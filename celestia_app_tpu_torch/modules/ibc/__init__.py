"""IBC-lite: the channel reads the ante handler makes (core.py).

The transfer stack, the handshakes and the light clients of
celestia_app_tpu/modules/ibc wait for the message handlers (ROADMAP,
queue 1).
"""

from celestia_app_tpu_torch.modules.ibc.core import ChannelKeeper, Height, Packet

__all__ = ["ChannelKeeper", "Height", "Packet"]
