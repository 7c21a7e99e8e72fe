from celestia_app_tpu_torch.modules.slashing.keeper import (
    Params,
    SigningInfo,
    SlashingError,
    SlashingKeeper,
)

__all__ = ["Params", "SigningInfo", "SlashingError", "SlashingKeeper"]
