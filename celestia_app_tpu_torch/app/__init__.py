"""Application entry points of the port: the block extend (extend_block.py)
and the ABCI proposal half of the App (app.py, with the ante chain and gas
meter in ante.py and gas.py)."""

from celestia_app_tpu_torch.app.ante import AnteError, run_ante  # noqa: F401
from celestia_app_tpu_torch.app.app import (  # noqa: F401
    App,
    BlockData,
    Ctx,
    Genesis,
    GenesisAccount,
    TxResult,
)
from celestia_app_tpu_torch.app.extend_block import extend_block, is_empty_block  # noqa: F401
