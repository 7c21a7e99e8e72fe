from celestia_app_tpu_torch.user.signer import Signer, SignerAccount
from celestia_app_tpu_torch.user.tx_client import (
    TxClient,
    TxResponse,
    TxSubmissionError,
)
from celestia_app_tpu_torch.user.errors import (
    parse_insufficient_min_gas_price,
    parse_nonce_mismatch,
)

__all__ = [
    "Signer",
    "SignerAccount",
    "TxClient",
    "TxResponse",
    "TxSubmissionError",
    "parse_insufficient_min_gas_price",
    "parse_nonce_mismatch",
]
