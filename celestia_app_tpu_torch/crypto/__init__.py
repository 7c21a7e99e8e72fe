from celestia_app_tpu_torch.crypto.keys import (
    ACCOUNT_HRP,
    PrivateKey,
    PublicKey,
    validate_address,
)

__all__ = ["ACCOUNT_HRP", "PrivateKey", "PublicKey", "validate_address"]
