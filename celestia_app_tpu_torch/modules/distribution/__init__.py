from celestia_app_tpu_torch.modules.distribution.keeper import (
    DISTRIBUTION_MODULE,
    DistributionError,
    DistributionKeeper,
)

__all__ = ["DISTRIBUTION_MODULE", "DistributionError", "DistributionKeeper"]
