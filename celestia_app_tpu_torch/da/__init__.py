"""Data availability: the extended data square, its header, and repair."""

from celestia_app_tpu_torch.da.dah import (  # noqa: F401
    DataAvailabilityHeader,
    min_data_availability_header,
)
from celestia_app_tpu_torch.da.eds import ExtendedDataSquare, extend_shares  # noqa: F401
from celestia_app_tpu_torch.da.repair import (  # noqa: F401
    IrrecoverableSquare,
    RootMismatch,
    repair,
)
