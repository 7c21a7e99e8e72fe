from celestia_app_tpu_torch.square.builder import (
    BlobPlacement,
    Builder,
    NamespaceUsage,
    Square,
    SquareAccounting,
    SquareOverflow,
    build,
    construct,
)
from celestia_app_tpu_torch.square.layout import (
    blob_min_square_size,
    next_share_index,
    round_up_power_of_two,
    subtree_width,
)

__all__ = [
    "BlobPlacement",
    "Builder",
    "NamespaceUsage",
    "Square",
    "SquareAccounting",
    "SquareOverflow",
    "build",
    "construct",
    "blob_min_square_size",
    "next_share_index",
    "round_up_power_of_two",
    "subtree_width",
]
