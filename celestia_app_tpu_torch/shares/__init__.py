from celestia_app_tpu_torch.shares.namespace import (  # noqa: F401
    Namespace,
    PARITY_NS_BYTES,
    PARITY_SHARE_NAMESPACE,
    PAY_FOR_BLOB_NAMESPACE,
    PRIMARY_RESERVED_PADDING_NAMESPACE,
    TAIL_PADDING_NAMESPACE,
    TRANSACTION_NAMESPACE,
)
from celestia_app_tpu_torch.shares.share import (  # noqa: F401
    Share,
    make_info_byte,
    padding_share,
    parse_info_byte,
    reserved_padding_shares,
    shares_from_bytes,
    shares_to_bytes,
    tail_padding_shares,
)
from celestia_app_tpu_torch.shares.sparse import (  # noqa: F401
    Blob,
    SparseShareSplitter,
    parse_sparse_shares,
    sparse_shares_needed,
    split_blob,
)
from celestia_app_tpu_torch.shares.compact import (  # noqa: F401
    compact_shares_needed,
    parse_compact_shares,
    split_txs,
    tx_sequence_len,
)
