"""Protocol constants the block-square path and the square builder use.

A copy of the values in celestia_app_tpu/constants (reference
pkg/appconsts/global_consts.go); they cannot change during the lifetime of
a network, so the two packages hold the same numbers.
"""

NAMESPACE_VERSION_SIZE = 1
NAMESPACE_ID_SIZE = 28
NAMESPACE_SIZE = NAMESPACE_VERSION_SIZE + NAMESPACE_ID_SIZE  # 29
SHARE_SIZE = 512
SHARE_INFO_BYTES = 1
SEQUENCE_LEN_BYTES = 4
SHARE_VERSION_ZERO = 0
MAX_SHARE_VERSION = 127
COMPACT_SHARE_RESERVED_BYTES = 4

FIRST_COMPACT_SHARE_CONTENT_SIZE = (
    SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES - SEQUENCE_LEN_BYTES
    - COMPACT_SHARE_RESERVED_BYTES
)  # 474
CONTINUATION_COMPACT_SHARE_CONTENT_SIZE = (
    SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES - COMPACT_SHARE_RESERVED_BYTES
)  # 478
FIRST_SPARSE_SHARE_CONTENT_SIZE = (
    SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES - SEQUENCE_LEN_BYTES
)  # 478
CONTINUATION_SPARSE_SHARE_CONTENT_SIZE = SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES  # 482

# Blob start alignment (non-interactive default rules, v1/v2 app consts).
SUBTREE_ROOT_THRESHOLD = 64

# The parity-share namespace (29 x 0xFF): every erasure-coded leaf outside
# Q0 carries it, and it triggers the NMT ignore-max rule.
PARITY_NAMESPACE_BYTES = bytes([0xFF]) * NAMESPACE_SIZE

HASH_LENGTH = 32  # SHA-256
NMT_NODE_SIZE = 2 * NAMESPACE_SIZE + HASH_LENGTH  # 90: minNs || maxNs || digest

# v3 protocol cap on the original square width.
SQUARE_SIZE_UPPER_BOUND = 128
# The largest ODS width the codec accepts (GF(2^16) codewords to 8192).
MAX_CODEC_SQUARE_SIZE = 4096
