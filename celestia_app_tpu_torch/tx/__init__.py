from celestia_app_tpu_torch.tx.envelopes import (
    BLOB_TX_TYPE_ID,
    INDEX_WRAPPER_TYPE_ID,
    BlobTx,
    IndexWrapper,
    marshal_blob,
    unmarshal_blob,
    tx_hash,
    unmarshal_blob_tx,
    unmarshal_index_wrapper,
)

__all__ = [
    "BLOB_TX_TYPE_ID",
    "INDEX_WRAPPER_TYPE_ID",
    "BlobTx",
    "IndexWrapper",
    "marshal_blob",
    "unmarshal_blob",
    "unmarshal_blob_tx",
    "unmarshal_index_wrapper",
]
