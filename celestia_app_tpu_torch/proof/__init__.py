"""Inclusion proofs to the data root (reference pkg/proof; the port's copy
of celestia_app_tpu/proof): share proofs (share_proof.py), the tx proof
below, and the ABCI query routes (querier.py)."""

from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
from celestia_app_tpu_torch.proof.share_proof import (
    RowProof,
    ShareProof,
    new_share_inclusion_proof,
)
from celestia_app_tpu_torch.square.builder import Square


def new_tx_inclusion_proof(
    square: Square, eds: ExtendedDataSquare, tx_index: int
) -> ShareProof:
    """Proof that block tx `tx_index`'s shares are committed by the data root.

    Reference pkg/proof/proof.go:23 NewTxInclusionProof: locate the tx's
    share span in the compact region, then prove those shares.
    """
    lo, hi = square.find_tx_share_range(tx_index)
    return new_share_inclusion_proof(eds, lo, hi)


__all__ = [
    "RowProof",
    "ShareProof",
    "new_share_inclusion_proof",
    "new_tx_inclusion_proof",
]
