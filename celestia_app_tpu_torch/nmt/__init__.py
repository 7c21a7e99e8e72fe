"""Namespaced Merkle Trees on the host: the digest rules, the tree, and
range proofs.  The port's own copy of celestia_app_tpu/nmt (hasher, tree,
and the range-proof half of proof.py); the batched device versions of the
same digests are kernels/nmt.py and kernels/verify.py."""

from celestia_app_tpu_torch.nmt.hasher import MAX_NAMESPACE, NmtHasher
from celestia_app_tpu_torch.nmt.tree import NamespacedMerkleTree

__all__ = ["NmtHasher", "NamespacedMerkleTree", "MAX_NAMESPACE"]
