"""NMT digest rules (host oracle).

Digest format: minNs(29) || maxNs(29) || sha256-digest(32) = 90 bytes.

    leaf:  ns || ns || sha256(0x00 || ns || data)
    node:  minNs || maxNs || sha256(0x01 || left(90) || right(90))

with the IgnoreMaxNamespace rule: if the right child's min namespace is the
maximum namespace (29 x 0xFF, parity shares), the parent's max namespace is
the left child's, so parity leaves never widen Q0 ranges (reference
test/util/malicious/hasher.go:186-310, pkg/wrapper/nmt_wrapper.go:59-62).
"""

from __future__ import annotations

import hashlib

from celestia_app_tpu_torch.constants import (
    NAMESPACE_SIZE,
    NMT_NODE_SIZE,
    PARITY_NAMESPACE_BYTES,
)

LEAF_PREFIX = b"\x00"
NODE_PREFIX = b"\x01"
MAX_NAMESPACE = PARITY_NAMESPACE_BYTES


class NmtHasher:
    """Stateless digest rules for 29-byte-namespace, sha256, ignore-max NMTs."""

    @staticmethod
    def hash_leaf(ndata: bytes) -> bytes:
        """ndata = ns(29) || raw data."""
        if len(ndata) < NAMESPACE_SIZE:
            raise ValueError("leaf shorter than a namespace")
        ns = ndata[:NAMESPACE_SIZE]
        return ns + ns + hashlib.sha256(LEAF_PREFIX + ndata).digest()

    @staticmethod
    def hash_node(left: bytes, right: bytes) -> bytes:
        if len(left) != NMT_NODE_SIZE or len(right) != NMT_NODE_SIZE:
            raise ValueError("NMT node children must be 90 bytes")
        l_min, l_max = left[:NAMESPACE_SIZE], left[NAMESPACE_SIZE:2 * NAMESPACE_SIZE]
        r_min, r_max = right[:NAMESPACE_SIZE], right[NAMESPACE_SIZE:2 * NAMESPACE_SIZE]
        if l_max > r_min:
            raise ValueError("sibling namespaces out of order")
        max_ns = l_max if r_min == MAX_NAMESPACE else r_max
        return l_min + max_ns + hashlib.sha256(NODE_PREFIX + left + right).digest()

    @staticmethod
    def empty_root() -> bytes:
        zero = b"\x00" * NAMESPACE_SIZE
        return zero + zero + hashlib.sha256(b"").digest()

    @staticmethod
    def min_namespace(node: bytes) -> bytes:
        return node[:NAMESPACE_SIZE]

    @staticmethod
    def max_namespace(node: bytes) -> bytes:
        return node[NAMESPACE_SIZE:2 * NAMESPACE_SIZE]
