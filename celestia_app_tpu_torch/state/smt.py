"""Merkleized state: a path-compressed binary trie over sha256(key).

Replaces the round-1 flat whole-state digest with the commitment structure
the reference gets from IAVL (app/app.go:435 — the committed multistore's
root becomes the app hash, pinned by app/test/consistent_apphash_test.go:47):

  * app hash = root of a deterministic merkle trie over all (key, value)
    pairs — shape is a function of the key set only (PATRICIA: one branch
    node per pairwise first-bit-difference), so insertion order never
    matters;
  * updates are persistent (structure-sharing): a commit re-hashes only
    O(delta * log n) nodes, never the whole state;
  * any key has a compact existence / non-existence proof against the app
    hash (the state-proof surface IAVL gives Cosmos light clients).

Domain-separated hashing (all SHA-256):
  leaf    H(0x00 || keyhash || sha256(value))
  branch  H(0x01 || bit_be16 || left || right)
  empty   H(0x02)
A branch node records the first bit position where its two subtrees'
keyhashes differ; bits are MSB-first over the 256-bit keyhash.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

_LEAF, _BRANCH = b"\x00", b"\x01"
EMPTY_ROOT = hashlib.sha256(b"\x02").digest()


def _h(*parts: bytes) -> bytes:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.digest()


def key_hash(key: bytes) -> bytes:
    return hashlib.sha256(key).digest()


def _bit(kh: bytes, i: int) -> int:
    return (kh[i >> 3] >> (7 - (i & 7))) & 1


def _first_diff(a: bytes, b: bytes) -> int:
    """First differing bit position of two 32-byte hashes (== 256 if equal)."""
    for byte in range(32):
        x = a[byte] ^ b[byte]
        if x:
            return (byte << 3) + (7 - x.bit_length() + 1)
    return 256


class Leaf:
    __slots__ = ("kh", "vh", "h")

    def __init__(self, kh: bytes, vh: bytes):
        self.kh = kh
        self.vh = vh
        self.h = _h(_LEAF, kh, vh)


class Branch:
    __slots__ = ("bit", "rep", "left", "right", "h")

    def __init__(self, bit: int, left, right):
        self.bit = bit
        self.rep = left.rep if isinstance(left, Branch) else left.kh
        self.left = left
        self.right = right
        self.h = _h(_BRANCH, bit.to_bytes(2, "big"), left.h, right.h)


def root_hash(node) -> bytes:
    return EMPTY_ROOT if node is None else node.h


def _rep(node) -> bytes:
    return node.rep if isinstance(node, Branch) else node.kh


def insert(node, kh: bytes, vh: bytes):
    """Persistent insert/update; returns the new root node."""
    if node is None:
        return Leaf(kh, vh)
    if isinstance(node, Leaf):
        d = _first_diff(kh, node.kh)
        if d == 256:
            return Leaf(kh, vh)  # update in place (new node)
        new = Leaf(kh, vh)
        return Branch(d, new, node) if _bit(kh, d) == 0 else Branch(d, node, new)
    d0 = _first_diff(kh, node.rep)
    if d0 < node.bit:
        # Diverges above this subtree's common prefix: split here.
        new = Leaf(kh, vh)
        return Branch(d0, new, node) if _bit(kh, d0) == 0 else Branch(d0, node, new)
    if _bit(kh, node.bit) == 0:
        return Branch(node.bit, insert(node.left, kh, vh), node.right)
    return Branch(node.bit, node.left, insert(node.right, kh, vh))


def delete(node, kh: bytes):
    """Persistent delete; returns the new root (None if emptied)."""
    if node is None:
        return None
    if isinstance(node, Leaf):
        return None if node.kh == kh else node
    if _bit(kh, node.bit) == 0:
        left = delete(node.left, kh)
        if left is None:
            return node.right
        if left is node.left:
            return node
        return Branch(node.bit, left, node.right)
    right = delete(node.right, kh)
    if right is None:
        return node.left
    if right is node.right:
        return node
    return Branch(node.bit, node.left, right)


@dataclass
class StateProof:
    """Merkle proof for `key` against an app hash.

    `value` is the proven value for existence, None for non-existence. The
    path is root-to-leaf: (branch bit, sibling hash) per traversed branch —
    the verifier re-derives directions from sha256(key), so directions are
    not part of the proof. For non-existence, `leaf_kh`/`leaf_vh` identify
    the leaf found at the key's unique lookup position (or None for an
    empty tree): lookup is deterministic, so a committed path ending in a
    different leaf proves absence.
    """

    key: bytes
    value: bytes | None
    path: list[tuple[int, bytes]]
    leaf_kh: bytes | None = None
    leaf_vh: bytes | None = None


def prove(node, key: bytes, value: bytes | None) -> StateProof:
    """Build the proof for `key` (pass its current value or None if absent)."""
    kh = key_hash(key)
    path: list[tuple[int, bytes]] = []
    cur = node
    while isinstance(cur, Branch):
        if _bit(kh, cur.bit) == 0:
            path.append((cur.bit, cur.right.h))
            cur = cur.left
        else:
            path.append((cur.bit, cur.left.h))
            cur = cur.right
    if cur is None:
        assert value is None and not path
        return StateProof(key, None, [])
    if cur.kh == kh:
        assert value is not None, "key exists; pass its value"
        return StateProof(key, value, path)
    assert value is None, "key absent; found a different leaf"
    return StateProof(key, None, path, leaf_kh=cur.kh, leaf_vh=cur.vh)


def verify(proof: StateProof, app_hash: bytes) -> bool:
    """Check the proof against a committed app hash.

    Malformed proofs (out-of-range bits, wrong-length hashes, missing
    fields) return False — a peer-supplied proof must never crash the
    verifier.
    """
    kh = key_hash(proof.key)
    if proof.value is not None:
        leaf = Leaf(kh, _h(proof.value))
    elif proof.leaf_kh is None:
        return not proof.path and app_hash == EMPTY_ROOT
    else:
        if proof.leaf_kh == kh:
            return False  # a leaf with the key's own hash cannot prove absence
        if not (
            isinstance(proof.leaf_kh, bytes) and len(proof.leaf_kh) == 32
            and isinstance(proof.leaf_vh, bytes) and len(proof.leaf_vh) == 32
        ):
            return False
        leaf = Leaf(proof.leaf_kh, proof.leaf_vh)
    h = leaf.h
    prev_bit = 256
    for bit, sibling in reversed(proof.path):
        if not (
            isinstance(bit, int) and 0 <= bit < prev_bit
            and isinstance(sibling, bytes) and len(sibling) == 32
        ):
            return False  # path bits strictly increase root-to-leaf, in [0,256)
        prev_bit = bit
        if _bit(kh, bit) == 0:
            h = _h(_BRANCH, bit.to_bytes(2, "big"), h, sibling)
        else:
            h = _h(_BRANCH, bit.to_bytes(2, "big"), sibling, h)
    return h == app_hash


def value_hash(value: bytes) -> bytes:
    return _h(value)


def proof_marshal(proof: StateProof) -> bytes:
    """Wire form for proofs that cross chains (IBC relay msgs):
    {key=1, has_value=2, value=3, path=4{bit=1, sibling=2},
    leaf_kh=5, leaf_vh=6}."""
    from celestia_app_tpu_torch.encoding.proto import (
        encode_bytes_field,
        encode_varint_field,
    )

    out = encode_bytes_field(1, proof.key)
    out += encode_varint_field(2, int(proof.value is not None))
    if proof.value is not None:
        out += encode_bytes_field(3, proof.value)
    for bit, sibling in proof.path:
        out += encode_bytes_field(
            4, encode_varint_field(1, bit) + encode_bytes_field(2, sibling)
        )
    if proof.leaf_kh is not None:
        out += encode_bytes_field(5, proof.leaf_kh)
        out += encode_bytes_field(6, proof.leaf_vh or b"")
    return out


def proof_unmarshal(raw: bytes) -> StateProof:
    from celestia_app_tpu_torch.encoding.proto import (
        WIRE_LEN,
        WIRE_VARINT,
        decode_fields,
    )

    key, value, has_value = b"", b"", False
    path: list[tuple[int, bytes]] = []
    leaf_kh = leaf_vh = None
    for n, wt, v in decode_fields(raw):
        if n == 1 and wt == WIRE_LEN:
            key = v
        elif n == 2 and wt == WIRE_VARINT:
            has_value = bool(v)
        elif n == 3 and wt == WIRE_LEN:
            value = v
        elif n == 4 and wt == WIRE_LEN:
            bit, sib = 0, b""
            for pn, pwt, pv in decode_fields(v):
                if pn == 1 and pwt == WIRE_VARINT:
                    bit = pv
                elif pn == 2 and pwt == WIRE_LEN:
                    sib = pv
            path.append((bit, sib))
        elif n == 5 and wt == WIRE_LEN:
            leaf_kh = v
        elif n == 6 and wt == WIRE_LEN:
            leaf_vh = v
    return StateProof(
        key, value if has_value else None, path, leaf_kh, leaf_vh
    )
