"""The Blobstream relayer circuit: orchestrator -> relayer -> verifying client.

Reference shape (x/blobstream/client/verify.go, overview.md):

  * every validator runs an *orchestrator* signing each attestation's
    commitment (valset hash or data-root tuple root) with its EVM key;
  * a *relayer* collects those signatures and submits the tuple root to the
    Blobstream contract on Ethereum (submitDataRootTupleRoot), which checks
    that >2/3 of the registered validator power signed;
  * a *verifying client* (rollup, bridge) proves a share range against the
    contract: shares -> NMT row roots -> data root (self-verifying
    ShareProof), then data root -> tuple root via a binary-merkle
    DataRootInclusionProof (verify.go:206-344).

This module provides TPU-repo equivalents of all three roles against the
JSON-RPC serving plane plus `BlobstreamContract`, an in-process stand-in
for the Ethereum contract (storage layout and checks modeled on
Blobstream.sol via x/blobstream/types/abi_consts.go).  Digests are
EVM-byte-parity keccak256 over the reference's ABI layouts
(modules/blobstream/evm.py, crypto/keccak.py) — the round-2 sha256
stand-in (then recorded as a PARITY deviation) is gone.

The port's copy of celestia_app_tpu/modules/blobstream/relayer.py.  Against
a port ServingNode the share proofs it checks come from squares that node
extended on its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

from celestia_app_tpu_torch import merkle
from celestia_app_tpu_torch.crypto.keys import PrivateKey, PublicKey
from celestia_app_tpu_torch.modules.blobstream.evm import (
    data_commitment_sign_bytes,
    valset_sign_bytes,
)
from celestia_app_tpu_torch.modules.blobstream.keeper import (
    BridgeValidator,
    encode_data_root_tuple,
)


def data_commitment_digest(nonce: int, tuple_root: bytes) -> bytes:
    """The message an orchestrator signs for a DataCommitment attestation
    (reference domainSeparateDataRootTupleRoot keccak digest)."""
    return data_commitment_sign_bytes(nonce, tuple_root)


def valset_checkpoint(
    nonce: int, members: tuple[BridgeValidator, ...]
) -> bytes:
    """Checkpoint digest registering a validator set in the contract
    (reference Valset.SignBytes, valset.go:32-56)."""
    return valset_sign_bytes(nonce, members)


@dataclass(frozen=True)
class OrchestratorSignature:
    validator: str  # bech32 operator address (the contract key here)
    signature: bytes


class ContractError(ValueError):
    pass


class BlobstreamContract:
    """In-process Blobstream.sol stand-in.

    state_dataRootTupleRoots[nonce] plus the currently registered validator
    set; submitDataRootTupleRoot enforces the reference's 2/3 signed-power
    threshold before accepting a root.
    """

    def __init__(self, valset_nonce: int, members: tuple[BridgeValidator, ...],
                 pubkeys: dict[str, PublicKey]):
        self.valset_nonce = valset_nonce
        self.members = tuple(members)
        self.pubkeys = dict(pubkeys)  # validator address -> secp256k1 key
        self.tuple_roots: dict[int, bytes] = {}  # nonce -> commitment root
        self.latest_nonce = valset_nonce

    def update_valset(
        self,
        new_nonce: int,
        new_members: tuple[BridgeValidator, ...],
        new_pubkeys: dict[str, PublicKey],
        signatures: list[OrchestratorSignature],
    ) -> None:
        """updateValidatorSet: the *old* set signs the new checkpoint."""
        digest = valset_checkpoint(new_nonce, tuple(new_members))
        self._check_threshold(digest, signatures)
        if new_nonce <= self.valset_nonce:
            raise ContractError("valset nonce must increase")
        self.valset_nonce = new_nonce
        self.members = tuple(new_members)
        self.pubkeys = dict(new_pubkeys)
        self.latest_nonce = max(self.latest_nonce, new_nonce)

    def submit_data_root_tuple_root(
        self, nonce: int, tuple_root: bytes, signatures: list[OrchestratorSignature]
    ) -> None:
        """submitDataRootTupleRoot: accept a window root signed by >2/3."""
        if nonce in self.tuple_roots:
            raise ContractError(f"nonce {nonce} already relayed")
        if len(tuple_root) != 32:
            raise ContractError("tuple root must be 32 bytes")
        self._check_threshold(data_commitment_digest(nonce, tuple_root), signatures)
        self.tuple_roots[nonce] = tuple_root
        self.latest_nonce = max(self.latest_nonce, nonce)

    def _check_threshold(
        self, digest: bytes, signatures: list[OrchestratorSignature]
    ) -> None:
        total = sum(m.power for m in self.members)
        power_by_addr = {m.address: m.power for m in self.members}
        signed = 0
        seen: set[str] = set()
        for sig in signatures:
            if sig.validator in seen or sig.validator not in power_by_addr:
                continue
            pub = self.pubkeys.get(sig.validator)
            if pub is None or not pub.verify(digest, sig.signature):
                raise ContractError(f"bad signature from {sig.validator}")
            seen.add(sig.validator)
            signed += power_by_addr[sig.validator]
        if Fraction(signed, total or 1) <= Fraction(2, 3):
            raise ContractError(
                f"insufficient signed power {signed}/{total} (needs >2/3)"
            )

    def verify_attestation(
        self,
        nonce: int,
        height: int,
        data_root: bytes,
        index: int,
        total: int,
        path: list[bytes],
    ) -> bool:
        """verifyAttestation: prove (height, dataRoot) under a relayed root."""
        root = self.tuple_roots.get(nonce)
        if root is None:
            return False
        leaf = encode_data_root_tuple(height, data_root)
        return merkle.verify_proof(root, leaf, index, total, path)


class Orchestrator:
    """Per-validator attestation signer (reference: the orchestrator daemon)."""

    def __init__(self, validator: str, key: PrivateKey):
        self.validator = validator
        self.key = key

    def sign_data_commitment(self, nonce: int, tuple_root: bytes) -> OrchestratorSignature:
        return OrchestratorSignature(
            self.validator, self.key.sign(data_commitment_digest(nonce, tuple_root))
        )

    def sign_valset(
        self, nonce: int, members: tuple[BridgeValidator, ...]
    ) -> OrchestratorSignature:
        return OrchestratorSignature(
            self.validator, self.key.sign(valset_checkpoint(nonce, members))
        )


def relay_pending(remote, contract: BlobstreamContract, orchestrators) -> int:
    """Relayer main loop body: walk un-relayed attestations in nonce order —
    valset updates first registered in the contract (signed by the *old*
    set), data commitments submitted against the set current at their
    nonce, as the reference relayer sequences updateValidatorSet /
    submitDataRootTupleRoot.  Returns the number of commitments relayed."""
    nonces = remote.blobstream_nonces()
    by_validator = {o.validator: o for o in orchestrators}
    relayed = 0
    for nonce in range(1, nonces["latest"] + 1):
        att = remote.blobstream_attestation(nonce)
        if att is None:
            continue
        if att["kind"] == "valset":
            if att["nonce"] <= contract.valset_nonce:
                continue  # genesis valset already registered
            members = tuple(
                BridgeValidator(m["address"], m["power"]) for m in att["members"]
            )
            # The relayer knows each orchestrator's key; the contract needs
            # the new members' verification keys alongside the old set's
            # signatures over the checkpoint.
            new_pubkeys = {
                m.address: by_validator[m.address].key.public_key()
                for m in members
                if m.address in by_validator
            }
            sigs = [o.sign_valset(att["nonce"], members) for o in orchestrators]
            contract.update_valset(att["nonce"], members, new_pubkeys, sigs)
            continue
        if nonce in contract.tuple_roots:
            continue
        root = remote.data_commitment(att["begin_block"], att["end_block"])
        sigs = [o.sign_data_commitment(nonce, root) for o in orchestrators]
        contract.submit_data_root_tuple_root(nonce, root, sigs)
        relayed += 1
    return relayed


def verify_shares(
    remote, contract: BlobstreamContract, height: int, start: int, end: int
) -> bool:
    """The full verify.go:206-344 client flow against contract + node."""
    proof, data_root = remote.share_inclusion_proof(height, start, end)
    if not proof.verify(data_root):
        return False
    dc = remote.data_commitment_range(height)
    index, total, path = remote.data_root_inclusion_proof(
        height, dc["begin_block"], dc["end_block"]
    )
    return contract.verify_attestation(
        dc["nonce"], height, data_root, index, total, path
    )


def _locate_tx(remote, tx_hash: bytes):
    """(height, tx_index, n_txs, reconstructed square) for a committed tx,
    or None.

    The square is rebuilt with the *hard cap of the app version the block
    was produced under* — verify.go:86-89 uses
    appconsts.SquareSizeUpperBound(header.Version.App), never the current
    governance param, so historical blocks re-layout identically even
    after a gov max-square change.
    """
    from celestia_app_tpu_torch.constants import square_size_upper_bound
    from celestia_app_tpu_torch.square import builder as square
    from celestia_app_tpu_torch.tx import tx_hash as hash_fn

    status = remote.tx_status(tx_hash)
    if status is None:
        return None
    height, _code, _log = status
    block = remote.block(height)
    txs = [bytes.fromhex(t) for t in block["txs"]]
    tx_index = next((i for i, t in enumerate(txs) if hash_fn(t) == tx_hash), None)
    if tx_index is None:
        return None
    # Chains run under the benchmark-manifest square-cap override report it
    # with the block; default to the versioned hard cap (verify.go:86-89).
    bound = block.get("square_size_upper_bound") or square_size_upper_bound(
        block["app_version"]
    )
    sq = square.construct(txs, bound)
    return height, tx_index, len(txs), sq


def verify_tx(remote, contract: BlobstreamContract, tx_hash: bytes) -> bool:
    """verify.go txCmd: tx hash -> share range -> verify_shares."""
    located = _locate_tx(remote, tx_hash)
    if located is None:
        return False
    height, tx_index, _n_txs, sq = located
    start, end = sq.find_tx_share_range(tx_index)
    return verify_shares(remote, contract, height, start, end)


def verify_blob(
    remote, contract: BlobstreamContract, tx_hash: bytes, blob_index: int
) -> bool:
    """verify.go blobCmd: (tx hash, blob index) -> blob share range."""
    located = _locate_tx(remote, tx_hash)
    if located is None:
        return False
    height, tx_index, n_txs, sq = located
    # pfb_index = position among the square's blob txs (block order keeps
    # normal txs first, then blob txs — square/builder.py find_tx_share_range).
    n_normal = n_txs - len(sq.wrapped_pfb_txs())
    if tx_index < n_normal:
        return False  # a committed tx, but not a blob tx: nothing to prove
    try:
        start, end = sq.blob_share_range(tx_index - n_normal, blob_index)
    except KeyError:
        return False  # blob_index out of range for this PFB
    return verify_shares(remote, contract, height, start, end)
