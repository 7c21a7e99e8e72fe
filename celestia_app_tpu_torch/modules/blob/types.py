"""x/blob types: PFB construction, BlobTx validation, gas model.

Behavioral parity with reference x/blob/types (payforblob.go, blob_tx.go):
NewMsgPayForBlobs computes share commitments; ValidateBlobTx re-derives and
compares them (the consensus-critical check run in CheckTx and
ProcessProposal, app/check_tx.go:43, app/process_proposal.go:107).

The port's copy of celestia_app_tpu/modules/blob/types.py.  The two
validators take a `device` (default CUDA, raising without a card; "cpu"
runs the plain kernel versions) and hash every commitment on it through
inclusion.batched.create_commitments_batched; a fault there comes out as
device.DeviceFault, never as a verdict on the blob.
"""

from __future__ import annotations

from celestia_app_tpu_torch.constants import (
    DEFAULT_GAS_PER_BLOB_BYTE,
    PFB_GAS_FIXED_COST,
    SHARE_SIZE,
    SUBTREE_ROOT_THRESHOLD,
)
from celestia_app_tpu_torch.crypto.keys import validate_address
from celestia_app_tpu_torch.device import on_device
from celestia_app_tpu_torch.inclusion import create_commitment
from celestia_app_tpu_torch.shares.namespace import Namespace
from celestia_app_tpu_torch.shares.share import SUPPORTED_SHARE_VERSIONS
from celestia_app_tpu_torch.shares.sparse import Blob, sparse_shares_needed
from celestia_app_tpu_torch.tx.envelopes import BlobTx
from celestia_app_tpu_torch.tx.messages import MsgPayForBlobs
from celestia_app_tpu_torch.tx.sign import Tx


class BlobTxError(ValueError):
    """A BlobTx failed stateless validation."""


def new_msg_pay_for_blobs(
    signer: str,
    blobs: list[Blob],
    subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD,
) -> MsgPayForBlobs:
    """Reference x/blob/types/payforblob.go:48 NewMsgPayForBlobs."""
    if not blobs:
        raise BlobTxError("at least one blob required")
    for b in blobs:
        b.namespace.validate_for_blob()
    msg = MsgPayForBlobs(
        signer=signer,
        namespaces=tuple(b.namespace.to_bytes() for b in blobs),
        blob_sizes=tuple(len(b.data) for b in blobs),
        share_commitments=tuple(
            create_commitment(b, subtree_root_threshold) for b in blobs
        ),
        share_versions=tuple(b.share_version for b in blobs),
    )
    validate_msg_pay_for_blobs(msg)
    return msg


def validate_msg_pay_for_blobs(msg: MsgPayForBlobs) -> None:
    """Stateless MsgPayForBlobs checks (payforblob.go ValidateBasic)."""
    n = len(msg.namespaces)
    if n == 0:
        raise BlobTxError("no namespaces in MsgPayForBlobs")
    if not (len(msg.blob_sizes) == len(msg.share_commitments) == len(msg.share_versions) == n):
        raise BlobTxError("MsgPayForBlobs field lengths differ")
    validate_address(msg.signer)
    for raw_ns in msg.namespaces:
        Namespace.from_bytes(raw_ns).validate_for_blob()
    for v in msg.share_versions:
        if v not in SUPPORTED_SHARE_VERSIONS:
            raise BlobTxError(f"unsupported share version {v}")
    for c in msg.share_commitments:
        if len(c) != 32:
            raise BlobTxError(f"share commitment must be 32 bytes, got {len(c)}")


def _structural_checks(btx: BlobTx) -> MsgPayForBlobs:
    """Everything in ValidateBlobTx except the commitment recompute."""
    try:
        tx = Tx.unmarshal(btx.tx)
        msgs = tx.msgs()
    except ValueError as e:
        raise BlobTxError(f"undecodable inner tx: {e}") from e
    pfbs = [m for m in msgs if isinstance(m, MsgPayForBlobs)]
    if len(pfbs) != 1 or len(msgs) != 1:
        raise BlobTxError("BlobTx inner tx must contain exactly one MsgPayForBlobs")
    msg = pfbs[0]
    validate_msg_pay_for_blobs(msg)
    if len(btx.blobs) != len(msg.namespaces):
        raise BlobTxError(
            f"blob count {len(btx.blobs)} != PFB namespace count {len(msg.namespaces)}"
        )
    for i, blob in enumerate(btx.blobs):
        if blob.namespace.to_bytes() != msg.namespaces[i]:
            raise BlobTxError(f"blob {i} namespace differs from PFB")
        if len(blob.data) != msg.blob_sizes[i]:
            raise BlobTxError(f"blob {i} size differs from PFB")
        if blob.share_version != msg.share_versions[i]:
            raise BlobTxError(f"blob {i} share version differs from PFB")
    return msg


def validate_blob_tx(
    btx: BlobTx, subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD,
    device=None,
) -> MsgPayForBlobs:
    """Full stateless BlobTx validation (blob_tx.go:37-108).

    Decodes the inner tx, requires exactly one MsgPayForBlobs, and checks
    every blob against the message: namespace match, size match, share
    version match, and commitment equality (the expensive recompute).
    Returns the validated message.
    """
    from celestia_app_tpu_torch.inclusion.batched import create_commitments_batched

    msg = _structural_checks(btx)
    # Through the batched path for its content memo: the same blob is
    # re-validated at Prepare/Process after CheckTx admission, and the
    # memo collapses those recomputes to one device pass.
    with on_device("blob share commitments"):
        commitments = create_commitments_batched(
            list(btx.blobs), subtree_root_threshold, device=device
        )
    for i, commitment in enumerate(commitments):
        if commitment != msg.share_commitments[i]:
            raise BlobTxError(f"blob {i} share commitment mismatch")
    return msg


def validate_blob_txs_batched(
    btxs: list[BlobTx], subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD,
    device=None,
) -> list[MsgPayForBlobs | BlobTxError]:
    """ValidateBlobTx over many txs with ALL commitment hashing batched on
    the device (hot loop (3) of ProcessProposal, SURVEY §3.3).

    Returns, per tx, the validated MsgPayForBlobs or the BlobTxError that
    rejected it — callers drop (Prepare) or reject (Process) as they
    choose.  Equivalent to [validate_blob_tx(b) for b in btxs].
    """
    from celestia_app_tpu_torch.inclusion.batched import create_commitments_batched

    results: list[MsgPayForBlobs | BlobTxError] = []
    todo: list[tuple[int, MsgPayForBlobs]] = []
    all_blobs = []
    for btx in btxs:
        try:
            msg = _structural_checks(btx)
        except BlobTxError as e:
            results.append(e)
            continue
        todo.append((len(results), msg))
        results.append(msg)
        all_blobs.extend(btx.blobs)

    with on_device("blob share commitments"):
        commitments = create_commitments_batched(
            all_blobs, subtree_root_threshold, device=device
        )
    pos = 0
    for idx, msg in todo:
        n = len(msg.share_commitments)
        got = commitments[pos : pos + n]
        pos += n
        for i, c in enumerate(got):
            if c != msg.share_commitments[i]:
                results[idx] = BlobTxError(f"blob {i} share commitment mismatch")
                break
    return results


def gas_to_consume(blob_sizes: tuple[int, ...], gas_per_blob_byte: int) -> int:
    """payforblob.go:158 GasToConsume: shares x 512 x gasPerBlobByte."""
    total_shares = sum(sparse_shares_needed(s) for s in blob_sizes)
    return total_shares * SHARE_SIZE * gas_per_blob_byte


def estimate_gas(
    blob_sizes: list[int],
    gas_per_blob_byte: int = DEFAULT_GAS_PER_BLOB_BYTE,
    fixed_cost: int = PFB_GAS_FIXED_COST,
) -> int:
    """payforblob.go:171 linear PFB gas model (fit R^2 ~ 0.996):
    blob gas + txSizeCost x BytesPerBlobInfo per blob + fixed cost."""
    from celestia_app_tpu_torch.app.gas import TX_SIZE_COST_PER_BYTE
    from celestia_app_tpu_torch.constants import BYTES_PER_BLOB_INFO

    return (
        gas_to_consume(tuple(blob_sizes), gas_per_blob_byte)
        + TX_SIZE_COST_PER_BYTE * BYTES_PER_BLOB_INFO * len(blob_sizes)
        + fixed_cost
    )
