"""The ante handler chain: every admission check a tx passes before execution.

Behavioral parity with reference app/ante/ante.go:15-82, decorator by
decorator and in the reference's order (the per-decorator map with its
rejection tests lives in PARITY.md §ante):

   1 HandlePanicDecorator        -> run_ante's catch-all reject
   2 MsgVersioningGateKeeper     -> allowed_msg_types version gate
   3 SetUpContextDecorator       -> GasMeter(fee.gas_limit)
   4 ExtensionOptionsDecorator   -> reject critical extension options
   5 ValidateBasicDecorator      -> per-msg validate_basic + sig presence
   6 TxTimeoutHeightDecorator    -> reject past-timeout txs
   7 ValidateMemoDecorator       -> memo <= 256 chars
   8 ConsumeGasForTxSizeDecorator-> 10 gas per tx byte
   9 DeductFeeDecorator          -> ValidateTxFee (network+node min gas
                                    price, priority = gas price x 1e6,
                                    fee_checker.go:17,31-60) + deduction
  10 SetPubKeyDecorator          -> stores the pubkey on first use
  11 ValidateSigCountDecorator   -> single-signer rule (see PARITY: the
                                    sdk allows up to 7 multisig keys; this
                                    framework pins exactly one signer)
  12 SigGasConsumeDecorator      -> 1000 gas per secp256k1 signature
  13 SigVerificationDecorator    -> sequence match + DIRECT verification
  14 MinGasPFBDecorator          -> gas limit covers blob gas
  15 MaxTotalBlobSizeDecorator   -> v1 blob byte cap
  16 BlobShareDecorator          -> v2 blob share cap
  17 GovProposalDecorator        -> MsgSubmitProposal needs >= 1 message
  18 IncrementSequenceDecorator  -> sequence bump
  19 RedundantRelayDecorator     -> IBC relay dedup (modules/ibc)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from celestia_app_tpu_torch.app.gas import (
    GasKVStore,
    GasMeter,
    MAX_MEMO_CHARACTERS,
    OutOfGas,
    SIG_VERIFY_COST_SECP256K1,
    TX_SIG_LIMIT,
    TX_SIZE_COST_PER_BYTE,
)
from celestia_app_tpu_torch.constants import CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
from celestia_app_tpu_torch.shares.sparse import sparse_shares_needed
from celestia_app_tpu_torch.state.accounts import FEE_COLLECTOR
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.tx.messages import (
    MsgAcknowledgement,
    MsgAuthzExec,
    MsgAuthzGrant,
    MsgAuthzRevoke,
    MsgBeginRedelegate,
    MsgCancelUnbondingDelegation,
    MsgCreateValidator,
    MsgDelegate,
    MsgDeposit,
    MsgEditValidator,
    MsgFundCommunityPool,
    MsgCreatePeriodicVestingAccount,
    MsgCreatePermanentLockedAccount,
    MsgCreateVestingAccount,
    MsgDepositV1,
    MsgGrantAllowance,
    MsgMultiSend,
    MsgSubmitEvidence,
    MsgSubmitProposalV1,
    MsgVerifyInvariant,
    MsgVoteV1,
    MsgVoteWeightedV1,
    MsgRevokeAllowance,
    MsgPayForBlobs,
    MsgRecvPacket,
    MsgSend,
    MsgSetWithdrawAddress,
    MsgSignalVersion,
    MsgSubmitProposal,
    MsgTimeout,
    MsgTransfer,
    MsgTryUpgrade,
    MsgUndelegate,
    MsgUnjail,
    MsgVote,
    MsgVoteWeighted,
    MsgWithdrawDelegatorReward,
    MsgWithdrawValidatorCommission,
)
from celestia_app_tpu_torch.tx.sign import Tx

PRIORITY_SCALING_FACTOR = 1_000_000  # fee_checker.go:17


class AnteError(ValueError):
    """Tx rejected by the ante chain."""


# appVersion -> allowed msg types (MsgVersioningGateKeeper,
# app/ante/msg_gatekeeper.go:18-42: signal msgs are v2+; gov and IBC msgs
# exist in every version, as x/gov and ibc are wired for v1 and v2 in
# app/modules.go:96-189).
_V1_MSGS = {
    MsgSend, MsgMultiSend, MsgPayForBlobs, MsgSubmitProposal, MsgVote,
    MsgVoteWeighted, MsgDeposit,
    MsgTransfer, MsgRecvPacket, MsgAcknowledgement, MsgTimeout,
    MsgDelegate, MsgUndelegate, MsgBeginRedelegate,
    MsgCancelUnbondingDelegation,
    MsgCreateValidator, MsgEditValidator,
    MsgWithdrawDelegatorReward, MsgWithdrawValidatorCommission,
    MsgSetWithdrawAddress, MsgFundCommunityPool, MsgUnjail,
    MsgGrantAllowance, MsgRevokeAllowance,
    MsgAuthzGrant, MsgAuthzExec, MsgAuthzRevoke,
    MsgCreateVestingAccount, MsgVerifyInvariant, MsgSubmitEvidence,
    MsgCreatePeriodicVestingAccount, MsgCreatePermanentLockedAccount,
    MsgSubmitProposalV1, MsgVoteV1, MsgVoteWeightedV1, MsgDepositV1,
}
_V2_MSGS = _V1_MSGS | {MsgSignalVersion, MsgTryUpgrade}


def allowed_msg_types(app_version: int) -> set[type]:
    return _V1_MSGS if app_version <= 1 else _V2_MSGS


@dataclass
class AnteResult:
    priority: int = 0
    gas_wanted: int = 0
    gas_consumed: int = 0  # meter reading after the chain (size+sig+store gas)
    signer: str = ""
    events: list = field(default_factory=list)
    # The tx's single gas meter (sdk runTx): execution continues on it so
    # store access during message handling is charged too.
    meter: GasMeter | None = None


def run_ante(
    app,
    ctx,
    tx: Tx,
    *,
    is_check_tx: bool,
    simulate: bool = False,
    tx_bytes: bytes | None = None,
) -> AnteResult:
    """Run the full chain against `ctx` (a branched state view).

    Raises AnteError on any rejection; mutates ctx state (sequence bump,
    fee deduction) on success, exactly like the reference chain.
    `tx_bytes` is the delivered tx encoding (the inner tx for a BlobTx),
    metered by ConsumeGasForTxSizeDecorator; None skips size gas (some
    internal callers have no wire encoding).

    The chain runs on a per-tx branch of `ctx` that is written back only on
    success (baseapp runTx's cacheTxContext around the ante handler): a
    rejection after fee deduction must not leave the fee deducted in a
    shared check/filter state.
    """
    tx_ctx = ctx.branch()
    try:
        res = _run(
            app, tx_ctx, tx, is_check_tx=is_check_tx, simulate=simulate,
            tx_bytes=tx_bytes,
        )
    except AnteError:
        raise
    except OutOfGas:
        # Gas exhaustion keeps its type: baseapp runTx returns sdk
        # ErrOutOfGas (code 11) whether the meter ran out in the ante
        # chain or in execution — check/deliver map it to code 11 there.
        raise
    except Exception as e:  # HandlePanicDecorator: panic -> reject, not crash
        raise AnteError(f"internal error in ante chain: {e!r}") from e
    ctx.store.write_back(tx_ctx.store)
    return res


def _run(
    app, ctx, tx: Tx, *, is_check_tx: bool, simulate: bool, tx_bytes: bytes | None
) -> AnteResult:
    from celestia_app_tpu_torch.tx.messages import decode_msg

    body = tx.body  # parsed once; msgs() would re-unmarshal the body
    msgs = [decode_msg(m) for m in body.messages]  # raises on unknown type
    if not msgs:
        raise AnteError("tx has no messages")

    # --- 2: msg version gating ---------------------------------------------
    # Nested authz msgs are gated too (the reference's MsgVersioningGateKeeper
    # unpacks MsgExec, msg_gatekeeper.go).
    allowed = allowed_msg_types(ctx.app_version)
    to_gate = list(msgs)
    for m in msgs:
        if isinstance(m, MsgAuthzExec):
            to_gate.extend(m.inner_msgs())
    for m in to_gate:
        if type(m) not in allowed:
            raise AnteError(
                f"message {type(m).__name__} not allowed at app version {ctx.app_version}"
            )

    # --- 3: gas meter setup (SetUpContextDecorator) --------------------------
    auth = tx.auth_info
    fee = auth.fee
    if fee.gas_limit == 0 and not simulate:
        # Simulate waives the limit entirely (sdk SetUpContextDecorator
        # installs an infinite meter): cosmjs's simulate() sends
        # gasLimit=0 by construction.
        raise AnteError("gas limit must be positive")
    meter = GasMeter(None if simulate else fee.gas_limit)
    # Every store access from here on is charged the sdk KVStore gas
    # schedule (gaskv wrapping in baseapp's runTx context).
    ctx = ctx.with_store(GasKVStore(ctx.store, meter))

    # --- 4: extension options (RejectExtensionOptionsDecorator: any critical
    # extension option rejects; non-critical ones pass by definition) ---------
    if body.extension_options:
        raise AnteError("unknown extension options")

    # --- 5: ValidateBasic --------------------------------------------------
    if not tx.signatures or any(not s for s in tx.signatures):
        raise AnteError("tx must contain signatures")
    for m in msgs:
        vb = getattr(m, "validate_basic", None)
        if vb is not None:
            try:
                vb()
            except ValueError as e:
                raise AnteError(str(e)) from e

    # --- 6: timeout height ---------------------------------------------------
    if body.timeout_height and ctx.height > body.timeout_height:
        raise AnteError(
            f"tx timeout height {body.timeout_height} exceeded, block height {ctx.height}"
        )

    # --- 7: memo length ------------------------------------------------------
    if len(body.memo) > MAX_MEMO_CHARACTERS:
        raise AnteError(
            f"maximum number of characters is {MAX_MEMO_CHARACTERS} "
            f"but received {len(body.memo)}"
        )

    # --- 8: tx size gas ------------------------------------------------------
    if tx_bytes is not None:
        meter.consume(len(tx_bytes) * TX_SIZE_COST_PER_BYTE, "txSize")

    # --- 9: fee checks (ValidateTxFee) + deduction ---------------------------
    fee_utia = sum(c.amount for c in fee.amount if c.denom == "utia")
    # gas_limit can be 0 only under Simulate (checked at step 3), where
    # the min-gas-price comparisons are skipped anyway.
    gas_price = (
        Dec(0) if fee.gas_limit == 0
        else Dec.from_fraction(fee_utia, fee.gas_limit)
    )
    # Error strings follow the sdk wording so clients can parse the required
    # fee and retry (app/errors/insufficient_gas_price.go:23).
    net_min = app.minfee.network_min_gas_price()
    if gas_price < net_min and not simulate:
        required = net_min.mul_int(fee.gas_limit).ceil_int()
        raise AnteError(
            f"insufficient fees; got: {fee_utia}utia required: {required}utia"
        )
    if is_check_tx and not simulate:
        node_min = app.node_min_gas_price
        if gas_price < node_min:
            required = node_min.mul_int(fee.gas_limit).ceil_int()
            raise AnteError(
                f"insufficient fees; got: {fee_utia}utia required: {required}utia"
            )
    priority = gas_price.mul_int(PRIORITY_SCALING_FACTOR).truncate_int()

    # Resolve the signer before moving money (DeductFee needs the fee payer —
    # the first signer, pkg/user single-signer rule).  The one signer may
    # be a threshold multisig (LegacyAminoPubKey): the sdk default ante
    # admits <= TxSigLimit = 7 sub-keys (NewValidateSigCountDecorator,
    # app/ante/ante.go:15-82).
    from celestia_app_tpu_torch.tx.multisig import MultisigPubKey

    if len(auth.signer_infos) != 1 or len(tx.signatures) != 1:
        raise AnteError("exactly one signer required")
    info = auth.signer_infos[0]
    is_multisig = isinstance(info.public_key, MultisigPubKey)
    sub_keys = len(info.public_key.public_keys) if is_multisig else 1
    if sub_keys > TX_SIG_LIMIT:
        raise AnteError(
            f"signatures: {sub_keys}, limit: {TX_SIG_LIMIT}"
        )
    signer_addr = info.public_key.address()
    acc = ctx.auth.get_account(signer_addr)
    if acc is None:
        raise AnteError(f"account {signer_addr} not found")
    # Fee deduction precedes signature verification in the reference chain
    # (DeductFeeDecorator at ante.go:46-49 vs SigVerification at :60-63), so
    # an underfunded fee payer surfaces as insufficient funds even when the
    # signature is also bad.  The branch is discarded on rejection.
    # Fee.granter routes payment through an x/feegrant allowance (the sdk's
    # DeductFeeDecorator feegrant path; txsim's master account pays its
    # sub-accounts' fees this way, test/txsim/account.go:238-239).
    # An explicit Fee.payer must be the signer: honoring a third-party
    # payer would charge an account that never signed (the sdk requires
    # the payer to be a tx signer; with single-signer txs that means the
    # signer itself).  Silently ignoring the field would debit the wrong
    # account from the client's point of view.
    if fee.payer and fee.payer != signer_addr:
        raise AnteError(
            f"fee payer {fee.payer} must be the tx signer {signer_addr}"
        )
    fee_payer = signer_addr
    if fee.granter:
        from celestia_app_tpu_torch.modules.feegrant import FeegrantError, FeegrantKeeper

        try:
            FeegrantKeeper(ctx.store).use_grant(
                fee.granter, signer_addr, fee_utia,
                [type(m).TYPE_URL for m in msgs], ctx.time_ns,
            )
        except FeegrantError as e:
            raise AnteError(str(e)) from e
        fee_payer = fee.granter
    if fee_utia:
        try:
            # Vesting-aware: fees cannot spend still-vesting tokens.
            ctx.send_spendable(fee_payer, FEE_COLLECTOR, fee_utia)
        except ValueError as e:
            raise AnteError(str(e)) from e

    # --- 10-13: pubkey, sig count, sig gas, sig verification -----------------
    for m in msgs:
        expected = getattr(m, "signer", None) or getattr(m, "from_address", None) or getattr(
            m, "validator_address", None
        )
        if expected and expected != signer_addr:
            raise AnteError(f"message signer {expected} != tx signer {signer_addr}")
    # Sig gas per participating sub-signature (the sdk's
    # ConsumeMultisignatureVerificationGas; 1 for a plain key).
    n_sigs = (
        sum(1 for b in (info.mode_bits or ()) if b) if is_multisig else 1
    )
    meter.consume(
        SIG_VERIFY_COST_SECP256K1 * max(n_sigs, 1), "ante verify: secp256k1"
    )
    if info.sequence != acc.sequence:
        raise AnteError(
            f"account sequence mismatch, expected {acc.sequence}, got {info.sequence}"
        )
    if not simulate and not tx.verify_signature(app.chain_id, acc.account_number):
        raise AnteError("signature verification failed")

    # --- 14-16: x/blob ante --------------------------------------------------
    for m in msgs:
        if isinstance(m, MsgPayForBlobs):
            if not simulate:
                # MinGasPFBDecorator reads the meter's limit, which is
                # infinite under Simulate — a placeholder fee gas limit
                # must not fail the estimation call.
                _check_pfb_gas(m, fee.gas_limit, app.gas_per_blob_byte)
            _check_blob_shares(m, app.gov_max_square_size, ctx.app_version)

    # --- 17: gov proposals ---------------------------------------------------
    _check_gov_proposals(msgs)

    # --- 19: redundant IBC relays (CheckTx only, as the reference's
    # RedundantRelayDecorator protects the mempool without affecting
    # consensus) ---------------------------------------------------------------
    if is_check_tx:
        _check_redundant_relays(ctx, msgs)

    # --- 18: sequence increment + pubkey persistence -------------------------
    if acc.pubkey == b"":
        # Multisig keys persist their proto value bytes (sdk stores the
        # whole LegacyAminoPubKey on the account the same way).
        acc.pubkey = (
            info.public_key.value_bytes()
            if is_multisig
            else info.public_key.bytes
        )
    acc.sequence += 1
    ctx.auth.set_account(acc)

    return AnteResult(
        priority=priority,
        gas_wanted=fee.gas_limit,
        gas_consumed=meter.consumed,
        signer=signer_addr,
        meter=meter,
    )


def _check_gov_proposals(msgs: list) -> None:
    """GovProposalDecorator (app/ante/gov.go): a MsgSubmitProposal with no
    inner messages is rejected before it can reach the gov keeper.  The
    v1 msg needs no branch here: MsgSubmitProposalV1.validate_basic (ante
    step 5) already rejects anything but exactly one legacy-content
    message, which subsumes the empty case."""
    for m in msgs:
        if (
            isinstance(m, MsgSubmitProposal)
            and not m.changes
            and not m.spend_recipient
        ):
            raise AnteError("proposal must contain at least one message")


def _check_redundant_relays(ctx, msgs: list) -> None:
    """RedundantRelayDecorator (ibc-go core/ante): a CheckTx-only guard —
    if the tx carries relay messages and EVERY one of them is a no-op
    (packet already received / already acked or timed out), reject so
    redundant relays never occupy the mempool."""
    from celestia_app_tpu_torch.modules.ibc.core import ChannelKeeper

    relay_msgs = [
        m for m in msgs if isinstance(m, (MsgRecvPacket, MsgAcknowledgement, MsgTimeout))
    ]
    if not relay_msgs:
        return
    channels = ChannelKeeper(ctx.store)
    for m in relay_msgs:
        packet = m.packet()
        if isinstance(m, MsgRecvPacket):
            if not channels.has_receipt(packet):
                return  # at least one effective message
        else:  # ack / timeout: effective iff the commitment still exists
            if channels.packet_commitment(
                packet.source_port, packet.source_channel, packet.sequence
            ) is not None:
                return
    raise AnteError("tx contains only redundant IBC relay messages")


def _check_pfb_gas(msg: MsgPayForBlobs, gas_limit: int, gas_per_blob_byte: int) -> None:
    """MinGasPFBDecorator: the gas limit must cover the blob gas."""
    from celestia_app_tpu_torch.modules.blob.types import gas_to_consume

    needed = gas_to_consume(msg.blob_sizes, gas_per_blob_byte)
    if gas_limit < needed:
        raise AnteError(
            f"gas limit {gas_limit} insufficient for blobs needing {needed}"
        )


def _check_blob_shares(
    msg: MsgPayForBlobs, gov_max_square_size: int, app_version: int
) -> None:
    """BlobShareDecorator (v2) / MaxTotalBlobSize (v1): blobs must be able to
    fit a square at all."""
    cap = gov_max_square_size * gov_max_square_size
    if app_version <= 1:
        # v1: bound total blob *bytes* by the square capacity
        # (x/blob/ante/max_total_blob_size_ante.go:25).
        max_bytes = cap * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
        if sum(msg.blob_sizes) > max_bytes:
            raise AnteError(f"total blob size exceeds {max_bytes} bytes")
    else:
        shares = sum(sparse_shares_needed(s) for s in msg.blob_sizes)
        if shares > cap:
            raise AnteError(
                f"blobs need {shares} shares > square capacity {cap}"
            )
