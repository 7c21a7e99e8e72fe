"""The ABCI application: CheckTx, PrepareProposal and ProcessProposal on the
port's square path, and block execution (FinalizeBlock, Commit, Simulate).

Behavioral parity with the reference app package, as the JAX package's
celestia_app_tpu/app/app.py holds it:

  PrepareProposal  app/prepare_proposal.go:22-91   filter -> build square ->
                                                   RS-extend -> DAH -> root
  ProcessProposal  app/process_proposal.go:24-158  decode/validate every tx,
                                                   reconstruct, compare root
  CheckTx          app/check_tx.go:16-54           BlobTx unwrap + ante
  Finalize/Commit  app/app.go:446-480              mint + distribution +
                                                   evidence + liveness
                                                   BeginBlock, every message
                                                   handler, gov / unbonding /
                                                   blobstream (v1) / upgrade
                                                   EndBlock, state commit

`App(..., device=None)` runs its device work on `device`: the blob share
commitments (modules/blob/types -> inclusion.batched) and the extend + DAH
(da.extend_shares); None means CUDA and raises without a card, "cpu" runs
the plain kernel versions.  Block execution does no device work: the
message handlers, the keepers and the commit are host code, a copy of the
JAX App's, and nothing in finalize_block or commit runs under
device.on_device, so they raise no DeviceFault.  Their TxResults (code,
log, gas, events) and app hashes are the JAX App's byte for byte
(tests/test_torch_finalize.py, tests/test_torch_ibc.py); chip_smoke.py's
phase_chain runs Prepare -> Process -> Finalize -> Commit on the card.

Two deliberate differences from the JAX App, both because no fallback may
hide the device:
  * ProcessProposal rejects a proposal on any fault of its content, as the
    reference's recover() does, but a fault of the device or a kernel
    (device.DeviceFault) raises to the caller instead of voting False.  The
    extend rides the degradation ladder (chaos/degrade.py) first, so a
    fault that raises here is one that outlasted every rung.
  * speculate_proposal returns False only on a mismatch (a square that does
    not build, or whose size or emptiness differs from the proposal's); a
    fault of the speculative extend raises.
The serve plane's rebuild sources are the JAX App's: `last_eds_for_root`
hands the commit hook of rpc/server.ServingNode the square this App just
extended (kept while $CELESTIA_SERVE_HEIGHTS > 0), and `square_eds` extends
a rebuilt square on the App's device.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from celestia_app_tpu_torch.app.ante import AnteError, run_ante
from celestia_app_tpu_torch.app.gas import GasKVStore, OutOfGas
from celestia_app_tpu_torch.app.module_manager import ModuleManager
from celestia_app_tpu_torch.constants import (
    CONTINUATION_SPARSE_SHARE_CONTENT_SIZE,
    DEFAULT_GOV_MAX_SQUARE_SIZE,
    LATEST_VERSION,
    MAX_CODEC_SQUARE_SIZE,
    SHARE_SIZE,
    SQUARE_SIZE_UPPER_BOUND,
)
from celestia_app_tpu_torch.da import (
    DataAvailabilityHeader,
    extend_shares,
    min_data_availability_header,
)
from celestia_app_tpu_torch.da.eds import speculation_enabled, speculator
from celestia_app_tpu_torch.device import DeviceFault, on_device, resolve_device
from celestia_app_tpu_torch.modules.authz import AuthzError, AuthzKeeper, Grant
from celestia_app_tpu_torch.modules.blob.params import BlobParamsKeeper
from celestia_app_tpu_torch.modules.blob.types import (
    BlobTxError,
    gas_to_consume,
    validate_blob_tx,
    validate_blob_txs_batched,
)
from celestia_app_tpu_torch.modules.blobstream.keeper import (
    BlobstreamKeeper,
    set_data_commitment_window,
)
from celestia_app_tpu_torch.modules.consensus_params import ConsensusParamsKeeper
from celestia_app_tpu_torch.modules.crisis import (
    INVARIANTS,
    InvariantBroken,
    assert_invariants,
)
from celestia_app_tpu_torch.modules.distribution import (
    DistributionError,
    DistributionKeeper,
)
from celestia_app_tpu_torch.modules.feegrant import (
    Allowance,
    FeegrantError,
    FeegrantKeeper,
)
from celestia_app_tpu_torch.modules.gov import GovKeeper, ParamChange, VoteOption
from celestia_app_tpu_torch.modules.ibc import (
    ChannelKeeper,
    Height,
    TransferKeeper,
    build_transfer_stack,
)
from celestia_app_tpu_torch.modules.ibc.handshake import (
    counterparty_proof_time,
    verify_ack_proof,
    verify_recv_proof,
    verify_timeout_proof,
)
from celestia_app_tpu_torch.modules.ibc.ica import (
    CONTROLLER_PORT_PREFIX,
    ICA_HOST_PORT,
    ICAHostKeeper,
    ICAHostModule,
)
from celestia_app_tpu_torch.modules.ibc.transfer import ack_is_error
from celestia_app_tpu_torch.modules.minfee import MinFeeKeeper
from celestia_app_tpu_torch.modules.mint.minter import Minter
from celestia_app_tpu_torch.modules.signal.keeper import SignalKeeper
from celestia_app_tpu_torch.modules.slashing import SlashingError, SlashingKeeper
from celestia_app_tpu_torch.square import builder as square
from celestia_app_tpu_torch.state.accounts import (
    FEE_COLLECTOR,
    VESTING_CONTINUOUS,
    VESTING_DELAYED,
    VESTING_PERIODIC,
    VESTING_PERMANENT,
    AuthKeeper,
    BankKeeper,
    assert_spendable,
    send_spendable,
)
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.state.staking import (
    POWER_REDUCTION,
    StakingError,
    StakingKeeper,
    Validator,
)
from celestia_app_tpu_torch.state.store import CommitStore, KVStore
from celestia_app_tpu_torch.trace import trace_span, traced
from celestia_app_tpu_torch.trace.metrics import registry
from celestia_app_tpu_torch.tx.envelopes import unmarshal_blob_tx
from celestia_app_tpu_torch.tx.messages import (
    MsgAcknowledgement,
    MsgAuthzExec,
    MsgAuthzGrant,
    MsgAuthzRevoke,
    MsgBeginRedelegate,
    MsgCancelUnbondingDelegation,
    MsgCreatePeriodicVestingAccount,
    MsgCreatePermanentLockedAccount,
    MsgCreateValidator,
    MsgCreateVestingAccount,
    MsgDelegate,
    MsgDeposit,
    MsgDepositV1,
    MsgEditValidator,
    MsgFundCommunityPool,
    MsgGrantAllowance,
    MsgMultiSend,
    MsgPayForBlobs,
    MsgRecvPacket,
    MsgRevokeAllowance,
    MsgSend,
    MsgSetWithdrawAddress,
    MsgSignalVersion,
    MsgSubmitEvidence,
    MsgSubmitProposal,
    MsgSubmitProposalV1,
    MsgTimeout,
    MsgTransfer,
    MsgTryUpgrade,
    MsgUndelegate,
    MsgUnjail,
    MsgVerifyInvariant,
    MsgVote,
    MsgVoteV1,
    MsgVoteWeighted,
    MsgVoteWeightedV1,
    MsgWithdrawDelegatorReward,
    MsgWithdrawValidatorCommission,
    _parse_gov_content,
)
from celestia_app_tpu_torch.tx.sign import Tx


@dataclass(frozen=True)
class GenesisAccount:
    address: str
    balance: int  # utia
    pubkey: bytes = b""
    # Optional vesting schedule (x/auth/vesting; celestia mainnet genesis
    # carries vesting accounts): type 1 = continuous, 2 = delayed.
    vesting_type: int = 0
    original_vesting: int = 0
    vesting_start_ns: int = 0
    vesting_end_ns: int = 0


@dataclass(frozen=True)
class Genesis:
    chain_id: str
    genesis_time_ns: int
    accounts: tuple[GenesisAccount, ...] = ()
    validators: tuple[Validator, ...] = ()
    app_version: int = LATEST_VERSION
    gov_max_square_size: int = DEFAULT_GOV_MAX_SQUARE_SIZE
    # x/blobstream DataCommitmentWindow (types/genesis.go:29); 0 = default 400.
    data_commitment_window: int = 0
    # Consensus Block.MaxBytes; 0 derives gov_max_square_size^2 x 482 (the
    # reference's DefaultMaxBytes formula, initial_consts.go:10-14).
    block_max_bytes: int = 0


@dataclass(frozen=True)
class BlockData:
    """PrepareProposal response payload (celestia-core BlockData fork fields,
    app/prepare_proposal.go:84-90)."""

    txs: tuple[bytes, ...]
    square_size: int
    hash: bytes  # the DAH data root


@dataclass
class TxResult:
    code: int  # 0 = ok
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = field(default_factory=list)


class Ctx:
    """A branched state view for one proposal / tx / block."""

    def __init__(self, store: KVStore, height: int, time_ns: int, app_version: int):
        self.store = store
        self.height = height
        self.time_ns = time_ns
        self.app_version = app_version
        self.auth = AuthKeeper(store)
        self.bank = BankKeeper(store)
        self.staking = StakingKeeper(store)

    def branch(self) -> "Ctx":
        return Ctx(self.store.branch(), self.height, self.time_ns, self.app_version)

    def with_store(self, store) -> "Ctx":
        """Same coordinates over a different store view (e.g. gas-metered)."""
        return Ctx(store, self.height, self.time_ns, self.app_version)

    def send_spendable(self, sender: str, recipient: str, amount: int) -> None:
        """Transfer that cannot dip into still-vesting tokens."""
        send_spendable(self.auth, self.bank, sender, recipient, amount, self.time_ns)

    def assert_spendable(self, sender: str, amount: int) -> None:
        assert_spendable(self.auth, self.bank, sender, amount, self.time_ns)


class App:
    """The celestia state machine, its square path on `device` (default
    CUDA; raises without a card)."""

    def __init__(
        self,
        node_min_gas_price: Dec | None = None,
        v2_upgrade_height: int | None = None,
        ibc_token_filter: bool = True,
        square_size_upper_bound: int | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cms = CommitStore()
        self.chain_id = ""
        self.app_version = LATEST_VERSION
        # Height-based v1->v2 upgrade (reference --v2-upgrade-height,
        # cmd/celestia-appd/cmd/root.go:40,142 consumed at app/app.go:458-470).
        self.v2_upgrade_height = v2_upgrade_height
        self.height = 0
        self.genesis_time_ns = 0
        self.last_block_time_ns = 0
        self.node_min_gas_price = node_min_gas_price or Dec.from_str("0.002")
        self.minter = Minter.default()
        # False models a non-celestia counterparty chain (the reference's
        # test/pfm/simapp.go) in IBC tests; celestia itself always filters.
        self.ibc_token_filter = ibc_token_filter
        # The versioned protocol hard cap (128 for v1/v2); the reference's
        # big-block benchmark manifests override it up to 512
        # (test/e2e/benchmark/throughput.go:15-54), clamped to the codec.
        self.square_size_upper_bound = min(
            square_size_upper_bound or SQUARE_SIZE_UPPER_BOUND,
            MAX_CODEC_SQUARE_SIZE,
        )
        self._check_state: KVStore | None = None
        # Own-root memo: (square_size, sha256(square bytes)) -> DAH hash.
        # A data root is a pure function of the square bytes, and this node
        # computes the SAME square's root up to twice per block (Prepare,
        # then Process rebuilding the square from the txs).  Only roots this
        # node computed enter it, and Process still rebuilds the square, so
        # a proposer's claim is never trusted.  Bounded FIFO.
        self._own_roots: dict[tuple[int, bytes], bytes] = {}
        # (square key, EDS, DAH hash) of the freshest square _square_root
        # extended, for the serve plane's commit-time retention.
        self._last_eds: tuple | None = None

    # --- keeper views over committed state ---------------------------------
    @property
    def minfee(self) -> MinFeeKeeper:
        return MinFeeKeeper(self.cms.working)

    @property
    def gov_max_square_size(self) -> int:
        """On-chain x/blob param (read at square_size.go:20-22)."""
        return BlobParamsKeeper(self.cms.working).gov_max_square_size()

    @property
    def gas_per_blob_byte(self) -> int:
        return BlobParamsKeeper(self.cms.working).gas_per_blob_byte()

    @property
    def signal(self) -> SignalKeeper:
        return SignalKeeper(self.cms.working, StakingKeeper(self.cms.working))

    def max_effective_square_size(self) -> int:
        """min(gov, hard cap) — reference app/square_size.go:9-23."""
        return min(self.gov_max_square_size, self.square_size_upper_bound)

    # --- genesis ------------------------------------------------------------
    def init_chain(self, genesis: Genesis) -> None:
        if self.height != 0:
            raise RuntimeError("chain already initialized")
        self.chain_id = genesis.chain_id
        self.app_version = genesis.app_version
        self.genesis_time_ns = genesis.genesis_time_ns
        self.last_block_time_ns = genesis.genesis_time_ns
        BlobParamsKeeper(self.cms.working).set_gov_max_square_size(
            genesis.gov_max_square_size
        )
        if genesis.data_commitment_window:
            set_data_commitment_window(
                self.cms.working, genesis.data_commitment_window
            )
        ConsensusParamsKeeper(self.cms.working).set_block_max_bytes(
            genesis.block_max_bytes
            or genesis.gov_max_square_size**2 * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
        )
        ctx = Ctx(self.cms.working, 0, genesis.genesis_time_ns, self.app_version)
        for acc in genesis.accounts:
            a = ctx.auth.create_account(acc.address, acc.pubkey)
            if acc.vesting_type:
                a.vesting_type = acc.vesting_type
                a.original_vesting = acc.original_vesting
                a.vesting_start_ns = acc.vesting_start_ns or genesis.genesis_time_ns
                a.vesting_end_ns = acc.vesting_end_ns
            ctx.auth.set_account(a)
            if acc.balance:
                ctx.bank.mint(acc.address, acc.balance)

        dist = DistributionKeeper(ctx.store)
        for v in genesis.validators:
            ctx.staking.set_validator(v)
            # A genesis validator's declared power is a notional self-bond;
            # distribution accrues its reward share to the operator.
            dist.set_notional(v.address, v.power * POWER_REDUCTION)
        # x/crisis: the genesis invariant assertion.

        assert_invariants(self.cms.working)
        self.cms.commit(0)
        self._check_state = None

    # --- CheckTx (mempool admission, app/check_tx.go:16-54) ----------------
    def check_tx(self, raw: bytes) -> TxResult:
        if self._check_state is None:
            self._check_state = self.cms.working.branch()
        ctx = Ctx(
            self._check_state, self.height + 1, self.last_block_time_ns, self.app_version
        )
        checked = registry().counter(
            "celestia_checktx_total", "CheckTx admissions by result"
        )
        btx = unmarshal_blob_tx(raw)
        inner = raw
        if btx is not None:
            try:
                validate_blob_tx(btx, device=self.device)
            except BlobTxError as e:
                checked.inc(result="rejected")
                return TxResult(code=11, log=str(e))
            inner = btx.tx
        try:
            tx = Tx.unmarshal(inner)
            res = run_ante(self, ctx, tx, is_check_tx=True, tx_bytes=inner)
        except OutOfGas as e:
            checked.inc(result="rejected")
            return TxResult(code=11, log=str(e))  # sdk ErrOutOfGas
        except (AnteError, ValueError) as e:
            checked.inc(result="rejected")
            return TxResult(code=1, log=str(e))
        checked.inc(result="accepted")
        return TxResult(code=0, gas_wanted=res.gas_wanted, events=[("priority", res.priority)])

    # --- PrepareProposal (app/prepare_proposal.go:22-91) --------------------
    def prepare_proposal(self, raw_txs: list[bytes]) -> BlockData:
        with trace_span("prepare_proposal", layer="app",
                        height=self.height + 1, n_txs=len(raw_txs)):
            raw_txs = self._cap_block_bytes(raw_txs)
            filtered = self._filter_txs(raw_txs)
            sq, kept = square.build(filtered, self.max_effective_square_size())
            if sq.is_empty():
                return BlockData(tuple(kept), 1, self._min_dah_hash())
            with trace_span("square_pipeline", layer="device", e2e="dispatch",
                            k=sq.size, phase="prepare"):
                root = self._square_root(sq.size, sq.share_bytes())
            return BlockData(tuple(kept), sq.size, root)

    def _cap_block_bytes(self, raw_txs: list[bytes]) -> list[bytes]:
        """Keep the prefix of candidate txs fitting the on-chain
        Block.MaxBytes consensus param (celestia-core reaps the mempool
        under this cap before PrepareProposal sees it)."""
        max_bytes = ConsensusParamsKeeper(self.cms.working).block_max_bytes()
        kept, total = [], 0
        for raw in raw_txs:
            if total + len(raw) > max_bytes:
                break  # prefix semantics: a later small tx must not jump an earlier one
            total += len(raw)
            kept.append(raw)
        return kept

    def _filter_txs(self, raw_txs: list[bytes]) -> list[bytes]:
        """FilterTxs (app/validate_txs.go:32): separate tx classes, then
        ante-validate in BLOCK order (normal txs before blob txs,
        validate_txs.go:14,31-36) on one branched state, dropping failures:
        a signer's sequence must advance in the order txs execute."""
        ctx = Ctx(
            self.cms.working.branch(),
            self.height + 1,
            self.last_block_time_ns,
            self.app_version,
        )
        classified = [(raw, unmarshal_blob_tx(raw)) for raw in raw_txs]
        normal: list[bytes] = []
        blob: list[bytes] = []
        for raw, btx in classified:
            if btx is not None:
                continue
            try:
                tx = Tx.unmarshal(raw)
                if any(isinstance(m, MsgPayForBlobs) for m in tx.msgs()):
                    continue  # PFB outside a BlobTx is invalid
                run_ante(self, ctx, tx, is_check_tx=False, tx_bytes=raw)
                normal.append(raw)
            except (AnteError, ValueError, OutOfGas):
                continue
        blob_entries = [(raw, btx) for raw, btx in classified if btx is not None]
        validated = validate_blob_txs_batched(
            [b for _, b in blob_entries], device=self.device
        )
        for (raw, btx), v in zip(blob_entries, validated):
            if isinstance(v, BlobTxError):
                continue
            try:
                run_ante(
                    self, ctx, Tx.unmarshal(btx.tx), is_check_tx=False, tx_bytes=btx.tx
                )
                blob.append(raw)
            except (AnteError, ValueError, OutOfGas):
                continue
        return normal + blob

    def speculate_proposal(
        self, data: BlockData, height: int | None = None,
        round_: int | None = None,
    ) -> bool:
        """Start the proposed square's extend ahead of ProcessProposal
        ($CELESTIA_PIPE_SPECULATE): called the moment a proposal's payload
        is known, so the device works while the prevote window's host work
        runs, and process_proposal's root claims the finished result
        (da.eds.speculator).  False when the seam is off or the payload does
        not match (a square that does not build, or whose size or emptiness
        differs); a fault of the speculative extend raises."""
        if not speculation_enabled():
            return False
        try:
            sq = square.construct(list(data.txs), self.max_effective_square_size())
        except Exception:  # the proposal's content does not build a square
            return False
        if sq.is_empty() or sq.size != data.square_size:
            return False
        k = sq.size
        ods = np.frombuffer(
            bytearray().join(sq.share_bytes()), dtype=np.uint8
        ).reshape(k, k, SHARE_SIZE)
        with on_device("speculative extend"):
            return speculator().speculate(
                ods, height=height, round_=round_, device=self.device
            )

    # --- ProcessProposal (app/process_proposal.go:24-158) -------------------
    def process_proposal(self, data: BlockData) -> bool:
        """True iff the proposal is valid.  Any fault of its content rejects
        it (the reference's recover(), process_proposal.go:29-35); a
        DeviceFault raises."""
        outcomes = registry().counter(
            "celestia_process_proposal_total", "ProcessProposal verdicts"
        )
        with trace_span("process_proposal", layer="app",
                        height=self.height + 1, n_txs=len(data.txs)):
            try:
                ok = self._process_proposal(data)
            except DeviceFault:
                outcomes.inc(result="device_fault")
                raise
            except Exception:
                traced().write("process_proposal_rejections", height=self.height + 1)
                outcomes.inc(result="panic_reject")
                return False
            outcomes.inc(result="accepted" if ok else "rejected")
            return ok

    def _process_proposal(self, data: BlockData) -> bool:
        # Block.MaxBytes is consensus law, not proposer advice: an oversize
        # block is rejected validator-side.
        if sum(len(t) for t in data.txs) > ConsensusParamsKeeper(
            self.cms.working
        ).block_max_bytes():
            return False
        ctx = Ctx(
            self.cms.working.branch(),
            self.height + 1,
            self.last_block_time_ns,
            self.app_version,
        )
        classified = [(raw, unmarshal_blob_tx(raw)) for raw in data.txs]
        # Hot loop (3): every blob's commitment recomputed, batched on device.
        validated = iter(
            validate_blob_txs_batched(
                [b for _, b in classified if b is not None], device=self.device
            )
        )
        for raw, btx in classified:
            if btx is None:
                tx = Tx.unmarshal(raw)
                if any(isinstance(m, MsgPayForBlobs) for m in tx.msgs()):
                    return False  # PFB must ride in a BlobTx (:77-88)
                run_ante(self, ctx, tx, is_check_tx=False, tx_bytes=raw)
            else:
                v = next(validated)
                if isinstance(v, BlobTxError):
                    raise v
                run_ante(
                    self, ctx, Tx.unmarshal(btx.tx), is_check_tx=False, tx_bytes=btx.tx
                )

        sq = square.construct(list(data.txs), self.max_effective_square_size())
        if sq.size != data.square_size:
            return False  # square-size equality (:133)
        if sq.is_empty():
            return self._min_dah_hash() == data.hash
        # Root equality (:152) over the square REBUILT from the raw txs.
        return self._square_root(sq.size, sq.share_bytes()) == data.hash

    def _min_dah_hash(self) -> bytes:
        with on_device("minimal DAH"):
            return min_data_availability_header(device=self.device).hash()

    @staticmethod
    def _square_key(size: int, share_bytes: list[bytes]) -> tuple:
        digest = hashlib.sha256()
        for s in share_bytes:
            digest.update(s)
        return (size, digest.digest())

    def square_eds(self, size: int, share_bytes: list[bytes]):
        """The extended square for a built square's shares — the serve
        plane's rebuild source (rpc/server._rebuild_eds): when the
        content matches the square this app just extended, the SAME
        device-resident handle comes back with zero extra extensions;
        otherwise (a cache-miss rebuild of an old height) it extends
        fresh.  Deliberately NOT a `_last_eds` writer: that slot belongs
        to the consensus path (_square_root), and a concurrent read-side
        rebuild overwriting it would displace the just-extended square
        right before the commit hook retains it.  The rebuild's caller
        admits the result to the forest cache, so repeats are already
        covered there."""
        key = self._square_key(size, share_bytes)
        last = self._last_eds
        if last is not None and last[0] == key:
            return last[1]
        with on_device("extend"):
            return extend_shares(share_bytes, device=self.device)

    def last_eds_for_root(self, data_root: bytes):
        """The freshest extended square IF its DAH hash is `data_root` —
        how the serving plane's commit hook retains the just-committed
        height without reconstructing the square (no second layout
        solve, no duplicate square-journal row, no device work)."""
        last = self._last_eds
        if last is not None and last[2] == data_root:
            return last[1]
        return None

    def _square_root(self, size: int, share_bytes: list[bytes]) -> bytes:
        """DAH hash of a built square, memoized on the square's content."""
        from celestia_app_tpu_torch.serve.cache import serve_heights

        key = self._square_key(size, share_bytes)
        cached = self._own_roots.get(key)
        if cached is not None:
            return cached
        with on_device("extend + DAH"):
            eds = extend_shares(share_bytes, device=self.device)
            root = DataAvailabilityHeader.from_eds(eds).hash()
        if serve_heights() > 0:
            # Keep the freshest EDS handle alive for the serve plane's
            # commit-time retention (ONE handle; the forest cache owns
            # longer-term residency).  Gated so a node with serving
            # disabled holds no extra device memory.
            self._last_eds = (key, eds, root)
        while len(self._own_roots) >= 4:
            self._own_roots.pop(next(iter(self._own_roots)))
        self._own_roots[key] = root
        return root

    # --- block execution ----------------------------------------------------
    def finalize_block(
        self,
        time_ns: int,
        txs: list[bytes],
        last_commit_signers: set[str] | None = None,
        evidence: tuple = (),
    ) -> list[TxResult]:
        """Execute one block.  `last_commit_signers` is the set of operator
        addresses whose precommits made the previous block's commit (ABCI
        RequestBeginBlock.LastCommitInfo) — None skips liveness tracking
        (harnesses without a consensus plane).  `evidence` carries
        consensus.votes.Equivocation records (ByzantineValidators)."""
        height = self.height + 1
        block_store = self.cms.working.branch()
        ctx = Ctx(block_store, height, time_ns, self.app_version)

        self._begin_block(ctx, time_ns, last_commit_signers, evidence)
        results = [self._deliver_tx(ctx, raw) for raw in txs]
        self._end_block(ctx, height)

        delivered = registry().counter(
            "celestia_txs_delivered_total", "delivered txs by result code"
        )
        for r in results:
            delivered.inc(code=str(r.code))

        self.cms.working.write_back(block_store)
        self.height = height
        self.last_block_time_ns = time_ns
        return results

    def commit(self) -> bytes:
        app_hash = self.cms.commit(self.height)
        self._check_state = None  # reset mempool check state each block

        registry().gauge("celestia_block_height", "last committed height").set(
            self.height
        )
        return app_hash

    def _begin_block(
        self,
        ctx: Ctx,
        time_ns: int,
        last_commit_signers: set[str] | None = None,
        evidence: tuple = (),
    ) -> None:
        """x/mint BeginBlocker (x/mint/abci.go:14-20), then x/distribution's
        (sdk begin-block order: mint before distribution, so this block's
        provision and the previous block's tx fees sweep together), then
        x/evidence + x/slashing liveness."""
        supply = ctx.bank.supply()
        self.minter.update(self.genesis_time_ns, time_ns, supply)
        prev = (
            self.minter.previous_block_time_ns
            if self.minter.previous_block_time_ns is not None
            else self.last_block_time_ns
        )
        provision = self.minter.calculate_block_provision(time_ns, prev)
        if provision > 0:
            ctx.bank.mint(FEE_COLLECTOR, provision)
        self.minter.previous_block_time_ns = time_ns

        dist = DistributionKeeper(ctx.store)
        dist.allocate(ctx.bank, ctx.staking)

        if evidence or last_commit_signers is not None:
            slashing = SlashingKeeper(ctx.store)
            # x/evidence BeginBlocker: punish equivocations first (sdk
            # begin-block order: evidence before slashing liveness).
            for ev in evidence:
                try:
                    slashing.handle_equivocation(
                        ctx.staking, ctx.bank, dist,
                        self.chain_id, ev.vote_a, ev.vote_b,
                        current_height=ctx.height,
                    )
                except ValueError:
                    continue  # invalid evidence is dropped, not fatal
            if last_commit_signers is not None:
                for v in ctx.staking.bonded_validators():
                    slashing.handle_validator_signature(
                        ctx.staking, ctx.bank, dist,
                        v.address, v.address in last_commit_signers, time_ns,
                    )

    def simulate_tx(self, raw: bytes) -> TxResult:
        """cosmos.tx.v1beta1.Service/Simulate: run the tx (ante + msgs)
        against a throwaway branch of committed state at the next height
        — signature verification and the gas limit are waived (sdk
        Simulate), gas_used is the real metered consumption, and no state
        survives."""
        ctx = Ctx(
            self.cms.working.branch(), self.height + 1,
            self.last_block_time_ns, self.app_version,
        )
        return self._deliver_tx(ctx, raw, simulate=True)

    def _deliver_tx(
        self, block_ctx: Ctx, raw: bytes, simulate: bool = False
    ) -> TxResult:
        """One tx on a branch of `block_ctx`: its ante chain, then its
        messages.  OutOfGas and every other handler fault become codes 11
        and 2 (with the ante effects kept); InvariantBroken halts: it
        propagates out of finalize_block.  OutOfGas and GasKVStore are
        imported at module level: a function-level import would make the
        name local to the whole function, and the first `except OutOfGas`
        would raise UnboundLocalError."""
        btx = unmarshal_blob_tx(raw)
        inner = btx.tx if btx is not None else raw
        tx_ctx = block_ctx.branch()
        try:
            tx = Tx.unmarshal(inner)
            ante_res = run_ante(
                self, tx_ctx, tx, is_check_tx=False, tx_bytes=inner,
                simulate=simulate,
            )
        except OutOfGas as e:
            return TxResult(code=11, log=str(e))  # sdk ErrOutOfGas, either phase
        except (AnteError, ValueError) as e:
            return TxResult(code=1, log=str(e))

        # The tx's SINGLE gas meter (sdk runTx) carries from the ante chain
        # into execution: store access during message handling is charged
        # the KVStore schedule, and blob gas consumes against the same
        # limit.
        meter = ante_res.meter
        events: list = []
        # Messages run on their own branch (baseapp runMsgs' cache): a failed
        # execution rolls back msg effects ONLY — the ante effects (fee
        # deduction, sequence bump) stay committed, so a failed tx still pays
        # its fee and cannot be replayed (msCache.Write() precedes runMsgs).
        msg_ctx = tx_ctx.branch()
        exec_ctx = msg_ctx.with_store(GasKVStore(msg_ctx.store, meter))
        try:
            for msg in tx.msgs():
                # Simulate runs on an infinite meter, so consumption can
                # legitimately exceed the fee's nominal gas_wanted — the
                # remaining-gas argument must not go negative there.
                remaining = (
                    (1 << 62) if simulate
                    else ante_res.gas_wanted - meter.consumed
                )
                used, evts = self._handle_msg(exec_ctx, msg, remaining)
                if used:
                    meter.consume(used, "execution")
                events.extend(evts)
        except OutOfGas as e:
            block_ctx.store.write_back(tx_ctx.store)  # ante effects persist
            return TxResult(
                code=11,  # sdk ErrOutOfGas
                log=str(e), gas_wanted=ante_res.gas_wanted,
                gas_used=meter.consumed,
            )
        except InvariantBroken:
            # x/crisis: a broken invariant HALTS the chain (the sdk panics
            # in the crisis msg server) — converting it into a failed tx
            # would let a corrupted state keep committing.
            raise
        except Exception as e:
            block_ctx.store.write_back(tx_ctx.store)  # ante effects persist
            return TxResult(
                code=2, log=str(e), gas_wanted=ante_res.gas_wanted,
                gas_used=meter.consumed,
            )
        tx_ctx.store.write_back(msg_ctx.store)
        block_ctx.store.write_back(tx_ctx.store)
        return TxResult(
            code=0, gas_wanted=ante_res.gas_wanted, gas_used=meter.consumed,
            events=events,
        )

    def _handle_msg(self, ctx: Ctx, msg, gas_remaining: int):
        if isinstance(msg, MsgSend):
            total = sum(c.amount for c in msg.amount if c.denom == "utia")
            ctx.send_spendable(msg.from_address, msg.to_address, total)
            # The sdk bank keeper creates the recipient account on first
            # receive (x/bank SendCoins -> SetAccount): a freshly funded
            # address — a multisig, say — must exist before it can sign.
            ctx.auth.get_or_create(msg.to_address)
            return 0, [("transfer", msg.from_address, msg.to_address, total)]
        if isinstance(msg, MsgSubmitEvidence):
            # Reference behavior: the evidence keeper has NO router
            # (app/app.go:348-353 never calls SetRouter), so tx-submitted
            # evidence never succeeds — equivocation evidence arrives via
            # ABCI ByzantineValidators, not txs.  Error text follows the
            # sdk's registered ErrNoEvidenceHandlerExists ("unregistered
            # handler for evidence type").
            raise ValueError(
                "unregistered handler for evidence type: "
                f"{msg.evidence.type_url}"
            )
        if isinstance(msg, MsgVerifyInvariant):
            name = f"{msg.invariant_module_name}/{msg.invariant_route}"
            check = next((c for n, c in INVARIANTS if n == name), None)
            if check is None:
                raise ValueError(f"unknown invariant {name}")
            # ConstantFee: 1000utia to the fee collector (reference
            # default_overrides.go:120) — on-chain invariant checks are
            # priced so they cannot be spammed for free.
            ctx.send_spendable(msg.sender, FEE_COLLECTOR, 1000)
            # On an UNMETERED branch: the sdk runs AssertInvariants under
            # an infinite gas meter (a full-state audit must not die on
            # the tx's gas limit), and some checks settle intermediate
            # state that must not leak into consensus state.  A broken
            # invariant raises InvariantBroken, which deliver()
            # deliberately does NOT convert to a tx error — the chain
            # halts (sdk panic).
            store = (
                ctx.store.unwrap() if hasattr(ctx.store, "unwrap") else ctx.store
            )
            check(store.branch())
            return 0, [(
                "cosmos.crisis.v1beta1.EventInvariantChecked", name,
            )]
        if isinstance(msg, (
            MsgCreateVestingAccount,
            MsgCreatePeriodicVestingAccount,
            MsgCreatePermanentLockedAccount,
        )):
            if ctx.auth.get_account(msg.to_address) is not None:
                # sdk vesting msg server: the target must be brand new.
                raise ValueError(f"account {msg.to_address} already exists")
            acc = ctx.auth.get_or_create(msg.to_address)
            if isinstance(msg, MsgCreateVestingAccount):
                total = sum(c.amount for c in msg.amount if c.denom == "utia")
                acc.vesting_type = (
                    VESTING_DELAYED if msg.delayed else VESTING_CONTINUOUS
                )
                # Continuous vesting starts at the block time (sdk
                # NewContinuousVestingAccount with ctx.BlockTime); delayed
                # ignores the start.
                acc.vesting_start_ns = ctx.time_ns
                acc.vesting_end_ns = msg.end_time * 10**9
            elif isinstance(msg, MsgCreatePeriodicVestingAccount):
                total = msg.total()
                acc.vesting_type = VESTING_PERIODIC
                # Periodic vesting starts at the MSG's start_time (sdk
                # NewPeriodicVestingAccount takes it verbatim).
                acc.vesting_start_ns = msg.start_time * 10**9
                acc.vesting_periods = tuple(
                    (p.length * 10**9,
                     sum(c.amount for c in p.amount if c.denom == "utia"))
                    for p in msg.vesting_periods
                )
                acc.vesting_end_ns = acc.vesting_start_ns + sum(
                    length for length, _ in acc.vesting_periods
                )
            else:
                total = sum(c.amount for c in msg.amount if c.denom == "utia")
                acc.vesting_type = VESTING_PERMANENT
            acc.original_vesting = total
            ctx.auth.set_account(acc)
            ctx.send_spendable(msg.from_address, msg.to_address, total)
            return 0, [(
                "cosmos.vesting.v1beta1.EventCreateVestingAccount",
                msg.to_address, total, acc.vesting_type,
            )]
        if isinstance(msg, MsgMultiSend):
            # Single input (enforced by ValidateBasic, see tx/messages.py),
            # fanned out to every output; recipients are created on first
            # receive like the MsgSend path.
            src = msg.inputs[0].address
            events = []
            for out in msg.outputs:
                total = sum(c.amount for c in out.coins if c.denom == "utia")
                ctx.send_spendable(src, out.address, total)
                ctx.auth.get_or_create(out.address)
                events.append(("transfer", src, out.address, total))
            return 0, events
        if isinstance(msg, MsgAuthzExec):
            return self._handle_authz_exec(ctx, msg, gas_remaining)
        if isinstance(msg, (MsgAuthzGrant, MsgAuthzRevoke)):
            authz = AuthzKeeper(ctx.store)
            try:
                if isinstance(msg, MsgAuthzGrant):
                    authz.grant(
                        msg.granter, msg.grantee,
                        Grant(msg.msg_type_url, msg.spend_limit, msg.expiration_ns),
                    )
                    return 0, [("cosmos.authz.v1beta1.EventGrant",
                                msg.granter, msg.grantee, msg.msg_type_url)]
                authz.revoke(msg.granter, msg.grantee, msg.msg_type_url)
                return 0, [("cosmos.authz.v1beta1.EventRevoke",
                            msg.granter, msg.grantee, msg.msg_type_url)]
            except AuthzError as e:
                raise ValueError(str(e)) from e
        if isinstance(msg, (MsgGrantAllowance, MsgRevokeAllowance)):
            feegrant = FeegrantKeeper(ctx.store)
            try:
                if isinstance(msg, MsgGrantAllowance):
                    feegrant.grant(
                        msg.granter, msg.grantee,
                        Allowance(
                            spend_limit=msg.spend_limit,
                            expiration_ns=msg.expiration_ns,
                            allowed_msgs=msg.allowed_msgs,
                        ),
                    )
                    return 0, [("cosmos.feegrant.v1beta1.EventSetFeeGrant",
                                msg.granter, msg.grantee)]
                feegrant.revoke(msg.granter, msg.grantee)
                return 0, [("cosmos.feegrant.v1beta1.EventRevokeFeeGrant",
                            msg.granter, msg.grantee)]
            except FeegrantError as e:
                raise ValueError(str(e)) from e
        if isinstance(msg, MsgPayForBlobs):
            # keeper.PayForBlobs (x/blob/keeper/keeper.go:43-57): consume
            # shares x 512 x gasPerBlobByte, emit the event.
            gas = gas_to_consume(msg.blob_sizes, self.gas_per_blob_byte)
            if gas > gas_remaining:
                raise ValueError(
                    f"out of gas: blob gas {gas} > remaining {gas_remaining}"
                )
            return gas, [("celestia.blob.v1.EventPayForBlobs", msg.signer, msg.blob_sizes)]
        if isinstance(msg, MsgSignalVersion):
            keeper = SignalKeeper(ctx.store, ctx.staking)
            keeper.signal_version(msg.validator_address, msg.version, self.app_version)
            return 0, []
        if isinstance(msg, MsgTryUpgrade):
            keeper = SignalKeeper(ctx.store, ctx.staking)
            keeper.try_upgrade(ctx.height, self.app_version)
            return 0, []
        if isinstance(msg, (MsgTransfer, MsgRecvPacket, MsgAcknowledgement, MsgTimeout)):
            return self._handle_ibc_msg(ctx, msg)
        if isinstance(msg, (MsgCreateValidator, MsgEditValidator)):
            dist = DistributionKeeper(ctx.store)
            try:
                if isinstance(msg, MsgCreateValidator):
                    self._track_vesting_delegation(
                        ctx, msg.delegator_address, msg.value.amount
                    )
                    ctx.staking.create_validator(
                        ctx.bank, dist, msg.validator_address, msg.pubkey,
                        msg.delegator_address, msg.value.amount,
                        Dec.from_str(msg.commission_rate or "0").raw,
                        msg.min_self_delegation,
                    )
                    # The bounds the operator declared bind every later edit.
                    dist.set_commission_bounds(
                        msg.validator_address,
                        Dec.from_str(msg.commission_max_rate or "1"),
                        Dec.from_str(msg.commission_max_change_rate or "1"),
                    )
                    return 0, [("cosmos.staking.v1beta1.EventCreateValidator",
                                msg.validator_address, msg.value.amount)]
                if not ctx.staking.has_validator(msg.validator_address):
                    raise ValueError(f"no validator {msg.validator_address}")
                if msg.commission_rate:
                    dist.change_commission_rate(
                        msg.validator_address, Dec.from_str(msg.commission_rate)
                    )
                return 0, [("cosmos.staking.v1beta1.EventEditValidator",
                            msg.validator_address)]
            except (StakingError, DistributionError) as e:
                raise ValueError(str(e)) from e
        if isinstance(msg, (MsgDelegate, MsgUndelegate, MsgBeginRedelegate)):
            if msg.amount.denom != "utia":  # x/staking ErrBadDenom
                raise ValueError(
                    f"invalid bond denom {msg.amount.denom!r}, expected utia"
                )
            amount = msg.amount.amount
            # Settle pending rewards before the stake changes (the sdk's
            # BeforeDelegationSharesModified hook; x/distribution hooks.go).

            dist = DistributionKeeper(ctx.store)
            dist.settle(ctx.staking, msg.delegator_address, msg.validator_address)
            if isinstance(msg, MsgBeginRedelegate):
                dist.settle(
                    ctx.staking, msg.delegator_address, msg.validator_dst_address
                )
            if isinstance(msg, MsgDelegate):
                self._track_vesting_delegation(ctx, msg.delegator_address, amount)
                ctx.staking.delegate(
                    ctx.bank, msg.delegator_address, msg.validator_address, amount
                )
                return 0, [("cosmos.staking.v1beta1.EventDelegate",
                            msg.validator_address, amount)]
            if isinstance(msg, MsgUndelegate):
                # No vesting bookkeeping here: the tokens return at
                # unbonding COMPLETION (end blocker), and that's when the
                # lock re-encumbers them (sdk TrackUndelegation runs at
                # CompleteUnbonding) — untracking now would freeze the
                # account's liquid funds for the whole unbonding window.
                completion = ctx.staking.undelegate(
                    ctx.bank, msg.delegator_address, msg.validator_address,
                    amount, ctx.time_ns, height=ctx.height,
                )
                # An operator undelegating below its declared
                # min_self_delegation is jailed (sdk Undelegate's
                # jailValidator path): no skin in the game, no vote.
                min_self = ctx.staking.min_self_delegation(msg.validator_address)
                if (
                    msg.delegator_address == msg.validator_address
                    and min_self
                    and ctx.staking.delegation(
                        msg.delegator_address, msg.validator_address
                    ) < min_self
                    and not ctx.staking.is_jailed(msg.validator_address)
                ):
                    ctx.staking.jail(msg.validator_address)
                return 0, [("cosmos.staking.v1beta1.EventUnbond",
                            msg.validator_address, amount, completion)]
            ctx.staking.begin_redelegate(
                msg.delegator_address, msg.validator_address,
                msg.validator_dst_address, amount,
            )
            # Same skin-in-the-game rule as the undelegate path: an operator
            # redelegating its self-bond below min_self_delegation is jailed
            # (sdk BeginRedelegate jails the source validator too).
            min_self = ctx.staking.min_self_delegation(msg.validator_address)
            if (
                msg.delegator_address == msg.validator_address
                and min_self
                and ctx.staking.delegation(
                    msg.delegator_address, msg.validator_address
                ) < min_self
                and not ctx.staking.is_jailed(msg.validator_address)
            ):
                ctx.staking.jail(msg.validator_address)
            return 0, [("cosmos.staking.v1beta1.EventRedelegate",
                        msg.validator_address, msg.validator_dst_address, amount)]
        if isinstance(msg, MsgCancelUnbondingDelegation):
            # Settle pending rewards before shares change (the same
            # BeforeDelegationSharesModified hook the delegate path runs).
            DistributionKeeper(ctx.store).settle(
                ctx.staking, msg.delegator_address, msg.validator_address
            )
            try:
                ctx.staking.cancel_unbonding(
                    ctx.bank, msg.delegator_address, msg.validator_address,
                    msg.amount.amount, msg.creation_height, ctx.time_ns,
                )
            except StakingError as e:
                raise ValueError(str(e)) from e
            return 0, [(
                "cosmos.staking.v1beta1.EventCancelUnbondingDelegation",
                msg.validator_address, msg.amount.amount, msg.creation_height,
            )]
        if isinstance(msg, MsgUnjail):
            try:
                SlashingKeeper(ctx.store).unjail(
                    ctx.staking, msg.validator_address, ctx.time_ns
                )
            except SlashingError as e:
                raise ValueError(str(e)) from e
            return 0, [("cosmos.slashing.v1beta1.EventUnjail", msg.validator_address)]
        if isinstance(
            msg,
            (
                MsgWithdrawDelegatorReward,
                MsgWithdrawValidatorCommission,
                MsgSetWithdrawAddress,
                MsgFundCommunityPool,
            ),
        ):
            dist = DistributionKeeper(ctx.store)
            try:
                if isinstance(msg, MsgWithdrawDelegatorReward):
                    paid = dist.withdraw_rewards(
                        ctx.bank, ctx.staking,
                        msg.delegator_address, msg.validator_address,
                    )
                    return 0, [(
                        "cosmos.distribution.v1beta1.EventWithdrawRewards",
                        msg.validator_address, paid,
                    )]
                if isinstance(msg, MsgWithdrawValidatorCommission):
                    paid = dist.withdraw_commission(ctx.bank, msg.validator_address)
                    return 0, [(
                        "cosmos.distribution.v1beta1.EventWithdrawCommission", paid,
                    )]
                if isinstance(msg, MsgSetWithdrawAddress):
                    dist.set_withdraw_address(
                        msg.delegator_address, msg.withdraw_address
                    )
                    return 0, []
                total = sum(c.amount for c in msg.amount if c.denom == "utia")
                ctx.assert_spendable(msg.depositor, total)
                dist.fund_community_pool(ctx.bank, msg.depositor, total)
                return 0, [(
                    "cosmos.distribution.v1beta1.EventFundCommunityPool", total,
                )]
            except DistributionError as e:
                raise ValueError(str(e)) from e
        if isinstance(msg, (
            MsgSubmitProposal, MsgSubmitProposalV1,
            MsgVote, MsgVoteV1, MsgVoteWeighted, MsgVoteWeightedV1,
            MsgDeposit, MsgDepositV1,
        )):
            gov = GovKeeper(ctx.store, ctx.staking, ctx.bank)
            if isinstance(msg, MsgSubmitProposalV1):
                # gov v1: the single MsgExecLegacyContent's Content maps
                # onto the same proposal shape the v1beta1 surface takes
                # (the gov router executes legacy Content only).

                exec_msg = msg.legacy_content()
                (
                    _title, _desc, v1_changes, spend_recipient, spend_amount,
                ) = _parse_gov_content(exec_msg.content)
                msg = MsgSubmitProposal(
                    _title, _desc, v1_changes, msg.initial_deposit,
                    msg.proposer, spend_recipient, spend_amount,
                )
            if isinstance(msg, MsgSubmitProposal):
                deposit = sum(c.amount for c in msg.initial_deposit if c.denom == "utia")
                ctx.assert_spendable(msg.proposer, deposit)
                spend = None
                if msg.spend_recipient:
                    spend = (
                        msg.spend_recipient,
                        sum(c.amount for c in msg.spend_amount if c.denom == "utia"),
                    )
                pid = gov.submit(
                    msg.proposer,
                    [ParamChange(c.subspace, c.key, c.value) for c in msg.changes],
                    deposit,
                    ctx.time_ns,
                    spend=spend,
                )
                return 0, [("cosmos.gov.v1beta1.EventSubmitProposal", pid)]
            if isinstance(msg, (MsgVote, MsgVoteV1)):
                gov.vote(msg.proposal_id, msg.voter, msg.option, ctx.time_ns)
                return 0, [("cosmos.gov.v1beta1.EventVote", msg.proposal_id, msg.voter)]
            if isinstance(msg, (MsgVoteWeighted, MsgVoteWeightedV1)):
                gov.vote_weighted(
                    msg.proposal_id, msg.voter,
                    [(VoteOption(o), Dec.from_str(w)) for o, w in msg.options],
                    ctx.time_ns,
                )
                return 0, [("cosmos.gov.v1beta1.EventVote", msg.proposal_id, msg.voter)]
            deposit = sum(c.amount for c in msg.amount if c.denom == "utia")
            ctx.assert_spendable(msg.depositor, deposit)
            gov.deposit(msg.proposal_id, msg.depositor, deposit, ctx.time_ns)
            return 0, [("cosmos.gov.v1beta1.EventDeposit", msg.proposal_id, deposit)]
        raise ValueError(f"no handler for {type(msg).__name__}")

    @staticmethod
    def _track_vesting_delegation(ctx: Ctx, delegator: str, amount: int) -> None:
        """Vesting bookkeeping BEFORE a staking escrow moves: delegations
        (incl. a create-validator self-bond) consume locked tokens first
        (sdk TrackDelegation), so a vesting account's later-received
        liquid funds stay spendable."""
        acc = ctx.auth.get_account(delegator)
        if acc is not None and acc.vesting_type:
            acc.track_delegation(amount, ctx.time_ns)
            ctx.auth.set_account(acc)

    def _handle_authz_exec(self, ctx: Ctx, msg, gas_remaining: int):
        """MsgExec (sdk authz DispatchActions): each inner msg's signer is
        the GRANTER; the grant (granter -> grantee=tx signer, msg type) is
        checked-and-consumed, then the msg runs through the normal
        handlers.  PFBs cannot ride in an exec (blobs only travel in
        BlobTxs), matching the reference's gatekeeping."""

        authz = AuthzKeeper(ctx.store)
        gas_total, events = 0, []
        for inner in msg.inner_msgs():
            if isinstance(inner, (MsgPayForBlobs, MsgAuthzExec)):
                raise ValueError(
                    f"{type(inner).__name__} cannot be nested in MsgExec"
                )
            granter = getattr(inner, "signer", None) or getattr(
                inner, "from_address", None
            )
            if not granter:
                raise ValueError(
                    f"cannot determine granter for {type(inner).__name__}"
                )
            try:
                authz.accept(granter, msg.grantee, inner, ctx.time_ns)
            except AuthzError as e:
                raise ValueError(str(e)) from e
            used, evts = self._handle_msg(ctx, inner, gas_remaining - gas_total)
            gas_total += used
            events.extend(evts)
        return gas_total, events

    def _handle_ibc_msg(self, ctx: Ctx, msg):
        """Transfer sends + the three relay callbacks through the versioned
        middleware stack (tokenfilter > PFM [v2] > transfer,
        app/app.go:329-346)."""


        channels = ChannelKeeper(ctx.store)
        if isinstance(msg, MsgTransfer):
            if msg.token.denom == "utia":
                # Escrow is an outflow: vesting tokens cannot leave via IBC.
                ctx.assert_spendable(msg.sender, msg.token.amount)
            keeper = TransferKeeper(channels, ctx.bank)
            packet = keeper.send_transfer(
                source_channel=msg.source_channel,
                sender=msg.sender,
                receiver=msg.receiver,
                denom=msg.token.denom,
                amount=msg.token.amount,
                timeout_height=Height(
                    msg.timeout_revision_number, msg.timeout_revision_height
                ),
                timeout_timestamp_ns=msg.timeout_timestamp_ns,
                memo=msg.memo,
                source_port=msg.source_port,
            )
            return 0, [("ibc.send_packet", packet.marshal().hex())]
        if isinstance(msg, MsgRecvPacket):
            packet = msg.packet()
            # Redundant relays are no-op successes in DeliverTx (ibc-go
            # ErrNoOpMsg), so a racing relayer's batched siblings survive.
            if channels.has_receipt(packet):
                return 0, [("ibc.noop", "recv", packet.sequence)]
            dest_chan = channels.channel(
                packet.destination_port, packet.destination_channel
            )
            if dest_chan.connection_id:
                # Connection-backed channel: the packet commitment must be
                # PROVEN in the sender's state through the light client.

                verify_recv_proof(
                    ctx.store, dest_chan, packet,
                    msg.state_proof(), msg.proof_height,
                )
            channels.recv_packet(packet, ctx.height, ctx.time_ns)
            # The app callback runs on a cache; its state lands only when
            # the ack is a success (ibc-go msg_server.go RecvPacket's
            # cacheCtx) — an error ack must not leave minted vouchers or
            # half-done forwards behind.  The destination port routes to
            # the app module (ibc-go's port router): transfer or icahost.
            recv_ctx = ctx.branch()

            if packet.destination_port == ICA_HOST_PORT:
                if self.app_version < 2:
                    raise ValueError(
                        "icahost is a v2 module (app/modules.go:185-187)"
                    )

                ica = ICAHostModule(
                    ICAHostKeeper(recv_ctx.store), self._handle_msg
                )
                ack, recv_events = ica.on_recv_packet(recv_ctx, packet)
            else:
                recv_keeper = TransferKeeper(
                    ChannelKeeper(recv_ctx.store), recv_ctx.bank
                )
                stack = build_transfer_stack(
                    self.app_version, recv_keeper,
                    token_filter=self.ibc_token_filter,
                )
                ack = stack.on_recv_packet(recv_ctx, packet)
                # Middleware (PFM) may have sent onward packets during recv.
                recv_events = [
                    ("ibc.send_packet", p.marshal().hex()) for p in recv_keeper.sent
                ]
            events = [("ibc.write_acknowledgement", packet.marshal().hex(), ack.hex())]
            if not ack_is_error(ack):
                ctx.store.write_back(recv_ctx.store)
                events += recv_events
            channels.write_acknowledgement(packet, ack)
            return 0, events

        def _ica_port(port: str) -> bool:
            # Port routing (ibc-go's router): the ONLY non-transfer app
            # here is ICA; every other port belongs to the transfer app
            # (send_transfer escrows for arbitrary ports, so the refund
            # callbacks must fire for them too).
            return port == ICA_HOST_PORT or port.startswith(CONTROLLER_PORT_PREFIX)

        keeper = TransferKeeper(channels, ctx.bank)
        stack = build_transfer_stack(
            self.app_version, keeper, token_filter=self.ibc_token_filter
        )
        if isinstance(msg, MsgAcknowledgement):
            packet = msg.packet()
            if channels.packet_commitment(
                packet.source_port, packet.source_channel, packet.sequence
            ) is None:
                return 0, [("ibc.noop", "ack", packet.sequence)]
            src_chan = channels.channel(packet.source_port, packet.source_channel)
            if src_chan.connection_id:
                verify_ack_proof(
                    ctx.store, src_chan, packet, msg.acknowledgement,
                    msg.state_proof(), msg.proof_height,
                )
            channels.acknowledge_packet(packet)
            # Only ICA acks bypass the transfer app's refund-on-error
            # callback; an ICA controller's ack just clears the commitment.
            if not _ica_port(packet.source_port):
                stack.on_acknowledgement_packet(ctx, packet, msg.acknowledgement)
            return 0, [("ibc.acknowledge_packet", packet.sequence)]
        packet = msg.packet()  # MsgTimeout
        if channels.packet_commitment(
            packet.source_port, packet.source_channel, packet.sequence
        ) is None:
            return 0, [("ibc.noop", "timeout", packet.sequence)]
        src_chan = channels.channel(packet.source_port, packet.source_channel)
        if src_chan.connection_id:
            # Proven non-receipt on the counterparty at the proof height;
            # the timestamp bound comes from the counterparty's ATTESTED
            # consensus time at that height, never the local clock (a
            # lagging local clock would otherwise let the sender refund
            # escrow while the receiver could still accept the packet).

            verify_timeout_proof(
                ctx.store, src_chan, packet, msg.state_proof(), msg.proof_height
            )
            proof_time_ns = counterparty_proof_time(
                ctx.store, src_chan, msg.proof_height
            )
        else:
            # Harness-direct channels (no connection/client): trusted mode.
            proof_time_ns = ctx.time_ns
        channels.timeout_packet(packet, msg.proof_height, proof_time_ns)
        if not _ica_port(packet.source_port):
            stack.on_timeout_packet(ctx, packet)
        return 0, [("ibc.timeout_packet", packet.sequence)]

    def _end_block(self, ctx: Ctx, height: int) -> None:
        """Gov clocks + blobstream (v1 only) + height/signal upgrades
        (app/app.go:458-477)."""

        GovKeeper(ctx.store, ctx.staking, ctx.bank).end_blocker(ctx.time_ns)
        # Matured unbonding delegations release back to delegators
        # (x/staking EndBlocker's unbonding queue); returning tokens
        # re-encumber a vesting account's lock (sdk TrackUndelegation at
        # CompleteUnbonding).
        for delegator, amount in ctx.staking.complete_unbondings(
            ctx.bank, ctx.time_ns
        ):
            acc = ctx.auth.get_account(delegator)
            if acc is not None and acc.vesting_type:
                acc.track_undelegation(amount)
                ctx.auth.set_account(acc)
        if self.app_version == 1:
            BlobstreamKeeper(ctx.store, ctx.staking).end_blocker(height, ctx.time_ns)
        if (
            self.app_version == 1
            and self.v2_upgrade_height is not None
            and height >= self.v2_upgrade_height
        ):
            ModuleManager().run_migrations(ctx, 1, 2)
            self.app_version = 2
            return
        if self.app_version >= 2:
            keeper = SignalKeeper(ctx.store, ctx.staking)
            up = keeper.should_upgrade(height)
            if up is not None:
                ModuleManager().run_migrations(ctx, self.app_version, up.app_version)
                self.app_version = up.app_version
                keeper.reset_tally()
