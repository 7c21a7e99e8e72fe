"""The ABCI application's proposal half: CheckTx, PrepareProposal and
ProcessProposal on the port's square path.

Behavioral parity with the reference app package, as the JAX package's
celestia_app_tpu/app/app.py holds it:

  PrepareProposal  app/prepare_proposal.go:22-91   filter -> build square ->
                                                   RS-extend -> DAH -> root
  ProcessProposal  app/process_proposal.go:24-158  decode/validate every tx,
                                                   reconstruct, compare root
  CheckTx          app/check_tx.go:16-54           BlobTx unwrap + ante

`App(..., device=None)` runs its device work on `device`: the blob share
commitments (modules/blob/types -> inclusion.batched) and the extend + DAH
(da.extend_shares); None means CUDA and raises without a card, "cpu" runs
the plain kernel versions.  Block execution (FinalizeBlock, Commit and the
message handlers, with the JAX App's `v2_upgrade_height` and
`ibc_token_filter` options, which only they read) is not ported yet
(ROADMAP, queue 1).

Two deliberate differences from the JAX App, both because no fallback may
hide the device:
  * ProcessProposal rejects a proposal on any fault of its content, as the
    reference's recover() does, but a fault of the device or a kernel
    (device.DeviceFault) raises to the caller instead of voting False.
  * speculate_proposal returns False only on a mismatch (a square that does
    not build, or whose size or emptiness differs from the proposal's); a
    fault of the speculative extend raises.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from celestia_app_tpu_torch.app.ante import AnteError, run_ante
from celestia_app_tpu_torch.app.gas import OutOfGas
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
from celestia_app_tpu_torch.modules.blob.params import BlobParamsKeeper
from celestia_app_tpu_torch.modules.blob.types import (
    BlobTxError,
    validate_blob_tx,
    validate_blob_txs_batched,
)
from celestia_app_tpu_torch.modules.consensus_params import ConsensusParamsKeeper
from celestia_app_tpu_torch.modules.minfee import MinFeeKeeper
from celestia_app_tpu_torch.modules.mint.minter import Minter
from celestia_app_tpu_torch.modules.signal.keeper import SignalKeeper
from celestia_app_tpu_torch.square import builder as square
from celestia_app_tpu_torch.state.accounts import AuthKeeper, BankKeeper
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.state.staking import StakingKeeper, Validator
from celestia_app_tpu_torch.state.store import CommitStore, KVStore
from celestia_app_tpu_torch.trace import trace_span, traced
from celestia_app_tpu_torch.trace.metrics import registry
from celestia_app_tpu_torch.tx.envelopes import unmarshal_blob_tx
from celestia_app_tpu_torch.tx.messages import MsgPayForBlobs
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
        from celestia_app_tpu_torch.state.accounts import send_spendable

        send_spendable(self.auth, self.bank, sender, recipient, amount, self.time_ns)


class App:
    """The celestia state machine's proposal half, on the port's square
    path on `device` (default CUDA; raises without a card)."""

    def __init__(
        self,
        node_min_gas_price: Dec | None = None,
        square_size_upper_bound: int | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cms = CommitStore()
        self.chain_id = ""
        self.app_version = LATEST_VERSION
        self.height = 0
        self.genesis_time_ns = 0
        self.last_block_time_ns = 0
        self.node_min_gas_price = node_min_gas_price or Dec.from_str("0.002")
        self.minter = Minter.default()
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
            from celestia_app_tpu_torch.modules.blobstream.keeper import (
                set_data_commitment_window,
            )

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
        from celestia_app_tpu_torch.modules.distribution import DistributionKeeper
        from celestia_app_tpu_torch.state.staking import POWER_REDUCTION

        dist = DistributionKeeper(ctx.store)
        for v in genesis.validators:
            ctx.staking.set_validator(v)
            # A genesis validator's declared power is a notional self-bond;
            # distribution accrues its reward share to the operator.
            dist.set_notional(v.address, v.power * POWER_REDUCTION)
        # x/crisis: the genesis invariant assertion.
        from celestia_app_tpu_torch.modules.crisis import assert_invariants

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

    def _square_root(self, size: int, share_bytes: list[bytes]) -> bytes:
        """DAH hash of a built square, memoized on the square's content."""
        key = self._square_key(size, share_bytes)
        cached = self._own_roots.get(key)
        if cached is not None:
            return cached
        with on_device("extend + DAH"):
            eds = extend_shares(share_bytes, device=self.device)
            root = DataAvailabilityHeader.from_eds(eds).hash()
        while len(self._own_roots) >= 4:
            self._own_roots.pop(next(iter(self._own_roots)))
        self._own_roots[key] = root
        return root
