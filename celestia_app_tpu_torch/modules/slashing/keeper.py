"""x/slashing + x/evidence: liveness tracking, downtime jailing, and
equivocation (double-sign) punishment.

The reference wires cosmos-sdk x/slashing and x/evidence
(app/modules.go:133-135,147-149) with celestia-tuned genesis
(app/default_overrides.go:100-111):

    SignedBlocksWindow       5000 blocks
    MinSignedPerWindow       0.75
    DowntimeJailDuration     1 minute
    SlashFractionDoubleSign  0.02 (2%)
    SlashFractionDowntime    0    (downtime jails but does NOT slash)

Liveness follows the sdk's sliding-window scheme: each bonded validator
has a missed-block bitmap over the window; when misses exceed
window - ceil(0.75 x window), the validator is jailed (and slashed by the
downtime fraction — zero on celestia) and its window resets.  MsgUnjail
restores a downtime-jailed validator after the jail duration; an
equivocation tombstones forever (sdk Tombstone semantics).

Evidence here is native to this framework's consensus plane: an
Equivocation is two verified votes by one validator for the SAME height
and vote type but DIFFERENT block ids (consensus/votes.py), the exact
condition Tendermint's evidence pool gossips as DuplicateVoteEvidence.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.state.store import KVStore

SIGNED_BLOCKS_WINDOW = 5000
MIN_SIGNED_PER_WINDOW = Dec.from_str("0.75")
DOWNTIME_JAIL_DURATION_NS = 60 * 10**9  # 1 minute
SLASH_FRACTION_DOUBLE_SIGN = Dec.from_str("0.02")
SLASH_FRACTION_DOWNTIME = Dec.from_str("0")

# Evidence max age in blocks: UnbondingTime / GoalBlockTime + 1 (reference
# app/default_overrides.go:254 DefaultEvidenceParams).
EVIDENCE_MAX_AGE_BLOCKS = (3 * 7 * 24 * 3600) // 15 + 1

_INFO_PREFIX = b"slash/info/"
_BITMAP_PREFIX = b"slash/bitmap/"
_PARAMS_KEY = b"slash/params"


class SlashingError(ValueError):
    pass


@dataclass
class SigningInfo:
    """sdk ValidatorSigningInfo: the liveness ledger for one validator."""

    index_offset: int = 0
    missed_blocks: int = 0
    jailed_until_ns: int = 0
    tombstoned: bool = False

    def marshal(self) -> bytes:
        return (
            f"{self.index_offset}/{self.missed_blocks}/"
            f"{self.jailed_until_ns}/{int(self.tombstoned)}"
        ).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "SigningInfo":
        a, b, c, d = raw.decode().split("/")
        return cls(int(a), int(b), int(c), bool(int(d)))


@dataclass(frozen=True)
class Params:
    signed_blocks_window: int = SIGNED_BLOCKS_WINDOW
    min_signed_per_window: Dec = MIN_SIGNED_PER_WINDOW
    downtime_jail_duration_ns: int = DOWNTIME_JAIL_DURATION_NS
    slash_fraction_double_sign: Dec = SLASH_FRACTION_DOUBLE_SIGN
    slash_fraction_downtime: Dec = SLASH_FRACTION_DOWNTIME

    @property
    def max_missed(self) -> int:
        """Misses beyond this jail the validator: window - ceil(min x window)."""
        min_signed = self.min_signed_per_window.mul_int(
            self.signed_blocks_window
        ).ceil_int()
        return self.signed_blocks_window - min_signed


class SlashingKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    # --- params -------------------------------------------------------------
    def params(self) -> Params:
        raw = self.store.get(_PARAMS_KEY)
        if not raw:
            return Params()
        w, m, j, ds, dt = raw.decode().split("|")
        return Params(int(w), Dec(int(m)), int(j), Dec(int(ds)), Dec(int(dt)))

    def set_params(self, p: Params) -> None:
        self.store.set(
            _PARAMS_KEY,
            f"{p.signed_blocks_window}|{p.min_signed_per_window.raw}|"
            f"{p.downtime_jail_duration_ns}|{p.slash_fraction_double_sign.raw}|"
            f"{p.slash_fraction_downtime.raw}".encode(),
        )

    # --- signing info --------------------------------------------------------
    def signing_info(self, validator: str) -> SigningInfo:
        raw = self.store.get(_INFO_PREFIX + validator.encode())
        return SigningInfo.unmarshal(raw) if raw else SigningInfo()

    def signing_infos(self) -> list[tuple[str, SigningInfo]]:
        """Every recorded (validator, SigningInfo), address-ordered — the
        sdk SigningInfos query's walk of the info prefix."""
        return [
            (key[len(_INFO_PREFIX):].decode(), SigningInfo.unmarshal(raw))
            for key, raw in self.store.iterate(_INFO_PREFIX)
        ]

    def _set_info(self, validator: str, info: SigningInfo) -> None:
        self.store.set(_INFO_PREFIX + validator.encode(), info.marshal())

    def _bitmap(self, validator: str, info: SigningInfo, window: int) -> bytearray:
        raw = self.store.get(_BITMAP_PREFIX + validator.encode())
        bm = bytearray(raw) if raw else bytearray((window + 7) // 8)
        if len(bm) != (window + 7) // 8:
            # Window param changed: the whole ledger resets together — a
            # fresh bitmap with a stale missed_blocks counter could never
            # decrement (every slot reads un-missed) and would jail a
            # validator that signs perfectly.
            bm = bytearray((window + 7) // 8)
            info.index_offset = 0
            info.missed_blocks = 0
        return bm

    def _reset_window(self, validator: str, info: SigningInfo, window: int) -> None:
        info.missed_blocks = 0
        info.index_offset = 0
        self.store.set(
            _BITMAP_PREFIX + validator.encode(), bytes((window + 7) // 8)
        )

    # --- liveness (BeginBlocker per bonded validator) ------------------------
    def handle_validator_signature(
        self, staking, bank, dist, validator: str, signed: bool, time_ns: int
    ) -> bool:
        """The sdk's HandleValidatorSignature: advance the sliding window,
        jail (+ slash the downtime fraction) when misses cross the line.
        Returns True if the validator was jailed by this call."""
        p = self.params()
        info = self.signing_info(validator)
        bm = self._bitmap(validator, info, p.signed_blocks_window)
        idx = info.index_offset % p.signed_blocks_window
        byte_i, bit = divmod(idx, 8)
        was_missed = bool(bm[byte_i] >> bit & 1)
        now_missed = not signed
        if was_missed != now_missed:
            bm[byte_i] ^= 1 << bit
            info.missed_blocks += 1 if now_missed else -1
            self.store.set(_BITMAP_PREFIX + validator.encode(), bytes(bm))
        info.index_offset += 1

        jailed = False
        if info.missed_blocks > p.max_missed and not staking.is_jailed(validator):
            if p.slash_fraction_downtime.raw:
                staking.slash(bank, dist, validator, p.slash_fraction_downtime.raw)
            staking.jail(validator)
            info.jailed_until_ns = time_ns + p.downtime_jail_duration_ns
            self._reset_window(validator, info, p.signed_blocks_window)
            jailed = True
        self._set_info(validator, info)
        return jailed

    # --- equivocation (x/evidence Equivocation handling) ----------------------
    def handle_equivocation(
        self, staking, bank, dist, chain_id: str, vote_a, vote_b,
        current_height: int | None = None,
    ) -> int:
        """Verify the two conflicting votes, slash 2%, tombstone, jail
        forever.  Returns the burned amount.  A tombstoned validator is
        punished once (sdk: evidence for a tombstoned validator is a
        no-op).  Evidence older than the unbonding window is rejected
        (reference app/default_overrides.go:249-254: MaxAgeNumBlocks =
        UnbondingTime/GoalBlockTime + 1) — slashing for an infraction the
        current delegators could not have witnessed would burn stake that
        joined after the fault."""
        from celestia_app_tpu_torch.crypto.keys import PublicKey

        if (
            vote_a.validator != vote_b.validator
            or vote_a.height != vote_b.height
            or getattr(vote_a, "round", 0) != getattr(vote_b, "round", 0)
            or vote_a.vote_type != vote_b.vote_type
            or vote_a.block_hash == vote_b.block_hash
        ):
            raise SlashingError("votes are not an equivocation pair")
        if current_height is not None and (
            vote_a.height < current_height - EVIDENCE_MAX_AGE_BLOCKS
        ):
            raise SlashingError(
                f"equivocation at height {vote_a.height} is older than the "
                f"evidence window ({EVIDENCE_MAX_AGE_BLOCKS} blocks before "
                f"{current_height})"
            )
        val = staking.get_validator(vote_a.validator)
        if val is None:
            raise SlashingError(f"no validator {vote_a.validator}")
        pubkey = PublicKey(val.pubkey)
        if not (vote_a.verify(pubkey, chain_id) and vote_b.verify(pubkey, chain_id)):
            raise SlashingError("equivocation votes fail signature verification")

        info = self.signing_info(val.address)
        if info.tombstoned:
            return 0
        p = self.params()
        burned = staking.slash(
            bank, dist, val.address, p.slash_fraction_double_sign.raw
        )
        staking.jail(val.address)
        info.tombstoned = True
        info.jailed_until_ns = (1 << 62)  # never
        self._set_info(val.address, info)
        return burned

    # --- MsgUnjail ------------------------------------------------------------
    def unjail(self, staking, validator: str, time_ns: int) -> None:
        """x/slashing MsgUnjail (operator-signed)."""
        if not staking.is_jailed(validator):
            raise SlashingError(f"validator {validator} is not jailed")
        info = self.signing_info(validator)
        if info.tombstoned:
            raise SlashingError(f"validator {validator} is tombstoned")
        if time_ns < info.jailed_until_ns:
            raise SlashingError(
                f"validator {validator} jailed until {info.jailed_until_ns}"
            )
        # sdk Unjail refuses while the operator's self-bond sits below its
        # declared min_self_delegation (ErrSelfDelegationTooLowToUnjail): a
        # validator jailed by the undelegate-below-min path has
        # jailed_until_ns == 0 and would otherwise unjail immediately
        # without restoring its bond.  Genesis validators' notional
        # self-bond counts as operator stake (state/staking.py header).
        min_self = staking.min_self_delegation(validator)
        if min_self:
            from celestia_app_tpu_torch.modules.distribution import DistributionKeeper

            self_bond = staking.delegation(validator, validator)
            self_bond += DistributionKeeper(self.store).notional(validator)
            if self_bond < min_self:
                raise SlashingError(
                    f"validator {validator} self-delegation {self_bond} is "
                    f"below its min self delegation {min_self}"
                )
        staking.unjail(validator)
