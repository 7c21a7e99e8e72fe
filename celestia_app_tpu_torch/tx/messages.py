"""sdk.Msg types and the Any envelope.

Wire parity with the reference protos: MsgPayForBlobs
(proto/celestia/blob/v1/tx.proto), bank MsgSend (cosmos bank.v1beta1), and
google.protobuf.Any {type_url=1, value=2}.  Each message knows its type URL;
the registry maps URLs back to decoders (the InterfaceRegistry analog,
app/encoding/encoding.go:26).
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    decode_packed_uint32,
    encode_bytes_field,
    encode_packed_uint32_field,
    encode_varint_field,
)

URL_MSG_PAY_FOR_BLOBS = "/celestia.blob.v1.MsgPayForBlobs"
URL_MSG_SEND = "/cosmos.bank.v1beta1.MsgSend"
URL_MSG_MULTI_SEND = "/cosmos.bank.v1beta1.MsgMultiSend"
URL_MSG_CREATE_VESTING_ACCOUNT = "/cosmos.vesting.v1beta1.MsgCreateVestingAccount"
URL_MSG_CREATE_PERIODIC_VESTING_ACCOUNT = (
    "/cosmos.vesting.v1beta1.MsgCreatePeriodicVestingAccount"
)
URL_MSG_CREATE_PERMANENT_LOCKED_ACCOUNT = (
    "/cosmos.vesting.v1beta1.MsgCreatePermanentLockedAccount"
)
URL_MSG_VERIFY_INVARIANT = "/cosmos.crisis.v1beta1.MsgVerifyInvariant"
URL_MSG_SUBMIT_EVIDENCE = "/cosmos.evidence.v1beta1.MsgSubmitEvidence"
URL_MSG_SIGNAL_VERSION = "/celestia.signal.v1.MsgSignalVersion"
URL_MSG_TRY_UPGRADE = "/celestia.signal.v1.MsgTryUpgrade"
URL_MSG_SUBMIT_PROPOSAL = "/cosmos.gov.v1beta1.MsgSubmitProposal"
URL_MSG_VOTE = "/cosmos.gov.v1beta1.MsgVote"
URL_MSG_VOTE_WEIGHTED = "/cosmos.gov.v1beta1.MsgVoteWeighted"
URL_MSG_DEPOSIT = "/cosmos.gov.v1beta1.MsgDeposit"
URL_PARAM_CHANGE_PROPOSAL = "/cosmos.params.v1beta1.ParameterChangeProposal"
URL_MSG_GOV_V1_SUBMIT_PROPOSAL = "/cosmos.gov.v1.MsgSubmitProposal"
URL_MSG_GOV_V1_EXEC_LEGACY_CONTENT = "/cosmos.gov.v1.MsgExecLegacyContent"
URL_MSG_GOV_V1_VOTE = "/cosmos.gov.v1.MsgVote"
URL_MSG_GOV_V1_VOTE_WEIGHTED = "/cosmos.gov.v1.MsgVoteWeighted"
URL_MSG_GOV_V1_DEPOSIT = "/cosmos.gov.v1.MsgDeposit"
URL_COMMUNITY_POOL_SPEND_PROPOSAL = (
    "/cosmos.distribution.v1beta1.CommunityPoolSpendProposal"
)
URL_MSG_TRANSFER = "/ibc.applications.transfer.v1.MsgTransfer"
URL_MSG_RECV_PACKET = "/ibc.core.channel.v1.MsgRecvPacket"
URL_MSG_ACKNOWLEDGEMENT = "/ibc.core.channel.v1.MsgAcknowledgement"
URL_MSG_TIMEOUT = "/ibc.core.channel.v1.MsgTimeout"
URL_MSG_DELEGATE = "/cosmos.staking.v1beta1.MsgDelegate"
URL_MSG_UNDELEGATE = "/cosmos.staking.v1beta1.MsgUndelegate"
URL_MSG_BEGIN_REDELEGATE = "/cosmos.staking.v1beta1.MsgBeginRedelegate"
URL_MSG_CANCEL_UNBONDING = "/cosmos.staking.v1beta1.MsgCancelUnbondingDelegation"
URL_MSG_WITHDRAW_DELEGATOR_REWARD = (
    "/cosmos.distribution.v1beta1.MsgWithdrawDelegatorReward"
)
URL_MSG_WITHDRAW_VALIDATOR_COMMISSION = (
    "/cosmos.distribution.v1beta1.MsgWithdrawValidatorCommission"
)
URL_MSG_SET_WITHDRAW_ADDRESS = "/cosmos.distribution.v1beta1.MsgSetWithdrawAddress"
URL_MSG_FUND_COMMUNITY_POOL = "/cosmos.distribution.v1beta1.MsgFundCommunityPool"
URL_MSG_UNJAIL = "/cosmos.slashing.v1beta1.MsgUnjail"
URL_MSG_CREATE_VALIDATOR = "/cosmos.staking.v1beta1.MsgCreateValidator"
URL_MSG_EDIT_VALIDATOR = "/cosmos.staking.v1beta1.MsgEditValidator"
URL_SECP256K1_PUBKEY_STR = "/cosmos.crypto.secp256k1.PubKey"
URL_MSG_GRANT_ALLOWANCE = "/cosmos.feegrant.v1beta1.MsgGrantAllowance"
URL_MSG_REVOKE_ALLOWANCE = "/cosmos.feegrant.v1beta1.MsgRevokeAllowance"
URL_BASIC_ALLOWANCE = "/cosmos.feegrant.v1beta1.BasicAllowance"
URL_ALLOWED_MSG_ALLOWANCE = "/cosmos.feegrant.v1beta1.AllowedMsgAllowance"
URL_MSG_AUTHZ_GRANT = "/cosmos.authz.v1beta1.MsgGrant"
URL_MSG_AUTHZ_EXEC = "/cosmos.authz.v1beta1.MsgExec"
URL_MSG_AUTHZ_REVOKE = "/cosmos.authz.v1beta1.MsgRevoke"
URL_GENERIC_AUTHORIZATION = "/cosmos.authz.v1beta1.GenericAuthorization"
URL_SEND_AUTHORIZATION = "/cosmos.bank.v1beta1.SendAuthorization"


def _encode_timestamp(ns: int) -> bytes:
    """google.protobuf.Timestamp {seconds=1, nanos=2}."""
    out = encode_varint_field(1, ns // 10**9)
    if ns % 10**9:
        out += encode_varint_field(2, ns % 10**9)
    return out


def _decode_timestamp(raw: bytes) -> int:
    f = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_VARINT}
    return f.get(1, 0) * 10**9 + f.get(2, 0)


@dataclass(frozen=True)
class Any:
    type_url: str
    value: bytes

    def marshal(self) -> bytes:
        return encode_bytes_field(1, self.type_url.encode()) + encode_bytes_field(
            2, self.value
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Any":
        url, value = "", b""
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                url = val.decode()
            elif num == 2 and wt == WIRE_LEN:
                value = val
        return cls(url, value)


@dataclass(frozen=True)
class Coin:
    denom: str
    amount: int

    def marshal(self) -> bytes:
        # cosmos Coin.amount is a decimal string on the wire.
        return encode_bytes_field(1, self.denom.encode()) + encode_bytes_field(
            2, str(self.amount).encode()
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Coin":
        denom, amount = "", 0
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                denom = val.decode()
            elif num == 2 and wt == WIRE_LEN:
                amount = int(val.decode())
        return cls(denom, amount)


@dataclass(frozen=True)
class MsgPayForBlobs:
    """Pays for blob inclusion (reference x/blob/types/payforblob.go:48)."""

    signer: str
    namespaces: tuple[bytes, ...]  # 29-byte encoded namespaces
    blob_sizes: tuple[int, ...]
    share_commitments: tuple[bytes, ...]
    share_versions: tuple[int, ...]

    TYPE_URL = URL_MSG_PAY_FOR_BLOBS

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.signer.encode())
        for ns in self.namespaces:
            out += encode_bytes_field(2, ns)
        out += encode_packed_uint32_field(3, list(self.blob_sizes))
        for c in self.share_commitments:
            out += encode_bytes_field(4, c)
        out += encode_packed_uint32_field(8, list(self.share_versions))
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgPayForBlobs":
        signer = ""
        namespaces: list[bytes] = []
        sizes: list[int] = []
        commitments: list[bytes] = []
        versions: list[int] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                signer = val.decode()
            elif num == 2 and wt == WIRE_LEN:
                namespaces.append(val)
            elif num == 3 and wt == WIRE_LEN:
                sizes.extend(decode_packed_uint32(val))
            elif num == 3 and wt == WIRE_VARINT:
                sizes.append(val)
            elif num == 4 and wt == WIRE_LEN:
                commitments.append(val)
            elif num == 8 and wt == WIRE_LEN:
                versions.extend(decode_packed_uint32(val))
            elif num == 8 and wt == WIRE_VARINT:
                versions.append(val)
        return cls(
            signer, tuple(namespaces), tuple(sizes), tuple(commitments), tuple(versions)
        )

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    def validate_basic(self) -> None:
        """Stateless checks (x/blob/types/payforblob.go ValidateBasic)."""
        from celestia_app_tpu_torch.modules.blob.types import validate_msg_pay_for_blobs

        validate_msg_pay_for_blobs(self)


@dataclass(frozen=True)
class MsgSend:
    from_address: str
    to_address: str
    amount: tuple[Coin, ...]

    TYPE_URL = URL_MSG_SEND

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.from_address.encode())
        out += encode_bytes_field(2, self.to_address.encode())
        for c in self.amount:
            out += encode_bytes_field(3, c.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgSend":
        f, t = "", ""
        coins: list[Coin] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                f = val.decode()
            elif num == 2 and wt == WIRE_LEN:
                t = val.decode()
            elif num == 3 and wt == WIRE_LEN:
                coins.append(Coin.unmarshal(val))
        return cls(f, t, tuple(coins))

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    def validate_basic(self) -> None:
        """Stateless checks (sdk bank MsgSend.ValidateBasic)."""
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.from_address)
        validate_address(self.to_address)
        if not self.amount:
            raise ValueError("send amount must not be empty")
        for c in self.amount:
            if c.amount <= 0:
                raise ValueError(f"send amount must be positive, got {c.amount}")


@dataclass(frozen=True)
class BankIO:
    """cosmos.bank.v1beta1 Input / Output {address=1, coins=2 repeated}."""

    address: str
    coins: tuple[Coin, ...]

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.address.encode())
        for c in self.coins:
            out += encode_bytes_field(2, c.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "BankIO":
        addr = ""
        coins: list[Coin] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                addr = val.decode()
            elif num == 2 and wt == WIRE_LEN:
                coins.append(Coin.unmarshal(val))
        return cls(addr, tuple(coins))


@dataclass(frozen=True)
class MsgMultiSend:
    """cosmos.bank.v1beta1.MsgMultiSend {inputs=1, outputs=2}.

    Deviation from sdk v0.46, aligned with v0.47+: exactly ONE input.
    Multi-input MultiSends require a signature from every input address,
    and this chain's ante admits one signer per tx (PARITY §ante row 11)
    — accepting unsigned inputs would let one signer move other
    accounts' funds, so the single-input rule is enforced statelessly."""

    inputs: tuple[BankIO, ...]
    outputs: tuple[BankIO, ...]

    TYPE_URL = URL_MSG_MULTI_SEND

    def marshal(self) -> bytes:
        out = b""
        for i in self.inputs:
            out += encode_bytes_field(1, i.marshal())
        for o in self.outputs:
            out += encode_bytes_field(2, o.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgMultiSend":
        ins: list[BankIO] = []
        outs: list[BankIO] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                ins.append(BankIO.unmarshal(val))
            elif num == 2 and wt == WIRE_LEN:
                outs.append(BankIO.unmarshal(val))
        return cls(tuple(ins), tuple(outs))

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.inputs[0].address if self.inputs else ""

    def validate_basic(self) -> None:
        """sdk bank MsgMultiSend.ValidateBasic + the single-input rule:
        no inputs/outputs -> ErrNoInputs/ErrNoOutputs; per-denom sums
        must match (ErrInputOutputMismatch); coins positive."""
        from celestia_app_tpu_torch.crypto.keys import validate_address

        if not self.inputs:
            raise ValueError("no inputs to send transaction")
        if len(self.inputs) != 1:
            raise ValueError("multiple senders not allowed")
        if not self.outputs:
            raise ValueError("no outputs to send transaction")
        sums: dict[str, int] = {}
        for io, sign in ((self.inputs, 1), (self.outputs, -1)):
            for entry in io:
                validate_address(entry.address)
                if not entry.coins:
                    raise ValueError("empty coins in multi-send entry")
                for c in entry.coins:
                    if c.amount <= 0:
                        raise ValueError(
                            f"send amount must be positive, got {c.amount}"
                        )
                    if c.denom != "utia":
                        # TIA-only chain: the handler moves utia; a
                        # foreign-denom output would be silently dropped.
                        raise ValueError(
                            f"invalid send denom {c.denom!r}, expected utia"
                        )
                    sums[c.denom] = sums.get(c.denom, 0) + sign * c.amount
        if any(v != 0 for v in sums.values()):
            raise ValueError("sum inputs != sum outputs")


@dataclass(frozen=True)
class MsgSubmitEvidence:
    """cosmos.evidence.v1beta1.MsgSubmitEvidence {submitter=1,
    evidence=2 Any}.

    Reference behavior: the evidence keeper is wired WITHOUT a router
    (/root/reference/app/app.go:348-353 — no SetRouter call), so a
    tx-submitted evidence never succeeds; equivocation evidence reaches
    the chain through the consensus plane (ABCI ByzantineValidators),
    never through this tx.  This framework reproduces the outcome — the
    msg decodes, validates, and always fails (with the sdk's registered
    ErrNoEvidenceHandlerExists text; the reference's exact nil-router
    failure shape is unverifiable in-image)."""

    submitter: str
    evidence: Any

    TYPE_URL = URL_MSG_SUBMIT_EVIDENCE

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.submitter.encode())
        out += encode_bytes_field(2, self.evidence.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgSubmitEvidence":
        f = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_LEN}
        return cls(f.get(1, b"").decode(), Any.unmarshal(f.get(2, b"")))

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.submitter

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.submitter)
        if not self.evidence.type_url:
            raise ValueError("missing evidence")


@dataclass(frozen=True)
class MsgVerifyInvariant:
    """cosmos.crisis.v1beta1.MsgVerifyInvariant {sender=1,
    invariant_module_name=2, invariant_route=3}: run one registered
    invariant on-chain.  A broken invariant HALTS the chain (the sdk
    panics); a passing check just costs the ConstantFee."""

    sender: str
    invariant_module_name: str
    invariant_route: str

    TYPE_URL = URL_MSG_VERIFY_INVARIANT

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.sender.encode())
        out += encode_bytes_field(2, self.invariant_module_name.encode())
        out += encode_bytes_field(3, self.invariant_route.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgVerifyInvariant":
        f = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_LEN}
        return cls(
            f.get(1, b"").decode(), f.get(2, b"").decode(),
            f.get(3, b"").decode(),
        )

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.sender

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.sender)
        if not self.invariant_module_name or not self.invariant_route:
            raise ValueError("invariant module and route must be set")


@dataclass(frozen=True)
class MsgCreateVestingAccount:
    """cosmos.vesting.v1beta1.MsgCreateVestingAccount {from_address=1,
    to_address=2, amount=3 repeated Coin, end_time=4 int64 unix SECONDS,
    delayed=5 bool}: fund a brand-new vesting account.  delayed=false ->
    ContinuousVestingAccount starting at the block time; delayed=true ->
    DelayedVestingAccount (everything releases at end_time)."""

    from_address: str
    to_address: str
    amount: tuple[Coin, ...]
    end_time: int
    delayed: bool = False

    TYPE_URL = URL_MSG_CREATE_VESTING_ACCOUNT

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.from_address.encode())
        out += encode_bytes_field(2, self.to_address.encode())
        for c in self.amount:
            out += encode_bytes_field(3, c.marshal())
        if self.end_time:
            # int64: negatives ride as 10-byte two's-complement varints.
            out += encode_varint_field(4, self.end_time & ((1 << 64) - 1))
        if self.delayed:
            out += encode_varint_field(5, 1)
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgCreateVestingAccount":
        f, t = "", ""
        coins: list[Coin] = []
        ints: dict[int, int] = {}
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                f = val.decode()
            elif num == 2 and wt == WIRE_LEN:
                t = val.decode()
            elif num == 3 and wt == WIRE_LEN:
                coins.append(Coin.unmarshal(val))
            elif wt == WIRE_VARINT:
                ints[num] = val
        from celestia_app_tpu_torch.encoding.proto import int64_from_uvarint

        return cls(
            f, t, tuple(coins), int64_from_uvarint(ints.get(4, 0)), bool(ints.get(5, 0))
        )

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.from_address

    def validate_basic(self) -> None:
        """sdk vesting MsgCreateVestingAccount.ValidateBasic: valid
        addresses, positive coins, end_time > 0."""
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.from_address)
        validate_address(self.to_address)
        # TIA-only chain (tokenfilter): the handler vests utia; silently
        # dropping a foreign denom would report code 0 while locking
        # nothing.
        _validate_utia_coins(self.amount, "vesting amount")
        if self.end_time <= 0:
            raise ValueError("invalid end time")


def _validate_utia_coins(coins: tuple[Coin, ...], what: str) -> None:
    if not coins:
        raise ValueError(f"{what} must not be empty")
    for c in coins:
        if c.amount <= 0:
            raise ValueError(f"{what} must be positive, got {c.amount}")
        if c.denom != "utia":
            raise ValueError(f"invalid {what} denom {c.denom!r}, expected utia")


@dataclass(frozen=True)
class VestingPeriod:
    """cosmos.vesting.v1beta1.Period {length=1 int64 SECONDS, amount=2
    repeated Coin}."""

    length: int  # seconds
    amount: tuple[Coin, ...]

    def marshal(self) -> bytes:
        out = b""
        if self.length:
            out += encode_varint_field(1, self.length & ((1 << 64) - 1))
        for c in self.amount:
            out += encode_bytes_field(2, c.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "VestingPeriod":
        from celestia_app_tpu_torch.encoding.proto import int64_from_uvarint

        length = 0
        coins: list[Coin] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_VARINT:
                length = int64_from_uvarint(val)
            elif num == 2 and wt == WIRE_LEN:
                coins.append(Coin.unmarshal(val))
        return cls(length, tuple(coins))


@dataclass(frozen=True)
class MsgCreatePeriodicVestingAccount:
    """cosmos.vesting.v1beta1.MsgCreatePeriodicVestingAccount
    {from_address=1, to_address=2, start_time=3 int64, vesting_periods=4
    repeated Period}: fund a brand-new account releasing stepwise — each
    period's amount unlocks when its cumulative length elapses past
    start_time."""

    from_address: str
    to_address: str
    start_time: int  # unix seconds
    vesting_periods: tuple[VestingPeriod, ...]

    TYPE_URL = URL_MSG_CREATE_PERIODIC_VESTING_ACCOUNT

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.from_address.encode())
        out += encode_bytes_field(2, self.to_address.encode())
        if self.start_time:
            out += encode_varint_field(3, self.start_time & ((1 << 64) - 1))
        for p in self.vesting_periods:
            out += encode_bytes_field(4, p.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgCreatePeriodicVestingAccount":
        from celestia_app_tpu_torch.encoding.proto import int64_from_uvarint

        f, t, start = "", "", 0
        periods: list[VestingPeriod] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                f = val.decode()
            elif num == 2 and wt == WIRE_LEN:
                t = val.decode()
            elif num == 3 and wt == WIRE_VARINT:
                start = int64_from_uvarint(val)
            elif num == 4 and wt == WIRE_LEN:
                periods.append(VestingPeriod.unmarshal(val))
        return cls(f, t, start, tuple(periods))

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.from_address

    def total(self) -> int:
        return sum(
            c.amount
            for p in self.vesting_periods
            for c in p.amount
            if c.denom == "utia"
        )

    def validate_basic(self) -> None:
        """sdk ValidateBasic: valid addresses, start_time >= 1, at least
        one period, each period length > 0 with valid positive coins."""
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.from_address)
        validate_address(self.to_address)
        if self.start_time < 1:
            # sdk v0.46 rejects a zero/negative anchor — the proto
            # default of 0 would vest everything at epoch.
            raise ValueError(f"invalid start time of {self.start_time}")
        if not self.vesting_periods:
            raise ValueError("vesting periods must not be empty")
        for i, p in enumerate(self.vesting_periods):
            if p.length <= 0:
                raise ValueError(f"invalid period length of {p.length} in period {i}")
            _validate_utia_coins(p.amount, "vesting amount")


@dataclass(frozen=True)
class MsgCreatePermanentLockedAccount:
    """cosmos.vesting.v1beta1.MsgCreatePermanentLockedAccount
    {from_address=1, to_address=2, amount=3 repeated Coin}: fund a
    brand-new account whose tokens never vest (delegatable, never
    spendable)."""

    from_address: str
    to_address: str
    amount: tuple[Coin, ...]

    TYPE_URL = URL_MSG_CREATE_PERMANENT_LOCKED_ACCOUNT

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.from_address.encode())
        out += encode_bytes_field(2, self.to_address.encode())
        for c in self.amount:
            out += encode_bytes_field(3, c.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgCreatePermanentLockedAccount":
        f, t = "", ""
        coins: list[Coin] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                f = val.decode()
            elif num == 2 and wt == WIRE_LEN:
                t = val.decode()
            elif num == 3 and wt == WIRE_LEN:
                coins.append(Coin.unmarshal(val))
        return cls(f, t, tuple(coins))

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.from_address

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.from_address)
        validate_address(self.to_address)
        _validate_utia_coins(self.amount, "locked amount")


@dataclass(frozen=True)
class MsgSignalVersion:
    """Validator signals readiness for an app version (x/signal)."""

    validator_address: str
    version: int

    TYPE_URL = URL_MSG_SIGNAL_VERSION

    def marshal(self) -> bytes:
        return encode_bytes_field(1, self.validator_address.encode()) + encode_varint_field(
            2, self.version
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgSignalVersion":
        addr, version = "", 0
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                addr = val.decode()
            elif num == 2 and wt == WIRE_VARINT:
                version = val
        return cls(addr, version)

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    def validate_basic(self) -> None:
        if not self.validator_address:
            raise ValueError("validator address must not be empty")


@dataclass(frozen=True)
class MsgTryUpgrade:
    """Triggers the upgrade tally (x/signal keeper.TryUpgrade)."""

    signer: str

    TYPE_URL = URL_MSG_TRY_UPGRADE

    def marshal(self) -> bytes:
        return encode_bytes_field(1, self.signer.encode())

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgTryUpgrade":
        signer = ""
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                signer = val.decode()
        return cls(signer)

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.signer)


@dataclass(frozen=True)
class ProposalParamChange:
    """cosmos.params.v1beta1.ParamChange {subspace=1, key=2, value=3}."""

    subspace: str
    key: str
    value: str

    def marshal(self) -> bytes:
        return (
            encode_bytes_field(1, self.subspace.encode())
            + encode_bytes_field(2, self.key.encode())
            + encode_bytes_field(3, self.value.encode())
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "ProposalParamChange":
        f = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_LEN}
        return cls(
            f.get(1, b"").decode(), f.get(2, b"").decode(), f.get(3, b"").decode()
        )


def _parse_gov_content(
    content: Any,
) -> tuple[str, str, tuple, str, tuple]:
    """Decode a gov Content Any -> (title, description, changes,
    spend_recipient, spend_amount).  Supported contents:
    ParameterChangeProposal {title=1, description=2, changes=3} and
    CommunityPoolSpendProposal {title=1, description=2, recipient=3,
    amount=4} (the distrclient.ProposalHandler the reference registers,
    default_overrides.go:207).  Shared by the v1beta1 MsgSubmitProposal
    and gov v1's MsgExecLegacyContent."""
    if content.type_url not in (
        URL_PARAM_CHANGE_PROPOSAL, URL_COMMUNITY_POOL_SPEND_PROPOSAL
    ):
        raise ValueError(f"unsupported proposal content {content.type_url}")
    is_spend = content.type_url == URL_COMMUNITY_POOL_SPEND_PROPOSAL
    title, description, spend_recipient = "", "", ""
    changes: list[ProposalParamChange] = []
    spend_amount: list[Coin] = []
    for cn, cwt, cval in decode_fields(content.value):
        if cn == 1 and cwt == WIRE_LEN:
            title = cval.decode()
        elif cn == 2 and cwt == WIRE_LEN:
            description = cval.decode()
        elif cn == 3 and cwt == WIRE_LEN and not is_spend:
            changes.append(ProposalParamChange.unmarshal(cval))
        elif cn == 3 and cwt == WIRE_LEN:
            spend_recipient = cval.decode()
        elif cn == 4 and cwt == WIRE_LEN and is_spend:
            spend_amount.append(Coin.unmarshal(cval))
    return title, description, tuple(changes), spend_recipient, tuple(spend_amount)


@dataclass(frozen=True)
class MsgSubmitProposal:
    """cosmos.gov.v1beta1.MsgSubmitProposal {content=1 (Any),
    initial_deposit=2, proposer=3}.  Supported contents:
    ParameterChangeProposal {title=1, description=2, changes=3} and
    CommunityPoolSpendProposal {title=1, description=2, recipient=3,
    amount=4} (the distrclient.ProposalHandler the reference registers,
    default_overrides.go:207)."""

    title: str
    description: str
    changes: tuple[ProposalParamChange, ...]
    initial_deposit: tuple[Coin, ...]
    proposer: str
    spend_recipient: str = ""
    spend_amount: tuple[Coin, ...] = ()

    TYPE_URL = URL_MSG_SUBMIT_PROPOSAL

    def _content(self) -> Any:
        body = encode_bytes_field(1, self.title.encode()) + encode_bytes_field(
            2, self.description.encode()
        )
        if self.spend_recipient:
            body += encode_bytes_field(3, self.spend_recipient.encode())
            for c in self.spend_amount:
                body += encode_bytes_field(4, c.marshal())
            return Any(URL_COMMUNITY_POOL_SPEND_PROPOSAL, body)
        for c in self.changes:
            body += encode_bytes_field(3, c.marshal())
        return Any(URL_PARAM_CHANGE_PROPOSAL, body)

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self._content().marshal())
        for c in self.initial_deposit:
            out += encode_bytes_field(2, c.marshal())
        out += encode_bytes_field(3, self.proposer.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgSubmitProposal":
        title, description = "", ""
        changes: tuple[ProposalParamChange, ...] = ()
        deposit: list[Coin] = []
        proposer = ""
        spend_recipient = ""
        spend_amount: tuple[Coin, ...] = ()
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                (
                    title, description, changes, spend_recipient, spend_amount,
                ) = _parse_gov_content(Any.unmarshal(val))
            elif num == 2 and wt == WIRE_LEN:
                deposit.append(Coin.unmarshal(val))
            elif num == 3 and wt == WIRE_LEN:
                proposer = val.decode()
        return cls(
            title, description, changes, tuple(deposit), proposer,
            spend_recipient, spend_amount,
        )

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.proposer

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.proposer)
        for c in self.initial_deposit:
            if c.amount < 0:
                raise ValueError("negative deposit")
        if self.spend_recipient and self.changes:
            # The wire carries exactly one content Any; encoding would
            # silently drop the param changes — reject instead.
            raise ValueError(
                "proposal cannot carry both param changes and a community "
                "pool spend"
            )
        if self.spend_recipient and any(
            c.amount <= 0 for c in self.spend_amount
        ):
            raise ValueError("community pool spend must be positive")


@dataclass(frozen=True)
class MsgVote:
    """cosmos.gov.v1beta1.MsgVote {proposal_id=1, voter=2, option=3}."""

    proposal_id: int
    voter: str
    option: int  # VoteOption numbering (1=yes 2=abstain 3=no 4=veto)

    TYPE_URL = URL_MSG_VOTE

    def marshal(self) -> bytes:
        return (
            encode_varint_field(1, self.proposal_id)
            + encode_bytes_field(2, self.voter.encode())
            + encode_varint_field(3, self.option)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgVote":
        pid, voter, option = 0, "", 0
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_VARINT:
                pid = val
            elif num == 2 and wt == WIRE_LEN:
                voter = val.decode()
            elif num == 3 and wt == WIRE_VARINT:
                option = val
        return cls(pid, voter, option)

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.voter

    def validate_basic(self) -> None:
        if self.proposal_id <= 0:
            raise ValueError("invalid proposal id")
        if self.option not in (1, 2, 3, 4):
            raise ValueError(f"invalid vote option {self.option}")


def encode_weighted_option(option: int, weight: str) -> bytes:
    """WeightedVoteOption {option=1, weight=2 (Dec string)} — the single
    codec for this shape, shared by the MsgVoteWeighted wire form and the
    gov keeper's vote records."""
    return encode_varint_field(1, option) + encode_bytes_field(
        2, weight.encode()
    )


def decode_weighted_option(raw: bytes) -> tuple[int, str]:
    opt, weight = 0, ""
    for n, wt, v in decode_fields(raw):
        if n == 1 and wt == WIRE_VARINT:
            opt = v
        elif n == 2 and wt == WIRE_LEN:
            weight = v.decode()
    return opt, weight


@dataclass(frozen=True)
class MsgVoteWeighted:
    """cosmos.gov.v1beta1.MsgVoteWeighted {proposal_id=1, voter=2,
    options=3 (repeated WeightedVoteOption {option=1, weight=2})} —
    weight is an 18-decimal Dec string on the wire."""

    proposal_id: int
    voter: str
    options: tuple[tuple[int, str], ...]  # (VoteOption number, Dec string)

    TYPE_URL = URL_MSG_VOTE_WEIGHTED

    def marshal(self) -> bytes:
        out = encode_varint_field(1, self.proposal_id)
        out += encode_bytes_field(2, self.voter.encode())
        for opt, weight in self.options:
            out += encode_bytes_field(3, encode_weighted_option(opt, weight))
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgVoteWeighted":
        pid, voter = 0, ""
        options: list[tuple[int, str]] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_VARINT:
                pid = val
            elif num == 2 and wt == WIRE_LEN:
                voter = val.decode()
            elif num == 3 and wt == WIRE_LEN:
                options.append(decode_weighted_option(val))
        return cls(pid, voter, tuple(options))

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.voter

    def validate_basic(self) -> None:
        """Stateless parity with sdk v1beta1 ValidateBasic: options
        non-empty, each weight in (0, 1], no duplicates, total exactly 1 —
        invalid weighted votes must die at CheckTx, not DeliverTx."""
        from celestia_app_tpu_torch.crypto.keys import validate_address
        from celestia_app_tpu_torch.state.dec import Dec

        validate_address(self.voter)
        if self.proposal_id <= 0:
            raise ValueError("invalid proposal id")
        if not self.options:
            raise ValueError("weighted vote needs at least one option")
        total = Dec(0)
        seen: set[int] = set()
        one = Dec.from_int(1)
        for opt, weight in self.options:
            if opt not in (1, 2, 3, 4):
                raise ValueError(f"invalid vote option {opt}")
            if opt in seen:
                raise ValueError(f"duplicate vote option {opt}")
            seen.add(opt)
            w = Dec.from_str(weight)
            if w <= Dec(0) or one < w:
                raise ValueError(f"vote weight {weight} outside (0, 1]")
            total = total.add(w)
        if total.raw != one.raw:
            raise ValueError(f"vote weights must sum to 1, got {total}")


@dataclass(frozen=True)
class MsgDeposit:
    """cosmos.gov.v1beta1.MsgDeposit {proposal_id=1, depositor=2, amount=3}."""

    proposal_id: int
    depositor: str
    amount: tuple[Coin, ...]

    TYPE_URL = URL_MSG_DEPOSIT

    def marshal(self) -> bytes:
        out = encode_varint_field(1, self.proposal_id)
        out += encode_bytes_field(2, self.depositor.encode())
        for c in self.amount:
            out += encode_bytes_field(3, c.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgDeposit":
        pid, depositor = 0, ""
        coins: list[Coin] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_VARINT:
                pid = val
            elif num == 2 and wt == WIRE_LEN:
                depositor = val.decode()
            elif num == 3 and wt == WIRE_LEN:
                coins.append(Coin.unmarshal(val))
        return cls(pid, depositor, tuple(coins))

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.depositor

    def validate_basic(self) -> None:
        if self.proposal_id <= 0:
            raise ValueError("invalid proposal id")
        if not self.amount or any(c.amount <= 0 for c in self.amount):
            raise ValueError("deposit must be positive")


# --- gov v1 (cosmos.gov.v1, sdk v0.46) -------------------------------------
#
# The reference chain serves BOTH gov msg servers (the sdk wires v1 and
# v1beta1 side by side); modern clients speak v1, where a proposal carries
# arbitrary messages and legacy Content rides inside MsgExecLegacyContent.
# Field numbers are the v1beta1 ones plus a trailing `metadata` string.


def gov_module_address() -> str:
    """The sdk-canonical gov module account address:
    bech32(hrp, sha256("gov")[:20]) (authtypes.NewModuleAddress) — the
    `authority` v1 clients put on MsgExecLegacyContent."""
    import hashlib

    from celestia_app_tpu_torch.crypto import bech32
    from celestia_app_tpu_torch.crypto.keys import ACCOUNT_HRP

    return bech32.encode(ACCOUNT_HRP, hashlib.sha256(b"gov").digest()[:20])


@dataclass(frozen=True)
class MsgExecLegacyContent:
    """cosmos.gov.v1.MsgExecLegacyContent {content=1 Any, authority=2}:
    the v1 wrapper carrying a v1beta1 Content inside a v1 proposal.  Not
    a tx msg — only the gov module account may execute it, so it appears
    exclusively inside MsgSubmitProposalV1.messages."""

    content: Any
    authority: str

    TYPE_URL = URL_MSG_GOV_V1_EXEC_LEGACY_CONTENT

    def marshal(self) -> bytes:
        return encode_bytes_field(1, self.content.marshal()) + encode_bytes_field(
            2, self.authority.encode()
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgExecLegacyContent":
        f = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_LEN}
        return cls(Any.unmarshal(f.get(1, b"")), f.get(2, b"").decode())

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())


@dataclass(frozen=True)
class MsgSubmitProposalV1:
    """cosmos.gov.v1.MsgSubmitProposal {messages=1 repeated Any,
    initial_deposit=2 repeated Coin, proposer=3, metadata=4}.

    Deviation (documented): this chain's gov router executes legacy
    Content only, so exactly ONE message is accepted and it must be a
    MsgExecLegacyContent wrapping a supported Content — the same set the
    v1beta1 surface takes.  `metadata` rides the wire but is not
    persisted (tallying never reads it)."""

    messages: tuple[Any, ...]
    initial_deposit: tuple[Coin, ...]
    proposer: str
    metadata: str = ""

    TYPE_URL = URL_MSG_GOV_V1_SUBMIT_PROPOSAL

    def marshal(self) -> bytes:
        out = b""
        for m in self.messages:
            out += encode_bytes_field(1, m.marshal())
        for c in self.initial_deposit:
            out += encode_bytes_field(2, c.marshal())
        out += encode_bytes_field(3, self.proposer.encode())
        if self.metadata:
            out += encode_bytes_field(4, self.metadata.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgSubmitProposalV1":
        msgs: list[Any] = []
        deposit: list[Coin] = []
        proposer, metadata = "", ""
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                msgs.append(Any.unmarshal(val))
            elif num == 2 and wt == WIRE_LEN:
                deposit.append(Coin.unmarshal(val))
            elif num == 3 and wt == WIRE_LEN:
                proposer = val.decode()
            elif num == 4 and wt == WIRE_LEN:
                metadata = val.decode()
        return cls(tuple(msgs), tuple(deposit), proposer, metadata)

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.proposer

    def legacy_content(self) -> MsgExecLegacyContent:
        """The single MsgExecLegacyContent this proposal carries; raises
        on anything else (this chain's gov router executes legacy
        Content only)."""
        if len(self.messages) != 1:
            raise ValueError(
                "gov v1 proposals carry exactly one message on this chain"
            )
        m = self.messages[0]
        if m.type_url != URL_MSG_GOV_V1_EXEC_LEGACY_CONTENT:
            raise ValueError(
                f"proposal message {m.type_url} not supported by the gov "
                "router (only MsgExecLegacyContent)"
            )
        exec_msg = MsgExecLegacyContent.unmarshal(m.value)
        from celestia_app_tpu_torch.modules.gov import GOV_MODULE

        if exec_msg.authority not in (GOV_MODULE, gov_module_address()):
            raise ValueError(
                f"invalid authority {exec_msg.authority!r}: expected the "
                "gov module account"
            )
        return exec_msg

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.proposer)
        for c in self.initial_deposit:
            if c.amount < 0:
                raise ValueError("negative deposit")
        # Statelessly pin the router rule + authority so a bad proposal
        # never escrows a deposit.
        self.legacy_content()


@dataclass(frozen=True)
class MsgVoteV1:
    """cosmos.gov.v1.MsgVote {proposal_id=1, voter=2, option=3,
    metadata=4} — v1beta1 numbering plus metadata."""

    proposal_id: int
    voter: str
    option: int
    metadata: str = ""

    TYPE_URL = URL_MSG_GOV_V1_VOTE

    def marshal(self) -> bytes:
        out = (
            encode_varint_field(1, self.proposal_id)
            + encode_bytes_field(2, self.voter.encode())
            + encode_varint_field(3, self.option)
        )
        if self.metadata:
            out += encode_bytes_field(4, self.metadata.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgVoteV1":
        pid, voter, option, metadata = 0, "", 0, ""
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_VARINT:
                pid = val
            elif num == 2 and wt == WIRE_LEN:
                voter = val.decode()
            elif num == 3 and wt == WIRE_VARINT:
                option = val
            elif num == 4 and wt == WIRE_LEN:
                metadata = val.decode()
        return cls(pid, voter, option, metadata)

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.voter

    def validate_basic(self) -> None:
        if self.proposal_id <= 0:
            raise ValueError("invalid proposal id")
        if self.option not in (1, 2, 3, 4):
            raise ValueError(f"invalid vote option {self.option}")


@dataclass(frozen=True)
class MsgVoteWeightedV1:
    """cosmos.gov.v1.MsgVoteWeighted {proposal_id=1, voter=2, options=3
    repeated WeightedVoteOption, metadata=4}."""

    proposal_id: int
    voter: str
    options: tuple[tuple[int, str], ...]  # (option, Dec-string weight)
    metadata: str = ""

    TYPE_URL = URL_MSG_GOV_V1_VOTE_WEIGHTED

    def marshal(self) -> bytes:
        out = encode_varint_field(1, self.proposal_id)
        out += encode_bytes_field(2, self.voter.encode())
        for opt, weight in self.options:
            out += encode_bytes_field(3, encode_weighted_option(opt, weight))
        if self.metadata:
            out += encode_bytes_field(4, self.metadata.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgVoteWeightedV1":
        pid, voter, metadata = 0, "", ""
        options: list[tuple[int, str]] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_VARINT:
                pid = val
            elif num == 2 and wt == WIRE_LEN:
                voter = val.decode()
            elif num == 3 and wt == WIRE_LEN:
                options.append(decode_weighted_option(val))
            elif num == 4 and wt == WIRE_LEN:
                metadata = val.decode()
        return cls(pid, voter, tuple(options), metadata)

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.voter

    # Same stateless weight rules as the v1beta1 surface (non-empty, each
    # weight in (0, 1], no duplicates, total exactly 1): an invalid
    # weighted vote must die at CheckTx on either url.
    validate_basic = MsgVoteWeighted.validate_basic


@dataclass(frozen=True)
class MsgDepositV1:
    """cosmos.gov.v1.MsgDeposit — same shape as v1beta1 {proposal_id=1,
    depositor=2, amount=3} under the v1 type url."""

    proposal_id: int
    depositor: str
    amount: tuple[Coin, ...]

    TYPE_URL = URL_MSG_GOV_V1_DEPOSIT

    marshal = MsgDeposit.marshal
    to_any = MsgDeposit.to_any
    validate_basic = MsgDeposit.validate_basic

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgDepositV1":
        base = MsgDeposit.unmarshal(raw)
        return cls(base.proposal_id, base.depositor, base.amount)

    @property
    def signer(self) -> str:
        return self.depositor


@dataclass(frozen=True)
class MsgTransfer:
    """ibc.applications.transfer.v1.MsgTransfer {source_port=1,
    source_channel=2, token=3, sender=4, receiver=5, timeout_height=6
    {revision_number=1, revision_height=2}, timeout_timestamp=7, memo=8}."""

    source_port: str
    source_channel: str
    token: Coin
    sender: str
    receiver: str
    timeout_revision_number: int = 0
    timeout_revision_height: int = 0
    timeout_timestamp_ns: int = 0
    memo: str = ""

    TYPE_URL = URL_MSG_TRANSFER

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.source_port.encode())
        out += encode_bytes_field(2, self.source_channel.encode())
        out += encode_bytes_field(3, self.token.marshal())
        out += encode_bytes_field(4, self.sender.encode())
        out += encode_bytes_field(5, self.receiver.encode())
        if self.timeout_revision_number or self.timeout_revision_height:
            out += encode_bytes_field(
                6,
                encode_varint_field(1, self.timeout_revision_number)
                + encode_varint_field(2, self.timeout_revision_height),
            )
        if self.timeout_timestamp_ns:
            out += encode_varint_field(7, self.timeout_timestamp_ns)
        if self.memo:
            out += encode_bytes_field(8, self.memo.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgTransfer":
        strs: dict[int, bytes] = {}
        ints: dict[int, int] = {}
        for num, wt, val in decode_fields(raw):
            if wt == WIRE_LEN:
                strs[num] = val
            elif wt == WIRE_VARINT:
                ints[num] = val
        rev_num = rev_h = 0
        if 6 in strs:
            hf = {n: v for n, wt, v in decode_fields(strs[6]) if wt == WIRE_VARINT}
            rev_num, rev_h = hf.get(1, 0), hf.get(2, 0)
        return cls(
            strs.get(1, b"").decode(), strs.get(2, b"").decode(),
            Coin.unmarshal(strs.get(3, b"")), strs.get(4, b"").decode(),
            strs.get(5, b"").decode(), rev_num, rev_h, ints.get(7, 0),
            strs.get(8, b"").decode(),
        )

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.sender

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.sender)
        if not self.receiver:
            raise ValueError("receiver must not be empty")
        if self.token.amount <= 0:
            raise ValueError("transfer amount must be positive")
        if not self.source_channel:
            raise ValueError("source channel must not be empty")


def _relay_msg(url: str, signer_field: int, proof_field: int,
               height_field: int, ack_field: int | None = None):
    """MsgRecvPacket / MsgAcknowledgement / MsgTimeout share one shape:
    a packet, a state proof + proof height, optional ack bytes, and the
    relayer signer.  Field numbers follow ibc.core.channel.v1
    (MsgRecvPacket proof_commitment=2, proof_height=3, signer=4;
    MsgAcknowledgement acknowledgement=2, proof_acked=3, proof_height=4,
    signer=5; MsgTimeout proof_unreceived=2, proof_height=3, signer=5).
    `proof` carries a marshaled SMT StateProof (state/smt.py) verified
    through the channel's light client when the channel is
    connection-backed; empty for direct-OPEN test channels (IBC-lite
    trusted relay)."""

    @dataclass(frozen=True)
    class RelayMsg:
        packet_bytes: bytes
        signer: str
        acknowledgement: bytes = b""
        proof_height: int = 0
        proof: bytes = b""

        TYPE_URL = url
        _SIGNER_FIELD = signer_field
        _ACK_FIELD = ack_field
        _PROOF_FIELD = proof_field
        _HEIGHT_FIELD = height_field

        def marshal(self) -> bytes:
            out = encode_bytes_field(1, self.packet_bytes)
            if self._ACK_FIELD is not None and self.acknowledgement:
                out += encode_bytes_field(self._ACK_FIELD, self.acknowledgement)
            if self.proof:
                out += encode_bytes_field(self._PROOF_FIELD, self.proof)
            if self.proof_height:
                out += encode_bytes_field(
                    self._HEIGHT_FIELD, encode_varint_field(2, self.proof_height)
                )
            out += encode_bytes_field(self._SIGNER_FIELD, self.signer.encode())
            return out

        @classmethod
        def unmarshal(cls, raw: bytes):
            packet, signer, ack, ph, proof = b"", "", b"", 0, b""
            for num, wt, val in decode_fields(raw):
                if num == 1 and wt == WIRE_LEN:
                    packet = val
                elif num == cls._ACK_FIELD and wt == WIRE_LEN:
                    ack = val
                elif num == cls._PROOF_FIELD and wt == WIRE_LEN:
                    proof = val
                elif num == cls._HEIGHT_FIELD and wt == WIRE_LEN:
                    hf = {n: v for n, wt2, v in decode_fields(val) if wt2 == WIRE_VARINT}
                    ph = hf.get(2, 0)
                elif num == cls._SIGNER_FIELD and wt == WIRE_LEN:
                    signer = val.decode()
            return cls(packet, signer, ack, ph, proof)

        def to_any(self) -> Any:
            return Any(self.TYPE_URL, self.marshal())

        def packet(self):
            from celestia_app_tpu_torch.modules.ibc.core import Packet

            return Packet.unmarshal(self.packet_bytes)

        def state_proof(self):
            from celestia_app_tpu_torch.state import smt

            return smt.proof_unmarshal(self.proof) if self.proof else None

        def validate_basic(self) -> None:
            if not self.packet_bytes:
                raise ValueError("relay msg missing packet")

    RelayMsg.__name__ = RelayMsg.__qualname__ = url.rsplit(".", 1)[-1]
    return RelayMsg


MsgRecvPacket = _relay_msg(
    URL_MSG_RECV_PACKET, signer_field=4, proof_field=2, height_field=3
)
MsgAcknowledgement = _relay_msg(
    URL_MSG_ACKNOWLEDGEMENT, signer_field=5, proof_field=3, height_field=4,
    ack_field=2,
)
MsgTimeout = _relay_msg(
    URL_MSG_TIMEOUT, signer_field=5, proof_field=2, height_field=3
)


def _staking_msg(url: str, has_dst: bool = False):
    """MsgDelegate / MsgUndelegate {delegator_address=1,
    validator_address=2, amount=3}; MsgBeginRedelegate {delegator_address=1,
    validator_src_address=2, validator_dst_address=3, amount=4}
    (cosmos.staking.v1beta1 field numbers)."""

    @dataclass(frozen=True)
    class StakingMsg:
        delegator_address: str
        validator_address: str  # the src validator for redelegations
        amount: Coin
        validator_dst_address: str = ""

        TYPE_URL = url
        _HAS_DST = has_dst

        def marshal(self) -> bytes:
            out = encode_bytes_field(1, self.delegator_address.encode())
            out += encode_bytes_field(2, self.validator_address.encode())
            if self._HAS_DST:
                out += encode_bytes_field(3, self.validator_dst_address.encode())
                out += encode_bytes_field(4, self.amount.marshal())
            else:
                out += encode_bytes_field(3, self.amount.marshal())
            return out

        @classmethod
        def unmarshal(cls, raw: bytes):
            f = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_LEN}
            if cls._HAS_DST:
                return cls(
                    f.get(1, b"").decode(), f.get(2, b"").decode(),
                    Coin.unmarshal(f.get(4, b"")), f.get(3, b"").decode(),
                )
            return cls(
                f.get(1, b"").decode(), f.get(2, b"").decode(),
                Coin.unmarshal(f.get(3, b"")),
            )

        def to_any(self) -> Any:
            return Any(self.TYPE_URL, self.marshal())

        @property
        def signer(self) -> str:
            return self.delegator_address

        def validate_basic(self) -> None:
            from celestia_app_tpu_torch.crypto.keys import validate_address

            validate_address(self.delegator_address)
            if not self.validator_address:
                raise ValueError("validator address must not be empty")
            if self._HAS_DST and not self.validator_dst_address:
                raise ValueError("destination validator must not be empty")
            if self.amount.denom != "utia":
                raise ValueError(
                    f"invalid bond denom {self.amount.denom!r}, expected utia"
                )
            if self.amount.amount <= 0:
                raise ValueError("stake amount must be positive")

    StakingMsg.__name__ = StakingMsg.__qualname__ = url.rsplit(".", 1)[-1]
    return StakingMsg


MsgDelegate = _staking_msg(URL_MSG_DELEGATE)
MsgUndelegate = _staking_msg(URL_MSG_UNDELEGATE)
MsgBeginRedelegate = _staking_msg(URL_MSG_BEGIN_REDELEGATE, has_dst=True)


@dataclass(frozen=True)
class MsgCancelUnbondingDelegation:
    """cosmos.staking.v1beta1.MsgCancelUnbondingDelegation (sdk v0.46)
    {delegator_address=1, validator_address=2, amount=3 Coin,
    creation_height=4 int64}: re-bond tokens from the unbonding entry
    created at `creation_height` back to the same validator."""

    delegator_address: str
    validator_address: str
    amount: Coin
    creation_height: int

    TYPE_URL = URL_MSG_CANCEL_UNBONDING

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.delegator_address.encode())
        out += encode_bytes_field(2, self.validator_address.encode())
        out += encode_bytes_field(3, self.amount.marshal())
        if self.creation_height:
            # int64: negatives ride as 10-byte two's-complement varints.
            out += encode_varint_field(4, self.creation_height & ((1 << 64) - 1))
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgCancelUnbondingDelegation":
        from celestia_app_tpu_torch.encoding.proto import int64_from_uvarint

        f = {(num, wt): val for num, wt, val in decode_fields(raw)}
        return cls(
            f.get((1, WIRE_LEN), b"").decode(),
            f.get((2, WIRE_LEN), b"").decode(),
            Coin.unmarshal(f.get((3, WIRE_LEN), b"")),
            int64_from_uvarint(f.get((4, WIRE_VARINT), 0)),
        )

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.delegator_address

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.delegator_address)
        if not self.validator_address:
            raise ValueError("validator address must not be empty")
        if self.amount.denom != "utia":
            raise ValueError(
                f"invalid bond denom {self.amount.denom!r}, expected utia"
            )
        if self.amount.amount <= 0:
            raise ValueError("cancel amount must be positive")
        if self.creation_height < 0:
            raise ValueError("creation height must be non-negative")


@dataclass(frozen=True)
class MsgCreateValidator:
    """cosmos.staking.v1beta1.MsgCreateValidator {description=1
    {moniker=1}, commission=2 {rate=1, max_rate=2, max_change_rate=3 —
    Dec strings}, min_self_delegation=3 (string), delegator_address=4,
    validator_address=5, pubkey=6 (Any), value=7 (Coin)}."""

    moniker: str
    commission_rate: str  # Dec string, e.g. "0.100000000000000000"
    delegator_address: str
    validator_address: str
    pubkey: bytes  # consensus pubkey bytes (secp256k1 compressed here)
    value: Coin
    min_self_delegation: int = 1
    commission_max_rate: str = "1.000000000000000000"
    commission_max_change_rate: str = "0.010000000000000000"

    TYPE_URL = URL_MSG_CREATE_VALIDATOR

    def marshal(self) -> bytes:
        # proto3 canonical form: an empty Description submessage still
        # appears (field presence), but its empty moniker string does not.
        out = encode_bytes_field(
            1,
            encode_bytes_field(1, self.moniker.encode()) if self.moniker else b"",
        )
        out += encode_bytes_field(
            2,
            encode_bytes_field(1, self.commission_rate.encode())
            + encode_bytes_field(2, self.commission_max_rate.encode())
            + encode_bytes_field(3, self.commission_max_change_rate.encode()),
        )
        out += encode_bytes_field(3, str(self.min_self_delegation).encode())
        out += encode_bytes_field(4, self.delegator_address.encode())
        out += encode_bytes_field(5, self.validator_address.encode())
        out += encode_bytes_field(
            6,
            Any(
                URL_SECP256K1_PUBKEY_STR, encode_bytes_field(1, self.pubkey)
            ).marshal(),
        )
        out += encode_bytes_field(7, self.value.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgCreateValidator":
        f = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_LEN}
        moniker = ""
        for n, wt, v in decode_fields(f.get(1, b"")):
            if n == 1 and wt == WIRE_LEN:
                moniker = v.decode()
        rates = {}
        for n, wt, v in decode_fields(f.get(2, b"")):
            if wt == WIRE_LEN:
                rates[n] = v.decode()
        pk = b""
        if 6 in f:
            a = Any.unmarshal(f[6])
            if a.type_url != URL_SECP256K1_PUBKEY_STR:
                raise ValueError(
                    f"unsupported consensus pubkey type {a.type_url}"
                )
            for n, wt, v in decode_fields(a.value):
                if n == 1 and wt == WIRE_LEN:
                    pk = v
        return cls(
            moniker, rates.get(1, ""), f.get(4, b"").decode(),
            f.get(5, b"").decode(), pk, Coin.unmarshal(f.get(7, b"")),
            int(f.get(3, b"1").decode() or "1"),
            rates.get(2, "1.000000000000000000"),
            rates.get(3, "0.010000000000000000"),
        )

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.delegator_address

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address
        from celestia_app_tpu_torch.state.dec import Dec

        validate_address(self.delegator_address)
        validate_address(self.validator_address)
        if self.validator_address != self.delegator_address:
            # The sdk derives the operator address from the signer's key;
            # in this framework's single-address model that means they are
            # literally equal — otherwise anyone could squat a validator
            # record under an address they don't control.
            raise ValueError(
                "validator address must be the signer (operator = delegator)"
            )
        if not self.pubkey:
            raise ValueError("validator needs a consensus pubkey")
        if self.value.denom != "utia" or self.value.amount <= 0:
            raise ValueError("self delegation must be positive utia")
        if self.value.amount < self.min_self_delegation:
            raise ValueError("self delegation below min_self_delegation")
        rate = Dec.from_str(self.commission_rate or "0")
        max_rate = Dec.from_str(self.commission_max_rate or "1")
        if rate < Dec(0) or Dec.from_int(1) < rate:
            raise ValueError("commission rate outside [0, 1]")
        if max_rate < rate:
            raise ValueError("commission rate exceeds its own max_rate")


@dataclass(frozen=True)
class MsgEditValidator:
    """cosmos.staking.v1beta1.MsgEditValidator {description=1 {moniker=1},
    validator_address=2, commission_rate=3 (Dec string, empty = keep)}."""

    moniker: str
    validator_address: str
    commission_rate: str = ""

    TYPE_URL = URL_MSG_EDIT_VALIDATOR

    def marshal(self) -> bytes:
        out = encode_bytes_field(
            1,
            encode_bytes_field(1, self.moniker.encode()) if self.moniker else b"",
        )
        out += encode_bytes_field(2, self.validator_address.encode())
        if self.commission_rate:
            out += encode_bytes_field(3, self.commission_rate.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgEditValidator":
        f = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_LEN}
        moniker = ""
        for n, wt, v in decode_fields(f.get(1, b"")):
            if n == 1 and wt == WIRE_LEN:
                moniker = v.decode()
        return cls(moniker, f.get(2, b"").decode(), f.get(3, b"").decode())

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.validator_address

    def validate_basic(self) -> None:
        if not self.validator_address:
            raise ValueError("validator address must not be empty")
        if self.commission_rate:
            from celestia_app_tpu_torch.state.dec import Dec

            rate = Dec.from_str(self.commission_rate)
            if rate < Dec(0) or Dec.from_int(1) < rate:
                raise ValueError("commission rate outside [0, 1]")


def _two_addr_msg(url: str, name1: str, name2: str | None):
    """Two-string-field distribution messages (cosmos.distribution.v1beta1):
    MsgWithdrawDelegatorReward {delegator_address=1, validator_address=2},
    MsgSetWithdrawAddress {delegator_address=1, withdraw_address=2},
    MsgWithdrawValidatorCommission {validator_address=1}."""

    @dataclass(frozen=True)
    class TwoAddrMsg:
        addr1: str
        addr2: str = ""

        TYPE_URL = url
        _HAS_SECOND = name2 is not None

        def marshal(self) -> bytes:
            out = encode_bytes_field(1, self.addr1.encode())
            if self._HAS_SECOND:
                out += encode_bytes_field(2, self.addr2.encode())
            return out

        @classmethod
        def unmarshal(cls, raw: bytes):
            f = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_LEN}
            return cls(f.get(1, b"").decode(), f.get(2, b"").decode())

        def to_any(self) -> Any:
            return Any(self.TYPE_URL, self.marshal())

        @property
        def signer(self) -> str:
            return self.addr1

        def validate_basic(self) -> None:
            if not self.addr1:
                raise ValueError(f"{name1} must not be empty")
            if self._HAS_SECOND and not self.addr2:
                raise ValueError(f"{name2} must not be empty")

    TwoAddrMsg.__name__ = TwoAddrMsg.__qualname__ = url.rsplit(".", 1)[-1]
    setattr(TwoAddrMsg, name1.replace(" ", "_"), property(lambda self: self.addr1))
    if name2 is not None:
        setattr(TwoAddrMsg, name2.replace(" ", "_"), property(lambda self: self.addr2))
    return TwoAddrMsg


MsgWithdrawDelegatorReward = _two_addr_msg(
    URL_MSG_WITHDRAW_DELEGATOR_REWARD, "delegator address", "validator address"
)
MsgSetWithdrawAddress = _two_addr_msg(
    URL_MSG_SET_WITHDRAW_ADDRESS, "delegator address", "withdraw address"
)
MsgWithdrawValidatorCommission = _two_addr_msg(
    URL_MSG_WITHDRAW_VALIDATOR_COMMISSION, "validator address", None
)
# cosmos.slashing.v1beta1.MsgUnjail {validator_addr=1} — same one-string
# shape as a commission withdrawal, different URL and field name.
MsgUnjail = _two_addr_msg(URL_MSG_UNJAIL, "validator address", None)


@dataclass(frozen=True)
class MsgFundCommunityPool:
    """cosmos.distribution.v1beta1.MsgFundCommunityPool
    {amount=1 (repeated Coin), depositor=2}."""

    amount: tuple[Coin, ...]
    depositor: str

    TYPE_URL = URL_MSG_FUND_COMMUNITY_POOL

    def marshal(self) -> bytes:
        out = b""
        for c in self.amount:
            out += encode_bytes_field(1, c.marshal())
        out += encode_bytes_field(2, self.depositor.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgFundCommunityPool":
        coins: list[Coin] = []
        depositor = ""
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                coins.append(Coin.unmarshal(val))
            elif num == 2 and wt == WIRE_LEN:
                depositor = val.decode()
        return cls(tuple(coins), depositor)

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.depositor

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.depositor)
        if not self.amount or any(c.amount <= 0 for c in self.amount):
            raise ValueError("community pool deposit must be positive")


@dataclass(frozen=True)
class MsgGrantAllowance:
    """cosmos.feegrant.v1beta1.MsgGrantAllowance {granter=1, grantee=2,
    allowance=3 (Any)}.  Wire allowances: BasicAllowance {spend_limit=1
    repeated Coin, expiration=2 Timestamp} optionally wrapped in
    AllowedMsgAllowance {allowance=1 Any, allowed_messages=2}."""

    granter: str
    grantee: str
    spend_limit: int = 0  # 0 = unlimited
    expiration_ns: int = 0  # 0 = never
    allowed_msgs: tuple[str, ...] = ()

    TYPE_URL = URL_MSG_GRANT_ALLOWANCE

    def _allowance(self) -> Any:
        basic = b""
        if self.spend_limit:
            basic += encode_bytes_field(1, Coin("utia", self.spend_limit).marshal())
        if self.expiration_ns:
            basic += encode_bytes_field(2, _encode_timestamp(self.expiration_ns))
        inner = Any(URL_BASIC_ALLOWANCE, basic)
        if not self.allowed_msgs:
            return inner
        body = encode_bytes_field(1, inner.marshal())
        for url in self.allowed_msgs:
            body += encode_bytes_field(2, url.encode())
        return Any(URL_ALLOWED_MSG_ALLOWANCE, body)

    def marshal(self) -> bytes:
        return (
            encode_bytes_field(1, self.granter.encode())
            + encode_bytes_field(2, self.grantee.encode())
            + encode_bytes_field(3, self._allowance().marshal())
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgGrantAllowance":
        f = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_LEN}
        granter = f.get(1, b"").decode()
        grantee = f.get(2, b"").decode()
        spend, exp = 0, 0
        allowed: list[str] = []
        a = Any.unmarshal(f.get(3, b""))
        if a.type_url == URL_ALLOWED_MSG_ALLOWANCE:
            inner_raw = b""
            for n, wt, v in decode_fields(a.value):
                if n == 1 and wt == WIRE_LEN:
                    inner_raw = v
                elif n == 2 and wt == WIRE_LEN:
                    allowed.append(v.decode())
            a = Any.unmarshal(inner_raw)
        if a.type_url != URL_BASIC_ALLOWANCE:
            raise ValueError(f"unsupported allowance {a.type_url}")
        for n, wt, v in decode_fields(a.value):
            if n == 1 and wt == WIRE_LEN:
                c = Coin.unmarshal(v)
                if c.denom != "utia":
                    # Dropping a foreign-denom limit would decode a capped
                    # allowance as UNLIMITED (0) — reject instead.
                    raise ValueError(
                        f"unsupported fee allowance denom {c.denom!r}"
                    )
                spend += c.amount
            elif n == 2 and wt == WIRE_LEN:
                exp = _decode_timestamp(v)
        return cls(granter, grantee, spend, exp, tuple(allowed))

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.granter

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.granter)
        validate_address(self.grantee)
        if self.granter == self.grantee:
            raise ValueError("cannot self-grant a fee allowance")


@dataclass(frozen=True)
class MsgRevokeAllowance:
    """cosmos.feegrant.v1beta1.MsgRevokeAllowance {granter=1, grantee=2}."""

    granter: str
    grantee: str

    TYPE_URL = URL_MSG_REVOKE_ALLOWANCE

    def marshal(self) -> bytes:
        return encode_bytes_field(1, self.granter.encode()) + encode_bytes_field(
            2, self.grantee.encode()
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgRevokeAllowance":
        f = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_LEN}
        return cls(f.get(1, b"").decode(), f.get(2, b"").decode())

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.granter

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.granter)
        validate_address(self.grantee)


@dataclass(frozen=True)
class MsgAuthzGrant:
    """cosmos.authz.v1beta1.MsgGrant {granter=1, grantee=2, grant=3
    {authorization=1 (Any), expiration=2 Timestamp}}.  Authorizations:
    GenericAuthorization {msg=1} or SendAuthorization {spend_limit=1}."""

    granter: str
    grantee: str
    msg_type_url: str
    spend_limit: int = 0  # >0 encodes a SendAuthorization
    expiration_ns: int = 0

    TYPE_URL = URL_MSG_AUTHZ_GRANT

    def _authorization(self) -> Any:
        if self.spend_limit:
            return Any(
                URL_SEND_AUTHORIZATION,
                encode_bytes_field(1, Coin("utia", self.spend_limit).marshal()),
            )
        return Any(
            URL_GENERIC_AUTHORIZATION,
            encode_bytes_field(1, self.msg_type_url.encode()),
        )

    def marshal(self) -> bytes:
        grant = encode_bytes_field(1, self._authorization().marshal())
        if self.expiration_ns:
            grant += encode_bytes_field(2, _encode_timestamp(self.expiration_ns))
        return (
            encode_bytes_field(1, self.granter.encode())
            + encode_bytes_field(2, self.grantee.encode())
            + encode_bytes_field(3, grant)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgAuthzGrant":
        f = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_LEN}
        granter = f.get(1, b"").decode()
        grantee = f.get(2, b"").decode()
        url, spend, exp = "", 0, 0
        for n, wt, v in decode_fields(f.get(3, b"")):
            if n == 1 and wt == WIRE_LEN:
                auth = Any.unmarshal(v)
                if auth.type_url == URL_GENERIC_AUTHORIZATION:
                    for an, awt, av in decode_fields(auth.value):
                        if an == 1 and awt == WIRE_LEN:
                            url = av.decode()
                elif auth.type_url == URL_SEND_AUTHORIZATION:
                    url = URL_MSG_SEND
                    for an, awt, av in decode_fields(auth.value):
                        if an == 1 and awt == WIRE_LEN:
                            c = Coin.unmarshal(av)
                            if c.denom != "utia":
                                # A foreign-denom limit must not decode to
                                # spend_limit=0 (= unbounded).
                                raise ValueError(
                                    f"unsupported authorization denom {c.denom!r}"
                                )
                            spend += c.amount
                else:
                    raise ValueError(f"unsupported authorization {auth.type_url}")
            elif n == 2 and wt == WIRE_LEN:
                exp = _decode_timestamp(v)
        return cls(granter, grantee, url, spend, exp)

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.granter

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.granter)
        validate_address(self.grantee)
        if self.granter == self.grantee:
            raise ValueError("cannot self-grant")
        if not self.msg_type_url:
            raise ValueError("authorization needs a msg type url")
        if self.spend_limit and self.msg_type_url != URL_MSG_SEND:
            # spend_limit>0 encodes a SendAuthorization, whose wire shape
            # carries no msg-type field and whose sdk Accept() covers
            # MsgSend ONLY — combining it with another msg type (incl.
            # MsgMultiSend) would sign a different authority than this
            # object declares and be wire-lossy.  MultiSend under authz
            # is a GenericAuthorization (unlimited), as in the sdk.
            raise ValueError(
                "spend_limit applies only to a MsgSend authorization"
            )


@dataclass(frozen=True)
class MsgAuthzExec:
    """cosmos.authz.v1beta1.MsgExec {grantee=1, msgs=2 (repeated Any)}."""

    grantee: str
    msgs: tuple[Any, ...]

    TYPE_URL = URL_MSG_AUTHZ_EXEC

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.grantee.encode())
        for m in self.msgs:
            out += encode_bytes_field(2, m.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgAuthzExec":
        grantee = ""
        msgs: list[Any] = []
        for n, wt, v in decode_fields(raw):
            if n == 1 and wt == WIRE_LEN:
                grantee = v.decode()
            elif n == 2 and wt == WIRE_LEN:
                msgs.append(Any.unmarshal(v))
        return cls(grantee, tuple(msgs))

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    def inner_msgs(self) -> list:
        return [decode_msg(m) for m in self.msgs]

    @property
    def signer(self) -> str:
        return self.grantee

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.grantee)
        if not self.msgs:
            raise ValueError("MsgExec needs at least one message")
        for m in self.inner_msgs():
            m.validate_basic()


@dataclass(frozen=True)
class MsgAuthzRevoke:
    """cosmos.authz.v1beta1.MsgRevoke {granter=1, grantee=2, msg_type_url=3}."""

    granter: str
    grantee: str
    msg_type_url: str

    TYPE_URL = URL_MSG_AUTHZ_REVOKE

    def marshal(self) -> bytes:
        return (
            encode_bytes_field(1, self.granter.encode())
            + encode_bytes_field(2, self.grantee.encode())
            + encode_bytes_field(3, self.msg_type_url.encode())
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgAuthzRevoke":
        f = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_LEN}
        return cls(
            f.get(1, b"").decode(), f.get(2, b"").decode(), f.get(3, b"").decode()
        )

    def to_any(self) -> Any:
        return Any(self.TYPE_URL, self.marshal())

    @property
    def signer(self) -> str:
        return self.granter

    def validate_basic(self) -> None:
        from celestia_app_tpu_torch.crypto.keys import validate_address

        validate_address(self.granter)
        if not self.msg_type_url:
            raise ValueError("revoke needs a msg type url")


MSG_DECODERS = {
    URL_MSG_CREATE_VALIDATOR: MsgCreateValidator.unmarshal,
    URL_MSG_EDIT_VALIDATOR: MsgEditValidator.unmarshal,
    URL_MSG_GRANT_ALLOWANCE: MsgGrantAllowance.unmarshal,
    URL_MSG_REVOKE_ALLOWANCE: MsgRevokeAllowance.unmarshal,
    URL_MSG_AUTHZ_GRANT: MsgAuthzGrant.unmarshal,
    URL_MSG_AUTHZ_EXEC: MsgAuthzExec.unmarshal,
    URL_MSG_AUTHZ_REVOKE: MsgAuthzRevoke.unmarshal,
    URL_MSG_UNJAIL: MsgUnjail.unmarshal,
    URL_MSG_WITHDRAW_DELEGATOR_REWARD: MsgWithdrawDelegatorReward.unmarshal,
    URL_MSG_WITHDRAW_VALIDATOR_COMMISSION: MsgWithdrawValidatorCommission.unmarshal,
    URL_MSG_SET_WITHDRAW_ADDRESS: MsgSetWithdrawAddress.unmarshal,
    URL_MSG_FUND_COMMUNITY_POOL: MsgFundCommunityPool.unmarshal,
    URL_MSG_DELEGATE: MsgDelegate.unmarshal,
    URL_MSG_UNDELEGATE: MsgUndelegate.unmarshal,
    URL_MSG_BEGIN_REDELEGATE: MsgBeginRedelegate.unmarshal,
    URL_MSG_CANCEL_UNBONDING: MsgCancelUnbondingDelegation.unmarshal,
    URL_MSG_PAY_FOR_BLOBS: MsgPayForBlobs.unmarshal,
    URL_MSG_SEND: MsgSend.unmarshal,
    URL_MSG_MULTI_SEND: MsgMultiSend.unmarshal,
    URL_MSG_CREATE_VESTING_ACCOUNT: MsgCreateVestingAccount.unmarshal,
    URL_MSG_CREATE_PERIODIC_VESTING_ACCOUNT: (
        MsgCreatePeriodicVestingAccount.unmarshal
    ),
    URL_MSG_CREATE_PERMANENT_LOCKED_ACCOUNT: (
        MsgCreatePermanentLockedAccount.unmarshal
    ),
    URL_MSG_VERIFY_INVARIANT: MsgVerifyInvariant.unmarshal,
    URL_MSG_SUBMIT_EVIDENCE: MsgSubmitEvidence.unmarshal,
    URL_MSG_SIGNAL_VERSION: MsgSignalVersion.unmarshal,
    URL_MSG_TRY_UPGRADE: MsgTryUpgrade.unmarshal,
    URL_MSG_SUBMIT_PROPOSAL: MsgSubmitProposal.unmarshal,
    URL_MSG_VOTE: MsgVote.unmarshal,
    URL_MSG_VOTE_WEIGHTED: MsgVoteWeighted.unmarshal,
    URL_MSG_DEPOSIT: MsgDeposit.unmarshal,
    URL_MSG_GOV_V1_SUBMIT_PROPOSAL: MsgSubmitProposalV1.unmarshal,
    URL_MSG_GOV_V1_VOTE: MsgVoteV1.unmarshal,
    URL_MSG_GOV_V1_VOTE_WEIGHTED: MsgVoteWeightedV1.unmarshal,
    URL_MSG_GOV_V1_DEPOSIT: MsgDepositV1.unmarshal,
    URL_MSG_TRANSFER: MsgTransfer.unmarshal,
    URL_MSG_RECV_PACKET: MsgRecvPacket.unmarshal,
    URL_MSG_ACKNOWLEDGEMENT: MsgAcknowledgement.unmarshal,
    URL_MSG_TIMEOUT: MsgTimeout.unmarshal,
}


def decode_msg(any_msg: Any):
    dec = MSG_DECODERS.get(any_msg.type_url)
    if dec is None:
        raise ValueError(f"unknown message type {any_msg.type_url}")
    return dec(any_msg.value)
