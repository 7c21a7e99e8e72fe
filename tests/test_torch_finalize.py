"""Block execution of the port's App (`App(device="cpu")`) against the JAX
App, byte for byte: the same genesis, the same raw txs (signed by the port,
whose bytes are the JAX package's, tests/test_torch_crypto.py) and the same
block times, last-commit signers and evidence go through `finalize_block` +
`commit` of both, and every block's TxResults (code, log, gas_wanted,
gas_used, events) and app hash must be equal.  No proposal is made, so no
JAX program compiles.

The chains: sends, PFBs and MsgMultiSend; vesting accounts and spends into
the lock; staking from create-validator to the end blocker's unbonding
maturity; distribution; gov v1beta1 and v1 with a param change that passes
the tally, one the paramfilter refuses and a community-pool spend; authz;
feegrant; crisis and a tx-submitted evidence (no handler);
liveness downtime -> jail -> MsgUnjail; equivocation evidence, valid and
invalid; MsgSignalVersion + MsgTryUpgrade; a v1 chain through the
blobstream end blocker and across `v2_upgrade_height`; out of gas (code 11)
and a failing message (code 2) with the ante effects kept.  Then
simulate_tx, commit's reset of the check state, the block metrics,
InvariantBroken propagating out of finalize_block, a JAX chain
carried across by `convert.app_from_export` (store, minter and options),
and the golden chain's app hash that chip_smoke.py's phase_chain holds the
card to.
"""

from __future__ import annotations

import gc

import jax
import pytest

import chip_smoke
from celestia_app_tpu.app import App as JaxApp
from celestia_app_tpu.consensus.votes import Equivocation as JaxEquivocation
from celestia_app_tpu.consensus.votes import Vote as JaxVote
from celestia_app_tpu.crypto.keys import PrivateKey as JaxPrivateKey
from celestia_app_tpu.modules.crisis import InvariantBroken as JaxInvariantBroken
from celestia_app_tpu.modules.signal import keeper as jax_signal
from celestia_app_tpu.modules.slashing import Params as JaxSlashingParams
from celestia_app_tpu.modules.slashing import SlashingKeeper as JaxSlashingKeeper
from celestia_app_tpu.state.dec import Dec as JaxDec
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu_torch.app import App
from celestia_app_tpu_torch.consensus import PRECOMMIT, Vote
from celestia_app_tpu_torch.consensus.votes import Equivocation
from celestia_app_tpu_torch.convert import app_from_export
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.modules.blob.types import estimate_gas, new_msg_pay_for_blobs
from celestia_app_tpu_torch.modules.crisis import InvariantBroken
from celestia_app_tpu_torch.modules.gov import VoteOption
from celestia_app_tpu_torch.modules.signal import keeper as port_signal
from celestia_app_tpu_torch.modules.slashing import Params, SlashingKeeper
from celestia_app_tpu_torch.shares import Blob, Namespace
from celestia_app_tpu_torch.state.accounts import AuthKeeper, BankKeeper
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.state.staking import POWER_REDUCTION, StakingKeeper
from celestia_app_tpu_torch.testutil import (
    BLOCK_INTERVAL_NS,
    GENESIS_TIME_NS,
    deterministic_genesis,
    funded_keys,
)
from celestia_app_tpu_torch.testutil.blocks import block_txs, next_sequences
from celestia_app_tpu_torch.tx.envelopes import BlobTx
from celestia_app_tpu_torch.tx.messages import (
    Any,
    BankIO,
    Coin,
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
    MsgExecLegacyContent,
    MsgFundCommunityPool,
    MsgGrantAllowance,
    MsgMultiSend,
    MsgRevokeAllowance,
    MsgSend,
    MsgSetWithdrawAddress,
    MsgSignalVersion,
    MsgSubmitEvidence,
    MsgSubmitProposal,
    MsgSubmitProposalV1,
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
    ProposalParamChange,
    VestingPeriod,
    gov_module_address,
)
from celestia_app_tpu_torch.tx.sign import Fee, build_and_sign

# The golden chain of chip_smoke.phase_chain: APP_GOLDEN's genesis and
# txs, finalized at GENESIS_TIME_NS + BLOCK_INTERVAL_NS with every genesis
# validator in the last commit; this is the JAX App's app hash after it.
GOLDEN_APP_HASH = "cd64aec07f3f4f72bc51d3677d4a95f45494792d9c76e6ce690bd9e04f98092d"

N_USERS = 3
WEEK_NS = 7 * 24 * 3600 * 10**9
SEND_PATH = "/cosmos.bank.v1beta1.MsgSend"


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends:
    each loaded XLA:CPU executable holds hundreds to thousands of memory
    mappings, and a test worker that keeps every module's programs can
    reach the kernel's per-process map limit, where the next compile
    aborts."""
    yield
    jax.clear_caches()
    gc.collect()


def validator_keys(n: int = 3) -> list[PrivateKey]:
    """The operators behind deterministic_genesis's validators."""
    return [PrivateKey.from_seed(f"validator-{i}".encode()) for i in range(n)]


# The seeds of funded_keys(N_USERS) + validator_keys(), for the JAX keys.
SEEDS = [f"account-{i}".encode() for i in range(N_USERS)] + [
    f"validator-{i}".encode() for i in range(3)]


def address(key) -> str:
    return key.public_key().address()


def result(r) -> tuple:
    return r.code, r.log, r.gas_wanted, r.gas_used, r.events


class Chain:
    """A port App and a JAX App from one genesis, driven block by block:
    `block` finalizes the same txs on both, commits, and asserts that the
    TxResults and app hashes are equal.  The genesis funds N_USERS users and
    the validator operators (so that operators can sign)."""

    def __init__(self, app_version: int = 2, app_kw: dict | None = None, **genesis_kw):
        self.users = funded_keys(N_USERS)
        self.validators = validator_keys()
        self.keys = self.users + self.validators
        self.port = App(device="cpu", **(app_kw or {}))
        self.ref = JaxApp(**(app_kw or {}))
        self.port.init_chain(deterministic_genesis(self.keys, app_version=app_version,
                                                   **genesis_kw))
        self.ref.init_chain(jax_genesis([JaxPrivateKey.from_seed(s) for s in SEEDS],
                                        app_version=app_version, **genesis_kw))
        assert self.port.cms.last_app_hash == self.ref.cms.last_app_hash
        self.signers = {address(k) for k in self.validators}
        self.pending: dict[str, int] = {}

    @property
    def chain_id(self) -> str:
        return self.port.chain_id

    def tx(self, key, *msgs, gas: int = 400_000, fee: int | None = None,
           granter: str = "") -> bytes:
        """`msgs` signed by `key` at its next sequence (counting the txs
        signed for the block being built)."""
        addr = address(key)
        acc = AuthKeeper(self.port.cms.working).get_account(addr)
        seq = self.pending.get(addr, acc.sequence)
        self.pending[addr] = seq + 1
        fee_amount = gas // 5 if fee is None else fee
        return build_and_sign(list(msgs), key, self.chain_id, acc.account_number, seq,
                              Fee((Coin("utia", fee_amount),), gas, granter=granter))

    def block(self, txs: list[bytes], *, dt: int = BLOCK_INTERVAL_NS, signers=None,
              evidence: tuple[tuple, tuple] = ((), ())) -> list:
        """Finalize + commit `txs` on both Apps, `dt` after the last block;
        `evidence` is (port records, JAX records).  Returns the port's
        results."""
        self.pending.clear()
        time_ns = self.port.last_block_time_ns + dt
        got = self.port.finalize_block(time_ns, list(txs), last_commit_signers=signers,
                                       evidence=evidence[0])
        want = self.ref.finalize_block(time_ns, list(txs), last_commit_signers=signers,
                                       evidence=evidence[1])
        assert [result(r) for r in got] == [result(r) for r in want]
        assert self.port.commit() == self.ref.commit()
        assert self.port.app_version == self.ref.app_version
        assert self.port.height == self.ref.height
        return got

    def both(self, fn) -> None:
        """Apply the same out-of-band write to both Apps' working stores."""
        fn(self.port.cms.working, "port")
        fn(self.ref.cms.working, "jax")

    def balance(self, addr: str) -> int:
        return BankKeeper(self.port.cms.working).balance(addr)


def codes(results) -> list[int]:
    return [r.code for r in results]


def event(results, suffix: str):
    return next(e for r in results for e in r.events if e[0].endswith(suffix))


# --- the chains ---------------------------------------------------------------

def chain_sends_pfbs_multisend(chain: Chain) -> None:
    txs = block_txs(chain.users, chain.chain_id, seed=3, sends=4, pfbs=4, blob_shares=(1, 6))
    assert codes(chain.block(txs)) == [0] * 8
    a, b, c = (address(k) for k in chain.users)
    fresh = address(PrivateKey.from_seed(b"multisend-recipient"))
    multi = MsgMultiSend((BankIO(a, (Coin("utia", 600),)),),
                         (BankIO(b, (Coin("utia", 100),)), BankIO(c, (Coin("utia", 200),)),
                          BankIO(fresh, (Coin("utia", 300),))))
    assert codes(chain.block([chain.tx(chain.users[0], multi)])) == [0]
    assert chain.balance(fresh) == 300
    more = block_txs(chain.users, chain.chain_id, seed=4, sends=3, pfbs=3, blob_shares=(2, 4),
                     sequences=next_sequences(chain.port, chain.users))
    assert codes(chain.block(more)) == [0] * 6


def chain_vesting(chain: Chain) -> None:
    u0 = chain.users[0]
    cont, delayed, periodic, locked = (PrivateKey.from_seed(f"vest-{n}".encode())
                                       for n in ("cont", "delayed", "periodic", "locked"))
    t = chain.port.last_block_time_ns // 10**9
    amount = (Coin("utia", 10_000_000),)
    res = chain.block([
        chain.tx(u0, MsgCreateVestingAccount(address(u0), address(cont), amount, t + 3600)),
        chain.tx(u0, MsgCreateVestingAccount(address(u0), address(delayed), amount, t + 3600,
                                             delayed=True)),
        chain.tx(u0, MsgCreatePeriodicVestingAccount(
            address(u0), address(periodic), t,
            (VestingPeriod(60, (Coin("utia", 1_000_000),)),
             VestingPeriod(600, (Coin("utia", 9_000_000),))))),
        chain.tx(u0, MsgCreatePermanentLockedAccount(address(u0), address(locked), amount)),
        # The target of a vesting message must be new.
        chain.tx(u0, MsgCreatePermanentLockedAccount(address(u0), address(cont), amount)),
    ])
    assert codes(res) == [0, 0, 0, 0, 2]
    # Liquid funds for the fees, then spends into and beside the lock.
    chain.block([chain.tx(u0, MsgSend(address(u0), address(k), (Coin("utia", 200_000),)))
                 for k in (cont, delayed, periodic, locked)])
    sink = address(chain.users[1])
    res = chain.block([
        chain.tx(locked, MsgSend(address(locked), sink, (Coin("utia", 1_000_000),))),
        chain.tx(delayed, MsgSend(address(delayed), sink, (Coin("utia", 50_000),))),
        chain.tx(cont, MsgFundCommunityPool((Coin("utia", 5_000_000),), address(cont))),
        chain.tx(periodic, MsgSend(address(periodic), sink, (Coin("utia", 1_100_000),)),
                 gas=200_000),
    ], dt=120 * 10**9)
    assert codes(res) == [2, 0, 2, 0]
    assert "10000000utia still vesting" in res[0].log and "still vesting" in res[2].log
    # Delegating locked tokens is allowed (vesting delegation tracking).
    val = address(chain.validators[0])
    res = chain.block([chain.tx(locked, MsgDelegate(address(locked), val,
                                                    Coin("utia", 5_000_000)))])
    assert codes(res) == [0]


def chain_staking(chain: Chain) -> None:
    u0, u1, u2 = chain.users
    v0, v1 = (address(k) for k in chain.validators[:2])
    operator = address(u2)
    consensus = PrivateKey.from_seed(b"new-validator-consensus").public_key().bytes
    res = chain.block([
        chain.tx(u2, MsgCreateValidator("newval", "0.05", operator, operator, consensus,
                                        Coin("utia", 50 * POWER_REDUCTION),
                                        commission_max_rate="0.2",
                                        commission_max_change_rate="0.01")),
        chain.tx(u0, MsgDelegate(address(u0), v0, Coin("utia", 20 * POWER_REDUCTION))),
        chain.tx(u1, MsgDelegate(address(u1), v1, Coin("utia", 10 * POWER_REDUCTION))),
        chain.tx(u1, MsgDelegate(address(u1), v1, Coin("ufake", 10))),  # refused by the ante
    ])
    assert codes(res) == [0, 0, 0, 1]
    assert StakingKeeper(chain.port.cms.working).has_validator(operator)
    res = chain.block([
        chain.tx(u2, MsgEditValidator("newval", operator, "0.06")),
        chain.tx(u2, MsgEditValidator("newval", operator, "0.15")),  # above the change rate
        chain.tx(u0, MsgUndelegate(address(u0), v0, Coin("utia", 5 * POWER_REDUCTION))),
        chain.tx(u0, MsgBeginRedelegate(address(u0), v0, Coin("utia", 3 * POWER_REDUCTION),
                                        validator_dst_address=operator)),
        chain.tx(u1, MsgUndelegate(address(u1), v1, Coin("utia", 4 * POWER_REDUCTION))),
    ])
    assert codes(res) == [0, 2, 0, 0, 0]
    undelegated_at = chain.port.height
    res = chain.block([
        chain.tx(u1, MsgCancelUnbondingDelegation(address(u1), v1,
                                                  Coin("utia", 1 * POWER_REDUCTION),
                                                  undelegated_at)),
        chain.tx(u1, MsgCancelUnbondingDelegation(address(u1), v1,
                                                  Coin("utia", 1 * POWER_REDUCTION),
                                                  undelegated_at + 7)),
        # The operator undelegates its self-bond below min_self_delegation.
        chain.tx(u2, MsgUndelegate(operator, operator, Coin("utia", 50 * POWER_REDUCTION))),
    ])
    assert codes(res) == [0, 2, 0]
    before = chain.balance(address(u0))
    # Three weeks later the end blocker matures every unbonding.
    chain.block([], dt=21 * 24 * 3600 * 10**9 + 1)
    assert chain.balance(address(u0)) == before + 5 * POWER_REDUCTION


def chain_distribution(chain: Chain) -> None:
    u0, u1, u2 = chain.users
    val = chain.validators[0]
    operator = address(u2)
    consensus = PrivateKey.from_seed(b"distribution-consensus").public_key().bytes
    chain.block([
        chain.tx(u0, MsgDelegate(address(u0), address(val), Coin("utia", 30 * POWER_REDUCTION))),
        chain.tx(u2, MsgCreateValidator("commissioned", "0.1", operator, operator, consensus,
                                        Coin("utia", 80 * POWER_REDUCTION))),
    ])
    txs = block_txs(chain.users, chain.chain_id, seed=9, sends=3, pfbs=3, blob_shares=(1, 2),
                    sequences=next_sequences(chain.port, chain.users))
    chain.block(txs, signers=chain.signers)
    res = chain.block([
        chain.tx(u0, MsgSetWithdrawAddress(address(u0), address(u1))),
        chain.tx(u0, MsgWithdrawDelegatorReward(address(u0), address(val))),
        chain.tx(u2, MsgWithdrawValidatorCommission(operator)),
        chain.tx(val, MsgWithdrawValidatorCommission(address(val))),  # commission rate 0
        chain.tx(u1, MsgFundCommunityPool((Coin("utia", 1_000),), address(u1))),
        chain.tx(u1, MsgWithdrawDelegatorReward(address(u1), address(val))),  # no delegation
    ], signers=chain.signers)
    assert codes(res)[:5] == [0, 0, 0, 2, 0]
    assert event(res, "EventWithdrawRewards")[2] > 0
    assert event(res, "EventWithdrawCommission")[1] > 0


def _param_change(key: str, value: str, subspace: str = "blob") -> tuple:
    return (ProposalParamChange(subspace, key, value),)


def chain_gov_v1beta1(chain: Chain) -> None:
    u0, u1, u2 = chain.users
    a0, a1, a2 = (address(k) for k in chain.users)
    val = address(chain.validators[0])
    chain.block([
        chain.tx(u0, MsgDelegate(a0, val, Coin("utia", 1_000 * POWER_REDUCTION))),
        chain.tx(u1, MsgDelegate(a1, val, Coin("utia", 100 * POWER_REDUCTION))),
    ])
    res = chain.block([
        chain.tx(u0, MsgSubmitProposal("gas", "per-byte gas to 16",
                                       _param_change("GasPerBlobByte", "16"),
                                       (Coin("utia", 4_000_000_000),), a0)),
        chain.tx(u1, MsgSubmitProposal("denom", "blocked", _param_change("BondDenom", "ufake",
                                                                         "staking"),
                                       (Coin("utia", 4_000_000_000),), a1)),
    ])
    assert codes(res) == [0, 2]
    assert "cannot be changed by governance" in res[1].log
    pid = event(res, "SubmitProposal")[1]
    # A community-pool spend too: it passes the tally, then finds the pool
    # holding less than it asks for or pays out, as the JAX App does.
    res = chain.block([chain.tx(u2, MsgSubmitProposal(
        "spend", "to u2", (), (Coin("utia", 10_000_000_000),), a2, spend_recipient=a2,
        spend_amount=(Coin("utia", 1),)))])
    assert codes(res) == [0]
    spend = event(res, "SubmitProposal")[1]
    res = chain.block([
        chain.tx(u2, MsgDeposit(pid, a2, (Coin("utia", 6_000_000_000),))),
        chain.tx(u0, MsgVote(pid, a0, int(VoteOption.YES))),
        chain.tx(u1, MsgVoteWeighted(pid, a1, ((int(VoteOption.YES), "0.7"),
                                               (int(VoteOption.NO), "0.3")))),
        chain.tx(u2, MsgVote(pid + 5, a2, int(VoteOption.YES))),
        chain.tx(u0, MsgVote(spend, a0, int(VoteOption.YES))),
    ])
    assert codes(res) == [0, 0, 0, 2, 0]
    assert chain.port.gas_per_blob_byte == 8
    chain.block([], dt=WEEK_NS + 1)  # the tally at the voting period's end
    assert chain.port.gas_per_blob_byte == chain.ref.gas_per_blob_byte == 16


def chain_gov_v1(chain: Chain) -> None:
    u0, u1, u2 = chain.users
    a0, a1, a2 = (address(k) for k in chain.users)
    val = address(chain.validators[1])
    chain.block([chain.tx(u0, MsgDelegate(a0, val, Coin("utia", 1_000 * POWER_REDUCTION)))])
    content = MsgSubmitProposal("gas", "v1", _param_change("GasPerBlobByte", "12"), (),
                                a0)._content()
    exec_msg = MsgExecLegacyContent(content, gov_module_address())
    res = chain.block([chain.tx(u0, MsgSubmitProposalV1((exec_msg.to_any(),),
                                                        (Coin("utia", 4_000_000_000),), a0,
                                                        "ipfs://meta"))])
    assert codes(res) == [0]
    pid = event(res, "SubmitProposal")[1]
    res = chain.block([
        chain.tx(u1, MsgDepositV1(pid, a1, (Coin("utia", 6_000_000_000),))),
        chain.tx(u0, MsgVoteV1(pid, a0, int(VoteOption.YES))),
        chain.tx(u2, MsgVoteWeightedV1(pid, a2, ((int(VoteOption.ABSTAIN), "0.5"),
                                                 (int(VoteOption.YES), "0.5")))),
    ])
    assert codes(res) == [0, 0, 0]
    chain.block([], dt=WEEK_NS + 1)
    assert chain.port.gas_per_blob_byte == 12


def chain_authz(chain: Chain) -> None:
    u0, u1, _ = chain.users
    a0, a1 = address(u0), address(u1)
    dest = address(PrivateKey.from_seed(b"authz-dest"))
    res = chain.block([chain.tx(u0, MsgAuthzGrant(a0, a1, SEND_PATH, spend_limit=1_000))])
    assert codes(res) == [0]
    send = MsgSend(a0, dest, (Coin("utia", 600),)).to_any()
    res = chain.block([
        chain.tx(u1, MsgAuthzExec(a1, (send,))),
        chain.tx(u1, MsgAuthzExec(a1, (send,))),  # over the spend limit
    ])
    assert codes(res) == [0, 2]
    assert chain.balance(dest) == 600
    res = chain.block([
        chain.tx(u0, MsgAuthzRevoke(a0, a1, SEND_PATH)),
        chain.tx(u1, MsgAuthzExec(a1, (MsgSend(a0, dest, (Coin("utia", 1),)).to_any(),))),
    ])
    assert codes(res) == [0, 2]


def chain_feegrant(chain: Chain) -> None:
    u0, u1, _ = chain.users
    a0, a1 = address(u0), address(u1)
    res = chain.block([chain.tx(u0, MsgGrantAllowance(a0, a1, spend_limit=200_000))])
    assert codes(res) == [0]
    before = chain.balance(a1)
    res = chain.block([chain.tx(u1, MsgSend(a1, a0, (Coin("utia", 7),)), gas=100_000,
                                granter=a0)])
    assert codes(res) == [0]
    assert chain.balance(a1) == before - 7
    res = chain.block([
        chain.tx(u0, MsgRevokeAllowance(a0, a1)),
        chain.tx(u0, MsgRevokeAllowance(a0, a1)),  # nothing left to revoke
    ])
    assert codes(res) == [0, 2]
    res = chain.block([chain.tx(u1, MsgSend(a1, a0, (Coin("utia", 7),)), gas=100_000,
                                granter=a0)])
    assert codes(res) == [1]


def chain_crisis_evidence_tx(chain: Chain) -> None:
    u0 = chain.users[0]
    a0 = address(u0)
    res = chain.block([chain.tx(u0, MsgVerifyInvariant(a0, module, route))
                       for module, route in (("bank", "total-supply"),
                                             ("staking", "bonded-pool"),
                                             ("distribution", "solvency"),
                                             ("gov", "deposits"),
                                             ("bank", "no-such-route"))])
    assert codes(res) == [0, 0, 0, 0, 2]
    # Evidence arrives through FinalizeBlock, never as a tx: no handler.
    evidence = Any("/cosmos.evidence.v1beta1.Equivocation", b"\x08\x01")
    res = chain.block([chain.tx(u0, MsgSubmitEvidence(a0, evidence))])
    assert codes(res) == [2] and "unregistered handler" in res[0].log


def chain_liveness_unjail(chain: Chain) -> None:
    chain.both(lambda store, which: (SlashingKeeper if which == "port" else JaxSlashingKeeper)(
        store).set_params((Params if which == "port" else JaxSlashingParams)(
            signed_blocks_window=4,
            min_signed_per_window=(Dec if which == "port" else JaxDec).from_str("0.75"))))
    lazy = chain.validators[0]
    active = chain.signers - {address(lazy)}
    chain.block([], signers=active)
    chain.block([], signers=active)
    staking = StakingKeeper(chain.port.cms.working)
    assert staking.is_jailed(address(lazy))
    res = chain.block([chain.tx(lazy, MsgUnjail(address(lazy)))], signers=active)
    assert codes(res) == [2]  # still inside the jail duration
    res = chain.block([chain.tx(lazy, MsgUnjail(address(lazy)))], dt=61 * 10**9,
                      signers=active)
    assert codes(res) == [0]
    assert not StakingKeeper(chain.port.cms.working).is_jailed(address(lazy))
    chain.block([], signers=chain.signers)


def _double_sign(index: int, chain_id: str, height: int) -> tuple:
    """One validator's two conflicting precommits, as (port, JAX) Equivocations."""
    records = []
    for key_type, vote_type, record_type in ((PrivateKey, Vote, Equivocation),
                                             (JaxPrivateKey, JaxVote, JaxEquivocation)):
        key = key_type.from_seed(f"validator-{index}".encode())
        a = vote_type.sign(key, chain_id, height, PRECOMMIT, b"\x01" * 32)
        b = vote_type.sign(key, chain_id, height, PRECOMMIT, b"\x02" * 32)
        records.append(record_type(a, b))
    return tuple(records)


def chain_evidence(chain: Chain) -> None:
    chain.block([])
    chain.block([])
    wrong_chain = _double_sign(1, "another-chain", 1)
    valid = _double_sign(0, chain.chain_id, 1)
    chain.block([], signers=chain.signers,
                evidence=((wrong_chain[0], valid[0]), (wrong_chain[1], valid[1])))
    staking = StakingKeeper(chain.port.cms.working)
    byzantine = address(chain.validators[0])
    assert staking.is_jailed(byzantine)
    assert staking.tokens(byzantine) == 98 * POWER_REDUCTION
    assert not staking.is_jailed(address(chain.validators[1]))
    assert SlashingKeeper(chain.port.cms.working).signing_info(byzantine).tombstoned
    # The same evidence again: the tombstoned validator is not punished twice.
    chain.block([], evidence=((valid[0],), (valid[1],)))
    assert StakingKeeper(chain.port.cms.working).tokens(byzantine) == 98 * POWER_REDUCTION


def chain_signal_upgrade(chain: Chain) -> None:
    res = chain.block([chain.tx(v, MsgSignalVersion(address(v), 3)) for v in chain.validators]
                      + [chain.tx(chain.users[0], MsgTryUpgrade(address(chain.users[0])))])
    assert codes(res) == [0, 0, 0, 0]
    assert chain.port.app_version == 2
    chain.block([])
    assert chain.port.app_version == 2
    chain.block([])  # the upgrade height
    assert chain.port.app_version == chain.ref.app_version == 3
    txs = block_txs(chain.users, chain.chain_id, seed=5, sends=3, pfbs=0, sequences=[1, 0, 0])
    assert codes(chain.block(txs)) == [0, 0, 0]


def chain_v1_blobstream_upgrade(chain: Chain) -> None:
    assert chain.port.app_version == 1
    for h in range(1, 5):
        txs = block_txs(chain.users, chain.chain_id, seed=h, sends=3, pfbs=2,
                        blob_shares=(1, 3), sequences=next_sequences(chain.port, chain.users))
        res = chain.block(txs)
        assert codes(res) == [0] * 5
        assert chain.port.app_version == (1 if h < 3 else 2)
    # Signalling exists from v2 on.
    res = chain.block([chain.tx(chain.validators[0],
                                MsgSignalVersion(address(chain.validators[0]), 2))])
    assert codes(res) == [0]


def chain_gas_and_failures(chain: Chain) -> None:
    u0, u1, _ = chain.users
    a0, a1 = address(u0), address(u1)
    many = MsgMultiSend((BankIO(a0, (Coin("utia", 40),)),),
                        tuple(BankIO(address(PrivateKey.from_seed(f"r{i}".encode())),
                                     (Coin("utia", 1),)) for i in range(40)))
    probe = build_and_sign([many], u0, chain.chain_id, 0, 0, Fee((Coin("utia", 0),), 1))
    needed = chain.port.simulate_tx(probe).gas_used
    before = chain.balance(a0)
    res = chain.block([
        chain.tx(u0, many, gas=needed - 15_000, fee=100_000),  # out of gas in execution
        chain.tx(u1, MsgSend(a1, a0, (Coin("utia", 10**15),)), fee=100_000),  # overdraft
        chain.tx(u0, MsgSend(a0, a1, (Coin("utia", 3),)), fee=100_000),
    ])
    assert codes(res) == [11, 2, 0]
    assert res[0].gas_used > res[0].gas_wanted and res[1].gas_used > 0
    # Ante effects kept: both fees paid, both sequences advanced.
    assert chain.balance(a0) == before - 200_000 - 3
    accounts = AuthKeeper(chain.port.cms.working)
    assert (accounts.get_account(a0).sequence, accounts.get_account(a1).sequence) == (2, 1)
    # A PFB whose gas limit covers the ante but not the blob gas, and a tx
    # whose fee cannot be paid.
    blob = Blob(Namespace.v0(b"\x07" * 10), bytes(range(256)) * 8)
    pfb = new_msg_pay_for_blobs(a0, [blob])
    probe = build_and_sign([pfb], u0, chain.chain_id, 0, 2, Fee((Coin("utia", 0),), 1))
    needed = chain.port.simulate_tx(BlobTx(probe, (blob,)).marshal()).gas_used
    assert needed < estimate_gas([len(blob.data)])
    short = chain.tx(u0, pfb, gas=needed - 5_000, fee=100_000)  # blob gas 20,480
    broke = PrivateKey.from_seed(b"no-funds")
    unfunded = build_and_sign([MsgSend(address(broke), a0, (Coin("utia", 1),))], broke,
                              chain.chain_id, 0, 0, Fee((Coin("utia", 100),), 100_000))
    res = chain.block([BlobTx(short, (blob,)).marshal(), unfunded])
    assert codes(res) == [2, 1]
    assert "blob gas" in res[0].log


CHAINS = {
    "sends_pfbs_multisend": (chain_sends_pfbs_multisend, {}),
    "vesting": (chain_vesting, {}),
    "staking": (chain_staking, {}),
    "distribution": (chain_distribution, {}),
    "gov_v1beta1": (chain_gov_v1beta1, {}),
    "gov_v1": (chain_gov_v1, {}),
    "authz": (chain_authz, {}),
    "feegrant": (chain_feegrant, {}),
    "crisis_evidence_tx": (chain_crisis_evidence_tx, {}),
    "liveness_unjail": (chain_liveness_unjail, {}),
    "evidence": (chain_evidence, {}),
    "signal_upgrade": (chain_signal_upgrade, {}),
    "v1_blobstream_upgrade": (chain_v1_blobstream_upgrade,
                              {"app_version": 1, "app_kw": {"v2_upgrade_height": 3},
                               "data_commitment_window": 2}),
    "gas_and_failures": (chain_gas_and_failures, {}),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_block_execution_equal(name, monkeypatch):
    fn, kw = CHAINS[name]
    for module in (port_signal, jax_signal):
        monkeypatch.setattr(module, "DEFAULT_UPGRADE_HEIGHT_DELAY", 2)
    fn(Chain(**kw))


def test_simulate_tx_equal():
    chain = Chain()
    u0 = chain.users[0]
    txs = block_txs(chain.users, chain.chain_id, seed=12, sends=2, pfbs=2, blob_shares=(1, 9))
    unsigned = build_and_sign([MsgDelegate(address(u0), address(chain.validators[0]),
                                           Coin("utia", 1_000))], u0, chain.chain_id, 0, 0,
                              Fee((Coin("utia", 0),), 0))
    cases = txs + [unsigned, b"\x0a\x03abc"]
    got = [result(chain.port.simulate_tx(raw)) for raw in cases]
    assert got == [result(chain.ref.simulate_tx(raw)) for raw in cases]
    # Each simulation starts from committed state: the last PFB's signer
    # already signed the block's first send, so its sequence is one ahead.
    assert [g[0] for g in got] == [0, 0, 0, 1, 0, 1]
    assert got[2][3] > got[0][3]  # a PFB's blob gas on top of the ante's
    # Simulation leaves no state behind.
    assert chain.port.cms.working.snapshot() == chain.ref.cms.working.snapshot()
    assert codes(chain.block(txs)) == [0, 0, 0, 0]


def test_invariant_broken_propagates_out_of_finalize_block():
    chain = Chain()
    u0 = chain.users[0]
    # A balance out of step with the supply, written past the bank keeper.
    key = b"bank/bal/" + address(u0).encode() + b"/utia"
    assert chain.port.cms.working.get(key) == chain.ref.cms.working.get(key) is not None
    chain.both(lambda store, _: store.set(key, (10**13).to_bytes(16, "big")))
    check = chain.tx(u0, MsgVerifyInvariant(address(u0), "bank", "total-supply"))
    time_ns = chain.port.last_block_time_ns + BLOCK_INTERVAL_NS
    hash_before = chain.port.cms.last_app_hash
    with pytest.raises(InvariantBroken):
        chain.port.finalize_block(time_ns, [check])
    with pytest.raises(JaxInvariantBroken):
        chain.ref.finalize_block(time_ns, [check])
    assert chain.port.height == chain.ref.height == 0
    assert chain.port.cms.last_app_hash == hash_before


def test_block_metrics_written():
    """finalize_block counts delivered txs by code and commit sets the
    height gauge, in the port's metrics registry as in the JAX App's."""
    from celestia_app_tpu_torch.trace.metrics import registry

    chain = Chain()
    delivered = registry().counter("celestia_txs_delivered_total")
    before = dict((labels["code"], v) for labels, v in delivered.samples())
    u0 = chain.users[0]
    chain.block([chain.tx(u0, MsgSend(address(u0), address(u0), (Coin("utia", 1),))),
                 chain.tx(u0, MsgSend(address(u0), address(u0), (Coin("utia", 10**15),)))])
    after = dict((labels["code"], v) for labels, v in delivered.samples())
    assert after["0"] == before.get("0", 0) + 1 and after["2"] == before.get("2", 0) + 1
    assert "celestia_block_height 1" in registry().render()


def test_commit_resets_check_state():
    chain = Chain()
    txs = block_txs(chain.users, chain.chain_id, seed=2, sends=3, pfbs=0)
    assert [chain.port.check_tx(t).code for t in txs] == [0, 0, 0]
    assert [chain.port.check_tx(t).code for t in txs] == [1, 1, 1]  # sequences used
    chain.block(txs)
    got = [result(chain.port.check_tx(t)) for t in txs]
    assert got == [result(chain.ref.check_tx(t)) for t in txs]
    assert [g[0] for g in got] == [1, 1, 1]
    again = block_txs(chain.users, chain.chain_id, seed=2, sends=3, pfbs=0,
                      sequences=[1, 1, 1])
    assert [chain.port.check_tx(t).code for t in again] == [0, 0, 0]


def test_app_from_export_carries_minter_and_options():
    """A JAX chain after three blocks a day apart (a day's provision each,
    fees swept, a v1 chain with a pending v2 upgrade height) carried across:
    the next blocks give equal results and app hashes on both.  The minter
    matters: the JAX App keeps the annual provisions of its first block's
    supply until the rate changes, and an App started from
    Minter.default() computes them from the supply it finds."""
    day = 24 * 3600 * 10**9
    keys = funded_keys(N_USERS)
    jax_keys = [JaxPrivateKey.from_seed(s) for s in SEEDS[:N_USERS]]
    ref = JaxApp(v2_upgrade_height=5, ibc_token_filter=False)
    ref.init_chain(jax_genesis(jax_keys, app_version=1, data_commitment_window=2))
    for h in range(1, 4):
        txs = block_txs(keys, ref.chain_id, seed=20 + h, sends=3, pfbs=1, blob_shares=(1, 2),
                        sequences=[2 * (h - 1), h - 1, h - 1])
        assert codes(ref.finalize_block(ref.last_block_time_ns + day, txs)) == [0] * 4
        ref.commit()
    m = ref.minter
    port = app_from_export(
        ref.cms.export(), chain_id=ref.chain_id, app_version=ref.app_version,
        height=ref.height, genesis_time_ns=ref.genesis_time_ns,
        last_block_time_ns=ref.last_block_time_ns,
        minter={"inflation_rate": m.inflation_rate.raw,
                "annual_provisions": m.annual_provisions.raw,
                "previous_block_time_ns": m.previous_block_time_ns},
        v2_upgrade_height=ref.v2_upgrade_height, ibc_token_filter=ref.ibc_token_filter,
        device="cpu")
    assert port.cms.last_app_hash == ref.cms.last_app_hash
    assert (port.v2_upgrade_height, port.ibc_token_filter) == (5, False)
    bare = app_from_export(ref.cms.export(), chain_id=ref.chain_id,
                           app_version=ref.app_version, height=ref.height,
                           genesis_time_ns=ref.genesis_time_ns,
                           last_block_time_ns=ref.last_block_time_ns, device="cpu")
    for h in range(4, 7):
        txs = block_txs(keys, ref.chain_id, seed=20 + h, sends=3, pfbs=1, blob_shares=(1, 2),
                        sequences=[2 * (h - 1), h - 1, h - 1])
        time_ns = ref.last_block_time_ns + day
        got = port.finalize_block(time_ns, txs)
        want = ref.finalize_block(time_ns, txs)
        assert [result(r) for r in got] == [result(r) for r in want]
        assert codes(got) == [0] * 4
        assert port.commit() == ref.commit()
        assert port.app_version == ref.app_version == (1 if h < 5 else 2)
        if h == 4:  # without the minter, the first block mints another provision
            bare.finalize_block(time_ns, txs)
            assert bare.commit() != ref.cms.last_app_hash


def test_golden_chain_app_hash_pinned():
    genesis = deterministic_genesis(funded_keys(4), gov_max_square_size=64)
    golden = chip_smoke.APP_GOLDEN
    txs = block_txs(funded_keys(golden["n_keys"]), genesis.chain_id, seed=golden["seed"],
                    sends=golden["sends"], pfbs=golden["pfbs"],
                    blob_shares=golden["blob_shares"])
    signers = {v.address for v in genesis.validators}
    port, ref = App(device="cpu"), JaxApp()
    port.init_chain(genesis)
    ref.init_chain(jax_genesis([JaxPrivateKey.from_seed(f"account-{i}".encode())
                                for i in range(4)], gov_max_square_size=64))
    time_ns = GENESIS_TIME_NS + BLOCK_INTERVAL_NS
    got = port.finalize_block(time_ns, txs, last_commit_signers=signers)
    want = ref.finalize_block(time_ns, txs, last_commit_signers=signers)
    assert [result(r) for r in got] == [result(r) for r in want]
    assert codes(got) == [0] * len(txs)
    assert port.commit().hex() == ref.commit().hex() == GOLDEN_APP_HASH
    assert chip_smoke.CHAIN_GOLDEN_APP_HASH == GOLDEN_APP_HASH
