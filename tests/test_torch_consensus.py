"""The port's consensus logic on the CPU against the JAX package's: the
round machine, the round journal, the vote WAL and the chaos spec.

No App is built here, so nothing compiles.  Each scenario of
tests/test_round_machine.py runs on JAX `RoundMachine`s and on port
`RoundMachine`s over the same keys and the same scripted deliveries (the
`Net` harness below is a port of that file's), and every effect the
machines return must be equal step for step: type, fields, sign bytes and
signatures.  The round journal's rows are equal under one injected clock
(and pin `precommit_power == 0.75` at decide, which is what the JAX code
gives: the machine closes the round at +2/3), the WAL files are equal byte
for byte through the same `may_sign` / `record_lock` / `prune` sequence and
a torn tail injected through the chaos spec, and the chaos spec parses the
same specs to the same per-seam decisions under a seed.
"""

from __future__ import annotations

import dataclasses
import importlib
from collections import defaultdict
from types import SimpleNamespace

import pytest

PACKAGES = ("celestia_app_tpu", "celestia_app_tpu_torch")
CHAIN = "round-test"
BLOCK_A = b"\xaa" * 32
BLOCK_B = b"\xbb" * 32


def package(name: str) -> SimpleNamespace:
    mod = importlib.import_module
    return SimpleNamespace(
        name=name,
        m=mod(f"{name}.consensus.machine"),
        v=mod(f"{name}.consensus.votes"),
        PrivateKey=mod(f"{name}.crypto.keys").PrivateKey,
        RoundJournal=mod(f"{name}.trace.round_journal").RoundJournal,
        traced=mod(f"{name}.trace.tracer").traced,
        VoteWAL=mod(f"{name}.consensus.wal").VoteWAL,
        chaos=mod(f"{name}.chaos"),
    )


def norm(obj):
    """A package-free view of an effect: class name and fields, recursively;
    a vote also carries its wire bytes, a proposal its sign bytes."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = tuple((f.name, norm(getattr(obj, f.name))) for f in dataclasses.fields(obj))
        extra = ()
        if type(obj).__name__ == "Vote":
            extra = (("marshal", obj.marshal()),)
        elif type(obj).__name__ == "Proposal":
            extra = (("sign_bytes", obj.sign_bytes(CHAIN)),)
        return (type(obj).__name__, fields + extra)
    if isinstance(obj, (list, tuple)):
        return tuple(norm(x) for x in obj)
    return obj


def signed_proposal(pkg, key, height, round_, block, pol_round, proposer):
    unsigned = pkg.m.Proposal(height, round_, block, pol_round, proposer)
    return pkg.m.Proposal(height, round_, block, pol_round, proposer,
                          key.sign(unsigned.sign_bytes(CHAIN)))


class Net:
    """N machines + a scripted network (tests/test_round_machine.py's
    harness), recording every effect list a machine returns."""

    def __init__(self, pkg, n=4, height=1):
        self.pkg = pkg
        self.keys = [pkg.PrivateKey.from_seed(f"rm-val-{i}".encode()) for i in range(n)]
        self.addrs = [k.public_key().address() for k in self.keys]
        self.validators = {a: (k.public_key(), 100) for a, k in zip(self.addrs, self.keys)}
        self.machines = [
            pkg.m.RoundMachine(CHAIN, height, self.validators, list(self.addrs),
                               my_address=a, my_key=k)
            for a, k in zip(self.addrs, self.keys)
        ]
        self.pending: dict[int, list] = defaultdict(list)
        self.timeouts: dict[int, list] = defaultdict(list)
        self.decided: dict = {}
        self.log: list = []

    def vote(self, i, vote_type, block, round_, height=1):
        return self.pkg.v.Vote.sign(self.keys[i], CHAIN, height, vote_type, block,
                                    validator=self.addrs[i], round=round_)

    def call(self, i, fn, *args, **kwargs):
        """fn(*args) on machine i's behalf; its effects are absorbed."""
        effects = fn(*args, **kwargs)
        self._absorb(i, effects)
        return effects

    def start(self, only=None):
        for i, m in enumerate(self.machines):
            if only is None or i in only:
                self.call(i, m.start)

    def _absorb(self, i, effects):
        self.log.append((i, norm(effects)))
        for e in effects:
            if isinstance(e, self.pkg.m.ScheduleTimeout):
                self.timeouts[i].append(e)
            elif isinstance(e, self.pkg.m.Decided):
                self.decided[i] = e
            elif not isinstance(e, self.pkg.m.EvidenceFound):
                self.pending[i].append(e)

    def deliver_all(self, to=None, drop_from=()):
        progressed = True
        while progressed:
            progressed = False
            for i in range(len(self.machines)):
                while self.pending[i]:
                    eff = self.pending[i].pop(0)
                    if i in drop_from:
                        continue
                    progressed = True
                    for j, m in enumerate(self.machines):
                        if j == i or (to is not None and j not in to):
                            continue
                        if isinstance(eff, self.pkg.m.BroadcastVote):
                            self.call(j, m.on_vote, eff.vote)
                        elif isinstance(eff, self.pkg.m.BroadcastProposal):
                            ok = m.verify_proposal(eff.proposal)
                            self.call(j, m.on_proposal, eff.proposal, valid=ok)

    def take_request(self, i):
        req = next(e for e in self.pending[i] if isinstance(e, self.pkg.m.RequestProposal))
        self.pending[i].remove(req)
        return req

    def fire(self, i, step, round_=None):
        m = self.machines[i]
        round_ = m.round if round_ is None else round_
        match = next(t for t in self.timeouts[i] if t.step == step and t.round == round_)
        self.timeouts[i].remove(match)
        self.call(i, m.on_timeout, match.round, match.step)

    def state(self):
        return [(m.round, m.step, m.locked_value, m.locked_round, m.valid_value,
                 m.valid_round) for m in self.machines]


# --- the scenarios of tests/test_round_machine.py ---------------------------

def happy_path(net):
    net.start()
    assert net.take_request(0).block_hash == net.pkg.v.NIL
    net.call(0, net.machines[0].on_own_proposal, BLOCK_A)
    net.deliver_all()
    assert {d.round for d in net.decided.values()} == {0} and len(net.decided) == 4


def observer(net):
    pkg = net.pkg
    obs = pkg.m.RoundMachine(CHAIN, 1, net.validators, list(net.addrs))
    net.call(4, obs.start)
    net.start()
    net.take_request(0)
    effects = net.call(0, net.machines[0].on_own_proposal, BLOCK_A)
    prop = next(e.proposal for e in effects if isinstance(e, pkg.m.BroadcastProposal))
    net.deliver_all()
    net.call(4, obs.on_proposal, prop, valid=obs.verify_proposal(prop))
    for m in net.machines:
        for v in m.precommits[0].votes.values():
            net.call(4, obs.on_vote, v)
        for v in m.prevotes[0].votes.values():
            try:
                net.call(4, obs.on_vote, v)
            except pkg.v.ConsensusError as e:
                net.log.append(("error", str(e)))
    assert obs.decided is not None and obs.decided.block_hash == BLOCK_A


def dead_proposer(net):
    live = {1, 2, 3}
    net.start(only=live)
    for i in live:
        net.fire(i, "propose")
    net.deliver_all(to=live)
    for i in live:
        net.fire(i, "precommit", round_=0)
    net.take_request(1)
    net.call(1, net.machines[1].on_own_proposal, BLOCK_B)
    net.deliver_all(to=live)
    assert all(net.decided[i].round == 1 for i in live)


def nil_on_invalid_proposal(net):
    net.start()
    net.take_request(0)
    effects = net.machines[0].on_own_proposal(BLOCK_A)
    prop = next(e.proposal for e in effects if isinstance(e, net.pkg.m.BroadcastProposal))
    for i in (1, 2, 3):
        net.call(i, net.machines[i].on_proposal, prop, valid=False)
    net.deliver_all(to={1, 2, 3}, drop_from={0})
    assert all(net.machines[i].locked_round == -1 for i in (1, 2, 3))


def lock_refuses_conflicting(net):
    pkg = net.pkg
    net.start()
    net.take_request(0)
    net.call(0, net.machines[0].on_own_proposal, BLOCK_A)
    net.deliver_all(to={1, 2})
    m2 = net.machines[2]
    for i in (0, 3):
        net.call(2, m2.on_vote, net.vote(i, pkg.v.PREVOTE, pkg.v.NIL, 1))
    prop_b = signed_proposal(pkg, net.keys[1], 1, 1, BLOCK_B, -1, net.addrs[1])
    assert m2.verify_proposal(prop_b)
    effects = net.call(2, m2.on_proposal, prop_b, valid=True)
    assert all(e.vote.is_nil for e in effects if isinstance(e, pkg.m.BroadcastVote))
    assert m2.locked_value == BLOCK_A


def reproposes_valid_value(net):
    pkg = net.pkg
    net.start()
    net.take_request(0)
    net.call(0, net.machines[0].on_own_proposal, BLOCK_A)
    net.deliver_all(to={1, 2})
    for i in (0, 3):
        net.call(1, net.machines[1].on_vote, net.vote(i, pkg.v.PREVOTE, pkg.v.NIL, 1))
    req = net.take_request(1)
    assert req.block_hash == BLOCK_A and req.pol_round == 0


def unlock_on_newer_polka(net):
    pkg = net.pkg
    m3 = net.machines[3]
    net.start(only={3})
    net.call(3, m3.on_proposal,
             signed_proposal(pkg, net.keys[0], 1, 0, BLOCK_A, -1, net.addrs[0]), valid=True)
    for i in (0, 1, 2):
        net.call(3, m3.on_vote, net.vote(i, pkg.v.PREVOTE, BLOCK_A, 0))
    for i in (0, 1):
        net.call(3, m3.on_vote, net.vote(i, pkg.v.PREVOTE, BLOCK_B, 2))
    for i in (0, 1, 2):
        net.call(3, m3.on_vote, net.vote(i, pkg.v.PREVOTE, BLOCK_B, 1))
    effects = net.call(3, m3.on_proposal,
                       signed_proposal(pkg, net.keys[2], 1, 2, BLOCK_B, 1, net.addrs[2]),
                       valid=True)
    votes = [e.vote for e in effects if isinstance(e, pkg.m.BroadcastVote)]
    assert votes and votes[0].block_hash == BLOCK_B


def stale_polka(net):
    pkg = net.pkg
    m3 = net.machines[3]
    net.start(only={3})
    for i in (0, 1, 2):
        net.call(3, m3.on_vote, net.vote(i, pkg.v.PREVOTE, BLOCK_B, 0))
    for i in (0, 1):
        net.call(3, m3.on_vote, net.vote(i, pkg.v.PREVOTE, BLOCK_A, 1))
    net.call(3, m3.on_proposal,
             signed_proposal(pkg, net.keys[1], 1, 1, BLOCK_A, -1, net.addrs[1]), valid=True)
    net.call(3, m3.on_vote, net.vote(2, pkg.v.PREVOTE, BLOCK_A, 1))
    assert m3.locked_round == 1
    for i in (0, 1):
        net.call(3, m3.on_vote, net.vote(i, pkg.v.PREVOTE, BLOCK_B, 2))
    effects = net.call(3, m3.on_proposal,
                       signed_proposal(pkg, net.keys[2], 1, 2, BLOCK_B, 0, net.addrs[2]),
                       valid=True)
    votes = [e.vote for e in effects if isinstance(e, pkg.m.BroadcastVote)]
    assert votes and votes[0].is_nil


def one_third_catch_up(net):
    pkg = net.pkg
    m3 = net.machines[3]
    net.start(only={3})
    net.call(3, m3.on_vote, net.vote(0, pkg.v.PREVOTE, pkg.v.NIL, 5))
    assert m3.round == 0
    net.call(3, m3.on_vote, net.vote(1, pkg.v.PREVOTE, pkg.v.NIL, 5))
    assert m3.round == 5


def equivocation_evidence(net):
    pkg = net.pkg
    m3 = net.machines[3]
    net.start(only={3})
    net.call(3, m3.on_vote, net.vote(0, pkg.v.PREVOTE, BLOCK_A, 0))
    effects = net.call(3, m3.on_vote, net.vote(0, pkg.v.PREVOTE, BLOCK_B, 0))
    assert len([e for e in effects if isinstance(e, pkg.m.EvidenceFound)]) == 1
    effects = net.call(3, m3.on_vote, net.vote(0, pkg.v.PREVOTE, BLOCK_A, 1))
    assert not any(isinstance(e, pkg.m.EvidenceFound) for e in effects)


def forged_and_foreign_votes(net):
    pkg = net.pkg
    m3 = net.machines[3]
    net.start(only={3})
    outsider = pkg.PrivateKey.from_seed(b"outsider")
    bad = [
        pkg.v.Vote.sign(outsider, CHAIN, 1, pkg.v.PREVOTE, BLOCK_A, round=0),
        pkg.v.Vote(1, pkg.v.PREVOTE, BLOCK_A, net.addrs[0], b"\x01" * 64, 0),
        net.vote(0, pkg.v.PREVOTE, BLOCK_A, 0, height=9),
    ]
    for vote in bad:
        with pytest.raises(pkg.v.ConsensusError) as err:
            m3.on_vote(vote)
        net.log.append(("error", str(err.value)))


def proposal_wire_verification(net):
    pkg = net.pkg
    m3 = net.machines[3]
    net.start(only={3})
    verdicts = [
        m3.verify_proposal(signed_proposal(pkg, net.keys[1], 1, 0, BLOCK_A, -1, net.addrs[1])),
        m3.verify_proposal(pkg.m.Proposal(1, 0, BLOCK_A, -1, net.addrs[0], b"\x00" * 64)),
        m3.verify_proposal(signed_proposal(pkg, net.keys[0], 1, 0, BLOCK_A, -1, net.addrs[0])),
    ]
    assert verdicts == [False, False, True]
    net.log.append(("verdicts", verdicts))


SCENARIOS = [happy_path, observer, dead_proposer, nil_on_invalid_proposal,
             lock_refuses_conflicting, reproposes_valid_value, unlock_on_newer_polka,
             stale_polka, one_third_catch_up, equivocation_evidence,
             forged_and_foreign_votes, proposal_wire_verification]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_round_machine_effects_equal(scenario):
    runs = []
    for name in PACKAGES:
        net = Net(package(name))
        scenario(net)
        runs.append((net.log, net.state(), sorted(
            (i, norm(d)) for i, d in net.decided.items())))
    assert runs[0] == runs[1]
    assert runs[1][0], "the scenario recorded no effects"


def test_proposal_sign_bytes_equal():
    got = []
    for name in PACKAGES:
        pkg = package(name)
        key = pkg.PrivateKey.from_seed(b"rm-val-0")
        prop = signed_proposal(pkg, key, 7, 3, BLOCK_A, 1, key.public_key().address())
        got.append((prop.sign_bytes(CHAIN), prop.sign_bytes("other-chain"), prop.signature))
    assert got[0] == got[1]


# --- the round journal ------------------------------------------------------

def journal_rows(pkg, drive) -> list[dict]:
    """The round_journal rows `drive(pkg, journal, clock)` writes, without
    the tracer's wall-clock stamp."""
    clock = [0.0]
    fsync = [0.0]
    journal = pkg.RoundJournal(clock=lambda: clock[0], fsync_ms_source=lambda: fsync[0])
    before = len(pkg.traced().table(pkg.RoundJournal.TABLE))
    drive(pkg, journal, clock, fsync)
    return [{k: v for k, v in row.items() if k != "ts_ns"}
            for row in pkg.traced().table(pkg.RoundJournal.TABLE)[before:]]


def decide_sequence(pkg, journal, clock, fsync):
    net = Net(pkg)
    m0 = net.machines[0]
    m0.journal = journal
    m0.start()
    clock[0] = 0.010
    m0.on_own_proposal(BLOCK_A)
    journal.trace_id = "trace-xyz"
    clock[0] = 0.030
    for i in (1, 2, 3):
        m0.on_vote(net.vote(i, pkg.v.PREVOTE, BLOCK_A, 0))
    clock[0] = 0.060
    fsync[0] = 2.5
    for i in (1, 2, 3):
        m0.on_vote(net.vote(i, pkg.v.PRECOMMIT, BLOCK_A, 0))
    assert m0.decided is not None


def round_bump(pkg, journal, clock, fsync):
    m1 = Net(pkg).machines[1]
    m1.journal = journal
    m1.start()
    for t, step in ((0.5, "propose"), (0.8, "prevote"), (1.0, "precommit")):
        clock[0] = t
        fsync[0] += 1.25
        m1.on_timeout(0, step)
    clock[0] = 1.7
    m1.on_timeout(1, "propose")
    m1.on_timeout(1, "prevote")
    m1.on_timeout(1, "precommit")


def late_round_decide(pkg, journal, clock, fsync):
    """A decide in round 1 after a round-0 bump, the precommits arriving
    before the proposal."""
    net = Net(pkg)
    m2 = net.machines[2]
    m2.journal = journal
    m2.start()
    clock[0] = 0.6
    m2.on_timeout(0, "propose")
    for i in (0, 1):
        m2.on_vote(net.vote(i, pkg.v.PREVOTE, BLOCK_B, 1))
    clock[0] = 0.9
    for i in (0, 1, 3):
        m2.on_vote(net.vote(i, pkg.v.PRECOMMIT, BLOCK_B, 1))
    clock[0] = 1.2
    m2.on_proposal(signed_proposal(pkg, net.keys[1], 1, 1, BLOCK_B, -1, net.addrs[1]),
                   valid=True)
    assert m2.decided is not None and m2.decided.round == 1


@pytest.mark.parametrize("drive", [decide_sequence, round_bump, late_round_decide],
                         ids=lambda f: f.__name__)
def test_round_journal_rows_equal(drive):
    jax_rows, port_rows = (journal_rows(package(name), drive) for name in PACKAGES)
    assert jax_rows == port_rows and port_rows


def test_round_journal_decide_closes_at_two_thirds():
    """The machine closes the round the moment it decides, at +2/3: three of
    the four precommits are in the tally (tests/test_round_journal.py
    expects 1.0 there; the JAX code, and so the port, gives 0.75)."""
    row = journal_rows(package("celestia_app_tpu_torch"), decide_sequence)[-1]
    assert row["result"] == "decided" and row["trace_id"] == "trace-xyz"
    assert row["prevote_power"] == 1.0
    assert row["precommit_power"] == 0.75
    assert row["propose_ms"] == pytest.approx(10.0)
    assert row["prevote_ms"] == pytest.approx(20.0)
    assert row["total_ms"] == pytest.approx(60.0)
    assert row["wal_fsync_ms"] == 2.5


# --- the vote WAL -----------------------------------------------------------

def wal_sequence(pkg, path):
    """The same may_sign / record_lock / prune sequence; the verdicts, the
    file after each stage, and what a restart restores."""
    PREVOTE, PRECOMMIT = pkg.v.PREVOTE, pkg.v.PRECOMMIT
    out = []
    wal = pkg.VoteWAL(str(path))
    out.append([wal.may_sign(h, r, t, b) for h, r, t, b in (
        (5, 0, PREVOTE, BLOCK_A), (5, 0, PREVOTE, BLOCK_A), (5, 0, PREVOTE, BLOCK_B),
        (5, 1, PREVOTE, BLOCK_B), (6, 0, PRECOMMIT, b""), (3, 0, PREVOTE, BLOCK_A))])
    wal.record_lock(5, 1, BLOCK_B)
    wal.record_lock(6, 0, BLOCK_A)
    wal.close()
    out.append(path.read_bytes())
    wal = pkg.VoteWAL(str(path))
    out.append((wal.lock_for(5), wal.lock_for(6), wal.lock_for(7),
                wal.may_sign(5, 1, PREVOTE, BLOCK_A), wal.salvaged_bytes))
    assert wal.prune(below_height=5)
    wal.close()
    out.append(path.read_bytes())
    wal = pkg.VoteWAL(str(path))
    out.append((wal.may_sign(3, 0, PREVOTE, BLOCK_B), wal.lock_for(6)))
    wal.close()
    out.append(path.read_bytes())
    return out


def test_wal_files_and_restarts_equal(tmp_path):
    jax_run, port_run = (wal_sequence(package(name), tmp_path / f"{name}.wal")
                         for name in PACKAGES)
    assert jax_run == port_run
    assert port_run[2][:3] == ((1, BLOCK_B), (0, BLOCK_A), None)


def torn_tail_run(pkg, path):
    """Two appends under `wal_torn_tail=1` (the chaos seam tears the first),
    the self-heal on the second, then a crash-torn tail salvaged on
    replay."""
    pkg.chaos.install("seed=3,wal_torn_tail=1")
    try:
        wal = pkg.VoteWAL(str(path))
        wal.may_sign(4, 0, pkg.v.PREVOTE, BLOCK_A)
        torn = path.read_bytes()
        wal.may_sign(4, 0, pkg.v.PRECOMMIT, BLOCK_A)
        healed = path.read_bytes()
        wal.close()
    finally:
        pkg.chaos.uninstall()
    with open(path, "ab") as f:
        f.write(b'{"k":"vote","h":5,"r":0')
    wal = pkg.VoteWAL(str(path))
    replay = (wal.salvaged_bytes, wal.may_sign(4, 0, pkg.v.PREVOTE, BLOCK_B),
              wal.may_sign(5, 0, pkg.v.PREVOTE, BLOCK_B))
    wal.close()
    return torn, healed, replay, path.read_bytes()


def test_wal_torn_tail_salvage_equal(tmp_path):
    jax_run, port_run = (torn_tail_run(package(name), tmp_path / f"{name}.wal")
                         for name in PACKAGES)
    assert jax_run == port_run
    torn, healed, replay, _ = port_run
    assert torn.endswith(b'"t"') and healed.endswith(b"\n")
    assert replay == (len(b'{"k":"vote","h":5,"r":0'), False, True)


def test_wal_guards_machine_across_restart(tmp_path):
    """A restarted machine with the WAL as its sign guard refuses to
    equivocate and resumes its lock, the same in both packages."""
    runs = []
    for name in PACKAGES:
        pkg = package(name)
        path = tmp_path / f"{name}.wal"
        net = Net(pkg)
        wal = pkg.VoteWAL(str(path))
        m = net.machines[1]
        m.sign_guard = wal.may_sign
        effects = [norm(m.start())]
        effects.append(norm(m.on_proposal(
            signed_proposal(pkg, net.keys[0], 1, 0, BLOCK_A, -1, net.addrs[0]), valid=True)))
        for i in (0, 2):
            got = m.on_vote(net.vote(i, pkg.v.PREVOTE, BLOCK_A, 0))
            effects.append(norm(got))
            for e in got:
                if isinstance(e, pkg.m.Locked):
                    wal.record_lock(1, e.round, e.block_hash)
        wal.close()
        wal = pkg.VoteWAL(str(path))
        locked_round, locked_value = wal.lock_for(1)
        again = pkg.m.RoundMachine(CHAIN, 1, net.validators, list(net.addrs),
                                   my_address=net.addrs[1], my_key=net.keys[1],
                                   sign_guard=wal.may_sign, locked_value=locked_value,
                                   locked_round=locked_round)
        effects.append(norm(again.start()))
        effects.append(norm(again.on_timeout(0, "propose")))  # nil: refused by the WAL
        effects.append(norm(again.on_proposal(
            signed_proposal(pkg, net.keys[1], 1, 1, BLOCK_B, -1, net.addrs[1]), valid=True)))
        wal.close()
        runs.append((effects, path.read_bytes(), again.locked_value, again.locked_round))
    assert runs[0] == runs[1]
    assert runs[1][2:] == (BLOCK_A, 0)


# --- the chaos spec ---------------------------------------------------------

SPECS = [
    "seed=7,gossip_drop=0.3,gossip_dup=0.4,gossip_delay_ms=5,gossip_reorder=0.5",
    "seed=11,dispatch_fail=0.5,upload_fail=0.25,rpc_fail=0.3,mempool_drop=0.5",
    "seed=2,proof_fail=0.5,verify_fail=0.5,shard_fail=0.5,extend_shard_fail=0.5,"
    "wal_torn_tail=3,dispatch_fail_all=1,dispatch_fail=0.2",
    {"seed": 5, "gossip_drop": 1.0, "mempool_drop": 0.1, "rpc_fail": 1},
]


def chaos_decisions(pkg, spec) -> list:
    inj = pkg.chaos.install(spec)
    out = [sorted(inj.params.items()), inj.raw]
    try:
        for n in range(40):
            row = [pkg.chaos.gossip_send(), pkg.chaos.wal_torn_tail(),
                   pkg.chaos.mempool_insert(), pkg.chaos.mempool_insert(shard=n % 3)]
            for seam, args in (("device_dispatch", (("panel", "host")[n % 2],)),
                               ("device_upload", ()), ("rpc_handle", ()), ("proof_serve", ()),
                               ("proof_verify", ()), ("proof_shard", ()), ("extend_shard", ())):
                try:
                    getattr(pkg.chaos, seam)(*args)
                    row.append(None)
                except pkg.chaos.ChaosInjected as e:
                    row.append((e.seam, e.fault, str(e)))
            out.append(row)
    finally:
        pkg.chaos.uninstall()
    return out


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: str(s)[:24])
def test_chaos_spec_decisions_equal(spec):
    jax_run, port_run = (chaos_decisions(package(name), spec) for name in PACKAGES)
    assert jax_run == port_run
    assert any(x not in (None, {}, False) for row in port_run[2:] for x in row)


@pytest.mark.parametrize("spec", ["seed=1,gossip_dorp=0.1", "gossip_drop", "seed=x",
                                  {"dispatch_fial": 1}])
def test_chaos_spec_rejections_equal(spec):
    errors = []
    for name in PACKAGES:
        with pytest.raises(ValueError) as err:
            package(name).chaos.install(spec)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_chaos_env_spec_and_adversary(monkeypatch):
    """$CELESTIA_CHAOS is parsed per string change, as in JAX; the port's
    protocol adversary is not ported and says so."""
    from celestia_app_tpu_torch import chaos

    monkeypatch.setenv("CELESTIA_CHAOS", "seed=4,gossip_drop=1")
    assert chaos.gossip_send() == {"drop": True}
    assert chaos.active_adversary() is None
    monkeypatch.setenv("CELESTIA_CHAOS", "")
    assert chaos.injector() is None and chaos.gossip_send() == {}
    chaos.install("seed=1,withhold_frac=0.5")
    try:
        with pytest.raises(NotImplementedError, match="serve API"):
            chaos.active_adversary()
    finally:
        chaos.uninstall()
