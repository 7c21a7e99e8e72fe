"""Consensus round journal: one `round_journal` row per (height, round).

The RoundMachine (consensus/machine.py) stays pure — no sockets, no
clocks; it only tells this journal WHEN things happen (round open, step
transition, timeout fire, close).  The journal owns the clock (injectable
for deterministic tests) and writes the trace row on round close with:

  * the proposer and wall-clock step deltas (propose -> prevote ->
    precommit -> close);
  * prevote/precommit power fractions for the round that closed (or, on
    a decide, the round whose tally decided);
  * which step timeouts fired;
  * the WAL append+fsync time the round paid (`fsync_ms_source` reads
    consensus/wal.VoteWAL.fsync_ms_total, the delta is per round);
  * the block's trace_id when the driver knows it (proposer side:
    adopted from the first reaped tx — rpc/gossip.py).

This module lives under trace/ (not consensus/) so it imports without
the signing stack: it duck-types the machine and pins the two vote-type
ints locally.

The port's copy of celestia_app_tpu/trace/round_journal.py, whole: the
same events under the same clock give the same rows
(tests/test_torch_consensus.py).
"""

from __future__ import annotations

# Pinned to consensus.votes.PREVOTE/PRECOMMIT — importing them would pull
# the signing stack into slim images where this journal must still load.
PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2

# Step names, pinned to consensus.machine.PROPOSE/PREVOTE_STEP/PRECOMMIT_STEP.
PROPOSE_STEP_NAME = "propose"
PREVOTE_STEP_NAME = "prevote"
PRECOMMIT_STEP_NAME = "precommit"


class RoundJournal:
    TABLE = "round_journal"

    def __init__(self, clock=None, fsync_ms_source=None):
        import time as _time

        self.clock = clock or _time.monotonic
        self.fsync_ms_source = fsync_ms_source
        self.trace_id: str | None = None
        self._row: dict | None = None

    def _fsync_ms(self) -> float:
        return float(self.fsync_ms_source()) if self.fsync_ms_source else 0.0

    def open_round(self, machine) -> None:
        # trace_id is per round: the driver re-stamps it when THIS node's
        # proposal is the one in play (rpc/gossip._propose_locked runs
        # after the round opens); without the reset, rounds proposed by
        # other validators would inherit a stale trace.
        self.trace_id = None
        self._row = {
            "height": machine.height,
            "round": machine.round,
            "proposer": machine.proposer(machine.round),
            "t0": self.clock(),
            "steps": {PROPOSE_STEP_NAME: 0.0},
            "timeouts": [],
            "fsync0": self._fsync_ms(),
        }

    def record_step(self, machine, step: str) -> None:
        row = self._row
        if row is None or machine.round != row["round"]:
            return
        row["steps"].setdefault(step, (self.clock() - row["t0"]) * 1e3)

    def record_timeout(self, machine, round: int, step: str) -> None:
        from celestia_app_tpu_torch.trace.metrics import registry

        registry().counter(
            "celestia_consensus_timeouts_total",
            "consensus step timeouts that fired and acted",
        ).inc(step=step)
        row = self._row
        if row is not None and round == row["round"]:
            row["timeouts"].append(step)

    def close_round(self, machine, reason: str, round: int | None = None) -> None:
        """Write the (height, round) row; `reason` is decided|round_bump.
        For a decide in an EARLIER round than the open one, `round` names
        the round whose tallies decided."""
        from celestia_app_tpu_torch.trace.metrics import registry
        from celestia_app_tpu_torch.trace.tracer import traced

        row, self._row = self._row, None
        if row is None:
            return
        tally_round = row["round"] if round is None else round
        total_ms = (self.clock() - row["t0"]) * 1e3
        steps = row["steps"]
        prevote_at = steps.get(PREVOTE_STEP_NAME)
        precommit_at = steps.get(PRECOMMIT_STEP_NAME)
        prevotes = machine._tally(machine.prevotes, tally_round, PREVOTE_TYPE)
        precommits = machine._tally(
            machine.precommits, tally_round, PRECOMMIT_TYPE
        )
        total_power = prevotes.total_power() or 1
        traced().write(
            self.TABLE,
            height=row["height"],
            round=row["round"],
            proposer=row["proposer"],
            result=reason,
            trace_id=self.trace_id,
            propose_ms=prevote_at,
            prevote_ms=(
                precommit_at - prevote_at
                if prevote_at is not None and precommit_at is not None
                else None
            ),
            precommit_ms=(
                total_ms - precommit_at if precommit_at is not None else None
            ),
            total_ms=total_ms,
            timeouts=row["timeouts"],
            prevote_power=prevotes.power_any() / total_power,
            precommit_power=precommits.power_any() / total_power,
            wal_fsync_ms=self._fsync_ms() - row["fsync0"],
        )
        registry().histogram(
            "celestia_consensus_round_seconds",
            "consensus round wall time by outcome",
        ).observe(total_ms / 1e3, result=reason)
