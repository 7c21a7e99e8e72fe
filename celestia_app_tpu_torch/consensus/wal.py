"""Consensus write-ahead log: double-sign protection across restarts.

celestia-core persists a WAL and replays it on boot so a restarted
validator never signs twice for the same (height, round, step) — the
fault x/slashing tombstones for.  This is
the minimal safety core of that mechanism:

  * every OWN vote is journaled (fsync) BEFORE it is broadcast; signing
    a conflicting vote for coordinates already in the journal is refused
    — even after a crash+restart wiped the in-memory machine;
  * polka locks are journaled too, so a restarted validator resumes
    locked on what it locked on (the cross-round safety input) instead
    of prevoting fresh values.

The journal is line-JSON, append-only, pruned by rewriting once the
height moves far past (prune()).  It deliberately does NOT replay the
full message stream (celestia-core's WAL also recovers liveness state);
crash recovery here re-joins via catch-up, which this framework already
does — the WAL only has to prevent equivocation.

The port's copy of celestia_app_tpu/consensus/wal.py, whole: the same
may_sign / record_lock / prune sequence writes the same bytes, and a torn
tail salvages the same bytes (tests/test_torch_consensus.py).
"""

from __future__ import annotations

import json
import os
import time


class VoteWAL:
    def __init__(self, path: str):
        self.path = path
        # (height, round, vote_type) -> block_hash hex
        self.votes: dict[tuple[int, int, int], str] = {}
        # height -> (locked_round, locked_value hex)
        self.locks: dict[int, tuple[int, str]] = {}
        # Cumulative append+fsync wall time: the round journal reads the
        # delta per round (consensus/machine.RoundJournal.fsync_ms_source).
        self.fsync_ms_total = 0.0
        # Torn-tail bookkeeping: bytes dropped by the replay salvage, and
        # whether an INJECTED torn tail (chaos wal.append seam) currently
        # sits past _offset on disk awaiting the next append's self-heal.
        self.salvaged_bytes = 0
        self._torn = False
        self._load()
        self._fh = open(path, "a", buffering=1)
        self._offset = self._fh.tell()  # end of the last complete record

    def _load(self) -> None:
        """Replay the journal, salvaging a torn tail.

        A crash mid-append leaves a partial final record (often without
        its newline).  Replay keeps every COMPLETE fsync'd record and
        truncates the torn bytes away — without the truncate, the append
        handle would write the next record onto the tail of the fragment
        and corrupt BOTH (the record a later restart then fails to
        replay is exactly the one double-sign protection needed).
        Mid-file garbage (a corrupted but newline-terminated line) is
        skipped, never truncated: records after it are still valid.

        The torn record itself is safely LOST, not violated: its vote was
        never broadcast (may_sign records durably BEFORE the caller
        signs), so forgetting it can at worst re-sign the same
        coordinates later — the idempotent case, never an equivocation.
        """
        if not os.path.exists(self.path):
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            return
        with open(self.path, "rb") as f:
            data = f.read()
        pos = 0
        good = 0  # offset just past the last complete (newline'd) line
        # Split strictly on b"\n" — the only terminator _append writes.
        # bytes.splitlines() also splits on bare \r, which would make
        # mid-file garbage CONTAINING a carriage return look like a torn
        # tail and truncate every later (valid, durably fsync'd) record:
        # exactly the double-sign window this journal exists to close.
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl == -1:
                break  # torn tail: no terminator — everything past `good` goes
            line = data[pos:nl]
            pos = nl + 1
            stripped = line.strip()
            if not stripped:
                good = pos
                continue
            try:
                rec = json.loads(stripped)
                if rec.get("k") == "vote":
                    self.votes[(rec["h"], rec["r"], rec["t"])] = rec["b"]
                elif rec.get("k") == "lock":
                    self.locks[rec["h"]] = (rec["r"], rec["b"])
            except (json.JSONDecodeError, KeyError, TypeError,
                    AttributeError):
                # Mid-file garbage: skip the record, keep walking.  The
                # broad net matters — `123` or `null` parse fine and then
                # fail attribute/key access, and a replay that CRASHES on
                # corruption is the failure mode this path exists to
                # survive.
                continue
            good = pos
        if good < len(data):
            self.salvaged_bytes = len(data) - good
            os.truncate(self.path, good)
            self._note_salvage("replay", self.salvaged_bytes)

    @staticmethod
    def _note_salvage(where: str, dropped: int) -> None:
        from celestia_app_tpu_torch.chaos.degrade import recoveries
        from celestia_app_tpu_torch.trace.flight_recorder import note_trigger
        from celestia_app_tpu_torch.trace.tracer import traced

        recoveries().inc(seam="wal.append", outcome="salvaged")
        traced().write("wal_salvage", where=where, dropped_bytes=dropped)
        # A salvage means a crash tore the double-sign guard's journal:
        # snapshot the surrounding state while it still exists
        # (note_trigger rate-limits per trigger and never raises).
        note_trigger("wal_salvage", where=where, dropped_bytes=dropped)

    def _append(self, rec: dict) -> None:
        from celestia_app_tpu_torch import chaos

        if self._torn:
            # A prior injected torn tail sits past _offset: heal exactly
            # the way a restart would, by truncating to the last complete
            # record before writing anything new.
            self._fh.truncate(self._offset)
            self._torn = False
            self._note_salvage("append", 0)
        t0 = time.perf_counter()
        self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._offset = self._fh.tell()
        elapsed = time.perf_counter() - t0
        self.fsync_ms_total += elapsed * 1e3
        frag = chaos.wal_torn_tail()
        if frag is not None:
            # The chaos seam: durably tear the tail (a crash mid-write of
            # the NEXT record) so replay/self-heal have something real to
            # salvage.  _offset deliberately not advanced.
            self._fh.write(frag.decode())
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._torn = True
        # The fsync sits on the vote-signing path: its latency is a direct
        # input to round time, so it gets its own histogram.
        from celestia_app_tpu_torch.trace.metrics import DEVICE_SECONDS_BUCKETS, registry

        registry().histogram(
            "celestia_wal_fsync_seconds",
            "consensus WAL append+fsync wall time",
            buckets=DEVICE_SECONDS_BUCKETS,
        ).observe(elapsed)

    # --- the sign guard -----------------------------------------------------
    def may_sign(self, height: int, round: int, vote_type: int,
                 block_hash: bytes) -> bool:
        """True iff signing this vote cannot be an equivocation.  Records
        the vote (durably) when allowed — record-then-sign ordering, so a
        crash between the two can at worst lose a vote, never double
        one."""
        key = (height, round, vote_type)
        prior = self.votes.get(key)
        if prior is not None:
            return prior == block_hash.hex()  # idempotent re-sign is fine
        self.votes[key] = block_hash.hex()
        self._append({
            "k": "vote", "h": height, "r": round, "t": vote_type,
            "b": block_hash.hex(),
        })
        return True

    # --- lock persistence ---------------------------------------------------
    def record_lock(self, height: int, round: int, value: bytes) -> None:
        self.locks[height] = (round, value.hex())
        self._append({"k": "lock", "h": height, "r": round, "b": value.hex()})

    def lock_for(self, height: int) -> tuple[int, bytes] | None:
        got = self.locks.get(height)
        if got is None:
            return None
        return got[0], bytes.fromhex(got[1])

    # --- maintenance --------------------------------------------------------
    def prune(self, below_height: int) -> bool:
        """Drop records for long-committed heights (rewrite in place).

        Best-effort: a failed rewrite (disk full, EIO) leaves the on-disk
        journal with its pre-prune content — superset of the in-memory
        state, so double-sign protection is intact — and returns False.
        The append handle is reopened in a finally either way: a failed
        prune must never crash may_sign()/record_lock() on a running
        validator, which is the vote-signing path.
        """
        self.votes = {k: v for k, v in self.votes.items() if k[0] >= below_height}
        self.locks = {h: v for h, v in self.locks.items() if h >= below_height}
        if self._torn:
            # Heal an injected torn tail before the handle swap: a failed
            # rewrite keeps the ORIGINAL file, whose offset bookkeeping
            # must stay truthful for the next append.
            self._fh.truncate(self._offset)
            self._torn = False
        self._fh.close()
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                for (h, r, t), b in sorted(self.votes.items()):
                    f.write(json.dumps(
                        {"k": "vote", "h": h, "r": r, "t": t, "b": b},
                        separators=(",", ":"),
                    ) + "\n")
                for h, (r, b) in sorted(self.locks.items()):
                    f.write(json.dumps(
                        {"k": "lock", "h": h, "r": r, "b": b},
                        separators=(",", ":"),
                    ) + "\n")
                # The retained records still guard against double-signing:
                # fsync BEFORE the rename (and the directory after), or a
                # crash can persist the rename with an empty file and lose
                # exactly the durability the journal exists for.
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            try:
                dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
                os.fsync(dfd)
                os.close(dfd)
            except OSError:
                pass  # directory fsync is best-effort on odd filesystems
        except OSError:
            return False
        finally:
            self._fh = open(self.path, "a", buffering=1)
        return True

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass
