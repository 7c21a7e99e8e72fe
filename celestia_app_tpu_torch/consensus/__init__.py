"""Consensus: Tendermint round machine, vote wire types, WAL.

  votes.py    the vote wire types, vote sets, commits and equivocation
              evidence that block execution (x/evidence) and the IBC light
              client read;
  machine.py  the pure round machine (propose / prevote / precommit,
              locks, round changes) that rpc/gossip.py drives;
  wal.py      the vote WAL: record-then-sign double-sign protection and
              lock recovery across restarts.

The port's copy of celestia_app_tpu/consensus/.  The JAX package exports
the vote types lazily to keep its optional signing dependency off the
import path; the port signs in pure Python (crypto/keys.py), so it imports
them plainly.  The machine and the WAL are reached as submodules, as in
the JAX package.
"""

from celestia_app_tpu_torch.consensus.votes import (
    PRECOMMIT,
    PREVOTE,
    Commit,
    ConsensusError,
    Vote,
    VoteSet,
    block_id,
    verify_commit,
)

__all__ = [
    "Commit",
    "ConsensusError",
    "PRECOMMIT",
    "PREVOTE",
    "Vote",
    "VoteSet",
    "block_id",
    "verify_commit",
]
