"""Consensus: the vote wire types, vote sets, commits and equivocation
evidence that block execution (x/evidence) and the IBC light client read.

The port's copy of celestia_app_tpu/consensus/votes.py.  The JAX package
exports these lazily to keep its optional signing dependency off the import
path; the port signs in pure Python (crypto/keys.py), so it imports them
plainly.  The round machine and the WAL are not part of the port yet
(ROADMAP, queue 1).
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
