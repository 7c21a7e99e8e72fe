"""The fault-survival counter of the chaos plane.

A partial copy of celestia_app_tpu/chaos/degrade.py: only `recoveries()`,
the one registration every seam's recovery accounting goes through (the WAL
salvage in consensus/wal.py and the gossip resend in rpc/transport.py).  The
device-path circuit breaker, the degradation ladder and `degraded_state`
come with the fault plane (ROADMAP, queue 1).
"""

from __future__ import annotations


def recoveries():
    """The shared fault-survival counter — the ONE registration every
    seam's recovery accounting (ladder, WAL salvage, gossip resend) goes
    through, so the name and help text cannot fork."""
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_recoveries_total",
        "faults survived, by seam and how (retried / degraded / salvaged "
        "/ resent / gave_up)",
    )
