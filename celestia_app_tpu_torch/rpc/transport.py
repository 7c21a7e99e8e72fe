"""Crypto-free gossip transport: chaotic delivery + flood dedup identity.

The pieces of the gossip plane that do NOT need the signing stack live
here, so a slim image (and scripts/chaos_soak.py's gossip drill) can
exercise the lossy-link machinery without `cryptography`:

  * `deliver` — one peer send through the chaos `gossip.send` seam
    (injected drop / duplicate / reorder-delay) with bounded
    exponential-backoff retry, gated per peer: only a peer whose LAST
    send succeeded earns retries.  Retrying a dead or blackholed link
    would multiply its timeout cost on every message — a liveness
    regression exactly when the mesh most needs to move on — so a peer
    mid-failure-streak gets the classic single attempt.
  * `msg_id` — the flood-termination dedup key (rpc/gossip.ConsensusDriver
    delegates here).  The proposal PAYLOAD is part of the identity: the
    proposal signature does not cover the block bytes (the signed block
    id does, indirectly), so without it a tampered relay copy would
    dedup-block the genuine message mesh-wide and censor an honest
    proposal.

The port's copy of celestia_app_tpu/rpc/transport.py, whole: the same
messages have the same ids, so port and JAX validators dedup each other's
gossip on one wire.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time


def msg_id(msg: dict) -> tuple:
    if msg.get("kind") == "vote":
        return ("vote", msg.get("vote", ""))
    payload = hashlib.sha256(
        json.dumps(
            [msg.get("block"), msg.get("last_commit"), msg.get("evidence")],
            sort_keys=True, separators=(",", ":"), default=str,
        ).encode()
    ).hexdigest()
    return (
        "proposal", msg.get("height"), msg.get("round"),
        msg.get("proposer"), msg.get("block_hash"), payload,
    )


def _recoveries():
    from celestia_app_tpu_torch.chaos.degrade import recoveries

    return recoveries()


# Injected-reorder deliveries in flight (Timer threads): tests and the
# chaos drills join them before asserting convergence.
_DELAYED_LOCK = threading.Lock()
_DELAYED: list[threading.Timer] = []


def drain_delayed(timeout_s: float = 5.0) -> None:
    """Wait out in-flight reorder-delayed deliveries (drills/shutdown)."""
    with _DELAYED_LOCK:
        timers = list(_DELAYED)
    for t in timers:
        t.join(timeout_s)
    with _DELAYED_LOCK:
        _DELAYED[:] = [t for t in _DELAYED if t.is_alive()]


def deliver(send, msg: dict, *, streak: dict, key, retries: int = 2,
            sleep=time.sleep) -> bool:
    """Send one message through the chaos seam with retry; True when it
    was delivered at least once (or handed to the chaos machinery).

    `send(msg)` performs the transport call; `streak[key]` counts the
    peer's consecutive failed sends (shared across calls so the retry
    gate sees history).  Injected DROPS return True without sending —
    they model loss PAST the send, which the receiver-side machinery
    (dedup, round timeouts, catch-up) must absorb; the sender cannot
    know, so it must not react.  An injected reorder-DELAY hands the
    delivery to a timer thread and returns immediately, so messages sent
    after it genuinely OVERTAKE it on the wire (an inline sleep would
    delay every successor equally — latency, not reordering).

    Cross-node propagation: the active trace context rides as a `trace`
    field on the envelope (`<trace_id>-<span_id>`, the x-celestia-trace
    grammar) so the receiving driver ADOPTS the trace.  Safe to attach:
    `msg_id` identity ignores top-level keys it does not name, and vote
    signatures cover msg["vote"] alone — the stamp cannot dedup-split or
    invalidate a relayed message.
    """
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.trace.context import serialize_context

    wire_ctx = serialize_context()
    if wire_ctx is not None and "trace" not in msg:
        msg = {**msg, "trace": wire_ctx}

    acts = chaos.gossip_send()
    if acts.get("drop"):
        return True
    deliveries = 2 if acts.get("dup") else 1

    def _attempt_all() -> bool:
        ok = False
        for _ in range(deliveries):
            prior = streak.get(key, 0)
            budget = retries if prior == 0 else 0
            for attempt in range(budget + 1):
                try:
                    send(msg)
                except Exception:  # chaos-ok: unreachable peer — flood routes around
                    if attempt == budget:
                        streak[key] = streak.get(key, 0) + 1
                        _recoveries().inc(
                            seam="gossip.send", outcome="gave_up"
                        )
                        break
                    sleep(0.02 * (2 ** attempt))
                else:
                    streak.pop(key, None)
                    if attempt:
                        _recoveries().inc(
                            seam="gossip.send", outcome="resent"
                        )
                    ok = True
                    break
        return ok

    if acts.get("delay_s"):
        timer = threading.Timer(acts["delay_s"], _attempt_all)
        timer.daemon = True
        with _DELAYED_LOCK:
            _DELAYED[:] = [t for t in _DELAYED if t.is_alive()]
            _DELAYED.append(timer)
        timer.start()
        return True
    return _attempt_all()
