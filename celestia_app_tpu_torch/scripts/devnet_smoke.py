"""Devnet smoke: the full consensus story in one run.

Spawns a 4-validator gossip devnet (multi-process, real sockets), submits
a PayForBlobs through the tx client to a non-proposer, SIGKILLs a
validator and requires the chain to keep committing (the dead node's
proposer heights commit in round >= 1), then light-client-verifies a
fetched Commit record — +2/3 precommit signatures over a block id that
binds the data root, the previous app hash, AND the attested block time.

Run:  python -m celestia_app_tpu_torch.scripts.devnet_smoke [--device cpu]

The port's copy of scripts/devnet_smoke.py, over the port's
rpc/devnet.spawn_devnet: the validators run on `--device` (default CUDA,
which raises without a card; the parent builds the kernels once before it
spawns), their ports are free ones picked at spawn where the JAX script
fixes 27410, and each child's output goes to a log under `--log-dir`.  The
script's checks are functions (`validator_set`, `check_commit`,
`check_post_kill`) so that they can run against a Commit built in process;
`main` returns 0 when every check holds and raises AssertionError when one
fails.
"""

from __future__ import annotations

import argparse
import signal

from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.scripts.common import add_device_argument


def validator_set(n: int) -> dict:
    """{address: (public key, power 100)} of the devnet's n validators
    (testutil.testnode.deterministic_genesis: seeds validator-<i>)."""
    from celestia_app_tpu_torch.crypto.keys import PrivateKey

    vals = {}
    for i in range(n):
        key = PrivateKey.from_seed(f"validator-{i}".encode())
        vals[key.public_key().address()] = (key.public_key(), 100)
    return vals


def check_commit(node, chain_id: str, height: int, vals: dict):
    """Light-client-verify the Commit record `node` (anything with
    `commit(height)`, a RemoteNode) returns for `height`: +2/3 of `vals`'s
    power in precommit signatures over a block id that binds the data
    root, the previous app hash and the block time.  Returns the record."""
    from celestia_app_tpu_torch.consensus import block_id, verify_commit

    rec = node.commit(height)
    assert rec is not None, "no commit record"
    ok = verify_commit(vals, chain_id, rec)
    print(f"commit@{height}: round={rec.round} time_ns={rec.time_ns} verify={ok}",
          flush=True)
    assert ok and rec.time_ns > 0
    assert rec.block_hash == block_id(rec.data_root, rec.prev_app_hash, rec.time_ns)
    return rec


def check_post_kill(node, vals: dict, dead: str, first: int, last: int) -> tuple:
    """Every Commit record of heights first..last must lack the dead
    validator's precommit, and each height whose round-0 proposer is the
    dead validator (rotation: sorted addresses shifted by height - 1) must
    have committed in a later round.  Returns (rounds seen, dead-proposer
    heights); at least one such height must be in the window."""
    rounds = set()
    dead_proposer_heights = []
    order = sorted(vals)
    for hh in range(first, last + 1):
        r = node.commit(hh)
        assert r is not None, f"node lost the commit record for {hh}"
        rounds.add(r.round)
        assert all(v.validator != dead for v in r.precommits), hh
        if order[(hh - 1) % len(order)] == dead:
            dead_proposer_heights.append(hh)
            assert r.round >= 1, (
                f"height {hh} had the dead round-0 proposer but "
                f"committed in round {r.round}"
            )
    assert dead_proposer_heights, "window missed every dead-proposer height"
    return sorted(rounds), dead_proposer_heights


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4, help="validators (default 4)")
    ap.add_argument("--log-dir", default=None,
                    help="each validator's log goes here (default: a fresh "
                         "temporary directory)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    import os

    from celestia_app_tpu_torch.crypto.keys import PrivateKey
    from celestia_app_tpu_torch.rpc.client import RemoteNode
    from celestia_app_tpu_torch.rpc.devnet import spawn_devnet
    from celestia_app_tpu_torch.shares import Blob
    from celestia_app_tpu_torch.shares.namespace import Namespace
    from celestia_app_tpu_torch.user.tx_client import TxClient

    net = spawn_devnet(n=args.n, block_interval_ms=150, mode="gossip",
                       env=dict(os.environ), wait_s=240, device=str(device),
                       log_dir=args.log_dir)
    try:
        c = RemoteNode(net.urls[2], defer_status=True)
        c.wait_for_height(2, timeout_s=180)
        print("devnet live, height", c.status()["height"], flush=True)

        key = PrivateKey.from_seed(b"account-0")
        client = TxClient(c, [key])
        ns = Namespace.v0(b"verifyns--")
        res = client.submit_pay_for_blob([Blob(ns, b"devnet end-to-end blob")])
        print("PFB committed: code", res.code, "height", res.height, flush=True)
        assert res.code == 0

        h0 = c.status()["height"]
        net.procs[0].send_signal(signal.SIGKILL)
        net.procs[0].wait(timeout=10)
        # +6 so the checked window [h0+2, h] spans >= 4 heights — with 4
        # validators that guarantees at least one height whose round-0
        # proposer is the dead node.
        c.wait_for_height(h0 + 6, timeout_s=150)
        print("survived proposer kill:", c.status()["height"], ">=", h0 + 6, flush=True)

        vals = validator_set(args.n)
        h = c.status()["height"] - 1
        check_commit(c, c.chain_id, h, vals)
        dead = PrivateKey.from_seed(b"validator-0").public_key().address()
        # Start at h0+2: consensus for h0+1 was in flight when the SIGKILL
        # landed, so a precommit the dead node broadcast moments earlier can
        # legitimately appear in that height's record.
        rounds, dead_heights = check_post_kill(c, vals, dead, h0 + 2, h)
        print("post-kill commit rounds seen:", rounds,
              "dead-proposer heights:", dead_heights, flush=True)
        print("VERIFY OK", flush=True)
    finally:
        net.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
