"""txsim: the deterministic load generator.

Parity with reference test/txsim (run.go:37-124, blob.go, send.go):
composable sequences submit txs through a TxClient against a node; a master
seed makes the whole load pattern reproducible.  Each sequence owns one
account (the reference's AccountManager funds subaccounts; here keys map to
genesis accounts from the harness).

The port's copy of celestia_app_tpu/txsim/run.py: the same seed gives the
same submissions, blocks and app hashes.  One deliberate difference: the
JAX `run` counts any exception of a submission as a failed submission; the
port's lets a `device.DeviceFault` propagate, since a fault of the card is
no verdict on the tx.
"""

from __future__ import annotations

import numpy as np

from celestia_app_tpu_torch.device import DeviceFault
from celestia_app_tpu_torch.shares.namespace import Namespace
from celestia_app_tpu_torch.shares.sparse import Blob
from celestia_app_tpu_torch.tx.messages import Coin, MsgSend
from celestia_app_tpu_torch.user import TxClient


class BlobSequence:
    """Submits PFBs with random namespaces/sizes (test/txsim/blob.go)."""

    def __init__(
        self,
        blobs_per_pfb: tuple[int, int] = (1, 3),
        blob_size: tuple[int, int] = (100, 10_000),
    ):
        self.blobs_per_pfb = blobs_per_pfb
        self.blob_size = blob_size
        self.address: str | None = None

    def next(self, rng: np.random.Generator, client: TxClient):
        count = int(rng.integers(self.blobs_per_pfb[0], self.blobs_per_pfb[1] + 1))
        blobs = []
        for _ in range(count):
            ns = Namespace.v0(rng.integers(1, 256, 10, dtype=np.uint8).tobytes())
            size = int(rng.integers(self.blob_size[0], self.blob_size[1] + 1))
            blobs.append(Blob(ns, rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
        # Namespaces within one PFB must be sorted for deterministic blob order.
        blobs.sort(key=lambda b: b.namespace.to_bytes())
        return ("pfb", blobs)


class SendSequence:
    """Round-robin MsgSends between the client's accounts (send.go)."""

    def __init__(self, amount: tuple[int, int] = (1, 1000)):
        self.amount = amount
        self.address: str | None = None

    def next(self, rng: np.random.Generator, client: TxClient):
        addrs = client.signer.addresses()
        to = addrs[int(rng.integers(0, len(addrs)))]
        amount = int(rng.integers(self.amount[0], self.amount[1] + 1))
        return ("send", to, amount)


class StakeSequence:
    """Delegate once, continuously claim rewards, and occasionally
    redelegate to a random other validator (test/txsim/stake.go: 1-in-10
    redelegation, MsgWithdrawDelegatorReward otherwise)."""

    def __init__(self, initial_stake: int = 1_000_000, validators: list[str] | None = None):
        self.initial_stake = initial_stake
        self.validators = validators  # None = query the node each round
        self.delegated_to: str | None = None
        self.address: str | None = None

    def _validator_addrs(self, node) -> list[str]:
        # node-agnostic: TestNode and RemoteNode both expose validators().
        return self.validators or [v["address"] for v in node.validators()]

    def next(self, rng: np.random.Generator, client: TxClient):
        if self.delegated_to is None:
            return ("delegate", None)
        if int(rng.integers(0, 10)) == 0:
            return ("redelegate", None)
        return ("claim", None)


def run(
    node, keys, sequences, blocks: int, seed: int = 42,
    use_feegrant: bool = False,
) -> dict:
    """Drive `sequences` for `blocks` blocks; returns submission stats.

    `use_feegrant` mirrors the reference AccountManager: the master (first)
    account grants every other account a fee allowance up front and then
    pays all their fees (test/txsim/account.go:238-239,318-330)."""
    rng = np.random.default_rng(seed)
    client = TxClient(node, keys)
    addrs = client.signer.addresses()
    if use_feegrant and len(addrs) > 1:
        from celestia_app_tpu_torch.tx.messages import MsgGrantAllowance

        master = addrs[0]
        grants = [MsgGrantAllowance(master, a) for a in addrs[1:]]
        client.submit_tx(grants, master, gas=200_000)  # confirms inclusion
        client.fee_granter = master
    for i, seq in enumerate(sequences):
        seq.address = addrs[i % len(addrs)]

    stats = {"submitted": 0, "failed": 0, "blocks": 0}
    for _ in range(blocks):
        for seq in sequences:
            op = seq.next(rng, client)
            try:
                if op[0] == "pfb":
                    with client._lock:
                        client._broadcast_pfb(op[1], seq.address)
                elif op[0] == "send":
                    _, to, amount = op
                    msg = MsgSend(seq.address, to, (Coin("utia", amount),))
                    with client._lock:
                        client._broadcast_msgs([msg], seq.address, gas=200_000)
                elif op[0] in ("delegate", "redelegate"):
                    from celestia_app_tpu_torch.tx.messages import (
                        MsgBeginRedelegate,
                        MsgDelegate,
                    )

                    vals = seq._validator_addrs(node)
                    if op[0] == "delegate":
                        target = vals[int(rng.integers(0, len(vals)))]
                        msg = MsgDelegate(
                            seq.address, target, Coin("utia", seq.initial_stake)
                        )
                    else:
                        others = [v for v in vals if v != seq.delegated_to]
                        if not others:
                            continue  # solo validator: nothing to redelegate to
                        target = others[int(rng.integers(0, len(others)))]
                        msg = MsgBeginRedelegate(
                            seq.address, seq.delegated_to,
                            Coin("utia", seq.initial_stake), target,
                        )
                    with client._lock:
                        client._broadcast_msgs([msg], seq.address, gas=200_000)
                    # Track only AFTER the broadcast succeeded: a rejected
                    # submission must not desync the sequence from chain
                    # state (it retries the same step next round).
                    seq.delegated_to = target
                elif op[0] == "claim":
                    from celestia_app_tpu_torch.tx.messages import (
                        MsgWithdrawDelegatorReward,
                    )

                    msg = MsgWithdrawDelegatorReward(seq.address, seq.delegated_to)
                    with client._lock:
                        client._broadcast_msgs([msg], seq.address, gas=200_000)
                else:
                    continue  # noop round
                stats["submitted"] += 1
            except DeviceFault:
                raise
            except Exception:
                stats["failed"] += 1
        node.produce_block()
        stats["blocks"] += 1
    return stats
