"""The port's ABCI proof querier and its C-bridge worker on the CPU.

Querier: `query_tx_inclusion_proof`, `query_share_inclusion_proof` and
`handle_query` with device="cpu" give the JAX package's proofs byte for
byte (through the JAX codec's canonical rendering), and they verify.
Worker: `python -m celestia_app_tpu_torch.bridge.worker` driven over pipes
with $CELESTIA_BRIDGE_DEVICE=cpu speaks the CSQ1 protocol of
bridge/celestia_square_bridge.cpp, its extend byte-equal to the JAX
ExtendedDataSquare.compute; without a card it answers status 1 and keeps
its stdout to protocol bytes.  C ABI: the bridge library built with cmake
into a temporary directory runs one BridgeClient round trip.  Every wait on
a worker is bounded by a time limit.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import select
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.proof import querier as jax_querier
from celestia_app_tpu.rpc.codec import to_jsonable
from celestia_app_tpu.serve.api import render
from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.proof import querier
from celestia_app_tpu_torch.shares import Blob, Namespace
from celestia_app_tpu_torch.square import construct
from celestia_app_tpu_torch.tx.envelopes import BlobTx


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


ROOT = Path(__file__).resolve().parent.parent
WORKER = [sys.executable, "-m", "celestia_app_tpu_torch.bridge.worker"]
REQ = struct.Struct("<IIIQ")
RESP = struct.Struct("<IIQ")
CSQ1, CSQR = 0x31515343, 0x52515343
TIMEOUT_S = 120


class StubApp:
    def max_effective_square_size(self) -> int:
        return 64


def block_txs() -> list[bytes]:
    """Six normal txs, then four BlobTxs (one with two blobs) under two
    namespaces: a k=8 square whose tx and PFB regions span rows."""
    rng = np.random.default_rng(21)
    namespaces = [Namespace.v0(rng.bytes(10)) for _ in range(2)]
    txs = [rng.bytes(int(n)) for n in (90, 400, 700, 1200, 60, 300)]
    for i, sizes in enumerate(([900], [3000, 200], [6000], [478 * 4])):
        blobs = tuple(Blob(namespaces[i % 2], rng.bytes(s)) for s in sizes)
        txs.append(BlobTx(rng.bytes(200), blobs).marshal())
    return txs


@pytest.fixture(scope="module")
def block():
    txs = block_txs()
    sq = construct(txs, 64)
    root = extend_shares(sq.share_bytes(), device="cpu").data_root()
    return txs, sq, root


def _same(proof, want) -> None:
    assert render(to_jsonable(proof)) == render(to_jsonable(want))


def test_tx_inclusion_proofs_equal_jax(block):
    txs, sq, root = block
    assert sq.size == 8
    for i in range(len(txs)):
        proof = querier.query_tx_inclusion_proof(txs, i, 64, device="cpu")
        _same(proof, jax_querier.query_tx_inclusion_proof(txs, i, 64))
        assert proof.verify(root)
    assert not proof.verify(bytes(32))


@pytest.mark.parametrize("start,end", [(0, 1), (3, 5), (6, 8), (8, 23), (23, 35)])
def test_share_inclusion_proofs_equal_jax(block, start, end):
    """One-namespace ranges inside one row and across rows (k=8: rows of 8
    shares): txs, PFBs, the first namespace's two blobs (rows 1-2), the
    second's three (rows 2-4)."""
    txs, _sq, root = block
    proof = querier.query_share_inclusion_proof(txs, start, end, 64, device="cpu")
    _same(proof, jax_querier.query_share_inclusion_proof(txs, start, end, 64))
    assert proof.verify(root)
    tampered = dataclasses.replace(proof, data=(bytes(SHARE_SIZE),) + proof.data[1:])
    assert not tampered.verify(root)


@pytest.mark.parametrize("path", [f"{querier.TX_INCLUSION_ROUTE}/7",
                                  f"{querier.SHARE_INCLUSION_ROUTE}/10/20"])
def test_handle_query_equals_jax(block, path):
    txs, _sq, root = block
    data = json.dumps({"txs": [t.hex() for t in txs]}).encode()
    proof = querier.handle_query(StubApp(), path, data, device="cpu")
    _same(proof, jax_querier.handle_query(StubApp(), path, data))
    assert proof.verify(root)


def test_share_range_across_namespaces_raises_like_jax(block):
    txs = block[0]
    with pytest.raises(ValueError, match="namespace"):
        jax_querier.query_share_inclusion_proof(txs, 9, 30, 64)
    with pytest.raises(ValueError, match="namespace"):
        querier.query_share_inclusion_proof(txs, 9, 30, 64, device="cpu")


def test_handle_query_rejects_unknown_route(block):
    data = json.dumps({"txs": [t.hex() for t in block[0]]}).encode()
    with pytest.raises(ValueError, match="unknown query path"):
        querier.handle_query(StubApp(), "custom/nope/1", data, device="cpu")


def test_querier_on_no_card_raises(block, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    txs = block[0]
    data = json.dumps({"txs": [t.hex() for t in txs]}).encode()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        querier.query_tx_inclusion_proof(txs, 0, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        querier.query_share_inclusion_proof(txs, 0, 2, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        querier.handle_query(StubApp(), f"{querier.TX_INCLUSION_ROUTE}/0", data)


# --- the worker over pipes --------------------------------------------------


class Worker:
    """One worker process; every read waits at most TIMEOUT_S."""

    def __init__(self, env: dict):
        self.stderr = tempfile.TemporaryFile()  # a file: a full pipe would block the worker
        self.proc = subprocess.Popen(WORKER, cwd=ROOT, env=env, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self.stderr, bufsize=0)
        self.stdout = b""  # every byte the worker wrote to stdout

    def send(self, raw: bytes) -> None:
        self.proc.stdin.write(raw)
        self.proc.stdin.flush()

    def _read(self, n: int) -> bytes:
        fd = self.proc.stdout.fileno()
        out = b""
        deadline = time.monotonic() + TIMEOUT_S
        while len(out) < n:
            ready, _, _ = select.select([fd], [], [], max(0.0, deadline - time.monotonic()))
            if not ready:
                raise TimeoutError(f"worker wrote {len(out)} of {n} bytes in {TIMEOUT_S} s")
            chunk = os.read(fd, n - len(out))
            if not chunk:
                raise EOFError(f"worker closed stdout after {len(out)} of {n} bytes")
            out += chunk
        self.stdout += out
        return out

    def request(self, op: int, k: int = 0, payload: bytes = b"") -> tuple[int, bytes]:
        self.send(REQ.pack(CSQ1, op, k, len(payload)) + payload)
        rmagic, status, n = RESP.unpack(self._read(RESP.size))
        assert rmagic == CSQR
        return status, self._read(n)

    def finish(self) -> tuple[int, bytes, str]:
        """Close stdin and wait: (exit code, the rest of stdout, stderr)."""
        self.proc.stdin.close()
        try:
            rc = self.proc.wait(timeout=TIMEOUT_S)
        finally:
            self.proc.kill()
        rest = self.proc.stdout.read()
        self.proc.stdout.close()
        self.stderr.seek(0)
        err = self.stderr.read().decode()
        self.stderr.close()
        return rc, rest, err


def _env(**values) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "CELESTIA_BRIDGE_DEVICE"}
    env.update(values)
    return env


@pytest.fixture(scope="module")
def cpu_worker():
    w = Worker(_env(CELESTIA_BRIDGE_DEVICE="cpu"))
    yield w
    if w.proc.poll() is None:
        w.request(4)
        w.finish()


def random_ods(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :29] = 0
    ods[:, 28] = np.sort(rng.integers(0, 200, k * k)).astype(np.uint8)
    return ods.reshape(k, k, SHARE_SIZE)


def test_worker_ping(cpu_worker):
    assert cpu_worker.request(2) == (0, b"")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_worker_extend_equals_jax(cpu_worker, k):
    ods = random_ods(k, seed=k)
    status, out = cpu_worker.request(1, k, ods.tobytes())
    assert status == 0
    want = JaxEDS.compute(ods)
    assert out == (np.asarray(want.squared()).tobytes() + b"".join(want.row_roots())
                   + b"".join(want.col_roots()) + want.data_root())


@pytest.mark.parametrize("k,payload", [(2, b"x" * 5), (2, bytes(4 * 4 * SHARE_SIZE)),
                                       (3, bytes(9 * SHARE_SIZE)), (0, b"")])
def test_worker_bad_extend_answers_status_1(cpu_worker, k, payload):
    """A payload that is not a k x k ODS, or k not a power of two: status 1,
    and the worker serves the next request."""
    assert cpu_worker.request(1, k, payload) == (1, b"")
    assert cpu_worker.request(2) == (0, b"")


def test_worker_unknown_op_answers_status_2(cpu_worker):
    assert cpu_worker.request(9, 0, b"abc") == (2, b"")
    assert cpu_worker.request(3, 2) == (0, b"")  # warmup at k=2


def test_worker_shutdown_exits_0_and_reports():
    w = Worker(_env(CELESTIA_BRIDGE_DEVICE="cpu"))
    assert w.request(1, 2, random_ods(2, 5).tobytes())[0] == 0
    assert w.request(4) == (0, b"")
    rc, rest, err = w.finish()
    assert (rc, rest) == (0, b"")
    line = next(x for x in err.splitlines() if x.startswith("bridge worker exit: "))
    report = json.loads(line.removeprefix("bridge worker exit: "))
    assert report["device"] == "cpu" and report["resolved"] is True
    assert set(report["launches"]) >= {"sha256", "sha256_leaf", "rs_dense"}


@pytest.mark.parametrize("raw", [
    REQ.pack(0xDEADBEEF, 2, 0, 0),         # bad magic
    REQ.pack(CSQ1, 2, 0, 0)[:11],          # truncated header
    REQ.pack(CSQ1, 1, 2, 2048) + b"abc",   # truncated payload
], ids=["bad-magic", "short-header", "short-payload"])
def test_worker_exits_1_on_a_malformed_request(raw):
    w = Worker(_env(CELESTIA_BRIDGE_DEVICE="cpu"))
    w.send(raw)
    rc, rest, err = w.finish()
    assert (rc, rest) == (1, b"")
    assert "bridge worker" in err


def test_worker_without_a_card_answers_status_1():
    """No $CELESTIA_BRIDGE_DEVICE (so CUDA) and no visible card: warmup and
    extend answer 1 with the cause on stderr, ping still answers, and
    stdout carries the protocol's bytes and nothing else."""
    w = Worker(_env(CUDA_VISIBLE_DEVICES=""))
    assert w.request(3, 2) == (1, b"")
    assert w.request(1, 2, random_ods(2, 1).tobytes()) == (1, b"")
    assert w.request(2) == (0, b"")
    assert w.request(4) == (0, b"")
    rc, rest, err = w.finish()
    assert (rc, rest) == (0, b"")
    assert w.stdout == b"".join(RESP.pack(CSQR, s, 0) for s in (1, 1, 0, 0))
    assert err.count("no CUDA device is available") == 2
    assert '"resolved": false' in err


def test_importing_the_worker_leaves_stdout_alone():
    code = ("import sys, celestia_app_tpu_torch.bridge.worker as w; "
            "assert sys.stdout is sys.__stdout__; print('still stdout')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=TIMEOUT_S, check=True)
    assert out.stdout == "still stdout\n"


# --- the C ABI ----------------------------------------------------------------

_CLIENT = """
import hashlib, json, sys
import numpy as np
from celestia_app_tpu_torch.bridge.client import BridgeClient
ods = np.load(sys.argv[2])
client = BridgeClient(sys.argv[1], warmup_ks=[4])
eds, rows, cols, root = client.extend_and_dah(ods)
ok = client.ping()
try:
    client.extend_and_dah(np.zeros((3, 3, 512), np.uint8))
    raised = None
except RuntimeError as e:
    raised = str(e)
client.shutdown()
print(json.dumps({"eds": hashlib.sha256(eds.tobytes()).hexdigest(), "rows": rows.tobytes().hex(),
                  "cols": cols.tobytes().hex(), "root": root.hex(), "ping": ok,
                  "raised": raised}))
"""


def test_c_abi_round_trip_equals_jax(tmp_path):
    build = tmp_path / "bridge"
    for cmd in (["cmake", "-S", str(ROOT / "bridge"), "-B", str(build)],
                ["cmake", "--build", str(build)]):
        subprocess.run(cmd, check=True, capture_output=True, timeout=TIMEOUT_S)
    ods = random_ods(4, seed=44)
    np.save(tmp_path / "ods.npy", ods)
    out = subprocess.run(
        [sys.executable, "-c", _CLIENT, str(build / "libcelestia_square_bridge.so"),
         str(tmp_path / "ods.npy")],
        cwd=ROOT, env=_env(CELESTIA_BRIDGE_DEVICE="cpu"), capture_output=True, text=True,
        timeout=TIMEOUT_S, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = JaxEDS.compute(ods)
    assert got["eds"] == hashlib.sha256(np.asarray(want.squared()).tobytes()).hexdigest()
    assert got["rows"] == b"".join(want.row_roots()).hex()
    assert got["cols"] == b"".join(want.col_roots()).hex()
    assert got["root"] == want.data_root().hex()
    assert got["ping"] is True
    assert got["raised"] is not None and "fall back" not in got["raised"]
    assert "invalid square size 3" in out.stderr
