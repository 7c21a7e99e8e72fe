"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests skip without an NVIDIA card;
`python3 chip_smoke.py` runs the same comparisons at the main path's full
shapes.  On a card: `python -m pytest tests/test_torch_cuda.py -m cuda`.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from celestia_app_tpu_torch.convert import codec_tensors
from celestia_app_tpu_torch.gf.rs import RSCodec
from celestia_app_tpu_torch.kernels import _build, rs_dense, rs_xor
from celestia_app_tpu_torch.kernels import sha256 as sha
from celestia_app_tpu_torch.kernels.rs import _encode_with

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py runs these comparisons on the card)")
    return torch.device("cuda")


def _bytes(rng, *shape):
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("length", [0, 1, 55, 56, 64, 65, 91, 181, 542])
def test_sha256_kernel_equals_plain(cuda, length):
    rng = np.random.default_rng(length)
    for n in (1, 127, 128, 129, 4097):
        msgs = _bytes(rng, n, length)
        before = _build.LAUNCHES["sha256"]
        got = sha.sha256(msgs.to(cuda)).cpu()
        assert _build.LAUNCHES["sha256"] == before + 1
        assert torch.equal(got, sha.sha256_plain(msgs))
        assert got[0].numpy().tobytes() == hashlib.sha256(msgs[0].numpy().tobytes()).digest()


def test_leaf_kernel_equals_plain(cuda):
    rng = np.random.default_rng(1)
    for n in (1, 100, 128, 1000):
        ns, shares = _bytes(rng, n, 29), _bytes(rng, n, 512)
        got = sha.sha256_leaves(ns.to(cuda), shares.to(cuda)).cpu()
        assert torch.equal(got, sha.sha256_leaves_plain(ns, shares))


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [1, 2, 4, 16, 128, 256, 512])
def test_rs_kernels_equal_plain(cuda, k, construction):
    rng = np.random.default_rng(k)
    codec = RSCodec(k, construction)
    m = codec.field.m
    on_card = codec_tensors(codec.generator_bits(), m, cuda)
    on_cpu = codec_tensors(codec.generator_bits(), m, "cpu")
    for axis, shape in ((1, (k, k, 512)), (0, (k, 2 * k, 512)), (1, (3, k, 40))):
        data = _bytes(rng, *shape)
        want = _encode_with(rs_dense.mod2_matmul_planes_plain, data, on_cpu["G_bits"], m, axis)
        dense = _encode_with(rs_dense.mod2_matmul_planes, data.to(cuda), on_card["G_bits"],
                             m, axis)
        xor = _encode_with(rs_xor.mod2_matmul_planes_xor, data.to(cuda), on_card["G_words"],
                           m, axis)
        assert torch.equal(dense.cpu(), want), (k, construction, axis)
        assert torch.equal(xor.cpu(), want), (k, construction, axis)


@pytest.mark.parametrize("cols", [1, 120, 257, 1000])
@pytest.mark.parametrize("Pm,nm,m", [(24, 40, 8), (32, 48, 16), (136, 264, 8)])
def test_dense_kernel_random_generator(cuda, Pm, nm, m, cols):
    """A random 0/1 generator at ragged Pm, nm and cols: the tiles cut
    through every edge of the kernel's 128 x 256 x 128 tiling, and the
    wrapper pads the contiguous operands' row strides."""
    rng = np.random.default_rng(Pm * cols + nm)
    G = torch.from_numpy(rng.integers(0, 2, (Pm, nm), dtype=np.int8))
    x = _bytes(rng, nm // m, m // 8, cols)
    before = _build.LAUNCHES["rs_dense"]
    got = rs_dense.mod2_matmul_planes(G.to(cuda), x.to(cuda), m)
    assert _build.LAUNCHES["rs_dense"] == before + 1
    assert torch.equal(got.cpu(), rs_dense.mod2_matmul_planes_plain(G, x, m))


@pytest.mark.parametrize("xor", [False, True])
def test_pipeline_on_card_equals_cpu(cuda, xor, monkeypatch):
    from celestia_app_tpu_torch.da import extend_shares

    monkeypatch.setenv("CELESTIA_RS_XOR", "on" if xor else "off")
    rng = np.random.default_rng(7)
    shares = [rng.integers(0, 256, 512, dtype=np.uint8).tobytes() for _ in range(64)]
    on_card = extend_shares(shares, "leopard")
    on_cpu = extend_shares(shares, "leopard", device="cpu")
    assert on_card.row_roots() == on_cpu.row_roots()
    assert on_card.col_roots() == on_cpu.col_roots()
    assert on_card.data_root() == on_cpu.data_root()


@pytest.mark.parametrize("k,construction", [
    (1, "vandermonde"), (2, "leopard"), (4, "vandermonde"), (16, "leopard"),
    (128, "vandermonde"), (256, "leopard"), (256, "vandermonde"), (512, "vandermonde"),
])
def test_epilogue_kernel_equals_plain(cuda, k, construction):
    """The fused extend + leaf-hash kernel against its plain version on the
    same card tensors; k >= 256 runs GF(2^16), where a share's symbol bytes
    come in pairs and the kernel reads them in share order."""
    rng = np.random.default_rng(k)
    codec = RSCodec(k, construction)
    m = codec.field.m
    G_bits = codec_tensors(codec.generator_bits(), m, cuda)["G_bits"]
    top = _bytes(rng, k, 2 * k, 512).to(cuda)
    before = _build.LAUNCHES["rs_dense_leaf"]
    bottom, hashes = rs_xor.extend_leaf_digests(top, G_bits, m)
    assert _build.LAUNCHES["rs_dense_leaf"] == before + 1
    want_bottom, want_hashes = rs_xor.extend_leaf_digests_plain(top, G_bits, m)
    assert torch.equal(bottom, want_bottom), (k, construction)
    assert torch.equal(hashes, want_hashes), (k, construction)
    for i, j in ((0, 0), (k - 1, 2 * k - 1)):
        msg = b"\x00" + b"\xff" * 29 + bottom[i, j].cpu().numpy().tobytes()
        assert hashes[i, j].cpu().numpy().tobytes() == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("n,P,n2", [(3, 5, 7), (17, 9, 3), (40, 24, 5), (33, 70, 2)])
def test_epilogue_kernel_random_generator(cuda, n, P, n2, m):
    """Random 0/1 generators with P != n: bands that end inside a share
    tile, contraction stages past n, and batch-column counts of any size."""
    rng = np.random.default_rng(n * 100 + P + m)
    G = torch.from_numpy(rng.integers(0, 2, (P * m, n * m), dtype=np.int8)).to(cuda)
    top = _bytes(rng, n, n2, 512).to(cuda)
    before = _build.LAUNCHES["rs_dense_leaf"]
    bottom, hashes = rs_xor.extend_leaf_digests(top, G, m)
    assert _build.LAUNCHES["rs_dense_leaf"] == before + 1
    want_bottom, want_hashes = rs_xor.extend_leaf_digests_plain(top, G, m)
    assert torch.equal(bottom, want_bottom)
    assert torch.equal(hashes, want_hashes)


@pytest.mark.parametrize("xor", [False, True])
def test_epi_pipeline_on_card_equals_cpu(cuda, xor, monkeypatch):
    """CELESTIA_PIPE_FUSED=epi on the card: one epilogue launch per extend,
    one RS launch (the row phase on the seated core), the same roots and
    EDS as the CPU's fused pipeline."""
    from celestia_app_tpu_torch.da import extend_shares

    monkeypatch.setenv("CELESTIA_RS_XOR", "on" if xor else "off")
    rng = np.random.default_rng(8)
    shares = [rng.integers(0, 256, 512, dtype=np.uint8).tobytes() for _ in range(256)]
    on_cpu = extend_shares(shares, "vandermonde", device="cpu")
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "epi")
    _build.reset_launches()
    on_card = extend_shares(shares, "vandermonde")
    assert _build.LAUNCHES["rs_dense_leaf"] == 1
    assert _build.LAUNCHES["sha256_leaf"] == 1
    # The row phase only: the column phase is the epilogue kernel's.
    assert _build.LAUNCHES["rs_xor" if xor else "rs_dense"] == 1
    assert _build.LAUNCHES["rs_dense" if xor else "rs_xor"] == 0
    assert on_card.data_root() == on_cpu.data_root()
    assert np.array_equal(on_card.squared(), on_cpu.squared())


def test_extend_block_on_card_equals_cpu(cuda, monkeypatch):
    from celestia_app_tpu_torch.app import extend_block

    txs = [bytes([i]) * (100 + 37 * i) for i in range(40)]
    on_cpu = extend_block(txs, device="cpu")
    for mode in ("on", "off", "epi"):
        monkeypatch.setenv("CELESTIA_PIPE_FUSED", mode)
        assert extend_block(txs).data_root() == on_cpu.data_root()
    assert extend_block([]) is None


def _read_side_square(k: int, seed: int):
    """A namespace-ordered random square extended on the card, and its DAH."""
    from celestia_app_tpu_torch.da import DataAvailabilityHeader, extend_shares

    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k * k, 512), dtype=np.uint8)
    ods[:, :29] = 0
    ods[:, 28] = np.sort(rng.integers(0, 256, k * k))
    eds = extend_shares([s.tobytes() for s in ods], "vandermonde")
    return eds, DataAvailabilityHeader.from_eds(eds)


@pytest.mark.parametrize("fused", ["on", "epi"])
@pytest.mark.parametrize("k,erasure", [(128, "Q0"), (128, "random"), (512, "Q0")])
def test_repair_on_card_equals_cpu(cuda, k, erasure, fused, monkeypatch):
    """da.repair on the card gives the original square, and at k=128 the
    CPU's roots; a Q0 repair makes one decode launch before the
    re-extension."""
    from celestia_app_tpu_torch.da import repair

    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", "vandermonde")
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", fused)
    eds, dah = _read_side_square(k, seed=k)
    full = eds.squared()
    n = 2 * k
    rng = np.random.default_rng(1)
    present = np.zeros((n, n), dtype=bool)
    if erasure == "Q0":
        present[:] = True
        present[:k, :k] = False
    else:
        for r in rng.choice(n, k, replace=False):
            present[r, rng.choice(n, k, replace=False)] = True
    damaged = np.where(present[..., None], full, 0).astype(np.uint8)
    _build.reset_launches()
    on_card = repair(damaged, present, dah)
    if erasure == "Q0":
        assert _build.LAUNCHES["rs_dense"] == (3 if fused == "on" else 2)
        assert _build.LAUNCHES["rs_dense_leaf"] == (0 if fused == "on" else 1)
    assert np.array_equal(on_card.squared(), full)
    if k <= 128:
        on_cpu = repair(damaged, present, dah, device="cpu")
        assert on_card.row_roots() == on_cpu.row_roots()
        assert on_card.col_roots() == on_cpu.col_roots()


@pytest.mark.parametrize("k", [128, 512])
def test_forest_sample_verify_on_card_equals_cpu(cuda, k):
    """The forest, sampled proofs and verdicts on the card against the CPU's
    plain path (its forest at k=128) and the host lowering."""
    from celestia_app_tpu_torch.kernels.fused import forest_fn
    from celestia_app_tpu_torch.serve import ForestCache, ProofSampler
    from celestia_app_tpu_torch.serve.verify import verify_proofs

    eds, _ = _read_side_square(k, seed=k + 1)
    _build.reset_launches()
    entry = ForestCache(heights=1, spill=1).put(1, eds)
    assert _build.LAUNCHES["sha256_leaf"] == 1
    if k == 128:
        row_flat, col_flat = forest_fn(k)(eds._eds.cpu())
        assert torch.equal(entry.row_flat.cpu(), row_flat)
        assert torch.equal(entry.col_flat.cpu(), col_flat)
    sampler = ProofSampler()
    rng = np.random.default_rng(k)
    coords = [tuple(int(v) for v in c) for c in rng.integers(0, 2 * k, (64, 2))]
    queue = sampler.sample_batch(entry, coords) + sampler.sample_batch(entry, coords, "col")
    for (row, col), p in zip(coords[:4], queue[:4]):
        assert p == sampler.host_proof(entry, row, col)
    roots = [entry.data_root] * len(queue)
    roots[3] = bytes(32)
    want = [p.verify(r) for p, r in zip(queue, roots)]
    assert want.count(False) == 1
    assert verify_proofs(queue, roots) == want == verify_proofs(queue, roots, device="cpu")


def _stream_squares(k: int, n: int, seed: int) -> list[tuple[int, np.ndarray]]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ods = rng.integers(0, 256, (k * k, 512), dtype=np.uint8)
        ods[:, :29] = 0
        ods[:, 28] = np.sort(rng.integers(0, 256, k * k))
        out.append((i, ods.reshape(k, k, 512)))
    return out


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("k", [16, 128])
def test_stream_on_card_equals_one_shot(cuda, k, batch, monkeypatch):
    """stream_blocks on the card: every square, in order, equal to a one-shot
    compute of its ODS; one pair of RS launches per dispatch."""
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.parallel import stream_blocks
    from celestia_app_tpu_torch.trace import journal

    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", "leopard")
    blocks = _stream_squares(k, 10, seed=k + batch)
    want = [ExtendedDataSquare.compute(ods) for _, ods in blocks]
    before = len(journal.rows("stream"))
    _build.reset_launches()
    out = list(stream_blocks(iter(blocks), k, depth=2, batch=batch))
    launches = dict(_build.LAUNCHES)
    assert [t for t, _ in out] == list(range(10))
    for (_, got), ref in zip(out, want):
        assert torch.equal(got._eds, ref._eds)
        assert got.row_roots() == ref.row_roots() and got.col_roots() == ref.col_roots()
        assert got.data_root() == ref.data_root()
    rows = journal.rows("stream")[before:]
    dispatches = round(sum(1 / r["batch_size"] for r in rows))
    assert launches["rs_dense"] == 2 * dispatches
    assert launches["sha256_leaf"] == dispatches


def test_forests_of_streamed_squares_while_streaming(cuda):
    """Forests built on the default stream from streamed squares, each
    square dropped right after its forest launches were enqueued, while the
    pipeline keeps allocating and launching on its own streams, equal the
    forests of one-shot squares: the outputs were handed to the caller's
    stream (a missing record_stream lets the pipeline overwrite a square
    that the default stream is still hashing)."""
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.kernels.fused import forest
    from celestia_app_tpu_torch.parallel import BlockPipeline

    k = 128
    build = forest(k)
    blocks = _stream_squares(k, 12, seed=3)
    pipe = BlockPipeline(k, depth=2, batch=2)
    got = {}
    try:
        for n, (tag, ods) in enumerate(blocks, start=1):
            pipe.submit(ods, tag)
            if n > 2:
                t, eds = pipe._drain_one()
                got[t] = build(eds._eds)
                del eds  # no sync: the pipeline may reuse the memory next
        for t, eds in pipe.drain():
            got[t] = build(eds._eds)
            del eds
    finally:
        pipe.close()
    assert sorted(got) == list(range(12))
    for tag, ods in blocks:
        row_flat, col_flat = build(ExtendedDataSquare.compute(ods)._eds)
        assert torch.equal(got[tag][0], row_flat), tag
        assert torch.equal(got[tag][1], col_flat), tag


def test_pipeline_runs_on_its_own_streams(cuda, monkeypatch):
    """The uploader copies on the copy stream, every kernel launches on the
    compute stream, and neither is the default stream; the staging slots
    are pinned."""
    from celestia_app_tpu_torch.parallel import BlockPipeline
    from celestia_app_tpu_torch.parallel import pipeline as port_pipeline

    launch_streams, upload_streams = set(), set()
    real_launch, real_upload = _build.launch, port_pipeline.upload

    def launch(*args):
        launch_streams.add(torch.cuda.current_stream().cuda_stream)
        return real_launch(*args)

    def upload(*args, **kwargs):
        upload_streams.add(kwargs["stream"].cuda_stream)
        return real_upload(*args, **kwargs)

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(port_pipeline, "upload", upload)
    pipe = BlockPipeline(16, depth=2, batch=2)
    try:
        for tag, ods in _stream_squares(16, 5, seed=5):
            pipe.submit(ods, tag)
        out = list(pipe.drain())
    finally:
        pipe.close()
    assert len(out) == 5
    default = torch.cuda.default_stream().cuda_stream
    assert launch_streams == {pipe._compute_stream.cuda_stream} != {default}
    assert upload_streams == {pipe._copy_stream.cuda_stream} != {default}
    assert all(pipe._ring.host(s).is_pinned() for s in range(pipe.depth + 1))


def test_speculation_on_card(cuda, monkeypatch):
    """A speculation launched on its side stream and claimed by compute()
    equals the computed square; a different square discards it."""
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.da.eds import speculator

    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    (_, a), (_, b) = _stream_squares(128, 2, seed=9)
    want = ExtendedDataSquare.compute(a)
    sp = speculator()
    sp.discard()
    hits = sp.outcomes["hit"]
    assert sp.speculate(a)
    got = ExtendedDataSquare.compute(a)
    assert sp.outcomes["hit"] == hits + 1
    assert torch.equal(got._eds, want._eds) and got.data_root() == want.data_root()
    assert sp.speculate(a)
    other = ExtendedDataSquare.compute(b)
    assert not sp.pending()
    assert other.data_root() == ExtendedDataSquare.compute(b, device="cpu").data_root()


def test_batched_commitments_on_card_equal_host(cuda):
    """One k=128 square's worth of blobs (a blob of each subtree width 1 to
    128, a 1.97 MB one, random ones): the batched commitments on the card
    equal the host oracle, one sha256_leaves launch per chunk size."""
    from celestia_app_tpu_torch.inclusion import (
        batched,
        create_commitment,
        create_commitments_batched,
        merkle_mountain_range_sizes,
    )
    from celestia_app_tpu_torch.shares import Blob, Namespace
    from celestia_app_tpu_torch.square import subtree_width

    rng = np.random.default_rng(1970)
    namespaces = [Namespace.v0(rng.bytes(10)) for _ in range(16)]
    counts = [1, 100, 200, 400, 800, 1600, 4088, 5000]
    counts += [int(v) for v in np.exp(rng.uniform(0, np.log(300), 80)).astype(int) + 1]
    blobs = [Blob(namespaces[i % 16], rng.bytes(478 + 482 * (n - 1) - int(rng.integers(0, 400))))
             for i, n in enumerate(counts)]
    sizes = {s for b in blobs for n in [b.share_count()]
             for s in merkle_mountain_range_sizes(n, subtree_width(n, 64))}
    batched._COMMIT_MEMO.clear()
    _build.reset_launches()
    got = create_commitments_batched(blobs)
    assert got == [create_commitment(b) for b in blobs]
    assert _build.LAUNCHES["sha256_leaf"] == len(sizes) == 8
    assert _build.LAUNCHES["sha256"] == sum(s.bit_length() - 1 for s in sizes)


_BRIDGE_CLIENT = """
import json, sys
import numpy as np
from celestia_app_tpu_torch.bridge.client import BridgeClient
from celestia_app_tpu_torch.da import ExtendedDataSquare
k = 128
ods = np.random.default_rng(5).integers(0, 256, (k, k, 512), dtype=np.uint8)
ods[:, :, :29] = 0
client = BridgeClient(sys.argv[1], warmup_ks=[k])
eds, rows, cols, root = client.extend_and_dah(ods)
client.shutdown()
want = ExtendedDataSquare.compute(ods)
print(json.dumps({"eds": bool(np.array_equal(eds, want.squared())),
                  "rows": rows.tobytes() == b"".join(want.row_roots()),
                  "cols": cols.tobytes() == b"".join(want.col_roots()),
                  "root": root == want.data_root()}))
"""


def test_bridge_round_trip_on_card(cuda, tmp_path):
    """The C ABI with the port's worker on the card at k=128: the round trip
    equals an in-process compute, and the worker reports the card and its
    launches.  The client runs in a child process under a time limit (the C
    side's reads have none)."""
    import json
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    lib = tmp_path / "libcelestia_square_bridge.so"
    if shutil.which("cmake"):
        subprocess.run(["cmake", "-S", str(root / "bridge"), "-B", str(tmp_path)], check=True,
                       capture_output=True, timeout=300)
        subprocess.run(["cmake", "--build", str(tmp_path)], check=True, capture_output=True,
                       timeout=300)
    else:
        subprocess.run(["c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o",
                        str(lib), str(root / "bridge" / "celestia_square_bridge.cpp")],
                       check=True, capture_output=True, timeout=300)
    env = {k: v for k, v in os.environ.items() if k != "CELESTIA_BRIDGE_DEVICE"}
    out = subprocess.run([sys.executable, "-c", _BRIDGE_CLIENT, str(lib)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "eds": True, "rows": True, "cols": True, "root": True}
    line = next(x for x in out.stderr.splitlines() if x.startswith("bridge worker exit: "))
    report = json.loads(line.removeprefix("bridge worker exit: "))
    assert report["device"] == torch.cuda.get_device_name(0)
    assert report["launches"]["rs_dense"] == 4  # the warmup and the extend
    assert report["launches"]["sha256_leaf"] == 2


# --- giant squares: the panel-streamed lowering and the additive FFT --------


def _panel_square(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    ods[..., 0] = 0
    return ods


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("rows", [48, 7, 1])
@pytest.mark.parametrize("k", [64, 128])
def test_panel_on_card_equals_materializing(cuda, k, rows, construction, monkeypatch):
    """The panel lowering on the card (device=None: the card) against the
    materializing fused pipeline, EDS and roots, with two rs_dense and two
    sha256_leaves launches per panel; the roots-only twin's roots too."""
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.kernels import panel

    ods = _panel_square(k, seed=k + rows)
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "off")
    ref = ExtendedDataSquare.compute(ods, construction)
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", str(rows))
    n = -(-k // rows)
    _build.reset_launches()
    got = ExtendedDataSquare.compute(ods, construction)
    assert torch.equal(got._eds, ref._eds)
    assert got.data_root() == ref.data_root() and got.row_roots() == ref.row_roots()
    assert _build.LAUNCHES["rs_dense"] == 2 * n and _build.LAUNCHES["sha256_leaf"] == 2 * n
    roots = panel.panel_pipeline(k, construction, roots_only=True)(ods)
    assert torch.equal(roots[2], ref._data_root) and torch.equal(roots[0], ref._row_roots)


@pytest.mark.parametrize("k", [64, 128])
def test_panel_generator_slices_at_odd_rows_m8(cuda, k):
    """At m=8 (leopard, k <= 128) a panel starting on an odd row starts its
    generator columns 8 bytes into a 16-byte row: the raw view goes through
    rs_dense.tma_rows' copy, the cached slice as it is; both == plain."""
    from celestia_app_tpu_torch.kernels import panel
    from celestia_app_tpu_torch.kernels.rs import _codec_tensors, encode_axis

    m, tensors = _codec_tensors(k, "leopard", cuda)
    assert m == 8
    G = tensors["G_bits"]
    bounds = panel.panel_bounds(k, 7)
    slices = panel._col_generator_slices(k, "leopard", bounds, cuda)
    rng = np.random.default_rng(k)
    odd = [(b, g) for b, g in zip(bounds, slices) if b[0] % 2]
    assert odd
    for (r0, r1), g in odd[:3]:
        ext = torch.from_numpy(rng.integers(0, 256, (r1 - r0, 2 * k, 512), dtype=np.uint8))
        view = G[:, r0 * m:r1 * m]
        want = encode_axis(ext, view.cpu(), m, contract_axis=0)
        assert torch.equal(encode_axis(ext.to(cuda), view, m, contract_axis=0).cpu(), want)
        assert torch.equal(encode_axis(ext.to(cuda), g, m, contract_axis=0).cpu(), want)


@pytest.mark.parametrize("md", [False, True])
@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [64, 512])
def test_fft_on_card_equals_dense(cuda, k, construction, md):
    """The additive FFT's float16 group products on the card == the dense
    rs_dense encode, on both axes (at k=512 the column phase in blocks)."""
    from celestia_app_tpu_torch.kernels.fft import col_block_encode_fn, encode_axis_fft
    from celestia_app_tpu_torch.kernels.rs import encode_fn

    rng = np.random.default_rng(k)
    dense = encode_fn(k, construction)
    ods = torch.from_numpy(rng.integers(0, 256, (k, k, 512), dtype=np.uint8)).to(cuda)
    assert torch.equal(encode_axis_fft(ods, k, construction, 1, md=md), dense(ods, 1))
    top = torch.cat([ods, dense(ods, 1)], dim=1)
    want = dense(top, 0)
    block = col_block_encode_fn(k, construction, md=md)
    for c0 in range(0, 2 * k, 128):
        assert torch.equal(block(top[:, c0:c0 + 128]), want[:, c0:c0 + 128])


def test_panel_fft_leg_and_stream_on_card(cuda, monkeypatch):
    """Under $CELESTIA_RS_FFT=on the panel lowering runs no rs_dense; a
    stream under panel mode runs batch 1 and equals one-shot computes."""
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.parallel import stream_blocks

    k = 128
    blocks = [(i, _panel_square(k, seed=300 + i)) for i in range(4)]
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "off")
    want = [ExtendedDataSquare.compute(ods) for _, ods in blocks]
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "48")
    monkeypatch.setenv("CELESTIA_RS_FFT", "on")
    _build.reset_launches()
    got = ExtendedDataSquare.compute(blocks[0][1])
    assert torch.equal(got._eds, want[0]._eds) and _build.LAUNCHES["rs_dense"] == 0
    monkeypatch.setenv("CELESTIA_RS_FFT", "auto")
    out = list(stream_blocks(iter(blocks), k, depth=2, batch=4))
    for (_, e), ref in zip(out, want):
        assert torch.equal(e._eds, ref._eds) and e.data_root() == ref.data_root()


# --- the multi-device plane (parallel/mesh.py) ---------------------------------


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
def test_four_shard_mesh_on_one_card_equals_cpu(cuda, construction, monkeypatch):
    """Four logical shards on cuda:0, each with its own stream and buffers:
    the sharded extend, the sharded panel lowering (dense and FFT legs),
    sharded repair and the sharded serving gathers give the CPU mesh's
    bytes, and rs_dense, sha256_leaves and sha256_batch launch on every
    shard's stream."""
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.kernels import panel_sharded as ps
    from celestia_app_tpu_torch.parallel import sharded_eds
    from celestia_app_tpu_torch.parallel.mesh import Mesh
    from celestia_app_tpu_torch.parallel.sharded_repair import sharded_repair
    from celestia_app_tpu_torch.serve import ForestCache, ProofSampler

    k = 64
    ods = _panel_square(k, seed=11)
    # Namespaces rising in row-major order, as NMT proofs need.
    ods[..., :29] = 0
    ods[..., 27:29] = np.arange(k * k, dtype=">u2").view(np.uint8).reshape(k, k, 2)
    card = Mesh([torch.device("cuda", 0)] * 4, "data")
    host = Mesh(["cpu"] * 4, "data")
    want = sharded_eds.make_sharded_pipeline(k, host, construction)(ods)
    _build.reset_launches()
    got = sharded_eds.make_sharded_pipeline(k, card, construction)(ods)
    for a, b in zip(got, want):
        assert np.array_equal(a.cpu().numpy(), b.cpu().numpy())
    for counts in card.launches():
        assert min(counts["rs_dense"], counts["sha256_leaf"], counts["sha256"]) > 0, counts
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "5")
    for fft in ("auto", "on"):
        monkeypatch.setenv("CELESTIA_RS_FFT", fft)
        out = ps.sharded_panel_pipeline(k, construction, mesh=Mesh([cuda] * 4, "extend"))(ods)
        for a, b in zip(out, want):
            assert np.array_equal(a.cpu().numpy(), b.cpu().numpy()), fft
    full = want[0].numpy()
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[k:, :k] = False
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    fixed = sharded_repair(np.where(present[..., None], full, 0).astype(np.uint8), present, card)
    assert np.array_equal(fixed.squared(), full)
    monkeypatch.setenv("CELESTIA_SERVE_SHARDS", "1")
    eds = ExtendedDataSquare(*got, k)
    entry = ForestCache(heights=1, spill=1).put(1, eds)
    coords = [(0, 0), (k, 2 * k - 1), (2 * k - 1, 3)]
    shares = entry.gather_shares(coords)
    assert np.array_equal(shares, np.stack([full[r, c] for r, c in coords]))
    proofs = ProofSampler().sample_batch(entry, coords)
    assert all(p.verify(eds.data_root()) for p in proofs)
    single = ExtendedDataSquare.compute(ods, construction)
    assert proofs == ProofSampler().sample_batch(ForestCache(heights=1, spill=1).put(2, single),
                                                 coords)


def test_launch_on_the_last_card(cuda):
    """A launch on cuda:{n-1} from a thread whose current device is 0 runs
    on that card's stream (kernels/_build.launch's device guard), and the
    tensor-core kernel's set-up is made there too (csrc/rs_dense.cuh)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs at least 2 cards to launch on another one; this machine has {n}")
    from celestia_app_tpu_torch.kernels.rs import _encode_with

    last = torch.device("cuda", n - 1)
    rng = np.random.default_rng(n)
    codec = RSCodec(64, "vandermonde")
    m = codec.field.m
    G = codec_tensors(codec.generator_bits(), m, last)["G_bits"]
    data = _bytes(rng, 64, 64, 512)
    with torch.cuda.device(0):
        got = _encode_with(rs_dense.mod2_matmul_planes, data.to(last), G, m, 1)
        digests = sha.sha256(data.reshape(-1, 512)[:100].to(last))
    assert got.device == last and digests.device == last
    want = _encode_with(rs_dense.mod2_matmul_planes_plain, data, G.cpu(), m, 1)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(digests.cpu(), sha.sha256_plain(data.reshape(-1, 512)[:100]))
    with pytest.raises(ValueError, match="want one CUDA device"):
        _build.launch("sha256", "sha256", "sha256_batch",
                      torch.zeros((2, 64), dtype=torch.uint8, device="cuda:0"), 2, 64,
                      torch.empty((2, 32), dtype=torch.uint8, device=last))


def test_app_prepare_process_round_trip_on_card(cuda):
    """A proposer App and a non-proposer App on the card: the proposer's
    BlockData equals App(device="cpu")'s, the non-proposer accepts it with
    the commitments and the extend launched on the card, and rejects a
    wrong hash."""
    from celestia_app_tpu_torch.app import App, BlockData
    from celestia_app_tpu_torch.inclusion import batched
    from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs

    keys = funded_keys(8)
    genesis = deterministic_genesis(keys)
    txs = block_txs(keys, genesis.chain_id, seed=16, sends=4, pfbs=16, blob_shares=(6, 14))
    apps = {}
    for name, device in (("proposer", None), ("validator", None), ("cpu", "cpu")):
        apps[name] = App(device=device)
        apps[name].init_chain(genesis)
    data = apps["proposer"].prepare_proposal(txs)
    want = apps["cpu"].prepare_proposal(txs)
    assert (data.txs, data.square_size, data.hash) == (want.txs, want.square_size, want.hash)
    assert data.square_size == 16 and len(data.txs) == len(txs)
    batched._COMMIT_MEMO.clear()
    _build.reset_launches()
    assert apps["validator"].process_proposal(data) is True
    assert all(_build.LAUNCHES[k] > 0 for k in ("sha256", "sha256_leaf", "rs_dense"))
    assert apps["validator"].process_proposal(
        BlockData(data.txs, data.square_size, bytes(32))) is False


def test_app_chain_finalize_commit_on_card(cuda):
    """Two heights of a small chain on the card: Prepare and Process on a
    card App, then finalize_block + commit, with no kernel launched across
    them; the app hash and TxResults equal App(device="cpu")'s, which
    finalizes the same txs."""
    from celestia_app_tpu_torch.app import App
    from celestia_app_tpu_torch.testutil import BLOCK_INTERVAL_NS, deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs, next_sequences

    keys = funded_keys(8)
    genesis = deterministic_genesis(keys)
    signers = {v.address for v in genesis.validators}
    card, on_cpu = App(), App(device="cpu")
    for app in (card, on_cpu):
        app.init_chain(genesis)
    for height in (1, 2):
        txs = block_txs(keys, genesis.chain_id, seed=20 + height, sends=4, pfbs=8,
                        blob_shares=(2, 6), sequences=next_sequences(card, keys))
        data = card.prepare_proposal(txs)
        assert card.process_proposal(data) is True and len(data.txs) == len(txs)
        time_ns = card.last_block_time_ns + BLOCK_INTERVAL_NS
        _build.reset_launches()
        got = card.finalize_block(time_ns, list(data.txs), last_commit_signers=signers)
        card_hash = card.commit()
        assert not any(_build.LAUNCHES.values())
        want = on_cpu.finalize_block(time_ns, list(data.txs), last_commit_signers=signers)
        assert on_cpu.commit() == card_hash
        assert [(r.code, r.log, r.gas_wanted, r.gas_used, r.events) for r in got] == [
            (r.code, r.log, r.gas_wanted, r.gas_used, r.events) for r in want]
        assert all(r.code == 0 for r in got)


def test_node_txsim_golden_on_card(cuda):
    """The pinned txsim load on a card TestNode: the JAX TestNode's app hash
    and tx index (chip_smoke.NODE_GOLDEN_*), with kernels launched on the
    way."""
    import importlib

    import chip_smoke
    from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys

    keys = funded_keys(chip_smoke.NODE_GOLDEN["n_keys"])
    node = TestNode(deterministic_genesis(keys), keys)
    _build.reset_launches()
    stats = chip_smoke.node_golden_run(
        node, keys, importlib.import_module("celestia_app_tpu_torch.txsim.run"))
    assert stats["failed"] == 0 and _build.LAUNCHES["rs_dense"] > 0
    assert node.app.cms.last_app_hash.hex() == chip_smoke.NODE_GOLDEN_APP_HASH
    assert chip_smoke.index_digest(node.tx_index) == chip_smoke.NODE_GOLDEN_INDEX


def test_node_and_network_on_card_equal_cpu(cuda):
    """Broadcasts on a card TestNode and a TestNode(device="cpu") with the
    reap budget binding, two heights, then a 3-validator Network on the card
    against one on the CPU: the same pools, blocks, TxResults and hashes."""
    import dataclasses

    from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs
    from celestia_app_tpu_torch.testutil.network import Network

    keys = funded_keys(8)
    genesis = dataclasses.replace(deterministic_genesis(keys), block_max_bytes=40_000)
    txs = block_txs(keys, genesis.chain_id, seed=30, sends=6, pfbs=24, blob_shares=(2, 8))
    legs = []
    for device in (None, "cpu"):
        node = TestNode(genesis, keys, device=device)
        codes = [node.broadcast(t).code for t in txs]
        heights = []
        for _ in range(2):
            data, results = node.produce_block()
            heights.append(((data.txs, data.square_size, data.hash),
                            [(r.code, r.log, r.gas_used, r.events) for r in results],
                            node.app.cms.last_app_hash, node.mempool.resident_txs()))
        net = Network(3, genesis, keys, device=device)
        for t in txs[:12]:
            assert net.broadcast(t).code == 0
        data, _ = net.produce_block()
        legs.append((codes, heights, node.tx_index, data.hash,
                     [n.cms.last_app_hash for n in net.nodes]))
    assert legs[0] == legs[1]
    assert not any(legs[0][0]) and len(legs[0][1][0][3]) > 0  # the budget bound


def test_node_concurrent_admission_on_card(cuda):
    """CheckTx on the card App in turn, then admission into the node's
    sharded pool from 8 threads: the pool the global pool gets in order."""
    import threading

    from celestia_app_tpu_torch.mempool import PriorityMempool
    from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs

    keys = funded_keys(16)
    node = TestNode(deterministic_genesis(keys), keys)
    txs = block_txs(keys, node.chain_id, seed=31, sends=16, pfbs=48, blob_shares=(1, 4))
    rows = []
    for t in txs:
        res = node.app.check_tx(t)
        assert res.code == 0
        rows.append((t, next(e[1] for e in res.events if e[0] == "priority")))
    ref = PriorityMempool(shards=0)
    for t, prio in rows:
        assert ref.insert(t, prio, 0)
    threads = [threading.Thread(target=lambda part: [node.mempool.insert(t, p, 0) for t, p in part],
                                args=(rows[i::8],)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(node.mempool.resident_txs()) == sorted(ref.resident_txs())
    assert node.mempool.size_bytes() == ref.size_bytes()


def test_gossip_cluster_on_card_equals_cpu(cuda):
    """3 card ServingNodes gossip a small chain through 3 heights (blob txs
    relayed from a non-proposer, speculation on): their app hashes agree,
    equal a TestNode(device="cpu") replaying the blocks, every Commit record
    verifies, and each retained forest serves a share proof that verifies
    against its data root."""
    import chip_smoke
    from celestia_app_tpu_torch.consensus import verify_commit
    from celestia_app_tpu_torch.rpc.server import ServingNode, serve
    from celestia_app_tpu_torch.serve import ProofSampler
    from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs
    from celestia_app_tpu_torch.tx import tx_hash

    keys = funded_keys(4)
    genesis = deterministic_genesis(keys, n_validators=3)
    makers = [lambda i=i: (ServingNode(genesis=genesis, keys=keys, validator_index=i,
                                       n_validators=3), serve) for i in range(3)]
    old = os.environ.get("CELESTIA_PIPE_SPECULATE")
    os.environ["CELESTIA_PIPE_SPECULATE"] = "on"
    nodes, servers = chip_smoke.gossip_cluster(makers, timeouts=chip_smoke.CPU_CLUSTER_TIMEOUTS)
    try:
        txs = block_txs(keys, genesis.chain_id, seed=11, sends=2, pfbs=4, blob_shares=(1, 6))
        for t in txs:
            assert nodes[1].broadcast(t).code == 0
        for n in nodes:
            n.consensus_driver.start()
        chip_smoke.wait_heights(nodes, 3, timeout_s=180)
        assert all(n.wait_tx(tx_hash(t), 60.0)[1] == 0 for n in nodes for t in txs)
    finally:
        for s in servers:
            s.stop()
        if old is None:
            os.environ.pop("CELESTIA_PIPE_SPECULATE", None)
        else:
            os.environ["CELESTIA_PIPE_SPECULATE"] = old
    upto = min(n.app.height for n in nodes)
    hashes = [nodes[0].app.cms.app_hash_at(h) for h in range(1, upto + 1)]
    assert all([n.app.cms.app_hash_at(h) for h in range(1, upto + 1)] == hashes for n in nodes)
    replay = TestNode(genesis, keys, device="cpu")
    assert chip_smoke.replay_heights(replay, nodes[0], upto, ServingNode._parse_evidence) == hashes
    sampler = ProofSampler()
    for h in range(1, upto + 1):
        data = nodes[0]._blocks_by_height[h][0]
        assert verify_commit(nodes[0]._valsets_by_height[h], nodes[0].chain_id, nodes[0]._commits[h])
        if data.txs:
            entry, _ = nodes[0].serve_cache.get(h)
            proofs = sampler.sample_batch(entry, [(0, 0), (2 * data.square_size - 1, 1)])
            assert all(p.verify(data.hash) for p in proofs)


def test_one_shot_launch_fault_is_retried_on_the_card(cuda):
    """A launch that fails once is retried within its rung (the ladder does
    not move) and the roots equal the CPU port's; a fault on every launch
    walks the ladder to the staged floor on the card and raises."""
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.da import ExtendedDataSquare

    rng = np.random.default_rng(140)
    ods = rng.integers(0, 256, (16, 16, 512), dtype=np.uint8)
    want = ExtendedDataSquare.compute(ods, device="cpu").data_root()
    inner, fired = _build.launch, []

    def once(kernel, *args, **kwargs):
        if not fired:
            fired.append(kernel)
            raise RuntimeError(f"injected launch fault in {kernel}")
        return inner(kernel, *args, **kwargs)

    degrade.reset_for_tests()
    try:
        _build.launch = once
        assert ExtendedDataSquare.compute(ods, device=cuda).data_root() == want
        assert fired and degrade.degraded_state() is None
        _build.launch = lambda kernel, *a, **k: (_ for _ in ()).throw(RuntimeError("dead"))
        with pytest.raises(RuntimeError, match="dead"):
            ExtendedDataSquare.compute(ods, device=cuda)
        assert degrade.degraded_state() == {"device": "host"}
    finally:
        _build.launch = inner
        degrade.reset_for_tests()


def test_parity_sentinel_matches_on_its_own_stream(cuda, monkeypatch):
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.da import eds as eds_mod
    from celestia_app_tpu_torch.trace.metrics import registry

    def matches():
        fam = registry().get("celestia_parity_checks_total")
        return 0.0 if fam is None else sum(v for k, v in fam.samples() if k["result"] == "match")

    monkeypatch.setenv("CELESTIA_PARITY_SENTINEL", "1")
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "epi")
    before = matches()
    rng = np.random.default_rng(141)
    for _ in range(3):
        ExtendedDataSquare.compute(rng.integers(0, 256, (64, 64, 512), dtype=np.uint8),
                                   device=cuda)
    eds_mod.drain_parity_checks(120)
    assert matches() == before + 3


def _serve_square(k: int, device):
    from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
    from celestia_app_tpu_torch.da import extend_shares

    rng = np.random.default_rng(k)
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = np.sort(rng.integers(0, 128, k * k))
    return extend_shares([s.tobytes() for s in ods], device=device)


def test_das_payloads_on_card_equal_cpu(cuda):
    """The DasProvider's share proof, namespace and attestation payloads on
    the card == on the CPU, the verification gate armed."""
    from celestia_app_tpu_torch.serve import ForestCache
    from celestia_app_tpu_torch.serve.api import DasProvider, render

    k = 16
    outs = []
    for device in (cuda, "cpu"):
        p = DasProvider(cache=ForestCache(heights=1, spill=1, device=device))
        p.cache.put(1, _serve_square(k, device))
        ns = p.entry(1).eds.ods_namespaces()[40].tobytes().hex()
        os.environ["CELESTIA_SERVE_VERIFY"] = "1"
        try:
            outs.append([render(p.share_proof_payload(1, r, c, axis=a))
                         for r, c, a in ((0, 0, "row"), (5, 30, "col"), (31, 31, "row"))]
                        + [render(p.shares_payload(1, ns)),
                           render(p.attestation_payload(1, "0:0,3:4:col,20:21,31:0:col"))])
        finally:
            os.environ.pop("CELESTIA_SERVE_VERIFY", None)
    assert outs[0] == outs[1]


def test_heal_on_card_equals_cpu_and_a_fault_is_no_verdict(cuda):
    """A withheld height heals on the card to the CPU heal's square; a fault
    on every rung raises DeviceFault with no verdict recorded."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.device import DeviceFault
    from celestia_app_tpu_torch.serve import ForestCache, heal
    from celestia_app_tpu_torch.serve.api import DasProvider, render
    from celestia_app_tpu_torch.serve.sampler import ShareWithheld

    k = 8
    served = []
    try:
        for device in (cuda, "cpu"):
            p = DasProvider(cache=ForestCache(heights=1, spill=1, device=device))
            p.cache.put(1, _serve_square(k, device))
            engine = heal.HealingEngine(p, name=f"card-{device}")
            chaos.install("seed=31,withhold_frac=0.25")
            coord = sorted(chaos.active_adversary().withheld_set(1, 2 * k))[0]
            with pytest.raises(ShareWithheld):
                p.share_proof_payload(1, *coord)
            assert engine.process_pending() == [(1, "healed")]
            served.append(render(p.share_proof_payload(1, *coord)))
            engine.close()
        assert served[0] == served[1]
        p = DasProvider(cache=ForestCache(heights=1, spill=1, device=cuda))
        p.cache.put(1, _serve_square(k, cuda))
        engine = heal.HealingEngine(p, name="card-fault")
        chaos.install("seed=31,withhold_frac=0.25,dispatch_fail=1.0,dispatch_fail_all=1")
        with pytest.raises(ShareWithheld):
            p.share_proof_payload(1, *coord)
        with pytest.raises(DeviceFault):
            engine.process_pending()
        state = engine.state()
        assert state["healing"] == [] and state["quarantined_total"] == 0 and state["last"] is None
        engine.close()
    finally:
        chaos.uninstall()
        degrade.reset_for_tests()


def test_get_surface_on_card_equals_cpu(cuda):
    """The exposition's /das routes over a provider on the card give the
    CPU provider's bytes; /device then reads the card's allocator; a
    persistent proof_fail answers 500 naming DeviceFault."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.serve import ForestCache
    from celestia_app_tpu_torch.serve.api import DasProvider
    from celestia_app_tpu_torch.trace import exposition

    k = 16
    paths = ["/das/share_proof?height=1&row=0&col=0", "/das/share_proof?height=1&row=5&col=30&axis=col",
             "/das/attestation?height=1&samples=0:0,3:4:col,20:21", "/das/coverage?height=1"]
    bodies = []
    for device in (cuda, "cpu"):
        p = DasProvider(cache=ForestCache(heights=1, spill=1, device=device))
        p.cache.put(1, _serve_square(k, device))
        exposition.register_das_provider(p)
        try:
            ns = p.entry(1).eds.ods_namespaces()[40].tobytes().hex()
            bodies.append([exposition.handle_observability_get(path)
                           for path in paths + [f"/das/shares?height=1&namespace={ns}"]])
            if device is cuda:
                own = json.loads(exposition.handle_observability_get("/device")[2])["ownership"]
                assert own["measured_source"] == "device_memory_stats" and own["measured_bytes"] > 0
                chaos.install("seed=1,proof_fail=1.0")
                try:
                    status, _, body = exposition.handle_observability_get(paths[0])
                finally:
                    chaos.uninstall()
                assert status == 500 and json.loads(body)["error"].startswith("DeviceFault: ")
        finally:
            exposition.unregister_das_provider(p)
    assert bodies[0][:3] == bodies[1][:3] and bodies[0][4] == bodies[1][4]
    assert all(b[0] == 200 for b in bodies[0])


def test_state_sync_joiner_on_card_equals_cpu_chain(cuda):
    """A chain built on the CPU, joined by a node on the card: its catch-up
    runs the extend and the forest on the card and lands on the CPU chain's
    app hash."""
    from celestia_app_tpu_torch.rpc.server import ServingNode, serve
    from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs, next_sequences

    keys = funded_keys(4)
    genesis = deterministic_genesis(keys, n_validators=1)
    source = ServingNode(genesis=genesis, keys=keys, snapshot_interval=4, device="cpu")
    server = serve(source, port=0, block_interval_s=None)
    try:
        for h in range(1, 7):
            for raw in block_txs(keys, source.app.chain_id, seed=h, sends=1, pfbs=2,
                                 blob_shares=(1, 3), sequences=next_sequences(source.app, keys)):
                source.broadcast(raw, relay=False)
            source.produce_block()
        joiner = ServingNode(genesis=genesis, keys=keys, device=cuda)
        _build.reset_launches()
        assert joiner.state_sync_from(server.url) == 4
        assert _build.LAUNCHES["rs_dense"] > 0 and _build.LAUNCHES["sha256_leaf"] > 0
        assert joiner.app.height == 6
        assert joiner.app.cms.last_app_hash == source.app.cms.last_app_hash
    finally:
        server.stop()


def test_devnet_on_card(cuda, tmp_path):
    """Two validator processes on the card reach height 2 at equal app
    hashes."""
    import time

    from celestia_app_tpu_torch.rpc.devnet import spawn_devnet

    net = spawn_devnet(2, device="cuda", log_dir=str(tmp_path), wait_s=300)
    try:
        deadline = time.monotonic() + 120
        while min(net.client(i).status()["height"] for i in range(2)) < 3:
            net.check()
            assert time.monotonic() < deadline
            time.sleep(0.2)
        hashes = [[net.client(i).commit(h + 1).prev_app_hash for h in (1, 2)] for i in range(2)]
        assert hashes[0] == hashes[1]
    finally:
        net.stop()
