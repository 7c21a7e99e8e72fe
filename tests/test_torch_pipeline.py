"""The port's whole block-square path on the CPU: ODS -> EDS -> NMT roots ->
data root, byte-identical to the JAX package, one square at a time and
streamed (parallel/pipeline.py: stream_blocks, the staging ring, the
batched pipelines).

The JAX `extend_shares` compiles one program per (k, construction), a few
seconds each on the CPU, so each k is held against it under one
construction (alternating); every (k, construction) pair is also held
against the JAX package's host oracles (gf.rs.RSCodec, nmt.tree, merkle).
The streamed squares are held against the JAX `stream_blocks`,
`jit_extend_and_dah_batched` and `ExtendedDataSquare.compute` at k=2 and 4,
where its compiles are cheap.
"""

from __future__ import annotations

import gc
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu import merkle as jax_host_merkle
from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.da.eds import extend_shares as jax_extend_shares
from celestia_app_tpu.kernels.fused import jit_extend_and_dah_batched
from celestia_app_tpu.parallel import pipeline as jax_pipeline
from celestia_app_tpu.gf.rs import RSCodec as JaxRSCodec
from celestia_app_tpu.nmt.tree import NamespacedMerkleTree
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, PARITY_NAMESPACE_BYTES, SHARE_SIZE
from celestia_app_tpu_torch.da import (
    DataAvailabilityHeader,
    ExtendedDataSquare,
    extend_shares,
    min_data_availability_header,
)
from celestia_app_tpu_torch.da.dah import tail_padding_share
from celestia_app_tpu_torch.da.eds import (
    _batched_pipeline_for_mode,
    leaf_namespaces,
    pipeline_batched,
    roots_fn,
)
from celestia_app_tpu_torch.kernels.fused import extend_and_dah_batched_fn, extend_and_dah_fn
from celestia_app_tpu_torch.parallel import pipeline as port_pipeline
from celestia_app_tpu_torch.parallel.pipeline import (
    BlockPipeline,
    _BufferRing,
    env_batch,
    env_batch_cap,
    stream_blocks,
)
from celestia_app_tpu_torch.serve import ForestCache
from celestia_app_tpu_torch.trace import journal


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


MIN_DAH_HASH = "3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353"
K2_HASH = "b56e4d251ac266f4b91cc5464b3fc7efcbdc888064647496d13133f0dc65ac25"


def _golden_share() -> bytes:
    ns = bytes([0x00]) + bytes(18) + bytes([0x01]) * 10
    return ns + b"\xff" * (SHARE_SIZE - NAMESPACE_SIZE)


def _random_ods(k: int, seed: int) -> np.ndarray:
    """Random shares whose namespaces rise in row-major order."""
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 2:NAMESPACE_SIZE] = np.sort(
        rng.integers(0, 2**16, k * k)).astype(">u2").view(np.uint8).reshape(-1, 2)
    return ods.reshape(k, k, SHARE_SIZE)


def _port(ods: np.ndarray, construction: str, xor: bool, monkeypatch):
    monkeypatch.setenv("CELESTIA_RS_XOR", "on" if xor else "off")
    k = ods.shape[0]
    return extend_shares([s.tobytes() for s in ods.reshape(k * k, SHARE_SIZE)],
                         construction, device="cpu")


def _host_reference(ods: np.ndarray, construction: str):
    """EDS, roots and data root from the JAX package's host code alone."""
    k = ods.shape[0]
    codec = JaxRSCodec(k, construction)
    top = np.stack([codec.extend(ods[i]) for i in range(k)])  # (k, 2k, S)
    eds = np.stack([codec.extend(top[:, j]) for j in range(2 * k)], axis=1)

    def root(line, coords):
        tree = NamespacedMerkleTree()
        for share, (r, c) in zip(line, coords):
            ns = share[:NAMESPACE_SIZE].tobytes() if r < k and c < k else PARITY_NAMESPACE_BYTES
            tree.push(ns + share.tobytes())
        return tree.root()

    n = 2 * k
    rows = [root(eds[i], [(i, j) for j in range(n)]) for i in range(n)]
    cols = [root(eds[:, j], [(i, j) for i in range(n)]) for j in range(n)]
    return eds, rows, cols, jax_host_merkle.hash_from_byte_slices(rows + cols)


def test_min_dah_golden():
    dah = min_data_availability_header(device="cpu")
    assert dah.hash().hex() == MIN_DAH_HASH
    dah.validate_basic()
    assert dah.square_size() == 1


def test_tail_padding_share_equals_jax_package():
    from celestia_app_tpu.shares.namespace import TAIL_PADDING_NAMESPACE
    from celestia_app_tpu.shares.share import padding_share

    assert tail_padding_share() == padding_share(TAIL_PADDING_NAMESPACE).raw


@pytest.mark.parametrize("xor", [False, True])
def test_k2_golden(xor, monkeypatch):
    monkeypatch.setenv("CELESTIA_RS_XOR", "on" if xor else "off")
    eds = extend_shares([_golden_share()] * 4, device="cpu")
    dah = DataAvailabilityHeader.from_eds(eds)
    assert len(dah.row_roots) == 4 and len(dah.column_roots) == 4
    assert dah.hash().hex() == K2_HASH == eds.data_root().hex()


@pytest.mark.parametrize("k,construction", [
    (1, "vandermonde"), (2, "leopard"), (4, "vandermonde"), (8, "leopard"),
    (16, "vandermonde"),
])
def test_roots_equal_jax_extend_shares(k, construction, monkeypatch):
    ods = _random_ods(k, seed=k)
    ref = jax_extend_shares([s.tobytes() for s in ods.reshape(k * k, SHARE_SIZE)], construction)
    for xor in (False, True):
        eds = _port(ods, construction, xor, monkeypatch)
        assert eds.row_roots() == ref.row_roots()
        assert eds.col_roots() == ref.col_roots()
        assert eds.data_root() == ref.data_root()
        assert np.array_equal(eds.squared(), np.asarray(ref.squared()))


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_roots_equal_host_reference(k, construction, monkeypatch):
    ods = _random_ods(k, seed=100 + k)
    want_eds, rows, cols, droot = _host_reference(ods, construction)
    for xor in (False, True):
        eds = _port(ods, construction, xor, monkeypatch)
        assert np.array_equal(eds.squared(), want_eds)
        assert eds.row_roots() == rows and eds.col_roots() == cols
        assert eds.data_root() == droot
        assert DataAvailabilityHeader.from_eds(eds).hash() == droot


def test_accessors_and_stages():
    k = 4
    ods = _random_ods(k, seed=3)
    eds = ExtendedDataSquare.compute(ods, "vandermonde", device="cpu")
    assert eds.width == 8 and eds.squared().shape == (8, 8, SHARE_SIZE)
    assert eds.flattened_ods() == [s.tobytes() for s in ods.reshape(k * k, SHARE_SIZE)]
    assert np.array_equal(eds.row(5), eds.squared()[5])
    assert np.array_equal(eds.col(6), eds.squared()[:, 6])
    row_ns, col_ns = leaf_namespaces(eds._eds, k)
    assert row_ns[1, 2].numpy().tobytes() == ods[1, 2, :NAMESPACE_SIZE].tobytes()
    assert row_ns[1, 5].numpy().tobytes() == PARITY_NAMESPACE_BYTES
    assert torch.equal(col_ns, row_ns.transpose(0, 1))
    rr, cr, droot = roots_fn(k)(eds._eds)
    assert droot.numpy().tobytes() == eds.data_root()
    assert torch.equal(rr, eds._row_roots) and torch.equal(cr, eds._col_roots)
    tensor_in = ExtendedDataSquare.compute(torch.from_numpy(ods.copy()), "vandermonde",
                                           device="cpu")
    assert tensor_in.data_root() == eds.data_root()
    roots_only = extend_and_dah_fn(k, "vandermonde", roots_only=True, device="cpu")
    rr2, cr2, droot2 = roots_only(torch.from_numpy(ods.copy()))
    assert torch.equal(rr2, rr) and torch.equal(cr2, cr) and torch.equal(droot2, droot)


def test_header_checks():
    dah = DataAvailabilityHeader([b"\x00" * 90] * 2, [b"\x00" * 90] * 2)
    dah.validate_basic()
    assert dah.equals(DataAvailabilityHeader(list(dah.row_roots), list(dah.column_roots)))
    for bad in (
        DataAvailabilityHeader([b"\x00" * 90] * 2, [b"\x00" * 90] * 4),
        DataAvailabilityHeader([b"\x00" * 90], [b"\x00" * 90]),
        DataAvailabilityHeader([b"\x00" * 89] * 2, [b"\x00" * 90] * 2),
    ):
        with pytest.raises(ValueError):
            bad.validate_basic()


def test_input_checks():
    with pytest.raises(ValueError):
        extend_shares([_golden_share()] * 3, device="cpu")
    with pytest.raises(ValueError):
        extend_shares([_golden_share()] * 9, device="cpu")
    with pytest.raises(ValueError):
        extend_shares([_golden_share()[:-1]] * 4, device="cpu")
    with pytest.raises(ValueError):
        ExtendedDataSquare.compute(np.zeros((2, 2, 100), dtype=np.uint8), device="cpu")


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        extend_shares([_golden_share()] * 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ExtendedDataSquare.compute(np.zeros((1, 1, SHARE_SIZE), dtype=np.uint8), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        min_data_availability_header()


# --- streaming: stream_blocks, the batched pipelines, the staging ring ------

CONSTRUCTIONS = ("vandermonde", "leopard")


def _blocks(k: int, n: int, seed: int) -> list[tuple[int, np.ndarray]]:
    return [(i, _random_ods(k, seed=seed + i)) for i in range(n)]


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
@pytest.mark.parametrize("depth,batch", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_stream_blocks_equal_jax(depth, batch, construction, monkeypatch):
    """In submission order, every streamed square equals the JAX stream's
    and the JAX one-shot compute's: roots, data root and EDS bytes."""
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    k = 2
    blocks = _blocks(k, 7, seed=300)
    ref = [JaxEDS.compute(ods) for _, ods in blocks]
    jax_out = list(jax_pipeline.stream_blocks(iter(blocks), k, depth=depth, batch=batch))
    port_out = list(stream_blocks(iter(blocks), k, depth=depth, batch=batch, device="cpu"))
    assert [t for t, _ in port_out] == [t for t, _ in jax_out] == list(range(7))
    for (_, got), (_, streamed), want in zip(port_out, jax_out, ref):
        assert got.data_root() == streamed.data_root() == want.data_root()
        assert got.row_roots() == want.row_roots() and got.col_roots() == want.col_roots()
        assert np.array_equal(got.squared(), np.asarray(want.squared()))


def test_stream_rows_in_the_journal():
    k = 2
    before = len(journal.rows("stream"))
    out = list(stream_blocks(iter(_blocks(k, 5, seed=320)), k, depth=2, batch=2, device="cpu"))
    rows = journal.rows("stream")[before:]
    assert [r["tag"] for r in rows] == [str(t) for t, _ in out]
    for r in rows:
        assert r["k"] == k and r["depth"] == 2 and r["batch_size"] in (1, 2)
        for name in ("intake_wait_ms", "upload_ms", "upload_stall_ms", "dispatch_ms",
                     "dispatch_starve_ms", "drain_ms"):
            assert r[name] >= 0.0, name


@pytest.mark.parametrize("xor", [False, True])
@pytest.mark.parametrize("construction", CONSTRUCTIONS)
def test_batched_fn_equals_jax_and_single(construction, xor, monkeypatch):
    """extend_and_dah_batched_fn(k=2, B=3) == the JAX vmapped program and
    == the port's one-square pipeline, square by square, byte for byte."""
    monkeypatch.setenv("CELESTIA_RS_XOR", "on" if xor else "off")
    k, batch = 2, 3
    odss = np.stack([_random_ods(k, seed=400 + b) for b in range(batch)])
    want = jit_extend_and_dah_batched(k, batch, construction)(jnp.asarray(odss))
    got = extend_and_dah_batched_fn(k, batch, construction, device="cpu")(torch.from_numpy(odss))
    single = extend_and_dah_fn(k, construction, device="cpu")
    assert [tuple(t.shape) for t in got] == [(batch, 4, 4, 512), (batch, 4, 90),
                                             (batch, 4, 90), (batch, 32)]
    for b in range(batch):
        one = single(torch.from_numpy(odss[b].copy()))
        for name, g, w, o in zip(("eds", "row_roots", "col_roots", "droot"), got, want, one):
            assert np.array_equal(g[b].numpy(), np.asarray(w[b])), (b, name)
            assert torch.equal(g[b], o), (b, name)


@pytest.mark.parametrize("mode", ["fused_epi", "staged", "host"])
def test_batched_modes_equal_fused(mode):
    k, batch = 4, 2
    odss = torch.from_numpy(np.stack([_random_ods(k, seed=440 + b) for b in range(batch)]))
    want = _batched_pipeline_for_mode("fused", k, batch, "leopard", device="cpu")(odss)
    got = _batched_pipeline_for_mode(mode, k, batch, "leopard", device="cpu")(odss)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_batched_fn_rejects_other_shapes():
    with pytest.raises(ValueError):
        extend_and_dah_batched_fn(2, 0, device="cpu")
    run = pipeline_batched(2, 3, "vandermonde", device="cpu")
    with pytest.raises(ValueError):
        run(torch.zeros((2, 2, 2, SHARE_SIZE), dtype=torch.uint8))


@pytest.mark.parametrize("k,want", [(1, MIN_DAH_HASH), (2, K2_HASH)])
def test_goldens_through_batched_path(k, want):
    """MinDAH (one tail-padding share), and the k=2 golden square, two
    copies in one batch: every square's DAH is the golden (the k=128 case
    is tests/test_torch_golden_k128_batched.py)."""
    share = tail_padding_share() if k == 1 else _golden_share()
    ods = np.frombuffer(share * (k * k), dtype=np.uint8).reshape(k, k, SHARE_SIZE)
    _, rows, cols, droots = extend_and_dah_batched_fn(k, 2, device="cpu")(
        torch.from_numpy(np.stack([ods, ods])))
    for b in range(2):
        dah = DataAvailabilityHeader([r.numpy().tobytes() for r in rows[b]],
                                     [c.numpy().tobytes() for c in cols[b]])
        assert dah.hash().hex() == want == droots[b].numpy().tobytes().hex()


def test_env_batch_parses_as_jax(monkeypatch):
    """Both parsers on the same values; "auto" with no occupancy signal."""
    from celestia_app_tpu.trace import square_journal

    monkeypatch.setattr(square_journal, "_LAST", None)
    for raw in (None, "", "0", "1", "off", "OFF", "4", " 7 ", "junk", "-3", "auto", "AUTO"):
        if raw is None:
            monkeypatch.delenv("CELESTIA_PIPE_BATCH", raising=False)
        else:
            monkeypatch.setenv("CELESTIA_PIPE_BATCH", raw)
        assert env_batch() == jax_pipeline.env_batch(), raw
        assert env_batch_cap() == jax_pipeline.env_batch_cap(), raw


def test_ring_reuses_buffers():
    ring = _BufferRing(2, slots=2, batch=1)
    a = ring.acquire(1.0)
    b = ring.acquire(1.0)
    assert {a, b} == {0, 1}
    assert ring.acquire(0.05) is None  # exhausted: bounded wait
    before = ring.host(a)
    ring.release(a)
    c = ring.acquire(1.0)
    assert c == a and ring.host(c) is before  # recycled, not reallocated
    assert ring.swaps == 0


def test_ring_pinned_slot_swaps_fresh_buffer():
    ring = _BufferRing(2, slots=1, batch=1)
    sid = ring.acquire(1.0)
    retained = ring.host(sid)
    retained[:] = 7  # the bytes a retained square would alias
    ring.release(sid)
    ring.pin(sid)
    again = ring.acquire(1.0)
    assert again == sid
    assert ring.host(again) is not retained
    assert bool((retained == 7).all())
    assert ring.swaps == 1
    assert ring.states()["pinned"] == 0


def test_ring_late_pin_is_counted():
    ring = _BufferRing(2, slots=1, batch=1)
    sid = ring.acquire(1.0)
    gen = ring.generation(sid)
    ring.release(sid)
    ring.acquire(1.0)  # acquired again: the pin comes late
    ring.pin(sid, gen)
    assert ring.late_pins == 1
    ring2 = _BufferRing(2, slots=1, batch=1)
    s2 = ring2.acquire(1.0)
    ring2.pin(s2, ring2.generation(s2))
    assert ring2.late_pins == 0


def test_ring_pin_after_release_still_protects():
    ring = _BufferRing(2, slots=2, batch=2)
    sid = ring.acquire(1.0)
    buf = ring.host(sid)
    ring.release(sid)
    ring.pin(sid)  # after release, as ForestCache.put at commit
    assert {ring.acquire(1.0), ring.acquire(1.0)} == {0, 1}
    assert ring.host(sid) is not buf


def test_forest_cache_put_of_streamed_square_pins_its_slot():
    """Retain a streamed square in ForestCache mid-stream and keep
    streaming until every slot recycled: the retention pinned (then
    swapped) its slot, and the retained square serves its committed bytes,
    equal to the JAX compute's."""
    k = 2
    blocks = _blocks(k, 8, seed=70)
    want = {i: JaxEDS.compute(o).data_root() for i, o in blocks}
    cache = ForestCache(heights=2, spill=2, device="cpu")
    pipe = BlockPipeline(k, depth=2, batch=1, device="cpu")
    retained = {}
    try:
        for n, (tag, ods) in enumerate(blocks, start=1):
            pipe.submit(ods, tag)
            if n <= 2:
                continue  # prime the overlap window
            got_tag, eds = pipe._drain_one()
            if got_tag == 0:
                retained[got_tag] = (cache.put(got_tag, eds), eds)
        drained = list(pipe.drain())
    finally:
        pipe.close()
    assert len(drained) == 2
    assert pipe._ring._pinned or pipe._ring.swaps
    entry, eds = retained[0]
    assert eds.data_root() == want[0]
    assert entry.line_levels("row", 0) == eds.row_tree(0, host=True).levels()


def test_stream_recycles_instead_of_allocating():
    k = 2
    pipe = BlockPipeline(k, depth=1, batch=1, device="cpu")
    ids_before = {id(h) for h in pipe._ring._hosts}
    out = []
    try:
        for n, (tag, ods) in enumerate(_blocks(k, 6, seed=90), start=1):
            pipe.submit(ods, tag)
            if n > 1:
                out.append(pipe._drain_one())
        out.extend(pipe.drain())
    finally:
        pipe.close()
    assert [t for t, _ in out] == list(range(6))
    assert {id(h) for h in pipe._ring._hosts} == ids_before
    assert pipe._ring.swaps == 0


def _fail(_odss):
    raise ValueError("injected dispatch fault")


@pytest.fixture(autouse=True)
def _rearm_the_ladder():
    """The degradation ladder is process-wide and one-way: a test whose
    fault walks it to the floor must not leave later tests on that rung."""
    yield
    degrade.reset_for_tests()


def test_dispatcher_fault_raises_from_submit_and_drain():
    """A dispatch fault that outlasts the degradation ladder (every rung's
    pipeline fails) raises from submit and drain with the cause chained."""
    k = 2
    blocks = _blocks(k, 3, seed=500)
    pipe = BlockPipeline(k, depth=1, batch=1, device="cpu")
    pipe._resolve_pipe = lambda mode: _fail
    t0 = time.monotonic()
    try:
        pipe.submit(blocks[0][1], 0)
        while pipe._error is None and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        with pytest.raises(RuntimeError) as submit_err:
            pipe.submit(blocks[1][1], 1)
        with pytest.raises(RuntimeError) as drain_err:
            list(pipe.drain())
    finally:
        pipe.close()
    assert isinstance(submit_err.value.__cause__, ValueError)
    assert isinstance(drain_err.value.__cause__, ValueError)
    assert time.monotonic() - t0 < 30
    for thread in (pipe._uploader, pipe._dispatcher):  # both stages wind down
        thread.join(timeout=10)
        assert not thread.is_alive(), thread.name


def test_stream_blocks_fault_surfaces(monkeypatch):
    """A fault of the port's pipeline, injected through the builder the
    stream uses, raises RuntimeError out of the stream, never hangs."""
    monkeypatch.setattr(port_pipeline, "_pipeline_and_state", lambda *a: (_fail, "miss"))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        list(stream_blocks(iter(_blocks(2, 6, seed=520)), 2, depth=2, batch=1, device="cpu"))
    assert isinstance(err.value.__cause__, ValueError)
    assert time.monotonic() - t0 < 30


def test_abandoned_stream_joins_its_threads(monkeypatch):
    made = []

    class Recording(BlockPipeline):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(port_pipeline, "BlockPipeline", Recording)
    gen = stream_blocks(iter(_blocks(2, 8, seed=540)), 2, depth=2, batch=2, device="cpu")
    tag, _eds = next(gen)
    gen.close()
    assert tag == 0 and len(made) == 1
    pipe = made[0]
    assert not pipe._uploader.is_alive() and not pipe._dispatcher.is_alive()
    assert pipe._ring.states()["free"] == pipe.depth + 1  # every slot back
    assert not [t for t in threading.enumerate()
                if t in (pipe._uploader, pipe._dispatcher)]


def test_stream_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockPipeline(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(stream_blocks(iter(_blocks(2, 1, seed=1)), 2))
