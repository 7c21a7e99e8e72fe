"""Leopard RS parity closure tool.

The reference pins `rsmt2d.NewLeoRSCodec` (pkg/appconsts/global_consts.go:92,
dep go.mod:13) — klauspost/reedsolomon's leopard additive-FFT codec. This
repo implements the same construction as an exact linear map
(gf/leopard.py), but leopard's hardcoded Cantor-basis constants, its
index->basis bit order, and its GF(2^16) polynomial are not derivable
without the leopard source. This tool closes the question the moment ANY
externally produced evidence appears:

  1. leopard encode vectors — data shards in, parity shards out:
       {"kind": "encode_vectors", "field": 8 | 16,
        "data":   ["<hex shard>", ...],     # k shards, equal byte length
        "parity": ["<hex shard>", ...]}     # k parity shards from leopard
  2. a real celestia block's ODS + DAH:
       {"kind": "block",
        "shares":    ["<hex 512-byte share>", ...],   # row-major ODS, k*k
        "row_roots": ["<hex>", ...],                  # 2k NMT row roots
        "col_roots": ["<hex>", ...]}                  # 2k NMT column roots
     (hex values may also be given as base64 with a "b64:" prefix)

Run:
    python -m celestia_app_tpu_torch.scripts.verify_leopard_parity EVIDENCE.json
    python -m celestia_app_tpu_torch.scripts.verify_leopard_parity --selftest
    (either with --device cpu to run the square's kernels' plain versions)

Output: one JSON line reporting byte-parity under each of this repo's RS
constructions ("leopard", "vandermonde"). For encode vectors that match
NEITHER construction, a bounded search over the unverifiable degrees of
freedom runs automatically (Artin-Schreier root choice at each Cantor
chain step, grid index bit-reversal, data-half placement) and, on a hit,
prints the exact constants to pin in gf/leopard.py (FORCED_CANTOR_BASIS &
friends) — i.e. one discriminating vector both answers the parity question
and yields the fix.

The port's copy of scripts/verify_leopard_parity.py, over the port's
gf/{field,leopard,rs}.py, constants and da/eds.  Differences, all
deliberate:
  * nothing is set at import (the JAX tool pins JAX_PLATFORMS, the
    compilation cache and sys.path there);
  * `--device` (default CUDA, which raises without a card; `cpu` runs the
    kernels' plain PyTorch versions) says where block evidence is
    extended: `check_block` and the self-test's block leg run
    da/eds.ExtendedDataSquare.compute on that device where the JAX tool
    runs jit_pipeline.  The encode-vector check and the basis search are
    host numpy in both;
  * `main(argv)` takes its arguments as a list (argparse) and exits 2 with
    this text when neither a file nor --selftest is given, as the JAX
    tool does for a wrong argument count.
The JSON line is the JAX tool's, key for key.
"""

from __future__ import annotations

import argparse
import base64
import binascii
import itertools
import json
import os
import sys
import tempfile

import numpy as np

from celestia_app_tpu_torch.scripts.common import add_device_argument

CONSTRUCTIONS = ("leopard", "vandermonde")


def _unhex(s: str) -> bytes:
    if s.startswith("b64:"):
        return base64.b64decode(s[4:])
    return binascii.unhexlify(s)


# --------------------------------------------------------------------------
# Evidence kind 1: raw leopard encode vectors
# --------------------------------------------------------------------------


def _evidence_field(ev: dict, k: int) -> int:
    """The GF(2^m) the evidence was produced in. Defaults to leopard's own
    width rule (ff8 up to 256 shards, ff16 above) when the key is absent."""
    from celestia_app_tpu_torch.gf.rs import field_for_width

    m = int(ev.get("field", field_for_width(2 * k).m))
    if m not in (8, 16):
        raise ValueError(f"field must be 8 or 16, got {m}")
    if 2 * k > (1 << m):
        raise ValueError(f"2k={2 * k} shards do not fit in GF(2^{m})")
    return m


def _leopard_encode(k: int, m: int, data: np.ndarray) -> np.ndarray:
    """Leopard-construction encode honouring an explicit field choice.

    RSCodec picks the field from the width alone (leopard's rule); external
    ff16 vectors can exist at any k, so this builds the generator for the
    requested field directly from the same leopard grid."""
    from celestia_app_tpu_torch.gf.leopard import leopard_field, leopard_points

    f = leopard_field(m)
    pts = leopard_points(k, f)
    V = f.vandermonde(pts, k)
    G = f.matmul(V[k:], f.inv_matrix(V[:k]))
    sym = data if m == 8 else data.view("<u2")
    out = f.matmul(G, sym)
    return np.asarray(out, dtype=f.dtype).view(np.uint8) if m == 16 \
        else np.asarray(out, dtype=np.uint8)


def check_encode_vectors(ev: dict) -> dict:
    from celestia_app_tpu_torch.gf.rs import RSCodec, field_for_width

    data = np.stack([np.frombuffer(_unhex(s), dtype=np.uint8) for s in ev["data"]])
    parity = np.stack([np.frombuffer(_unhex(s), dtype=np.uint8) for s in ev["parity"]])
    k = data.shape[0]
    if parity.shape != data.shape:
        raise ValueError(f"data {data.shape} vs parity {parity.shape} mismatch")
    if k & (k - 1):
        raise ValueError(f"k={k} is not a power of two")
    m = _evidence_field(ev, k)
    if m == 16 and data.shape[1] % 2:
        raise ValueError("ff16 shards must have even byte length")

    out = {"kind": "encode_vectors", "k": k, "share_bytes": int(data.shape[1]),
           "field": m, "results": {}}

    def _diff_row(got: np.ndarray) -> dict:
        match = bool(np.array_equal(got, parity))
        row = {"match": match}
        if not match:
            diff = np.argwhere(got != parity)
            row["first_mismatch"] = {
                "shard": int(diff[0][0]), "byte": int(diff[0][1]),
                "got": int(got[tuple(diff[0])]), "want": int(parity[tuple(diff[0])]),
            }
            row["mismatching_bytes"] = int(len(diff))
        return row

    out["results"]["leopard"] = _diff_row(_leopard_encode(k, m, data))
    # The vandermonde construction is only defined in this repo's own
    # width-derived field; in any other field it is definitionally a miss.
    if field_for_width(2 * k).m == m:
        out["results"]["vandermonde"] = _diff_row(
            RSCodec(k, "vandermonde").encode(data))
    else:
        out["results"]["vandermonde"] = {
            "match": False,
            "note": f"repo vandermonde at k={k} lives in "
                    f"GF(2^{field_for_width(2 * k).m}), evidence is GF(2^{m})"}

    if not out["results"]["leopard"]["match"]:
        out["basis_search"] = _search_leopard_constants(ev, data, parity, m)
    return out


def _candidate_bases(m: int, r: int):
    """Every DISTINCT length-r Cantor chain prefix b_0=1, b_{j+1} in
    {x, x+1} with x^2+x=b_j, in GF(2^m).

    Only the first r basis elements touch a 2k-point grid (r = ceil(log2
    2k)), so enumerating full length-m chains would re-test one effective
    prefix 2^(m-r) times; 2^(r-1) distinct prefixes is the whole space.
    """
    from celestia_app_tpu_torch.gf.leopard import _solve_artin_schreier, leopard_field

    f = leopard_field(m)

    def chains(prefix: tuple[int, ...]):
        if len(prefix) == r:
            yield prefix
            return
        x = _solve_artin_schreier(f, prefix[-1])
        if x < 0:
            return
        for cand in (x, x ^ 1):
            if cand != 0:
                yield from chains(prefix + (cand,))

    return chains((1,))


def _extend_chain(m: int, prefix: tuple[int, ...]) -> tuple[int, ...]:
    """Deterministically continue a chain prefix to full length m (smallest
    root each step) — the grid never sees elements past the prefix, so any
    valid continuation serves for a FORCED_CANTOR_BASIS pin."""
    from celestia_app_tpu_torch.gf.leopard import _solve_artin_schreier, leopard_field

    f = leopard_field(m)
    chain = list(prefix)
    while len(chain) < m:
        x = _solve_artin_schreier(f, chain[-1])
        if x <= 0:
            break  # chain cannot continue; a short pin still fixes the grid
        chain.append(x)
    return tuple(chain)


def _search_leopard_constants(
    ev: dict, data: np.ndarray, parity: np.ndarray, m: int
) -> dict:
    """Bounded sweep over the unverifiable leopard constants."""
    from celestia_app_tpu_torch.gf.field import _field
    from celestia_app_tpu_torch.gf.leopard import LEOPARD_POLY

    k = data.shape[0]
    f = _field(m, LEOPARD_POLY[m])
    sym = data if m == 8 else data.view("<u2")
    want = parity if m == 8 else parity.view("<u2")

    tried = 0
    budget = int(ev.get("search_budget", 4096))
    r = max(1, (2 * k - 1).bit_length())
    for basis in _candidate_bases(m, r):
        for bitrev, data_low in itertools.product((False, True), repeat=2):
            tried += 1
            if tried > budget:
                return {"hit": False, "tried": tried - 1, "exhausted": False,
                        "note": f"search budget {budget} reached; rerun with "
                                f"a larger \"search_budget\" in the evidence"}
            idx = np.arange(2 * k, dtype=np.uint32)
            if bitrev:
                rev = np.zeros_like(idx)
                for j in range(r):
                    rev |= ((idx >> j) & 1) << (r - 1 - j)
                idx = rev
            omega = np.zeros(2 * k, dtype=np.uint32)
            for j in range(r):
                omega ^= np.where((idx >> j) & 1, basis[j], 0).astype(np.uint32)
            pts = (np.concatenate([omega[:k], omega[k:]]) if data_low
                   else np.concatenate([omega[k:], omega[:k]])).astype(f.dtype)
            V = f.vandermonde(pts, k)
            try:
                G = f.matmul(V[k:], f.inv_matrix(V[:k]))
            except Exception:
                continue
            if np.array_equal(f.matmul(G, sym), want):
                full = _extend_chain(m, basis)
                return {"hit": True, "tried": tried,
                        "cantor_basis": [int(b) for b in basis],
                        "full_chain": [int(b) for b in full],
                        "index_bit_reversed": bitrev, "data_half": "low" if data_low else "high",
                        "pin": f"gf/leopard.py: FORCED_CANTOR_BASIS[{m}] = "
                               f"{tuple(int(b) for b in full)}  "
                               f"# first {r} elements evidence-determined"
                               + (" + flip index bit order" if bitrev else "")
                               + (" + data on LOW grid half" if data_low else "")}
    return {"hit": False, "tried": tried, "exhausted": True,
            "note": "no basis/bit-order/half assignment reproduces these "
                    "vectors - check the field polynomial or shard layout"}


# --------------------------------------------------------------------------
# Evidence kind 2: real block ODS + DAH roots
# --------------------------------------------------------------------------


def _square_roots(ods: np.ndarray, construction: str, device) -> tuple[list, list]:
    """(row roots, column roots) as bytes of `ods` extended under
    `construction` on `device` (the JAX tool's jit_pipeline)."""
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare

    eds = ExtendedDataSquare.compute(ods, construction, device=device)
    return eds.row_roots(), eds.col_roots()


def check_block(ev: dict, device=None) -> dict:
    from celestia_app_tpu_torch.constants import SHARE_SIZE

    shares = [_unhex(s) for s in ev["shares"]]
    n = len(shares)
    k = int(round(n ** 0.5))
    if k * k != n or k & (k - 1):
        raise ValueError(f"share count {n} is not a power-of-two square")
    for i, s in enumerate(shares):
        if len(s) != SHARE_SIZE:
            raise ValueError(f"share {i}: {len(s)} bytes, want {SHARE_SIZE}")
    want_rows = [_unhex(s) for s in ev["row_roots"]]
    want_cols = [_unhex(s) for s in ev["col_roots"]]
    if len(want_rows) != 2 * k or len(want_cols) != 2 * k:
        raise ValueError(f"want 2k={2 * k} row and col roots, "
                         f"got {len(want_rows)}/{len(want_cols)}")

    ods = np.frombuffer(b"".join(shares), dtype=np.uint8).reshape(k, k, SHARE_SIZE)
    out = {"kind": "block", "k": k, "results": {}}
    for construction in CONSTRUCTIONS:
        rows, cols = _square_roots(ods, construction, device)
        row = {"match": rows == want_rows and cols == want_cols}
        if not row["match"]:
            # ODS-derived roots (rows/cols 0..k-1 use only data + parity of
            # data rows) vs parity-quadrant roots localise the divergence.
            row["first_row_mismatch"] = next(
                (i for i, (a, b) in enumerate(zip(rows, want_rows)) if a != b), None)
            row["first_col_mismatch"] = next(
                (i for i, (a, b) in enumerate(zip(cols, want_cols)) if a != b), None)
        out["results"][construction] = row
    return out


def block_evidence(ods: np.ndarray, construction: str, device=None) -> dict:
    """Block evidence ({"kind": "block", ...}, hex) of `ods` with the roots
    of its square extended under `construction` on `device`."""
    k = ods.shape[0]
    rows, cols = _square_roots(ods, construction, device)
    return {"kind": "block",
            "shares": [ods[i, j].tobytes().hex() for i in range(k) for j in range(k)],
            "row_roots": [r.hex() for r in rows],
            "col_roots": [c.hex() for c in cols]}


# --------------------------------------------------------------------------
# Self-test: synthesize evidence from this repo's own codecs and make sure
# the checker discriminates constructions on it.
# --------------------------------------------------------------------------


def selftest(device=None) -> dict:
    from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
    from celestia_app_tpu_torch.gf.rs import RSCodec

    rng = np.random.default_rng(7)
    report = {}

    # 1) encode vectors produced by our leopard construction must come back
    #    leopard-match=True, vandermonde-match=False.
    k, width = 8, 64
    data = rng.integers(0, 256, (k, width), dtype=np.uint8)
    parity = RSCodec(k, "leopard").encode(data)
    ev = {"kind": "encode_vectors", "field": 8,
          "data": [d.tobytes().hex() for d in data],
          "parity": [p.tobytes().hex() for p in parity]}
    got = check_encode_vectors(ev)
    assert got["results"]["leopard"]["match"], got
    assert not got["results"]["vandermonde"]["match"], got
    report["encode_vectors"] = "ok"

    # 2) a foreign-but-valid basis must MISS both constructions and then be
    #    FOUND by the basis search. Flip the Artin-Schreier root choice at a
    #    chain step the 2k=16 grid actually uses (step 3), then re-derive
    #    the rest of the chain from the flipped element.
    from celestia_app_tpu_torch.gf import leopard as leo
    chain = list(leo.cantor_basis(8))
    chain[3] ^= 1
    f8 = leo.leopard_field(8)
    for j in range(4, 8):
        chain[j] = leo._solve_artin_schreier(f8, chain[j - 1])
        assert chain[j] > 0, chain
    foreign = tuple(chain)
    orig_pin = leo.FORCED_CANTOR_BASIS[8]
    leo.FORCED_CANTOR_BASIS[8] = foreign
    leo.cantor_basis.cache_clear()
    try:
        parity2 = RSCodec(k, "leopard").encode(data)
    finally:
        leo.FORCED_CANTOR_BASIS[8] = orig_pin
        leo.cantor_basis.cache_clear()
    ev2 = dict(ev, parity=[p.tobytes().hex() for p in parity2])
    got2 = check_encode_vectors(ev2)
    assert not got2["results"]["leopard"]["match"], got2
    assert got2["basis_search"]["hit"], got2
    assert tuple(got2["basis_search"]["full_chain"]) == foreign, got2
    report["basis_search_recovers_foreign_basis"] = "ok"

    # 3) block evidence round-trip: roots from our own pipeline under
    #    leopard must match leopard and not vandermonde.
    k = 4
    ods = rng.integers(0, 256, (k, k, SHARE_SIZE), dtype=np.uint8)
    ns = np.sort(rng.integers(0, 64, k * k).astype(np.uint8)).reshape(k, k)
    ods[:, :, :NAMESPACE_SIZE] = 0
    ods[:, :, NAMESPACE_SIZE - 1] = ns
    got3 = check_block(block_evidence(ods, "leopard", device), device)
    assert got3["results"]["leopard"]["match"], got3
    assert not got3["results"]["vandermonde"]["match"], got3
    report["block"] = "ok"

    # 4) the file round-trip the real invocation uses.
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(ev, f)
        path = f.name
    try:
        got4 = run_file(path, device)
        assert got4["results"]["leopard"]["match"], got4
    finally:
        os.unlink(path)
    report["file_roundtrip"] = "ok"
    return {"selftest": report, "verdict": "tool discriminates constructions; "
            "feed it real leopard vectors or a real block to close parity"}


def run_file(path: str, device=None) -> dict:
    with open(path) as f:
        ev = json.load(f)
    kind = ev.get("kind")
    if kind == "encode_vectors":
        return check_encode_vectors(ev)
    if kind == "block":
        return check_block(ev, device)
    raise ValueError(f"unknown evidence kind {kind!r} "
                     "(want \"encode_vectors\" or \"block\")")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("evidence", nargs="?", help="evidence JSON file, or --selftest")
    ap.add_argument("--selftest", action="store_true",
                    help="synthesize evidence from the repo's codecs and check it")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    if args.selftest == (args.evidence is not None):
        print(__doc__, file=sys.stderr)
        return 2
    from celestia_app_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.selftest:
        out = selftest(device)
    else:
        out = run_file(args.evidence, device)
        res = out["results"]
        out["verdict"] = (
            "PARITY CLOSED: leopard construction byte-identical"
            if res["leopard"]["match"] else
            "vandermonde construction matches (unexpected for reference data)"
            if res["vandermonde"]["match"] else
            "NO MATCH: see basis_search / first_mismatch for the fix trail")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
