"""JSON wire codec for RPC payloads: dataclasses <-> JSON-safe dicts.

Bytes travel as hex strings; nested dataclasses/tuples recurse. The proof
reconstructors rebuild the exact dataclass types so `verify()` runs
client-side on wire-fetched proofs (the light-client contract).

The port's copy of celestia_app_tpu/rpc/codec.py, whole, over the port's
nmt.proof, proof.share_proof and state.smt.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def to_jsonable(obj: Any) -> Any:
    if isinstance(obj, bytes):
        return obj.hex()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: to_jsonable(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    return obj


def share_proof_from_json(d: dict):
    from celestia_app_tpu_torch.nmt.proof import NmtRangeProof
    from celestia_app_tpu_torch.proof.share_proof import RowProof, ShareProof

    rp = d["row_proof"]
    row_proof = RowProof(
        row_roots=tuple(bytes.fromhex(r) for r in rp["row_roots"]),
        proofs=tuple(
            tuple(bytes.fromhex(h) for h in path) for path in rp["proofs"]
        ),
        start_row=rp["start_row"],
        end_row=rp["end_row"],
        total=rp["total"],
    )
    share_proofs = tuple(
        NmtRangeProof(
            start=p["start"],
            end=p["end"],
            nodes=tuple(bytes.fromhex(n) for n in p["nodes"]),
            total=p["total"],
        )
        for p in d["share_proofs"]
    )
    return ShareProof(
        data=tuple(bytes.fromhex(s) for s in d["data"]),
        share_proofs=share_proofs,
        namespace=bytes.fromhex(d["namespace"]),
        row_proof=row_proof,
    )


def share_proofs_from_attestation(d: dict):
    """Per-sample ShareProofs reconstructed from an attestation payload
    (serve/api.DasProvider.attestation_payload) — pure indexing into the
    deduped node tables, byte-identical to fetching each sample's
    share_proof alone.  This is BOTH the light client's reconstructor
    and the serve-side verification gate's input, so what the gate
    decides is exactly what a client would verify.

    Raises ValueError/KeyError/IndexError on malformed payloads
    (attacker-shaped input maps to a 400-class refusal, never a crash).
    """
    from celestia_app_tpu_torch.constants import (
        NAMESPACE_SIZE,
        PARITY_NAMESPACE_BYTES,
    )
    from celestia_app_tpu_torch.nmt.proof import NmtRangeProof
    from celestia_app_tpu_torch.proof.share_proof import RowProof, ShareProof

    k = d["square_size"]
    samples, shares = d["samples"], d["shares"]
    nodes = [bytes.fromhex(nd) for nd in d["nodes"]]
    root_nodes = [bytes.fromhex(nd) for nd in d["root_nodes"]]
    if len(samples) != len(shares):
        raise ValueError(
            f"{len(samples)} samples but {len(shares)} shares"
        )
    out: list[ShareProof] = []
    pos = 0
    for tree in d["trees"]:
        axis, index = tree["axis"], tree["index"]
        root = bytes.fromhex(tree["root"])
        root_path = tuple(root_nodes[j] for j in tree["root_path_refs"])
        row_proof = RowProof(
            row_roots=(root,),
            proofs=(root_path,),
            start_row=tree["root_index"],
            end_row=tree["root_index"] + 1,
            total=tree["root_total"],
        )
        if len(tree["ranges"]) != len(tree["node_refs"]):
            raise ValueError("ranges/node_refs length mismatch")
        for (start, end), refs in zip(tree["ranges"], tree["node_refs"]):
            if pos >= len(samples):
                raise ValueError("more tree ranges than samples")
            s = samples[pos]
            row, col = s["row"], s["col"]
            tree_of, leaf = (row, col) if s["axis"] == "row" else (col, row)
            if s["axis"] != axis or tree_of != index or leaf != start:
                raise ValueError(
                    f"sample {pos} ({row},{col},{s['axis']}) does not "
                    f"match tree {axis}:{index} range [{start},{end})"
                )
            share = bytes.fromhex(shares[pos])
            ns = (
                share[:NAMESPACE_SIZE]
                if row < k and col < k
                else PARITY_NAMESPACE_BYTES
            )
            out.append(ShareProof(
                data=(share,),
                share_proofs=(NmtRangeProof(
                    start=start,
                    end=end,
                    nodes=tuple(nodes[j] for j in refs),
                    total=tree["total"],
                ),),
                namespace=ns,
                row_proof=row_proof,
            ))
            pos += 1
    if pos != len(samples):
        raise ValueError(f"{len(samples) - pos} samples not covered by trees")
    return out


def state_proof_from_json(d: dict):
    from celestia_app_tpu_torch.state.smt import StateProof

    return StateProof(
        key=bytes.fromhex(d["key"]),
        value=None if d["value"] is None else bytes.fromhex(d["value"]),
        path=[(bit, bytes.fromhex(sib)) for bit, sib in d["path"]],
        leaf_kh=None if d["leaf_kh"] is None else bytes.fromhex(d["leaf_kh"]),
        leaf_vh=None if d["leaf_vh"] is None else bytes.fromhex(d["leaf_vh"]),
    )
