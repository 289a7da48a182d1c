"""The host traceback's thread scaling (the card's counterpart of
tools/tb_scaling.py).

    python -m opal_tpu_torch.tools.tb_scaling [--n-pairs 4000]
        [--workers 1,2,4] [--query P18080] [--mode SW] [--device cuda|cpu]

Times the host stage of alignment_pass alone (the banded C fill and walk,
opal_tpu_torch._native, one traceback per thread) at each
OPAL_TPU_TRACEBACK_WORKERS setting. The exact score and end of every pair
come from the committed x1 golden file of the reference binary
(tests/golden_large/<query>__synth12071__<mode>_x1_o3_e1.txt.gz), the
database from tests/data/synth12071.fasta.gz and the query from
tests/port_data, so no search runs; the `n-pairs` best-scoring pairs are
aligned. Every worker count must give the same alignments, or the tool
raises. One JSON line, with the host's CPU count.

The stage runs on the host; the device is named only to keep the tools'
contract: "cuda" (the default) needs a card, and `--device cpu` runs a
small size (64 pairs, workers 1 and 2) and reports no time.
"""
from __future__ import annotations

import argparse
import gzip
import os
import re
from pathlib import Path

from .. import _native
from ..constants import MODE_CODES
from ..engine.search import alignment_pass
from ..result import SearchResult
from . import environ, port_query, report, require, seconds

REPO = Path(__file__).resolve().parents[2]
LINE = re.compile(r"^#(\d+): (-?\d+) \(\?, \?\) \((-?\d+), (-?\d+)\)")


def golden_x1(query: str, mode: str) -> dict:
    """{db index: (score, end_q, end_t)} of the x1 golden file."""
    path = (REPO / "tests" / "golden_large"
            / f"{query}__synth12071__{mode}_x1_o3_e1.txt.gz")
    out = {}
    with gzip.open(path, "rt") as f:
        for ln in f:
            m = LINE.match(ln)
            if m:
                i, score, eq, et = map(int, m.groups())
                out[i] = (score, eq, et)
    return out


def _fresh(x1, cand):
    res = {}
    for i in cand:
        r = res[i] = SearchResult()
        r.set_score(x1[i][0])
        r.end_location_query, r.end_location_target = x1[i][1:]
    return res


def _paths(res, cand):
    return [(res[i].start_location_query, res[i].start_location_target,
             None if res[i].alignment is None else bytes(res[i].alignment))
            for i in cand]


def run(query, db, x1: dict, matrix, mode="SW", workers=(1, 2, 4),
        n_pairs=4000, device="cuda"):
    """alignment_pass over the `n_pairs` best of `x1` ({db index: (score,
    end_q, end_t)}) at each worker count. Returns the result dict;
    "answers" holds the alignments (start_q, start_t, path bytes) in the
    order of the pairs."""
    m = MODE_CODES[mode]
    cand = sorted(x1, key=lambda i: (-x1[i][0], i))[:n_pairs]
    cells = sum(len(db[i]) * len(query) for i in cand)
    rows, first = [], None
    for w in workers:
        with environ(OPAL_TPU_TRACEBACK_WORKERS=w):
            res = _fresh(x1, cand)
            dt = seconds(lambda: alignment_pass(query, db, 3, 1, matrix, m,
                                                res, list(cand),
                                                device=device))
        paths = _paths(res, cand)
        if first is None:
            first, base = paths, dt
        require(paths == first, f"workers={w}: the alignments differ from "
                                f"workers={workers[0]}")
        rows.append({"workers": w, "pass_s": dt,
                     "pairs_per_s": len(cand) / dt,
                     "aligned": sum(p[2] is not None for p in paths),
                     "speedup": base / dt})
    return {"pairs": len(cand), "full_matrix_cells": cells,
            "qlen": len(query), "mode": mode, "cpu_count": os.cpu_count(),
            "native": _native.available(), "rows": rows, "identical": True,
            "answers": first}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-pairs", type=int, default=4000)
    ap.add_argument("--workers", default="1,2,4")
    ap.add_argument("--query", default="P18080")
    ap.add_argument("--mode", default="SW")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import resolve_device
    from ..fasta import read_fasta_file
    from ..matrices import ScoreMatrix

    dev = resolve_device(a.device)
    if dev.type == "cpu":
        a.n_pairs, a.workers = min(a.n_pairs, 64), "1,2"
    sm = ScoreMatrix.blosum50()
    lut = sm.letter_index()
    db, _ = read_fasta_file(
        str(REPO / "tests" / "data" / "synth12071.fasta.gz"), lut)
    res = run(port_query(a.query, lut), db, golden_x1(a.query, a.mode),
              sm.matrix, a.mode, [int(w) for w in a.workers.split(",")],
              a.n_pairs, dev)
    res.pop("answers")
    res["query"] = a.query
    report("tb_scaling", dev, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
