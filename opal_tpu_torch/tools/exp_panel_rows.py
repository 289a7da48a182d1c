"""The panel height swept (the card's counterpart of
tools/exp_panel_rows.py).

    python -m opal_tpu_torch.tools.exp_panel_rows [--q 16000]
        [--db-seqs 8000] [--mode SW] [--st 0]
        [--rows default,1504,1024,768,512,256] [--reps 4]
        [--device cuda|cpu]

exp_panels' database and matrix (np.random.default_rng(99), which then
draws the query of `q` letters). Under OPAL_TPU_FORCE_PANELS=1 the query
runs through search_database_arrays at each OPAL_TPU_PANEL_ROWS of
`rows` ("default": unset, kernels.PANEL_ROWS), read at dispatch; the
heights take turns, `reps` rounds of them, each run ended by
torch.cuda.synchronize(), and the best of all rounds but the first
counts. Every height must give the same results, or the tool raises. One
JSON line. On the CPU (`--device cpu`) the plain versions run at a small
size (24 sequences, q 70, rows default/48/32/16, 2 rounds) and no time is
reported.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..constants import MODE_CODES
from ..engine import backend
from ..engine.search import Engine, search_database_arrays
from . import CPU_BLOCK, environ, report, require, seconds
from .exp_panels import A, equal, panel_inputs


def run(engine, ddb, query, matrix, rows=("default", 1504, 1024, 768, 512,
                                          256), reps=4, mode="SW", st=0):
    """The sweep of the module docstring on a resident database `ddb` of
    `engine`. Returns the result dict; "answers" holds the result (equal
    at every height)."""
    m = MODE_CODES[mode]
    cells = len(query) * int(ddb.total_residues)
    runs = {r: [] for r in rows}
    ref = None
    with environ(OPAL_TPU_FORCE_PANELS="1", OPAL_TPU_NO_PANELS=None):
        for _ in range(reps):
            for r in rows:
                out = {}
                with environ(OPAL_TPU_PANEL_ROWS=None if r == "default"
                             else r):
                    dt = seconds(lambda: out.update(search_database_arrays(
                        query, ddb, 3, 1, matrix, mode=m, search_type=st,
                        engine=engine)))
                    panels = len(backend.panel_plan(len(query)))
                if ref is None:
                    ref = out
                require(equal(out, ref), f"rows={r}: results differ")
                runs[r].append((dt, panels))
    points = [{"rows": r, "panels": runs[r][0][1],
               "best_s": min(t for t, _ in runs[r][1:] or runs[r]),
               "all_s": [t for t, _ in runs[r]]} for r in rows]
    for p in points:
        p["gcups"] = cells / p["best_s"] / 1e9
    return {"n_db": ddb.n, "residues": int(ddb.total_residues),
            "Q": len(query), "mode": mode, "st": st, "reps": reps,
            "points": points, "identical": True, "answers": ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--q", type=int, default=16000)
    ap.add_argument("--db-seqs", type=int, default=8000)
    ap.add_argument("--mode", default="SW")
    ap.add_argument("--st", type=int, default=0)
    ap.add_argument("--rows", default="default,1504,1024,768,512,256")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import resolve_device

    dev = resolve_device(a.device)
    cpu = dev.type == "cpu"
    if cpu:
        a.db_seqs, a.q, a.rows, a.reps = (min(a.db_seqs, 24), min(a.q, 70),
                                          "default,48,32,16", 2)
    engine = Engine(device=str(dev), block_size=CPU_BLOCK if cpu else 1024)
    db, matrix, rng = panel_inputs(a.db_seqs)
    ddb = engine.upload(db)
    query = rng.integers(0, A, a.q, dtype=np.uint8)
    rows = [r if r == "default" else int(r) for r in a.rows.split(",")]
    res = run(engine, ddb, query, matrix, rows, a.reps, a.mode, a.st)
    res.pop("answers")
    report("exp_panel_rows", dev, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
