"""Query panels on a 1-device mesh against no mesh (the card's counterpart
of tools/exp_panel_mesh.py).

    python -m opal_tpu_torch.tools.exp_panel_mesh [--q 16000]
        [--nseq 3000] [--reps 3] [--mode SW] [--x 0] [--device cuda|cpu]

A random query of `q` letters and `nseq` random sequences of 200-1799
letters (np.random.default_rng(11), 20 letters of a 24-letter alphabet,
the matrix +5 on the diagonal and -2 elsewhere, gaps 3/1). Under
OPAL_TPU_FORCE_PANELS=1 the query runs through search_database_arrays on
an Engine without a mesh and on one whose database is a 1-device mesh
(parallel.shard.db_mesh([device])), each a warm-up and then the best of
`reps`, ended by torch.cuda.synchronize(). Both must give identical
results, or the tool raises. One JSON line. On the CPU (`--device cpu`)
the plain versions run at a small size (24 sequences, q 70 in 32-row
panels) and no time is reported.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..constants import MODE_CODES, SEARCH_SCORE, SEARCH_SCORE_END
from ..engine.search import Engine, search_database_arrays
from ..parallel.shard import db_mesh
from . import CPU_BLOCK, environ, report, require, seconds
from .exp_panels import equal


def mesh_inputs(q: int, nseq: int, seed: int = 11):
    """(query, db, matrix) of the module docstring."""
    rng = np.random.default_rng(seed)
    matrix = np.full((24, 24), -2, np.int32)
    np.fill_diagonal(matrix, 5)
    query = rng.integers(0, 20, size=q, dtype=np.uint8)
    db = [rng.integers(0, 20, size=int(rng.integers(200, 1800)),
                       dtype=np.uint8) for _ in range(nseq)]
    return query, db, matrix


def run(device, db, query, matrix, reps=3, mode="SW", x=0,
        block_size=1024, panel_rows=None):
    """The A/B of the module docstring on `device`. Returns the result
    dict; "answers" holds the result (equal in both)."""
    m = MODE_CODES[mode]
    st = SEARCH_SCORE_END if x else SEARCH_SCORE
    cells = len(query) * sum(len(s) for s in db)
    res, outs = {"n_db": len(db), "Q": len(query), "mode": mode, "x": x,
                 "reps": reps}, {}
    with environ(OPAL_TPU_FORCE_PANELS="1", OPAL_TPU_NO_PANELS=None,
                 OPAL_TPU_PANEL_ROWS=panel_rows):
        for label, mesh in (("mesh_none", None),
                            ("mesh_1dev", db_mesh([device]))):
            engine = Engine(device=str(device), block_size=block_size,
                            mesh=mesh)
            ddb = engine.upload(db)

            def search():
                return search_database_arrays(query, ddb, 3, 1, matrix,
                                              mode=m, search_type=st,
                                              engine=engine)

            outs[label] = search()
            best = min(seconds(search) for _ in range(reps))
            res[f"{label}_s"] = best
            res[f"{label}_gcups"] = cells / best / 1e9
    require(equal(outs["mesh_none"], outs["mesh_1dev"]),
            "a 1-device mesh differs from no mesh")
    if torch.device(device).type == "cuda":
        res["time_ratio"] = res["mesh_1dev_s"] / res["mesh_none_s"]
    res.update(identical=True, answers=outs["mesh_none"])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--q", type=int, default=16000)
    ap.add_argument("--nseq", type=int, default=3000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mode", default="SW")
    ap.add_argument("--x", type=int, default=0, choices=(0, 1))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import resolve_device

    dev = resolve_device(a.device)
    cpu = dev.type == "cpu"
    if cpu:
        a.q, a.nseq, a.reps = min(a.q, 70), min(a.nseq, 24), 1
    query, db, matrix = mesh_inputs(a.q, a.nseq)
    res = run(dev, db, query, matrix, a.reps, a.mode, a.x,
              CPU_BLOCK if cpu else 1024, 32 if cpu else None)
    res.pop("answers")
    report("exp_panel_mesh", dev, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
