"""Long queries: query panels against one sweep (the card's counterpart of
tools/exp_panels.py).

    python -m opal_tpu_torch.tools.exp_panels
        [--qlens 6000,16000,34000,65000,100000] [--db-seqs 8000]
        [--mode SW] [--st 0] [--reps 2] [--check] [--device cuda|cpu]

The database: `db-seqs` random sequences of 100-699 letters over a
24-letter alphabet, the matrix +3 on the diagonal and -1 elsewhere, gaps
3/1 (np.random.default_rng(99), which then draws each query). Each query
runs through search_database_arrays in two ways, a warm-up and then the
best of `reps`, each ended by torch.cuda.synchronize():

  panel      OPAL_TPU_FORCE_PANELS=1: ragged_dp's panel role, panels of
             kernels.PANEL_ROWS rows (OPAL_TPU_PANEL_ROWS where given);
  one_sweep  OPAL_TPU_NO_PANELS=1: ragged_dp over the whole query in one
             sweep (the counterpart of opal_tpu's "legacy" lane).

opal_tpu's third lane, its XLA twin, has no counterpart: the port has no
XLA backend, and `--check` holds both lanes instead against the plain
version (Engine(device="cpu"), one sweep) on the first 4 sequences. The
two lanes must agree on every column, or the tool raises. One JSON line.
On the CPU (`--device cpu`) the plain versions run at a small size (24
sequences, queries of 40 and 70 letters in 32-row panels) and no time is
reported.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..constants import MODE_CODES
from ..engine.search import Engine, search_database_arrays
from . import CPU_BLOCK, environ, report, require, seconds

A = 24
LANES = {"panel": {"OPAL_TPU_FORCE_PANELS": "1", "OPAL_TPU_NO_PANELS": None},
         "one_sweep": {"OPAL_TPU_FORCE_PANELS": None,
                       "OPAL_TPU_NO_PANELS": "1"}}
CHECK_SEQS = 4


def panel_inputs(n_seqs: int, seed: int = 99):
    """(db, matrix, rng): the tools' long-query database and matrix, and
    the generator that goes on to draw the queries."""
    rng = np.random.default_rng(seed)
    matrix = np.full((A, A), -1, np.int32)
    np.fill_diagonal(matrix, 3)
    db = [rng.integers(0, A, rng.integers(100, 700), dtype=np.uint8)
          for _ in range(n_seqs)]
    return db, matrix, rng


def equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def run(engine, ddb, queries: dict, matrix, mode="SW", st=0, reps=2,
        check=False, panel_rows=None):
    """The protocol of the module docstring on a resident database `ddb`
    of `engine`; queries {qlen: letters}. Returns the result dict;
    "answers" holds each query's result."""
    m = MODE_CODES[mode]
    total = int(ddb.total_residues)
    rows, answers = [], {}
    for qlen, query in queries.items():
        def search():
            return search_database_arrays(query, ddb, 3, 1, matrix, mode=m,
                                          search_type=st, engine=engine)

        row, outs = {"Q": qlen}, {}
        for label, env in LANES.items():
            rows_env = panel_rows if label == "panel" else None
            with environ(OPAL_TPU_PANEL_ROWS=rows_env, **env):
                outs[label] = search()
                best = min(seconds(search) for _ in range(reps))
            row[f"{label}_s"] = best
            row[f"{label}_gcups"] = qlen * total / best / 1e9
        require(equal(outs["panel"], outs["one_sweep"]),
                f"Q={qlen}: panels differ from one sweep")
        if check:
            with environ(**LANES["one_sweep"]):
                plain = search_database_arrays(
                    query, ddb.raw[:CHECK_SEQS], 3, 1, matrix, mode=m,
                    search_type=st,
                    engine=Engine(device="cpu", block_size=CPU_BLOCK))
            require(equal(plain, {k: v[:CHECK_SEQS]
                                  for k, v in outs["panel"].items()}),
                    f"Q={qlen}: the card differs from the plain version")
            row["checked_seqs"] = CHECK_SEQS
        row["identical"] = True
        rows.append(row)
        answers[qlen] = outs["panel"]
    return {"n_db": ddb.n, "residues": total, "mode": mode, "st": st,
            "reps": reps, "xla": "no XLA variant in the port", "rows": rows,
            "answers": answers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qlens", default="6000,16000,34000,65000,100000")
    ap.add_argument("--db-seqs", type=int, default=8000)
    ap.add_argument("--mode", default="SW")
    ap.add_argument("--st", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--check", action="store_true",
                    help="hold both lanes against the plain version on the "
                         f"first {CHECK_SEQS} sequences")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import resolve_device

    dev = resolve_device(a.device)
    cpu = dev.type == "cpu"
    if cpu:
        a.db_seqs, a.qlens, a.reps = min(a.db_seqs, 24), "40,70", 1
    engine = Engine(device=str(dev), block_size=CPU_BLOCK if cpu else 1024)
    db, matrix, rng = panel_inputs(a.db_seqs)
    ddb = engine.upload(db)
    queries = {q: rng.integers(0, A, q, dtype=np.uint8)
               for q in map(int, a.qlens.split(","))}
    res = run(engine, ddb, queries, matrix, a.mode, a.st, a.reps, a.check,
              panel_rows=32 if cpu else None)
    res.pop("answers")
    report("exp_panels", dev, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
