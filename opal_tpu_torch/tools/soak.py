"""Randomized differential soak of the DP kernels against the scalar oracle.

The card's counterpart of the repository's tools/soak.py (its score and
score+end trials and its stacked multi-query trials). Each trial draws a
random problem and checks the port's search against opal_tpu_torch.oracle
(numpy, int64, full matrices):

- an alphabet of 2..24 letters and a matrix: match/mismatch, uniform
  random, or entries near the int32 bound the backend derives
  (backend.UPPER_BOUND: Q (M + ge) just under 2^31, so scores reach past
  2^30);
- a gap pair: go >= ge, go == ge, ge > go, or 0/0;
- a query length from a pool at the strip (16 rows) and strip-group (8
  strips) edges, 1 to 300 residues;
- a database of 10..100 sequences mixing block-edge lengths (1, 2, 3, 4,
  63..65, 127..129) with random ones up to 260, so blocks hold lanes of
  very different lengths;
- "single" trials: one query in one of the 4 modes, score or score+end,
  through search_database (ragged_dp on the card);
- "multi" trials: 2..8 queries stacked through search_database_multi_arrays
  (multi_dp on the card), each against its own oracle.

Scores must be equal, and so must end locations at score+end depth (the
oracle's tie-break: smallest end_t, then smallest end_q), except SW's
score-0 ends, which the API reports as (-1, -1) and the oracle as none.

    python -m opal_tpu_torch.tools.soak [--trials 200] [--seed 0]
        [--device cuda] [--block-size 64]

prints one JSON line (trials, failures, the first failing trial's seed
and problem, launches of each kernel, seconds) and exits 1 on a failure.
The gap pair ge > go runs the oracle's cell loop, so those trials are kept
small.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from ..oracle import search_oracle

MODES = (MODE_NW, MODE_HW, MODE_OV, MODE_SW)
Q_POOL = (1, 2, 15, 16, 17, 64, 110, 127, 128, 129, 300)
EDGE_LENS = (1, 2, 3, 4, 63, 64, 65, 127, 128, 129)


def random_matrix(rng, Q, ge):
    """(A, matrix [A, A] int32, kind)."""
    A = int(rng.integers(2, 25))
    kind = rng.random()
    if kind < 0.35:
        m = np.full((A, A), int(rng.integers(-8, 1)), np.int32)
        np.fill_diagonal(m, int(rng.integers(1, 14)))
        return A, m, "match"
    if kind < 0.8:
        return A, rng.integers(-8, 13, size=(A, A)).astype(np.int32), \
            "uniform"
    # entries up to M, with Q (M + ge) just under 2^31: the derived bound
    M = min(2**30 - 1, (2**31 - 1) // Q - ge - 1)
    m = rng.integers(-M, M + 1, size=(A, A)).astype(np.int64)
    np.fill_diagonal(m, M)
    return A, m.astype(np.int32), "large"


def random_gaps(rng):
    r = rng.random()
    if r < 0.65:
        go = int(rng.integers(1, 14))
        return go, int(rng.integers(1, go + 1))
    if r < 0.8:
        go = int(rng.integers(1, 10))
        return go, go
    if r < 0.9:
        ge = int(rng.integers(2, 12))
        return int(rng.integers(1, ge)), ge
    return 0, 0


def random_db(rng, n, A, max_len):
    lens = [int(rng.choice(EDGE_LENS)) if rng.random() < 0.35
            else int(rng.integers(1, max_len + 1)) for _ in range(n)]
    return [rng.integers(0, A, size=L, dtype=np.uint8) for L in lens]


def _check(got_score, got_eq, got_et, want, mode, track_end, where):
    """None, or what differs between the port's answers and the oracle's."""
    for i, w in enumerate(want):
        if int(got_score[i]) != w.score:
            return f"{where} seq {i}: score {int(got_score[i])} != {w.score}"
        if track_end and not (mode == MODE_SW and w.score == 0):
            got = (int(got_eq[i]), int(got_et[i]))
            if got != (w.end_location_query, w.end_location_target):
                return (f"{where} seq {i}: end {got} != "
                        f"{(w.end_location_query, w.end_location_target)}")
    return None


def run_trial(seed, engine):
    """(kind, problem, failure or None) of one trial."""
    from ..engine.search import search_database, search_database_multi_arrays

    rng = np.random.default_rng(seed)
    go, ge = random_gaps(rng)
    small = ge > go  # the oracle's cell loop
    multi = rng.random() < 0.4
    pool = [q for q in Q_POOL if q <= (64 if small else 300)]
    n_q = int(rng.integers(2, 9)) if multi else 1
    qlens = [int(rng.choice(pool)) for _ in range(n_q)]
    A, matrix, mkind = random_matrix(rng, max(qlens), ge)
    queries = [rng.integers(0, A, size=q, dtype=np.uint8) for q in qlens]
    db = random_db(rng, int(rng.integers(10, 30 if small else 100)), A,
                   120 if small else 260)
    mode = int(rng.choice(MODES))
    st = SEARCH_SCORE if rng.random() < 0.5 else SEARCH_SCORE_END
    track_end = st != SEARCH_SCORE
    problem = {"seed": int(seed), "mode": mode, "x": int(st), "go": go,
               "ge": ge, "A": A, "matrix": mkind, "queries": qlens,
               "sequences": len(db)}
    if multi:
        outs = search_database_multi_arrays(queries, db, go, ge, matrix,
                                            mode=mode, search_type=st,
                                            engine=engine)
        for k, (q, out) in enumerate(zip(queries, outs)):
            bad = _check(out["score"], out.get("end_q"), out.get("end_t"),
                         search_oracle(q, db, go, ge, matrix, mode, st),
                         mode, track_end, f"query {k}")
            if bad:
                return "multi", problem, bad
        return "multi", problem, None
    res = search_database(queries[0], db, go, ge, matrix, mode=mode,
                          search_type=st, engine=engine)
    bad = _check([r.score for r in res],
                 [r.end_location_query for r in res],
                 [r.end_location_target for r in res],
                 search_oracle(queries[0], db, go, ge, matrix, mode, st),
                 mode, track_end, "single")
    return "single", problem, bad


def run(trials=200, seed=0, device="cuda", block_size=64):
    """The soak as a dict (see the module docstring)."""
    from ..engine import kernels
    from ..engine.search import Engine, resolve_device

    dev = resolve_device(device)
    engine = Engine(device=dev, block_size=block_size)
    kernels.reset_counts()
    t0 = time.perf_counter()
    kinds = {"single": 0, "multi": 0}
    matrices = {"match": 0, "uniform": 0, "large": 0}
    failures, first = 0, None
    for s in np.random.SeedSequence(seed).generate_state(trials):
        kind, problem, bad = run_trial(int(s), engine)
        kinds[kind] += 1
        matrices[problem["matrix"]] += 1
        if bad:
            failures += 1
            first = first or dict(problem, failure=bad)
    out = {"tool": "soak", "device": str(dev), "trials": trials,
           "seed": seed, "failures": failures, "kinds": kinds,
           "matrices": matrices, "launches": dict(kernels.LAUNCHES),
           "plain_calls": dict(kernels.PLAIN_CALLS),
           "seconds": time.perf_counter() - t0}
    if first:
        out["first_failure"] = first
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--block-size", type=int, default=64)
    a = ap.parse_args(argv)
    res = run(a.trials, a.seed, a.device, a.block_size)
    print(json.dumps(res), flush=True)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
