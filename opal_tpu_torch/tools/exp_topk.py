"""The device top k against the whole result table ranked on the host (the
card's counterpart of tools/exp_topk.py).

    python -m opal_tpu_torch.tools.exp_topk [--n-seqs 541762] [--top-k 10]
        [--reps 4] [--device cuda|cpu]

`n-seqs` synthetic sequences (opal_tpu_torch.synth, seed 12071) are held
resident. For random queries of 110 and 513 residues
(np.random.default_rng(1)), SW at x0 and x1 (BLOSUM50, gaps 3/1), two
paths of search_database_arrays:

  full  the whole table copied to the host, ranked by rank_scores;
  topk  top_k=k: the k best selected on the card (engine/ranked.py), only
        they copied.

Both must give the same rows (indices, scores and, at x1, ends), or the
tool raises. Each path's time is the best of `reps` after a warm-up,
ended by torch.cuda.synchronize(). One JSON line. On the CPU (`--device
cpu`) the plain versions run at a small size (48 sequences, queries of 24
and 40 residues) and no time is reported.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..constants import MODE_SW, SEARCH_SCORE, SEARCH_SCORE_END
from ..engine.search import search_database_arrays
from ..ranking import rank_scores
from . import CPU_BLOCK, report, require, seconds, synth_db


def run(engine, ddb, matrix, top_k=10, reps=4, qlens=(110, 513), seed=1):
    """The protocol of the module docstring on a resident database `ddb`
    of `engine`. Returns the result dict; "answers" holds each case's
    top-k rows."""
    rng = np.random.default_rng(seed)
    total = int(ddb.total_residues)
    rows, answers = [], {}
    for qlen in qlens:
        query = rng.integers(0, 20, size=qlen, dtype=np.uint8)
        for st, tag in ((SEARCH_SCORE, "x0"), (SEARCH_SCORE_END, "x1")):
            def full():
                return search_database_arrays(
                    query, ddb, 3, 1, matrix, mode=MODE_SW, search_type=st,
                    engine=engine)

            def topk():
                return search_database_arrays(
                    query, ddb, 3, 1, matrix, mode=MODE_SW, search_type=st,
                    engine=engine, top_k=top_k)

            whole, best = full(), topk()
            order = rank_scores(whole["score"], top_k)
            for col in best:
                want = order if col == "index" else whole[col][order]
                require(np.array_equal(best[col], want),
                        f"Q={qlen} {tag}: the device top k's {col} differs "
                        "from the host ranking")
            answers[(qlen, tag)] = best
            t_full = min(seconds(full) for _ in range(reps))
            t_topk = min(seconds(topk) for _ in range(reps))
            rows.append({"Q": qlen, "search": tag, "full_s": t_full,
                         "topk_s": t_topk,
                         "full_gcups": qlen * total / t_full / 1e9,
                         "topk_gcups": qlen * total / t_topk / 1e9,
                         "speedup": t_full / t_topk, "identical": True})
    return {"n_db": ddb.n, "residues": total, "top_k": top_k, "reps": reps,
            "rows": rows, "answers": answers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-seqs", type=int, default=541762)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import Engine, resolve_device
    from ..matrices import ScoreMatrix

    dev = resolve_device(a.device)
    engine = Engine(device=str(dev),
                    block_size=CPU_BLOCK if dev.type == "cpu" else 1024)
    qlens = (110, 513)
    if dev.type == "cpu":
        a.n_seqs, a.reps, qlens = min(a.n_seqs, 48), 1, (24, 40)
    sm = ScoreMatrix.blosum50()
    ddb = engine.upload(synth_db(a.n_seqs, sm.letter_index()))
    res = run(engine, ddb, sm.matrix, a.top_k, a.reps, qlens)
    res.pop("answers")
    report("exp_topk", engine.device, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
