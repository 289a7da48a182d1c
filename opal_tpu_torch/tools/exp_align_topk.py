"""The alignment pass's cost at whole-database scale (the card's
counterpart of tools/exp_align_topk.py).

    python -m opal_tpu_torch.tools.exp_align_topk [--n-seqs 541762]
        [--top-k 1000] [--qlen 513] [--device cuda|cpu]

`n-seqs` synthetic sequences (opal_tpu_torch.synth, seed 12071) are held
resident; a random query of `qlen` residues (np.random.default_rng(1)) is
searched SW (BLOSUM50, gaps 3/1) through search_database:

  x1  score and end (the SearchResult list built);
  x2  the same, then the alignment paths of the top k (align_top_k=k,
      reconstructed on the host unless OPAL_TPU_DEVICE_FILL=1).

Each is the best of 2, ended by torch.cuda.synchronize(); their
difference is the alignment pass's marginal cost. Then its two stages
alone on the x2 results: the ranking (rank_scores) and alignment_pass
over the k winners. The x2 results must keep x1's scores and ends, or the
tool raises. One JSON line. On the CPU (`--device cpu`) the plain
versions run at a small size (48 sequences, qlen 40, top 20) and no time
is reported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..constants import MODE_SW, SEARCH_ALIGNMENT, SEARCH_SCORE_END
from ..engine.search import alignment_pass, search_database
from ..ranking import rank_scores
from . import CPU_BLOCK, report, require, seconds, synth_db


def run(engine, ddb, matrix, top_k=1000, qlen=513, seed=1):
    """The protocol of the module docstring on a resident database `ddb`
    of `engine`. Returns the result dict; "answers" holds the aligned
    winners' (index, score, start_q, start_t, end_q, end_t, path bytes)."""
    query = np.random.default_rng(seed).integers(0, 20, size=qlen,
                                                 dtype=np.uint8)
    db = ddb.raw

    def timed(**kw):
        out = {}

        def one():
            out["res"] = search_database(query, ddb, 3, 1, matrix,
                                         mode=MODE_SW, engine=engine, **kw)

        return min(seconds(one) for _ in range(2)), out["res"]

    t1, res1 = timed(search_type=SEARCH_SCORE_END)
    t2, res = timed(search_type=SEARCH_ALIGNMENT, align_top_k=top_k)
    require(all((a.score, a.end_location_query, a.end_location_target)
                == (b.score, b.end_location_query, b.end_location_target)
                for a, b in zip(res1, res)),
            "x2 changed a score or an end of x1")
    aligned = [i for i, r in enumerate(res) if r.alignment is not None]

    all_scores = np.array([r.score if r.score_set else -(2**62)
                           for r in res])
    t0 = time.perf_counter()
    cand = sorted(rank_scores(all_scores, top_k).tolist())
    t_rank = time.perf_counter() - t0
    t_align = seconds(lambda: alignment_pass(
        query, db, 3, 1, matrix, MODE_SW, res, cand, device=engine.device))
    return {
        "n_db": ddb.n, "residues": int(ddb.total_residues), "qlen": qlen,
        "top_k": top_k, "x1_s": t1, "x2_s": t2, "marginal_s": t2 - t1,
        "paths": len(aligned), "paths_per_s": len(aligned) / max(t2 - t1,
                                                                 1e-9),
        "rank_s": t_rank, "alignment_pass_s": t_align,
        "pairs_per_s": len(cand) / t_align,
        "answers": [(i, res[i].score, res[i].start_location_query,
                     res[i].start_location_target, res[i].end_location_query,
                     res[i].end_location_target, bytes(res[i].alignment))
                    for i in aligned]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-seqs", type=int, default=541762)
    ap.add_argument("--top-k", type=int, default=1000)
    ap.add_argument("--qlen", type=int, default=513)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import Engine, resolve_device
    from ..matrices import ScoreMatrix

    dev = resolve_device(a.device)
    engine = Engine(device=str(dev),
                    block_size=CPU_BLOCK if dev.type == "cpu" else 1024)
    if dev.type == "cpu":
        a.n_seqs, a.qlen, a.top_k = (min(a.n_seqs, 48), min(a.qlen, 40),
                                     min(a.top_k, 20))
    sm = ScoreMatrix.blosum50()
    ddb = engine.upload(synth_db(a.n_seqs, sm.letter_index()))
    res = run(engine, ddb, sm.matrix, a.top_k, a.qlen)
    res.pop("answers")
    report("exp_align_topk", engine.device, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
