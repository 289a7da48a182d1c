"""Warm single-query serve latency at whole-database scale (the card's
counterpart of tools/serve_latency.py).

    python -m opal_tpu_torch.tools.serve_latency [--n-seqs 541762]
        [--qlen 110] [--top-k 10] [--reps 8] [--align] [--device cuda|cpu]

The server (opal_tpu_torch.serve.Server) holds `n-seqs` synthetic
sequences (opal_tpu_torch.synth.make_db_arrays(n, seed=12071)) resident
and answers over TCP on a free loopback port with batch_window=0. One
client sends unique queries of `qlen` residues
(np.random.default_rng(7), SW, top k, with `--align` their alignments
too), one at a time: the first builds, the second warms, then `reps`
timed requests, each from the request line written to the response line
read. Every answer must hold min(top_k, n) hits, or the tool raises.

One JSON line: min, median and max milliseconds. On the CPU (`--device
cpu`) the plain versions run at a small size (48 sequences, 2 requests of
32 residues) and no time is reported.
"""
from __future__ import annotations

import argparse
import contextlib

import numpy as np

from . import CPU_BLOCK, report, require, synth_db
from .serve_qps import connect, random_queries, request, start_server


def run(srv, qlen=110, top_k=10, reps=8, align=False, seed=7,
        around=contextlib.nullcontext):
    """The protocol of the module docstring on a Server `srv` (its resident
    database as it is); `around()` is a context entered around the timed
    requests only (a profiler, say). Returns the result dict; "answers"
    holds the hit list of each timed query."""
    alpha = srv.sm.alphabet
    qs = random_queries(np.random.default_rng(seed), alpha, reps + 2, qlen)
    n = len(srv.db)
    tcp = start_server(srv, 0.0)
    try:
        c, f = connect(tcp.server_address[1])
        with c:
            def one(q):
                dt, resp = request(f, {"id": 0, "query": q, "top_k": top_k,
                                       "align": bool(align)})
                require(len(resp.get("hits", ())) == min(top_k, n),
                        f"answer without {min(top_k, n)} hits: {resp}")
                return dt, resp["hits"]

            one(qs[0])  # builds
            one(qs[1])  # warms
            with around():
                timed = [one(q) for q in qs[2:]]
    finally:
        tcp.close()
    ms = np.array([t for t, _ in timed]) * 1e3
    return {"n_db": n, "residues": int(srv.ddb.total_residues),
            "qlen": qlen, "top_k": top_k, "align": bool(align), "reps": reps,
            "min_ms": float(ms.min()), "median_ms": float(np.median(ms)),
            "max_ms": float(ms.max()),
            "request_ms": [float(x) for x in ms],
            "answers": {q: h for q, (_, h) in zip(qs[2:], timed)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-seqs", type=int, default=541762)
    ap.add_argument("--qlen", type=int, default=110)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--align", action="store_true",
                    help="request alignment paths (score+end, then the "
                         "traceback of the top k)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import resolve_device
    from ..matrices import ScoreMatrix
    from ..serve import Server

    dev = resolve_device(a.device)
    if dev.type == "cpu":
        a.n_seqs, a.qlen, a.reps = (min(a.n_seqs, 48), min(a.qlen, 32),
                                    min(a.reps, 2))
    sm = ScoreMatrix.blosum50()
    db = synth_db(a.n_seqs, sm.letter_index())
    srv = Server.from_sequences(
        db, [f"t{i}" for i in range(len(db))], sm,
        block_size=CPU_BLOCK if dev.type == "cpu" else 1024, device=str(dev))
    res = run(srv, a.qlen, a.top_k, a.reps, a.align)
    res.pop("answers")
    report("serve_latency", dev, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
