"""Performance suite: the four modes for the reference's benchmark queries,
seconds and GCUPS per configuration (the card's counterpart of
tools/perf.py, itself the reference's test/perf harness).

    python -m opal_tpu_torch.tools.perf [--db FASTA] [--n-seqs 541762]
        [--modes SW,NW,HW,OV] [--block-size 1024] [--repeats 3]
        [--search-type 0|1] [--multi] [--device cuda|cpu]

The reference times O74807, P19930, Q3ZAI3 and P18080; the repository
holds O74807 and P18080 (tests/port_data), so those two run and the line
names the two that are missing. The database is `--db` (a FASTA file) or
`n-seqs` synthetic sequences (opal_tpu_torch.synth, seed 12071), held
resident. Each query in each mode (BLOSUM50, gaps 3/1, search type 0 or 1)
runs through search_database_arrays once to warm up, then `repeats`
times, each ended by torch.cuda.synchronize(); the best counts. With
`--multi`, the queries also run stacked in one pass per mode
(search_database_multi_arrays), against the sum of their own rows; the
stacked results must equal the single ones, or the tool raises.

One JSON line. On the CPU (`--device cpu`) the plain versions run at a
small size (48 sequences in blocks of 16, SW and NW) and no time is
reported.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..constants import MODE_CODES, SEARCH_SCORE, SEARCH_SCORE_END
from ..engine.search import (search_database_arrays,
                             search_database_multi_arrays)
from . import (CPU_BLOCK, PORT_DATA, port_query, report, require, seconds,
               synth_db)

QUERIES = ("O74807", "P19930", "Q3ZAI3", "P18080")  # the reference's


def run(engine, ddb, queries: dict, matrix, modes=("SW", "NW", "HW", "OV"),
        repeats=3, search_type=SEARCH_SCORE, multi=False):
    """The protocol of the module docstring on a resident database `ddb`
    of `engine`; queries {name: alphabet indices}. Returns the result
    dict; "answers" holds each query's result by mode."""
    total = int(ddb.total_residues)
    rows, stacked, answers, seq = [], [], {}, {}
    for qname, query in queries.items():
        for mode_name in modes:
            mode = MODE_CODES[mode_name]

            def one():
                return search_database_arrays(
                    query, ddb, 3, 1, matrix, mode=mode,
                    search_type=search_type, engine=engine)

            answers[(qname, mode_name)] = one()  # warm
            best = min(seconds(one) for _ in range(repeats))
            seq[mode_name] = seq.get(mode_name, 0.0) + best
            rows.append({"query": qname, "query_len": len(query),
                         "mode": mode_name, "best_s": best,
                         "gcups": total * len(query) / best / 1e9,
                         "seqs_per_s": ddb.n / best})
    if multi:
        qs = list(queries.values())
        cells = total * sum(len(q) for q in qs)
        for mode_name in modes:
            mode = MODE_CODES[mode_name]

            def group():
                return search_database_multi_arrays(
                    qs, ddb, 3, 1, matrix, mode=mode,
                    search_type=search_type, engine=engine)

            outs = group()
            for qname, out in zip(queries, outs):
                want = answers[(qname, mode_name)]
                require(all(np.array_equal(out[k], want[k]) for k in want),
                        f"{qname} {mode_name}: stacked differs from single")
            best = min(seconds(group) for _ in range(repeats))
            stacked.append({"stacked": list(queries), "mode": mode_name,
                            "best_s": best, "gcups": cells / best / 1e9,
                            "sequential_s": seq[mode_name],
                            "speedup": seq[mode_name] / best})
    res = {"n_db": ddb.n, "residues": total, "search_type": search_type,
           "queries": list(queries),
           "missing": [q for q in QUERIES if q not in queries],
           "rows": rows, "answers": answers}
    if multi:
        res["stacked"] = stacked
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db", default=None, help="FASTA database (default: "
                                               "synthetic)")
    ap.add_argument("--n-seqs", type=int, default=541762)
    ap.add_argument("--modes", default="SW,NW,HW,OV")
    ap.add_argument("--block-size", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--search-type", type=int, default=0, choices=(0, 1),
                    help="0 = score only (the reference's protocol), "
                         "1 = score and end")
    ap.add_argument("--multi", action="store_true",
                    help="also run the queries stacked in one pass per mode")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import Engine, resolve_device
    from ..fasta import read_fasta_file
    from ..matrices import ScoreMatrix

    dev = resolve_device(a.device)
    engine = Engine(device=str(dev),
                    block_size=CPU_BLOCK if dev.type == "cpu"
                    else a.block_size)
    if dev.type == "cpu":
        a.n_seqs, a.modes, a.repeats = min(a.n_seqs, 48), "SW,NW", 1
    sm = ScoreMatrix.blosum50()
    lut = sm.letter_index()
    db = (read_fasta_file(a.db, lut)[0] if a.db
          else synth_db(a.n_seqs, lut))
    ddb = engine.upload(db)
    queries = {q: port_query(q, lut) for q in QUERIES
               if (PORT_DATA / f"{q}.fasta").exists()}
    st = SEARCH_SCORE if a.search_type == 0 else SEARCH_SCORE_END
    res = run(engine, ddb, queries, sm.matrix, a.modes.split(","),
              a.repeats, st, a.multi)
    res.pop("answers")
    report("perf", engine.device, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
