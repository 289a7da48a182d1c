"""Where a search's time goes: x0 against x1 end to end, and each search
split into its parts (the card's counterpart of tools/exp_x1_gap.py).

    python -m opal_tpu_torch.tools.exp_x1_gap [--n-seqs 541762]
        [--queries P18080,O74807] [--modes SW,NW,HW,OV] [--repeats 3]
        [--device cuda|cpu]

`n-seqs` synthetic sequences (opal_tpu_torch.synth, seed 12071) are held
resident; each query of tests/port_data runs in each mode (BLOSUM50, gaps
3/1):

- x0 and x1 end to end through search_database_arrays, one warm-up, then
  the best of `repeats`, each ended by torch.cuda.synchronize();
- the x1 search split into the steps of Engine.score_blocks, with a
  torch.cuda.synchronize() at each boundary (best of `repeats`, each part
  on its own): the query profile built and copied to the card
  (prepare_query), the launches enqueued (dispatch_many returns), the
  card's work after that (the synchronize), the panel merge or finalize
  and the copy to the host (collect_many), and the host's assembly of the
  result arrays in database order;
- the download modelled: the x1 result's bytes (three int32 columns per
  sequence) over the device-to-host rate of one transfer of that size,
  measured alone.

One JSON line, a row per query and mode. On the CPU (`--device cpu`) the
plain versions run at a small size (48 sequences, O74807 only, SW and NW)
and no time is reported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..constants import MODE_CODES, SEARCH_SCORE, SEARCH_SCORE_END
from ..engine.search import _finish_cols, search_database_arrays
from . import (CPU_BLOCK, port_query, report, require, seconds, sync,
               synth_db)


def link_rate(dev, nbytes: int, reps: int = 3) -> dict:
    """The best device-to-host seconds of one `nbytes` transfer, and its
    rate in bytes per second."""
    buf = torch.ones(max(1, nbytes // 4), dtype=torch.int32, device=dev)
    buf.cpu()
    best = min(seconds(buf.cpu) for _ in range(reps))
    return {"bytes": nbytes, "d2h_s": best, "d2h_bytes_per_s": nbytes / best}


def split_x1(engine, ddb, query, matrix, mode, repeats=3):
    """The x1 search of `query` split into its parts (module docstring):
    {part: best seconds}, and the result columns in database order."""
    be = engine._backend
    dev = engine.device
    qprofile = np.ascontiguousarray(
        np.asarray(matrix, np.int32)[np.asarray(query, np.int64)].T)
    Q = qprofile.shape[1]
    best, out = {}, None
    for rep in range(repeats + 1):  # rep 0 warms
        t = [time.perf_counter()]
        profile = be.prepare_query(qprofile, 3, 1)
        sync(dev)
        t.append(time.perf_counter())
        handle = be.dispatch_many(profile, ddb, 3, 1, mode, SEARCH_SCORE_END)
        t.append(time.perf_counter())
        sync(dev)
        t.append(time.perf_counter())
        per_block = be.collect_many(handle, ddb, mode, SEARCH_SCORE_END, Q)
        sync(dev)
        t.append(time.perf_counter())
        cols = {}
        for blk, blk_cols in per_block:
            for k, v in blk_cols.items():
                cols.setdefault(k, np.empty(ddb.n, v.dtype))[blk.indices] = v
        out = _finish_cols(cols, mode, SEARCH_SCORE_END, n=ddb.n)
        t.append(time.perf_counter())
        if rep:
            for name, a, b in zip(
                    ("prepare_s", "enqueue_s", "device_s", "collect_s",
                     "assembly_s"), t, t[1:]):
                best[name] = min(best.get(name, b - a), b - a)
    return best, out


def run(engine, ddb, queries: dict, matrix, modes=("SW", "NW", "HW", "OV"),
        repeats=3):
    """The protocol of the module docstring on a resident database `ddb`
    of `engine`; queries {name: alphabet indices}. Returns the result
    dict; "answers" holds each row's x0 and x1 results."""
    total = int(ddb.total_residues)
    payload = 3 * 4 * ddb.n
    rows, answers = [], {}
    for qname, query in queries.items():
        for mode_name in modes:
            mode = MODE_CODES[mode_name]
            row = {"query": qname, "Q": len(query), "mode": mode_name}
            for st, tag in ((SEARCH_SCORE, "x0"), (SEARCH_SCORE_END, "x1")):
                def search():
                    return search_database_arrays(
                        query, ddb, 3, 1, matrix, mode=mode, search_type=st,
                        engine=engine)

                answers[(qname, mode_name, tag)] = search()  # warm
                best = min(seconds(search) for _ in range(repeats))
                row[f"{tag}_s"] = best
                row[f"{tag}_gcups"] = total * len(query) / best / 1e9
            split, x1 = split_x1(engine, ddb, query, matrix, mode, repeats)
            same = all(np.array_equal(x1[k], answers[(qname, mode_name,
                                                      "x1")][k])
                       for k in ("score", "end_q", "end_t"))
            require(same, f"{qname} {mode_name}: the split x1 search "
                    "differs from search_database_arrays")
            row.update(split)
            row["split_sum_s"] = sum(split.values())
            rows.append(row)
    return {"n_db": ddb.n, "residues": total, "x1_payload_bytes": payload,
            "download_model": link_rate(engine.device, payload),
            "rows": rows, "answers": answers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-seqs", type=int, default=541762)
    ap.add_argument("--queries", default="P18080,O74807")
    ap.add_argument("--modes", default="SW,NW,HW,OV")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import Engine, resolve_device
    from ..matrices import ScoreMatrix

    dev = resolve_device(a.device)
    engine = Engine(device=str(dev),
                    block_size=CPU_BLOCK if dev.type == "cpu" else 1024)
    if dev.type == "cpu":
        a.n_seqs, a.queries, a.modes, a.repeats = (
            min(a.n_seqs, 48), "O74807", "SW,NW", 1)
    sm = ScoreMatrix.blosum50()
    lut = sm.letter_index()
    ddb = engine.upload(synth_db(a.n_seqs, lut))
    queries = {q: port_query(q, lut) for q in a.queries.split(",")}
    res = run(engine, ddb, queries, sm.matrix, a.modes.split(","), a.repeats)
    res.pop("answers")
    report("exp_x1_gap", engine.device, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
