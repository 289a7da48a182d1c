"""The device alignment fill against the host path at full scale (the
card's counterpart of the TPU tool tools/exp_device_fill.py).

    python -m opal_tpu_torch.tools.exp_device_fill [--n-seqs 541762]
        [--top-k 1000] [--qlen 513] [--lanes 512] [--device cuda|cpu]

1. An SW x1 search (BLOSUM50, gaps 3/1) of a query of `qlen` letters,
   np.random.default_rng(1).integers(0, 20, qlen), against `n-seqs`
   synthetic sequences (opal_tpu_torch.synth.make_db_arrays(n)) held
   resident, the top k selected on the device: the winners.
2. engine/search.py's alignment_pass over the winners on the host
   (OPAL_TPU_DEVICE_FILL unset), then with the device fill (set to 1), then
   with the audit (OPAL_TPU_DEVICE_FILL_CHECK=1 as well); each pass is
   compared with the host pass field by field.
3. align_winners_device alone, its first call and its second ("cold" and
   "warm"), with the split of its host work (device_fill.LAST_STATS).

One JSON line. Every time is host wall time ending in
torch.cuda.synchronize(). On the CPU (`--device cpu`) the plain version
runs at a small size (200 sequences, qlen 48, top 40) and no time is
reported.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

from ..constants import MODE_SW, SEARCH_SCORE_END
from ..engine import device_fill, kernels
from ..engine.search import Engine, alignment_pass, search_database_arrays
from ..matrices import ScoreMatrix
from ..result import SearchResult
from ..synth import make_db_arrays

SWITCHES = ("OPAL_TPU_DEVICE_FILL", "OPAL_TPU_DEVICE_FILL_CHECK")


def _fields(res, order):
    return [(res[i].score, res[i].start_location_query,
             res[i].start_location_target, res[i].end_location_query,
             res[i].end_location_target,
             None if res[i].alignment is None else bytes(res[i].alignment))
            for i in order]


def protocol(engine, ddb, query, matrix, top_k=1000, lanes=512):
    """Steps 1-3 of the module docstring on a resident database `ddb` of
    `engine`; returns the result dict (times in seconds, a CPU run
    included: main() drops them there)."""
    dev = engine.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    db = ddb.raw
    out = search_database_arrays(query, ddb, 3, 1, matrix, mode=MODE_SW,
                                 search_type=SEARCH_SCORE_END, engine=engine,
                                 top_k=top_k)
    winners = [(int(i), int(s), int(eq), int(et))
               for i, s, eq, et in zip(out["index"], out["score"],
                                       out["end_q"], out["end_t"])]
    order = sorted(w[0] for w in winners)

    def aligned(fill, check=False):
        res = {}
        for i, s, eq, et in winners:
            r = res[i] = SearchResult()
            r.score, r.score_set = s, 1
            r.end_location_query, r.end_location_target = eq, et
        saved = {k: os.environ.pop(k, None) for k in SWITCHES}
        try:
            if fill:
                os.environ["OPAL_TPU_DEVICE_FILL"] = "1"
            if check:
                os.environ["OPAL_TPU_DEVICE_FILL_CHECK"] = "1"
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                alignment_pass(query, db, 3, 1, matrix, MODE_SW, res, order,
                               device=dev)
                sync()
                seconds = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        lane_warnings = sum("device fill lane" in str(w.message)
                            for w in caught)
        return res, seconds, lane_warnings

    host, host_s, _ = aligned(False)
    kernels.reset_counts()
    dev_res, dev_s, _ = aligned(True)
    launches = kernels.LAUNCHES["device_fill"]
    plain_calls = kernels.PLAIN_CALLS["fill_walk_plain"]
    pass_stats = dict(device_fill.LAST_STATS)
    audit, audit_s, audit_warnings = aligned(True, check=True)
    want = _fields(host, order)
    timed = []
    for _ in range(2):  # cold, warm
        t0 = time.perf_counter()
        got = device_fill.align_winners_device(query, db, 3, 1, matrix,
                                               MODE_SW, winners, lanes=lanes,
                                               device=dev)
        sync()
        timed.append((time.perf_counter() - t0, dict(device_fill.LAST_STATS),
                      len(got)))
    return {
        "sequences": len(db), "residues": int(ddb.total_residues),
        "qlen": len(query), "top_k": top_k, "lanes": lanes,
        "winners": len(winners),
        "rect_cells": int(sum((eq + 1) * (et + 1)
                              for _, _, eq, et in winners)),
        "host_pass_s": host_s, "device_pass_s": dev_s,
        "identical": _fields(dev_res, order) == want,
        "paths": sum(host[i].alignment is not None for i in order),
        "device_lanes": pass_stats["device_lanes"],
        "host_lanes": pass_stats["host_lanes"],
        "groups": pass_stats["groups"], "shapes": pass_stats["shapes"],
        "launches": launches, "plain_calls": plain_calls,
        "audit_s": audit_s, "audit_warnings": audit_warnings,
        "audit_identical": _fields(audit, order) == want,
        "cold_s": timed[0][0], "warm_s": timed[1][0],
        "warm_coverage": timed[1][2],
        "warm_split_ms": {k: timed[1][1][k]
                          for k in ("pack_ms", "dev_ms", "replay_ms")},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-seqs", type=int, default=541762)
    ap.add_argument("--top-k", type=int, default=1000)
    ap.add_argument("--qlen", type=int, default=513)
    ap.add_argument("--lanes", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    engine = Engine(device=a.device, block_size=1024)
    cuda = engine.device.type == "cuda"
    if not cuda:  # the plain versions, small
        a.n_seqs, a.qlen, a.top_k = min(a.n_seqs, 200), min(a.qlen, 48), \
            min(a.top_k, 40)
    sm = ScoreMatrix.blosum50()
    lut = sm.letter_index()
    db = [lut[s] for s in make_db_arrays(a.n_seqs)]
    ddb = engine.upload(db)
    query = np.random.default_rng(1).integers(0, 20, size=a.qlen,
                                              dtype=np.uint8)
    res = protocol(engine, ddb, query, sm.matrix, a.top_k, a.lanes)
    res = {"tool": "exp_device_fill", "device": engine.device.type,
           "measured": cuda, **res}
    if cuda:
        from . import nvidia_smi

        res["card"] = nvidia_smi("name,power.limit")
    else:  # no time from a CPU run
        res = {k: v for k, v in res.items()
               if not k.endswith(("_s", "_ms"))}
    print(json.dumps(res), flush=True)
    ok = (res["identical"] and res["audit_identical"]
          and res["audit_warnings"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
