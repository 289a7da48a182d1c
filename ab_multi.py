#!/usr/bin/env python3
"""multi_dp of two trees in one process, in turns, on the served cell's
stacked groups.

Run from the root of the tree under test, with another tree (the parent,
unpacked with git archive) in PARENT_DIR:

    python3 ab_multi.py PARENT_DIR [--rounds 4] [--pairs 10]

It builds both trees' multi_dp, loads the other tree's package under
another name, and synthesizes and uploads the served cell's database once
(benchmark/configs/sprot541k_blosum50_go3_ge1.json at the cell's seed:
541,762 sequences, blocks of 1,024 lanes), which both trees read. The
groups are those the cell `sprot541k_serve_top10_8clients` stacks: its 8
clients move in step, so round r stacks the r-th timed request of each
(benchmark.cell_serve.make_queries). Then, printing one JSON line each:

- equal: on the first group, both trees' multi_score rows in every mode
  at x0 and x1 (gaps 3/1), and at SW x1 with gaps 2/2 and 1/3, must be
  equal bit for bit;
- plan: each variant's launch plan for the first group (blocks per G,
  strips, the resident threads it planned with), both trees' ptxas
  registers and spills per instantiation, and this tree's CUDA blocks
  per SM, registers and spill bytes of each instantiation (the library's
  multi_dp_attrs);
- per group: each variant's milliseconds (SW x0, gaps 3/1; CUDA events
  around one multi_score call, one sample each) over `pairs` rounds of
  turns (the variants in turn, the order reversed every other round);
- the last line: per variant the median and quartiles over all samples,
  its median over the other tree's, and the pairs it won against it.

Variants: `other` (PARENT_DIR's tree), `this` (this tree as it plans), and
`this_occ` (this tree planned with kernels.RESIDENT_THREADS_PER_SM at the
SW x0 kernel's own occupancy, its CUDA blocks per SM x THREADS) where that
plan differs from the one `this` launches.
The card's name and power limit are on the first line.
"""
import argparse
import contextlib
import ctypes
import importlib
import importlib.util
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import cell_serve, common  # noqa: E402
from chip_smoke import ptxas_summary  # noqa: E402
from opal_tpu_torch import tools  # noqa: E402
from opal_tpu_torch.engine import _build, kernels  # noqa: E402
from opal_tpu_torch.engine.search import Engine  # noqa: E402
from opal_tpu_torch.matrices import ScoreMatrix  # noqa: E402

CELL = "sprot541k_serve_top10_8clients"


def other_kernels(root, alias="ab_other_tree"):
    """The kernels module of the package opal_tpu_torch under `root`,
    imported as `alias` (its relative imports stay inside that tree)."""
    pkg = os.path.join(os.path.abspath(root), "opal_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(alias + ".engine.kernels")


def groups_of(rounds, db, sm, seed, cell):
    """The query groups (alphabet indices) of the cell's first `rounds`
    timed rounds."""
    tr = cell["traffic"]
    clients, per = tr["clients"], tr["requests_per_client"]
    n_q = clients * (1 + per + cell_serve.TRACED_REQUESTS)
    queries, _ = cell_serve.make_queries(
        seed, n_q, cell_serve.query_lengths(), db, sm.alphabet)
    timed = queries[clients:clients * (1 + per)]
    lut = sm.letter_index()
    enc = [lut[np.frombuffer(q.encode(), np.uint8)] for q in timed]
    return [[enc[c * per + r] for c in range(clients)]
            for r in range(rounds)]


@contextlib.contextmanager
def residents(km, per_sm):
    """km.RESIDENT_THREADS_PER_SM at per_sm (None: as it is) for a block."""
    saved = km.RESIDENT_THREADS_PER_SM
    if per_sm is not None:
        km.RESIDENT_THREADS_PER_SM = per_sm
    try:
        yield
    finally:
        km.RESIDENT_THREADS_PER_SM = saved


def plan_summary(km, stream, n_strips, per_sm=None):
    """{"n_strips", "resident_per_sm", "waves", "groups": {G: blocks}} of
    the plan km (a kernels module) launches multi_dp with for this stream,
    with RESIDENT_THREADS_PER_SM at per_sm where given."""
    with residents(km, per_sm):
        plan = km.plan_for(stream, n_strips)
        resident = km.RESIDENT_THREADS_PER_SM
    g, n = np.unique(plan.groups, return_counts=True)
    return {"n_strips": n_strips, "resident_per_sm": resident,
            "waves": len(plan.waves),
            "groups": {int(a): int(b) for a, b in zip(g, n)}}


def library_attrs(km, mode=3, track_end=0, max_g=8, W=32):
    """(blocks per SM, registers, spill bytes) of km's multi_dp
    instantiation, or None where its library has no multi_dp_attrs."""
    lib = km._lib("multi_dp")
    if not hasattr(lib, "multi_dp_attrs"):
        return None
    out = (ctypes.c_int * 3)()
    err = lib.multi_dp_attrs(mode, track_end, max_g, W, out)
    if err:
        raise RuntimeError(f"multi_dp_attrs: CUDA error {err}")
    return list(out)


def quartiles(v):
    q = np.percentile(v, [25, 50, 75])
    return {"q1": float(q[0]), "median": float(q[1]), "q3": float(q[2]),
            "n": len(v)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other tree (the parent)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=common.DEFAULT_SEED)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_multi: needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": tools.nvidia_smi("name,power.limit")}),
          flush=True)
    other = other_kernels(a.other)
    t0 = time.perf_counter()
    log = _build.build_all(("multi_dp",), report=True)
    other_build = importlib.import_module(other.__package__ + "._build")
    other_log = other_build.build_all(("multi_dp",), report=True)
    build_s = time.perf_counter() - t0

    cell, config = common.load_cell(CELL)
    sm = ScoreMatrix.from_name(config["scoring"]["matrix"])
    db, synth_s = common.synth_database(config["database"]["sequences"],
                                        a.seed, sm.letter_index())
    ddb = Engine(device="cuda",
                 block_size=config["database"]["block_size"]).upload(db)
    torch.cuda.synchronize()
    groups = groups_of(a.rounds, db, sm, a.seed, cell)
    matrix = sm.matrix

    def profiles(km, group):
        prof, qs = km.prepare_profile_multi(
            [matrix[q.astype(np.int64)].T for q in group])
        return torch.from_numpy(prof).to("cuda"), qs

    # equality on the first group
    p_this, q_this = profiles(kernels, groups[0])
    p_other, q_other = profiles(other, groups[0])
    cases = [(m, x, 3, 1) for m in range(4) for x in (0, 1)] + [
        (3, 1, 2, 2), (3, 1, 1, 3)]
    bad = entries = 0
    for mode, x, go, ge in cases:
        mine = kernels.multi_score(p_this, q_this, ddb.stream, mode, x, go,
                                   ge)
        theirs = other.multi_score(p_other, q_other, ddb.stream, mode, x,
                                   go, ge)
        bad += int((mine != theirs).sum())
        entries += mine.numel()
    print(json.dumps({"line": "equal", "cases": len(cases),
                      "entries": entries, "mismatches": bad,
                      "segments": list(q_this)}), flush=True)

    n_this = p_this.shape[0] // kernels.MULTI_STRIP_ROWS
    n_other = p_other.shape[0] // getattr(other, "MULTI_STRIP_ROWS",
                                          other.STRIP_ROWS)
    attrs = {f"mode{m}_end{e}": library_attrs(kernels, m, e)
             for m in range(4) for e in (0, 1)}
    occupancy = attrs["mode3_end0"][0] * kernels.THREADS
    plans = {"other": plan_summary(other, ddb.stream, n_other),
             "this": plan_summary(kernels, ddb.stream, n_this),
             "this_occ": plan_summary(kernels, ddb.stream, n_this,
                                      occupancy)}
    variants = {"other": (other, None), "this": (kernels, None)}
    if plans["this_occ"]["groups"] != plans["this"]["groups"]:
        variants["this_occ"] = (kernels, occupancy)
    print(json.dumps({
        "line": "plan", "plans": plans, "variants": list(variants),
        "attrs_this": attrs,
        "ptxas": {k: ptxas_summary(v["multi_dp"]["log"])
                  for k, v in (("this", log), ("other", other_log))},
        "build_s": build_s, "synth_s": synth_s}), flush=True)

    def timed(v, prof, qs):
        km, resident = variants[v]
        with residents(km, resident):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            km.multi_score(prof, qs, ddb.stream, 3, 0, 3, 1)
            stop.record()
            torch.cuda.synchronize()
        return start.elapsed_time(stop)

    samples = {v: [] for v in variants}
    wins, total = dict.fromkeys(variants, 0), 0
    for r, group in enumerate(groups):
        pt, qt = profiles(kernels, group)
        po, qo = profiles(other, group)
        ops = {v: (po, qo) if v == "other" else (pt, qt) for v in variants}
        for v in variants:  # warm-up: plans, scratch
            timed(v, *ops[v])
        mine = {v: [] for v in variants}
        for k in range(a.pairs):
            order = list(variants)[::1 if k % 2 == 0 else -1]
            got = {v: timed(v, *ops[v]) for v in order}
            for v in variants:
                mine[v].append(got[v])
            for v in variants:
                wins[v] += got[v] < got["other"]
            total += 1
        for v in variants:
            samples[v] += mine[v]
        print(json.dumps({"line": "group", "round": r, "segments": list(qt),
                          "rows": {"this": int(pt.shape[0]),
                                   "other": int(po.shape[0])},
                          "ms": {v: quartiles(mine[v]) for v in variants}}),
              flush=True)
    stats = {v: quartiles(samples[v]) for v in variants}
    print(json.dumps({
        "ab_multi": stats,
        "over_other": {v: stats[v]["median"] / stats["other"]["median"]
                       for v in variants},
        "won_against_other": wins, "pairs": total, "mismatches": bad,
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
