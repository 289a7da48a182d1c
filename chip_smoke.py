#!/usr/bin/env python3
"""Smoke run of opal_tpu_torch on one NVIDIA GPU (H100): python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero before
the last line:

1. device  - the card's name and power limit (nvidia-smi);
2. build   - nvcc builds every kernel from opal_tpu_torch/engine/csrc, one
             nvcc per source, all started together;
3. kernel  - ragged_dp and multi_dp against their plain PyTorch versions,
             both on the card, on random streams (4 modes x score /
             score+end, several gap pairs, query lengths and stacked
             segment sets, partial first blocks, several waves); exact
             equality;
4. goldens - the port on the card against the reference binary's result
             lines for the 12,071-sequence fixture (16 x0/x1 files);
5. main    - the single-query path at full scale: O74807 (SW, score,
             BLOSUM50, gaps 3/1) against 541,762 synthetic sequences held
             resident, through search_database_arrays; then ragged_dp
             against the plain version on blocks of that database;
6. serve   - the serving path on the same resident database:
             opal_tpu_torch.serve.Server answers the 15 queries of
             tests/port_data/uniprot_sprot15.fasta as one batch request
             (stacked multi_dp launches, top 10 selected on the card), as
             15 single-query lines batched by _respond_many, as NW/HW/OV
             batches, a cache hit and an align request; every hit list is
             checked against the host ranking of a full ragged_dp score
             table; then multi_dp against its plain version on blocks of
             that database.

Then the kernels line and the last line {"ok": true, "device": {...}}.
Needs CUDA, nvcc and the repository checkout around this file; imports
nothing of JAX or opal_tpu.
"""
import gzip
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
# The least int32 instructions one SW score-only DP cell needs, with the
# card's DPX forms (see ragged_dp.cu): 2 adds, which the ALU or the FMA pipe
# can issue, and 3.5 max-type instructions, which only the ALU pipe issues.
CELL_ADDS, CELL_MAXES = 2, 3.5
ALU_PER_SM_CLK = 64    # int32 ALU lanes per SM (4 sub-partitions x 16)
ISSUE_PER_SM_CLK = 128  # 4 schedulers x one 32-thread instruction per clock


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi(query):
    """nvidia-smi's answer for the first card, e.g. query="name,power.limit"."""
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def op_bound_ms(cells):
    """Least milliseconds the card takes for `cells` SW DP cells in int32:
    the max-type instructions on the ALU pipe, or all instructions on the
    schedulers' issue rate, whichever is slower, at the card's SM count and
    highest SM clock."""
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(re.match(r"\s*([\d.]+)\s*MHz", nvidia_smi("clocks.max.sm"))
                .group(1))
    clk_per_cell = max(CELL_MAXES / ALU_PER_SM_CLK,
                       (CELL_ADDS + CELL_MAXES) / ISSUE_PER_SM_CLK)
    return cells * clk_per_cell / (n_sm * mhz * 1e6) * 1e3, n_sm, mhz


def ptxas_summary(log):
    """{instantiation: "N registers, S spill bytes"} from ptxas's report;
    ragged_dp's instantiations read mode<M>_end<E>."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELb(\d)E", m.group(1))
            name = f"mode{t.group(1)}_end{t.group(2)}" if t else m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            out[name] = f"{m.group(1)} spill bytes"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out


def random_stream(rng, n, max_len, B, lut_size, device):
    """A random database of n sequences (lengths 1..max_len, both ends
    present) packed as the resident stream; the first block is partial
    whenever n is not a multiple of B."""
    from opal_tpu_torch.engine import batching, kernels

    lens = rng.integers(1, max_len + 1, size=n)
    lens[0], lens[-1] = 1, max_len
    db = [rng.integers(0, lut_size, size=int(L), dtype=np.uint8)
          for L in lens]
    blocks = batching.plan_blocks(db, B)
    return kernels.pack_stream([b.letters for b in blocks],
                               [b.lengths for b in blocks], B, device)


def compare(profile, stream, mode, x, go, ge, seg_qs=None):
    """(mismatching entries, max |diff|) of kernel vs plain rows: ragged_dp,
    or multi_dp when seg_qs (the stacked segments' lengths) is given."""
    import torch

    from opal_tpu_torch.engine import kernels

    if seg_qs is None:
        got = kernels.ragged_score(profile, stream, mode, x, go, ge)
        want = kernels.ragged_score_plain(profile, stream, mode, x, go, ge)
    else:
        got = kernels.multi_score(profile, seg_qs, stream, mode, x, go, ge)
        want = kernels.multi_score_plain(profile, seg_qs, stream, mode, x,
                                         go, ge)
    torch.cuda.synchronize()
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


def multi_profile(matrix, queries, dev):
    """multi_dp's stacked profile of the queries (letter arrays) on dev."""
    import torch

    from opal_tpu_torch.engine import kernels

    prof, seg_qs = kernels.prepare_profile_multi(
        [matrix[np.asarray(q, np.int64)].T for q in queries])
    return torch.from_numpy(prof).to(dev), seg_qs


def phase_kernel(matrix, dev):
    """ragged_dp vs ragged_score_plain on random streams."""
    import torch

    from opal_tpu_torch.engine import kernels

    rng = np.random.default_rng(2024)
    A = matrix.shape[0]
    cases = []
    # (gaps, query lengths, longest target): the F chain's row loop of the
    # plain version (gap_ext > gap_open) is slow, so that pair runs small
    for gaps, qs, tmax in (((3, 1), (1, 37, 110, 513, 2000), 5000),
                           ((2, 2), (37, 513), 3000),
                           ((0, 0), (37, 513), 3000),
                           ((1, 3), (1, 37, 64), 300)):
        for Q in qs:
            for mode in range(4):
                for x in (0, 1):
                    cases.append((gaps, Q, min(tmax, 5000 if Q < 513
                                               else 2000), mode, x))
    n_cases = mismatches = max_err = 0
    t0 = time.perf_counter()
    for k, ((go, ge), Q, tmax, mode, x) in enumerate(cases):
        query = rng.integers(0, A, size=Q)
        profile = torch.from_numpy(kernels.build_profile(
            matrix[query].T)).to(dev)
        B = (256, 200)[k % 2]
        stream = random_stream(rng, 3 * B - 57, tmax, B, A, dev)
        bad, err = compare(profile, stream, mode, x, go, ge)
        n_cases += 1
        mismatches += bad
        max_err = max(max_err, err)
        if bad:
            emit({"phase": "kernel", "mismatch": {
                "mode": mode, "x": x, "go": go, "ge": ge, "Q": Q,
                "tmax": tmax, "B": B, "entries": bad}})
    # several launches (waves) over one stream
    profile = torch.from_numpy(kernels.build_profile(
        matrix[rng.integers(0, A, size=110)].T)).to(dev)
    stream = random_stream(rng, 2000, 2000, 128, A, dev)
    wave_cells = kernels.WAVE_CELLS
    kernels.WAVE_CELLS = int(stream.host_offsets[-1]) // 4
    try:
        for mode in range(4):
            before = kernels.LAUNCHES["ragged_dp"]
            bad, err = compare(profile, stream, mode, 1, 3, 1)
            check(kernels.LAUNCHES["ragged_dp"] - before > 1,
                  "wave case ran in one launch")
            n_cases += 1
            mismatches += bad
            max_err = max(max_err, err)
    finally:
        kernels.WAVE_CELLS = wave_cells
    res = {"phase": "kernel", "kernel": "ragged_dp", "cases": n_cases,
           "mismatches": mismatches, "max_abs_err": max_err, "tolerance": 0,
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    check(mismatches == 0, "ragged_dp disagrees with ragged_score_plain")
    return res


def phase_kernel_multi(matrix, dev):
    """multi_dp vs multi_score_plain on random streams."""
    from opal_tpu_torch.engine import kernels

    rng = np.random.default_rng(2025)
    A = matrix.shape[0]
    mixed = [3, 60, 16, 513, 33, 2, 200, 47]
    # (gaps, segment sets, longest target): the plain version's cost grows
    # with segments x columns, and its row loop (gap_ext > gap_open) is slow
    plan = (((3, 1), ([1, 37], [16, 17, 110], mixed), 1000),
            ((2, 2), ([16, 17, 110], mixed), 500),
            ((0, 0), ([16, 17, 110], mixed), 500),
            ((1, 3), ([1, 37],), 200))
    n_cases = mismatches = max_err = 0
    t0 = time.perf_counter()
    k = 0
    for (go, ge), seg_sets, tmax in plan:
        for segs in seg_sets:
            for mode in range(4):
                for x in (0, 1):
                    profile, seg_qs = multi_profile(
                        matrix, [rng.integers(0, A, size=q) for q in segs],
                        dev)
                    B = (256, 200)[k % 2]
                    k += 1
                    stream = random_stream(rng, 3 * B - 57, tmax, B, A, dev)
                    bad, err = compare(profile, stream, mode, x, go, ge,
                                       seg_qs)
                    n_cases += 1
                    mismatches += bad
                    max_err = max(max_err, err)
                    if bad:
                        emit({"phase": "kernel", "mismatch": {
                            "kernel": "multi_dp", "mode": mode, "x": x,
                            "go": go, "ge": ge, "segments": segs,
                            "tmax": tmax, "B": B, "entries": bad}})
    # several launches (waves) over one stream
    profile, seg_qs = multi_profile(
        matrix, [rng.integers(0, A, size=q) for q in mixed], dev)
    stream = random_stream(rng, 1500, 600, 128, A, dev)
    wave_cells = kernels.WAVE_CELLS
    kernels.WAVE_CELLS = int(stream.host_offsets[-1]) // 4
    try:
        for mode in range(4):
            before = kernels.LAUNCHES["multi_dp"]
            bad, err = compare(profile, stream, mode, 1, 3, 1, seg_qs)
            check(kernels.LAUNCHES["multi_dp"] - before > 1,
                  "multi_dp wave case ran in one launch")
            n_cases += 1
            mismatches += bad
            max_err = max(max_err, err)
    finally:
        kernels.WAVE_CELLS = wave_cells
    res = {"phase": "kernel", "kernel": "multi_dp", "cases": n_cases,
           "mismatches": mismatches, "max_abs_err": max_err, "tolerance": 0,
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    check(mismatches == 0, "multi_dp disagrees with multi_score_plain")
    return res


def _normalize_sw_zero(lines):
    # SW x1 score-0 lines carry indeterminate ends in the reference output
    out = []
    for ln in lines:
        m = re.match(r"(#\d+: 0) \(\?, \?\) \(-?\d+, -?\d+\)$", ln)
        out.append(m.group(1) + " (?, ?) (?, ?)" if m else ln)
    return out


def phase_goldens(sm, engine):
    from opal_tpu_torch.constants import MODE_CODES
    from opal_tpu_torch.engine.search import search_database
    from opal_tpu_torch.fasta import read_fasta_file
    from opal_tpu_torch.render import result_line

    t0 = time.perf_counter()
    lut = sm.letter_index()
    db, _ = read_fasta_file(
        os.path.join(HERE, "tests", "data", "synth12071.fasta.gz"), lut)
    ddb = engine.upload(db)
    gdir = os.path.join(HERE, "tests", "golden_large")
    configs = bad_lines = 0
    for qname in ("O74807", "P18080"):
        qs, _ = read_fasta_file(
            os.path.join(HERE, "tests", "port_data", f"{qname}.fasta"), lut)
        for mode_name in ("SW", "NW", "HW", "OV"):
            for x in (0, 1):
                res = search_database(qs[0], ddb, 3, 1, sm.matrix,
                                      mode=MODE_CODES[mode_name],
                                      search_type=x, engine=engine)
                mine = [result_line(i, r) for i, r in enumerate(res)]
                path = os.path.join(
                    gdir, f"{qname}__synth12071__{mode_name}_x{x}_o3_e1"
                    ".txt.gz")
                with gzip.open(path, "rt") as f:
                    want = [ln for ln in f.read().splitlines()
                            if ln.startswith("#")]
                if mode_name == "SW" and x == 1:
                    mine, want = _normalize_sw_zero(mine), \
                        _normalize_sw_zero(want)
                check(len(want) == len(db), f"{path}: {len(want)} lines")
                bad_lines += sum(a != b for a, b in zip(mine, want))
                configs += 1
    res = {"phase": "goldens", "configs": configs, "sequences": len(db),
           "mismatching_lines": bad_lines,
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    check(configs == 16 and bad_lines == 0, "golden result lines differ")


def time_cuda(fn, reps):
    """Mean milliseconds of fn() over reps runs (CUDA events, warmed up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def full_scale_server(sm):
    """The serving path's Server over 541,762 synthetic sequences (seed
    12071) held resident on the card, and its set-up seconds."""
    import torch

    from opal_tpu_torch.serve import Server
    from opal_tpu_torch.synth import make_db_arrays

    t0 = time.perf_counter()
    lut = sm.letter_index()
    db = [lut[a] for a in make_db_arrays(541762, seed=12071)]
    names = [f"synth12071|{i}" for i in range(len(db))]
    srv = Server.from_sequences(db, names, sm, block_size=1024,
                                device="cuda")
    torch.cuda.synchronize()
    return srv, time.perf_counter() - t0


def phase_main(sm, engine, ddb, setup_s, smi):
    import torch

    from opal_tpu_torch.constants import MODE_OV, MODE_SW, SEARCH_SCORE
    from opal_tpu_torch.engine import kernels
    from opal_tpu_torch.engine.search import Engine, search_database_arrays
    from opal_tpu_torch.fasta import read_fasta_file

    lut = sm.letter_index()
    db = ddb.raw
    total = ddb.total_residues
    qs, _ = read_fasta_file(
        os.path.join(HERE, "tests", "port_data", "O74807.fasta"), lut)
    query = qs[0]
    Q = len(query)

    def search(mode=MODE_SW, x=SEARCH_SCORE):
        t = time.perf_counter()
        out = search_database_arrays(query, ddb, 3, 1, sm.matrix, mode=mode,
                                     search_type=x, engine=engine)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    search()  # warm-up
    kernels.reset_counts()
    runs = [search() for _ in range(5)]
    launches = kernels.LAUNCHES["ragged_dp"]
    plain_calls = kernels.PLAIN_CALLS["ragged_score_plain"]
    best = min(t for t, _ in runs)
    out = runs[0][1]["score"]
    check(launches > 0, "main path launched no ragged_dp")
    check(plain_calls == 0, "main path ran the plain version")
    check(out.shape == (len(db),) and out.dtype == np.int32
          and int(out.min()) >= 0, "SW scores malformed")
    check(all(np.array_equal(r[1]["score"], out) for r in runs),
          "repeated searches differ")

    # a seeded sample of the database, searched on the CPU (plain version)
    pick = np.random.default_rng(7).choice(len(db), 48, replace=False)
    cpu = search_database_arrays(query, [db[i] for i in pick], 3, 1,
                                 sm.matrix,
                                 engine=Engine(device="cpu", block_size=64))
    check(np.array_equal(cpu["score"], out[pick]),
          "full-scale scores differ from the CPU plain version")

    x1_s, _ = search(MODE_SW, 1)
    ov_s, _ = search(MODE_OV, 1)

    # the kernel alone at the main path's shapes, then against its plain
    # version on blocks of this database (every 24th block and the last)
    profile = engine._backend.prepare_query(
        sm.matrix[query.astype(np.int64)].T, 3, 1)
    kernel_ms = time_cuda(lambda: kernels.ragged_score(
        profile, ddb.stream, MODE_SW, SEARCH_SCORE, 3, 1), 5)
    sel = sorted(set(range(0, len(ddb.blocks), 24)) | {len(ddb.blocks) - 1})
    sub_stream = kernels.pack_stream(
        [ddb.blocks[b].letters for b in sel],
        [ddb.blocks[b].lengths for b in sel], ddb.block_size, ddb.device)
    sub_cells = Q * int(sum(int(ddb.blocks[b].lengths.sum()) for b in sel))
    bad = err = 0
    for mode in range(4):
        for x in (0, 1):
            b_, e_ = compare(profile, sub_stream, mode, x, 3, 1)
            bad += b_
            err = max(err, e_)
    check(bad == 0, "ragged_dp disagrees with the plain version on "
          "main-path blocks")
    sub_kernel_ms = time_cuda(lambda: kernels.ragged_score(
        profile, sub_stream, MODE_SW, SEARCH_SCORE, 3, 1), 3)
    plain_ms = time_cuda(lambda: kernels.ragged_score_plain(
        profile, sub_stream, MODE_SW, SEARCH_SCORE, 3, 1), 1)

    cells = Q * total
    ops_ms, n_sm, max_mhz = op_bound_ms(cells)
    in_bytes = (ddb.stream.letters.numel() + 4 * ddb.stream.lengths.numel()
                + 4 * profile.numel())
    bytes_ms = (in_bytes + 4 * ddb.stream.lengths.numel()) \
        / HBM_BYTES_PER_S * 1e3
    res = {
        "phase": "main", "sequences": len(db), "residues": total,
        "query": "O74807", "Q": Q, "setup_s": round(setup_s, 1),
        "search_s": [round(t, 6) for t, _ in runs], "best_s": best,
        "gcups": total * Q / best / 1e9,
        "launches": launches, "launches_per_search": launches / len(runs),
        "plain_calls": plain_calls, "sw_x1_s": x1_s, "ov_x1_s": ov_s,
        "kernel_ms": kernel_ms, "kernel_gcups": cells / kernel_ms / 1e6,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ops_ms": ops_ms, "bytes_ms": bytes_ms, "sm_count": n_sm,
        "max_sm_mhz": max_mhz,
        "blocks": len(ddb.blocks), "sub_blocks": len(sel), "sub_cells": sub_cells,
        "sub_kernel_ms": sub_kernel_ms, "sub_plain_ms": plain_ms,
        "sub_cases": 8, "sub_mismatches": bad, "max_abs_err": err,
        "tolerance": 0,
        "card": smi,
    }
    emit(res)
    return res


def read_queries(path):
    """The residue strings of a FASTA file, in order."""
    seqs = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if ln.startswith(">"):
                seqs.append("")
            elif ln:
                seqs[-1] += ln
    return seqs


def phase_serve(srv, smi):
    """The serving path at full scale, checked against full-table rankings,
    then multi_dp timed and held against its plain version."""
    import torch

    from opal_tpu_torch.constants import MODE_CODES, MODE_SW, SEARCH_SCORE
    from opal_tpu_torch.engine import kernels, ranked
    from opal_tpu_torch.engine.search import (
        plan_groups,
        search_database_arrays,
        search_database_multi_arrays,
    )
    from opal_tpu_torch.ranking import rank_scores

    sm, ddb, engine = srv.sm, srv.ddb, srv.engine
    matrix = sm.matrix
    texts = read_queries(os.path.join(HERE, "tests", "port_data",
                                      "uniprot_sprot15.fasta"))
    check(len(texts) == 15, f"{len(texts)} queries in uniprot_sprot15")
    qs = [srv._encode_query(t) for t in texts]
    sum_q = sum(len(q) for q in qs)
    total = ddb.total_residues

    def request(req, cold=True):
        """(seconds, response line) of one request line; cold clears the
        response cache first."""
        if cold:
            srv._cache.clear()
        line = json.dumps(req)
        t = time.perf_counter()
        out = srv._respond(line)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    def hits_of(out):
        resp = json.loads(out)
        check("hits" in resp, f"error response: {out[:300]}")
        return resp["hits"]

    def want_hits(q, mode=MODE_SW, k=10):
        full = search_database_arrays(q, ddb, 3, 1, matrix, mode=mode,
                                      search_type=SEARCH_SCORE,
                                      engine=engine)
        return [[int(i), int(full["score"][i])]
                for i in rank_scores(full["score"], k)]

    batch = {"id": "batch", "queries": texts, "top_k": 10}
    request(batch)  # warm-up: lane indices upload, first launches
    kernels.reset_counts()
    runs = [request(batch) for _ in range(3)]
    launches = dict(kernels.LAUNCHES)
    plain = dict(kernels.PLAIN_CALLS)
    check(launches["multi_dp"] > 0, "serve path launched no multi_dp")
    check(sum(plain.values()) == 0, "serve path ran a plain version")
    batch_s = min(t for t, _ in runs)
    got = hits_of(runs[0][1])
    check(all(r[1] == runs[0][1] for r in runs), "repeated batches differ")
    check(len(got) == 15 and all(len(h) == 10 for h in got),
          "batch answer malformed")

    single_s = min(request({"id": 0, "query": texts[0], "top_k": 10})[0]
                   for _ in range(3))

    # the same 15 as single-query lines, batched across requests
    srv._cache.clear()
    lines = [json.dumps({"id": i, "query": t, "top_k": 10})
             for i, t in enumerate(texts)]
    outs = srv._respond_many(lines)
    for i, out in enumerate(outs):
        check(json.dumps(hits_of(out)) == json.dumps(got[i]),
              f"query {i}: single-query line differs from the batch")
    # every hit list against the host ranking of a full ragged_dp table
    for i, q in enumerate(qs):
        check(got[i] == want_hits(q), f"query {i}: top 10 differ from the "
              "full-table ranking")
    other_modes = {}
    for name in ("NW", "HW", "OV"):
        t, out = request({"id": name, "queries": texts[:4], "mode": name,
                          "top_k": 10})
        other_modes[name] = t
        for i, h in enumerate(hits_of(out)):
            check(h == want_hits(qs[i], MODE_CODES[name]),
                  f"{name} query {i}: top 10 differ")
    _, first = request(batch)  # cold: enters the cache
    cached_before = dict(kernels.LAUNCHES)
    t_hit, out = request(batch, cold=False)
    check(out == first == runs[0][1] and len(srv._cache) == 1
          and kernels.LAUNCHES == cached_before,
          "repeated request not answered from the cache")
    _, out = request({"id": "al", "query": texts[0], "align": True})
    check(json.loads(out).get("error", "").startswith("NotImplementedError"),
          f"align request: {out[:200]}")

    # one stacked group of 8 at score+end depth, top 10 and full tables,
    # against single-query searches
    group = [qs[p] for p in plan_groups(qs, lambda g: True)[0]]
    check(len(group) == 8, "no group of 8")
    for k in (10, 0):
        outs = search_database_multi_arrays(group, ddb, 3, 1, matrix,
                                            search_type=1, engine=engine,
                                            top_k=k)
        for q, o in zip(group, outs):
            w = search_database_arrays(q, ddb, 3, 1, matrix, search_type=1,
                                       engine=engine, top_k=k)
            check(set(o) == set(w) and all(np.array_equal(o[c], w[c])
                                           for c in w),
                  f"x1 multi search (top_k {k}) differs from single")

    # multi_dp alone on one group of 8, against ragged_dp on each query
    profile, seg_qs = multi_profile(matrix, group, ddb.device)
    multi_ms = time_cuda(lambda: kernels.multi_score(
        profile, seg_qs, ddb.stream, MODE_SW, SEARCH_SCORE, 3, 1), 3)
    singles = [engine._backend.prepare_query(matrix[q.astype(np.int64)].T,
                                             3, 1) for q in group]
    ragged_sum_ms = sum(time_cuda(lambda p=p: kernels.ragged_score(
        p, ddb.stream, MODE_SW, SEARCH_SCORE, 3, 1), 3) for p in singles)
    cells = sum(seg_qs) * total
    ops_ms, _, _ = op_bound_ms(cells)
    bytes_ms = (ddb.stream.letters.numel() + 4 * ddb.stream.lengths.numel()
                + 4 * profile.numel()
                + 4 * len(seg_qs) * ddb.stream.lengths.numel()) \
        / HBM_BYTES_PER_S * 1e3

    # where a batch request's time goes: multi_dp for each of its groups,
    # and the device top-k with its one copy for a group
    request_kernel_ms = 0.0
    for grp in plan_groups(qs, lambda g: True):
        p_g, q_g = multi_profile(matrix, [qs[p] for p in grp], ddb.device)
        request_kernel_ms += time_cuda(lambda: kernels.multi_score(
            p_g, q_g, ddb.stream, MODE_SW, SEARCH_SCORE, 3, 1), 1)
    handle = engine._backend.dispatch_multi(
        [matrix[q.astype(np.int64)].T for q in group], ddb, 3, 1, MODE_SW,
        SEARCH_SCORE)
    torch.cuda.synchronize()
    topk_s = []
    for _ in range(3):
        t = time.perf_counter()
        ranked.topk_from_multi_handle(handle, ddb, 10)
        topk_s.append(time.perf_counter() - t)

    # multi_dp against its plain version on blocks of this database
    sel = list(range(0, len(ddb.blocks), 48))
    sub = kernels.pack_stream(
        [ddb.blocks[b].letters for b in sel],
        [ddb.blocks[b].lengths for b in sel], ddb.block_size, ddb.device)
    bad = err = 0
    sub_cases = [(MODE_SW, 0), (MODE_SW, 1), (MODE_CODES["NW"], 1),
                 (MODE_CODES["OV"], 1)]
    for mode, x in sub_cases:
        b_, e_ = compare(profile, sub, mode, x, 3, 1, seg_qs)
        bad += b_
        err = max(err, e_)
    check(bad == 0, "multi_dp disagrees with the plain version on "
          "main-path blocks")
    sub_kernel_ms = time_cuda(lambda: kernels.multi_score(
        profile, seg_qs, sub, MODE_SW, SEARCH_SCORE, 3, 1), 3)
    plain_ms = time_cuda(lambda: kernels.multi_score_plain(
        profile, seg_qs, sub, MODE_SW, SEARCH_SCORE, 3, 1), 1)

    k2 = 2 * min(10, ddb.stream.lengths.numel())
    res = {
        "phase": "serve", "sequences": ddb.n, "residues": total,
        "queries": len(qs), "query_residues": sum_q,
        "batch_s": [round(t, 6) for t, _ in runs], "batch_best_s": batch_s,
        "batch_gcups": total * sum_q / batch_s / 1e9,
        "single_query_s": single_s,
        "nw_hw_ov_batch4_s": other_modes, "cache_hit_s": t_hit,
        "launches_per_request": {k: v / len(runs)
                                 for k, v in launches.items()},
        "launches": launches, "plain_calls": plain,
        "candidate_bytes_per_request": 15 * 3 * k2 * 4,
        "full_table_bytes_per_query": ddb.n * 4,
        "group_segments": list(seg_qs), "group_cells": cells,
        "request_multi_dp_ms": request_kernel_ms,
        "topk_one_group_s": min(topk_s),
        "multi_dp_group_ms": multi_ms,
        "ragged_dp_sum_ms": ragged_sum_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ops_ms": ops_ms, "bytes_ms": bytes_ms,
        "sub_blocks": len(sel), "blocks": len(ddb.blocks),
        "sub_kernel_ms": sub_kernel_ms, "sub_plain_ms": plain_ms,
        "sub_cases": len(sub_cases), "sub_mismatches": bad,
        "max_abs_err": err, "tolerance": 0, "card": smi,
    }
    emit(res)
    return res


def main():
    if not os.path.isdir(os.path.join(HERE, "opal_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from opal_tpu_torch.engine import _build
    from opal_tpu_torch.engine.search import Engine
    from opal_tpu_torch.matrices import ScoreMatrix

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = _build.build_all(report=True)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 1),
          "kernels": {k: {"seconds": round(v["seconds"], 1),
                          "ptxas": ptxas_summary(v["log"])}
                      for k, v in log.items()}})

    sm = ScoreMatrix.blosum50()
    dev = torch.device("cuda")
    kern = phase_kernel(sm.matrix, dev)
    kern_multi = phase_kernel_multi(sm.matrix, dev)
    phase_goldens(sm, Engine(device="cuda", block_size=1024))
    srv, setup_s = full_scale_server(sm)
    main_res = phase_main(sm, srv.engine, srv.ddb, setup_s, smi)
    serve_res = phase_serve(srv, smi)

    emit({"kernels": [{
        "name": "ragged_dp", "route": "cuda",
        "source": "opal_tpu_torch/engine/csrc/ragged_dp.cu",
        "replaces": "opal_tpu/engine/pallas_kernels.py:825:"
                    "build_pallas_ragged_fn_raw",
        "launches": main_res["launches"],
        "checked_cases": kern["cases"] + main_res["sub_cases"],
        "mismatches": kern["mismatches"] + main_res["sub_mismatches"],
        "max_abs_err": max(kern["max_abs_err"], main_res["max_abs_err"]),
        "ms": main_res["kernel_ms"],
        "plain_ms": main_res["sub_plain_ms"],
        "plain_at": f"{main_res['sub_blocks']} of the main path's "
                    f"{main_res['blocks']} blocks",
        "bound_ms": main_res["bound_ms"],
        "bound_by": main_res["bound_by"],
        "library_ms": None,
    }, {
        "name": "multi_dp", "route": "cuda",
        "source": "opal_tpu_torch/engine/csrc/multi_dp.cu",
        "replaces": "opal_tpu/engine/pallas_kernels.py:1440:"
                    "build_pallas_multi_fn_raw",
        "launches": serve_res["launches"]["multi_dp"],
        "checked_cases": kern_multi["cases"] + serve_res["sub_cases"],
        "mismatches": kern_multi["mismatches"]
        + serve_res["sub_mismatches"],
        "max_abs_err": max(kern_multi["max_abs_err"],
                           serve_res["max_abs_err"]),
        "ms": serve_res["multi_dp_group_ms"],
        "ms_at": f"one group of 8 queries ({sum(serve_res['group_segments'])}"
                 f" rows) x the whole database",
        "plain_ms": serve_res["sub_plain_ms"],
        "plain_at": f"the same group x {serve_res['sub_blocks']} of the "
                    f"{serve_res['blocks']} blocks",
        "bound_ms": serve_res["bound_ms"],
        "bound_by": serve_res["bound_by"],
        "library_ms": None,
    }]})
    # count is what torch sees: 1 on the one-card machine this runs on
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
