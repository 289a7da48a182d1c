#!/usr/bin/env python3
"""Smoke run of opal_tpu_torch on one NVIDIA GPU (H100): python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero before
the last line:

1. device  - the card's name and power limit (nvidia-smi);
2. build   - nvcc builds every kernel from opal_tpu_torch/engine/csrc and
             every probe from opal_tpu_torch/tools/csrc, one nvcc per
             source, all started together, then cc the host C library
             (opal_tpu_torch/_native: FASTA tokenizer, traceback);
3. tools   - the measurement tools' main path (opal_tpu_torch.tools:
             roofline, exp_unroll, exp_sstack_ablate, each probe launched):
             the int32 / DPX / f32 issue rates per SM per clock at the SM
             clock read under load, the probe loops' SASS opcode counts,
             the F-chain scan, ragged_dp's cells/s by slope, the column-body
             ablation on ragged_dp's strip-group body (every variant
             against `hooks`, the body in the probe's frame; base, ragged_dp
             itself, at forced G 1-8) and its tail pair (192 CUDA blocks against a full grid), the
             chains-per-thread ablation at the tool's and the main path's
             query heights; then every probe variant, at the launch plan's
             G and at every G, against its plain version at the tools'
             widths, exact. The measured ceiling gives every kernel its
             bound_measured_ms;
4. kernel  - ragged_dp (without and with its overflow-flag rows) and
             multi_dp against their plain PyTorch versions, both on the
             card, on random streams (4 modes x score / score+end, several
             gap pairs, query lengths and stacked segment sets, partial
             first blocks, passes through scratch in several waves; the
             flag cases reach 8, 16 and 32 bits in every mode); exact
             equality;
4b. kernel_mapping - the strip-group mapping (G threads per lane) against
             the plain versions: lanes of mixed lengths and empty lanes in
             one warp, queries of 1, 15, 16, 17, 127, 128, 129 and 1,000
             rows at every G (kernels.MAX_GROUP 1-8, passes past the first
             through scratch), every G in one launch, SW ends and OV
             last-column maxima tied across strips of different threads,
             multi_dp segments that start mid-pass; exact;
4c. soak    - opal_tpu_torch.tools.soak: 120 random problems (alphabets,
             matrices with entries near the int32 bound, gap pairs with
             ge > go and 0/0, query lengths, adversarial length mixes)
             through ragged_dp and multi_dp against the scalar oracle;
5. goldens - the port on the card against the reference binary's output
             for the 12,071-sequence fixture: result lines of the 16 x0/x1
             files, result lines and alignment blocks of the 6 x2 files;
6. main    - the single-query path at full scale: O74807 (SW, score,
             BLOSUM50, gaps 3/1) against 541,762 synthetic sequences held
             resident, through search_database_arrays, timed by the bench's
             protocol (opal_tpu_torch.bench.measure: 11 or 17 runs, the
             kernel alone, the idle share, the 48-sequence gate);
             ragged_dp's ms per launch and the launch plan's G per block;
             then ragged_dp against the plain version on blocks of that
             database;
6b. bench  - python -m opal_tpu_torch.bench at its defaults in a fresh
             process: its lines checked (the four keys of the last, value
             above 0, ragged_dp launched, no plain call, the gate) and
             printed beside phase 6's GCUPS;
7. serve   - the serving path on the same resident database:
             opal_tpu_torch.serve.Server answers the 15 queries of
             tests/port_data/uniprot_sprot15.fasta as one batch request
             (stacked multi_dp launches, top 10 selected on the card), as
             15 single-query lines batched by _respond_many, as NW/HW/OV
             batches and a cache hit; every hit list is
             checked against the host ranking of a full ragged_dp score
             table; then multi_dp against its plain version on blocks of
             that database;
8. cascade - Engine(precision="adaptive") at full scale (SW x0, NW x1)
             through ragged_dp's flag rows: scores and ends against the
             int32 path, precision counts, search_database_char_sw, the
             flag kernel against its plain version on blocks;
9. serve_align - the 15-query batch with align: true, top 10, against
             search_database(search_type=2, align_top_k=10) per query;
10. cli     - python -m opal_tpu_torch.cli as subprocesses on a FASTA copy
             of the database: -s -x 0 (trailer, and a --profile run for the
             card's idle share) and -x 2 --align-top 10 against the API;
11. kernel_panels - the panel role of ragged_dp (K6) against the plain
             chain of ragged_panel_plain, panel by panel, exact: 4 modes x
             x0/x1 x flags off and on, gaps (3,1), (2,2), (0,0), (1,3),
             queries of 17 to 1,000 rows in 16-, 32- and 48-row panels (tails
             of 1 row among them), partial first blocks, several waves, and a
             100,000-residue query on the resident database's first block;
12. kernel_grouped - grouped_score (K7, ragged_dp over dense [G, T, B]
             blocks) against grouped_score_plain, exact, and timed on 64
             blocks of the resident database;
13. long_query - a 100,000-residue query (SW x0) against the resident
             database through search_database_arrays in panels: seconds,
             GCUPS, kernel ms per launch and per wave, launches, the bound;
             the same search at PANEL_ROWS 1,024, 4,096, 16,384 and in one
             sweep, all equal; a 16,000-residue query in 4 modes at x1,
             panels equal to the one sweep; one served batch with that query
             beside the 15 uniprot_sprot15 queries, equal to the API;
14. device_fill - the alignment fill and walk of the x2 winners on the card
             (OPAL_TPU_DEVICE_FILL=1): the device_fill kernel against its
             plain version, exact on all five outputs, in 4 modes x 5 gap
             pairs on planted ties, 1-letter targets and a lane that is not
             ok, 1-lane and 512-lane groups, several groups in one call and
             groups cut by a small byte budget, and the warp wavefront's
             edge shapes (opal_tpu_torch.tools.fill_shapes: tlen 1/31/33,
             qlen one past a pass, narrow bands, stops near and far from
             tlen) at plan_fill's strip rows and at 16; then
             opal_tpu_torch.tools.exp_device_fill's protocol at full scale
             (a 513-residue query, SW x1 top 1,000 on the resident database,
             the winners aligned on the host, on the device and with the
             audit: identical, 0 warnings; times and the host lanes by
             reason); the kernel's ms and bound at those groups, each
             group's strip rows, passes and computed against executed
             columns, and ptxas's registers; the 6 x2
             golden files and the served align batch with the switch;
15. multi_device - the database over a device mesh on the one card
             (opal_tpu_torch.parallel): the dry run dryrun_multichip(2) (the
             card named twice); the main path (SW x0 best of 5, SW x1 top
             10) without a mesh, on a 1-device mesh and in 2 parts on the
             card, all equal, with each part's kernel ms and launches; each
             part's ragged_dp and multi_dp against their plain versions on
             its first block; a 16,000-residue query at x1 in panels on the
             2-part mesh, equal to no mesh; then two OS processes in one
             gloo group sharing the card (python -m
             opal_tpu_torch.parallel.multihost on 4 FASTA shards of the
             database, a 2-part mesh each): ranked top 10 at x0 and x1 and
             search_aligned top 5, equal to one process's search.
16. host_tools - the ten host tools of opal_tpu_torch.tools, each through
             its run(...) at its protocol on the card, the resident
             database of phase 6 where the tool reads the 541,762
             sequences: serve_qps (8 clients x 12 unique 110-residue
             queries, batching window 0.004 s against 0, identical
             answers; its curve cut to 1 and 16 clients), serve_latency
             (8 warm requests, without and with align, the card's idle
             share over the warm ones from a torch.profiler trace), one
             request after a 20 s idle gap without and with
             Server.start_keepalive(5), exp_x1_gap (P18080 and O74807 in 4
             modes, the x1 search split at each synchronize), exp_topk,
             exp_align_topk (top 1,000 of a 513-residue query), perf (4
             modes x 2 queries and stacked), tb_scaling (4,000 pairs at 1,
             2 and 4 workers, identical), exp_panel_mesh, exp_panels (5
             query lengths up to 100,000, panels against one sweep and the
             plain version) and exp_panel_rows (6 heights, best of 4); each
             tool's equality checks, and the kernels it launched
             (kernels.LAUNCHES) beside its numbers.

Then the run's seconds, the kernels line and the last line
{"ok": true, "device": {...}}.
Needs CUDA, nvcc and the repository checkout around this file; imports
nothing of JAX or opal_tpu.
"""
import contextlib
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
# With the overflow flags (K4): SW adds half a __vimax3_s32 for ulH + P (two
# cells per instruction); NW/HW/OV cells need 3 max-type ones (E and F by
# __viaddmax_s32, H by __vimax3_s32) and add min E, min F and max H, two
# cells per 3-input instruction, so 1.5 more.
FLAG_CELL_MAXES = {"SW": CELL_MAXES + 0.5, "NW": 3 + 1.5}
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


def op_bound_ms(cells, maxes=CELL_MAXES, adds=CELL_ADDS):
    """Least milliseconds the card takes for `cells` DP cells in int32 with
    `maxes` max-type and `adds` add instructions each (an SW score-only
    cell by default): the max-type instructions on the ALU pipe, or all
    instructions on the schedulers' issue rate, whichever is slower, at the
    card's SM count and highest SM clock."""
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(re.match(r"\s*([\d.]+)\s*MHz", nvidia_smi("clocks.max.sm"))
                .group(1))
    clk_per_cell = max(maxes / ALU_PER_SM_CLK,
                       (adds + maxes) / ISSUE_PER_SM_CLK)
    return cells * clk_per_cell / (n_sm * mhz * 1e6) * 1e3, n_sm, mhz


def ptxas_summary(log):
    """{instantiation: "N registers, S spill bytes"} from ptxas's report;
    ragged_dp's instantiations read mode<M>_end<E>_flags<F> (and _panel for
    its panel role), multi_dp's mode<M>_end<E>, device_fill's
    device_fill_mode<M>_rows<R>, a probe's <name>_kernel<template
    arguments>."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELb(\d)E(?:Lb(\d)E)?(?:Lb(\d)E)?",
                          m.group(1))
            name = m.group(1)
            probe = re.search(r"(peak|scan|unroll|sstack)_kernel", name)
            fill = re.search(r"device_fill_kernelILi(\d)ELi(\d+)E", name)
            if fill:
                t, name = None, (f"device_fill_mode{fill.group(1)}"
                                 f"_rows{fill.group(2)}")
            elif probe:  # a tools probe: its template arguments
                t = None
                name = probe.group(0) + "<" + ",".join(
                    re.findall(r"L[ib](\d+)E", name)) + ">"
            if t:
                name = f"mode{t.group(1)}_end{t.group(2)}" + (
                    f"_flags{t.group(3)}" if t.group(3) else "") + (
                    "_panel" if t.group(4) == "1" else "")
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            out[name] = f"{m.group(1)} spill bytes"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out


def measured_bound_ms(cells, ceiling, maxes=CELL_MAXES):
    """The least milliseconds for `cells` cells of `maxes` max-type
    instructions each at the max-type rate the roofline probe measured on
    this card (per SM per clock, at the SM clock read while it ran)."""
    return cells * maxes / (ceiling["max_per_sm_clk"] * ceiling["sm_count"]
                            * ceiling["sm_mhz_under_load"] * 1e6) * 1e3


def phase_tools(smi):
    """The measurement tools' main path, then each probe against its plain
    version (see the module docstring, phase 3)."""
    import torch

    from opal_tpu_torch import tools
    from opal_tpu_torch.engine import kernels
    from opal_tpu_torch.tools import exp_sstack_ablate as ss
    from opal_tpu_torch.tools import exp_unroll, roofline

    t0 = time.perf_counter()
    tools.reset_counts()
    kernels.reset_counts()
    roof = roofline.run("cuda", seconds=0.5)
    unroll = exp_unroll.run("cuda", ceiling=roof["ceiling"])
    sstack = ss.run("cuda", ceiling=roof["ceiling"])
    launches = dict(tools.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"a tool launched no probe: {launches}")
    check(kernels.PLAIN_CALLS["ragged_score_plain"] == 0,
          "a tool ran ragged_dp's plain version")
    run_s = time.perf_counter() - t0
    ceil = roof["ceiling"]
    res = {"phase": "tools", "card": smi, "launches": launches,
           "ceiling": ceil, "max_sm_mhz": roof["max_sm_mhz"],
           "peak": roof["peak"]["variants"], "scan": roof["scan"],
           "kernel_slope": roof["kernel"],
           "unroll": unroll["variants"], "unroll_B": unroll["B"],
           "unroll_g_sweep": unroll["g_sweep"],
           "tail": unroll["tail"], "sstack": sstack["variants"],
           "sstack_main_height": sstack["main_height"],
           "sstack_B": sstack["B"], "run_s": run_s}
    emit({k: res[k] for k in ("phase", "card", "ceiling", "max_sm_mhz",
                              "peak", "launches")})

    # each probe against its plain version at the main path's shapes
    entries = {}

    def diff(got, want):  # float64 holds the int32 and f32 states exactly
        d = (got.double() - want.double()).abs()
        return int((d != 0).sum()), float(d.max()) if d.numel() else 0.0

    n = roof["peak"]["elements"]
    cases = bad = err = 0
    for v in roofline.VARIANTS:
        for seed in (None, 1):
            st = roofline.peak_state(v, n, "cuda", seed=seed)
            b, e = diff(roofline.peak(st, 64, 8, v),
                        roofline.peak_plain(st, 64, 8, v))
            cases, bad, err = cases + 1, bad + b, max(err, e)
    st = roofline.peak_state("i32", n, "cuda", seed=1)
    peak_i32 = roof["peak"]["variants"]["i32"]
    updates = n * roof["peak"]["iters"] * roof["peak"]["unroll"] * 8
    # an update needs one max-type instruction at least (nvcc's own i32
    # and DPX loops issue just that: one VIADDMNMX)
    ops_ms = op_bound_ms(updates, 1, 0)[0]
    entries["roofline_peak"] = {
        "replaces": "tools/roofline.py:97:build_peak_kernel",
        "source": "opal_tpu_torch/tools/csrc/roofline.cu",
        "checked_cases": cases, "mismatches": bad, "max_abs_err": err,
        "ms": peak_i32["ms"],
        "ms_at": f"i32 form, {n} elements x {updates // n} chain updates",
        "variants_ms": {v: r["ms"] for v, r in res["peak"].items()},
        "plain_ms": time_cuda(lambda: roofline.peak_plain(st, 64, 8, "i32"),
                              1),
        "plain_at": f"i32 form, {n} elements x {64 * 8 * 8} chain updates, "
                    f"where the probe takes {time_cuda(lambda: roofline.peak(st, 64, 8, 'i32'), 3):.3f} ms",
        "bound_ms": ops_ms, "bound_by": "operations",
        "bound_measured_ms": measured_bound_ms(updates, ceil, 1)}

    sc = roof["scan"]
    cases = bad = err = 0
    for seed in (0, 1):
        H = torch.from_numpy(np.random.default_rng(seed).integers(
            -300, 300, (sc["qp"], sc["B"])).astype(np.int32)).cuda()
        b, e = diff(roofline.scan(H, 64, 1), roofline.scan_plain(H, 64, 1))
        cases, bad, err = cases + 1, bad + b, max(err, e)
    row_cells = sc["qp"] * sc["B"] * sc["columns"]
    entries["roofline_scan"] = {
        "replaces": "tools/roofline.py:141:build_scan_kernel",
        "source": "opal_tpu_torch/tools/csrc/roofline.cu",
        "checked_cases": cases, "mismatches": bad, "max_abs_err": err,
        "ms": sc["ms"], "ms_at": f"[{sc['qp']}, {sc['B']}] x "
                                 f"{sc['columns']} columns",
        "plain_ms": time_cuda(lambda: roofline.scan_plain(H, 64, 1), 1),
        "plain_at": f"the same H x 64 columns, where the probe takes "
                    f"{time_cuda(lambda: roofline.scan(H, 64, 1), 3):.3f} ms",
        # a row needs two max-type instructions (the chain's and H's)
        "bound_ms": op_bound_ms(row_cells, 2, 0)[0], "bound_by": "operations",
        "bound_measured_ms": measured_bound_ms(row_cells, ceil, 2)}

    # exp_unroll: every variant at the plan's G and at every G, and
    # ragged_dp, against the plain version on the tool's lanes, 8 chunks
    # long (at the tool's Q of 104, r32's last strip holds 24 padding rows)
    B = unroll["B"]
    profile, Q = exp_unroll.random_profile(unroll["qpad"], 1, 0, "cuda")
    stream = exp_unroll.random_stream(B, 8 * 64, 1, "cuda")
    t = time.perf_counter()
    want = exp_unroll.unroll_plain(profile, stream)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cases = bad = err = 0
    for v in exp_unroll.VARIANTS:
        for G in (None,) + exp_unroll.GROUPS:
            b, e = diff(exp_unroll.unroll_score(profile, stream, v, G=G),
                        want)
            cases, bad, err = cases + 1, bad + b, max(err, e)
    b, e = diff(exp_unroll.single(profile, stream), want)
    cases, bad, err = cases + 1, bad + b, max(err, e)
    cells = unroll["cells"]
    hooks = unroll["variants"]["hooks"]  # the probe's kernel, default body
    entries["exp_unroll"] = {
        "replaces": "tools/exp_unroll.py:127:build",
        "source": "opal_tpu_torch/tools/csrc/exp_unroll.cu",
        "checked_cases": cases, "mismatches": bad, "max_abs_err": err,
        "ms": hooks["ms"], "ms_at": f"hooks at G {hooks['G']}, Q "
                                    f"{unroll['Q']} x {B} lanes x "
                                    f"{unroll['columns']} columns",
        "variants_ms": {v: r["ms"] for v, r in unroll["variants"].items()},
        "g_sweep_ms": {G: r["ms"] for G, r in unroll["g_sweep"].items()},
        "plain_ms": plain_ms,
        "plain_at": f"the same lanes, 512 columns, where hooks takes "
                    f"{time_cuda(lambda: exp_unroll.unroll_score(profile, stream, 'hooks'), 3):.3f} ms",
        "bound_ms": op_bound_ms(cells)[0], "bound_by": "operations",
        "bound_measured_ms": measured_bound_ms(cells, ceil)}
    del stream

    # exp_sstack: every S, strips2, noprof and s1ctl, each at the plan's G
    # and at every G, against the plain version on the tool's streams, 8
    # chunks long; at the main path's query height the lane and strip
    # variants again
    S = sstack["S"]
    cases = bad = err = 0
    plain_ms = None
    for qpad in (sstack["qpad"], sstack["main_height"]["qpad"]):
        profile, stream, meta, nb = ss.random_inputs(
            qpad, sstack["B"], 8, S, sstack["per_block"], 1, 1, "cuda")
        t = time.perf_counter()
        want = ss.sstack_plain(profile, stream, meta, nb)
        torch.cuda.synchronize()
        if plain_ms is None:
            plain_ms = (time.perf_counter() - t) * 1e3
            full_ms = time_cuda(
                lambda: ss.sstack_score(profile, stream, meta, nb, S), 3)
            plain_at = (f"the same streams, 512 columns, where full at S {S}"
                        f" takes {full_ms:.3f} ms")
        for G in (None,) + ss.GROUPS:
            for lanes in (1, 2, 4):
                b, e = diff(ss.sstack_score(profile, stream, meta, nb, lanes,
                                            G=G), want)
                cases, bad, err = cases + 1, bad + b, max(err, e)
            b, e = diff(ss.sstack_score(profile, stream, meta, nb,
                                        strips2=True, G=G), want)
            cases, bad, err = cases + 1, bad + b, max(err, e)
        if qpad == sstack["qpad"]:
            want = ss.sstack_plain(profile, stream, meta, nb, True)
            ctl = ss.s1ctl_inputs(profile, stream, meta, S)
            want_ctl = ss.sstack_plain(*ctl, nb)
            for G in (None,) + ss.GROUPS:
                b, e = diff(ss.sstack_score(profile, stream, meta, nb, S,
                                            True, G=G), want)
                cases, bad, err = cases + 1, bad + b, max(err, e)
                b, e = diff(ss.sstack_score(*ctl, nb, 1, G=G), want_ctl)
                cases, bad, err = cases + 1, bad + b, max(err, e)
            del ctl, want_ctl
        del stream
    cells = sstack["cells"]
    entries["exp_sstack"] = {
        "replaces": "tools/exp_sstack_ablate.py:182:build_variant",
        "source": "opal_tpu_torch/tools/csrc/exp_sstack.cu",
        "checked_cases": cases, "mismatches": bad, "max_abs_err": err,
        "ms": sstack["variants"][f"full{S}"]["ms"],
        "ms_at": f"full at S {S}, G {sstack['variants'][f'full{S}']['G']},"
                 f" qpad {sstack['qpad']} x {S} x {sstack['B']} lanes x "
                 f"{sstack['columns']} columns",
        "variants_ms": {v: r["ms"] for v, r in sstack["variants"].items()},
        "main_height_ms": {v: r["ms"] for v, r in
                           sstack["main_height"]["variants"].items()},
        "plain_ms": plain_ms, "plain_at": plain_at,
        "bound_ms": op_bound_ms(cells)[0], "bound_by": "operations",
        "bound_measured_ms": measured_bound_ms(cells, ceil)}
    for name, e in entries.items():
        e["launches"] = launches[name]
    res["entries"] = entries
    res["seconds"] = round(time.perf_counter() - t0, 1)
    emit({k: res[k] for k in ("phase", "scan", "kernel_slope", "unroll",
                              "unroll_B", "unroll_g_sweep", "tail", "sstack",
                              "sstack_main_height", "sstack_B", "entries",
                              "run_s", "seconds")})
    bad = {k: e["mismatches"] for k, e in entries.items() if e["mismatches"]}
    check(not bad, f"probes disagree with their plain versions: {bad}")
    return res


@contextlib.contextmanager
def plan_knobs(**values):
    """Set kernels' launch-plan constants (MAX_GROUP, SCRATCH_CELLS,
    RESIDENT_THREADS_PER_SM, PANEL_ROWS) for the duration of a block."""
    from opal_tpu_torch.engine import kernels

    saved = {k: getattr(kernels, k) for k in values}
    for k, v in values.items():
        setattr(kernels, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(kernels, k, v)


def plan_groups_summary(plan, ddb):
    """{G: {blocks, residues, CUDA blocks, shortest and longest lane}} of a
    launch plan over the resident database."""
    from opal_tpu_torch.engine import kernels

    out = {}
    for g in sorted(set(plan.groups.tolist())):
        bl = np.flatnonzero(plan.groups == g)
        lens = np.concatenate([ddb.blocks[b].lengths[:ddb.blocks[b].n]
                               for b in bl])
        out[int(g)] = {"blocks": len(bl), "residues": int(lens.sum()),
                       "cuda_blocks": len(bl) * -(-ddb.block_size * int(g)
                                                  // kernels.THREADS),
                       "lane_min": int(lens.min()), "lane_max": int(lens.max())}
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


def compare(profile, stream, mode, x, go, ge, seg_qs=None, with_flags=False):
    """(mismatching entries, max |diff|) of kernel vs plain rows: ragged_dp
    (with its flag rows when with_flags), or multi_dp when seg_qs (the
    stacked segments' lengths) is given."""
    import torch

    from opal_tpu_torch.engine import kernels

    if seg_qs is None:
        got = kernels.ragged_score(profile, stream, mode, x, go, ge,
                                   with_flags)
        want = kernels.ragged_score_plain(profile, stream, mode, x, go, ge,
                                          with_flags)
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
    for gaps, qs, tmax in (((3, 1), (1, 37, 110, 513, 1100), 3000),
                           ((2, 2), (37, 513), 2000),
                           ((0, 0), (37, 513), 2000),
                           ((1, 3), (1, 37, 64), 300)):
        for Q in qs:
            for mode in range(4):
                for x in (0, 1):
                    cases.append((gaps, Q, min(tmax, 3000 if Q < 513
                                               else 1500), mode, x))
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
    # several launches (waves) over one stream: G capped at 1 and 4 leaves
    # passes past the first, handed on through scratch, and a small
    # scratch budget splits the database into waves
    profile = torch.from_numpy(kernels.build_profile(
        matrix[rng.integers(0, A, size=110)].T)).to(dev)
    stream = random_stream(rng, 2000, 2000, 128, A, dev)
    for max_group in (1, 4):
        with plan_knobs(MAX_GROUP=max_group,
                        SCRATCH_CELLS=int(stream.host_offsets[-1]) // 4):
            for mode in range(4):
                before = kernels.LAUNCHES["ragged_dp"]
                bad, err = compare(profile, stream, mode, 1, 3, 1)
                check(kernels.LAUNCHES["ragged_dp"] - before > 1,
                      "wave case ran in one launch")
                n_cases += 1
                mismatches += bad
                max_err = max(max_err, err)
    res = {"phase": "kernel", "kernel": "ragged_dp", "cases": n_cases,
           "mismatches": mismatches, "max_abs_err": max_err, "tolerance": 0,
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    check(mismatches == 0, "ragged_dp disagrees with ragged_score_plain")
    return res


def phase_kernel_flags(matrix, dev):
    """ragged_dp with its overflow-flag rows (K4) vs ragged_score_plain with
    flags on random streams: 4 modes x x0/x1, gaps (3,1), (2,2), (0,0),
    (1,3), queries of 1, 16, 17 and 110 rows (partial last strips), partial
    first blocks, several waves. The matrix is scaled by 1, 40 or 400 in
    turn, so that every mode has lanes that need 16 and 32 bits and no
    flag only reads its initial value."""
    import torch

    from opal_tpu_torch.engine import cascade, kernels

    rng = np.random.default_rng(2026)
    A = matrix.shape[0]
    n_cases = mismatches = max_err = 0
    reached = {m: set() for m in range(4)}
    t0 = time.perf_counter()

    def one(profile, stream, mode, x, go, ge):
        nonlocal n_cases, mismatches, max_err
        bad, err = compare(profile, stream, mode, x, go, ge, with_flags=True)
        n_cases += 1
        mismatches += bad
        max_err = max(max_err, err)
        tr = kernels.ragged_score(profile, stream, mode, x, go, ge, True)
        cols = kernels.finalize_device(tr, stream.lengths, mode, x,
                                       profile.shape[0], True)
        real = (stream.lengths > 0).reshape(-1).cpu().numpy()
        flags = {k: v.reshape(-1).cpu().numpy()[real]
                 for k, v in cols.items()}
        reached[mode] |= set(cascade.classify_precision(flags, mode).tolist())
        return bad

    k = 0
    for (go, ge), tmax in (((3, 1), 700), ((2, 2), 500), ((0, 0), 500),
                           ((1, 3), 200)):
        for Q in (1, 16, 17, 110):
            for mode in range(4):
                for x in (0, 1):
                    scale = (1, 40, 400)[k % 3]
                    query = rng.integers(0, A, size=Q)
                    profile = torch.from_numpy(kernels.build_profile(
                        scale * matrix[query].T)).to(dev)
                    B = (256, 200)[k % 2]
                    k += 1
                    stream = random_stream(rng, 3 * B - 57, tmax, B, A, dev)
                    if one(profile, stream, mode, x, go, ge):
                        emit({"phase": "kernel_flags", "mismatch": {
                            "mode": mode, "x": x, "go": go, "ge": ge,
                            "Q": Q, "scale": scale, "tmax": tmax, "B": B}})
    # several launches (waves) over one stream, passes through scratch
    profile = torch.from_numpy(kernels.build_profile(
        40 * matrix[rng.integers(0, A, size=110)].T)).to(dev)
    stream = random_stream(rng, 2000, 1500, 128, A, dev)
    with plan_knobs(MAX_GROUP=2,
                    SCRATCH_CELLS=int(stream.host_offsets[-1]) // 4):
        for mode in range(4):
            before = kernels.LAUNCHES["ragged_dp_flags"]
            one(profile, stream, mode, 1, 3, 1)
            check(kernels.LAUNCHES["ragged_dp_flags"] - before > 1,
                  "flag wave case ran in one launch")
    res = {"phase": "kernel", "kernel": "ragged_dp_flags", "cases": n_cases,
           "mismatches": mismatches, "max_abs_err": max_err, "tolerance": 0,
           "precisions_reached": {m: sorted(v) for m, v in reached.items()},
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    check(mismatches == 0, "ragged_dp with flags disagrees with "
          "ragged_score_plain")
    check(all(v == {8, 16, 32} for v in reached.values()),
          f"flag cases do not reach 8, 16 and 32 bits in every mode: "
          f"{res['precisions_reached']}")
    return res


def mixed_stream(rng, n_blocks, B, max_len, A, device):
    """Blocks whose lanes have unsorted lengths 0..max_len, a fifth of them
    empty: one warp holds lanes of every length."""
    from opal_tpu_torch.engine import kernels

    letters, lengths = [], []
    for _ in range(n_blocks):
        lens = rng.integers(0, max_len + 1, size=B)
        lens[rng.random(B) < 0.2] = 0
        letters.append(rng.integers(0, A, size=(max(1, int(lens.max())),
                                                B)).astype(np.int8))
        lengths.append(lens.astype(np.int32))
    return kernels.pack_stream(letters, lengths, B, device)


def planted(rng, Q, n, A=12):
    """(query, database, matrix): two 6-letter motifs repeated in the query
    at rows 3, 21, 37 and 53 (strips 0-3) and at its end, and targets that
    hold them in crossed order and end with one, so SW ends tie across
    strips of different threads (some reached at an earlier column by a
    later strip) and OV's last-column maxima tie with row Q-1."""
    matrix = np.where(np.eye(A, dtype=bool), 5, -4).astype(np.int32)
    query = rng.integers(0, A, size=Q)
    x, y = rng.integers(0, A, size=6), rng.integers(0, A, size=6)
    for at, m in ((3, x), (21, y), (37, x), (53, y), (Q - 6, x)):
        if 0 <= at and at + 6 <= Q:
            query[at:at + 6] = m
    db = []
    for i in range(n):
        t = rng.integers(0, A, size=int(rng.integers(0, 90)))
        if len(t) >= 30 and i % 3:
            a, b = (y, x) if i % 2 else (x, y)
            t[4:10], t[len(t) - 6:] = a, b
        db.append(t.astype(np.uint8))
    return query, db, matrix


def phase_kernel_mapping(matrix, dev):
    """The strip-group mapping against the plain versions on random
    streams (see the module docstring, phase 4b)."""
    import torch

    from opal_tpu_torch.engine import batching, kernels

    rng = np.random.default_rng(2029)
    A = matrix.shape[0]
    t0 = time.perf_counter()
    n_cases = mismatches = max_err = 0
    groups_seen = set()

    def tally(name, bad, err, **case):
        nonlocal n_cases, mismatches, max_err
        n_cases += 1
        mismatches += bad
        max_err = max(max_err, err)
        if bad:
            emit({"phase": "kernel_mapping", "mismatch": dict(
                case=name, entries=bad, **case)})

    def prof(q, m=matrix):
        return torch.from_numpy(kernels.build_profile(
            m[np.asarray(q, np.int64)].T)).to(dev)

    def packed(db, B):
        blocks = batching.plan_blocks(db, B)
        return kernels.pack_stream([b.letters for b in blocks],
                                   [b.lengths for b in blocks], B, dev)

    # lanes of mixed lengths and empty lanes in one warp; queries at the
    # strip and group edges; every G; passes past the first
    k = 0
    for Q in (1, 15, 16, 17, 127, 128, 129, 1000):
        stream = mixed_stream(rng, 3, 72, 90 if Q == 1000 else 300, A, dev)
        profile = prof(rng.integers(0, A, size=Q))
        for max_group in (1, 2, 4, 8):
            with plan_knobs(MAX_GROUP=max_group):
                groups_seen |= set(kernels.plan_for(
                    stream, -(-Q // 16)).groups.tolist())
                for mode, flags in ((k % 4, False), (k % 4, True)):
                    bad, err = compare(profile, stream, mode, 1, 3, 1,
                                       with_flags=flags)
                    tally("mixed_lanes", bad, err, Q=Q, mode=mode,
                          max_group=max_group, flags=flags)
                k += 1
    check(groups_seen == {1, 2, 4, 8}, f"G in use: {sorted(groups_seen)}")
    # every G in one launch: short blocks G = 1, long ones larger
    stream = random_stream(rng, 900, 1200, 64, A, dev)
    with plan_knobs(RESIDENT_THREADS_PER_SM=8):
        plan = kernels.plan_for(stream, 19)
        check(set(plan.groups.tolist()) == {1, 2, 4, 8},
              f"one launch mixes G {sorted(set(plan.groups.tolist()))}")
        profile = prof(rng.integers(0, A, size=300))
        for mode in range(4):
            bad, err = compare(profile, stream, mode, 1, 3, 1)
            tally("mixed_groups", bad, err, mode=mode)
    # SW ends and OV last-column maxima tied across strips of different
    # threads, the last column's max on the row-Q-1 thread
    for max_group in (2, 4, 8):
        query, db, m = planted(rng, 70, 300)
        stream = packed(db, 128)
        with plan_knobs(MAX_GROUP=max_group):
            for mode in (3, 2):
                bad, err = compare(prof(query, m), stream, mode, 1, 2, 1)
                tally("ties", bad, err, mode=mode, max_group=max_group)
    # multi_dp: segments that start mid-pass at every G
    segs = (5, 40, 16, 17, 33, 2, 64, 1)  # 1,3,1,2,3,1,4,1 strips
    query, db, m = planted(rng, sum(segs), 300)
    cuts = np.cumsum((0,) + segs)
    mprof, seg_qs = multi_profile(
        m, [query[cuts[i]:cuts[i + 1]] for i in range(len(segs))], dev)
    stream = packed(db, 128)
    for max_group in (1, 2, 4, 8):
        with plan_knobs(MAX_GROUP=max_group):
            for mode in range(4):
                bad, err = compare(mprof, stream, mode, 1, 3, 1, seg_qs)
                tally("multi_mid_pass", bad, err, mode=mode,
                      max_group=max_group)
    res = {"phase": "kernel_mapping", "cases": n_cases,
           "mismatches": mismatches, "max_abs_err": max_err, "tolerance": 0,
           "groups_seen": sorted(groups_seen),
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    check(mismatches == 0, "the strip-group mapping disagrees with the "
          "plain versions")
    return res


def phase_soak(trials=120):
    """opal_tpu_torch.tools.soak on the card: random problems through
    ragged_dp and multi_dp against the scalar oracle."""
    from opal_tpu_torch.tools import soak

    res = soak.run(trials=trials, seed=6, device="cuda")
    res["phase"] = "soak"
    emit(res)
    check(res["failures"] == 0, f"soak: {res.get('first_failure')}")
    check(res["launches"]["ragged_dp"] > 0 and res["launches"]["multi_dp"] > 0
          and sum(res["plain_calls"].values()) == 0,
          f"soak did not run both kernels alone: {res['launches']}")
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
    with plan_knobs(SCRATCH_CELLS=int(stream.host_offsets[-1]) // 4):
        for mode in range(4):
            before = kernels.LAUNCHES["multi_dp"]
            bad, err = compare(profile, stream, mode, 1, 3, 1, seg_qs)
            check(kernels.LAUNCHES["multi_dp"] - before > 1,
                  "multi_dp wave case ran in one launch")
            n_cases += 1
            mismatches += bad
            max_err = max(max_err, err)
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


def render_text(query, db, res, alphabet, base=0):
    """The CLI's text of result lines, each followed by its alignment
    blocks (what the reference binary's goldens hold)."""
    from opal_tpu_torch.render import render_alignment, result_line

    lines = []
    for i, (r, t) in enumerate(zip(res, db)):
        lines.append(result_line(base + i, r))
        if r.alignment is not None:
            lines.append(render_alignment(query, t, r, alphabet))
    return "\n".join(lines) + "\n"


def phase_goldens(sm, engine):
    from opal_tpu_torch import _native
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
    t1 = time.perf_counter()
    x2_files, x2_lines, x2_bad = x2_goldens(sm, engine, ddb, db)
    res = {"phase": "goldens", "configs": configs, "sequences": len(db),
           "mismatching_lines": bad_lines, "x2_files": x2_files,
           "x2_lines": x2_lines, "x2_mismatching_lines": x2_bad,
           "x2_seconds": round(time.perf_counter() - t1, 1),
           "native_traceback": _native.available(),
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    check(configs == 16 and bad_lines == 0, "golden result lines differ")
    check(x2_files == 6 and x2_bad == 0,
          "x2 golden lines (results or alignment blocks) differ")
    check(_native.available(), "the native host library did not load")
    return db, ddb


def x2_goldens(sm, engine, ddb, db):
    """The 6 x2 golden files of the 12,071-sequence fixture against
    search_database(search_type=2): result lines and alignment blocks, the
    whole file. Returns (files, lines, mismatching lines)."""
    import glob

    from opal_tpu_torch.constants import MODE_CODES
    from opal_tpu_torch.engine.search import search_database
    from opal_tpu_torch.fasta import read_fasta_file

    lut = sm.letter_index()
    x2_files = sorted(glob.glob(os.path.join(
        HERE, "tests", "golden_large", "*__synth12071__*_x2_o3_e1.txt.gz")))
    x2_lines = x2_bad = 0
    for path in x2_files:
        qname, _, rest = os.path.basename(path).split("__")
        qs, _ = read_fasta_file(
            os.path.join(HERE, "tests", "port_data", f"{qname}.fasta"), lut)
        res = search_database(qs[0], ddb, 3, 1, sm.matrix,
                              mode=MODE_CODES[rest.split("_")[0]],
                              search_type=2, engine=engine)
        # these files end with one more blank line than the CLI prints
        mine = render_text(qs[0], db, res, sm.alphabet).rstrip(
            "\n").splitlines()
        with gzip.open(path, "rt") as f:
            want = f.read().rstrip("\n").splitlines()
        x2_lines += len(want)
        x2_bad += sum(a != b for a, b in zip(mine, want)) + abs(
            len(mine) - len(want))
    return len(x2_files), x2_lines, x2_bad


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


def launch_split(fn):
    """Kernel ms of each launch of one fn(events) call (CUDA events)."""
    import torch

    events = []
    fn(events)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for *_, a, b in events]


def full_scale_server(sm):
    """The serving path's Server over 541,762 synthetic sequences (seed
    12071) held resident on the card, the sequences as ASCII letters, and
    the set-up seconds."""
    import torch

    from opal_tpu_torch.serve import Server
    from opal_tpu_torch.synth import make_db_arrays

    t0 = time.perf_counter()
    lut = sm.letter_index()
    ascii_db = make_db_arrays(541762, seed=12071)
    db = [lut[a] for a in ascii_db]
    names = [f"synth12071|{i}" for i in range(len(db))]
    srv = Server.from_sequences(db, names, sm, block_size=1024,
                                device="cuda")
    torch.cuda.synchronize()
    return srv, ascii_db, time.perf_counter() - t0


def phase_main(sm, engine, ddb, setup_s, smi):
    import torch

    from opal_tpu_torch import bench
    from opal_tpu_torch.constants import MODE_OV, MODE_SW, SEARCH_SCORE
    from opal_tpu_torch.engine import kernels
    from opal_tpu_torch.engine.search import search_database_arrays
    from opal_tpu_torch.fasta import read_fasta_file

    lut = sm.letter_index()
    db = ddb.raw
    total = ddb.total_residues
    qs, _ = read_fasta_file(
        os.path.join(HERE, "tests", "port_data", "O74807.fasta"), lut)
    query = qs[0]
    Q = len(query)

    # bench.py's protocol, as the bench runs it (it sets the counts to 0
    # after its warm-up and reads them after the timed runs), with its
    # 48-sequence gate against the plain version on the CPU
    m = bench.measure(query, ddb, engine, sm)
    out = m["scores"]
    check(m["launches"] > 0, "main path launched no ragged_dp")
    check(m["plain_calls"] == 0, "main path ran the plain version")
    check(out.shape == (len(db),) and out.dtype == np.int32
          and int(out.min()) >= 0, "SW scores malformed")
    check(m["runs_differ"] == 0, "repeated searches differ")
    check(m["gate_mismatches"] == 0,
          "full-scale scores differ from the CPU plain version")

    def search(mode, x):
        t = time.perf_counter()
        search_database_arrays(query, ddb, 3, 1, sm.matrix, mode=mode,
                               search_type=x, engine=engine)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    x1_s = search(MODE_SW, 1)
    ov_s = search(MODE_OV, 1)

    # the kernel against its plain version on blocks of this database
    # (every 24th block and the last)
    profile = engine._backend.prepare_query(
        sm.matrix[query.astype(np.int64)].T, 3, 1)
    kernel_ms = m["kernel_ms"]
    plan = kernels.plan_for(ddb.stream, -(-Q // kernels.STRIP_ROWS))
    split = launch_split(lambda ev: kernels.ragged_score(
        profile, ddb.stream, MODE_SW, SEARCH_SCORE, 3, 1, events=ev))
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
        "search_s": m["runs_s"], "best_s": m["best_s"],
        "median_s": m["median_s"], "max_over_min": m["max_over_min"],
        "gcups": m["gcups"], "launches": m["launches"],
        "launches_per_search": m["launches_per_search"],
        "plain_calls": m["plain_calls"], "gate_seqs": m["gate_seqs"],
        "host_ms": m["host_ms"],
        "max_memory_allocated_bytes": m["max_memory_allocated_bytes"],
        "device_idle_share": m["device_idle_share"],
        "sw_x1_s": x1_s, "ov_x1_s": ov_s,
        "kernel_ms": kernel_ms, "kernel_gcups": cells / kernel_ms / 1e6,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ops_ms": ops_ms, "bytes_ms": bytes_ms, "sm_count": n_sm,
        "max_sm_mhz": max_mhz,
        "launch_ms": split, "groups": plan_groups_summary(plan, ddb),
        "scratch_cells": plan.scratch_cells,
        "blocks": len(ddb.blocks), "sub_blocks": len(sel), "sub_cells": sub_cells,
        "sub_kernel_ms": sub_kernel_ms, "sub_plain_ms": plain_ms,
        "sub_cases": 8, "sub_mismatches": bad, "max_abs_err": err,
        "tolerance": 0,
        "card": smi,
    }
    emit(res)
    return res


def phase_bench(main_res, smi):
    """python -m opal_tpu_torch.bench at its defaults in a fresh process
    (after the build, so it loads the libraries built and never waits on
    the build's lock): its lines, checked, beside phase_main's
    in-process numbers; no gate on their ratio."""
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if k not in ("BENCH_SEQS", "BENCH_BLOCK")}
    r = subprocess.run([sys.executable, "-m", "opal_tpu_torch.bench"],
                       cwd=HERE, env=env, capture_output=True, text=True,
                       timeout=600)
    check(r.returncode == 0, f"the bench exited {r.returncode}: "
          f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    last = lines[-1]
    by = {ln["bench"]: ln for ln in lines[:-1]}
    check(list(last) == ["metric", "value", "unit", "vs_baseline"],
          f"the bench's last line {last}")
    check(last["value"] > 0, f"the bench's value {last['value']}")
    check(by["launches"]["ragged_dp_per_search"] >= 1,
          "the bench launched no ragged_dp")
    check(by["launches"]["plain_calls"] == 0,
          "the bench ran the plain version")
    check(by["gate"]["mismatches"] == 0, "the bench's gate failed")
    res = {"phase": "bench", "seconds": time.perf_counter() - t0,
           "last": last, "lines": by,
           "main_gcups": main_res["gcups"], "main_best_s": main_res["best_s"],
           "main_kernel_ms": main_res["kernel_ms"], "card": smi}
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
    multi_split = launch_split(lambda ev: kernels.multi_score(
        profile, seg_qs, ddb.stream, MODE_SW, SEARCH_SCORE, 3, 1,
        events=ev))
    multi_plan = kernels.plan_for(ddb.stream,
                                  profile.shape[0] // kernels.STRIP_ROWS)
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
        "multi_dp_group_ms": multi_ms, "multi_dp_launch_ms": multi_split,
        "multi_dp_groups": plan_groups_summary(multi_plan, ddb),
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


def _o74807(sm):
    from opal_tpu_torch.fasta import read_fasta_file

    qs, _ = read_fasta_file(
        os.path.join(HERE, "tests", "port_data", "O74807.fasta"),
        sm.letter_index())
    return qs[0]


def phase_cascade(sm, engine, ddb, smi):
    """The adaptive cascade at full scale: Engine(precision="adaptive")
    with search_database at SW x0 and NW x1 on the resident database,
    through ragged_dp with its flag rows; scores and ends against the int32
    path, the flag kernel against its plain version on blocks of the
    database, search_database_char_sw against the precision counts."""
    import torch

    from opal_tpu_torch.constants import MODE_NW, MODE_SW, OVERFLOW_BUCKETS
    from opal_tpu_torch.engine import cascade, kernels
    from opal_tpu_torch.engine.search import (
        Engine,
        _search_stats,
        search_database,
        search_database_arrays,
    )

    adaptive = Engine(device="cuda", block_size=ddb.block_size,
                      precision="adaptive")
    query = _o74807(sm)
    Q = len(query)
    total = ddb.total_residues
    profile = engine._backend.prepare_query(
        sm.matrix[query.astype(np.int64)].T, 3, 1)
    res = {"phase": "cascade", "sequences": ddb.n, "residues": total,
           "query": "O74807", "Q": Q, "card": smi, "modes": {},
           "groups": plan_groups_summary(kernels.plan_for(
               ddb.stream, -(-Q // kernels.STRIP_ROWS)), ddb)}
    launches = 0
    for name, mode, x, reps in (("SW", MODE_SW, 0, 3), ("NW", MODE_NW, 1, 1)):
        search_database(query, ddb, 3, 1, sm.matrix, mode=mode,
                        search_type=x, engine=adaptive)  # warm-up
        kernels.reset_counts()
        runs = []
        for _ in range(reps):
            t = time.perf_counter()
            out = search_database(query, ddb, 3, 1, sm.matrix, mode=mode,
                                  search_type=x, engine=adaptive)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
        n_launch = kernels.LAUNCHES["ragged_dp_flags"]
        check(n_launch > 0, f"adaptive {name} launched no ragged_dp_flags")
        check(kernels.LAUNCHES["ragged_dp"] == 0
              and sum(kernels.PLAIN_CALLS.values()) == 0,
              f"adaptive {name} ran another kernel or a plain version")
        launches += n_launch
        stats = adaptive.last_search_stats
        want = search_database_arrays(query, ddb, 3, 1, sm.matrix,
                                      mode=mode, search_type=x,
                                      engine=engine)
        got_score = np.fromiter((r.score for r in out), np.int64, ddb.n)
        check(np.array_equal(got_score, want["score"]),
              f"adaptive {name} scores differ from the int32 path")
        if x:
            for k, attr in (("end_q", "end_location_query"),
                            ("end_t", "end_location_target")):
                got = np.fromiter((getattr(r, attr) for r in out), np.int64,
                                  ddb.n)
                check(np.array_equal(got, want[k]),
                      f"adaptive {name} {k} differ from the int32 path")
        counts = stats["precision_counts"]
        check(sum(counts.values()) == ddb.n, "precision counts")
        # where a search's time goes: the scoring pass with the flag
        # columns' copy back, then the statistics; the rest is the result
        # objects
        t = time.perf_counter()
        idx, cols = adaptive.score_blocks(query, ddb, 3, 1, sm.matrix, mode,
                                          x, with_flags=True)
        score_s = time.perf_counter() - t
        t = time.perf_counter()
        _search_stats(idx, cols, mode, ddb.n, OVERFLOW_BUCKETS)
        stats_s = time.perf_counter() - t
        buckets = stats["bucket_escalations"]
        flag_ms = time_cuda(lambda: kernels.ragged_score(
            profile, ddb.stream, mode, x, 3, 1, True), 3)
        plain_kernel_ms = time_cuda(lambda: kernels.ragged_score(
            profile, ddb.stream, mode, x, 3, 1), 3)
        cells = Q * total
        ops_ms, _, _ = op_bound_ms(cells, FLAG_CELL_MAXES[name])
        rows = len(kernels.tracker_rows(mode, x, True))
        bytes_ms = (ddb.stream.letters.numel()
                    + 4 * ddb.stream.lengths.numel() * (1 + rows)
                    + 4 * profile.numel()) / HBM_BYTES_PER_S * 1e3
        res["modes"][name] = {
            "x": x, "search_s": runs, "best_s": min(runs),
            "score_blocks_s": score_s, "stats_s": stats_s,
            "launches": n_launch, "launches_per_search": n_launch / reps,
            "precision_counts": counts,
            "buckets": len(buckets["n"]),
            "buckets_over8": int((buckets["over8"] > 0).sum()),
            "buckets_over16": int((buckets["over16"] > 0).sum()),
            "rerun_stage8": int(stats["rerun_mask_stage8"].sum()),
            "rerun_stage16": int(stats["rerun_mask_stage16"].sum()),
            "flag_kernel_ms": flag_ms, "no_flag_kernel_ms": plain_kernel_ms,
            "flag_launch_ms": launch_split(lambda ev: kernels.ragged_score(
                profile, ddb.stream, mode, x, 3, 1, True, events=ev)),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_per_cell": FLAG_CELL_MAXES[name]}
        if name == "SW":
            over8 = counts[16] + counts[32]

    # search_database_char_sw: its flagged sequences are the SW over-8 ones
    t = time.perf_counter()
    char = cascade.search_database_char_sw(query, ddb, 3, 1, sm.matrix,
                                           engine=engine)
    res["char_sw_s"] = time.perf_counter() - t
    flagged = sum(r.score_set == 0 for r in char)
    res["char_sw_flagged"] = flagged
    check(flagged == over8, f"char SW flagged {flagged}, the cascade "
          f"counts {over8} over 8 bits")

    # the flag kernel against its plain version on blocks of this database
    sel = list(range(0, len(ddb.blocks), 48))
    sub = kernels.pack_stream(
        [ddb.blocks[b].letters for b in sel],
        [ddb.blocks[b].lengths for b in sel], ddb.block_size, ddb.device)
    bad = err = 0
    for mode, x in ((MODE_SW, 0), (MODE_NW, 1)):
        b_, e_ = compare(profile, sub, mode, x, 3, 1, with_flags=True)
        bad += b_
        err = max(err, e_)
    check(bad == 0, "ragged_dp with flags disagrees with the plain version "
          "on blocks of the database")
    res.update({
        "sub_blocks": len(sel), "blocks": len(ddb.blocks), "sub_cases": 2,
        "sub_mismatches": bad, "max_abs_err": err, "tolerance": 0,
        "sub_kernel_ms": time_cuda(lambda: kernels.ragged_score(
            profile, sub, MODE_SW, 0, 3, 1, True), 3),
        "sub_plain_ms": time_cuda(lambda: kernels.ragged_score_plain(
            profile, sub, MODE_SW, 0, 3, 1, True), 1),
        "launches": launches})
    emit(res)
    return res


def phase_serve_align(srv, smi):
    """align: true at full scale: the 15-query batch, top 10, against
    search_database(search_type=2, align_top_k=10) for each query."""
    import torch

    from opal_tpu_torch.engine import kernels
    from opal_tpu_torch.engine.search import search_database
    from opal_tpu_torch.ranking import rank_scores
    from opal_tpu_torch.render import ops_to_cigar

    texts = read_queries(os.path.join(HERE, "tests", "port_data",
                                      "uniprot_sprot15.fasta"))
    line = json.dumps({"id": "al", "queries": texts, "align": True,
                       "top_k": 10})
    srv._cache.clear()
    srv._respond(line)  # warm-up
    kernels.reset_counts()
    runs = []
    for _ in range(3):
        srv._cache.clear()
        t = time.perf_counter()
        out = srv._respond(line)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
    launches = dict(kernels.LAUNCHES)
    plain = dict(kernels.PLAIN_CALLS)
    check(launches["multi_dp"] > 0, "align requests launched no multi_dp")
    check(sum(plain.values()) == 0, "align requests ran a plain version")
    hits = json.loads(out).get("hits")
    check(hits is not None and len(hits) == 15, f"align answer: {out[:300]}")
    t = time.perf_counter()
    n_paths = 0
    for i, q in enumerate(texts):
        res = search_database(srv._encode_query(q), srv.ddb, 3, 1,
                              srv.sm.matrix, search_type=2, align_top_k=10,
                              engine=srv.engine)
        order = rank_scores(np.array([r.score for r in res]), 10)
        want = [[int(j), res[j].score, res[j].start_location_query,
                 res[j].start_location_target, res[j].end_location_query,
                 res[j].end_location_target,
                 ops_to_cigar(res[j].alignment)
                 if res[j].alignment is not None else None] for j in order]
        check(hits[i] == want, f"query {i}: aligned top 10 differ from "
              "search_database(search_type=2, align_top_k=10)")
        n_paths += sum(h[6] is not None for h in want)
    res = {"phase": "serve_align", "queries": 15, "top_k": 10,
           "request_s": runs, "best_s": min(runs), "launches": launches,
           "plain_calls": plain, "paths": n_paths,
           "api_check_s": time.perf_counter() - t, "card": smi}
    emit(res)
    return res


def phase_cli(sm, srv, ascii_db, smi):
    """python -m opal_tpu_torch.cli at full scale, as subprocesses on a
    FASTA copy of the resident database written to a temporary directory:
    -s -x 0 (the trailer's time and GCUPS), the same with --profile (the
    card's idle share within the search), and -x 2 --align-top 10, whose
    per-chunk lines must equal the API's x1 result lines and whose global
    top 10 the API's x2 search."""
    import shutil
    import tempfile

    import torch

    from opal_tpu_torch import _native
    from opal_tpu_torch.engine.search import search_database
    from opal_tpu_torch.ranking import rank_scores
    from opal_tpu_torch.render import result_line
    from opal_tpu_torch.tools import idle_share

    query = _o74807(sm)
    qpath = os.path.join(HERE, "tests", "port_data", "O74807.fasta")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t = time.perf_counter()
        dbpath = os.path.join(tmp, "synth12071.fasta")
        with open(dbpath, "wb") as f:
            for i, a in enumerate(ascii_db):
                f.write(b">synth12071|%d\n" % i)
                f.write(a.tobytes())
                f.write(b"\n")
        res = {"phase": "cli", "fasta_bytes": os.path.getsize(dbpath),
               "write_fasta_s": time.perf_counter() - t, "card": smi}

        def run(args, out_path=None):
            t = time.perf_counter()
            with open(out_path or os.devnull, "w") as out:
                r = subprocess.run(
                    [sys.executable, "-m", "opal_tpu_torch.cli", *args,
                     qpath, dbpath], cwd=HERE, stdout=out,
                    stderr=subprocess.PIPE, text=True, timeout=600)
            check(r.returncode == 0, f"cli {args}: {r.stderr[-2000:]}")
            return time.perf_counter() - t

        def trailer(text):
            cpu = float(re.search(r"Cpu time of searching: ([\d.]+)",
                                  text).group(1))
            m = re.search(r"GCUPS \(giga cell updates per second\): "
                          r"([\d.]+)", text)
            return cpu, float(m.group(1)) if m else None

        # the upload the CLI's timed search includes (Engine._get_resident)
        t = time.perf_counter()
        up = srv.engine.upload(srv.db)
        torch.cuda.synchronize()
        res["upload_s"] = time.perf_counter() - t
        del up

        x0_out = os.path.join(tmp, "x0.txt")
        res["x0_wall_s"] = run(["-s", "-a", "SW", "-x", "0"], x0_out)
        with open(x0_out) as f:
            res["x0_cpu_time_s"], res["x0_gcups"] = trailer(f.read())

        prof = os.path.join(tmp, "prof")
        res["x0_profiled_wall_s"] = run(["-s", "-a", "SW", "-x", "0",
                                         "--profile", prof], x0_out)
        with open(x0_out) as f:
            res["x0_profiled_cpu_time_s"] = trailer(f.read())[0]
        res.update(idle_share(os.path.join(prof, "chunk0.json")))

        x2_out = os.path.join(tmp, "x2.txt")
        res["x2_wall_s"] = run(["-a", "SW", "-x", "2", "--align-top", "10"],
                               x2_out)
        with open(x2_out) as f:
            text = f.read()
        res["x2_cpu_time_s"] = trailer(text)[0]
        head, glob_part = text.split("\nGlobal top 10 alignments:\n")
        glob_part = glob_part[: glob_part.index("\nCpu time of searching")]
        lines = [ln for ln in head.splitlines()
                 if re.match(r"#\d+: ", ln)]
        api1 = search_database(query, srv.ddb, 3, 1, sm.matrix,
                               search_type=1, engine=srv.engine)
        want = [result_line(i, r) for i, r in enumerate(api1)]
        res["x2_chunk_lines"] = len(lines)
        res["x2_chunk_mismatching_lines"] = sum(
            a != b for a, b in zip(lines, want)) + abs(len(lines) - len(want))
        check(len(lines) == srv.ddb.n
              and res["x2_chunk_mismatching_lines"] == 0,
              "cli -x 2 per-chunk lines differ from the API's x1 lines")
        api2 = search_database(query, srv.ddb, 3, 1, sm.matrix,
                               search_type=2, align_top_k=10,
                               engine=srv.engine)
        order = rank_scores(np.array([r.score for r in api2]), 10)
        top = [api2[i] for i in order]
        want_glob = "".join(
            render_text(query, [srv.db[i]], [r], sm.alphabet, base=int(i))
            for i, r in zip(order, top))
        check(glob_part == want_glob, "cli global top 10 differs from "
              "search_database(search_type=2, align_top_k=10)")
        res["x2_global_top"] = [int(i) for i in order]
        res["native_traceback"] = _native.available()
        check(res["native_traceback"], "the native host library did not "
              "load")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(res)
    return res


def panel_plan(Q, rows):
    """((row0, rows), ...) of a Q-row query in `rows`-row panels."""
    return tuple((r0, min(rows, Q - r0)) for r0 in range(0, Q, rows))


def compare_panels(profile, stream, mode, x, go, ge, with_flags, panels):
    """(mismatching entries, max |diff|) of the panel kernel's rows against
    the plain chain of ragged_panel_plain, over every panel."""
    import torch

    from opal_tpu_torch.engine import kernels

    got = kernels.ragged_panel_score(profile, stream, mode, x, go, ge,
                                     with_flags, panels=panels)
    top, bad, err = None, 0, 0
    for (row0, rows), g in zip(panels, got):
        w, top = kernels.ragged_panel_plain(profile, stream, mode, x, go, ge,
                                            with_flags, row0, rows, top)
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        bad += int((diff != 0).sum())
        err = max(err, int(diff.max()) if diff.numel() else 0)
    torch.cuda.synchronize()
    return bad, err


def phase_kernel_panels(matrix, dev):
    """The panel role of ragged_dp (K6) vs the plain chain on random
    streams."""
    import torch

    from opal_tpu_torch.engine import kernels

    rng = np.random.default_rng(2027)
    A = matrix.shape[0]
    # (gaps, (query rows, panel rows), longest target): 1-row tails at
    # 17/16, 33/32 and 97/48; the plain version's row loop (gap_ext >
    # gap_open) is slow, so that pair runs small
    plan = (((3, 1), ((17, 16), (33, 32), (80, 48), (1000, 48)), 300),
            ((2, 2), ((33, 16), (97, 48)), 250),
            ((0, 0), ((33, 16), (97, 48)), 250),
            ((1, 3), ((17, 16), (33, 32)), 120))
    n_cases = mismatches = max_err = 0
    t0 = time.perf_counter()
    k = 0
    for (go, ge), shapes, tmax in plan:
        for Q, rows in shapes:
            for mode in range(4):
                for x in (0, 1):
                    for flags in (False, True):
                        if Q > 500 and flags != bool((mode + x) % 2):
                            continue  # the plain chain is slow here
                        scale = (1, 40)[k % 2] if flags else 1
                        query = rng.integers(0, A, size=Q)
                        profile = torch.from_numpy(kernels.build_profile(
                            scale * matrix[query].T)).to(dev)
                        B = (256, 200)[k % 2]
                        k += 1
                        stream = random_stream(rng, 3 * B - 57, tmax, B, A,
                                               dev)
                        bad, err = compare_panels(profile, stream, mode, x,
                                                  go, ge, flags,
                                                  panel_plan(Q, rows))
                        n_cases += 1
                        mismatches += bad
                        max_err = max(max_err, err)
                        if bad:
                            emit({"phase": "kernel_panels", "mismatch": {
                                "mode": mode, "x": x, "go": go, "ge": ge,
                                "Q": Q, "rows": rows, "flags": flags,
                                "B": B, "entries": bad}})
    # several launches (waves) over one stream, panels inside each
    profile = torch.from_numpy(kernels.build_profile(
        matrix[rng.integers(0, A, size=110)].T)).to(dev)
    stream = random_stream(rng, 2000, 1500, 128, A, dev)
    with plan_knobs(SCRATCH_CELLS=int(stream.host_offsets[-1]) // 4):
        for mode in range(4):
            for flags in (False, True):
                before = kernels.LAUNCHES["ragged_dp_panel"]
                bad, err = compare_panels(profile, stream, mode, 1, 3, 1,
                                          flags, panel_plan(110, 32))
                check(kernels.LAUNCHES["ragged_dp_panel"] - before > 4,
                      "panel wave case ran in one wave")
                n_cases += 1
                mismatches += bad
                max_err = max(max_err, err)
    res = {"phase": "kernel_panels", "kernel": "ragged_dp_panel",
           "cases": n_cases, "mismatches": mismatches,
           "max_abs_err": max_err, "tolerance": 0,
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    check(mismatches == 0, "the panel kernel disagrees with "
          "ragged_panel_plain")
    return res


def dense_blocks(ddb, first, G):
    """G consecutive blocks of the resident database as grouped_score's
    dense input on its device: letters [G, T, B] int8 (T the longest
    t_pad, PAD_LETTER padding) and lengths [G, B] int32."""
    import torch

    from opal_tpu_torch.engine import batching

    blocks = ddb.blocks[first:first + G]
    T = max(b.t_pad for b in blocks)
    letters = np.full((G, T, ddb.block_size), batching.PAD_LETTER, np.int8)
    for g, b in enumerate(blocks):
        letters[g, : b.t_pad] = b.letters
    lengths = np.stack([b.lengths for b in blocks]).astype(np.int32)
    return (torch.from_numpy(letters).to(ddb.device),
            torch.from_numpy(lengths).to(ddb.device))


def phase_kernel_grouped(sm, ddb, smi):
    """grouped_score (K7) vs grouped_score_plain on random dense blocks,
    then the entry point alone on 64 blocks of the resident database."""
    import torch

    from opal_tpu_torch.constants import MODE_SW, SEARCH_SCORE
    from opal_tpu_torch.engine import kernels

    matrix = sm.matrix
    rng = np.random.default_rng(2028)
    A = matrix.shape[0]
    t0 = time.perf_counter()
    n_cases = mismatches = max_err = 0
    for mode in range(4):
        for x in (0, 1):
            for flags in (False, True):
                G, T, B = 3, 201, (256, 200)[n_cases % 2]
                lengths = rng.integers(0, T + 1, size=(G, B)).astype(
                    np.int32)
                letters = rng.integers(0, A, size=(G, T, B)).astype(np.int8)
                profile = torch.from_numpy(kernels.build_profile(
                    matrix[rng.integers(0, A, size=45)].T)).to(ddb.device)
                args = (profile, torch.from_numpy(letters).to(ddb.device),
                        torch.from_numpy(lengths).to(ddb.device), mode, x,
                        3, 1, flags)
                got = kernels.grouped_score(*args)
                want = kernels.grouped_score_plain(*args)
                torch.cuda.synchronize()
                diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
                n_cases += 1
                mismatches += int((diff != 0).sum())
                max_err = max(max_err, int(diff.max()))
    check(mismatches == 0, "grouped_score disagrees with "
          "grouped_score_plain")
    # the entry point on 64 blocks of the database around its median
    # length, O74807, SW x0
    query = _o74807(sm)
    profile = torch.from_numpy(kernels.build_profile(
        matrix[query.astype(np.int64)].T)).to(ddb.device)
    G = min(64, len(ddb.blocks))
    first = (len(ddb.blocks) - G) // 2
    letters, lengths = dense_blocks(ddb, first, G)
    args = (profile, letters, lengths, MODE_SW, SEARCH_SCORE, 3, 1)
    kernels.reset_counts()
    got = kernels.grouped_score(*args)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["ragged_dp_grouped"]
    check(launches > 0 and sum(kernels.PLAIN_CALLS.values()) == 0,
          "grouped_score launched no ragged_dp")
    want = kernels.grouped_score_plain(*args)
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    n_cases += 1
    mismatches += int((diff != 0).sum())
    max_err = max(max_err, int(diff.max()))
    check(mismatches == 0, "grouped_score disagrees with "
          "grouped_score_plain on database blocks")
    ms = time_cuda(lambda: kernels.grouped_score(*args), 5)
    plain_ms = time_cuda(lambda: kernels.grouped_score_plain(*args), 1)
    cells = len(query) * int(lengths.sum())
    ops_ms, _, _ = op_bound_ms(cells)
    bytes_ms = (letters.numel() + 4 * lengths.numel() * 2
                + 4 * profile.numel()) / HBM_BYTES_PER_S * 1e3
    res = {"phase": "kernel_grouped", "kernel": "ragged_dp_grouped",
           "cases": n_cases, "mismatches": mismatches,
           "max_abs_err": max_err, "tolerance": 0,
           "G": G, "T": int(letters.shape[1]), "B": ddb.block_size,
           "first_block": first, "cells": cells, "launches": launches,
           "ms": ms, "gcups": cells / ms / 1e6, "plain_ms": plain_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "card": smi, "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    return res


def long_query(sm, n, seed):
    """A query of n residues drawn with numpy from synth.FREQ over
    synth.AA (seed `seed`): (letter indices, ASCII string)."""
    from opal_tpu_torch import synth

    rng = np.random.default_rng(seed)
    ascii_q = rng.choice(np.frombuffer(synth.AA.encode(), np.uint8), size=n,
                         p=synth.FREQ)
    return sm.letter_index()[ascii_q], ascii_q.tobytes().decode()


def phase_long_query(sm, srv, smi):
    """Long queries through the panels at full scale (see the module
    docstring, phase 12)."""
    import torch

    from opal_tpu_torch.constants import MODE_SW, SEARCH_SCORE
    from opal_tpu_torch.engine import kernels
    from opal_tpu_torch.engine.search import search_database_arrays
    from opal_tpu_torch.ranking import rank_scores

    ddb, engine, matrix = srv.ddb, srv.engine, sm.matrix
    total = ddb.total_residues
    query, _ = long_query(sm, 100_000, 100_000)
    Q = len(query)
    default_rows = kernels.PANEL_ROWS
    plan = kernels.plan_for(ddb.stream, default_rows // kernels.STRIP_ROWS,
                            True)
    waves = plan.waves
    wave_residues = [int(sum(int(ddb.blocks[b].lengths.sum()) for b in w))
                     for w in waves]
    res = {"phase": "long_query", "sequences": ddb.n, "residues": total,
           "Q": Q, "seed": 100_000, "panel_rows": default_rows,
           "waves": len(waves), "groups": plan_groups_summary(plan, ddb),
           "scratch_cells": plan.scratch_cells, "card": smi}

    def search(q, rows, mode=MODE_SW, x=SEARCH_SCORE):
        """(seconds, columns, per-launch CUDA events) of one
        search_database_arrays call with PANEL_ROWS = rows (None: one
        sweep)."""
        events = []
        wrapped = {}
        for name in ("ragged_panel_score", "ragged_score"):
            fn = wrapped[name] = getattr(kernels, name)
            setattr(kernels, name, lambda *a, _fn=fn, **k: _fn(
                *a, events=events, **k))
        kernels.PANEL_ROWS = (rows if rows is not None
                              else -(-len(q) // 16) * 16)
        try:
            t = time.perf_counter()
            out = search_database_arrays(q, ddb, 3, 1, matrix, mode=mode,
                                         search_type=x, engine=engine)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        finally:
            kernels.PANEL_ROWS = default_rows
            for name, fn in wrapped.items():
                setattr(kernels, name, fn)
        return dt, out, events

    def kernel_times(events):
        """(sum of launch ms, first start to last end ms, per-wave ms)"""
        ms = [(w, a.elapsed_time(b)) for w, _, a, b in events]
        per_wave = [sum(m for w2, m in ms if w2 == w)
                    for w in range(len(waves))]
        return (sum(m for _, m in ms),
                events[0][2].elapsed_time(events[-1][3]), per_wave, ms)

    # the timed run at the default panel height
    kernels.reset_counts()
    sec, out, events = search(query, default_rows)
    launches = kernels.LAUNCHES["ragged_dp_panel"]
    n_panels = len(kernels.plan_panels(Q))
    check(launches == len(waves) * n_panels,
          f"{launches} panel launches, not {len(waves)} x {n_panels}")
    check(kernels.LAUNCHES["ragged_dp"] == 0
          and sum(kernels.PLAIN_CALLS.values()) == 0,
          "the long query ran another kernel or a plain version")
    kms, span_ms, per_wave, launch_ms = kernel_times(events)
    cells = Q * total
    ops_ms, _, _ = op_bound_ms(cells)
    bytes_ms = (ddb.stream.letters.numel() + 4 * ddb.stream.lengths.numel()
                * (1 + n_panels) + 4 * Q * 32) / HBM_BYTES_PER_S * 1e3
    score = out["score"]
    check(score.shape == (ddb.n,) and int(score.min()) >= 0,
          "long-query SW scores malformed")
    res.update({
        "search_s": sec, "gcups": cells / sec / 1e9, "cells": cells,
        "launches": launches, "panels": n_panels,
        "kernel_ms": kms, "kernel_span_ms": span_ms,
        "kernel_gcups": cells / kms / 1e6,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "kernel_share_of_bound": max(ops_ms, bytes_ms) / kms,
        "per_wave": [{"blocks": len(blocks), "residues": r, "ms": m,
                      "gcups": Q * r / m / 1e6,
                      "launch_ms_min": min(x for w2, x in launch_ms
                                           if w2 == w),
                      "launch_ms_max": max(x for w2, x in launch_ms
                                           if w2 == w)}
                     for w, (blocks, r, m) in enumerate(
                         zip(waves, wave_residues, per_wave))],
        "launch_ms": [x for _, x in launch_ms]})
    emit({"phase": "long_query", "timed": {k: res[k] for k in (
        "search_s", "gcups", "launches", "kernel_ms", "bound_ms")}})

    # the same search at other panel heights and in one sweep: equal
    # columns; the times pick PANEL_ROWS
    sweep = {}
    for rows in (None, 1024, 4096, 16384):
        if rows == default_rows:
            sweep[rows] = (sec, kms, launches)
            continue
        kernels.reset_counts()
        s_, o_, ev = search(query, rows)
        check(all(np.array_equal(o_[k], out[k]) for k in out),
              f"Q=100,000 at PANEL_ROWS {rows} differs")
        sweep[rows] = (s_, kernel_times(ev)[0],
                       sum(kernels.LAUNCHES.values()))
        emit({"phase": "long_query", "panel_rows": rows or "one sweep",
              "search_s": s_, "kernel_ms": sweep[rows][1]})
    res["panel_rows_sweep"] = {str(k or "one_sweep"): {
        "search_s": v[0], "kernel_ms": v[1], "launches": v[2]}
        for k, v in sweep.items()}

    # the panel kernel against the plain chain at Q = 100,000 on the
    # database's first block (4 modes x x0/x1), and both timed there
    sub = kernels.pack_stream([ddb.blocks[0].letters],
                              [ddb.blocks[0].lengths], ddb.block_size,
                              ddb.device)
    profile = engine._backend.prepare_query(
        matrix[query.astype(np.int64)].T, 3, 1)
    panels = kernels.plan_panels(Q)
    bad = err = 0
    for mode in range(4):
        for x in (0, 1):
            b_, e_ = compare_panels(profile, sub, mode, x, 3, 1, False,
                                    panels)
            bad += b_
            err = max(err, e_)
    check(bad == 0, "the panel kernel disagrees with the plain chain at "
          "Q = 100,000 on the first block")

    def plain_chain():
        top = None
        for row0, rows in panels:
            _, top = kernels.ragged_panel_plain(profile, sub, MODE_SW, 0, 3,
                                                1, False, row0, rows, top)

    res.update({
        "sub_cases": 8, "sub_mismatches": bad, "max_abs_err": err,
        "tolerance": 0, "sub_residues": int(ddb.blocks[0].lengths.sum()),
        "sub_kernel_ms": time_cuda(lambda: kernels.ragged_panel_score(
            profile, sub, MODE_SW, 0, 3, 1, panels=panels), 3),
        "sub_plain_ms": time_cuda(plain_chain, 1)})

    # 16,000 residues, 4 modes at x1: panels equal the one sweep
    q16, text16 = long_query(sm, 16_000, 16_000)
    res["q16000"] = {}
    for mode in range(4):
        s_p, o_p, _ = search(q16, default_rows, mode, 1)
        s_1, o_1, _ = search(q16, None, mode, 1)
        check(set(o_p) == set(o_1) and all(
            np.array_equal(o_p[k], o_1[k]) for k in o_1),
            f"Q=16,000 mode {mode} x1: panels differ from the one sweep")
        res["q16000"][mode] = {"panels_s": s_p, "one_sweep_s": s_1}

    # one served batch: the 16,000-residue query beside the 15 queries
    texts = read_queries(os.path.join(HERE, "tests", "port_data",
                                      "uniprot_sprot15.fasta"))
    line = json.dumps({"id": "long", "queries": texts + [text16],
                       "top_k": 10})
    srv._cache.clear()
    kernels.reset_counts()
    t = time.perf_counter()
    got = json.loads(srv._respond(line))
    torch.cuda.synchronize()
    res["serve_batch_s"] = time.perf_counter() - t
    res["serve_launches"] = dict(kernels.LAUNCHES)
    check(kernels.LAUNCHES["multi_dp"] > 0
          and kernels.LAUNCHES["ragged_dp_panel"] > 0,
          "the served batch did not stack the short queries and run the "
          "long one in panels")
    check("hits" in got and len(got["hits"]) == 16, "served batch "
          "malformed")
    for i, q in enumerate([srv._encode_query(tx) for tx in texts] + [q16]):
        full = search_database_arrays(q, ddb, 3, 1, matrix, engine=engine)
        want = [[int(j), int(full["score"][j])]
                for j in rank_scores(full["score"], 10)]
        check(got["hits"][i] == want, f"served query {i} differs from the "
              "API")
    emit(res)
    return res


def _fasta_shards(ascii_db, n_shards, directory):
    """The database written as n_shards FASTA files of contiguous
    quarters (or other fractions) of it; returns their paths."""
    paths = []
    cuts = np.linspace(0, len(ascii_db), n_shards + 1).astype(int)
    for s in range(n_shards):
        p = os.path.join(directory, f"shard{s}.fasta")
        with open(p, "wb") as f:
            for i in range(cuts[s], cuts[s + 1]):
                f.write(b">synth12071|%d\n" % i)
                f.write(ascii_db[i].tobytes())
                f.write(b"\n")
        paths.append(p)
    return paths


def phase_multi_device(sm, srv, ascii_db, smi):
    """The database over a device mesh on the one card (see the module
    docstring, phase 15)."""
    import io
    import shutil
    import socket
    import tempfile

    import torch

    from opal_tpu_torch.constants import (
        MODE_SW,
        SEARCH_ALIGNMENT,
        SEARCH_SCORE,
        SEARCH_SCORE_END,
    )
    from opal_tpu_torch.engine import kernels
    from opal_tpu_torch.engine.search import (
        Engine,
        search_database,
        search_database_arrays,
    )
    from opal_tpu_torch.parallel.dryrun import dryrun_multichip
    from opal_tpu_torch.parallel.multihost import shard_for_process
    from opal_tpu_torch.parallel.shard import db_mesh

    t_phase = time.perf_counter()
    matrix, db = sm.matrix, srv.db
    query = _o74807(sm)
    Q = len(query)
    res = {"phase": "multi_device", "cuda_devices": torch.cuda.device_count(),
           "card": smi}

    # 1) the dry run over a 2-device mesh (the card named twice)
    kernels.reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        dry = dryrun_multichip(2)
    torch.cuda.synchronize()
    res["dryrun"] = {"seconds": time.perf_counter() - t,
                     "last_line": text.getvalue().strip().splitlines()[-1],
                     "live_parts": dry["live_parts"],
                     "distinct_devices": dry["distinct_devices"],
                     "launches": dict(kernels.LAUNCHES),
                     "plain_calls": sum(kernels.PLAIN_CALLS.values())}
    check(all(kernels.LAUNCHES[k] > 0 for k in
              ("ragged_dp", "multi_dp", "ragged_dp_panel"))
          and res["dryrun"]["plain_calls"] == 0,
          "the dry run did not launch ragged_dp, multi_dp and the panels")

    # 2) the main path (SW x0 best of 5, SW x1 top 10) without a mesh, on
    # a 1-device mesh and in 2 parts on the card
    layouts = {"none": (srv.engine, srv.ddb, None)}
    for name, devs in (("mesh1", ["cuda"]), ("mesh2", ["cuda", "cuda"])):
        eng = Engine(device="cuda", block_size=1024, mesh=db_mesh(devs))
        t = time.perf_counter()
        ddb = eng.upload(db)
        torch.cuda.synchronize()
        layouts[name] = (eng, ddb, time.perf_counter() - t)
    outs = {}
    for name, (eng, ddb, upload_s) in layouts.items():
        def search(x=SEARCH_SCORE, top_k=0):
            t = time.perf_counter()
            out = search_database_arrays(query, ddb, 3, 1, matrix,
                                         mode=MODE_SW, search_type=x,
                                         engine=eng, top_k=top_k)
            torch.cuda.synchronize()
            return time.perf_counter() - t, out

        live = [p for p in ddb.parts if p.blocks]
        search()  # warm-up
        kernels.reset_counts()
        runs = [search() for _ in range(5)]
        launches = kernels.LAUNCHES["ragged_dp"]
        check(launches >= 5 * len(live)
              and kernels.PLAIN_CALLS["ragged_score_plain"] == 0,
              f"{name}: ragged_dp was not launched on every part")
        search(SEARCH_SCORE_END, 10)  # warm-up
        top_s, top = search(SEARCH_SCORE_END, 10)
        outs[name] = (runs[0][1], top)
        profile = eng._backend.prepare_query(
            matrix[query.astype(np.int64)].T, 3, 1)
        parts = [{"blocks": len(p.blocks),
                  "residues": int(sum(int(b.lengths.sum())
                                      for b in p.blocks)),
                  "kernel_ms": time_cuda(lambda p=p: kernels.ragged_score(
                      profile, p.stream, MODE_SW, SEARCH_SCORE, 3, 1), 5),
                  "launch_ms": launch_split(
                      lambda ev, p=p: kernels.ragged_score(
                          profile, p.stream, MODE_SW, SEARCH_SCORE, 3, 1,
                          events=ev))}
                 for p in live]
        res[name] = {
            "parts": len(ddb.parts), "upload_s": upload_s,
            "search_s": [t for t, _ in runs],
            "best_s": min(t for t, _ in runs),
            "gcups": ddb.total_residues * Q / min(t for t, _ in runs) / 1e9,
            "launches": launches, "launches_per_search": launches / 5,
            "kernel_ms": time_cuda(lambda: eng._backend.dispatch_many(
                profile, ddb, 3, 1, MODE_SW, SEARCH_SCORE), 5),
            "part_kernels": parts, "sw_x1_top10_s": top_s}
    want_x0, want_top = outs["none"]
    for name in ("mesh1", "mesh2"):
        got_x0, got_top = outs[name]
        check(np.array_equal(got_x0["score"], want_x0["score"]),
              f"{name}: SW x0 scores differ from the search without a mesh")
        check(sorted(got_top) == sorted(want_top) and all(
            np.array_equal(got_top[k], want_top[k]) for k in want_top),
            f"{name}: SW x1 top 10 differs from the search without a mesh")

    # each part's kernels against their plain versions on its first block
    eng2, ddb2, _ = layouts["mesh2"]
    profile = eng2._backend.prepare_query(
        matrix[query.astype(np.int64)].T, 3, 1)
    mprof, seg_qs = multi_profile(
        matrix, [query, query[:40], long_query(sm, 200, 200)[0]],
        ddb2.device)
    cases = bad = m_cases = m_bad = err = 0
    for part in ddb2.parts:
        blk = part.blocks[0]
        sub = kernels.pack_stream([blk.letters], [blk.lengths],
                                  ddb2.block_size, part.device)
        for mode in range(4):
            for x in (0, 1):
                b_, e_ = compare(profile, sub, mode, x, 3, 1)
                cases, bad, err = cases + 1, bad + b_, max(err, e_)
        for x in (0, 1):
            b_, e_ = compare(mprof, sub, MODE_SW, x, 3, 1, seg_qs)
            m_cases, m_bad, err = m_cases + 1, m_bad + b_, max(err, e_)
    check(bad == 0 and m_bad == 0, "a part's kernels disagree with their "
          "plain versions")
    res.update(sub_cases=cases, sub_mismatches=bad, multi_sub_cases=m_cases,
               multi_sub_mismatches=m_bad, max_abs_err=err, tolerance=0)

    # 3) a 16,000-residue query at x1 in panels, 2 parts against none
    q16, _ = long_query(sm, 16_000, 16_000)
    long = {}
    for name in ("none", "mesh2"):
        eng, ddb, _ = layouts[name]
        kernels.reset_counts()
        t = time.perf_counter()
        out = search_database_arrays(q16, ddb, 3, 1, matrix, mode=MODE_SW,
                                     search_type=SEARCH_SCORE_END,
                                     engine=eng)
        torch.cuda.synchronize()
        long[name] = (time.perf_counter() - t, out,
                      kernels.LAUNCHES["ragged_dp_panel"])
    n_panels = len(kernels.plan_panels(len(q16)))
    check(long["mesh2"][2] >= 2 * n_panels, "the 2-part mesh did not run "
          "the long query's panels on both parts")
    check(all(np.array_equal(long["mesh2"][1][k], long["none"][1][k])
              for k in long["none"][1]),
          "Q=16,000 SW x1: the 2-part mesh differs from no mesh")
    res["q16000_x1"] = {name: {"search_s": s, "panel_launches": n}
                        for name, (s, _, n) in long.items()}

    # 4) two OS processes over gloo sharing the card: MultiHostSearch on 4
    # FASTA shards of the database against one process's search
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mh_")
    try:
        paths = _fasta_shards(ascii_db, 4, tmp)
        qpath = os.path.join(HERE, "tests", "port_data", "O74807.fasta")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out_base = os.path.join(tmp, "out.json")
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "opal_tpu_torch.parallel.multihost",
             "--init-method", f"tcp://localhost:{port}", "--rank", str(r),
             "--world-size", "2", "--query", qpath, "--out", out_base,
             "--mesh", "2", *paths], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            errs = [p.communicate(timeout=300)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
        res["two_process_s"] = time.perf_counter() - t
        for p, e in zip(procs, errs):
            check(p.returncode == 0, f"multihost worker: {e[-2000:]}")
        got = []
        for r in range(2):
            with open(f"{out_base}.{r}") as f:
                got.append(json.load(f))
        res["worker_launches"] = [g.pop("launches") for g in got]
        check(all(w["ragged_dp"] > 0 for w in res["worker_launches"])
              and not any(sum(g.pop("plain_calls").values()) for g in got),
              "a worker did not launch ragged_dp on the card")
        check(got[0] == got[1], "the two processes' results differ")
        lut = sm.letter_index()
        cuts = np.linspace(0, len(ascii_db), 5).astype(int)
        want, full = [], {}
        t = time.perf_counter()
        for s in range(2):
            shard = [lut[ascii_db[i]] for f in shard_for_process(
                range(4), s, 2) for i in range(cuts[f], cuts[f + 1])]
            rs = search_database(query, shard, 3, 1, matrix, mode=MODE_SW,
                                 search_type=SEARCH_ALIGNMENT,
                                 engine=srv.engine, align_top_k=5)
            want += [(r.score, s, i) for i, r in enumerate(rs)]
            full.update(((s, i), rs[i]) for i in range(len(rs)))
        res["one_process_s"] = time.perf_counter() - t
        want.sort(key=lambda w: (-w[0], w[1], w[2]))
        r0 = got[0]
        check(r0["sizes"] == [int(cuts[1] - cuts[0] + cuts[3] - cuts[2]),
                              int(cuts[2] - cuts[1] + cuts[4] - cuts[3])],
              "shard sizes")
        check([tuple(r) for r in r0["ranked"]] == want[:10],
              "two-process ranked top 10 (x0) differs from one process")
        check([tuple(r[:3]) for r in r0["ranked_ends"]] == want[:10]
              and all((eq, et) == (full[(s, i)].end_location_query,
                                   full[(s, i)].end_location_target)
                      for _, s, i, eq, et in r0["ranked_ends"]),
              "two-process ranked top 10 (x1) differs from one process")
        check([(w["score"], w["shard"], w["index"])
               for w in r0["aligned"]] == want[:5], "aligned top 5 order")
        for w in r0["aligned"]:
            r = full[(w["shard"], w["index"])]
            check((w["start_q"], w["start_t"], w["end_q"], w["end_t"],
                   w["ops"]) == (r.start_location_query,
                                 r.start_location_target,
                                 r.end_location_query,
                                 r.end_location_target,
                                 None if r.alignment is None
                                 else list(r.alignment)),
                  f"aligned winner {w['shard']}/{w['index']} differs")
        res["two_process"] = {"sizes": r0["sizes"],
                              "top1": r0["ranked"][0], "matches": True}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


# kernels each host tool must have launched in its run (tb_scaling runs
# on the host only)
TOOL_KERNELS = {
    "serve_qps": ("ragged_dp", "multi_dp"),
    "serve_latency": ("ragged_dp",),
    "serve_latency_align": ("ragged_dp",),
    "exp_x1_gap": ("ragged_dp",),
    "exp_topk": ("ragged_dp",),
    "exp_align_topk": ("ragged_dp",),
    "perf": ("ragged_dp", "multi_dp"),
    "tb_scaling": (),
    "exp_panel_mesh": ("ragged_dp_panel",),
    "exp_panels": ("ragged_dp_panel", "ragged_dp"),
    "exp_panel_rows": ("ragged_dp_panel",),
}
# seconds the card is left idle before one request, without and with the
# keepalive (beating every KEEPALIVE_S)
IDLE_GAP_S, KEEPALIVE_S = 20.0, 5.0
# the host tools' own protocol sizes where they bring their own data
TOOL_SIZES = {"tb_pairs": 4000, "mesh_q": 16000, "mesh_seqs": 3000,
              "panel_seqs": 8000, "panel_qlens": (6000, 16000, 34000, 65000,
                                                  100000),
              "rows_q": 16000}


def phase_host_tools(sm, srv, smi):
    """The ten host tools of opal_tpu_torch.tools on the resident database
    (see the module docstring, phase 16)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.profiler as tp

    from opal_tpu_torch.engine import kernels
    from opal_tpu_torch.engine.search import Engine
    from opal_tpu_torch.fasta import read_fasta_file
    from opal_tpu_torch.tools import (exp_align_topk, exp_panel_mesh,
                                      exp_panel_rows, exp_panels, exp_topk,
                                      exp_x1_gap, idle_share, perf,
                                      port_query, serve_latency, serve_qps,
                                      tb_scaling)

    t_phase = time.perf_counter()
    lut = sm.letter_index()
    engine, ddb, dev = srv.engine, srv.ddb, srv.engine.device
    res = {"phase": "host_tools", "card": smi, "tools": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_tools_")

    def tool(name, fn):
        kernels.reset_counts()
        t = time.perf_counter()
        out = fn()
        out.pop("answers", None)
        out["tool_s"] = time.perf_counter() - t
        out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        out["plain_calls"] = {k: v for k, v in kernels.PLAIN_CALLS.items()
                              if v}
        for k in TOOL_KERNELS[name]:
            check(out["launches"].get(k, 0) > 0,
                  f"{name} launched no {k}")
        if name != "exp_panels":  # its --check runs the plain version
            check(not out["plain_calls"], f"{name} ran a plain version")
        res["tools"][name] = out
        return out

    try:
        qps = tool("serve_qps", lambda: serve_qps.run(
            srv, clients=8, reqs=12, qlen=110, window=0.004, curve=[1, 16]))
        check(qps["identical"], "serve_qps: batched differs from serial")

        trace = os.path.join(tmp, "serve_latency.json")

        def profiled():
            prof = tp.profile(activities=[tp.ProfilerActivity.CPU,
                                          tp.ProfilerActivity.CUDA])

            class Around:
                def __enter__(self):
                    prof.start()

                def __exit__(self, *exc):
                    prof.stop()
                    prof.export_chrome_trace(trace)

            return Around()

        lat = tool("serve_latency", lambda: serve_latency.run(
            srv, qlen=110, top_k=10, reps=8, around=profiled))
        lat.update(idle_share(trace))
        tool("serve_latency_align", lambda: serve_latency.run(
            srv, qlen=110, top_k=10, reps=8, align=True))

        # one request after an idle gap, without and with the keepalive
        alpha = sm.alphabet
        wake = serve_qps.random_queries(np.random.default_rng(20), alpha, 4,
                                        110)
        tcp = serve_qps.start_server(srv, 0.0)
        try:
            c, f = serve_qps.connect(tcp.server_address[1])
            with c:
                def ask(q):
                    dt, r = serve_qps.request(
                        f, {"id": 0, "query": q, "top_k": 10})
                    check(len(r.get("hits", ())) == 10,
                          f"idle-wake request failed: {r}")
                    return dt * 1e3

                warm_ms = [ask(q) for q in wake[:2]]
                time.sleep(IDLE_GAP_S)
                off_ms = ask(wake[2])
                stop = srv.start_keepalive(KEEPALIVE_S)
                try:
                    time.sleep(IDLE_GAP_S)
                    on_ms = ask(wake[3])
                finally:
                    stop()
        finally:
            tcp.close()
        res["idle_wake"] = {
            "gap_s": IDLE_GAP_S, "keepalive_interval_s": KEEPALIVE_S,
            "warm_median_ms": lat["median_ms"], "warm_now_ms": warm_ms,
            "after_gap_keepalive_off_ms": off_ms,
            "after_gap_keepalive_on_ms": on_ms}

        queries = {q: port_query(q, lut) for q in ("P18080", "O74807")}
        tool("exp_x1_gap", lambda: exp_x1_gap.run(
            engine, ddb, queries, sm.matrix, repeats=3))
        tool("exp_topk", lambda: exp_topk.run(engine, ddb, sm.matrix,
                                              top_k=10, reps=4))
        tool("exp_align_topk", lambda: exp_align_topk.run(
            engine, ddb, sm.matrix, top_k=1000, qlen=513))
        tool("perf", lambda: perf.run(
            engine, ddb, {q: port_query(q, lut) for q in ("O74807",
                                                          "P18080")},
            sm.matrix, repeats=3, multi=True))
        gold_db, _ = read_fasta_file(
            os.path.join(HERE, "tests", "data", "synth12071.fasta.gz"), lut)
        tool("tb_scaling", lambda: tb_scaling.run(
            queries["P18080"], gold_db, tb_scaling.golden_x1("P18080", "SW"),
            sm.matrix, "SW", (1, 2, 4), TOOL_SIZES["tb_pairs"], dev))

        mq, mdb, mm = exp_panel_mesh.mesh_inputs(TOOL_SIZES["mesh_q"],
                                                 TOOL_SIZES["mesh_seqs"])
        tool("exp_panel_mesh", lambda: exp_panel_mesh.run(
            dev, mdb, mq, mm, reps=3))
        # exp_panels' and exp_panel_rows' database (each tool draws its
        # queries from the generator that drew it)
        pdb, pm, rng = exp_panels.panel_inputs(TOOL_SIZES["panel_seqs"])
        pengine = Engine(device=str(dev), block_size=1024)
        pddb = pengine.upload(pdb)
        pqs = {q: rng.integers(0, exp_panels.A, q, dtype=np.uint8)
               for q in TOOL_SIZES["panel_qlens"]}
        tool("exp_panels", lambda: exp_panels.run(
            pengine, pddb, pqs, pm, reps=2, check=True))
        rng = exp_panels.panel_inputs(TOOL_SIZES["panel_seqs"])[2]
        rq = rng.integers(0, exp_panels.A, TOOL_SIZES["rows_q"],
                          dtype=np.uint8)
        tool("exp_panel_rows", lambda: exp_panel_rows.run(
            pengine, pddb, rq, pm, reps=4))
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


# The device fill's int32 work per in-band cell (csrc/device_fill.cu): E,
# H', F, H and the column max by max (5 max-type instructions), and at
# least 5 adds (H - go, E - ge, ul + P, H above - go, F - ge) and 5
# compares for the decision bits (their packing not counted).
FILL_CELL_MAXES, FILL_CELL_ADDS = 5, 10
FILL_GAPS = ((3, 1), (5, 5), (10, 2), (1, 1), (7, 3))


def fill_problem(n, seed, A):
    """tests/test_device_fill.py's problem at seed 23 and n 120: a
    90-letter query and n targets of 4-259 letters, every ninth a prefix of
    the query (ties), target 5 its first letter."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, A - 4, size=90, dtype=np.uint8)
    db = [rng.integers(0, A - 4, size=int(rng.integers(4, 260)),
                       dtype=np.uint8) for _ in range(n)]
    for i in range(0, n, 9):
        db[i] = q[: int(rng.integers(3, 90))].copy()
    db[5] = q[:1].copy()
    return q, db


def fill_diff(args, go, ge, mat, mode):
    """(outputs that differ, max abs error, the kernel's outputs) of the
    device_fill kernel against its plain version on one packed group, both
    on the card."""
    from opal_tpu_torch.engine import device_fill

    got = device_fill.fill_walk(*args, go, ge, mat, mode)
    want = device_fill.fill_walk_plain(*args, go, ge, mat, mode)
    diffs = [int((g.long() - w.long()).abs().max()) for g, w in zip(got,
                                                                   want)]
    return sum(d > 0 for d in diffs), max(diffs), got


def same_paths(a, b):
    return set(a) == set(b) and all(
        a[i][:2] == b[i][:2] and np.array_equal(a[i][2], b[i][2]) for i in a)


def band_cells(qlen, bottom, top, cols):
    """In-band cells of each lane's first `cols` columns: rows
    max(0, c - top) .. min(qlen - 1, c + bottom) of column c."""
    total = 0
    for q, b, t, n in zip(qlen.tolist(), bottom.tolist(), top.tolist(),
                          cols.tolist()):
        c = np.arange(n)
        total += int(np.maximum(0, np.minimum(q - 1, c + b)
                                - np.maximum(0, c - t) + 1).sum())
    return total


def phase_device_fill(sm, srv, gold, ceil, smi, ptxas):
    """The device fill (OPAL_TPU_DEVICE_FILL=1): the kernel against its
    plain version on the card, on planted problems and at the wavefront's
    edge shapes; exp_device_fill's protocol at full scale, with each
    group's plan (strip rows, passes) and its computed against executed
    columns; the 6 x2 golden files and the served align batch with the
    switch. `ptxas` is the build's register report of device_fill."""
    import torch

    from opal_tpu_torch.constants import MODE_SW
    from opal_tpu_torch.engine import device_fill, kernels
    from opal_tpu_torch.engine.search import Engine, search_database_arrays
    from opal_tpu_torch.tools import exp_device_fill, fill_shapes
    from opal_tpu_torch.traceback import align_pair_reverse_trick

    t0 = time.perf_counter()
    dev = srv.engine.device
    matrix = sm.matrix
    mat = torch.from_numpy(matrix.astype(np.int32)).to(dev)
    small = Engine(device=dev.type, block_size=128)

    def host():
        return dict.fromkeys(("no_end", "no_band", "value_bound",
                              "budget"), 0)

    def winners_of(q, db, mode, go, ge, engine=small, top_k=0):
        out = search_database_arrays(q, db, go, ge, matrix, mode=mode,
                                     search_type=1, engine=engine,
                                     top_k=top_k)
        idx = out["index"] if top_k else range(len(out["score"]))
        return [(int(i), int(s), int(eq), int(et)) for i, s, eq, et in
                zip(idx, out["score"], out["end_q"], out["end_t"])
                if not (mode == MODE_SW and s == 0)]

    # (a) the kernel against its plain version: 4 modes x 5 gap pairs on
    # planted ties and a 1-letter target, a lane whose limit is one above
    # its score (ok False), 1-lane groups, a 512-lane group, several
    # groups in one call, groups cut by a small byte budget
    cases = bad = err = 0
    q, db = fill_problem(120, 23, matrix.shape[0])
    for mode in range(4):
        for go, ge in FILL_GAPS:
            jobs = device_fill.make_jobs(q, db, go, ge, matrix, mode,
                                         winners_of(q, db, mode, go, ge),
                                         host())
            jobs[-1] = jobs[-1][:1] + (jobs[-1][1] + 1,) + jobs[-1][2:]
            for group in (jobs, jobs[:1]):
                b, e, got = fill_diff(device_fill.pack_group(group, dev), go,
                                      ge, mat, mode)
                bad, err, cases = bad + b, max(err, e), cases + 1
                check(len(group) == 1 or not bool(got[3][-1]),
                      "device_fill: the planted lane is ok")
    # the wavefront's edges (tools/fill_shapes.py): tlen 1/31/33, qlen one
    # past a pass, bands 1-3 rows wide, stops near and far from tlen, at
    # plan_fill's strip rows and at 16 (up to three passes a lane)
    edge_cases = 0
    for _, mode, go, ge, jobs in fill_shapes.edge_groups(matrix,
                                                         device=dev):
        args = device_fill.pack_group(jobs, dev)
        for rows in (None, 16):
            device_fill.FILL_ROWS = rows
            try:
                b, e, _ = fill_diff(args, go, ge, mat, mode)
            finally:
                device_fill.FILL_ROWS = None
            bad, err, cases = bad + b, max(err, e), cases + 1
            edge_cases += 1
    q2, db2 = fill_problem(700, 24, matrix.shape[0])
    win2 = winners_of(q2, db2, MODE_SW, 3, 1)
    groups = device_fill.plan_groups(
        device_fill.make_jobs(q2, db2, 3, 1, matrix, MODE_SW, win2, host()),
        512, device_fill.FILL_BUDGET_BYTES, host())
    check(len(groups[0]) == 512, "no 512-lane group")
    b, e, _ = fill_diff(device_fill.pack_group(groups[0], dev), 3, 1, mat,
                        MODE_SW)
    bad, err, cases = bad + b, max(err, e), cases + 1
    whole = device_fill.align_winners_device(q2, db2, 3, 1, matrix, MODE_SW,
                                             win2, device=dev)
    check(device_fill.LAST_STATS["groups"] == 2, "700 lanes in 2 groups")
    launches = kernels.LAUNCHES["device_fill"]
    by32 = device_fill.align_winners_device(q2, db2, 3, 1, matrix, MODE_SW,
                                            win2, lanes=32, device=dev)
    n32 = device_fill.LAST_STATS["groups"]
    check(kernels.LAUNCHES["device_fill"] - launches == n32 > 2,
          "one launch per group")
    budget = device_fill.FILL_BUDGET_BYTES
    device_fill.FILL_BUDGET_BYTES = 8 * 128 * 320
    try:
        cut = device_fill.align_winners_device(q2, db2, 3, 1, matrix,
                                               MODE_SW, win2, device=dev)
        n_cut = device_fill.LAST_STATS["groups"]
    finally:
        device_fill.FILL_BUDGET_BYTES = budget
    group_bad = (not same_paths(by32, whole)) + (not same_paths(cut, whole))
    cases += 2
    host_bad = 0
    for i, score, eq, et in win2:
        if i in whole:
            want = align_pair_reverse_trick(q2, db2[i], 3, 1, matrix, score,
                                            eq, et, MODE_SW)
            host_bad += not (whole[i][:2] == want[:2]
                             and np.array_equal(whole[i][2], want[2]))
    check(bad == 0 and group_bad == 0,
          "device_fill disagrees with its plain version")
    check(host_bad == 0 and len(whole) >= 0.9 * len(win2),
          "device_fill paths differ from the host path")

    # (b) exp_device_fill's protocol at full scale: a 513-residue query,
    # SW x1 top 1,000 on the resident database, the winners aligned on the
    # host and on the device
    query = np.random.default_rng(1).integers(0, 20, size=513,
                                              dtype=np.uint8)
    proto = exp_device_fill.protocol(srv.engine, srv.ddb, query, matrix,
                                     1000, 512)
    check(proto["identical"] and proto["audit_identical"],
          "device pass differs from the host pass at full scale")
    check(proto["audit_warnings"] == 0, "the audit warned")
    check(proto["launches"] > 0 and proto["plain_calls"] == 0,
          "the full-scale device pass launched no device_fill or ran the "
          "plain version")
    win = winners_of(query, srv.ddb, MODE_SW, 3, 1, srv.engine, 1000)
    groups = device_fill.plan_groups(
        device_fill.make_jobs(query, srv.ddb.raw, 3, 1, matrix, MODE_SW,
                              win, host()),
        512, device_fill.FILL_BUDGET_BYTES, host())
    packed = [device_fill.pack_group(g, dev) for g in groups]
    ms = time_cuda(lambda: [device_fill.fill_walk(*a, 3, 1, mat, MODE_SW)
                            for a in packed], 3)
    group_ms = [time_cuda(lambda a=a: device_fill.fill_walk(
        *a, 3, 1, mat, MODE_SW), 2) for a in packed]
    cells = nbytes = 0
    kernel_out = [device_fill.fill_walk(*a, 3, 1, mat, MODE_SW)
                  for a in packed]
    plans = []
    for a, (_, _, rend_t, _, codes), g_ms in zip(packed, kernel_out,
                                                 group_ms):
        qlen, tlen, bottom, top = (t.cpu().numpy() for t in a[2:6])
        executed = rend_t.cpu().numpy() + 1
        computed = device_fill.computed_columns(tlen, executed, MODE_SW)
        plan = device_fill.plan_fill(a[0].shape[0], a[1].shape[0],
                                     a[0].shape[1])
        rows_ms = {}  # the same group at each strip height plan_fill has
        for rows in (16, 32):
            device_fill.FILL_ROWS = rows
            try:
                rows_ms[rows] = time_cuda(lambda a=a: device_fill.fill_walk(
                    *a, 3, 1, mat, MODE_SW), 2)
            finally:
                device_fill.FILL_ROWS = None
        plans.append({
            "b_qp_tp": [a[0].shape[1], a[0].shape[0], a[1].shape[0]],
            "rows": plan["rows"], "passes": plan["passes"],
            "columns_executed": int(executed.sum()),
            "columns_computed": int(computed.sum()),
            "speculative_share": float(1 - executed.sum() / computed.sum()),
            "longest_lane_columns": int(executed.max()), "ms": g_ms,
            "ms_at_rows": rows_ms})
        c = band_cells(qlen, bottom, top, executed)
        cells += c
        # bits written once, letters and parameters read once, outputs
        # and codes written once
        nbytes += c + 4 * int(qlen.sum() + tlen.sum()) + 33 * len(qlen) \
            + codes.numel()
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = device_fill.fill_walk_plain(*packed[0], 3, 1, mat, MODE_SW)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    diffs = [int((g.long() - w.long()).abs().max())
             for g, w in zip(kernel_out[0], want)]
    b = sum(d > 0 for d in diffs)
    bad, err, cases = bad + b, max([err] + diffs), cases + 1
    check(b == 0, "device_fill disagrees with its plain version at full "
          "scale")
    ops_ms, _, _ = op_bound_ms(cells, FILL_CELL_MAXES, FILL_CELL_ADDS)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_measured = measured_bound_ms(cells, ceil, FILL_CELL_MAXES)

    # (c) the 6 x2 golden files with the switch
    gold_db, gold_ddb, gold_engine = gold
    os.environ["OPAL_TPU_DEVICE_FILL"] = "1"
    try:
        kernels.reset_counts()
        t = time.perf_counter()
        x2_files, x2_lines, x2_bad = x2_goldens(sm, gold_engine, gold_ddb,
                                                gold_db)
        x2_s = time.perf_counter() - t
        gold_counts = (kernels.LAUNCHES["device_fill"],
                       kernels.PLAIN_CALLS["fill_walk_plain"])
    finally:
        os.environ.pop("OPAL_TPU_DEVICE_FILL")
    check(x2_files == 6 and x2_bad == 0,
          "x2 golden lines differ with the device fill")
    check(gold_counts[0] > 0 and gold_counts[1] == 0,
          "the x2 goldens launched no device_fill or ran the plain version")

    # (d) the served align batch, without and with the switch in turns
    texts = read_queries(os.path.join(HERE, "tests", "port_data",
                                      "uniprot_sprot15.fasta"))
    line = json.dumps({"id": "al", "queries": texts, "align": True,
                       "top_k": 10})

    def request(fill):
        if fill:
            os.environ["OPAL_TPU_DEVICE_FILL"] = "1"
        try:
            srv._cache.clear()
            t = time.perf_counter()
            out = srv._respond(line)
            torch.cuda.synchronize()
            return time.perf_counter() - t, out
        finally:
            os.environ.pop("OPAL_TPU_DEVICE_FILL", None)

    request(True)  # warm-up
    kernels.reset_counts()
    runs = {False: [], True: []}
    for fill in (False, True, True, False, False, True):
        runs[fill].append(request(fill))
    outs = {o for r in runs.values() for _, o in r}
    check(len(outs) == 1 and '"hits"' in next(iter(outs)),
          "align answers differ with the device fill")
    serve_counts = (kernels.LAUNCHES["device_fill"],
                    kernels.PLAIN_CALLS["fill_walk_plain"])
    check(serve_counts[0] > 0 and serve_counts[1] == 0,
          "align requests launched no device_fill or ran the plain version")

    res = {
        "phase": "device_fill", "cases": cases, "edge_cases": edge_cases,
        "mismatches": bad,
        "max_abs_err": err, "group_mismatches": group_bad,
        "host_path_mismatches": host_bad, "groups_by32": n32,
        "groups_cut_by_budget": n_cut, "tolerance": 0,
        **{f"full_{k}": v for k, v in proto.items()},
        "kernel_ms": ms, "group_ms": group_ms, "groups_plan": plans,
        "ptxas": ptxas,
        "groups_b_qp_tp": [[a[0].shape[1], a[0].shape[0], a[1].shape[0]]
                           for a in packed],
        "band_cells": cells, "bytes": nbytes, "ops_ms": ops_ms,
        "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_measured_ms": bound_measured,
        "bound_share": max(ops_ms, bytes_ms) / ms,
        "bound_measured_share": bound_measured / ms,
        "plain_ms": plain_ms,
        "plain_at": f"the first group, [{packed[0][0].shape[0]}, "
                    f"{packed[0][1].shape[0]}] x {packed[0][0].shape[1]} "
                    "lanes",
        "x2_files": x2_files, "x2_lines": x2_lines,
        "x2_mismatching_lines": x2_bad, "x2_seconds": x2_s,
        "x2_launches": gold_counts[0],
        "serve_align_host_s": [t for t, _ in runs[False]],
        "serve_align_device_s": [t for t, _ in runs[True]],
        "serve_align_launches": serve_counts[0],
        "seconds": time.perf_counter() - t0, "card": smi,
    }
    emit(res)
    return res


def main():
    t_start = time.perf_counter()
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

    from opal_tpu_torch import _native

    from concurrent.futures import ThreadPoolExecutor

    from opal_tpu_torch import tools

    t0 = time.perf_counter()
    # the kernels' and the probes' nvcc processes all start together
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_build.build_all, report=True),
                pool.submit(_build.build_all, tools.PROBES, True,
                            tools.CSRC)]
        log = {k: v for j in jobs for k, v in j.result().items()}
    t1 = time.perf_counter()
    native = _native.available()  # the host C library (FASTA, traceback)
    emit({"phase": "build", "seconds": round(t1 - t0, 1),
          "kernels": {k: {"seconds": round(v["seconds"], 1),
                          "ptxas": ptxas_summary(v["log"])}
                      for k, v in log.items()},
          "native_host_library": native,
          "native_seconds": round(time.perf_counter() - t1, 1)})
    check(native, "the native host library did not build or load")

    sm = ScoreMatrix.blosum50()
    dev = torch.device("cuda")
    tool_res = phase_tools(smi)
    ceil = tool_res["ceiling"]
    kern = phase_kernel(sm.matrix, dev)
    kern_flags = phase_kernel_flags(sm.matrix, dev)
    kern_multi = phase_kernel_multi(sm.matrix, dev)
    kern_map = phase_kernel_mapping(sm.matrix, dev)
    soak_res = phase_soak()
    gold_engine = Engine(device="cuda", block_size=1024)
    gold = phase_goldens(sm, gold_engine) + (gold_engine,)
    srv, ascii_db, setup_s = full_scale_server(sm)
    main_res = phase_main(sm, srv.engine, srv.ddb, setup_s, smi)
    phase_bench(main_res, smi)
    serve_res = phase_serve(srv, smi)
    casc = phase_cascade(sm, srv.engine, srv.ddb, smi)
    phase_serve_align(srv, smi)
    phase_cli(sm, srv, ascii_db, smi)
    kern_panels = phase_kernel_panels(sm.matrix, dev)
    grouped = phase_kernel_grouped(sm, srv.ddb, smi)
    longq = phase_long_query(sm, srv, smi)
    fill = phase_device_fill(sm, srv, gold, ceil, smi,
                             ptxas_summary(log["device_fill"]["log"]))
    mesh = phase_multi_device(sm, srv, ascii_db, smi)
    phase_host_tools(sm, srv, smi)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    emit({"kernels": [{
        "name": "ragged_dp", "route": "cuda",
        "source": "opal_tpu_torch/engine/csrc/ragged_dp.cu",
        "replaces": "opal_tpu/engine/pallas_kernels.py:825:"
                    "build_pallas_ragged_fn_raw",
        "launches": main_res["launches"],
        "checked_cases": kern["cases"] + main_res["sub_cases"]
        + kern_map["cases"] + mesh["sub_cases"],
        "mismatches": kern["mismatches"] + main_res["sub_mismatches"]
        + kern_map["mismatches"] + mesh["sub_mismatches"],
        "max_abs_err": max(kern["max_abs_err"], main_res["max_abs_err"],
                           kern_map["max_abs_err"], mesh["max_abs_err"]),
        "mesh_launches": mesh["mesh2"]["launches"],
        "mesh_ms": mesh["mesh2"]["kernel_ms"],
        "mesh_at": "the main path in 2 parts on the card, both launches",
        "soak_trials": soak_res["trials"],
        "soak_failures": soak_res["failures"],
        "ms": main_res["kernel_ms"],
        "plain_ms": main_res["sub_plain_ms"],
        "plain_at": f"{main_res['sub_blocks']} of the main path's "
                    f"{main_res['blocks']} blocks",
        "bound_ms": main_res["bound_ms"],
        "bound_by": main_res["bound_by"],
        "bound_measured_ms": measured_bound_ms(
            main_res["Q"] * main_res["residues"], ceil),
        "library_ms": None,
    }, {
        "name": "multi_dp", "route": "cuda",
        "source": "opal_tpu_torch/engine/csrc/multi_dp.cu",
        "replaces": "opal_tpu/engine/pallas_kernels.py:1440:"
                    "build_pallas_multi_fn_raw",
        "launches": serve_res["launches"]["multi_dp"],
        "checked_cases": kern_multi["cases"] + serve_res["sub_cases"]
        + mesh["multi_sub_cases"],
        "mismatches": kern_multi["mismatches"]
        + serve_res["sub_mismatches"] + mesh["multi_sub_mismatches"],
        "max_abs_err": max(kern_multi["max_abs_err"],
                           serve_res["max_abs_err"], mesh["max_abs_err"]),
        "ms": serve_res["multi_dp_group_ms"],
        "ms_at": f"one group of 8 queries ({sum(serve_res['group_segments'])}"
                 f" rows) x the whole database",
        "plain_ms": serve_res["sub_plain_ms"],
        "plain_at": f"the same group x {serve_res['sub_blocks']} of the "
                    f"{serve_res['blocks']} blocks",
        "bound_ms": serve_res["bound_ms"],
        "bound_by": serve_res["bound_by"],
        "bound_measured_ms": measured_bound_ms(serve_res["group_cells"],
                                               ceil),
        "library_ms": None,
    }, {
        "name": "ragged_dp_flags", "route": "cuda",
        "source": "opal_tpu_torch/engine/csrc/ragged_dp.cu",
        "replaces": "opal_tpu/engine/pallas_kernels.py:525:"
                    "_kernel_body(with_flags)",
        "launches": casc["launches"],
        "checked_cases": kern_flags["cases"] + casc["sub_cases"],
        "mismatches": kern_flags["mismatches"] + casc["sub_mismatches"],
        "max_abs_err": max(kern_flags["max_abs_err"], casc["max_abs_err"]),
        "ms": casc["modes"]["SW"]["flag_kernel_ms"],
        "ms_at": "SW x0, O74807 x the whole database (the main path with "
                 "flags)",
        "plain_ms": casc["sub_plain_ms"],
        "plain_at": f"SW x0 with flags, {casc['sub_blocks']} of the "
                    f"{casc['blocks']} blocks",
        "bound_ms": casc["modes"]["SW"]["bound_ms"],
        "bound_by": casc["modes"]["SW"]["bound_by"],
        "bound_measured_ms": measured_bound_ms(
            casc["Q"] * casc["residues"], ceil, FLAG_CELL_MAXES["SW"]),
        "library_ms": None,
    }, {
        "name": "ragged_dp_panel", "route": "cuda",
        "source": "opal_tpu_torch/engine/csrc/ragged_dp.cu",
        "replaces": "opal_tpu/engine/pallas_kernels.py:959:"
                    "build_pallas_panel_fn_raw",
        "launches": longq["launches"],
        "checked_cases": kern_panels["cases"] + longq["sub_cases"],
        "mismatches": kern_panels["mismatches"] + longq["sub_mismatches"],
        "max_abs_err": max(kern_panels["max_abs_err"],
                           longq["max_abs_err"]),
        "ms": longq["kernel_ms"],
        "ms_at": f"SW x0, a {longq['Q']}-residue query x the whole "
                 f"database, {longq['panels']} panels x {longq['waves']} "
                 "waves",
        "plain_ms": longq["sub_plain_ms"],
        "plain_at": f"the same query on the first block "
                    f"({longq['sub_residues']} residues), where the kernel "
                    f"takes {longq['sub_kernel_ms']:.3f} ms",
        "bound_ms": longq["bound_ms"],
        "bound_by": longq["bound_by"],
        "bound_measured_ms": measured_bound_ms(longq["cells"], ceil),
        "library_ms": None,
    }, {
        "name": "ragged_dp_grouped", "route": "cuda",
        "source": "opal_tpu_torch/engine/csrc/ragged_dp.cu",
        "replaces": "opal_tpu/engine/pallas_kernels.py:732:"
                    "build_pallas_score_fn_raw",
        "launches": grouped["launches"],
        "checked_cases": grouped["cases"],
        "mismatches": grouped["mismatches"],
        "max_abs_err": grouped["max_abs_err"],
        "ms": grouped["ms"],
        "ms_at": f"SW x0, O74807 x {grouped['G']} dense blocks of "
                 f"[{grouped['T']}, {grouped['B']}] from the database",
        "plain_ms": grouped["plain_ms"],
        "plain_at": "the same inputs",
        "bound_ms": grouped["bound_ms"],
        "bound_by": grouped["bound_by"],
        "bound_measured_ms": measured_bound_ms(grouped["cells"], ceil),
        "library_ms": None,
    }, {
        "name": "device_fill", "route": "cuda",
        "source": "opal_tpu_torch/engine/csrc/device_fill.cu",
        "replaces": "opal_tpu/engine/device_fill.py:90:_fill_walk_fn (XLA)",
        "launches": fill["full_launches"],
        "checked_cases": fill["cases"],
        "mismatches": fill["mismatches"],
        "max_abs_err": fill["max_abs_err"],
        "ms": fill["kernel_ms"],
        "ms_at": f"the {fill['full_winners']} SW winners of a 513-residue "
                 f"query on the whole database, {len(fill['group_ms'])} "
                 "groups (B, Qp, Tp) "
                 f"{fill['groups_b_qp_tp']}",
        "plain_ms": fill["plain_ms"],
        "plain_at": fill["plain_at"],
        "bound_ms": fill["bound_ms"],
        "bound_by": fill["bound_by"],
        "bound_measured_ms": fill["bound_measured_ms"],
        "library_ms": None,
    }] + [dict(name=name, route="cuda", **e, library_ms=None)
          for name, e in tool_res["entries"].items()]})
    # count is what torch sees: 1 on the one-card machine this runs on
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
