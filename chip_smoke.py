#!/usr/bin/env python3
"""Smoke run of opal_tpu_torch on one NVIDIA GPU (H100): python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero before
the last line:

1. device  - the card's name and power limit (nvidia-smi);
2. build   - nvcc builds every kernel from opal_tpu_torch/engine/csrc, one
             nvcc per source, all started together, then cc the host C
             library (opal_tpu_torch/_native: FASTA tokenizer, traceback);
3. kernel  - ragged_dp (without and with its overflow-flag rows) and
             multi_dp against their plain PyTorch versions, both on the
             card, on random streams (4 modes x score / score+end, several
             gap pairs, query lengths and stacked segment sets, partial
             first blocks, several waves; the flag cases reach 8, 16 and
             32 bits in every mode); exact equality;
4. goldens - the port on the card against the reference binary's output
             for the 12,071-sequence fixture: result lines of the 16 x0/x1
             files, result lines and alignment blocks of the 6 x2 files;
5. main    - the single-query path at full scale: O74807 (SW, score,
             BLOSUM50, gaps 3/1) against 541,762 synthetic sequences held
             resident, through search_database_arrays; then ragged_dp
             against the plain version on blocks of that database;
6. serve   - the serving path on the same resident database:
             opal_tpu_torch.serve.Server answers the 15 queries of
             tests/port_data/uniprot_sprot15.fasta as one batch request
             (stacked multi_dp launches, top 10 selected on the card), as
             15 single-query lines batched by _respond_many, as NW/HW/OV
             batches and a cache hit; every hit list is
             checked against the host ranking of a full ragged_dp score
             table; then multi_dp against its plain version on blocks of
             that database;
7. cascade - Engine(precision="adaptive") at full scale (SW x0, NW x1)
             through ragged_dp's flag rows: scores and ends against the
             int32 path, precision counts, search_database_char_sw, the
             flag kernel against its plain version on blocks;
8. serve_align - the 15-query batch with align: true, top 10, against
             search_database(search_type=2, align_top_k=10) per query;
9. cli     - python -m opal_tpu_torch.cli as subprocesses on a FASTA copy
             of the database: -s -x 0 (trailer, and a --profile run for the
             card's idle share) and -x 2 --align-top 10 against the API.

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
    ragged_dp's instantiations read mode<M>_end<E>_flags<F>, multi_dp's
    mode<M>_end<E>."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELb(\d)E(?:Lb(\d)E)?", m.group(1))
            name = m.group(1)
            if t:
                name = f"mode{t.group(1)}_end{t.group(2)}" + (
                    f"_flags{t.group(3)}" if t.group(3) else "")
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
    # several launches (waves) over one stream
    profile = torch.from_numpy(kernels.build_profile(
        40 * matrix[rng.integers(0, A, size=110)].T)).to(dev)
    stream = random_stream(rng, 2000, 1500, 128, A, dev)
    wave_cells = kernels.WAVE_CELLS
    kernels.WAVE_CELLS = int(stream.host_offsets[-1]) // 4
    try:
        for mode in range(4):
            before = kernels.LAUNCHES["ragged_dp_flags"]
            one(profile, stream, mode, 1, 3, 1)
            check(kernels.LAUNCHES["ragged_dp_flags"] - before > 1,
                  "flag wave case ran in one launch")
    finally:
        kernels.WAVE_CELLS = wave_cells
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
    import glob

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
    # x2: result lines and alignment blocks, the whole file
    t1 = time.perf_counter()
    x2_files = sorted(glob.glob(os.path.join(
        gdir, "*__synth12071__*_x2_o3_e1.txt.gz")))
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
    res = {"phase": "goldens", "configs": configs, "sequences": len(db),
           "mismatching_lines": bad_lines, "x2_files": len(x2_files),
           "x2_lines": x2_lines, "x2_mismatching_lines": x2_bad,
           "x2_seconds": round(time.perf_counter() - t1, 1),
           "native_traceback": _native.available(),
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    check(configs == 16 and bad_lines == 0, "golden result lines differ")
    check(len(x2_files) == 6 and x2_bad == 0,
          "x2 golden lines (results or alignment blocks) differ")
    check(_native.available(), "the native host library did not load")


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
           "query": "O74807", "Q": Q, "card": smi, "modes": {}}
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


def idle_share(trace_path):
    """The card's busy and idle share within a torch.profiler Chrome trace:
    the union of kernel intervals over the span from the first to the last
    event of the trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and "ts" in e]
    kern = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "kernel")
    check(kern, f"{trace_path}: no kernel in the trace")
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in kern:
        if cur_e is None or a > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    return {"trace_window_ms": window / 1e3, "kernel_busy_ms": busy / 1e3,
            "kernels_in_trace": len(kern),
            "device_idle_share": 1 - busy / window}


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

    from opal_tpu_torch import _native

    t0 = time.perf_counter()
    log = _build.build_all(report=True)
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
    kern = phase_kernel(sm.matrix, dev)
    kern_flags = phase_kernel_flags(sm.matrix, dev)
    kern_multi = phase_kernel_multi(sm.matrix, dev)
    phase_goldens(sm, Engine(device="cuda", block_size=1024))
    srv, ascii_db, setup_s = full_scale_server(sm)
    main_res = phase_main(sm, srv.engine, srv.ddb, setup_s, smi)
    serve_res = phase_serve(srv, smi)
    casc = phase_cascade(sm, srv.engine, srv.ddb, smi)
    phase_serve_align(srv, smi)
    phase_cli(sm, srv, ascii_db, smi)

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
        "library_ms": None,
    }]})
    # count is what torch sees: 1 on the one-card machine this runs on
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
