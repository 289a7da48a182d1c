"""The card's own int32 ceiling, the price of the F chain, and the DP
kernel's cells per second (the counterpart of the TPU tool
tools/roofline.py, whose Pallas kernels are CUDA probes here,
csrc/roofline.cu).

    python -m opal_tpu_torch.tools.roofline [--device cuda|cpu]

Three measurements in one process, one JSON line:

1. `peak` (tools/roofline.py:62-104): 8 chains per element, st[j] =
   max(st[j] + c_j, st[(j+1) % 8]) - c_j, in four forms (f32, i32, dpx,
   max3; see csrc/roofline.cu): instructions per SM per clock of each, at
   the SM clock nvidia-smi reads while the probe runs, and the opcodes
   cuobjdump finds in each built loop.
2. `scan` (:107-148): the F chain alone, microseconds per column.
3. `kernel` (:151-178): the port's ragged_dp through Engine.score_blocks,
   cells per second by the slope between two database sizes (qlen 110,
   30,000 and 15,000 sequences of 120-500 residues, seed 3, a 24-letter
   matrix of 3 / -1, SW score only), and its utilization: OPS_PER_CELL
   instructions per cell against the measured ceiling.

On the CPU (`--device cpu`) the plain versions run at a small size and no
time or rate is reported.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from ..engine.search import resolve_device
from . import (
    CELL_MAXES,
    LAUNCHES,
    SASS_MAX_OPS,
    check_launch,
    cu_stream,
    lib,
    nvidia_smi,
    sass_counts,
    sm_count,
    timed_under_load,
)

CHAINS = 8
VARIANTS = ("f32", "i32", "dpx", "max3")
# instructions of one chain update, and how many of them are max-type
UPDATE_INSTR = {"f32": 3, "i32": 3, "dpx": 2, "max3": 3}
MAX3_LO = -(2**30)  # max3's third operand: below every value
# ragged_dp's instructions per SW cell without DPX, and the max-type ones
# among them (engine/csrc/ragged_dp.cu's header)
OPS_PER_CELL, MAX_OPS_PER_CELL = 11, 7
SCAN_QP = (16, 32, 48, 64, 80, 96, 112, 128)


def peak_constants(variant):
    """(init of chain j, c_j) for j = 0..7: the TPU tool's f32 values, and
    for the int forms the same scaled by 8 (then exact multiples)."""
    if variant == "f32":
        return ([1.0 + 0.25 * j for j in range(CHAINS)],
                [1.0 + 0.125 * j for j in range(CHAINS)])
    if variant not in VARIANTS:
        raise ValueError(f"peak variant {variant!r}: one of {VARIANTS}")
    return [8 + 2 * j for j in range(CHAINS)], [8 + j for j in range(CHAINS)]


def peak_state(variant, n, device="cuda", seed=None):
    """[8, n] start state: the TPU tool's init, or (seed given) random
    multiples of 1/8 in [0, 64) (scaled by 8 for the int forms), which move
    under the update where the tool's init is a fixed point."""
    init, _ = peak_constants(variant)
    if seed is None:
        st = np.repeat(np.asarray(init, np.float64)[:, None], n, axis=1)
    else:
        st = np.random.default_rng(seed).integers(0, 512, (CHAINS, n)) / 8
        if variant != "f32":
            st = st * 8
    dtype = torch.float32 if variant == "f32" else torch.int32
    return torch.tensor(st, dtype=dtype, device=resolve_device(device))


def peak(state: torch.Tensor, iters: int, unroll: int, variant: str):
    """The final [8, n] state after `iters` iterations of `unroll` rounds of
    the 8 chain updates (variant's form and constants), from `state`. CUDA
    tensors launch the probe (LAUNCHES["roofline_peak"]), CPU tensors run
    peak_plain."""
    _check_peak(state, variant, unroll)
    if state.device.type == "cpu":
        return peak_plain(state, iters, unroll, variant)
    if state.device.type != "cuda":
        raise ValueError(f"no roofline kernel for device {state.device}")
    out = state.contiguous().clone()
    init, c = peak_constants(variant)
    cf = (ctypes.c_float * CHAINS)(*(c if variant == "f32" else [0] * 8))
    ci = (ctypes.c_int * CHAINS)(*(c if variant != "f32" else [0] * 8))
    so = _lib()
    with torch.cuda.device(out.device):
        check_launch(so.roofline_peak_launch(
            out.data_ptr(), out.shape[1], int(iters), int(unroll),
            VARIANTS.index(variant), cf, ci, MAX3_LO,
            cu_stream(out.device)), "roofline_peak")
    LAUNCHES["roofline_peak"] += 1
    return out


def _check_peak(state, variant, unroll):
    want = torch.float32 if variant == "f32" else torch.int32
    if variant not in VARIANTS:
        raise ValueError(f"peak variant {variant!r}: one of {VARIANTS}")
    if state.dtype != want or state.dim() != 2 or state.shape[0] != CHAINS:
        raise ValueError(f"{variant} state must be [8, n] {want}")
    if unroll not in (1, 2, 4, 8):
        raise ValueError(f"unroll {unroll}: 1, 2, 4 or 8")


def peak_plain(state, iters, unroll, variant):
    """The function `peak` computes, in plain PyTorch."""
    _check_peak(state, variant, unroll)
    _, c = peak_constants(variant)
    st = list(state.clone())
    for _ in range(iters * unroll):
        for j in range(CHAINS):
            st[j] = torch.maximum(st[j] + c[j], st[(j + 1) % CHAINS]) - c[j]
    return torch.stack(st)


def scan_state(qp, B, device="cuda"):
    """[qp, B] int32: each row holds its row index (the TPU tool's init)."""
    return torch.arange(qp, dtype=torch.int32, device=resolve_device(device))[
        :, None].repeat(1, B)


def scan(H: torch.Tensor, tc: int, g: int):
    """H after g steps of tc columns: per column tt, X[0] = -3, X[r] =
    H[r-1] - 2, F = the running max of X down the rows, H = max(H, F - tt).
    CUDA tensors launch the probe (LAUNCHES["roofline_scan"]), CPU tensors
    run scan_plain."""
    _check_scan(H)
    if H.device.type == "cpu":
        return scan_plain(H, tc, g)
    if H.device.type != "cuda":
        raise ValueError(f"no roofline kernel for device {H.device}")
    out = H.contiguous().clone()
    qp, B = out.shape
    scratch = None
    if scan_strip(qp) < qp:  # [column, lane] int2
        scratch = torch.empty(2 * tc * g * B, dtype=torch.int32,
                              device=out.device)
    so = _lib()
    with torch.cuda.device(out.device):
        check_launch(so.roofline_scan_launch(
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            qp, B, int(tc), int(g), cu_stream(out.device)), "roofline_scan")
    LAUNCHES["roofline_scan"] += 1
    return out


def scan_strip(qp):
    """Rows per strip of the scan probe: all of them up to 64 (H in
    registers), else two strips of qp / 2 (csrc/roofline.cu)."""
    return qp if qp <= 64 else qp // 2


def _check_scan(H):
    if H.dtype != torch.int32 or H.dim() != 2 or H.shape[0] not in SCAN_QP:
        raise ValueError(f"H must be [qp, B] int32 with qp in {SCAN_QP}")


def scan_plain(H, tc, g):
    """The function `scan` computes, in plain PyTorch."""
    _check_scan(H)
    H = H.clone()
    head = torch.full_like(H[:1], -3)
    for _ in range(g):
        for tt in range(tc):
            X = torch.cat([head, H[:-1] - 2])
            H = torch.maximum(H, torch.cummax(X, dim=0).values - tt)
    return H


def _lib():
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return lib("roofline", {
        # st, n, iters, unroll, variant, cf, ci, lo, stream
        "roofline_peak_launch": [vp, cll, ci, ci, ci,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.POINTER(ci), ci, vp],
        # H, scratch, qp, B, tc, g, stream
        "roofline_scan_launch": [vp, vp, ci, ci, ci, ci, vp]})


def loop_sass(fn_pattern):
    """{opcode: count} in the hot loop (tools.sass_counts) of the roofline
    library's function whose name contains fn_pattern."""
    for fn, counts in sass_counts("roofline").items():
        if fn_pattern in fn:
            return counts["loop"]
    raise RuntimeError(f"no {fn_pattern} in the roofline library's SASS")


def per_item(loop, items):
    """A loop's opcode counts per item (update, row) it computes: every
    counted opcode, "total", and "max_type" (SASS_MAX_OPS, or FMNMX)."""
    out = {op: n / items for op, n in loop.items()}
    out["max_type"] = sum(loop.get(op, 0) for op in SASS_MAX_OPS) / items
    out["fmnmx"] = loop.get("FMNMX", 0) / items
    return out


def kernel_cells(qlen, n_seqs, block_size, device, reps=4):
    """(cells, best seconds, scores) of ragged_dp through
    Engine.score_blocks: SW score only, qlen residues against n_seqs
    sequences of 120-500 residues (12-50 on the CPU; seed 3, a 24-letter
    matrix of 3 / -1, gaps 3 / 1); the timing ends with the scores on the
    host."""
    from ..constants import MODE_SW, SEARCH_SCORE
    from ..engine.search import Engine

    rng = np.random.default_rng(3)
    A = 24
    matrix = np.full((A, A), -1, np.int32)
    np.fill_diagonal(matrix, 3)
    query = rng.integers(0, A, qlen, dtype=np.uint8)
    lo, hi = (120, 500) if device.type == "cuda" else (12, 50)
    db = [rng.integers(0, A, rng.integers(lo, hi), dtype=np.uint8)
          for _ in range(n_seqs)]
    eng = Engine(device=str(device), block_size=block_size)
    ddb = eng.upload(db)
    cells = qlen * sum(len(s) for s in db)

    def run():
        return eng.score_blocks(query, ddb, 3, 1, matrix, MODE_SW,
                                SEARCH_SCORE)[1]["score"]

    run()
    best = None
    for _ in range(reps):
        t = time.perf_counter()
        run()
        dt = time.perf_counter() - t
        best = dt if best is None else min(best, dt)
    return cells, best, run()


def measure_peak(dev, n, iters, unroll=8, seconds=1.0):
    """The peak probe in its four forms on n elements (see the module
    docstring): ({"variants": {form: ...}, "int_equal_8x_f32": ...}, [SM
    MHz under load of each form]). On the card each form has its ms, the
    SASS of its built loop per chain update, and from these its total and
    max-type instructions per SM per clock at the clock read under load."""
    cuda = dev.type == "cuda"
    n_sm = sm_count() if cuda else None
    res = {"elements": n, "iters": iters, "unroll": unroll,
           "updates_per_element": iters * unroll * CHAINS, "variants": {}}
    updates = n * iters * unroll * CHAINS
    states, clocks = {}, []
    for k, v in enumerate(VARIANTS):
        st0 = peak_state(v, n, dev)
        out = {"source_instr_per_update": UPDATE_INSTR[v]}
        if cuda:
            ms, mhz, _ = timed_under_load(
                lambda: peak(st0, iters, unroll, v), seconds)
            clocks.append(mhz)
            sass = per_item(loop_sass(f"peak_kernelILi{k}ELi{unroll}E"),
                            unroll * CHAINS)
            per_clk = updates / (ms * 1e-3 * n_sm * mhz * 1e6)
            out.update({
                "ms": ms, "sm_mhz_under_load": mhz,
                "sass_per_update": sass,
                "updates_per_sm_clk": per_clk,
                "instr_per_sm_clk": per_clk * sass["total"],
                # the float form's max is FMNMX; the int forms' the others
                "max_per_sm_clk": per_clk * (sass["fmnmx"] if v == "f32"
                                             else sass["max_type"])})
        # from a seeded state that moves (the tool's init is a fixed point)
        states[v] = peak(peak_state(v, n, dev, seed=0), iters, unroll, v)
        res["variants"][v] = out
    # every int form equals 8 x the f32 state
    f32x8 = states["f32"].double() * 8
    res["int_equal_8x_f32"] = all(
        torch.equal(states[v].double(), f32x8) for v in VARIANTS[1:])
    if not res["int_equal_8x_f32"]:
        raise RuntimeError("a peak int form differs from 8 x the f32 form")
    return res, clocks


def ceiling(peak_res, n_sm, mhz):
    """The measured int32 ceiling from the peak variants: the best max-type
    (integer pipe) and total instruction rates per SM per clock over the
    int forms, and the SW cells per second that the max-type rate allows
    at CELL_MAXES per cell."""
    ints = [peak_res[v] for v in VARIANTS if v != "f32"]
    r_max = max(r["max_per_sm_clk"] for r in ints)
    return {"max_per_sm_clk": r_max,
            "instr_per_sm_clk": max(r["instr_per_sm_clk"] for r in ints),
            "sm_mhz_under_load": mhz, "sm_count": n_sm,
            "sw_cells_per_s": r_max * n_sm * mhz * 1e6 / CELL_MAXES}


def run_ceiling(dev, seconds=0.5):
    """The measured ceiling (see ceiling) from the peak probe at its card
    defaults."""
    n_sm = sm_count()
    peak_res, clocks = measure_peak(dev, 4 * 1024 * n_sm, 64 * 64, 8,
                                    seconds)
    return ceiling(peak_res["variants"], n_sm, float(np.median(clocks)))


def run(device="cuda", R=None, B=None, K=64, G=64, unroll=8, scan_qp=112,
        scan_B=None, scan_tc=64, scan_g=64, qlen=110, n_seqs=30000,
        block_size=1024, seconds=1.0):
    """The three measurements (see the module docstring) as a dict. On the
    card the sizes default to filling it; on the CPU to a small size."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if not cuda:  # the plain versions, small
        R, B, K, G = R or 8, B or 128, min(K, 2), min(G, 2)
        unroll = min(unroll, 2)
        scan_qp, scan_B, scan_tc, scan_g = 16, scan_B or 128, 4, 2
        qlen, n_seqs, block_size = 20, 40, 16
    n_sm = sm_count() if cuda else None
    R = R or 4
    B = B or 1024 * n_sm  # two waves of 2,048 threads per SM
    n = R * B
    iters = K * G
    res = {"tool": "roofline", "device": str(dev), "measured": cuda}
    if cuda:
        res["card"] = nvidia_smi("name,power.limit")
        res["max_sm_mhz"] = float(nvidia_smi("clocks.max.sm").split()[0])

    # 1. peak
    res["peak"], clocks = measure_peak(dev, n, iters, unroll, seconds)

    # 2. scan
    H = scan_state(scan_qp, scan_B or 512 * (n_sm or 1), dev)
    cols = scan_tc * scan_g
    row_cells = scan_qp * H.shape[1] * cols
    out = {"qp": scan_qp, "B": H.shape[1], "columns": cols,
           "strip_rows": scan_strip(scan_qp)}
    if cuda:
        ms, mhz, _ = timed_under_load(lambda: scan(H, scan_tc, scan_g),
                                      seconds)
        sass = per_item(loop_sass(f"scan_kernelILi{scan_qp}E"),
                        scan_strip(scan_qp))
        rows_clk = row_cells / (ms * 1e-3 * n_sm * mhz * 1e6)
        out.update({"ms": ms, "us_per_column": ms * 1e3 / cols,
                    "sm_mhz_under_load": mhz, "sass_per_row": sass,
                    "rows_per_sm_clk": rows_clk,
                    "max_per_sm_clk": rows_clk * sass["max_type"]})
    Hf = scan(H, scan_tc, scan_g)
    out["row0_max"] = int(Hf[0].max())
    out["last_row_max"] = int(Hf[-1].max())
    res["scan"] = out

    # 3. ragged_dp by slope, and its utilization
    c1, t1, s1 = kernel_cells(qlen, n_seqs, block_size, dev)
    c2, t2, _ = kernel_cells(qlen, n_seqs // 2, block_size, dev)
    out = {"qlen": qlen, "sequences": [n_seqs, n_seqs // 2],
           "cells": [c1, c2], "score_sum": int(np.asarray(s1).sum())}
    if cuda:
        cells_s = (c1 - c2) / (t1 - t2)
        ceil = ceiling(res["peak"]["variants"], n_sm, float(np.median(clocks)))
        res["ceiling"] = ceil
        ceil_clk = n_sm * ceil["sm_mhz_under_load"] * 1e6
        out.update({
            "seconds": [t1, t2], "gcups_raw": c1 / t1 / 1e9,
            "gcups_marginal": cells_s / 1e9,
            "ops_per_cell": OPS_PER_CELL,
            "max_ops_per_cell": MAX_OPS_PER_CELL,
            # the source's operations against the best measured rates
            "ops_utilization": cells_s * OPS_PER_CELL
            / (ceil["instr_per_sm_clk"] * ceil_clk),
            "max_utilization": cells_s * MAX_OPS_PER_CELL
            / (ceil["max_per_sm_clk"] * ceil_clk),
            "share_of_sw_cell_ceiling": cells_s / ceil["sw_cells_per_s"]})
    res["kernel"] = out
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--R", type=int, default=None)
    ap.add_argument("--B", type=int, default=None)
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--G", type=int, default=64)
    ap.add_argument("--unroll", type=int, default=8)
    ap.add_argument("--qlen", type=int, default=110)
    ap.add_argument("--n-seqs", type=int, default=30000)
    ap.add_argument("--block-size", type=int, default=1024)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, R=a.R, B=a.B, K=a.K, G=a.G,
                         unroll=a.unroll, qlen=a.qlen, n_seqs=a.n_seqs,
                         block_size=a.block_size)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
