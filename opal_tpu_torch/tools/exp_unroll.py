"""Ablations of ragged_dp's SW score-only column body on the card (the
counterpart of the TPU tool tools/exp_unroll.py, whose Pallas kernel is
the CUDA probe csrc/exp_unroll.cu here).

    python -m opal_tpu_torch.tools.exp_unroll [--device cuda|cpu]

One query (the profile of qprofile [24, Q], Q = qpad - 8, made as the TPU
tool makes it) against B lanes of chunks x 64 random letters each, in the
port's input layout (a kernels.Stream of one block). The probe runs
ragged_dp's strip-group body (engine/csrc/strip_group.cuh): `base` is
ragged_dp's SW x0 kernel itself (kernels.ragged_score at a given G), at
the G per block that kernels.plan_launch gives this input; `hooks` runs
that body in the probe's own frame, and every other variant (VARIANTS;
csrc/exp_unroll.cu says what each changes) changes only the column body
there, at the plan's G for its own strip height, so `hooks` is their
control. Every variant and ragged_dp itself (`single`) score the same
input; all must be equal. Then the forced-G sweep (`base` at G = 1,
2, 4, 8 on the same input: what spreading a lane's rows over more threads
buys) and the tail pair: `base` at the plan's G on 192 CUDA blocks of
5,000-column lanes (the grid of the main path's last wave) and on a full
grid (every SM at its occupancy) of lanes of the same length, whose
per-cell times tell the grid from one group's serial chain. One JSON line:
per variant ms, GCUPS, its share of the bound (3.5 max-type instructions
per cell at the card's highest clock) and of the measured SW-cell ceiling
(tools.roofline), SASS per cell, registers, local (spill) bytes and
resident CUDA blocks per SM; the G sweep; the tail pair.

On the CPU (`--device cpu`) the plain version runs at a small size and no
time is reported.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..constants import MODE_SW
from ..engine.search import resolve_device
from . import (LAUNCHES, cell_bound_ms, check_launch, cu_stream, lib,
               nvidia_smi, sm_count)

T_CHUNK = 64        # letters per chunk, as the TPU tool streams them
A_PAD = 32          # profile columns
PAD_NEG = -(2**20)  # profile value of padding rows and letters
# base is ragged_dp's own kernel; the others are exp_unroll.cu's, numbered
# by their place here
VARIANTS = ("base", "fold2", "dpx", "dpx_fold2", "r8", "r32", "hooks")
STRIP = {"base": 16, "fold2": 16, "dpx": 16, "dpx_fold2": 16, "r8": 8,
         "r32": 32, "hooks": 16}
GROUPS = (1, 2, 4, 8)  # threads per lane the kernel takes
THREADS = 128       # threads per CUDA block
# lanes per SM of the default input: one per thread of 6 CUDA blocks, the
# grid the one-thread-per-lane probe filled the card with, kept so that
# times compare across designs
LANES_PER_SM = 6 * THREADS
TAIL_BLOCKS, TAIL_LEN = 192, 5000  # the main path's last wave
# ragged_dp's SW score-only instantiation (MODE 3, no END, FLAGS, PANEL)
RAGGED_SW = "ragged_dp_kernelILi3ELb0ELb0ELb0E"


def prepare_qp(qprofile: np.ndarray, ge: int) -> np.ndarray:
    """The TPU tool's profile operand from qprofile [A, Q]: [Q_pad, 32] f32
    holding P + ge, PAD_NEG in padding rows and letter columns (a copy of
    opal_tpu's prepare_qp)."""
    A, Q = qprofile.shape
    Q_pad = -(-max(Q, 16) // 16) * 16
    qp = np.full((Q_pad, A_PAD), float(PAD_NEG), np.float32)
    qp[:Q, :A] = np.asarray(qprofile, np.float32).T + float(ge)
    return qp


def inputs(qp, Q, letters, ge, device):
    """(profile [Q, 32] int32, Stream of one block) from the TPU tool's
    operands: qp [Q_pad, 32] (prepare_qp) and letters [C, 64, B] int8, lane
    b's sequence being letters[:, :, b] in order."""
    from ..engine import kernels

    letters = np.asarray(letters, np.int8)
    C, tc, B = letters.shape
    profile = torch.from_numpy(kernels.profile_from_jax_qp(qp, Q, ge))
    stream = kernels.pack_stream([letters.reshape(C * tc, B)],
                                 [np.full(B, C * tc, np.int32)], B, device)
    return profile.to(device), stream


def random_stream(B, T, seed, device):
    """One block of B lanes of T random letters (0..19) each, made on
    `device` from a seeded generator, in the Stream layout."""
    from ..engine import kernels

    gen = torch.Generator(device=device).manual_seed(seed)
    letters = torch.randint(0, 20, (T * B,), generator=gen, device=device,
                            dtype=torch.int8)
    offsets = np.array([0, T * B], np.int64)
    return kernels.Stream(
        letters=letters, offsets=torch.from_numpy(offsets).to(device),
        lengths=torch.full((1, B), T, dtype=torch.int32, device=device),
        host_offsets=offsets)


def random_profile(qpad, ge=1, seed=0, device="cuda"):
    """(profile, Q): the TPU tool's query (qprofile [24, qpad - 8] from
    default_rng(seed), values -4..11) through prepare_qp and
    kernels.profile_from_jax_qp, as the port's profile."""
    from ..engine import kernels

    rng = np.random.default_rng(seed)
    qprofile = rng.integers(-4, 12, size=(24, qpad - 8)).astype(np.int32)
    Q = qpad - 8
    prof = kernels.profile_from_jax_qp(prepare_qp(qprofile, ge), Q, ge)
    return torch.from_numpy(prof).to(device), Q


def _check(profile, stream, variant, G):
    from ..engine import kernels

    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    if G is not None and G not in GROUPS:
        raise ValueError(f"G={G}: one of {GROUPS} threads per lane")
    kernels._check_inputs(profile, stream)
    if stream.lengths.shape[0] != 1:
        raise ValueError("the probe takes a stream of one block")


def plan_group(stream, Q, variant="base"):
    """G of the stream's block in ragged_dp's launch plan
    (kernels.plan_for, on the card) for Q query rows in strips of
    `variant`'s height."""
    from ..engine import kernels

    return int(kernels.plan_for(stream, -(-Q // STRIP[variant])).groups[0])


def unroll_score(profile: torch.Tensor, stream, variant: str = "base",
                 go: int = 3, ge: int = 1, G: int | None = None
                 ) -> torch.Tensor:
    """Best SW score [B] int32 of the profile against each lane of a
    one-block stream, by `variant`'s column body with G threads per lane
    (plan_group's by default). CUDA tensors launch the probe
    (LAUNCHES["exp_unroll"]), CPU tensors run unroll_plain."""
    _check(profile, stream, variant, G)
    dev = stream.letters.device
    if dev.type == "cpu":
        return unroll_plain(profile, stream, go, ge)
    if dev.type != "cuda":
        raise ValueError(f"no exp_unroll kernel for device {dev}")
    profile = profile.contiguous()
    Q, W = profile.shape
    B = stream.lengths.shape[1]
    G = G or plan_group(stream, Q, variant)
    if variant == "base":  # ragged_dp's launch (LAUNCHES["ragged_dp"])
        return single(profile, stream, go, ge, G)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = None
    if Q > G * STRIP[variant]:  # more than one pass
        scratch = torch.empty(2 * stream.letters.numel(), dtype=torch.int32,
                              device=dev)
    with torch.cuda.device(dev):
        err = _lib().exp_unroll_launch(
            profile.data_ptr(), stream.letters.data_ptr(),
            stream.lengths.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            B, Q, W, G, int(go), int(ge), VARIANTS.index(variant),
            cu_stream(dev))
        check_launch(err, "exp_unroll")
    LAUNCHES["exp_unroll"] += 1
    return out


def unroll_plain(profile, stream, go=3, ge=1):
    """The function every variant computes: ragged_dp's SW score-only row
    (kernels.ragged_score_plain) of the one block."""
    from ..constants import SEARCH_SCORE
    from ..engine import kernels

    return kernels.ragged_score_plain(profile, stream, MODE_SW, SEARCH_SCORE,
                                      go, ge)[0, 0]


def single(profile, stream, go=3, ge=1, G=None):
    """ragged_dp itself on the same input (its SW score-only row), at G
    threads per lane where given."""
    from ..constants import SEARCH_SCORE
    from ..engine import kernels

    return kernels.ragged_score(profile, stream, MODE_SW, SEARCH_SCORE, go,
                                ge, G=G)[0, 0]


def attrs(variant, G=8, W=A_PAD):
    """{"blocks_per_sm", "registers", "local_bytes"} of `variant`'s kernel
    at G threads per lane and profile width W: resident CUDA blocks per
    SM, registers and local (spill) bytes per thread."""
    from ..engine import kernels

    out = (ctypes.c_int * 3)()
    if variant == "base":
        err = kernels._lib("ragged_dp").ragged_dp_sw_attrs(G, W, out)
    else:
        err = _lib().exp_unroll_attrs(VARIANTS.index(variant), G, W, out)
    if err:
        raise RuntimeError(f"exp_unroll attribute query: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes"), out))


def occupancy(variant, G=8, W=A_PAD):
    """Resident CUDA blocks per SM of `variant`'s kernel."""
    return attrs(variant, G, W)["blocks_per_sm"]


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return lib("exp_unroll", {
        # profile, letters, lengths, scratch, out, B, Q, W, G, go, ge,
        # variant, stream
        "exp_unroll_launch": [vp] * 5 + [ci] * 7 + [vp],
        # variant, G, W, out[3]
        "exp_unroll_attrs": [ci] * 3 + [ctypes.POINTER(ci)]})


def per_cell(loop):
    """A column loop's SASS opcodes per cell and its max-type instructions
    per cell: every cell reads its profile value from shared memory once,
    so the loop's LDS count is its cells ((None, None) for a loop without
    them)."""
    from . import SASS_MAX_OPS

    cells = loop.get("LDS")
    if not cells:
        return None, None
    return ({op: n / cells for op, n in loop.items()},
            sum(loop.get(op, 0) for op in SASS_MAX_OPS) / cells)


def add_sass(variants, ceiling):
    """Each timed variant gains the SASS of its built column loop per cell
    (tools.sass_counts' "main"; base's from ragged_dp's library) and the
    share of the measured max-type rate that its cells per second use."""
    from ..engine import _build
    from . import sass_counts

    fns = {"base": sass_counts("ragged_dp", _build.CSRC),
           "probe": sass_counts("exp_unroll")}
    rate = ceiling["max_per_sm_clk"] * ceiling["sm_count"] * \
        ceiling["sm_mhz_under_load"] * 1e6
    for v, r in variants.items():
        k = VARIANTS.index(v)
        pat = (RAGGED_SW if v == "base" else
               f"unroll_kernelILi{STRIP[v]}ELb{int(k in (1, 3))}"
               f"ELb{int(k in (2, 3))}E")
        loop = next(c["main"] for f, c in
                    fns["base" if v == "base" else "probe"].items()
                    if pat in f)
        r["sass_per_cell"], r["max_per_cell"] = per_cell(loop)
        if r["max_per_cell"] is not None:
            r["max_pipe_share"] = (r["gcups"] * 1e9 * r["max_per_cell"]
                                   / rate)


def timed(fn, cells, padded, ceiling, bound, reps):
    """ms of fn() (CUDA events) with its GCUPS over real and padded cells
    and its shares of the measured ceiling and of the bound (ms)."""
    from . import time_cuda

    ms = time_cuda(fn, reps)
    return {"ms": ms, "gcups": cells / ms / 1e6,
            "padded_gcups": padded / ms / 1e6,
            "share_of_ceiling": cells / ms * 1e3
            / ceiling["sw_cells_per_s"],
            "bound_ms": bound, "share_of_bound": bound / ms}


def tail_pair(profile, Q, go=3, ge=1, reps=3):
    """`base` at the plan's G over lanes of TAIL_LEN columns on TAIL_BLOCKS
    CUDA blocks and on a full grid (SMs x occupancy blocks): ms, ns per
    cell and GCUPS of each; both equal ragged_dp on the same lanes."""
    from . import time_cuda

    dev = profile.device
    probe = random_stream(THREADS, TAIL_LEN, 5000, dev)
    G = plan_group(probe, Q)
    occ = occupancy("base", G, profile.shape[1])
    full = sm_count() * occ
    out = {"lane_columns": TAIL_LEN, "G": G, "occupancy_blocks_per_sm": occ}
    for name, blocks in (("last_wave_grid", TAIL_BLOCKS), ("full_grid", full)):
        B = blocks * THREADS // G
        stream = random_stream(B, TAIL_LEN, 5000, dev)
        got = unroll_score(profile, stream, "base", go, ge, G)
        if not torch.equal(got, single(profile, stream, go, ge)):
            raise RuntimeError(f"tail run {name}: base differs from ragged_dp")
        ms = time_cuda(lambda: unroll_score(profile, stream, "base", go, ge,
                                            G), reps)
        cells = Q * TAIL_LEN * B
        out[name] = {"cuda_blocks": blocks, "lanes": B, "ms": ms,
                     "ns_per_cell": ms * 1e6 / cells,
                     "gcups": cells / ms / 1e6}
        del stream
    out["per_cell_ratio"] = (out["last_wave_grid"]["ns_per_cell"]
                             / out["full_grid"]["ns_per_cell"])
    return out


def run(device="cuda", qpad=112, B=None, chunks=None, go=3, ge=1, reps=3,
        ceiling=None, tail=True):
    """Every variant at its plan's G, `single`, and on the card the forced-G
    sweep of `base` and the tail pair, on one input (see the module
    docstring), as a dict. `ceiling`: tools.roofline's measured ceiling
    (its "ceiling" entry); measured here (peak only) when None on the
    card."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if not cuda:
        qpad, B, chunks = min(qpad, 32), B or 128, chunks or 2
    else:
        B = B or LANES_PER_SM * sm_count()
        chunks = chunks or 64
    T = chunks * T_CHUNK
    profile, Q = random_profile(qpad, ge, 0, dev)
    stream = random_stream(B, T, 0, dev)
    cells, padded = Q * T * B, qpad * T * B
    res = {"tool": "exp_unroll", "device": str(dev), "measured": cuda,
           "Q": Q, "qpad": qpad, "B": B, "columns": T, "cells": cells,
           "variants": {}}
    if cuda:
        res["card"] = nvidia_smi("name,power.limit")
        if ceiling is None:
            from . import roofline

            ceiling = roofline.run_ceiling(dev)
        res["ceiling_sw_cells_per_s"] = ceiling["sw_cells_per_s"]
        bound = cell_bound_ms(cells)
    ref = single(profile, stream, go, ge)
    differ = []
    for v in VARIANTS:
        G = plan_group(stream, Q, v) if cuda else None
        if not torch.equal(unroll_score(profile, stream, v, go, ge, G), ref):
            differ.append(v)
        out = {}
        if cuda:
            out = {"G": G, **attrs(v, G, profile.shape[1]), **timed(
                lambda: unroll_score(profile, stream, v, go, ge, G), cells,
                padded, ceiling, bound, reps)}
        res["variants"][v] = out
    if cuda:
        add_sass(res["variants"], ceiling)
        res["variants"]["single"] = timed(
            lambda: single(profile, stream, go, ge), cells, padded, ceiling,
            bound, reps)
        res["g_sweep"] = {}
        for G in GROUPS:
            if not torch.equal(unroll_score(profile, stream, "base", go, ge,
                                            G), ref):
                differ.append(f"base at G {G}")
            res["g_sweep"][str(G)] = {
                **attrs("base", G, profile.shape[1]), **timed(
                    lambda: unroll_score(profile, stream, "base", go, ge, G),
                    cells, padded, ceiling, bound, reps)}
        if tail:
            res["tail"] = tail_pair(profile, Q, go, ge, reps)
    res["score_sum"] = int(ref.sum())
    res["variants_equal"] = not differ
    if differ:
        raise RuntimeError(f"exp_unroll variants differ from ragged_dp: "
                           f"{differ}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--qpad", type=int, default=112)
    ap.add_argument("--B", type=int, default=None,
                    help="lanes (default: fill every SM)")
    ap.add_argument("--chunks", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.qpad, a.B, a.chunks, reps=a.rounds)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
