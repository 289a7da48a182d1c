"""Stacking ablation on the card (the counterpart of the TPU tool
tools/exp_sstack_ablate.py, whose Pallas kernel is the CUDA probe
csrc/exp_sstack.cu here).

    python -m opal_tpu_torch.tools.exp_sstack_ablate [--device cuda|cpu]

The TPU tool stacked S database streams as row segments of one DP column
(the dual of multi-query stacking) to ask whether a short query underfills
the column. On the card the question is how much of a column's serial
16-row chain more independent chains per thread hide, asked of ragged_dp's
strip-group body (engine/csrc/strip_group.cuh): a lane's strips go to G
threads of one warp swept as a column wavefront, and each thread of the
group carries several chains per step. One query profile (qp [Q_pad, 32]
of values -4..11, used as qp - ge, as the TPU kernel's `full` variant uses
it) against S stream blocks of B lanes of chunks x 64 letters; each
block's running SW best is emitted every per_block chunks (the tool's
meta). Variants, all on the same cells, at the launch plan's G
(kernels.plan_for) unless named:

  full<S>  - lanes<S>: each thread of the group carries its strip for S =
             1, 2 and 4 database lanes (one per stream block), interleaved
             (`full`);
  strips2  - each thread carries two adjacent strips of one lane, the
             lower a column behind the upper (S = 1, half the plan's G:
             the threads per cell of full2);
  s1ctl    - S = 1 with the query tiled S times against block 0 alone: the
             same cells and the same threads as full<S>, but S times more
             rows instead of S interleaved lanes;
  noprof   - full<S> with the profile lookup replaced by a per-row
             constant (the function of full on letters that are all 0);
  single   - ragged_dp on the same stream (its final best equals full's
             last emit).

Variants of the TPU tool with no counterpart here, and why: onedot, noemit,
out1, out1qps, out1lett1, out1noseg, out1all, outconst, lett1, qps, noseg
and noinit probe the TPU's one-hot profile matmul on the MXU, Pallas output
references and their index maps, and the SEG_M row ramp that isolates
segments. The card has no MXU in this kernel (the profile is a shared-memory
lookup, which noprof prices), no output references (a thread stores its
own result), and no segments to isolate (each lane has its own registers).

One JSON line: per variant ms, GCUPS, its shares of the bound (3.5
max-type instructions per cell at the card's highest clock) and of the
measured SW-cell ceiling (tools.roofline), SASS per cell, registers, local
(spill) bytes and resident CUDA blocks per SM, and whether every emitted
row equals the plain version; at the tool's qpad and at the main path's
query height (Q_MAIN rows: 7 strips, so G 8 leaves a thread idle). On the
CPU (`--device cpu`) the plain version runs at a small size and no time is
reported.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..engine.search import resolve_device
from . import (LAUNCHES, cell_bound_ms, check_launch, cu_stream, lib,
               nvidia_smi, sm_count)

T_CHUNK = 64   # letters per chunk
A_PAD = 32     # profile columns
THREADS = 128  # threads per CUDA block
STRIP = 16     # query rows per register strip (R in strip_group.cuh)
GROUPS = (1, 2, 4, 8)  # threads per lane the kernel takes
Q_MAIN = 110   # the main path's query height (O74807)


def make_meta(n_blocks, C, per_block):
    """The TPU tool's meta for every stream block: [5 * n_blocks, C] int32
    with rows (output block, first, emit, t0, active) per stream; a block's
    running best is emitted at the last chunk of each group of per_block
    chunks into output block c // per_block."""
    c = np.arange(C)
    one = np.stack([c // per_block, c % per_block == 0,
                    c % per_block == per_block - 1, (c % per_block) * T_CHUNK,
                    np.ones(C, bool)]).astype(np.int32)
    return np.tile(one, (n_blocks, 1))


def inputs(qp, letters, meta, ge, device):
    """(profile, stream, meta) from the TPU tool's operands: qp [Q_pad, 32]
    (the per-segment profile before block-diagonal stacking; the kernel
    reads qp - ge), letters [C, S * 64, B] int8 (segment s's chunk c at rows
    s * 64 .. s * 64 + 63), meta [5S, C]. Segment s becomes stream block s."""
    from ..engine import kernels

    letters = np.asarray(letters, np.int8)
    C, rows, B = letters.shape
    S = rows // T_CHUNK
    blocks = [letters[:, s * T_CHUNK:(s + 1) * T_CHUNK].reshape(C * T_CHUNK, B)
              for s in range(S)]
    stream = kernels.pack_stream(blocks, np.full((S, B), C * T_CHUNK,
                                                 np.int32), B, device)
    profile = torch.from_numpy(
        (np.asarray(qp, np.float32) - ge).astype(np.int32)).to(device)
    return profile, stream, torch.from_numpy(
        np.ascontiguousarray(meta, np.int32)).to(device)


def random_inputs(qpad, B, chunks, n_blocks, per_block, ge=1, seed=0,
                  device="cuda"):
    """(profile, stream, meta, nb): a profile of qpad rows from
    default_rng(seed) (values -4..11, used as qp - ge) and n_blocks stream
    blocks of B lanes of chunks x 64 random letters made on `device`."""
    from ..engine import kernels

    rng = np.random.default_rng(seed)
    qp = rng.integers(-4, 12, size=(qpad, A_PAD)).astype(np.int32)
    T = chunks * T_CHUNK
    gen = torch.Generator(device=device).manual_seed(seed)
    letters = torch.randint(0, 20, (n_blocks * T * B,), generator=gen,
                            device=device, dtype=torch.int8)
    offsets = np.arange(n_blocks + 1, dtype=np.int64) * (T * B)
    stream = kernels.Stream(
        letters=letters, offsets=torch.from_numpy(offsets).to(device),
        lengths=torch.full((n_blocks, B), T, dtype=torch.int32,
                           device=device), host_offsets=offsets)
    meta = torch.from_numpy(make_meta(n_blocks, chunks, per_block)).to(device)
    return (torch.from_numpy(qp - ge).to(device), stream, meta,
            chunks // per_block + 2)


def _check(profile, stream, meta, nb, S, strips2=False, G=None):
    from ..engine import kernels

    kernels._check_inputs(profile, stream)
    NB, B = stream.lengths.shape
    T = int(stream.host_offsets[1] - stream.host_offsets[0]) // B
    if (T < T_CHUNK or T % T_CHUNK
            or np.any(np.diff(stream.host_offsets) != T * B)
            or not bool((stream.lengths == T).all())):
        raise ValueError("every lane must hold the same whole chunks")
    if S not in (1, 2, 4) or NB % S or (strips2 and S != 1):
        raise ValueError(f"S={S}: 1, 2 or 4 lanes per thread, dividing the "
                         f"{NB} blocks (1 with strips2)")
    if G is not None and G not in GROUPS:
        raise ValueError(f"G={G}: one of {GROUPS} threads per lane")
    if (meta.dtype != torch.int32 or tuple(meta.shape) != (5 * NB,
                                                           T // T_CHUNK)
            or meta.device != stream.letters.device):
        raise ValueError(f"meta must be [{5 * NB}, {T // T_CHUNK}] int32 "
                         "beside the stream")
    blk = meta.reshape(NB, 5, -1)[:, 0]
    if int(blk.min()) < 0 or int(blk.max()) >= nb:
        raise ValueError(f"meta's output blocks outside [0, {nb})")
    return T


def plan_group(stream, Q, strips2=False):
    """G of the stream's blocks in ragged_dp's launch plan
    (kernels.plan_for, on the card) for Q query rows; half of it (at least
    1) for strips2, whose threads carry two strips each."""
    from ..engine import kernels

    G = int(kernels.plan_for(stream, -(-Q // STRIP)).groups[0])
    return max(1, G // 2) if strips2 else G


def sstack_score(profile: torch.Tensor, stream, meta: torch.Tensor, nb: int,
                 S: int = 1, noprof: bool = False, go: int = 3,
                 ge: int = 1, strips2: bool = False,
                 G: int | None = None) -> torch.Tensor:
    """[NB, nb, B] int32: for each stream block and lane, the running SW
    best written at the chunks meta marks (rows never written hold 0).
    CUDA tensors launch the probe (LAUNCHES["exp_sstack"]) with S lanes
    per thread, or two strips per thread (strips2), and G threads per lane
    (plan_group's by default); CPU tensors run sstack_plain."""
    T = _check(profile, stream, meta, nb, S, strips2, G)
    dev = stream.letters.device
    if dev.type == "cpu":
        return sstack_plain(profile, stream, meta, nb, noprof, go, ge)
    if dev.type != "cuda":
        raise ValueError(f"no exp_sstack kernel for device {dev}")
    profile = profile.contiguous()
    NB, B = stream.lengths.shape
    Q = profile.shape[0]
    G = G or plan_group(stream, Q, strips2)
    out = torch.zeros((NB, nb, B), dtype=torch.int32, device=dev)
    scratch = None
    if Q > (2 if strips2 else 1) * G * STRIP:  # more than one pass
        scratch = torch.empty(2 * stream.letters.numel(), dtype=torch.int32,
                              device=dev)
    with torch.cuda.device(dev):
        check_launch(_lib().exp_sstack_launch(
            profile.data_ptr(), stream.letters.data_ptr(),
            meta.contiguous().data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            NB, B, Q, profile.shape[1], T, nb, int(go), int(ge), int(S),
            int(bool(strips2)), int(bool(noprof)), int(G), cu_stream(dev)),
            "exp_sstack")
    LAUNCHES["exp_sstack"] += 1
    return out


def running_best_plain(profile, letters, go, ge):
    """[T // 64, L] running SW best of profile [Q, W] against letters [T, L]
    (int64) at the end of each 64-column chunk; the F chain as a max-plus
    prefix (exact for ge <= go)."""
    if ge > go:
        raise ValueError("the plain version's F prefix needs ge <= go")
    T, L = letters.shape
    Q = profile.shape[0]
    dev = profile.device
    prof_t = profile.t().contiguous()
    H = torch.zeros((L, Q), dtype=torch.int32, device=dev)
    E = torch.zeros_like(H)
    best = torch.zeros(L, dtype=torch.int32, device=dev)
    ramp = (torch.arange(Q, dtype=torch.int32, device=dev) * ge)[None]
    head = torch.full((L, 1), max(-go, -ge), dtype=torch.int32, device=dev)
    zero = torch.zeros((L, 1), dtype=torch.int32, device=dev)
    snaps = []
    for t in range(T):
        P = prof_t[letters[t]]
        E = torch.maximum(H - go, E - ge)
        Hp = torch.maximum(E, torch.cat([zero, H[:, :-1]], 1) + P).clamp_min(0)
        F = torch.cummax(torch.cat([head, Hp[:, :-1] - go], 1) + ramp,
                         1).values - ramp
        H = torch.maximum(Hp, F)
        best = torch.maximum(best, H.amax(1))
        if (t + 1) % T_CHUNK == 0:
            snaps.append(best)
    return torch.stack(snaps)


def sstack_plain(profile, stream, meta, nb, noprof=False, go=3, ge=1):
    """The function `sstack_score` computes, in plain PyTorch (noprof: on
    letters that are all 0)."""
    T = _check(profile, stream, meta, nb, 1)
    NB, B = stream.lengths.shape
    lett = stream.letters.view(NB, T // 4, B, 4).permute(1, 3, 0, 2).reshape(
        T, NB * B).to(torch.int64)
    if noprof:
        lett = torch.zeros_like(lett)
    snaps = running_best_plain(profile, lett, go, ge).reshape(-1, NB, B)
    out = torch.zeros((NB, nb, B), dtype=torch.int32, device=profile.device)
    m = meta.reshape(NB, 5, -1).cpu().numpy()
    for blk in range(NB):
        for c in np.flatnonzero(m[blk, 2] == 1):
            out[blk, m[blk, 0, c]] = snaps[c, blk]
    return out


def s1ctl_inputs(profile, stream, meta, S):
    """s1ctl's input: the profile tiled S times, block 0 of the stream and
    its meta rows."""
    from ..engine import kernels

    size = int(stream.host_offsets[1])
    sub = kernels.Stream(letters=stream.letters[:size],
                         offsets=stream.offsets[:2],
                         lengths=stream.lengths[:1],
                         host_offsets=stream.host_offsets[:2])
    return profile.repeat(S, 1), sub, meta[:5]


def attrs(S=1, strips2=False, noprof=False, G=8, W=A_PAD):
    """{"blocks_per_sm", "registers", "local_bytes"} of the variant's
    kernel at G threads per lane and profile width W: resident CUDA
    blocks per SM, registers and local (spill) bytes per thread."""
    out = (ctypes.c_int * 3)()
    err = _lib().exp_sstack_attrs(int(S), int(bool(strips2)),
                                  int(bool(noprof)), int(G), int(W), out)
    if err:
        raise RuntimeError(f"exp_sstack attribute query: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes"), out))


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return lib("exp_sstack", {
        # profile, letters, meta, scratch, out, n_blocks, B, Q, W, T, nb,
        # go, ge, S, strips2, noprof, G, stream
        "exp_sstack_launch": [vp] * 5 + [ci] * 12 + [vp],
        # S, strips2, noprof, G, W, out[3]
        "exp_sstack_attrs": [ci] * 5 + [ctypes.POINTER(ci)]})


def loop_per_cell(S, strips2, noprof):
    """SASS opcodes per cell of the variant's column loop
    (tools.sass_counts' "main") and its max-type instructions per cell: a
    cell reads its profile value from shared memory once, so the loop's
    LDS count is its cells; noprof reads none, and its loop computes one
    column of each chain. (None, None) for a loop without its cells'
    reads."""
    from . import SASS_MAX_OPS, sass_counts

    pat = f"sstack_kernelILi{S}ELb{int(strips2)}ELb{int(noprof)}E"
    loop = next(c["main"] for f, c in sass_counts("exp_sstack").items()
                if pat in f)
    cells = (2 if strips2 else S) * STRIP if noprof else loop.get("LDS")
    if not cells:
        return None, None
    return ({op: n / cells for op, n in loop.items()},
            sum(loop.get(op, 0) for op in SASS_MAX_OPS) / cells)


def measure(runs, kinds, cells, ceiling, W, reps):
    """ms of each run (CUDA events), with GCUPS over `cells`, the shares
    of the measured ceiling and of the bound, and its kernel's G,
    attributes and SASS per cell (kinds: run -> (S, strips2, noprof, G),
    None for ragged_dp)."""
    from . import time_cuda

    bound = cell_bound_ms(cells)
    out = {}
    for v, fn in runs.items():
        ms = time_cuda(fn, reps)
        r = {"ms": ms, "gcups": cells / ms / 1e6,
             "share_of_ceiling": cells / ms * 1e3
             / ceiling["sw_cells_per_s"],
             "bound_ms": bound, "share_of_bound": bound / ms}
        if kinds.get(v):
            S, strips2, noprof, G = kinds[v]
            r.update({"S": S, "strips2": strips2, "G": G,
                      **attrs(S, strips2, noprof, G, W)})
            r["sass_per_cell"], r["max_per_cell"] = loop_per_cell(
                S, strips2, noprof)
        out[v] = r
    return out


def shape(dev, S, qpad, B, chunks, per_block, go, ge, reps, ceiling):
    """The variants on one input of a qpad-row profile (see the module
    docstring): their equality, and on the card their measures."""
    from ..constants import MODE_SW, SEARCH_SCORE
    from ..engine import kernels

    cuda = dev.type == "cuda"
    profile, stream, meta, nb = random_inputs(qpad, B, chunks, S, per_block,
                                              ge, 0, dev)
    res = {"qpad": qpad, "strips": -(-qpad // STRIP), "variants": {}}
    ctl = s1ctl_inputs(profile, stream, meta, S)
    kinds = {}
    if cuda:
        kinds = {f"full{s}": (s, False, False, plan_group(stream, qpad))
                 for s in (1, 2, 4) if S % s == 0}
        kinds["strips2"] = (1, True, False, plan_group(stream, qpad, True))
        kinds["s1ctl"] = (1, False, False, plan_group(ctl[1], S * qpad))
        kinds["noprof"] = (S, False, True, plan_group(stream, qpad))
    runs = {f"full{s}": (lambda s=s: sstack_score(
        profile, stream, meta, nb, s, False, go, ge)) for s in (1, 2, 4)
        if S % s == 0}
    runs["strips2"] = lambda: sstack_score(profile, stream, meta, nb, 1,
                                           False, go, ge, strips2=True)
    runs["s1ctl"] = lambda: sstack_score(*ctl, nb, 1, False, go, ge)
    runs["noprof"] = lambda: sstack_score(profile, stream, meta, nb, S, True,
                                          go, ge)
    runs["single"] = lambda: kernels.ragged_score(
        profile, stream, MODE_SW, SEARCH_SCORE, go, ge)
    outs = {v: fn() for v, fn in runs.items()}
    # the variants that compute full's function agree with each other, and
    # ragged_dp's final best with full's last emit
    fulls = [o for v, o in outs.items() if v.startswith("full")
             or v == "strips2"]
    last = int(np.flatnonzero(make_meta(1, chunks, per_block)[2] == 1)[-1])
    res["full_equal"] = all(torch.equal(o, fulls[0]) for o in fulls)
    if last == chunks - 1:
        res["single_equal_last_emit"] = bool(torch.equal(
            outs["single"][:, 0], fulls[0][:, last // per_block]))
    if not res["full_equal"] or not res.get("single_equal_last_emit", True):
        raise RuntimeError("exp_sstack variants disagree")
    if cuda:
        res["variants"] = measure(runs, kinds, qpad * chunks * T_CHUNK * B
                                  * S, ceiling, profile.shape[1], reps)
    res["score_sum"] = int(fulls[0].sum())
    return res


def run(device="cuda", S=4, qpad=128, B=None, chunks=None, per_block=8,
        go=3, ge=1, reps=3, ceiling=None, main_height=True):
    """The variants (see the module docstring) at qpad and, with
    main_height, at Q_MAIN rows, as a dict. `ceiling`: tools.roofline's
    measured ceiling (its "ceiling" entry); measured here (peak only) when
    None on the card."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if not cuda:
        S, qpad, B, chunks, per_block = min(S, 2), min(qpad, 16), B or 128, \
            chunks or 4, min(per_block, 2)
    else:
        B = B or 2 * THREADS * sm_count()
        chunks = chunks or 16
    T = chunks * T_CHUNK
    res = {"tool": "exp_sstack_ablate", "device": str(dev), "measured": cuda,
           "S": S, "qpad": qpad, "B": B, "columns": T, "per_block": per_block,
           "cells": qpad * T * B * S}
    if cuda:
        res["card"] = nvidia_smi("name,power.limit")
        if ceiling is None:
            from . import roofline

            ceiling = roofline.run_ceiling(dev)
    first = shape(dev, S, qpad, B, chunks, per_block, go, ge, reps, ceiling)
    res.update({k: first[k] for k in ("variants", "full_equal",
                                      "score_sum")})
    if "single_equal_last_emit" in first:
        res["single_equal_last_emit"] = first["single_equal_last_emit"]
    if main_height:
        q = Q_MAIN if cuda else 20
        res["main_height"] = shape(dev, S, q, B, chunks, per_block, go, ge,
                                   reps, ceiling)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--S", type=int, default=4)
    ap.add_argument("--qpad", type=int, default=128)
    ap.add_argument("--B", type=int, default=None,
                    help="lanes per stream block (default: fill every SM)")
    ap.add_argument("--chunks", type=int, default=None)
    ap.add_argument("--per-block", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.S, a.qpad, a.B, a.chunks, a.per_block,
                         reps=a.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
