"""Stacking ablation on the card (the counterpart of the TPU tool
tools/exp_sstack_ablate.py, whose Pallas kernel is the CUDA probe
csrc/exp_sstack.cu here).

    python -m opal_tpu_torch.tools.exp_sstack_ablate [--device cuda|cpu]

The TPU tool stacked S database streams as row segments of one DP column
(the dual of multi-query stacking) to ask whether a short query underfills
the column. On the card the dual is one thread carrying S database lanes
interleaved: S independent dependence chains for S times fewer threads.
One query profile (qp [Q_pad, 32] of values -4..11, used as qp - ge, as the
TPU kernel's `full` variant uses it) against S stream blocks of B lanes of
chunks x 64 letters; each block's running SW best is emitted every
per_block chunks (the tool's meta). Variants, all on the same cells:

  full<S>  - the probe at S = 1, 2 and 4 lanes per thread (`full`);
  s1ctl    - S = 1 with the query tiled S times against block 0 alone: the
             same cells and the same threads as full<S>, but S times more
             rows instead of S interleaved lanes;
  noprof   - full at S with the profile lookup replaced by a per-row
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

One JSON line: per variant ms and GCUPS, and whether every emitted row
equals the plain version. On the CPU (`--device cpu`) the plain version
runs at a small size and no time is reported.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..engine.search import resolve_device
from . import LAUNCHES, check_launch, cu_stream, lib, nvidia_smi, sm_count

T_CHUNK = 64   # letters per chunk
A_PAD = 32     # profile columns
THREADS = 128  # lanes per CUDA block
STRIP = 16     # query rows per register strip (R in csrc/exp_sstack.cu)


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


def _check(profile, stream, meta, nb, S):
    from ..engine import kernels

    kernels._check_inputs(profile, stream)
    NB, B = stream.lengths.shape
    T = int(stream.host_offsets[1] - stream.host_offsets[0]) // B
    if (T < T_CHUNK or T % T_CHUNK
            or np.any(np.diff(stream.host_offsets) != T * B)
            or not bool((stream.lengths == T).all())):
        raise ValueError("every lane must hold the same whole chunks")
    if S not in (1, 2, 4) or NB % S:
        raise ValueError(f"S={S}: 1, 2 or 4 lanes per thread, dividing the "
                         f"{NB} blocks")
    if (meta.dtype != torch.int32 or tuple(meta.shape) != (5 * NB,
                                                           T // T_CHUNK)
            or meta.device != stream.letters.device):
        raise ValueError(f"meta must be [{5 * NB}, {T // T_CHUNK}] int32 "
                         "beside the stream")
    blk = meta.reshape(NB, 5, -1)[:, 0]
    if int(blk.min()) < 0 or int(blk.max()) >= nb:
        raise ValueError(f"meta's output blocks outside [0, {nb})")
    return T


def sstack_score(profile: torch.Tensor, stream, meta: torch.Tensor, nb: int,
                 S: int = 1, noprof: bool = False, go: int = 3,
                 ge: int = 1) -> torch.Tensor:
    """[NB, nb, B] int32: for each stream block and lane, the running SW
    best written at the chunks meta marks (rows never written hold 0).
    CUDA tensors launch the probe with S lanes per thread
    (LAUNCHES["exp_sstack"]), CPU tensors run sstack_plain."""
    T = _check(profile, stream, meta, nb, S)
    dev = stream.letters.device
    if dev.type == "cpu":
        return sstack_plain(profile, stream, meta, nb, noprof, go, ge)
    if dev.type != "cuda":
        raise ValueError(f"no exp_sstack kernel for device {dev}")
    profile = profile.contiguous()
    NB, B = stream.lengths.shape
    out = torch.zeros((NB, nb, B), dtype=torch.int32, device=dev)
    scratch = None
    if profile.shape[0] > STRIP:
        scratch = torch.empty(2 * stream.letters.numel(), dtype=torch.int32,
                              device=dev)
    with torch.cuda.device(dev):
        check_launch(_lib().exp_sstack_launch(
            profile.data_ptr(), stream.letters.data_ptr(),
            meta.contiguous().data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            NB, B, profile.shape[0], profile.shape[1], T, nb, int(go),
            int(ge), int(S), int(bool(noprof)), cu_stream(dev)),
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


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # profile, letters, meta, scratch, out, n_blocks, B, Q, W, T, nb, go,
    # ge, S, noprof, stream
    return lib("exp_sstack", {"exp_sstack_launch": [vp] * 5 + [ci] * 10
                              + [vp]})


def run(device="cuda", S=4, qpad=128, B=None, chunks=None, per_block=8,
        go=3, ge=1, reps=3):
    """The variants (see the module docstring) on one input, as a dict."""
    from ..constants import MODE_SW, SEARCH_SCORE
    from ..engine import kernels
    from . import time_cuda

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if not cuda:
        S, qpad, B, chunks, per_block = min(S, 2), min(qpad, 16), B or 128, \
            chunks or 4, min(per_block, 2)
    else:
        B = B or 2 * THREADS * sm_count()
        chunks = chunks or 16
    profile, stream, meta, nb = random_inputs(qpad, B, chunks, S, per_block,
                                              ge, 0, dev)
    T = chunks * T_CHUNK
    cells = qpad * T * B * S
    res = {"tool": "exp_sstack_ablate", "device": str(dev), "measured": cuda,
           "S": S, "qpad": qpad, "B": B, "columns": T, "per_block": per_block,
           "cells": cells, "variants": {}}
    if cuda:
        res["card"] = nvidia_smi("name,power.limit")
    ctl = s1ctl_inputs(profile, stream, meta, S)
    runs = {f"full{s}": (lambda s=s: sstack_score(
        profile, stream, meta, nb, s, False, go, ge)) for s in (1, 2, 4)
        if S % s == 0}
    runs["s1ctl"] = lambda: sstack_score(*ctl, nb, 1, False, go, ge)
    runs["noprof"] = lambda: sstack_score(profile, stream, meta, nb, S, True,
                                          go, ge)
    runs["single"] = lambda: kernels.ragged_score(
        profile, stream, MODE_SW, SEARCH_SCORE, go, ge)
    outs = {v: fn() for v, fn in runs.items()}
    # the variants that compute full's function agree with each other, and
    # ragged_dp's final best with full's last emit
    fulls = [o for v, o in outs.items() if v.startswith("full")]
    last = int(np.flatnonzero(make_meta(1, chunks, per_block)[2] == 1)[-1])
    res["full_equal"] = all(torch.equal(o, fulls[0]) for o in fulls)
    if last == chunks - 1:
        res["single_equal_last_emit"] = bool(torch.equal(
            outs["single"][:, 0], fulls[0][:, last // per_block]))
    if not res["full_equal"] or not res.get("single_equal_last_emit", True):
        raise RuntimeError("exp_sstack variants disagree")
    if cuda:
        for v, fn in runs.items():
            ms = time_cuda(fn, reps)
            res["variants"][v] = {"ms": ms, "gcups": cells / ms / 1e6}
    res["score_sum"] = int(fulls[0].sum())
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
