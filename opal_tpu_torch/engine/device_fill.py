"""The alignment fill and backtrace walk of the x2 winners on the card.

The counterpart of opal_tpu/engine/device_fill.py. The alignment stage
reconstructs each winner's path with the reverse-pair trick (traceback.py):
a banded NW-boundary DP over the REVERSED prefixes query[:end_q+1][::-1]
and target[:end_t+1][::-1], whose end is the forward start. Here a group of
such pairs, one per lane, is filled and walked on the card in one launch
(csrc/device_fill.cu, `device_fill`), which replaces opal_tpu's XLA
`_fill_walk_fn` (opal_tpu/engine/device_fill.py:90-318). Per cell the fill
records five decision bits in a uint8 matrix that never leaves the card
([Tp, Qp, B] in the plain version, lane-major [B, Tp, Qp] in the kernel):

  bit0  H == E            (the walk prefers E on ties)
  bit1  H == F            (then F, then the diagonal)
  bit2  E == H(left) - go (E opened here rather than extended)
  bit3  F == H(up) - go   (the same for F)
  bit4  the diagonal substitution is a match

with per-lane trackers that follow traceback.find_alignment's early stop
and end rules per mode. The walk runs on the card too, with field switches
fused into the first emission of the run they start, so Qp + Tp + 4 steps
suffice; only the op codes come back, two per byte in base 5. The host
unpacks them and replay-validates every path (traceback._replay_batch).

`fill_walk` launches the kernel for CUDA tensors, runs `fill_walk_plain`
(a PyTorch transcription of `_fill_walk_fn`, int32) for CPU tensors and
raises for anything else; the two agree on all five outputs, bit for bit.
The kernel runs one warp per lane, a column wavefront over strips of R
query rows (`plan_fill` picks R and sizes the scratch).
`align_winners_device` is the host driver (opal_tpu's :325-474).
Lanes that go to the host path instead are opal_tpu's own: no closed-form
band, values past VALUE_BOUND, a failed replay; and lanes whose bits alone
pass FILL_BUDGET_BYTES. `LAST_STATS` counts them by reason. opal_tpu's f32 variant (OPAL_TPU_DEVICE_FILL_F32) has no
counterpart: the card runs int32.
"""
from __future__ import annotations

import ctypes
import os
import sys
import time

import numpy as np
import torch

from ..bandmath import band_borders
from ..constants import (
    ALIGN_DEL,
    ALIGN_INS,
    ALIGN_MATCH,
    ALIGN_MISMATCH,
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
)
from . import kernels
from .search import resolve_device

LSB = -(1 << 30)        # -inf sentinel (int32, headroom for -go/-ge algebra)
NEG2 = LSB - (1 << 24)  # strictly dominated filler of the F chain
BIGR = 1 << 24          # "no row found" marker of the end_q search
# Real DP values must stay far from the LSB algebra; |score| and the
# per-column chain offsets must fit int32.
VALUE_BOUND = 1 << 28
# Bytes of decision bits one launch may hold (Tp x Qp x B uint8): a group
# is cut where it would pass this, and a lane whose bits alone pass it
# goes to the host path.
FILL_BUDGET_BYTES = 1 << 31
# Query rows per strip of the kernel (16 or 32); None lets plan_fill pick
# by Qp. Tests set 16 to reach several passes per lane at a small Qp;
# chip_smoke times the protocol's groups at both.
FILL_ROWS = None
WARP = 32  # threads of the warp that fills one lane

# what the last align_winners_device call did (OPAL_TPU_DEVICE_FILL_STATS
# prints it): groups and their shapes, lanes filled on the device, lanes
# left to the host path by reason, and the host-side milliseconds
LAST_STATS: dict = {}


def _round_up(x, q):
    return -(-x // q) * q


def steps_for(Qp: int, Tp: int) -> int:
    """Walk steps of a [Qp, Tp] group: every live step emits one op."""
    return Qp + Tp + 4


def plan_fill(Qp: int, Tp: int, B: int, rows=None) -> dict:
    """The kernel's launch plan for a [Qp, Tp] group of B lanes: `rows` (R)
    query rows per strip, 16 unless Qp passes 32 strips of 16, then 32 (a
    Qp 576-1024 lane in one pass rather than two);
    `passes` of 32 strips the tallest lane needs; `scratch_bytes` of the
    [B, Tp] int2 row and int4 summary scratch that passes hand on through
    (0 for one pass); `blocks` of 4 lanes (warps)."""
    R = rows if rows is not None else (16 if Qp <= WARP * 16 else 32)
    if R not in (16, 32):
        raise ValueError("a strip holds 16 or 32 rows")
    passes = -(-Qp // (WARP * R))
    return {"rows": R, "passes": passes,
            "scratch_bytes": B * Tp * (8 + 16) if passes > 1 else 0,
            "blocks": -(-B // 4)}


def computed_columns(tlen, executed, mode):
    """Columns the first thread of a lane's last pass computes, per lane,
    against the `executed` columns (rend_t + 1 where the guard stops): the
    last thread learns of the stop 31 columns behind the first, so a lane
    that stops early computes up to 31 columns more than it executes (NW
    and lanes that run to tlen compute exactly theirs). Exact when the
    lane runs one pass; an earlier pass may stop sooner."""
    tlen = np.asarray(tlen, np.int64)
    executed = np.asarray(executed, np.int64)
    if mode == MODE_NW:
        return tlen.copy()
    return np.where(executed >= tlen, tlen,
                    np.minimum(tlen, executed + WARP - 1))


# ----------------------------------------------------------------------
# plain version


def fill_walk_plain(aq, at, qlen, tlen, bottom, top, limit, go, ge, matrix,
                    mode):
    """opal_tpu's _fill_walk_fn (opal_tpu/engine/device_fill.py:90-318) in
    PyTorch, int32, on the tensors' device. aq [Qp, B] and at [Tp, B] int32
    letters of the reversed prefixes, qlen .. limit [B] int32, matrix [A, A]
    int32. Returns (score, rend_q, rend_t [B] int32, ok [B] bool, codes
    [(Qp + Tp + 4) // 2, B] uint8: op + 1 per walk step in forward order,
    0 = no emission, two steps per byte as c[0::2] * 5 + c[1::2])."""
    kernels.PLAIN_CALLS["fill_walk_plain"] += 1
    dev = aq.device
    Qp, B = aq.shape
    Tp = at.shape[0]
    go, ge = int(go), int(ge)
    i32 = torch.int32
    ridx = torch.arange(Qp, dtype=i32, device=dev)[:, None]
    qmask = ridx < qlen[None, :]
    rg = ridx * ge
    aq64 = aq.long()
    mat = matrix.to(device=dev, dtype=i32)
    A = mat.shape[0]

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=dev)

    prevH = torch.where(qmask, -go - rg, LSB).to(i32)
    prevE = full((Qp, B), LSB)
    m = full((B,), NEG2)
    last_col = full((B,), 0)
    endq = full((B,), BIGR)
    h_last = full((B,), LSB)
    dirs = torch.zeros((Tp, Qp, B), dtype=torch.uint8, device=dev)
    for c in range(Tp):
        col_live = c < tlen
        active = col_live if mode == MODE_NW else col_live & (m < limit)
        if not bool(active.any()):
            break  # no lane executes this column or any later one
        letters = at[c].long()
        P = mat.view(-1)[aq64 * A + letters[None, :]]
        in_band = (qmask & col_live[None, :] & (ridx >= c - top[None, :])
                   & (ridx <= c + bottom[None, :]))
        bnd_uH = -go - c * ge  # NW boundary H(-1, c)
        ulH0 = 0 if c == 0 else bnd_uH + ge
        E = torch.maximum(prevH - go, prevE - ge)
        ulH = torch.cat([full((1, B), ulH0), prevH[:-1]])
        Hp = torch.maximum(E, ulH + P)
        Hp_m = torch.where(in_band, Hp, LSB)
        # the F chain as opal_tpu's exact max-plus prefix (ge <= go), seeded
        # uF = LSB at the first in-band row of the column
        above_out = torch.cat([torch.ones((1, B), dtype=torch.bool,
                                          device=dev), ~in_band[:-1]])
        seed = torch.where(in_band & above_out, LSB - ge, NEG2)
        c_top = torch.cat([full((1, B), bnd_uH - go), Hp_m[:-1] - go])
        C = torch.where(in_band, torch.maximum(c_top, seed), NEG2)
        F = torch.cummax(C + rg, dim=0).values - rg
        Hcol = torch.maximum(Hp, F)

        H_m = torch.where(in_band, Hcol, LSB)
        E_m = torch.where(in_band, E, LSB)
        F_m = torch.where(in_band, F, LSB)
        uh = torch.cat([full((1, B), LSB), H_m[:-1]])
        bits = ((H_m == E_m).to(torch.uint8)
                | ((H_m == F_m).to(torch.uint8) << 1)
                | ((E_m == prevH - go).to(torch.uint8) << 2)
                | ((F_m == uh - go).to(torch.uint8) << 3)
                | ((aq == letters[None, :].to(i32)).to(torch.uint8) << 4))
        dirs[c] = bits

        # trackers: a column executes while the PRE-column max is below
        # the limit (find_alignment's loop guard); NW has no early stop
        re = torch.clamp(torch.minimum(qlen - 1, c + bottom), 0, Qp - 1)
        empty = (c - top > torch.minimum(qlen - 1, c + bottom)) | ~col_live
        gath = H_m.gather(0, re[None, :].long())[0]
        h_last_new = torch.where(active & ~empty, gath, h_last)
        colmax = torch.where(in_band, Hcol, NEG2).max(dim=0).values
        if mode == MODE_SW:
            cand, upd = colmax, active & ~empty
        elif mode == MODE_HW:
            cand, upd = h_last_new, active
        elif mode == MODE_OV:
            cand = torch.maximum(h_last_new, torch.where(
                (c == tlen - 1) & ~empty, colmax, NEG2))
            upd = active
        else:  # NW: the score is h_last at the end
            cand, upd = m, torch.zeros_like(active)
        m_new = torch.where(upd, torch.maximum(m, cand), m)
        # first in-band row equal to the updated max, evaluated in every
        # executed column: the last executed column's answer stands
        hit = in_band & (Hcol == m_new[None, :])
        first = torch.where(hit, ridx, BIGR).min(dim=0).values
        endq = torch.where(active, first, endq)
        last_col = torch.where(active, torch.full_like(last_col, c),
                               last_col)
        m, h_last = m_new, h_last_new
        prevH, prevE = H_m, E_m

    score = h_last if mode == MODE_NW else m
    if mode == MODE_NW:
        rend_q, rend_t = qlen - 1, tlen - 1
        ok = score == limit
    elif mode == MODE_HW:
        rend_q, rend_t = qlen - 1, last_col
        ok = score == limit
    else:  # SW / OV
        rend_q, rend_t = endq, last_col
        ok = (score == limit) & (endq < BIGR)
    ok = ok & (rend_q >= 0) & (rend_q < qlen)
    codes = _walk_plain(dirs, torch.where(ok, rend_q, -1),
                        torch.where(ok, rend_t, -1))
    return (score.to(i32), rend_q.to(i32), rend_t.to(i32), ok,
            codes)


def _walk_plain(dirs, r, c):
    """The lockstep backtrace of opal_tpu's walk (:236-293) over the
    decision bits: tie order E, F, diagonal; border indels once one
    coordinate is spent; lanes at (-1, -1) emit nothing."""
    Tp, Qp, B = dirs.shape
    dev = dirs.device
    steps = steps_for(Qp, Tp)
    lanes = torch.arange(B, device=dev)
    field = torch.zeros(B, dtype=torch.int32, device=dev)
    r, c = r.to(torch.int32), c.to(torch.int32)
    codes = torch.zeros((steps, B), dtype=torch.uint8, device=dev)
    for s in range(steps):
        if not bool(((r >= 0) | (c >= 0)).any()):
            break  # every lane is done: the rest of the codes stay 0
        inside = (r >= 0) & (c >= 0)
        bits = torch.where(inside, dirs[c.clamp(0, Tp - 1).long(),
                                        r.clamp(0, Qp - 1).long(), lanes],
                           0).to(torch.int32)
        b0, b1 = (bits & 1) != 0, (bits & 2) != 0
        b2, b3 = (bits & 4) != 0, (bits & 8) != 0
        is_match = (bits & 16) != 0
        fH = inside & (field == 0)
        fE = inside & (field == 1)
        fF = inside & (field == 2)
        ins_step = fE | (fH & b0)        # an E run: emit INS now
        del_step = fF | (fH & ~b0 & b1)  # an F run: emit DEL now
        diag = fH & ~b0 & ~b1
        e_open = ins_step & b2 & (c > 0)
        f_open = del_step & b3 & (r > 0)
        bdel = ~inside & (r >= 0)
        bins = ~inside & (r < 0) & (c >= 0)
        sub = torch.where(is_match, ALIGN_MATCH + 1, ALIGN_MISMATCH + 1)
        code = torch.where(diag, sub, torch.where(
            ins_step | bins, ALIGN_INS + 1,
            torch.where(del_step | bdel, ALIGN_DEL + 1, 0)))
        field = torch.where(ins_step, 1, field)
        field = torch.where(del_step, 2, field)
        field = torch.where(e_open | f_open | diag, 0, field).to(torch.int32)
        r = r - (diag | del_step | bdel).to(torch.int32)
        c = c - (diag | ins_step | bins).to(torch.int32)
        codes[s] = code.to(torch.uint8)
    return codes[0::2] * 5 + codes[1::2]


# ----------------------------------------------------------------------
# the kernel


def _check_group(aq, at, params, matrix):
    if aq.dim() != 2 or at.dim() != 2 or aq.shape[1] != at.shape[1]:
        raise ValueError("aq must be [Qp, B] and at [Tp, B]")
    B = aq.shape[1]
    if B < 1 or aq.shape[0] < 1 or at.shape[0] < 1:
        raise ValueError("a group needs at least one lane, row and column")
    for t in (aq, at, matrix, *params):
        if t.dtype != torch.int32:
            raise ValueError("device_fill takes int32 tensors")
        if t.device != aq.device:
            raise ValueError("device_fill's tensors must share one device")
        if not t.is_contiguous():
            raise ValueError("device_fill's tensors must be contiguous")
    if any(p.shape != (B,) for p in params):
        raise ValueError(f"per-lane parameters must be [{B}]")
    if matrix.dim() != 2 or matrix.shape[0] != matrix.shape[1]:
        raise ValueError("matrix must be [A, A]")
    if matrix.shape[0] > kernels.MAX_ALPHABET:
        raise ValueError(f"alphabet above {kernels.MAX_ALPHABET} letters")


def fill_walk(aq, at, qlen, tlen, bottom, top, limit, go, ge, matrix, mode):
    """The fill and walk of one group (see fill_walk_plain for the inputs
    and outputs): the device_fill kernel for CUDA tensors (counted in
    kernels.LAUNCHES["device_fill"]), the plain version for CPU tensors.
    The caller guarantees 1 <= qlen <= Qp, 1 <= tlen <= Tp, letters inside
    the matrix, ge <= go and values within VALUE_BOUND
    (align_winners_device's conditions)."""
    params = (qlen, tlen, bottom, top, limit)
    _check_group(aq, at, params, matrix)
    dev = aq.device
    if dev.type == "cpu":
        return fill_walk_plain(aq, at, qlen, tlen, bottom, top, limit, go,
                               ge, matrix, mode)
    if dev.type != "cuda":
        raise ValueError(f"no device_fill kernel for device {dev}")
    Qp, B = aq.shape
    if Qp % 64:
        raise ValueError("the kernel takes Qp in multiples of 64")
    Tp = at.shape[0]
    steps = steps_for(Qp, Tp)
    plan = plan_fill(Qp, Tp, B, FILL_ROWS)
    i32 = torch.int32
    dirs = torch.empty((B, Tp, Qp), dtype=torch.uint8, device=dev)
    # the int2 rows and int4 summaries that passes hand on; a token
    # allocation when every lane runs one pass (the kernel touches none)
    n = plan["scratch_bytes"] // 24 or 1
    scratch = torch.empty(6 * n, dtype=i32, device=dev)
    out = torch.empty((3, B), dtype=i32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    codes = torch.empty((steps // 2, B), dtype=torch.uint8, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.device_fill_launch(
            aq.data_ptr(), at.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            bottom.data_ptr(), top.data_ptr(), limit.data_ptr(),
            matrix.data_ptr(), scratch[4 * n:].data_ptr(),
            scratch[:4 * n].data_ptr(), dirs.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), ok.data_ptr(),
            codes.data_ptr(), Qp, Tp, B, matrix.shape[0], int(mode),
            int(go), int(ge), plan["rows"],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"device_fill launch failed: CUDA error {err}")
    kernels.LAUNCHES["device_fill"] += 1
    return out[0], out[1], out[2], ok, codes


def _lib():
    """The built device_fill library with its C signature declared."""
    from . import _build

    lib = _build.load("device_fill")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.device_fill_launch.argtypes = [vp] * 16 + [ci] * 8 + [vp]
    lib.device_fill_launch.restype = ci
    return lib


# ----------------------------------------------------------------------
# the host driver


def make_jobs(query, db_list, go, ge, matrix, mode, winners, host):
    """The lanes of `winners` [(index, score, end_q, end_t), ...] that the
    device can fill: (index, score, aq, at, bottom, top) with the reversed
    prefixes. The others are counted in `host` by reason: "no_end" (no end
    location), "no_band" (no closed-form band), "value_bound"."""
    query = np.asarray(query, np.uint8)
    M = int(np.asarray(matrix).max())
    jobs = []
    for i, score, eq, et in winners:
        if eq < 0 or et < 0:
            host["no_end"] += 1
            continue
        aq = query[: eq + 1][::-1]
        at = np.asarray(db_list[i], np.uint8)[: et + 1][::-1]
        try:
            bottom, top = band_borders(score, mode, len(aq), len(at), go, ge,
                                       M)
        except ZeroDivisionError:
            host["no_band"] += 1
            continue
        if not (0 <= bottom < len(aq) and 0 <= top < len(at)):
            host["no_band"] += 1
            continue
        vb = abs(int(score)) + (len(aq) + len(at)) * (abs(M) + go + ge)
        if vb >= VALUE_BOUND:
            host["value_bound"] += 1
            continue
        jobs.append((i, int(score), aq, at, bottom, top))
    return jobs


def plan_groups(jobs, lanes, budget, host):
    """Jobs sorted by (len(aq), len(at)) and cut into groups of at most
    `lanes` lanes whose Tp x Qp x B bits stay within `budget` bytes (Qp and
    Tp padded to 64). A lane whose bits alone pass the budget is counted
    in host["budget"] and left out."""
    jobs = sorted(jobs, key=lambda j: (len(j[2]), len(j[3])))
    groups, cur, qp, tp = [], [], 0, 0
    for j in jobs:
        jq, jt = _round_up(len(j[2]), 64), _round_up(len(j[3]), 64)
        if jq * jt > budget:
            host["budget"] += 1
            continue
        nq, nt = max(qp, jq), max(tp, jt)
        if cur and (len(cur) >= lanes or nq * nt * (len(cur) + 1) > budget):
            groups.append(cur)
            cur, nq, nt = [], jq, jt
        cur.append(j)
        qp, tp = nq, nt
    if cur:
        groups.append(cur)
    return groups


def pack_group(group, device):
    """A group's kernel inputs on `device` (a torch.device): aq [Qp, B],
    at [Tp, B] and qlen, tlen, bottom, top, limit [B], all int32."""
    B = len(group)
    Qp = _round_up(max(len(j[2]) for j in group), 64)
    Tp = _round_up(max(len(j[3]) for j in group), 64)
    aqs = np.zeros((Qp, B), np.int32)
    ats = np.zeros((Tp, B), np.int32)
    par = np.zeros((5, B), np.int32)
    for k, (_, score, aq, at, b, t) in enumerate(group):
        aqs[: len(aq), k] = aq
        ats[: len(at), k] = at
        par[:, k] = (len(aq), len(at), b, t, score)
    host = [torch.from_numpy(a) for a in (aqs, ats, par)]
    if device.type == "cuda":
        # pinned and asynchronous: packing the next group overlaps this
        # group's fill (a pageable copy would wait for the card)
        host = [t.pin_memory() for t in host]
    aqs, ats, par = (t.to(device, non_blocking=True) for t in host)
    return (aqs, ats, *par.unbind(0))


def align_winners_device(query, db_list, go, ge, matrix, mode, winners,
                         lanes=512, device="cuda"):
    """Reconstruct `winners` [(index, score, end_q, end_t), ...] with the
    device fill. Returns {index: (start_q, start_t, ops)} for every winner
    reconstructed on the device and replay-validated; the caller runs the
    host per-pair path for the rest. {} for ge > go and go == ge == 0.
    Every group is dispatched before the first is fetched."""
    from ..traceback import _replay_batch

    dev = resolve_device(device)
    query = np.asarray(query, np.uint8)
    m = np.asarray(matrix, np.int64)
    go, ge = int(go), int(ge)
    host = dict.fromkeys(("no_end", "no_band", "value_bound", "budget",
                          "not_ok", "replay"), 0)
    LAST_STATS.clear()
    LAST_STATS.update(groups=0, shapes=[], device_lanes=0, host_lanes=host)
    if ge > go or (go == 0 and ge == 0):
        return {}
    jobs = make_jobs(query, db_list, go, ge, m, mode, winners, host)
    groups = plan_groups(jobs, lanes, FILL_BUDGET_BYTES, host)
    t0 = time.perf_counter()
    mat = torch.from_numpy(np.ascontiguousarray(m, np.int32)).to(dev)
    pending = []
    for group in groups:
        args = pack_group(group, dev)
        pending.append((group, fill_walk(*args, go, ge, mat, mode)))
        LAST_STATS["shapes"].append((len(group), args[0].shape[0],
                                     args[1].shape[0]))
    t1 = time.perf_counter()
    t_dev = t_replay = 0.0
    out = {}
    for group, outputs in pending:
        t2 = time.perf_counter()
        _, rend_q, rend_t, ok, codes = (t.cpu().numpy() for t in outputs)
        t3 = time.perf_counter()
        t_dev += t3 - t2
        oks = np.flatnonzero(ok)
        host["not_ok"] += len(group) - oks.size
        if oks.size:
            # base-5 unpack and per-lane compaction of every ok lane at
            # once; the walk's emission order is the forward order
            pairs = codes[:, oks].astype(np.int16)
            up = np.empty((pairs.shape[0] * 2, oks.size), np.uint8)
            up[0::2] = pairs // 5
            up[1::2] = pairs % 5
            lanes_ops = np.ascontiguousarray(up.T)
            nz = lanes_ops != 0
            counts = nz.sum(1)
            cat_ops = lanes_ops[nz] - 1
            per_lane = np.split(cat_ops, np.cumsum(counts)[:-1])
            sqs = np.array([len(group[k][2]) - int(rend_q[k]) - 1
                            for k in oks], np.int64)
            sts = np.array([len(group[k][3]) - int(rend_t[k]) - 1
                            for k in oks], np.int64)
            targets = [np.asarray(db_list[group[k][0]], np.uint8)
                       for k in oks]
            got_s, got_rq, got_rt, valid = _replay_batch(
                query, targets, sqs, sts, cat_ops, counts, go, ge, m)
            for j, k in enumerate(oks):
                i, score, aq, at, _, _ = group[k]
                if (valid[j] and got_s[j] == score
                        and got_rq[j] == len(aq) - 1
                        and got_rt[j] == len(at) - 1):
                    out[i] = (int(sqs[j]), int(sts[j]), per_lane[j])
                else:
                    host["replay"] += 1
        t_replay += time.perf_counter() - t3
    LAST_STATS.update(groups=len(groups), device_lanes=len(out),
                      pack_ms=(t1 - t0) * 1e3, dev_ms=t_dev * 1e3,
                      replay_ms=t_replay * 1e3)
    if os.environ.get("OPAL_TPU_DEVICE_FILL_STATS") == "1":
        cells = sum(b * q * t for b, q, t in LAST_STATS["shapes"])
        print(f"[device_fill] groups={len(groups)} "
              f"shapes={LAST_STATS['shapes']} padded_cells={cells/1e6:.1f}M "
              f"pack={(t1 - t0)*1e3:.0f}ms dev={t_dev*1e3:.0f}ms "
              f"replay={t_replay*1e3:.0f}ms device_lanes={len(out)} "
              f"host_lanes={host}", file=sys.stderr, flush=True)
    return out
