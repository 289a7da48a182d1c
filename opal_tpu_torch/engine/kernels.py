"""The DP kernels, their plain PyTorch versions, and their host helpers.

One query is scored against a whole resident database in one pass: every
database sequence is one *lane*, lanes are grouped into length-sorted
blocks (engine/batching.py), and each lane runs the affine-gap (Gotoh)
recurrence over its own columns only. The CUDA kernel
(csrc/ragged_dp.cu, `ragged_dp`) replaces opal_tpu's Pallas kernel
`build_pallas_ragged_fn_raw` / `_kernel_body`
(opal_tpu/engine/pallas_kernels.py:825-924, body :264-728) in all four
modes at score and score+end depth. The CUDA kernel csrc/multi_dp.cu
(`multi_dp`) replaces `build_pallas_multi_fn_raw` / `_kernel_multi`
(:1440-1521, body :1163-1437): up to MULTI_MAX_SEGS queries stacked as
independent row segments, scored in one pass.

`ragged_score` and `multi_score` are the entry points: each launches its
kernel for CUDA tensors and runs its plain version (`ragged_score_plain`,
`multi_score_plain`) for CPU tensors, and raises for anything else. Kernel
and plain version return the same rows, bit for bit; the semantics are
those of opal_tpu's int32 twin (opal_tpu/engine/xla.py).

The kernel's input (`Stream`): block b's letters are the int8 bytes
letters[offsets[b]:offsets[b+1]], laid out [t4, B, 4] with t4 = ceil(t_pad/4):
column t of lane l sits at byte ((t // 4) * B + l) * 4 + t % 4, so one
32-bit load gives a lane four columns and neighbouring lanes read
neighbouring words. Columns at or past a lane's length are never read.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..constants import MODE_HW, MODE_NW, MODE_OV, MODE_SW, SEARCH_SCORE
from .batching import PAD_LETTER

NEG = -(2**30)       # -inf sentinel of the int32 DP (== opal_tpu's NEG)
PAD_NEG = -(2**20)   # profile value of letters outside the alphabet
PROFILE_WIDTH = 32   # profile columns for alphabets up to 31 letters
MAX_ALPHABET = 128   # letters are int8
STRIP_ROWS = 16      # query rows per register strip (== R in the kernels)
MULTI_MAX_SEGS = 8   # queries per multi_dp launch (== MAX_SEGS in multi_dp.cu)
# Scratch cells (one int2 boundary pair per lane and column) per launch;
# larger databases launch in waves of consecutive blocks.
WAVE_CELLS = 32 * 1024 * 1024
MAX_WAVE_BLOCKS = 65535  # CUDA grid.y limit

# Launches of each kernel and calls of each plain version; the counts
# let a run show which path it took.
LAUNCHES = {"ragged_dp": 0, "multi_dp": 0}
PLAIN_CALLS = {"ragged_score_plain": 0, "multi_score_plain": 0}

# tracker row ids (opal_tpu's TR_* numbering, kept for reading across)
TR_BEST = 0      # SW best score / HW-OV last-row running max / OV score
TR_BEST_R = 1    # SW / OV end_q
TR_BEST_C = 2    # SW end_t / HW-OV first-improvement column / OV end_t
TR_NW = 3        # NW score, H[Q-1][len-1]


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def tracker_rows(mode, search_type):
    """Tracker rows a config emits, in output order."""
    track_end = search_type != SEARCH_SCORE
    if mode == MODE_SW or mode == MODE_OV:
        return (TR_BEST,) + ((TR_BEST_R, TR_BEST_C) if track_end else ())
    if mode == MODE_NW:
        return (TR_NW,)
    return (TR_BEST,) + ((TR_BEST_C,) if track_end else ())


def finalize_device(tr: torch.Tensor, lengths: torch.Tensor, mode,
                    search_type, Q):
    """Tracker rows [NB, n_rows, B] (see tracker_rows) -> (score, end_q,
    end_t) [NB, B] int32 on tr's device, for every block at once; end_q and
    end_t are None at score depth. NW ends are (Q-1, len-1), HW's end_q is
    Q-1."""
    row = {r: tr[:, j] for j, r in enumerate(tracker_rows(mode, search_type))}
    score = row[TR_NW if mode == MODE_NW else TR_BEST]
    if search_type == SEARCH_SCORE:
        return score, None, None
    if mode in (MODE_NW, MODE_HW):
        end_q = torch.full_like(score, Q - 1)
    else:
        end_q = row[TR_BEST_R]
    end_t = lengths - 1 if mode == MODE_NW else row[TR_BEST_C]
    return score, end_q, end_t


def build_profile(qprofile: np.ndarray) -> np.ndarray:
    """Query profile [Q, W] int32 from qprofile [A, Q] (= matrix[query].T):
    profile[r, a] = matrix[query[r], a]; W = max(32, A), and the columns
    from A on (PAD_LETTER's among them) hold PAD_NEG."""
    A, Q = qprofile.shape
    if A > MAX_ALPHABET:
        raise ValueError(f"alphabet of {A} letters; int8 letters allow "
                         f"{MAX_ALPHABET}")
    prof = np.full((Q, max(PROFILE_WIDTH, A)), PAD_NEG, np.int32)
    prof[:, :A] = np.asarray(qprofile, np.int32).T
    return prof


def segment_rows(Q: int) -> int:
    """Rows a query of Q residues takes in a stacked profile: Q rounded up
    to whole strips (opal_tpu's 16-quantized segment heights)."""
    return -(-max(Q, 1) // STRIP_ROWS) * STRIP_ROWS


def prepare_profile_multi(qprofiles):
    """Stack query profiles (qprofile [A, Q_s] each) into multi_dp's
    operand: [sum segment_rows(Q_s), W] int32, each segment padded with
    PAD_NEG rows so that no strip spans two segments (the counterpart of
    opal_tpu's prepare_qp_multi, pallas_kernels.py:1524-1545). Returns
    (profile, seg_qs)."""
    if not 1 <= len(qprofiles) <= MULTI_MAX_SEGS:
        raise ValueError(f"{len(qprofiles)} queries; a stacked launch takes "
                         f"1..{MULTI_MAX_SEGS}")
    profs = [build_profile(qp) for qp in qprofiles]
    W = max(p.shape[1] for p in profs)
    seg_qs = tuple(p.shape[0] for p in profs)
    if min(seg_qs) < 1:
        raise ValueError("empty query")
    out = np.full((sum(segment_rows(q) for q in seg_qs), W), PAD_NEG,
                  np.int32)
    off = 0
    for p in profs:
        out[off:off + p.shape[0], :p.shape[1]] = p
        off += segment_rows(p.shape[0])
    return out, seg_qs


def profile_from_jax_qp(qp, Q: int, ge: int) -> np.ndarray:
    """opal_tpu's kernel operand (pallas_kernels.prepare_qp: [Q_pad, 32]
    holding P + Ge, PAD_NEG in padding) -> this port's int32 profile."""
    qp = np.asarray(qp, np.float32)[:Q]
    return np.where(qp == PAD_NEG, PAD_NEG, qp - ge).astype(np.int32)


@dataclasses.dataclass
class Stream:
    """The whole database as the kernel reads it (see module docstring)."""
    letters: torch.Tensor      # int8 [offsets[-1]]
    offsets: torch.Tensor      # int64 [NB + 1] byte offset of each block
    lengths: torch.Tensor      # int32 [NB, B]
    host_offsets: np.ndarray   # the same offsets, for planning launches


def pack_stream(block_letters, block_lengths, B: int, device) -> Stream:
    """Lay out blocks ([t_pad, B] int8 letters, [B] int32 lengths each)
    in the kernel's layout and upload them to `device` once."""
    parts = []
    for lett in block_letters:
        lett = np.asarray(lett, np.int8)
        t_pad = lett.shape[0]
        t4 = -(-t_pad // 4)
        if t4 * 4 != t_pad:
            lett = np.concatenate([
                lett, np.full((t4 * 4 - t_pad, B), PAD_LETTER, np.int8)])
        parts.append(lett.reshape(t4, 4, B).transpose(0, 2, 1).ravel())
    offsets = np.zeros(len(parts) + 1, np.int64)
    offsets[1:] = np.cumsum([p.size for p in parts])
    letters = (np.concatenate(parts) if parts else np.zeros(0, np.int8))
    lengths = np.asarray(block_lengths, np.int32).reshape(len(parts), B)
    return Stream(
        letters=torch.from_numpy(letters).to(device),
        offsets=torch.from_numpy(offsets).to(device),
        lengths=torch.from_numpy(lengths).to(device),
        host_offsets=offsets,
    )


def _check_inputs(profile: torch.Tensor, stream: Stream):
    dev = stream.letters.device
    for name, t in (("profile", profile), ("offsets", stream.offsets),
                    ("lengths", stream.lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, letters on {dev}")
    if profile.dtype != torch.int32 or profile.dim() != 2:
        raise ValueError("profile must be a [Q, W] int32 tensor")
    if not PROFILE_WIDTH <= profile.shape[1] <= MAX_ALPHABET:
        raise ValueError(f"profile width {profile.shape[1]} outside "
                         f"[{PROFILE_WIDTH}, {MAX_ALPHABET}]")
    if profile.shape[0] < 1:
        raise ValueError("empty query")
    if (stream.letters.dtype != torch.int8
            or stream.lengths.dtype != torch.int32
            or stream.offsets.dtype != torch.int64):
        raise ValueError("stream dtypes must be int8 / int32 / int64")
    if not all(t.is_contiguous() for t in (stream.letters, stream.offsets,
                                           stream.lengths)):
        raise ValueError("stream tensors must be contiguous")


def ragged_score(profile: torch.Tensor, stream: Stream, mode: int,
                 search_type: int, go: int, ge: int) -> torch.Tensor:
    """Score one query (profile [Q, W] int32) against every lane of the
    stream. Returns the tracker rows [NB, len(tracker_rows), B] int32 on
    the stream's device (see finalize_device)."""
    _check_inputs(profile, stream)
    dev = stream.letters.device
    if dev.type == "cpu":
        return ragged_score_plain(profile, stream, mode, search_type, go, ge)
    if dev.type != "cuda":
        raise ValueError(f"no ragged_dp kernel for device {dev}")
    profile = profile.contiguous()
    NB, B = stream.lengths.shape
    Q, W = profile.shape
    rows = len(tracker_rows(mode, search_type))
    out = torch.empty((NB, rows, B), dtype=torch.int32, device=dev)
    if NB == 0:
        return out
    lib = _lib("ragged_dp")

    def launch(scratch, first, n, cu_stream):
        return lib.ragged_dp_launch(
            profile.data_ptr(), stream.letters.data_ptr(),
            stream.offsets.data_ptr(), stream.lengths.data_ptr(),
            scratch, out.data_ptr(), first, n, B, Q, W, int(mode),
            int(search_type != SEARCH_SCORE), int(go), int(ge), cu_stream)

    _launch_waves("ragged_dp", launch, stream, Q > STRIP_ROWS)
    return out


def multi_score(profile: torch.Tensor, seg_qs, stream: Stream, mode: int,
                search_type: int, go: int, ge: int) -> torch.Tensor:
    """Score len(seg_qs) stacked queries (profile from
    prepare_profile_multi) against every lane of the stream in one pass.
    Returns [NB, n_seg * (3 if score+end else 1), B] int32 on the stream's
    device: rows [scores | end_qs | end_ts], final values (segment s equals
    finalize_device of ragged_score on query s alone)."""
    seg_qs = _check_segments(profile, seg_qs, stream)
    dev = stream.letters.device
    if dev.type == "cpu":
        return multi_score_plain(profile, seg_qs, stream, mode, search_type,
                                 go, ge)
    if dev.type != "cuda":
        raise ValueError(f"no multi_dp kernel for device {dev}")
    profile = profile.contiguous()
    NB, B = stream.lengths.shape
    n_seg = len(seg_qs)
    track_end = search_type != SEARCH_SCORE
    out = torch.empty((NB, n_seg * (3 if track_end else 1), B),
                      dtype=torch.int32, device=dev)
    if NB == 0:
        return out
    lib = _lib("multi_dp")
    c_qs = (ctypes.c_int * n_seg)(*seg_qs)

    def launch(scratch, first, n, cu_stream):
        return lib.multi_dp_launch(
            profile.data_ptr(), stream.letters.data_ptr(),
            stream.offsets.data_ptr(), stream.lengths.data_ptr(),
            scratch, out.data_ptr(), first, n, B, profile.shape[1], n_seg,
            c_qs, int(mode), int(track_end), int(go), int(ge), cu_stream)

    _launch_waves("multi_dp", launch, stream, max(seg_qs) > STRIP_ROWS)
    return out


def _check_segments(profile: torch.Tensor, seg_qs, stream: Stream):
    _check_inputs(profile, stream)
    seg_qs = tuple(int(q) for q in seg_qs)
    if not 1 <= len(seg_qs) <= MULTI_MAX_SEGS or min(seg_qs) < 1:
        raise ValueError(f"segments {seg_qs}: 1..{MULTI_MAX_SEGS} queries "
                         "of at least one residue")
    if profile.shape[0] != sum(segment_rows(q) for q in seg_qs):
        raise ValueError(f"profile of {profile.shape[0]} rows for segments "
                         f"{seg_qs}")
    return seg_qs


def _launch_waves(name, launch, stream: Stream, tall: bool):
    """Run launch(scratch_ptr, first_block, n_blocks, cu_stream) once per
    wave of blocks, with one boundary scratch sized for the largest wave
    (None when no strip hands rows to another, i.e. `tall` is false)."""
    dev = stream.letters.device
    waves = plan_waves(stream.host_offsets)
    scratch = None
    if tall:  # boundary rows pass between strips through scratch
        cells = max(int(stream.host_offsets[f + n] - stream.host_offsets[f])
                    for f, n in waves)
        scratch = torch.empty(2 * cells, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        cu_stream = torch.cuda.current_stream(dev).cuda_stream
        for first, n in waves:
            err = launch(None if scratch is None else scratch.data_ptr(),
                         first, n, cu_stream)
            if err:
                raise RuntimeError(f"{name} launch failed: CUDA error {err}")
            LAUNCHES[name] += 1


def plan_waves(host_offsets: np.ndarray):
    """[(first_block, n_blocks)] of consecutive blocks whose scratch fits
    WAVE_CELLS (a block larger than that runs alone)."""
    NB = len(host_offsets) - 1
    waves, first = [], 0
    while first < NB:
        n = 1
        while (first + n < NB and n < MAX_WAVE_BLOCKS
               and host_offsets[first + n + 1] - host_offsets[first]
               <= WAVE_CELLS):
            n += 1
        waves.append((first, n))
        first += n
    return waves


def _lib(name):
    """The built library of kernel `name`, with its C signature declared."""
    from . import _build

    lib = _build.load(name)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "ragged_dp":
        args = [vp] * 6 + [ci] * 9 + [vp]
    else:  # multi_dp: ..., n_seg, seg_q, mode, track_end, go, ge, stream
        args = [vp] * 6 + [ci] * 5 + [ctypes.POINTER(ci)] + [ci] * 4 + [vp]
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = args
    fn.restype = ci
    return lib


# ----------------------------------------------------------------------
# plain version


def _decode_letters(stream: Stream, T: int) -> torch.Tensor:
    """[T, NB * B] int64 letters (columns past a block's t_pad hold 0)."""
    NB, B = stream.lengths.shape
    dev = stream.letters.device
    out = torch.zeros((T, NB, B), dtype=torch.int64, device=dev)
    offs = stream.host_offsets
    for b in range(NB):
        t4 = int(offs[b + 1] - offs[b]) // (4 * B)
        blk = stream.letters[int(offs[b]):int(offs[b + 1])].view(t4, B, 4)
        blk = blk.permute(0, 2, 1).reshape(t4 * 4, B)
        n = min(T, t4 * 4)
        out[:n, b] = blk[:n].to(torch.int64)
    return out.reshape(T, NB * B)


def _column_prefix(H, E, P, ul0, uH0, uF0, go, ge, ramp, sw):
    """One column for all lanes, F chain as a max-plus prefix (exact for
    ge <= go; opal_tpu/engine/xla.py::_column_update)."""
    E = torch.maximum(H - go, E - ge)
    ulH = torch.cat([torch.full_like(H[:, :1], ul0), H[:, :-1]], dim=1)
    Hp = torch.maximum(E, ulH + P)
    if sw:
        Hp = Hp.clamp_min(0)
    c0 = max(uH0 - go, uF0 - ge)
    C = torch.cat([torch.full_like(Hp[:, :1], c0), Hp[:, :-1] - go], dim=1)
    F = torch.cummax(C + ramp, dim=1).values - ramp
    return torch.maximum(Hp, F), E


def _column_seq(H, E, P, ul0, uH0, uF0, go, ge, sw):
    """One column for all lanes, F chain row by row (exact for any gaps;
    opal_tpu/engine/xla.py::_column_update_seq)."""
    L, Q = H.shape
    E = torch.maximum(H - go, E - ge)
    uH = torch.full((L,), uH0, dtype=H.dtype, device=H.device)
    uF = torch.full_like(uH, uF0)
    ul = torch.full_like(uH, ul0)
    cols = []
    for r in range(Q):
        F = torch.maximum(uH - go, uF - ge)
        h = torch.maximum(torch.maximum(E[:, r], F), ul + P[:, r])
        if sw:
            h = h.clamp_min(0)
        cols.append(h)
        ul, uH, uF = H[:, r], h, F
    return torch.stack(cols, dim=1), E


def ragged_score_plain(profile: torch.Tensor, stream: Stream, mode: int,
                       search_type: int, go: int, ge: int) -> torch.Tensor:
    """The function `ragged_dp` computes, in plain PyTorch int32: lanes
    vectorised, a Python loop over columns (the semantics of
    opal_tpu/engine/xla.py::build_score_fn)."""
    _check_inputs(profile, stream)
    PLAIN_CALLS["ragged_score_plain"] += 1
    NB, B = stream.lengths.shape
    Q = profile.shape[0]
    dev = profile.device
    i32 = torch.int32
    sw = mode == MODE_SW
    track_end = search_type != SEARCH_SCORE
    lens = stream.lengths.reshape(-1)
    L = NB * B
    T = int(lens.max()) if L else 0
    letters = _decode_letters(stream, T)
    prof_t = profile.t().contiguous()  # [W, Q]
    rows = torch.arange(Q, dtype=i32, device=dev)
    ramp = (rows * ge)[None, :]

    if sw or mode == MODE_OV:
        H = torch.zeros((L, Q), dtype=i32, device=dev)
    else:
        H = (-go - rows * ge)[None, :].expand(L, Q).clone()
    E = torch.full((L, Q), 0 if sw else NEG, dtype=i32, device=dev)
    zeros = torch.zeros(L, dtype=i32, device=dev)
    negs = torch.full((L,), NEG, dtype=i32, device=dev)
    best, best_r, best_c = zeros.clone(), zeros.clone(), zeros.clone()
    lr, lr_c, plrm = negs.clone(), zeros.clone(), negs.clone()
    ocm, orow, nw = negs.clone(), zeros.clone(), negs.clone()

    for t in range(T):
        P = prof_t[letters[t]]  # [L, Q]
        if mode == MODE_NW:
            uH0 = -go - t * ge
            ul0 = 0 if t == 0 else uH0 + ge
        else:
            uH0 = ul0 = 0
        uF0 = 0 if sw else NEG
        if ge <= go:
            H, E = _column_prefix(H, E, P, ul0, uH0, uF0, go, ge, ramp, sw)
        else:
            H, E = _column_seq(H, E, P, ul0, uH0, uF0, go, ge, sw)
        valid = t < lens
        if sw:
            colmax, argrow = torch.max(H, dim=1)
            improved = valid & (colmax > best)
            best = torch.where(improved, colmax, best)
            if track_end:
                best_r = torch.where(improved, argrow.to(i32), best_r)
                best_c = torch.where(improved, torch.full_like(best_c, t),
                                     best_c)
            continue
        is_end = t == lens - 1
        lastrow = H[:, Q - 1]
        if mode == MODE_NW:
            nw = torch.where(is_end, lastrow, nw)
            continue
        if mode == MODE_OV:
            plrm = torch.where(is_end, lr, plrm)
            colmax, argrow = torch.max(H, dim=1)
            ocm = torch.where(is_end, colmax, ocm)
            orow = torch.where(is_end, argrow.to(i32), orow)
        improved = valid & (lastrow > lr)
        lr = torch.where(improved, lastrow, lr)
        lr_c = torch.where(improved, torch.full_like(lr_c, t), lr_c)

    if sw:
        outs = [best] + ([best_r, best_c] if track_end else [])
    elif mode == MODE_NW:
        outs = [nw]
    elif mode == MODE_HW:
        outs = [lr] + ([lr_c] if track_end else [])
    else:  # OV: the end is in the last column iff its max beats the
        # last-row max of the earlier columns (opal_tpu/engine/xla.py:238-249)
        outs = [torch.maximum(ocm, lr)]
        if track_end:
            in_last = ocm > plrm
            outs += [torch.where(in_last, orow, torch.full_like(orow, Q - 1)),
                     torch.where(in_last, lens - 1, lr_c)]
    return torch.stack(outs, dim=0).reshape(len(outs), NB, B).transpose(
        0, 1).contiguous()


def multi_score_plain(profile: torch.Tensor, seg_qs, stream: Stream,
                      mode: int, search_type: int, go: int,
                      ge: int) -> torch.Tensor:
    """The function `multi_dp` computes, in plain PyTorch int32: each
    segment through ragged_score_plain on its own query, then finalized to
    multi_dp's final-value rows [scores | end_qs | end_ts]."""
    seg_qs = _check_segments(profile, seg_qs, stream)
    PLAIN_CALLS["multi_score_plain"] += 1
    cols = ([], [], [])
    off = 0
    for Q in seg_qs:
        tr = ragged_score_plain(profile[off:off + Q], stream, mode,
                                search_type, go, ge)
        for c, v in zip(cols, finalize_device(tr, stream.lengths, mode,
                                              search_type, Q)):
            if v is not None:
                c.append(v)
        off += segment_rows(Q)
    return torch.stack(cols[0] + cols[1] + cols[2], dim=1)
