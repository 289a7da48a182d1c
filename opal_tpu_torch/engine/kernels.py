"""The DP kernels, their plain PyTorch versions, and their host helpers.

One query is scored against a whole resident database in one pass: every
database sequence is one *lane*, lanes are grouped into length-sorted
blocks (engine/batching.py), and each lane runs the affine-gap (Gotoh)
recurrence over its own columns only. The CUDA kernel
(csrc/ragged_dp.cu, `ragged_dp`) replaces opal_tpu's Pallas kernel
`build_pallas_ragged_fn_raw` / `_kernel_body`
(opal_tpu/engine/pallas_kernels.py:825-924, body :264-728) in all four
modes at score and score+end depth, with or without the overflow-flag rows
that the adaptive cascade reads (with_flags, :525-549). The CUDA kernel csrc/multi_dp.cu
(`multi_dp`) replaces `build_pallas_multi_fn_raw` / `_kernel_multi`
(:1440-1521, body :1163-1437): up to MULTI_MAX_SEGS queries stacked as
independent row segments, scored in one pass.

Long queries run in query panels (`ragged_panel_score`, the panel role of
ragged_dp): a query taller than PANEL_ROWS is cut into panels of
PANEL_ROWS rows (`plan_panels`), each launch covers one panel over the
launch plan's blocks, and a panel hands its last row to the next through
scratch. This replaces opal_tpu's `build_pallas_panel_fn_raw`
(:959-1082); `finalize_panels_device` is its host merge
`finalize_trackers_panels` (:1091-1160), here on the card. `grouped_score`
is the counterpart of `build_pallas_score_fn_raw` (:732-821): one query
against G dense [T, B] blocks, laid out as a stream and scored by ragged_dp.

Both kernels walk a lane's query strips with a group of G threads
(csrc/strip_group.cuh); `plan_launch` picks G per block and lays the whole
database out as one launch, longest block first (see its docstring).

`ragged_score`, `ragged_panel_score`, `multi_score` and `grouped_score` are
the entry points: each launches its kernel for CUDA tensors and runs its
plain version (`ragged_score_plain`, `ragged_panel_plain`,
`multi_score_plain`, `grouped_score_plain`) for CPU tensors, and raises for
anything else. Kernel and plain version return the same rows, bit for bit;
the semantics are those of opal_tpu's int32 twin (opal_tpu/engine/xla.py).

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
# The launch plan (plan_launch). Scratch cells (one int2 boundary pair per
# lane and column) one launch may use: 2 GiB; a database whose hand-offs
# need more launches in several waves.
SCRATCH_CELLS = 256 * 1024 * 1024
MAX_GROUP = 8         # threads per lane group, at most (== MAX_G)
THREADS = 128         # threads per CUDA block (== THREADS in the kernels)
# Threads the card keeps resident per SM, for the plan's balance: 8 CUDA
# blocks of 128 at up to 64 registers (an estimate; it sizes G only).
RESIDENT_THREADS_PER_SM = 1024
# Query rows per panel (a multiple of STRIP_ROWS): a query taller than this
# runs in panels (engine/backend.py), each launch covering PANEL_ROWS rows
# of the whole database. 1,024, 4,096, 16,384 rows and one sweep ran a
# 100,000-residue search within 0.5 % of each other on an H100 (PERF.md);
# this is the smallest of them. The environment knobs OPAL_TPU_PANEL_ROWS,
# OPAL_TPU_FORCE_PANELS and OPAL_TPU_NO_PANELS change the height and the
# route at dispatch (backend.panel_plan); this stays the threshold.
PANEL_ROWS = 1024

# Launches of each kernel and calls of each plain version; the counts
# let a run show which path it took.
LAUNCHES = {"ragged_dp": 0, "ragged_dp_flags": 0, "multi_dp": 0,
            "ragged_dp_panel": 0, "ragged_dp_grouped": 0, "device_fill": 0}
PLAIN_CALLS = {"ragged_score_plain": 0, "multi_score_plain": 0,
               "ragged_panel_plain": 0, "fill_walk_plain": 0}

# tracker row ids (opal_tpu's TR_* numbering, kept for reading across)
TR_BEST = 0      # SW best score / HW-OV last-row running max / OV score
TR_BEST_R = 1    # SW / OV end_q
TR_BEST_C = 2    # SW end_t / HW-OV first-improvement column / OV end_t
TR_NW = 3        # NW score, H[Q-1][len-1]
TR_OV_PLRM = 4   # OV last-row max before the last column (panels)
TR_OV_CMAX = 5   # OV last-column max (panels)
TR_OV_ROW = 6    # OV first row of the last-column max (panels)
TR_ULHP = 7      # SW overflow flag: running max of ulH + P
TR_MIN_E = 8     # NW/HW/OV overflow flags: running min of E,
TR_MIN_F = 9     # running min of F
TR_MAX_H = 10    # and running max of H
# flag rows' result columns (engine/cascade.py reads them)
FLAG_COLUMNS = {TR_ULHP: "max_ulhp", TR_MIN_E: "min_e", TR_MIN_F: "min_f",
                TR_MAX_H: "max_h"}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def tracker_rows(mode, search_type, with_flags=False):
    """Tracker rows a config emits, in output order: the score rows, then
    the flag rows (opal_tpu's order, pallas_kernels.py:210-228)."""
    track_end = search_type != SEARCH_SCORE
    if mode == MODE_SW or mode == MODE_OV:
        rows = (TR_BEST,) + ((TR_BEST_R, TR_BEST_C) if track_end else ())
    elif mode == MODE_NW:
        rows = (TR_NW,)
    else:
        rows = (TR_BEST,) + ((TR_BEST_C,) if track_end else ())
    if with_flags:
        rows += ((TR_ULHP,) if mode == MODE_SW
                 else (TR_MIN_E, TR_MIN_F, TR_MAX_H))
    return rows


def finalize_device(tr: torch.Tensor, lengths: torch.Tensor, mode,
                    search_type, Q, with_flags=False):
    """Tracker rows [NB, n_rows, B] (see tracker_rows) -> {column: [NB, B]
    int32} on tr's device, for every block at once: "score", at score+end
    depth "end_q" and "end_t", and with_flags the flag rows passed through
    as "max_ulhp" (SW) or "min_e", "min_f", "max_h". NW ends are (Q-1,
    len-1), HW's end_q is Q-1."""
    row = {r: tr[:, j] for j, r in
           enumerate(tracker_rows(mode, search_type, with_flags))}
    cols = {"score": row[TR_NW if mode == MODE_NW else TR_BEST]}
    if search_type != SEARCH_SCORE:
        if mode in (MODE_NW, MODE_HW):
            cols["end_q"] = torch.full_like(cols["score"], Q - 1)
        else:
            cols["end_q"] = row[TR_BEST_R]
        cols["end_t"] = lengths - 1 if mode == MODE_NW else row[TR_BEST_C]
    for r, name in FLAG_COLUMNS.items():
        if r in row:
            cols[name] = row[r]
    return cols


def panel_tracker_rows(mode, search_type, with_flags, final):
    """Tracker rows one query panel emits, in output order (a copy of
    opal_tpu's panel_tracker_rows, pallas_kernels.py:933-955). Interior
    panels emit only what the merge needs (SW records, OV last-column
    stats, flags); the final panel adds the last-row trackers. End rows
    (TR_BEST_R, TR_OV_ROW) are local to the panel. A panel with nothing to
    emit gets one filler row (NEG), which the merge never reads."""
    track_end = search_type != SEARCH_SCORE
    if mode == MODE_SW:
        rows = [TR_BEST] + ([TR_BEST_R, TR_BEST_C] if track_end else [])
    elif mode == MODE_NW:
        rows = [TR_NW] if final else []
    elif mode == MODE_HW:
        rows = ([TR_BEST] + ([TR_BEST_C] if track_end else [])
                if final else [])
    else:  # OV: per-panel last-column stats + final-panel last-row rows
        if track_end:
            rows = ([TR_BEST, TR_BEST_C, TR_OV_PLRM] if final else [])
            rows += [TR_OV_CMAX, TR_OV_ROW]
        else:
            rows = ([TR_BEST] if final else []) + [TR_OV_CMAX]
    if with_flags:
        rows += [TR_ULHP] if mode == MODE_SW else [
            TR_MIN_E, TR_MIN_F, TR_MAX_H]
    return tuple(rows) if rows else (TR_BEST,)


def plan_panels(Q: int, rows: int | None = None):
    """((row0, rows), ...) of a Q-row query cut into panels of `rows` rows
    (PANEL_ROWS by default), the last one shorter (opal_tpu's split,
    pallas_backend.py:286-300)."""
    P = PANEL_ROWS if rows is None else rows
    if P < STRIP_ROWS or P % STRIP_ROWS:
        raise ValueError(f"PANEL_ROWS={P}: panels are whole strips of "
                         f"{STRIP_ROWS} rows")
    if Q < 1:
        raise ValueError("empty query")
    return tuple((r0, min(P, Q - r0)) for r0 in range(0, Q, P))


def _check_panels(panels, Q):
    """panels as ints, if they cut Q rows into consecutive panels of whole
    strips (the last one excepted); else ValueError."""
    panels = tuple((int(r0), int(n)) for r0, n in panels)
    ends = [r0 + n for r0, n in panels]
    if not (panels and [r0 for r0, _ in panels] == [0] + ends[:-1]
            and ends[-1] == Q and min(n for _, n in panels) >= 1
            and all(n % STRIP_ROWS == 0 for _, n in panels[:-1])):
        raise ValueError(f"panels {panels} do not cut {Q} rows into whole "
                         f"strips of {STRIP_ROWS} rows")
    return panels


def finalize_panels_device(trs, panels, lengths: torch.Tensor, mode,
                           search_type, with_flags=False):
    """Merge per-panel tracker rows ([NB, n_rows_p, B] each, rows per
    panel_tracker_rows) on their device into finalize_device's columns
    (opal_tpu's finalize_trackers_panels, pallas_kernels.py:1091-1160, in
    torch ops): SW best over the panels, its end at the smallest end_t,
    then the smallest global end_q; OV score and end from the merged
    last-column max and the final panel's last-row rows; flags by min/max."""
    n_p = len(trs)
    Q = panels[-1][0] + panels[-1][1]
    track_end = search_type != SEARCH_SCORE
    big = torch.iinfo(torch.int32).max
    maps = [{r: trs[p][:, j] for j, r in enumerate(panel_tracker_rows(
        mode, search_type, with_flags, p == n_p - 1))} for p in range(n_p)]
    last = maps[-1]

    def stack(r, add_offset=False):
        return torch.stack([m[r] + (panels[p][0] if add_offset else 0)
                            for p, m in enumerate(maps)])

    cols = {}
    if mode == MODE_SW:
        bests = stack(TR_BEST)
        cols["score"] = bests.amax(dim=0)
        if track_end:
            end_ts = stack(TR_BEST_C)
            att = bests == cols["score"]
            end_t = torch.where(att, end_ts, big).amin(dim=0)
            cols["end_q"] = torch.where(att & (end_ts == end_t),
                                        stack(TR_BEST_R, True),
                                        big).amin(dim=0)
            cols["end_t"] = end_t
    elif mode in (MODE_NW, MODE_HW):
        cols["score"] = last[TR_NW if mode == MODE_NW else TR_BEST]
        if track_end:
            cols["end_q"] = torch.full_like(cols["score"], Q - 1)
            cols["end_t"] = (lengths - 1 if mode == MODE_NW
                             else last[TR_BEST_C])
    else:  # OV
        cmaxs = stack(TR_OV_CMAX)
        colmax = cmaxs.amax(dim=0)
        cols["score"] = torch.maximum(colmax, last[TR_BEST])
        if track_end:
            ovrow = torch.where(cmaxs == colmax, stack(TR_OV_ROW, True),
                                big).amin(dim=0)
            in_last = colmax > last[TR_OV_PLRM]
            cols["end_q"] = torch.where(in_last, ovrow, Q - 1)
            cols["end_t"] = torch.where(in_last, lengths - 1,
                                        last[TR_BEST_C])
    if with_flags:
        if mode == MODE_SW:
            cols["max_ulhp"] = stack(TR_ULHP).amax(dim=0)
        else:
            cols["min_e"] = stack(TR_MIN_E).amin(dim=0)
            cols["min_f"] = stack(TR_MIN_F).amin(dim=0)
            cols["max_h"] = stack(TR_MAX_H).amax(dim=0)
    return cols


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
                 search_type: int, go: int, ge: int,
                 with_flags: bool = False, events=None,
                 G: int | None = None) -> torch.Tensor:
    """Score one query (profile [Q, W] int32) against every lane of the
    stream. Returns the tracker rows [NB, len(tracker_rows), B] int32 on
    the stream's device (see finalize_device); with_flags adds the
    overflow-flag rows (counted in LAUNCHES["ragged_dp_flags"]). `events`,
    a list, receives (wave, 0, start, end) CUDA events around each
    launch. G sets every block's threads per lane (1, 2, 4 or 8) in place
    of the plan's (plan_groups; the probe tools.exp_unroll sweeps it)."""
    _check_inputs(profile, stream)
    dev = stream.letters.device
    if dev.type == "cpu":
        return ragged_score_plain(profile, stream, mode, search_type, go, ge,
                                  with_flags)
    if dev.type != "cuda":
        raise ValueError(f"no ragged_dp kernel for device {dev}")
    return _ragged_launch(profile, stream, mode, search_type, go, ge,
                          with_flags,
                          "ragged_dp_flags" if with_flags else "ragged_dp",
                          events, G)


def _ragged_launch(profile, stream, mode, search_type, go, ge, with_flags,
                   name, events=None, G=None):
    """ragged_dp over the whole stream as its launch plan lays it out, counted
    in LAUNCHES[name]."""
    dev = stream.letters.device
    profile = profile.contiguous()
    NB, B = stream.lengths.shape
    Q, W = profile.shape
    rows = len(tracker_rows(mode, search_type, with_flags))
    out = torch.empty((NB, rows, B), dtype=torch.int32, device=dev)
    if NB == 0:
        return out
    lib = _lib("ragged_dp")

    def launch(w, scratch, cu_stream, _step):
        return lib.ragged_dp_launch(
            profile.data_ptr(), stream.letters.data_ptr(),
            stream.offsets.data_ptr(), stream.lengths.data_ptr(),
            *w, scratch, out.data_ptr(), w.n_jobs, w.max_g, B, Q, 0, Q, W,
            int(mode), int(search_type != SEARCH_SCORE),
            int(bool(with_flags)), 0, int(go), int(ge), cu_stream)

    _run_plan(name, launch, stream, -(-Q // STRIP_ROWS), False,
              events=events, G=G)
    return out


def ragged_panel_score(profile: torch.Tensor, stream: Stream, mode: int,
                       search_type: int, go: int, ge: int,
                       with_flags: bool = False, panels=None,
                       events=None) -> list:
    """Score one query (profile [Q, W] int32) in query panels: panels
    ((row0, rows), ...), plan_panels(Q) by default. Returns one tracker-row
    tensor [NB, len(panel_tracker_rows(.., final)), B] int32 per panel, on
    the stream's device (merge them with finalize_panels_device). On the
    card, the panels run in order over the launch plan's blocks (every
    wave of them, where its scratch forces several), one launch each
    (counted in LAUNCHES["ragged_dp_panel"]), and hand rows to each other
    through scratch. `events`, a list, receives (wave, panel, start, end)
    CUDA events around each launch."""
    _check_inputs(profile, stream)
    Q = profile.shape[0]
    panels = plan_panels(Q) if panels is None else _check_panels(panels, Q)
    dev = stream.letters.device
    if dev.type == "cpu":
        outs, top = [], None
        for row0, rows in panels:
            tr, top = ragged_panel_plain(profile, stream, mode, search_type,
                                         go, ge, with_flags, row0, rows, top)
            outs.append(tr)
        return outs
    if dev.type != "cuda":
        raise ValueError(f"no ragged_dp kernel for device {dev}")
    profile = profile.contiguous()
    NB, B = stream.lengths.shape
    W = profile.shape[1]
    outs = [torch.empty((NB, len(panel_tracker_rows(
        mode, search_type, with_flags, r0 + n == Q)), B), dtype=torch.int32,
        device=dev) for r0, n in panels]
    if NB == 0:
        return outs
    lib = _lib("ragged_dp")

    def launch(w, scratch, cu_stream, p):
        row0, rows = panels[p]
        return lib.ragged_dp_launch(
            profile.data_ptr(), stream.letters.data_ptr(),
            stream.offsets.data_ptr(), stream.lengths.data_ptr(),
            *w, scratch, outs[p].data_ptr(), w.n_jobs, w.max_g, B, Q, row0,
            rows, W, int(mode), int(search_type != SEARCH_SCORE),
            int(bool(with_flags)), 1, int(go), int(ge), cu_stream)

    _run_plan("ragged_dp_panel", launch, stream,
              max(-(-n // STRIP_ROWS) for _, n in panels), len(panels) > 1,
              len(panels), events)
    return outs


def grouped_stream(letters: torch.Tensor, lengths: torch.Tensor) -> Stream:
    """Dense blocks (letters [G, T, B] int8, lengths [G, B] int32, on one
    device) laid out on that device as the kernel's Stream: T padded to
    T_pad = 4 * ceil(T / 4) with PAD_LETTER, each block [t4, B, 4] at byte
    offset g * T_pad * B."""
    if letters.dtype != torch.int8 or letters.dim() != 3:
        raise ValueError("letters must be a [G, T, B] int8 tensor")
    G, T, B = letters.shape
    if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (G, B)
            or lengths.device != letters.device):
        raise ValueError(f"lengths must be a [{G}, {B}] int32 tensor on "
                         f"{letters.device}")
    if lengths.numel() and not 0 <= int(lengths.min()) <= int(
            lengths.max()) <= T:
        raise ValueError(f"lengths outside [0, {T}]")
    t4 = -(-T // 4)
    if t4 * 4 != T:
        letters = torch.cat([letters, torch.full(
            (G, t4 * 4 - T, B), PAD_LETTER, dtype=torch.int8,
            device=letters.device)], dim=1)
    flat = letters.reshape(G, t4, 4, B).permute(0, 1, 3, 2).reshape(-1)
    host_offsets = np.arange(G + 1, dtype=np.int64) * (t4 * 4 * B)
    return Stream(letters=flat.contiguous(),
                  offsets=torch.from_numpy(host_offsets).to(letters.device),
                  lengths=lengths.contiguous(), host_offsets=host_offsets)


def grouped_score(profile: torch.Tensor, letters: torch.Tensor,
                  lengths: torch.Tensor, mode: int, search_type: int,
                  go: int, ge: int, with_flags: bool = False) -> torch.Tensor:
    """Score one query against G dense blocks (letters [G, T, B] int8,
    lengths [G, B] int32; opal_tpu's build_pallas_score_fn_raw). Returns
    the tracker rows [G, len(tracker_rows), B] int32, as ragged_score
    does; on the card ragged_dp runs over grouped_stream's layout (counted
    in LAUNCHES["ragged_dp_grouped"])."""
    stream = grouped_stream(letters, lengths)
    _check_inputs(profile, stream)
    dev = stream.letters.device
    if dev.type == "cpu":
        return ragged_score_plain(profile, stream, mode, search_type, go, ge,
                                  with_flags)
    if dev.type != "cuda":
        raise ValueError(f"no ragged_dp kernel for device {dev}")
    return _ragged_launch(profile, stream, mode, search_type, go, ge,
                          with_flags, "ragged_dp_grouped")


def grouped_score_plain(profile: torch.Tensor, letters: torch.Tensor,
                        lengths: torch.Tensor, mode: int, search_type: int,
                        go: int, ge: int,
                        with_flags: bool = False) -> torch.Tensor:
    """The function `grouped_score` computes: ragged_score_plain on the
    same stream."""
    return ragged_score_plain(profile, grouped_stream(letters, lengths),
                              mode, search_type, go, ge, with_flags)


def multi_score(profile: torch.Tensor, seg_qs, stream: Stream, mode: int,
                search_type: int, go: int, ge: int,
                events=None) -> torch.Tensor:
    """Score len(seg_qs) stacked queries (profile from
    prepare_profile_multi) against every lane of the stream in one pass.
    Returns [NB, n_seg * (3 if score+end else 1), B] int32 on the stream's
    device: rows [scores | end_qs | end_ts], final values (segment s equals
    finalize_device of ragged_score on query s alone). `events`, a list,
    receives (wave, 0, start, end) CUDA events around each launch."""
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

    def launch(w, scratch, cu_stream, _step):
        return lib.multi_dp_launch(
            profile.data_ptr(), stream.letters.data_ptr(),
            stream.offsets.data_ptr(), stream.lengths.data_ptr(),
            *w, scratch, out.data_ptr(), w.n_jobs, w.max_g, B,
            profile.shape[1], n_seg, c_qs, int(mode), int(track_end),
            int(go), int(ge), cu_stream)

    _run_plan("multi_dp", launch, stream, profile.shape[0] // STRIP_ROWS,
              False, events=events)
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


@dataclasses.dataclass
class LaunchPlan:
    """How one kernel covers the whole stream (see plan_launch)."""
    groups: np.ndarray       # [NB] int32, G of each block
    waves: list              # per launch: block ids, longest block first
    jobs: list               # per launch: [n, 2] int32 (block, first lane)
    scratch_offsets: list    # per launch: [NB] int64 first cell, -1: none
    scratch_cells: int       # cells of the largest launch's scratch


def plan_groups(block_cols, B: int, n_strips: int, threads: int):
    """G per block ([NB] int32) for a launch of n_strips strips per lane,
    from each block's longest lane (block_cols, its padded columns; B
    lanes per block):

    - a query of up to MAX_GROUP strips runs in one pass: every block takes
      the smallest power of two G >= n_strips (no scratch, no hand-off
      through memory);
    - a taller query needs several passes anyway: a block takes the
      smallest G whose longest chain, ceil(n_strips / G) x (columns + G -
      1) steps, fits half the launch's work per resident thread (n_strips x
      the blocks' columns x B / `threads`); longer blocks take larger G, up
      to MAX_GROUP, and short ones keep G = 1 (no lag)."""
    g_top = 1
    while g_top < min(n_strips, MAX_GROUP):
        g_top *= 2
    cols = np.asarray(block_cols, np.int64)
    out = np.full(len(cols), g_top, np.int32)
    if n_strips <= g_top:
        return out
    work = n_strips * int(cols.sum()) * B  # strip-columns of the launch
    g = g_top
    while g >= 1:  # walk down: the smallest G that fits wins
        chain = -(-n_strips // g) * (cols + g - 1)
        out[2 * chain * threads <= work] = g
        g //= 2
    return out


def plan_launch(host_offsets: np.ndarray, B: int, n_strips: int,
                handoff: bool, threads: int, G: int | None = None
                ) -> LaunchPlan:
    """The launch plan of a kernel whose lanes walk n_strips strips over
    the stream with these block offsets (B lanes per block). `handoff`: the
    launches hand rows on to a following launch (query panels). `threads`:
    the threads the card keeps resident.

    - G per block: plan_groups, or G for every block where it is given.
    - Every block in one launch, as CUDA blocks of THREADS threads
      (THREADS / G lanes each), the blocks ordered by their longest lane,
      longest first, so the longest chains start at once and short blocks
      fill the SMs behind them.
    - Scratch ([t, lane] int2 cells, one per letter byte of the block) only
      for blocks that hand rows on: several passes (n_strips > G) or
      `handoff`. Where their scratch exceeds SCRATCH_CELLS, the blocks are
      dealt round-robin, longest first, into the fewest launches (waves)
      whose scratch fits, so each wave holds long and short blocks and
      about the same number of CUDA blocks; a block larger than the budget
      runs alone. The waves share one scratch of the largest wave's size."""
    offs = np.asarray(host_offsets, np.int64)
    NB = len(offs) - 1
    nbytes = offs[1:] - offs[:-1]
    cols = nbytes // max(B, 1)
    if G is None:
        groups = plan_groups(cols, B, n_strips, threads)
    elif G in (1, 2, 4, 8):
        groups = np.full(NB, G, np.int32)
    else:
        raise ValueError(f"G={G}: 1, 2, 4 or 8 threads per lane")
    need = np.where(handoff | (n_strips > groups), nbytes, 0)
    order = np.argsort(-cols, kind="stable")
    n_w = max(1, -(-int(need.sum()) // SCRATCH_CELLS))
    while True:
        waves = [order[w::n_w] for w in range(n_w)]
        if n_w >= NB or max(int(need[w].sum()) for w in waves) \
                <= SCRATCH_CELLS:
            break
        n_w += 1
    waves = [w for w in waves if len(w)]
    jobs, scr = [], []
    for w in waves:
        per = [np.stack([np.full(-(-B * int(groups[b]) // THREADS), b),
                         np.arange(0, B, THREADS // int(groups[b]))], 1)
               for b in w]
        jobs.append(np.concatenate(per).astype(np.int32))
        off = np.full(NB, -1, np.int64)
        starts = np.cumsum(need[w]) - need[w]
        off[w] = np.where(need[w] > 0, starts, -1)
        scr.append(off)
    return LaunchPlan(groups=groups, waves=[tuple(int(b) for b in w)
                                            for w in waves],
                      jobs=jobs, scratch_offsets=scr,
                      scratch_cells=max(int(need[w].sum()) for w in waves))


@dataclasses.dataclass
class _WaveArgs:
    """One launch's plan on the device: jobs, groups, scratch offsets
    (unpacked, in that order, into the C call), and their sizes."""
    jobs: torch.Tensor
    groups: torch.Tensor
    scr_off: torch.Tensor
    n_jobs: int
    max_g: int

    def __iter__(self):
        return iter((self.jobs.data_ptr(), self.groups.data_ptr(),
                     self.scr_off.data_ptr()))


def plan_for(stream: Stream, n_strips: int, handoff: bool = False,
             G: int | None = None) -> LaunchPlan:
    """The plan the kernels use for this stream on its device (see
    plan_launch): n_strips strips per lane, `handoff` for query panels, G
    (where given) threads per lane in every block."""
    return _device_plan(stream, n_strips, handoff, G)[0]


# Launch plans on their device, by stream shape and planning constants: a
# grouped_score call builds a new Stream of the same shape every time
_PLANS: dict = {}
_PLANS_KEPT = 64


def _device_plan(stream: Stream, n_strips: int, handoff: bool, G=None):
    """(plan_launch's plan, [_WaveArgs] on the stream's device), cached by
    the stream's block offsets, lanes, G and the planning constants."""
    dev = stream.letters.device
    threads = (torch.cuda.get_device_properties(dev).multi_processor_count
               * RESIDENT_THREADS_PER_SM)
    B = stream.lengths.shape[1]
    key = (stream.host_offsets.tobytes(), B, n_strips, handoff, threads,
           MAX_GROUP, SCRATCH_CELLS, str(dev), G)
    hit = _PLANS.get(key)
    if hit is None:
        plan = plan_launch(stream.host_offsets, B, n_strips, handoff,
                           threads, G)
        groups = torch.from_numpy(plan.groups).to(dev)
        hit = (plan, [_WaveArgs(
            torch.from_numpy(j).to(dev), groups, torch.from_numpy(o).to(dev),
            len(j), int(plan.groups[list(w)].max()))
            for w, j, o in zip(plan.waves, plan.jobs,
                               plan.scratch_offsets)])
        if len(_PLANS) >= _PLANS_KEPT:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = hit
    return hit


def _run_plan(name, launch, stream: Stream, n_strips: int, handoff: bool,
              n_steps=1, events=None, G=None):
    """Run launch(wave_args, scratch_ptr, cu_stream, step) once per wave of
    the stream's launch plan (at G threads per lane where given) and,
    inside each wave, for step 0 .. n_steps-1 in order (the panels of a
    query), with one boundary scratch sized for the largest wave (None when
    no block hands rows on). `events`, a list, receives (wave, step, start,
    end) CUDA events around each launch."""
    dev = stream.letters.device
    plan, args = _device_plan(stream, n_strips, handoff, G)
    scratch = None
    if plan.scratch_cells:
        scratch = torch.empty(2 * plan.scratch_cells, dtype=torch.int32,
                              device=dev)
    with torch.cuda.device(dev):
        cu_stream = torch.cuda.current_stream(dev).cuda_stream
        for w, wa in enumerate(args):
            for step in range(n_steps):
                if events is not None:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                err = launch(wa, None if scratch is None
                             else scratch.data_ptr(), cu_stream, step)
                if err:
                    raise RuntimeError(
                        f"{name} launch failed: CUDA error {err}")
                LAUNCHES[name] += 1
                if events is not None:
                    ev[1].record()
                    events.append((w, step) + ev)


def _lib(name):
    """The built library of kernel `name`, with its C signature declared."""
    from . import _build

    lib = _build.load(name)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "ragged_dp":  # 9 pointers, n_jobs .. ge, stream
        sigs = {"ragged_dp_launch": [vp] * 9 + [ci] * 13 + [vp],
                # max_g, W, out[3]
                "ragged_dp_sw_attrs": [ci] * 2 + [ctypes.POINTER(ci)]}
    else:  # multi_dp: 9 pointers, n_jobs, max_g, B, W, n_seg, seg_q, ...
        sigs = {"multi_dp_launch": [vp] * 9 + [ci] * 5
                + [ctypes.POINTER(ci)] + [ci] * 4 + [vp]}
    for fname, args in sigs.items():
        fn = getattr(lib, fname)
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


def _lanes(v, H):
    """[L, 1] column of a boundary value: an int for every lane, or an [L]
    tensor (one per lane)."""
    if torch.is_tensor(v):
        return v[:, None]
    return torch.full_like(H[:, :1], v)


def _column_prefix(H, E, P, ul0, uH0, uF0, go, ge, ramp, sw):
    """One column for all lanes, F chain as a max-plus prefix (exact for
    ge <= go; opal_tpu/engine/xla.py::_column_update). The row above the
    first (ul0 = its H at the previous column, uH0 and uF0 at this one) is
    an int or a per-lane tensor. Returns (H, E, F, ulH + P)."""
    E = torch.maximum(H - go, E - ge)
    ulH = torch.cat([_lanes(ul0, H), H[:, :-1]], dim=1)
    ulhp = ulH + P
    Hp = torch.maximum(E, ulhp)
    if sw:
        Hp = Hp.clamp_min(0)
    c0 = torch.maximum(_lanes(uH0, H) - go, _lanes(uF0, H) - ge)
    C = torch.cat([c0, Hp[:, :-1] - go], dim=1)
    F = torch.cummax(C + ramp, dim=1).values - ramp
    return torch.maximum(Hp, F), E, F, ulhp


def _column_seq(H, E, P, ul0, uH0, uF0, go, ge, sw):
    """One column for all lanes, F chain row by row (exact for any gaps;
    opal_tpu/engine/xla.py::_column_update_seq); the row above as in
    _column_prefix. Returns (H, E, F, ulH + P)."""
    L, Q = H.shape
    E = torch.maximum(H - go, E - ge)
    uH, uF, ul = (_lanes(v, H)[:, 0] for v in (uH0, uF0, ul0))
    cols, fs, ulhps = [], [], []
    for r in range(Q):
        F = torch.maximum(uH - go, uF - ge)
        d = ul + P[:, r]
        h = torch.maximum(torch.maximum(E[:, r], F), d)
        if sw:
            h = h.clamp_min(0)
        cols.append(h)
        fs.append(F)
        ulhps.append(d)
        ul, uH, uF = H[:, r], h, F
    return (torch.stack(cols, dim=1), E, torch.stack(fs, dim=1),
            torch.stack(ulhps, dim=1))


def _sweep_plain(profile, stream, mode, search_type, go, ge, with_flags,
                 row0, rows, top):
    """The DP over the query rows [row0, row0 + rows) of profile [Q, W],
    lanes vectorised, a Python loop over columns (the semantics of
    opal_tpu/engine/xla.py::build_score_fn). top is None for the panel
    that starts at row 0 (the mode's row -1 wall), else (H, F) [T, L] of
    the row above at every column. Returns ({TR_*: [L] int32} raw
    trackers, with rows local to the panel, and the last-row ones only
    when the panel ends at row Q-1; the bottom (H, F) [T, L] of its last
    row, or None when it ends at row Q-1). with_flags adds the flag
    trackers over each lane's valid cells (xla.py:201-216): there are no
    padding rows here, and columns at or past a lane's length are
    masked."""
    NB, B = stream.lengths.shape
    final = row0 + rows == profile.shape[0]
    dev = profile.device
    i32 = torch.int32
    sw = mode == MODE_SW
    track_end = search_type != SEARCH_SCORE
    lens = stream.lengths.reshape(-1)
    L = NB * B
    T = int(lens.max()) if L else 0
    letters = _decode_letters(stream, T)
    prof_t = profile[row0:row0 + rows].t().contiguous()  # [W, rows]
    local = torch.arange(rows, dtype=i32, device=dev)
    ramp = (local * ge)[None, :]
    wall = mode in (MODE_NW, MODE_HW)

    if wall:
        H = (-go - (row0 + local) * ge)[None, :].expand(L, rows).clone()
    else:
        H = torch.zeros((L, rows), dtype=i32, device=dev)
    E = torch.full((L, rows), 0 if sw else NEG, dtype=i32, device=dev)
    zeros = torch.zeros(L, dtype=i32, device=dev)
    negs = torch.full((L,), NEG, dtype=i32, device=dev)
    best, best_r, best_c = zeros.clone(), zeros.clone(), zeros.clone()
    lr, lr_c, plrm = negs.clone(), zeros.clone(), negs.clone()
    ocm, orow, nw = negs.clone(), zeros.clone(), negs.clone()
    max_ulhp, max_h = negs.clone(), negs.clone()
    min_e, min_f = zeros.clone(), zeros.clone()
    bottom = ([], [])

    for t in range(T):
        P = prof_t[letters[t]]  # [L, rows]
        if top is not None:  # the last row of the panel above
            uH0, uF0 = top[0][t], top[1][t]
            # H[row0-1][-1]: the mode's first-column wall
            ul0 = ((-go - (row0 - 1) * ge if wall else 0) if t == 0
                   else top[0][t - 1])
        elif mode == MODE_NW:
            uH0 = -go - t * ge
            ul0 = 0 if t == 0 else uH0 + ge
        else:
            uH0 = ul0 = 0
        if top is None:
            uF0 = 0 if sw else NEG
        if ge <= go:
            H, E, F, ulhp = _column_prefix(H, E, P, ul0, uH0, uF0, go, ge,
                                           ramp, sw)
        else:
            H, E, F, ulhp = _column_seq(H, E, P, ul0, uH0, uF0, go, ge, sw)
        if not final:
            bottom[0].append(H[:, -1])
            bottom[1].append(F[:, -1])
        valid = t < lens
        if with_flags:
            vm = valid[:, None]
            if sw:
                max_ulhp = torch.maximum(
                    max_ulhp, torch.where(vm, ulhp, NEG).amax(dim=1))
            else:
                min_e = torch.minimum(min_e, torch.where(vm, E, 0).amin(dim=1))
                min_f = torch.minimum(min_f, torch.where(vm, F, 0).amin(dim=1))
                max_h = torch.maximum(max_h,
                                      torch.where(vm, H, NEG).amax(dim=1))
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
        if mode == MODE_OV:
            colmax, argrow = torch.max(H, dim=1)
            ocm = torch.where(is_end, colmax, ocm)
            orow = torch.where(is_end, argrow.to(i32), orow)
        if not final:  # the last-row trackers belong to the final panel
            continue
        lastrow = H[:, rows - 1]
        if mode == MODE_NW:
            nw = torch.where(is_end, lastrow, nw)
            continue
        if mode == MODE_OV:
            plrm = torch.where(is_end, lr, plrm)
        improved = valid & (lastrow > lr)
        lr = torch.where(improved, lastrow, lr)
        lr_c = torch.where(improved, torch.full_like(lr_c, t), lr_c)

    raw = {TR_BEST: best if sw else lr, TR_BEST_R: best_r,
           TR_BEST_C: best_c if sw else lr_c, TR_NW: nw, TR_OV_PLRM: plrm,
           TR_OV_CMAX: ocm, TR_OV_ROW: orow, TR_ULHP: max_ulhp,
           TR_MIN_E: min_e, TR_MIN_F: min_f, TR_MAX_H: max_h}
    if final:
        return raw, None
    empty = torch.zeros((0, L), dtype=i32, device=dev)
    return raw, tuple(torch.stack(b) if b else empty for b in bottom)


def _stack_rows(raw, row_ids, NB, B):
    """[NB, len(row_ids), B] of the raw [L] trackers, in row_ids' order."""
    return torch.stack([raw[r] for r in row_ids], dim=0).reshape(
        len(row_ids), NB, B).transpose(0, 1).contiguous()


def ragged_score_plain(profile: torch.Tensor, stream: Stream, mode: int,
                       search_type: int, go: int, ge: int,
                       with_flags: bool = False) -> torch.Tensor:
    """The function `ragged_dp` computes, in plain PyTorch int32 (see
    _sweep_plain): the tracker rows of tracker_rows, the OV end resolved
    (opal_tpu/engine/xla.py:238-249)."""
    _check_inputs(profile, stream)
    PLAIN_CALLS["ragged_score_plain"] += 1
    NB, B = stream.lengths.shape
    Q = profile.shape[0]
    raw, _ = _sweep_plain(profile, stream, mode, search_type, go, ge,
                          with_flags, 0, Q, None)
    if mode == MODE_OV:  # the end is in the last column iff its max beats
        # the last-row max of the earlier columns
        ocm, lr = raw[TR_OV_CMAX], raw[TR_BEST]
        in_last = ocm > raw[TR_OV_PLRM]
        raw[TR_BEST] = torch.maximum(ocm, lr)
        raw[TR_BEST_R] = torch.where(in_last, raw[TR_OV_ROW],
                                     torch.full_like(lr, Q - 1))
        raw[TR_BEST_C] = torch.where(in_last, stream.lengths.reshape(-1) - 1,
                                     raw[TR_BEST_C])
    return _stack_rows(raw, tracker_rows(mode, search_type, with_flags), NB,
                       B)


def ragged_panel_plain(profile: torch.Tensor, stream: Stream, mode: int,
                       search_type: int, go: int, ge: int,
                       with_flags: bool = False, row0: int = 0,
                       rows: int = None, top=None):
    """The function one panel launch of `ragged_dp` computes, in plain
    PyTorch int32: ragged_score_plain over the query rows [row0, row0 +
    rows) of profile [Q, W] with a per-lane top boundary in place of the
    mode's row -1 wall (top: the previous panel's bottom, None when row0 is
    0). Returns (tracker rows [NB, len(panel_tracker_rows), B] int32, the
    panel's bottom: (H, F) [T, L] of its last row at every column, T the
    longest lane and L = NB * B, or None when the panel ends at row
    Q-1)."""
    _check_inputs(profile, stream)
    Q = profile.shape[0]
    rows = Q - row0 if rows is None else rows
    final = row0 + rows == Q
    if (top is None) != (row0 == 0) or not (
            0 <= row0 and 1 <= rows and row0 + rows <= Q
            and row0 % STRIP_ROWS == 0
            and (final or rows % STRIP_ROWS == 0)):
        raise ValueError(f"query rows [{row0}, {row0 + rows}) of {Q}: not "
                         "a panel of whole strips with its top boundary")
    PLAIN_CALLS["ragged_panel_plain"] += 1
    NB, B = stream.lengths.shape
    # an interior NW or HW panel's filler row TR_BEST holds the untouched
    # last-row max, NEG, as the kernel's does
    raw, bottom = _sweep_plain(profile, stream, mode, search_type, go, ge,
                               with_flags, row0, rows, top)
    return _stack_rows(raw, panel_tracker_rows(mode, search_type, with_flags,
                                               final), NB, B), bottom


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
        fin = finalize_device(tr, stream.lengths, mode, search_type, Q)
        for c, k in zip(cols, ("score", "end_q", "end_t")):
            if k in fin:
                c.append(fin[k])
        off += segment_rows(Q)
    return torch.stack(cols[0] + cols[1] + cols[2], dim=1)
