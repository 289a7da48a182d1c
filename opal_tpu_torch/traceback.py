"""Alignment reconstruction: banded DP + backtrace (a copy of opal_tpu's
traceback.py; the port keeps its own, with its own native library).

Host-side (NumPy) port of the reference's ``findAlignment``
(reference: src/opal.cpp:1236-1431) with identical semantics:

- the DP always starts at the top-left corner (NW-style boundaries) and the
  stop/score rules follow the requested mode;
- only cells inside the score-bound band are computed (out-of-band cells get
  the -inf sentinel), and the column loop stops early once the running max
  score reaches ``score_limit``;
- the backtrace prefers E over F over the diagonal when fields tie
  (src/opal.cpp:1376-1398), and leading indels at the matrix border are
  appended manually (src/opal.cpp:1400-1409).

Per-pair work is small and irregular (band-shaped, data-dependent early
stop), so this stage runs on the host (in C through _native where a
compiler is present) while the scoring pass runs on the card. In the
pure-Python path, columns are vectorized over the in-band rows with the
exact max-plus rewrite of the F chain (valid for gap_ext <= gap_open;
scalar loop otherwise).
"""
from __future__ import annotations

import numpy as np

from .bandmath import band_borders
from .constants import (
    ALIGN_DEL,
    ALIGN_INS,
    ALIGN_MATCH,
    ALIGN_MISMATCH,
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
)

INT_MIN = -(2**31)


class AlignmentError(Exception):
    pass


def find_alignment(
    query, target, gap_open, gap_ext, matrix, score_limit, mode,
    full_band: bool = False, use_native: bool = True,
):
    """Returns (score, end_query, end_target, ops) where ops is a uint8 array
    of ALIGN_* codes covering the alignment from the top-left corner to the
    end location. Mirrors findAlignment (src/opal.cpp:1236-1431).

    All DP arithmetic is int64: where the reference's int arithmetic wraps
    around INT_MIN (it does when gap_ext == max(gap_open, gap_ext) makes the
    sentinel hit INT_MIN exactly, e.g. -o 5 -e 5, on which the reference
    binary segfaults), this implementation keeps exact values and still
    produces a correct alignment. On configs where the reference is
    well-defined, results are bit-identical.

    full_band: bypass the score-bound band (compute every cell); used as a
    fallback when the closed-form band is too narrow for degenerate configs.
    """
    query = np.asarray(query, dtype=np.int64)
    target = np.asarray(target, dtype=np.int64)
    Q, T = len(query), len(target)
    Go, Ge = int(gap_open), int(gap_ext)
    m = np.asarray(matrix, dtype=np.int64)
    M = int(m.max())

    if full_band:
        bottom, top = Q - 1, T - 1
    else:
        try:
            bottom, top = band_borders(score_limit, mode, Q, T, Go, Ge, M)
        except ZeroDivisionError:
            # zero gap penalties: the closed-form band math divides by the
            # gap costs (the reference would hit the same division,
            # src/opal.cpp:1057-1124); every cell can be on an optimal path
            bottom, top = Q - 1, T - 1
    if not (0 <= bottom < Q and 0 <= top < T):
        raise AlignmentError(
            f"no band for score_limit={score_limit} (band=({bottom},{top}))"
        )

    if use_native:
        from ._native import find_alignment_native

        out = find_alignment_native(
            query, target, Go, Ge, m, score_limit, mode, bottom, top
        )
        if out is not None:
            return out

    LSB = INT_MIN + max(Go, Ge)  # reference: src/opal.cpp:1265

    P = m[query][:, target]  # profile: P[r, c]

    # Band-relative cell storage: where the reference stores the full Q*T
    # matrix (src/opal.cpp:1263 — its main long-sequence memory weakness),
    # cell (r, c) lives at row (r - c*step + off) so only O(band * T) cells
    # are kept when the band is narrower than the matrix.
    W = bottom + top + 1
    if W < Q:
        rows, step, off = W, 1, top
    else:
        rows, step, off = Q, 0, 0
    Hm = np.full((rows, T), LSB, dtype=np.int64)
    Em = np.full((rows, T), LSB, dtype=np.int64)
    Fm = np.full((rows, T), LSB, dtype=np.int64)

    def _read(arr, r, cc, col_rs, col_re):
        if r < col_rs or r > col_re:
            return LSB
        return int(arr[r - cc * step + off, cc])

    prevH = -Go - np.arange(Q, dtype=np.int64) * Ge  # initial column H
    prevE = np.full(Q, LSB, dtype=np.int64)

    vectorized = Ge <= Go
    max_score = INT_MIN  # max among cells that could be final
    H_last = INT_MIN     # value of the last computed cell in the column
    c = 0
    while c < T and max_score < score_limit:
        rs = max(0, c - top)
        re = min(Q - 1, c + bottom)  # inclusive
        if re < rs:
            # column beyond the band's reach: all cells -inf (the reference
            # runs an empty row loop here, keeping its stale H)
            prevH = np.full(Q, LSB, dtype=np.int64)
            prevE = np.full(Q, LSB, dtype=np.int64)
            if mode in (MODE_HW, MODE_OV):
                max_score = max(max_score, H_last)
            c += 1
            continue
        if rs == 0:
            uF = LSB
            uH = -Go - c * Ge
            ulH0 = 0 if c == 0 else uH + Ge
        else:
            uH = uF = LSB
            ulH0 = int(prevH[rs - 1])

        n = re - rs + 1
        pH = prevH[rs : re + 1]
        pE = prevE[rs : re + 1]
        E = np.maximum(pH - Go, pE - Ge)
        ulH = np.empty(n, dtype=np.int64)
        ulH[0] = ulH0
        if n > 1:
            ulH[1:] = prevH[rs : re]
        Hp = np.maximum(E, ulH + P[rs : re + 1, c])
        if vectorized:
            # F chain via exact max-plus prefix (see module docstring).
            C = np.empty(n, dtype=np.int64)
            C[0] = max(uH - Go, uF - Ge)
            if n > 1:
                C[1:] = Hp[:-1] - Go
            ridx = np.arange(n, dtype=np.int64)
            F = np.maximum.accumulate(C + ridx * Ge) - ridx * Ge
            Hcol = np.maximum(Hp, F)
        else:
            F = np.empty(n, dtype=np.int64)
            Hcol = np.empty(n, dtype=np.int64)
            fuH, fuF = uH, uF
            for i in range(n):
                Fi = max(fuH - Go, fuF - Ge)
                Hi = max(int(Hp[i]), Fi)
                F[i] = Fi
                Hcol[i] = Hi
                fuF, fuH = Fi, Hi

        brs = rs - c * step + off
        Hm[brs : brs + n, c] = Hcol
        Em[brs : brs + n, c] = E
        Fm[brs : brs + n, c] = F
        H_last = int(Hcol[-1])

        if mode == MODE_SW:
            max_score = max(max_score, int(Hcol.max()))
        elif mode == MODE_OV and c == T - 1:
            max_score = max(max_score, int(Hcol.max()))
        if mode in (MODE_HW, MODE_OV):
            # reference tracks the last *computed* cell of the column as the
            # "last row" (src/opal.cpp:1329-1331)
            max_score = max(max_score, H_last)

        # next column's prev state (out-of-band rows hold LSB)
        prevH = np.full(Q, LSB, dtype=np.int64)
        prevE = np.full(Q, LSB, dtype=np.int64)
        prevH[rs : re + 1] = Hcol
        prevE[rs : re + 1] = E
        c += 1

    last_col = c - 1

    # Score and end location (reference: src/opal.cpp:1336-1362).
    if mode == MODE_NW:
        score = H_last
        end_t, end_q = T - 1, Q - 1
    elif mode == MODE_HW:
        score = max_score
        end_t, end_q = last_col, Q - 1
    elif mode in (MODE_SW, MODE_OV):
        score = max_score
        end_t = last_col
        rs = max(0, last_col - top)
        re = min(Q - 1, last_col + bottom)
        brs = rs - last_col * step + off
        col = Hm[brs : brs + (re - rs + 1), last_col]
        idx = np.nonzero(col == max_score)[0]
        if idx.size == 0:
            raise AlignmentError("end location not found in last column")
        end_q = rs + int(idx[0])
    else:
        raise ValueError(f"invalid mode {mode}")

    # Backtrace (reference: src/opal.cpp:1364-1416). Fields: 0=H, 1=E, 2=F.
    # Out-of-band cells read as LSB (_read checks the band per column).
    ops: list[int] = []
    r, cc = end_q, end_t
    field = 0
    while r >= 0 and cc >= 0:
        rs = max(0, cc - top)
        re = min(Q - 1, cc + bottom)
        prs = max(0, cc - 1 - top)
        pre = min(Q - 1, cc - 1 + bottom)
        if field == 0:
            h = _read(Hm, r, cc, rs, re)
            e = _read(Em, r, cc, rs, re)
            f = _read(Fm, r, cc, rs, re)
            if h == e:
                field = 1
            elif h == f:
                field = 2
            else:
                ops.append(ALIGN_MATCH if query[r] == target[cc] else ALIGN_MISMATCH)
                r -= 1
                cc -= 1
        elif field == 1:
            if cc > 0:
                e = _read(Em, r, cc, rs, re)
                lh = _read(Hm, r, cc - 1, prs, pre)
                field = 0 if e == lh - Go else 1
            ops.append(ALIGN_INS)
            cc -= 1
        else:
            if r > 0:
                f = _read(Fm, r, cc, rs, re)
                uh = _read(Hm, r - 1, cc, rs, re)
                field = 0 if f == uh - Go else 2
            ops.append(ALIGN_DEL)
            r -= 1
    while r >= 0:
        ops.append(ALIGN_DEL)
        r -= 1
    while cc >= 0:
        ops.append(ALIGN_INS)
        cc -= 1

    return score, end_q, end_t, np.asarray(ops[::-1], dtype=np.uint8)


def _replay(query, target, start_q, start_t, ops, go, ge, matrix):
    """Affine-gap score and end coordinates of an op path replayed from
    (start_q, start_t); (None, ...) if the path walks out of the matrix.

    Vectorized: per-op query/target advances are cumulative sums, match
    scores one fancy-indexed gather, gap opens a shifted-comparison mask
    (a gap op opens at cost go unless the previous op is the same gap
    kind, else extends at ge) — measured ~12x the per-op Python loop,
    which was 25% of the whole-DB alignment pass."""
    ops = np.asarray(ops, dtype=np.uint8)
    if ops.size == 0:
        return 0, start_q - 1, start_t - 1
    is_sub = (ops == ALIGN_MATCH) | (ops == ALIGN_MISMATCH)
    is_del = ops == ALIGN_DEL
    is_ins = ops == ALIGN_INS
    dq = is_sub | is_del
    dt = is_sub | is_ins
    qi = start_q + np.cumsum(dq) - dq  # row BEFORE consuming this op
    ti = start_t + np.cumsum(dt) - dt
    # out-of-matrix walk: report the first offending position
    bad = (dq & (qi >= len(query))) | (dt & (ti >= len(target)))
    if bad.any():
        k = int(np.argmax(bad))
        return None, int(qi[k]), int(ti[k])
    score = int(matrix[query[qi[is_sub]], target[ti[is_sub]]].sum())
    prev_same = np.empty(ops.size, dtype=bool)
    prev_same[0] = False
    prev_same[1:] = ops[1:] == ops[:-1]
    n_gap = int(is_del.sum() + is_ins.sum())
    n_ext = int(((is_del | is_ins) & prev_same).sum())
    score -= n_ext * int(ge) + (n_gap - n_ext) * int(go)
    return (score, int(qi[-1] + dq[-1]) - 1, int(ti[-1] + dt[-1]) - 1)


def _replay_batch(query, targets, starts_q, starts_t, ops_cat, counts,
                  go, ge, matrix):
    """Vectorized `_replay` over many op paths sharing one query.

    targets: list of per-segment target arrays; starts_q/starts_t: int
    arrays [L]; ops_cat: all segments' ops concatenated segment-major;
    counts: ops per segment [L]. Returns (score[L], end_q[L], end_t[L],
    valid[L]) — valid False where the path walks out of the matrix
    (equivalent to _replay returning score None). Segment k's outputs
    equal `_replay(query, targets[k], starts_q[k], starts_t[k], ops_k,
    go, ge, matrix)` exactly; one pass of numpy ops replaces L calls
    (the per-call overhead was ~25% of the batched device fill)."""
    L = len(counts)
    counts = np.asarray(counts, np.int64)
    starts_q = np.asarray(starts_q, np.int64)
    starts_t = np.asarray(starts_t, np.int64)
    scores = np.zeros(L, np.int64)
    reqs = starts_q - 1
    rets = starts_t - 1
    valid = np.ones(L, bool)
    n = int(ops_cat.size)
    if n == 0:
        return scores, reqs, rets, valid
    ops = np.asarray(ops_cat, np.uint8)
    seg_ends = np.cumsum(counts)
    seg_starts = seg_ends - counts
    seg_id = np.repeat(np.arange(L), counts)

    is_sub = (ops == ALIGN_MATCH) | (ops == ALIGN_MISMATCH)
    is_del = ops == ALIGN_DEL
    is_ins = ops == ALIGN_INS
    dq = is_sub | is_del
    dt = is_sub | is_ins
    cq = np.cumsum(dq)
    ct = np.cumsum(dt)
    ne = seg_starts[counts > 0]  # non-empty segments' first op index
    cq0 = np.zeros(L, np.int64)
    ct0 = np.zeros(L, np.int64)
    cq0[counts > 0] = cq[ne] - dq[ne]
    ct0[counts > 0] = ct[ne] - dt[ne]
    qi = starts_q[seg_id] + (cq - cq0[seg_id]) - dq  # row BEFORE the op
    ti = starts_t[seg_id] + (ct - ct0[seg_id]) - dt

    tlens = np.fromiter((len(t) for t in targets), np.int64, count=L)
    bad = (dq & (qi >= len(query))) | (dt & (ti >= tlens[seg_id]))
    if bad.any():
        valid &= np.bincount(seg_id[bad], minlength=L) == 0

    t_off = np.concatenate([[0], np.cumsum(tlens)[:-1]])
    cat_t = (np.concatenate([np.asarray(t, np.uint8) for t in targets])
             if tlens.sum() else np.zeros(0, np.uint8))
    sub = is_sub & ~bad
    qlet = np.asarray(query, np.uint8)[qi[sub]]
    tlet = cat_t[t_off[seg_id[sub]] + ti[sub]]
    m = np.asarray(matrix, np.int64)
    scores += np.bincount(seg_id[sub], weights=m[qlet, tlet],
                          minlength=L).astype(np.int64)

    is_gap = is_del | is_ins
    prev_same = np.empty(n, bool)
    prev_same[0] = False
    prev_same[1:] = ops[1:] == ops[:-1]
    prev_same[seg_starts[counts > 0]] = False  # runs never span segments
    n_gap = np.bincount(seg_id[is_gap], minlength=L)
    n_ext = np.bincount(seg_id[is_gap & prev_same], minlength=L)
    scores -= n_ext * int(ge) + (n_gap - n_ext) * int(go)

    last = seg_ends[counts > 0] - 1
    reqs[counts > 0] = qi[last] + dq[last] - 1
    rets[counts > 0] = ti[last] + dt[last] - 1
    return scores, reqs, rets, valid


def align_pair_reverse_trick(
    query, target, gap_open, gap_ext, matrix, score, end_q, end_t, mode
):
    """Find start location + ops for one pair whose (score, end location) is
    already known, using the reference's reverse-alignment trick
    (reference: src/opal.cpp:1475-1504): align reversed prefixes with
    score_limit = known score; the end found on the reversed pair is the
    start on the forward pair.

    Every reconstructed path is replay-validated (score and end coords)
    before being returned. This catches a flaw the reference shares but
    never detects (its assert checks only the score, src/opal.cpp:1497):
    with a narrow band, the HW/OV "last row" early-stop tracks the
    band-edge cell, and when the band excludes the true last row the
    backtrace anchors on an out-of-band cell and emits an invalid path.
    An invalid banded path triggers a full-band retry (whose last-row
    semantics are exact); a still-invalid path raises.

    Returns (start_q, start_t, ops) with ops in forward order.
    """
    aq = np.asarray(query[: end_q + 1], dtype=np.uint8)[::-1]
    at = np.asarray(target[: end_t + 1], dtype=np.uint8)[::-1]

    def _attempt(full_band):
        rscore, rend_q, rend_t, rops = find_alignment(
            aq, at, gap_open, gap_ext, matrix, score, mode,
            full_band=full_band,
        )
        if rscore != score:
            raise AlignmentError(
                f"reverse-pass score {rscore} != known score {score}"
            )
        sq = len(aq) - rend_q - 1
        st = len(at) - rend_t - 1
        ops = rops[::-1].copy()
        got, req, ret = _replay(
            query, target, sq, st, ops, gap_open, gap_ext, matrix
        )
        if got != score or (req, ret) != (end_q, end_t):
            raise AlignmentError(
                f"path replay ({got}, end ({req},{ret})) != known "
                f"({score}, end ({end_q},{end_t}))"
            )
        return sq, st, ops

    try:
        return _attempt(full_band=False)
    except AlignmentError:
        # Narrow-band failure modes (see docstring) or degenerate configs
        # where the closed-form band is too tight (the reference crashes).
        return _attempt(full_band=True)
