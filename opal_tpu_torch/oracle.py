"""Scalar oracle: trivially-correct full-matrix DP used as the correctness
anchor for the engine and its CUDA kernels (a copy of opal_tpu's oracle,
numpy only; it mirrors the role of calculateSW/calculateGlobal in the
reference's self-test, reference: src/test.cpp:199-328).

Two implementations are provided:

- ``dp_matrix_slow``: pure Python cell loops, the "obviously correct"
  transcription of the Gotoh affine-gap recurrence. Use on tiny inputs.
- ``dp_matrix``: per-column NumPy vectorization. The in-column F chain
  F[r] = max(H[r-1]-Go, F[r-1]-Ge) is rewritten as a running max of
  H'[r-1]-Go candidates, which is exact whenever Ge <= Go (if F[r-1] won the
  max for H[r-1], then H[r-1]-Go = F[r-1]-Go <= F[r-1]-Ge, so the F-path
  candidate via H is dominated). For Ge > Go it falls back to the slow path.

Both return the full H matrix; mode-specific score/end-location rules are
applied post-hoc in ``search_oracle`` with the reference's exact tie-breaking
("smallest end position in target, then in query", src/opal.h:44-46).
"""
from __future__ import annotations

import numpy as np

from .constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_SCORE,
)
from .result import SearchResult

NEG = -(2**40)  # -inf sentinel; never surfaces (always dominated by real values)


def dp_matrix_slow(query, target, gap_open, gap_ext, matrix, mode):
    """Full H matrix via scalar loops. H[r, c] per the Gotoh recurrence with
    mode-specific boundaries (reference: src/test.cpp:199-328)."""
    Q, T = len(query), len(target)
    Go, Ge = gap_open, gap_ext
    sw = mode == MODE_SW
    H = np.zeros((Q, T), dtype=np.int64)
    # prev column state
    if mode in (MODE_NW, MODE_HW):
        prevH = [-Go - r * Ge for r in range(Q)]
    else:
        prevH = [0] * Q
    prevE = [NEG] * Q
    if sw:
        prevH = [0] * Q
        prevE = [0] * Q
    for c in range(T):
        if sw:
            uF = uH = ulH = 0
        else:
            uF = NEG
            if mode == MODE_NW:
                uH = -Go - c * Ge
                ulH = 0 if c == 0 else uH + Ge
            else:
                uH = ulH = 0
        for r in range(Q):
            E = max(prevH[r] - Go, prevE[r] - Ge)
            F = max(uH - Go, uF - Ge)
            s = int(matrix[query[r], target[c]])
            h = max(E, F, ulH + s)
            if sw:
                h = max(h, 0)
            uF, uH, ulH = F, h, prevH[r]
            prevH[r], prevE[r] = h, E
            H[r, c] = h
    return H


def dp_matrix(query, target, gap_open, gap_ext, matrix, mode):
    """Full H matrix, per-column vectorized. Exact (see module docstring)."""
    if gap_ext > gap_open:
        return dp_matrix_slow(query, target, gap_open, gap_ext, matrix, mode)
    query = np.asarray(query, dtype=np.int64)
    target = np.asarray(target, dtype=np.int64)
    Q, T = len(query), len(target)
    Go, Ge = gap_open, gap_ext
    sw = mode == MODE_SW
    m = np.asarray(matrix, dtype=np.int64)
    # Profile: P[r, c] = matrix[query[r], target[c]]
    P = m[query][:, target]

    H = np.empty((Q, T), dtype=np.int64)
    if sw:
        prevH = np.zeros(Q, dtype=np.int64)
        prevE = np.zeros(Q, dtype=np.int64)
    else:
        if mode == MODE_OV:
            prevH = np.zeros(Q, dtype=np.int64)
        else:
            prevH = -Go - np.arange(Q, dtype=np.int64) * Ge
        prevE = np.full(Q, NEG, dtype=np.int64)

    ridx = np.arange(Q, dtype=np.int64)
    for c in range(T):
        E = np.maximum(prevH - Go, prevE - Ge)
        # ulH[r] = prevH[r-1]; boundary value from the virtual row -1.
        if sw:
            ul0, uH0, uF0 = 0, 0, 0
        elif mode == MODE_NW:
            uH0 = -Go - c * Ge
            ul0 = 0 if c == 0 else uH0 + Ge
            uF0 = NEG
        else:
            ul0, uH0, uF0 = 0, 0, NEG
        ulH = np.concatenate(([ul0], prevH[:-1]))
        Hp = np.maximum(E, ulH + P[:, c])  # H without the F candidate
        if sw:
            np.maximum(Hp, 0, out=Hp)
        # F chain: C[0] = max(uH0-Go, uF0-Ge); C[r>=1] = Hp[r-1] - Go
        C = np.empty(Q, dtype=np.int64)
        C[0] = max(uH0 - Go, uF0 - Ge)
        C[1:] = Hp[:-1] - Go
        F = np.maximum.accumulate(C + ridx * Ge) - ridx * Ge
        Hcol = np.maximum(Hp, F)
        H[:, c] = Hcol
        prevE = E
        prevH = Hcol
    return H


def score_and_end(H, mode, query_len, target_len):
    """Apply mode-specific final-score + end-location rules to a full H matrix.

    Tie-break: among maximal cells, the smallest target position wins, then
    the smallest query position (reference: src/opal.h:44-46; improvement
    tracking src/opal.cpp:384-401, :821-835, :881-904).
    Returns (score, end_query, end_target); end locations are None for a
    zero-score SW result.
    """
    Q, T = query_len, target_len
    if mode == MODE_SW:
        best = int(H.max())
        score = max(best, 0)
        if score == 0:
            return 0, None, None
        # first maximal cell in (target-major, then query) order
        cols_max = H.max(axis=0)
        c = int(np.argmax(cols_max == best))  # first column achieving best
        r = int(np.argmax(H[:, c] == best))
        return score, r, c
    if mode == MODE_NW:
        return int(H[Q - 1, T - 1]), Q - 1, T - 1
    if mode == MODE_HW:
        last_row = H[Q - 1, :]
        score = int(last_row.max())
        c = int(np.argmax(last_row == score))
        return score, Q - 1, c
    if mode == MODE_OV:
        last_row = H[Q - 1, :]
        last_col = H[:, T - 1]
        score = int(max(last_row.max(), last_col.max()))
        col_max = int(last_col.max())
        # prev last-row max excludes the final column's last-row cell
        prev_lr_max = int(last_row[: T - 1].max()) if T > 1 else NEG
        if col_max > prev_lr_max:
            r = int(np.argmax(last_col == col_max))
            return score, r, T - 1
        c = int(np.argmax(last_row == int(last_row.max())))
        return score, Q - 1, c
    raise ValueError(f"invalid mode {mode}")


def search_oracle(
    query,
    db,
    gap_open,
    gap_ext,
    matrix,
    mode,
    search_type=SEARCH_SCORE,
    slow=False,
):
    """Score (+ end-location) search over a database, oracle version."""
    results = []
    dp = dp_matrix_slow if slow else dp_matrix
    for target in db:
        H = dp(query, target, gap_open, gap_ext, matrix, mode)
        score, r, c = score_and_end(H, mode, len(query), len(target))
        res = SearchResult()
        res.set_score(score)
        if search_type != SEARCH_SCORE:
            res.end_location_query = -1 if r is None else r
            res.end_location_target = -1 if c is None else c
        results.append(res)
    return results
