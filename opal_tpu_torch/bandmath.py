"""Band mathematics for the alignment-reconstruction pass (a copy of
opal_tpu's bandmath.py).

Given a known score lower bound k, computes the pair of diagonal borders
(bottom, top) such that any alignment scoring >= k lies entirely within the
band. Exact port of the reference's closed-form border formulas
(reference: src/opal.cpp:1029-1179), including C's truncating integer
division semantics.

Diagonal indexing: the main diagonal is 0; diagonals below it (toward larger
query index) count up from 1, as do diagonals above it (toward larger target
index). Returns (-1, -1) when no band exists.
"""
from __future__ import annotations

from .constants import MODE_HW, MODE_NW, MODE_OV, MODE_SW


def cdiv(a: int, b: int) -> int:
    """C integer division: truncates toward zero (Python // floors)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def gap_penalty(length: int, gap_open: int, gap_ext: int) -> int:
    """Penalty of a gap of the given length, as a non-negative number
    (reference: src/opal.cpp:1046-1052)."""
    if length > 0:
        return gap_open + gap_ext * (length - 1)
    return 0


def _bottom_border_ov(k: int, Q: int, T: int, Go: int, Ge: int, M: int) -> int:
    """Reference: calculateBottomBandBorderOV (src/opal.cpp:1057-1070)."""
    border = 0
    border = max(border, min(Q - T, cdiv(-1 * (k + Go - Ge - M * T), Ge)))
    candidate = cdiv(-1 * (k - M * Q + Go - Ge), Ge + M)
    if candidate > Q - T:
        border = max(border, candidate)
    return min(border, Q - 1)


def _top_border_hw(k: int, Q: int, T: int, Go: int, Ge: int, M: int) -> int:
    """Reference: calculateTopBandBorderHW (src/opal.cpp:1072-1085)."""
    border = 0
    border = max(border, min(T - Q, cdiv(-1 * (k - M * Q + Go), Ge) + 1))
    candidate = cdiv(-1 * (k - T * M + 2 * Go + Ge * (Q - T - 2)), 2 * Ge + M)
    if candidate > T - Q:
        border = max(border, candidate)
    return min(border, T - 1)


def _bottom_border_hw(k: int, Q: int, T: int, Go: int, Ge: int, M: int) -> int:
    """Reference: calculateBottomBandBorderHW (src/opal.cpp:1087-1102)."""
    border = 0
    candidate = cdiv(-1 * (k + Go - Ge - Q * M), Ge + M)
    if candidate >= Q - T:
        border = max(border, candidate)
    if -2 * Go - Ge * (Q - T - 2) + M * T >= k:
        border = max(border, Q - T - 1)
    return min(border, Q - 1)


def _bottom_border_nw(k: int, Q: int, T: int, Go: int, Ge: int, M: int) -> int:
    """Reference: calculateBottomBandBorderNW (src/opal.cpp:1104-1124)."""
    border = 0
    candidate = cdiv(-1 * (k + 2 * Go - M * Q + Ge * (T - Q - 2)), 2 * Ge + M)
    if candidate > Q - T:
        border = max(border, candidate)
    if Q - T <= cdiv(-1 * (k + Go - M * T - Ge), Ge):
        border = max(border, Q - T)
    if -2 * Go - Ge * (Q - T - 2) + M * T >= k:
        border = max(border, Q - T - 1)
    return min(border, Q - 1)


def band_borders(k: int, mode: int, Q: int, T: int, Go: int, Ge: int, M: int):
    """(bottom, top) band borders, or (-1, -1) if no band exists.

    Reference: calculateBandBorders (src/opal.cpp:1151-1179). The band always
    anchors at the top-left corner (alignment start) and the stop condition
    depends on the mode. OV and SW share conditions; NW/HW differ.
    M is the maximum value in the score matrix.
    """
    if mode in (MODE_OV, MODE_SW):
        if M * min(Q, T) >= k:
            return (_bottom_border_ov(k, Q, T, Go, Ge, M),
                    _bottom_border_ov(k, T, Q, Go, Ge, M))
        return (-1, -1)
    if mode == MODE_HW:
        if M * min(Q, T) - gap_penalty(Q - min(Q, T), Go, Ge) >= k:
            return (_bottom_border_hw(k, Q, T, Go, Ge, M),
                    _top_border_hw(k, Q, T, Go, Ge, M))
        return (-1, -1)
    if mode == MODE_NW:
        if M * min(Q, T) - gap_penalty(abs(Q - T), Go, Ge) >= k:
            return (_bottom_border_nw(k, Q, T, Go, Ge, M),
                    _bottom_border_nw(k, T, Q, Go, Ge, M))
        return (-1, -1)
    raise ValueError(f"invalid mode {mode}")
