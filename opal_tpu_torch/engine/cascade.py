"""Adaptive-precision cascade semantics (a copy of opal_tpu's
engine/cascade.py).

The reference escalates int8 -> int16 -> int32 on saturation overflow
(reference: src/opal.cpp:496-535, :983-1021) because narrower SIMD lanes
double throughput on SSE/AVX. The port computes in exact int32 on the card
(csrc/ragged_dp.cu), so the cascade's *throughput* role disappears, but
its *semantics* remain part of the API surface. The flags it reads are the
ragged_dp kernel's overflow-flag rows (with_flags: the running max of the
diagonal candidate ulH + P for SW; min E, min F and max H otherwise):

- ``classify_precision`` reports, per sequence, the narrowest reference
  precision whose kernel would have finished without overflow. The flag
  conditions are derived analytically from exact values:

  * char SW (negRange trick, reference src/opal.cpp:100-110, :294-303,
    :353-362): overflow iff some cell's diagonal candidate ulH+P reaches
    >= 128, i.e. the biased saturating add would have gone non-negative.
    Values before the first such event equal the exact values, so the flag
    sets coincide exactly.
  * short SW (reference src/opal.cpp:363-371): overflow iff maxH saturates
    at 32767, i.e. some exact diagonal candidate >= 32767.
  * char/short NW/HW/OV (reference src/opal.cpp:801-814): the reference
    flags minE/minF hitting the saturation floor or maxH the ceiling. The
    analytic conditions here (exact min_e <= floor, min_f <= floor,
    max_h >= ceiling) coincide with the saturated kernels EXACTLY, not
    conservatively: saturated values equal exact values up to the first
    saturation event, and that first event is itself a floor/ceiling hit
    that fires the reference's per-column check. Differentially pinned
    against the reference's actual char/short kernels (internal
    ``calculated[]`` arrays via tools/ref_overflow_harness.cpp) in
    opal_tpu's tests/test_cascade_differential.py — zero set difference
    across adversarial boundary configs, all 4 modes, both stage
    boundaries; tests/test_torch_cascade.py holds this copy and the
    kernel's flags against opal_tpu's.
    (The reference's *int* stage has its overflow check commented out,
    src/opal.cpp:793-800, so precision 32 is by definition never
    flagged — matching prec's 32 ceiling.)

- ``search_database_char_sw`` mirrors ``opalSearchDatabaseCharSW``
  (reference: src/opal.cpp:1522-1546): char-precision SW score search that
  flags overflowed sequences (score_set=0, score=-1) instead of escalating.

- ``simulate_overflow_method`` reproduces which sequences each strategy
  would recompute: SIMPLE escalates per sequence; BUCKETS escalates every
  1024-sequence bucket containing an overflow (reference src/opal.cpp:502,
  :347-349). Since all precisions agree wherever they don't overflow,
  outputs are identical either way; the reference differs only in wasted
  work, so this is exposed for observability/compatibility, not correctness.
"""
from __future__ import annotations

import numpy as np

from ..constants import (
    BUCKET_SIZE,
    MODE_SW,
    OVERFLOW_BUCKETS,
    SEARCH_SCORE,
)
from ..result import SearchResult

CHAR_SW_LIMIT = 128       # biased int8 saturating add goes >= 0
SHORT_LIMIT = 32767       # int16 saturation ceiling
CHAR_LIMIT_SAT = 127      # int8 ceiling for the non-negRange kernels


def classify_precision(flags: dict, mode: int) -> np.ndarray:
    """Per-sequence minimal reference precision: 8, 16 or 32 (bits)."""
    if mode == MODE_SW:
        max_ulhp = flags["max_ulhp"]
        prec = np.full(max_ulhp.shape, 8, dtype=np.int32)
        prec[max_ulhp >= CHAR_SW_LIMIT] = 16
        prec[max_ulhp >= SHORT_LIMIT] = 32
    else:
        prec = np.full(flags["max_h"].shape, 8, dtype=np.int32)
        min_e = flags.get("min_e")
        min_f = flags.get("min_f")
        max_h = flags.get("max_h")
        over8 = (
            (max_h >= CHAR_LIMIT_SAT)
            | (min_e <= -128)
            | (min_f <= -128)
        )
        over16 = (
            (max_h >= SHORT_LIMIT)
            | (min_e <= -32768)
            | (min_f <= -32768)
        )
        prec[over8] = 16
        prec[over16] = 32
    return prec


def simulate_overflow_method(
    prec: np.ndarray, overflow_method: int, stage_bits: int = 8
) -> np.ndarray:
    """Which sequences the given strategy recomputes above `stage_bits`.

    SIMPLE: exactly the overflowed sequences. BUCKETS: every sequence in a
    1024-sequence bucket that contains at least one overflow."""
    over = prec > stage_bits
    if overflow_method != OVERFLOW_BUCKETS:
        return over
    out = np.zeros_like(over)
    for start in range(0, len(over), BUCKET_SIZE):
        chunk = over[start : start + BUCKET_SIZE]
        if chunk.any():
            out[start : start + BUCKET_SIZE] = True
    return out


def bucket_escalation_counts(prec: np.ndarray) -> dict:
    """Per-1024-sequence-bucket escalation summary: how many sequences in
    each bucket needed more than 8 / more than 16 bits (reference bucket
    granularity: src/opal.cpp:502, :990). Returns arrays indexed by bucket:
    {"n": sequences per bucket, "over8": ..., "over16": ...}."""
    n = len(prec)
    n_buckets = max(1, -(-n // BUCKET_SIZE)) if n else 0
    sizes = np.zeros(n_buckets, dtype=np.int64)
    over8 = np.zeros(n_buckets, dtype=np.int64)
    over16 = np.zeros(n_buckets, dtype=np.int64)
    for b in range(n_buckets):
        chunk = prec[b * BUCKET_SIZE : (b + 1) * BUCKET_SIZE]
        sizes[b] = len(chunk)
        over8[b] = int((chunk > 8).sum())
        over16[b] = int((chunk > 16).sum())
    return {"n": sizes, "over8": over8, "over16": over16}


def search_database_char_sw(
    query, db, gap_open, gap_ext, matrix, results=None, engine=None
):
    """Char-precision SW score search: sequences whose int8 kernel would
    have overflowed get score=-1, score_set=0; the rest get exact scores.
    Mirrors opalSearchDatabaseCharSW (reference: src/opal.cpp:1522-1546,
    decl src/opal.h:156-165)."""
    from .search import get_default_engine

    engine = engine or get_default_engine()
    query = np.asarray(query, dtype=np.uint8)
    n = len(db)
    if results is None:
        results = [SearchResult() for _ in range(n)]
    idx, cols = engine.score_blocks(
        query, db, gap_open, gap_ext, matrix, MODE_SW, SEARCH_SCORE,
        with_flags=True,
    )
    scores = np.empty(n, np.int64)
    ulhp = np.empty(n, np.int64)
    scores[idx] = cols["score"]
    ulhp[idx] = cols["max_ulhp"]
    overflowed = ulhp >= CHAR_SW_LIMIT
    for i in range(n):
        r = results[i]
        if overflowed[i]:
            r.score = -1
            r.score_set = 0
        else:
            r.set_score(int(scores[i]))
        r.end_location_query = r.end_location_target = -1
        r.start_location_query = r.start_location_target = -1
        r.alignment = None
        r.alignment_length = -1
    return results
