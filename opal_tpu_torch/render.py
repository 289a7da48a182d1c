"""Result rendering in the reference CLI's output format (a copy of
opal_tpu's render.py).

The per-sequence result line and the 50-column pretty alignment blocks are
the parity surface of the CLI (reference: src/opal_aligner.cpp:170-188,
printAlignment :304-340); ops_to_cigar is the server's encoding of a path.
"""
from __future__ import annotations

import numpy as np

from .constants import ALIGN_DEL, ALIGN_INS, ALIGN_MATCH, ALIGN_MISMATCH
from .result import SearchResult


def result_line(index: int, res: SearchResult) -> str:
    parts = [f"#{index}: {res.score}"]
    if res.start_location_query >= 0:
        parts.append(f"({res.start_location_query}, {res.start_location_target})")
    else:
        parts.append("(?, ?)")
    if res.end_location_query >= 0:
        parts.append(f"({res.end_location_query}, {res.end_location_target})")
    else:
        parts.append("(?, ?)")
    return " ".join(parts)


def render_alignment(query, target, res: SearchResult, alphabet: str) -> str:
    """50-column alignment blocks, identical to printAlignment
    (reference: src/opal_aligner.cpp:304-340)."""
    out = []
    t_idx = res.start_location_target
    q_idx = res.start_location_query
    aln = res.alignment
    n = res.alignment_length
    for start in range(0, n, 50):
        chunk = aln[start : min(start + 50, n)]
        row = ["T: "]
        start_t = t_idx
        for op in chunk:
            if op == ALIGN_DEL:
                row.append("_")
            else:
                row.append(alphabet[target[t_idx]])
                t_idx += 1
        row.append(f" ({max(start_t, 0)} - {t_idx - 1})")
        out.append("".join(row))
        row = ["Q: "]
        start_q = q_idx
        for op in chunk:
            if op == ALIGN_INS:
                row.append("_")
            else:
                row.append(alphabet[query[q_idx]])
                q_idx += 1
        row.append(f" ({max(start_q, 0)} - {q_idx - 1})")
        out.append("".join(row))
        out.append("")
    return "\n".join(out)


def ops_to_cigar(ops) -> str:
    """SAM-convention CIGAR string for an ALIGN_* op array, treating the
    query as the read: '=' match, 'X' mismatch, 'I' consumes a query
    residue (ALIGN_DEL in the reference's op vocabulary), 'D' consumes a
    target residue (ALIGN_INS) — e.g. "12=1X3I40=". Standard SAM parsers
    can walk query/target coordinates with it directly. (The
    reference exposes raw op arrays only; this is the serving-side
    encoding.)"""
    sym = {ALIGN_MATCH: "=", ALIGN_MISMATCH: "X",
           ALIGN_DEL: "I", ALIGN_INS: "D"}
    ops = np.asarray(ops)
    if ops.size == 0:
        return ""
    out = []
    run = 1
    for i in range(1, len(ops) + 1):
        if i < len(ops) and ops[i] == ops[i - 1]:
            run += 1
        else:
            out.append(f"{run}{sym[int(ops[i - 1])]}")
            run = 1
    return "".join(out)
