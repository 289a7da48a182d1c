"""Result ranking (copies of opal_tpu's ranking.py): score descending,
then original DB index ascending (stable and independent of how the
database was split)."""
from __future__ import annotations

import numpy as np


def rank_scores(scores: np.ndarray, top_k: int = 0) -> np.ndarray:
    """Indices of DB sequences ordered by (score desc, index asc); the
    first top_k of them when top_k > 0."""
    scores = np.asarray(scores)
    order = np.lexsort((np.arange(len(scores)), -scores))
    return order[:top_k] if top_k else order


def top_k_results(results, k: int):
    """(index, SearchResult) pairs for the k best-scoring results (all of
    them when k is 0); a result without a score ranks below every score."""
    scores = np.array([r.score if r.score_set else np.iinfo(np.int64).min
                       for r in results])
    order = rank_scores(scores, k)
    return [(int(i), results[int(i)]) for i in order]


def rank_rows(idx, cols, k):
    """Rank rows whose DB indices are `idx` by (score desc, index asc) and
    keep the first k. Returns (ranked_idx, ranked_cols)."""
    idx = np.asarray(idx)
    order = np.lexsort((idx, -np.asarray(cols["score"], np.int64)))[:k]
    return idx[order], {c: np.asarray(v)[order] for c, v in cols.items()}


def merge_shard_scores(shard_scores, shard_sizes) -> np.ndarray:
    """Trim per-shard padded rows (1-D score vectors, or [max_local, k]
    record tables) to their true sizes and concatenate them in shard
    order. A utility for custom merge flows: MultiHostSearch ranks the
    padded table directly and never builds the concatenation."""
    parts = [np.asarray(row)[:n] for row, n in zip(shard_scores, shard_sizes)]
    return np.concatenate(parts) if parts else np.zeros(0, np.int32)
