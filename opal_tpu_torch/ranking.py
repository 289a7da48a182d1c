"""Result ranking (copies of opal_tpu's rank_scores and rank_rows): score
descending, then original DB index ascending (stable and independent of
how the database was split)."""
from __future__ import annotations

import numpy as np


def rank_scores(scores: np.ndarray, top_k: int = 0) -> np.ndarray:
    """Indices of DB sequences ordered by (score desc, index asc); the
    first top_k of them when top_k > 0."""
    scores = np.asarray(scores)
    order = np.lexsort((np.arange(len(scores)), -scores))
    return order[:top_k] if top_k else order


def rank_rows(idx, cols, k):
    """Rank rows whose DB indices are `idx` by (score desc, index asc) and
    keep the first k. Returns (ranked_idx, ranked_cols)."""
    idx = np.asarray(idx)
    order = np.lexsort((idx, -np.asarray(cols["score"], np.int64)))[:k]
    return idx[order], {c: np.asarray(v)[order] for c, v in cols.items()}
