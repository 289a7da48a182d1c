"""Device-side top-k: the k best sequences of a search, selected on the
device, so only candidates are downloaded (a port of opal_tpu's
engine/ranked.py; there the selection is XLA code, here PyTorch ops).

The order is the reference tie-break: score descending, then DB index
ascending (reference: src/opal.h:44-74). Selection is exact:

1. tracker rows become score (and end_q, end_t) per lane on the device
   (kernels.finalize_device; multi_dp emits final values already);
2. padding lanes are masked through the per-lane DB index
   (DeviceDatabase.lane_indices, -1 = padding);
3. ``s_k = topk(score, k)[k-1]``, then two more topk calls emit a SUPERSET
   of the exact top k: the entries with score > s_k (at most k-1) and the
   k smallest-index entries with score == s_k. Their keys are -index, which
   are unique, so the unspecified tie order of torch.topk cannot change
   which entries are chosen. The host sorts the <= 2k candidates by
   (-score, index) and keeps k.

The candidates of one query come back as one packed [n_cols, 2k] int32
tensor (rows db, score, valid[, end_q, end_t]); those of a stacked group
in one copy for the whole group.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import SEARCH_SCORE
from . import kernels

# The invalid-lane sentinel and the padding key. Unreachable by a valid
# lane: every score of the int32 DP lies above NEG = -2^30.
I32_MIN = -(2**31)


def select_topk(score, end_q, end_t, db_idx, k):
    """<= 2k top-k candidates of [NB, B] score / end / DB-index tensors, as
    one packed [n_cols, 2 * min(k, NB * B)] int32 tensor on their device:
    rows (db, score, valid[, end_q, end_t]). Candidates with valid == 0
    fill unused selection slots; merge_candidates drops them."""
    flat_i = db_idx.reshape(-1)
    valid = flat_i >= 0
    s = torch.where(valid, score.reshape(-1), I32_MIN)
    kk = min(int(k), s.numel())
    sk = torch.topk(s, kk).values[kk - 1]
    # score > sk implies a valid lane (invalid lanes sit at I32_MIN);
    # score == sk needs the explicit mask when sk == I32_MIN itself
    key_gt = torch.where(s > sk, -flat_i, I32_MIN)
    key_eq = torch.where((s == sk) & valid, -flat_i, I32_MIN)
    kg, ig = torch.topk(key_gt, kk)
    ke, ie = torch.topk(key_eq, kk)
    idx2 = torch.cat([ig, ie])
    ok = (torch.cat([kg, ke]) != I32_MIN).to(torch.int32)
    rows = [flat_i[idx2], s[idx2], ok]
    if end_q is not None:
        rows += [end_q.reshape(-1)[idx2], end_t.reshape(-1)[idx2]]
    return torch.stack(rows)


def merge_candidates(parts, k, track_end):
    """Union packed candidate arrays ([n_cols, 2k] each, rows db, score,
    valid[, end_q, end_t]), sort by (score desc, DB index asc) and keep k.
    Returns the ranked dict {"index", "score"[, "end_q", "end_t"]}."""
    dbs, scores, eqs, ets = [], [], [], []
    for p in parts:
        p = np.asarray(p)
        ok = p[2] != 0
        dbs.append(p[0][ok])
        scores.append(p[1][ok])
        if track_end:
            eqs.append(p[3][ok])
            ets.append(p[4][ok])
    db = np.concatenate(dbs) if dbs else np.zeros(0, np.int32)
    score = np.concatenate(scores) if scores else np.zeros(0, np.int32)
    order = np.lexsort((db, -score.astype(np.int64)))[:k]
    out = {"index": db[order].astype(np.int64),
           "score": score[order].astype(np.int32)}
    if track_end:
        eq = np.concatenate(eqs) if eqs else np.zeros(0, np.int32)
        et = np.concatenate(ets) if ets else np.zeros(0, np.int32)
        out["end_q"] = eq[order].astype(np.int32)
        out["end_t"] = et[order].astype(np.int32)
    return out


def topk_from_handle(tr, ddb, mode, search_type, Q, k):
    """The ranked top k of one query from its live ragged_score tracker
    rows (None for an empty database): one selection on the device and one
    copy of the candidates."""
    track_end = search_type != SEARCH_SCORE
    if tr is None:
        return merge_candidates([], k, track_end)
    cols = kernels.finalize_device(tr, ddb.stream.lengths, mode,
                                   search_type, Q)
    cand = select_topk(cols["score"], cols.get("end_q"), cols.get("end_t"),
                       ddb.lane_indices, k)
    return merge_candidates([cand.cpu().numpy()], k, track_end)


def topk_from_multi_handle(handle, ddb, k):
    """The ranked top k of each query of a stacked group from its live
    multi_score rows (see backend.dispatch_multi): one selection per
    segment on the device, one copy of all the candidates. Returns one
    ranked dict per query."""
    tr, seg_qs, _, track_end = handle
    n_q = len(seg_qs)
    if tr is None:
        return [merge_candidates([], k, track_end) for _ in range(n_q)]
    db_idx = ddb.lane_indices
    cands = []
    for s in range(n_q):
        ends = ((tr[:, n_q + s], tr[:, 2 * n_q + s]) if track_end
                else (None, None))
        cands.append(select_topk(tr[:, s], *ends, db_idx, k))
    out = torch.stack(cands).cpu().numpy()  # [n_q, n_cols, 2k]
    return [merge_candidates([out[s]], k, track_end) for s in range(n_q)]
