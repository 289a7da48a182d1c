"""Backend: queries against a resident database through the DP kernels.

It takes the places of opal_tpu's PallasBackend (on the card: the ragged_dp
kernel for one query, the multi_dp kernel for a stacked group, one launch
per wave of blocks) and XlaBackend (on the CPU: the plain versions) with
one protocol: prepare_query -> dispatch_many -> collect_many for one
query, supports_multi -> dispatch_multi -> collect_multi for a group.
Which one runs follows from the device the database lives on; nothing
falls back from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import SEARCH_SCORE
from . import kernels

# |DP values| must stay clear of the int32 -inf sentinel (NEG = -2^30)
VALUE_BOUND = 2**29


class RaggedBackend:
    name = "ragged"

    def __init__(self, device):
        self.device = torch.device(device)

    def supports(self, Q: int, gap_open: int, gap_ext: int, A: int,
                 profile_absmax: int = 0, max_len: int = 0) -> bool:
        """Can the kernel take this search exactly? Any query length, any
        gap pair; int8 letters, and DP values well inside int32."""
        return (
            Q >= 1
            and A <= kernels.MAX_ALPHABET
            and Q * profile_absmax + 2 * abs(gap_open)
            + (Q + max_len) * abs(gap_ext) < VALUE_BOUND
        )

    def supports_multi(self, queries, gap_open, gap_ext, A, matrix,
                       max_len=0) -> bool:
        """Can these queries run as one stacked multi_dp launch? At most
        MULTI_MAX_SEGS of them, each within `supports` (the tallest decides
        the value bound). Any gap pair: the kernel's F chain is exact for
        all of them. The grouping decides launches only, never results."""
        return (0 < len(queries) <= kernels.MULTI_MAX_SEGS
                and min(len(q) for q in queries) >= 1
                and self.supports(max(len(q) for q in queries), gap_open,
                                  gap_ext, A, int(np.abs(matrix).max()),
                                  max_len))

    def prepare_query(self, qprofile: np.ndarray, gap_open, gap_ext):
        """qprofile [A, Q] -> the kernel's [Q, W] int32 profile on device."""
        return torch.from_numpy(kernels.build_profile(qprofile)).to(
            self.device)

    def dispatch_many(self, profile, ddb, gap_open, gap_ext, mode,
                      search_type, with_flags=False):
        """Enqueue the whole database; returns the device tracker rows
        (with the overflow-flag rows when with_flags)."""
        if not ddb.blocks:
            return None
        return kernels.ragged_score(profile, ddb.stream, mode, search_type,
                                    int(gap_open), int(gap_ext), with_flags)

    def collect_many(self, tr, ddb, mode, search_type, Q, with_flags=False):
        """Finalize the tracker rows on the device, then one device->host
        copy; returns [(Block, {col: [n] array}), ...] over all DB
        blocks (the flag columns too when with_flags)."""
        if tr is None:
            return []
        cols = kernels.finalize_device(tr, ddb.stream.lengths, mode,
                                       search_type, Q, with_flags)
        host = torch.stack(list(cols.values()), dim=1).cpu().numpy()
        return [(blk, {k: host[bi, j, :blk.n] for j, k in enumerate(cols)})
                for bi, blk in enumerate(ddb.blocks)]

    def dispatch_multi(self, qprofiles, ddb, gap_open, gap_ext, mode,
                       search_type):
        """Enqueue one stacked pass of the group (qprofile [A, Q_s] each;
        the caller has checked supports_multi). Returns the handle
        (rows or None, seg_qs, mode, track_end); rows stay on the device."""
        profile, seg_qs = kernels.prepare_profile_multi(qprofiles)
        track_end = search_type != SEARCH_SCORE
        if not ddb.blocks:
            return (None, seg_qs, mode, track_end)
        rows = kernels.multi_score(
            torch.from_numpy(profile).to(self.device), seg_qs, ddb.stream,
            mode, search_type, int(gap_open), int(gap_ext))
        return (rows, seg_qs, mode, track_end)

    def collect_multi(self, handle, ddb):
        """One device->host copy of the group's rows; returns per-query
        lists of (Block, {col: [n] array}) pairs (score[, end_q, end_t])."""
        rows, seg_qs, _, track_end = handle
        n_q = len(seg_qs)
        result = [[] for _ in range(n_q)]
        if rows is None:
            return result
        tr = rows.cpu().numpy()
        for bi, blk in enumerate(ddb.blocks):
            for s in range(n_q):
                cols = {"score": tr[bi, s, :blk.n]}
                if track_end:
                    cols["end_q"] = tr[bi, n_q + s, :blk.n]
                    cols["end_t"] = tr[bi, 2 * n_q + s, :blk.n]
                result[s].append((blk, cols))
        return result
