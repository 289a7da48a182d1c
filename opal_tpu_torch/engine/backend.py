"""Backend: queries against a resident database through the DP kernels.

It takes the places of opal_tpu's PallasBackend (on the card: the ragged_dp
kernel for one query, in query panels when it is taller than
kernels.PANEL_ROWS, the multi_dp kernel for a stacked group, one launch
over the whole database per query, panel or group, as kernels.plan_launch
lays it out) and XlaBackend (on the CPU: the plain
versions) with one protocol: prepare_query -> dispatch_many ->
collect_many for one query, supports_multi -> dispatch_multi ->
collect_multi for a group. Which one runs follows from the device the
database lives on; nothing falls back from one to the other.

Three environment knobs of opal_tpu, read at each dispatch, steer the
route of one query (panel_plan) and never its result:
OPAL_TPU_FORCE_PANELS=1 runs every single-query search in panels,
OPAL_TPU_NO_PANELS=1 runs a query of any height in one sweep (it wins over
FORCE_PANELS, as in opal_tpu), and OPAL_TPU_PANEL_ROWS=<n> sets the panel
height in place of kernels.PANEL_ROWS, which stays the threshold.

A database is resident in parts (engine/device_db.py: one, or one per
mesh device). Every part's launch is enqueued, on the part's device,
before the first result is fetched; handles hold one entry per part (None
for a part without blocks, which is never launched), and results join in
block order.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..constants import SEARCH_SCORE
from . import kernels

# What ragged_dp, multi_dp and their plain versions keep exact in int32.
# Let M = max |matrix entry|, Q the query's rows, T the longest target.
# - Upwards: a cell's H is the best path to it, at most Q * M; the diagonal
#   candidate H[r-1] + P likewise. The plain versions' F prefix adds its
#   ramp (row * ge) on top. So Q * (M + ge) < 2^31 (UPPER_BOUND).
# - Downwards: H is at least the gap-only path to its cell, -2 go - (Q + T)
#   ge, in every mode; E and F are at most go below H. E and F start at the
#   sentinel NEG = -2^30 and fall from it by ge once (NEG - ge) before the
#   first real H - go replaces them. Real values stay above that fall when
#   3 go + (Q + T + 1) ge < 2^30 (LOWER_BOUND = -NEG); the NW walls
#   (-go - r ge, -go - t ge) are gap-only paths and lie inside too.
# - The diagonal candidate reaches H - M on a real row and H + PAD_NEG
#   (-2^20) on a padding row: with H above -2^30 it stays above -2^31 when
#   M < 2^30 (LOWER_BOUND again).
# Scores may therefore exceed 2^30 upwards, never reach -2^30 downwards.
UPPER_BOUND = 2**31
LOWER_BOUND = 2**30


@dataclasses.dataclass
class PanelRows:
    """A long query's live result: one tracker-row tensor per panel."""
    rows: list
    panels: tuple    # ((row0, rows), ...), kernels.plan_panels


def panels_forced() -> bool:
    return (os.environ.get("OPAL_TPU_FORCE_PANELS") == "1"
            and os.environ.get("OPAL_TPU_NO_PANELS") != "1")


def panel_rows() -> int:
    """The panel height: OPAL_TPU_PANEL_ROWS, else kernels.PANEL_ROWS.
    A height that is not a positive multiple of kernels.STRIP_ROWS
    raises."""
    env = os.environ.get("OPAL_TPU_PANEL_ROWS")
    if not env:
        return kernels.PANEL_ROWS
    try:
        rows = int(env)
    except ValueError:
        rows = 0
    if rows < kernels.STRIP_ROWS or rows % kernels.STRIP_ROWS:
        raise ValueError(f"OPAL_TPU_PANEL_ROWS={env!r}: a panel is a "
                         f"positive number of whole {kernels.STRIP_ROWS}-row "
                         "strips")
    return rows


def panel_plan(Q: int):
    """The panels ((row0, rows), ...) a Q-row query runs in, or None for
    one sweep: panels when it is taller than kernels.PANEL_ROWS or
    OPAL_TPU_FORCE_PANELS=1, one sweep under OPAL_TPU_NO_PANELS=1."""
    if os.environ.get("OPAL_TPU_NO_PANELS") == "1":
        return None
    if Q <= kernels.PANEL_ROWS and not panels_forced():
        return None
    return kernels.plan_panels(Q, panel_rows())


def finalize_handle(handle, part, mode, search_type, Q, with_flags=False):
    """One part's entry of dispatch_many's handle -> {column: [NB, B]
    int32} on the part's device (kernels.finalize_device, or the panel
    merge for a PanelRows)."""
    if isinstance(handle, PanelRows):
        return kernels.finalize_panels_device(
            handle.rows, handle.panels, part.stream.lengths, mode,
            search_type, with_flags)
    return kernels.finalize_device(handle, part.stream.lengths, mode,
                                   search_type, Q, with_flags)


def replicate(profile: torch.Tensor, ddb) -> dict:
    """{device: the profile on it} for each distinct device of the
    database's parts, one copy each (none on the profile's own device)."""
    out = {profile.device: profile}
    for part in ddb.parts:
        if part.device not in out:
            out[part.device] = profile.to(part.device)
    return out


class RaggedBackend:
    name = "ragged"

    def __init__(self, device):
        self.device = torch.device(device)

    def supports(self, Q: int, gap_open: int, gap_ext: int, A: int,
                 profile_absmax: int = 0, max_len: int = 0) -> bool:
        """Can the kernel take this search exactly? Any query length, any
        gap pair; int8 letters, and DP values inside the int32 range the
        kernels keep exact (UPPER_BOUND, LOWER_BOUND)."""
        go, ge, M = abs(gap_open), abs(gap_ext), abs(profile_absmax)
        return (
            Q >= 1
            and A <= kernels.MAX_ALPHABET
            and Q * (M + ge) < UPPER_BOUND
            and 3 * go + (Q + max_len + 1) * ge < LOWER_BOUND
            and M < LOWER_BOUND
        )

    def supports_multi(self, queries, gap_open, gap_ext, A, matrix,
                       max_len=0) -> bool:
        """Can these queries run as one stacked multi_dp launch? At most
        MULTI_MAX_SEGS of them, each within `supports` (the tallest decides
        the value bound) and none taller than kernels.PANEL_ROWS: a long
        query runs alone, in panels, as in opal_tpu (in one sweep under
        OPAL_TPU_NO_PANELS). Under OPAL_TPU_FORCE_PANELS nothing stacks:
        every query runs alone in panels. Any gap pair: the kernel's F
        chain is exact for all of them. The grouping decides launches
        only, never results."""
        return (0 < len(queries) <= kernels.MULTI_MAX_SEGS
                and not panels_forced()
                and min(len(q) for q in queries) >= 1
                and max(len(q) for q in queries) <= kernels.PANEL_ROWS
                and self.supports(max(len(q) for q in queries), gap_open,
                                  gap_ext, A, int(np.abs(matrix).max()),
                                  max_len))

    def prepare_query(self, qprofile: np.ndarray, gap_open, gap_ext):
        """qprofile [A, Q] -> the kernel's [Q, W] int32 profile on the
        engine's device (dispatch replicates it to the parts' devices)."""
        return torch.from_numpy(kernels.build_profile(qprofile)).to(
            self.device)

    def dispatch_many(self, profile, ddb, gap_open, gap_ext, mode,
                      search_type, with_flags=False):
        """Enqueue the whole database, part by part; returns the handle,
        per part: the device tracker rows (with the overflow-flag rows
        when with_flags), a PanelRows for a query that runs in panels
        (panel_plan: the row count and the knobs decide, the card has no
        VMEM gate), or None for a part without blocks."""
        profiles = replicate(profile, ddb)
        panels = panel_plan(profile.shape[0])
        handle = []
        for part in ddb.parts:
            args = (profiles[part.device], part.stream, mode, search_type,
                    int(gap_open), int(gap_ext), with_flags)
            if not part.blocks:
                handle.append(None)
            elif panels is not None:
                handle.append(PanelRows(
                    kernels.ragged_panel_score(*args, panels=panels),
                    panels))
            else:
                handle.append(kernels.ragged_score(*args))
        return handle

    def collect_many(self, handle, ddb, mode, search_type, Q,
                     with_flags=False):
        """Finalize each part's rows on its device, then one device->host
        copy per part; returns [(Block, {col: [n] array}), ...] over all
        DB blocks in block order (the flag columns too when with_flags)."""
        finals = [(part, finalize_handle(h, part, mode, search_type, Q,
                                         with_flags))
                  for h, part in zip(handle, ddb.parts) if h is not None]
        out = []
        for part, cols in finals:
            host = torch.stack(list(cols.values()), dim=1).cpu().numpy()
            out += [(blk, {k: host[bi, j, :blk.n]
                           for j, k in enumerate(cols)})
                    for bi, blk in enumerate(part.blocks)]
        return out

    def dispatch_multi(self, qprofiles, ddb, gap_open, gap_ext, mode,
                       search_type):
        """Enqueue one stacked pass of the group (qprofile [A, Q_s] each;
        the caller has checked supports_multi), part by part. Returns the
        handle ([rows or None per part], seg_qs, mode, track_end); rows
        stay on their part's device."""
        profile, seg_qs = kernels.prepare_profile_multi(qprofiles)
        profiles = replicate(torch.from_numpy(profile).to(self.device), ddb)
        rows = [kernels.multi_score(
            profiles[part.device], seg_qs, part.stream, mode, search_type,
            int(gap_open), int(gap_ext)) if part.blocks else None
            for part in ddb.parts]
        return (rows, seg_qs, mode, search_type != SEARCH_SCORE)

    def collect_multi(self, handle, ddb):
        """One device->host copy of the group's rows per part; returns
        per-query lists of (Block, {col: [n] array}) pairs (score[, end_q,
        end_t]) in block order."""
        rows, seg_qs, _, track_end = handle
        n_q = len(seg_qs)
        result = [[] for _ in range(n_q)]
        for part_rows, part in zip(rows, ddb.parts):
            if part_rows is None:
                continue
            tr = part_rows.cpu().numpy()
            for bi, blk in enumerate(part.blocks):
                for s in range(n_q):
                    cols = {"score": tr[bi, s, :blk.n]}
                    if track_end:
                        cols["end_q"] = tr[bi, n_q + s, :blk.n]
                        cols["end_t"] = tr[bi, 2 * n_q + s, :blk.n]
                    result[s].append((blk, cols))
        return result
