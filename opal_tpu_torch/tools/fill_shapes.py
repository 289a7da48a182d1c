"""Groups of device-fill lanes at the shapes that the kernel's column
wavefront makes hard (engine/csrc/device_fill.cu: one warp per lane, strips
of R = 16 or 32 rows, 32 strips a pass).

Each lane is a reversed-prefix problem as align_winners_device packs it:
random letters, with the target's first `plant` letters a copy of the
query's (a run along the diagonal, so SW stops where the run ends). Its
limit is the score the plain version finds with no stop ("exact"), one
above it (the guard never trips: ok is False) or one below it (the max
passes the limit: ok is False). The shapes: tlen 1, 31 and 33; qlen at 16,
32 x 16, 32 x 16 + 1, 32 x 32 and 32 x 32 + 1 (a last pass of one row);
bands 1-3 rows wide; SW stops within 31 columns of tlen and far from it.

tests/test_torch_fill_shapes.py holds the plain version against opal_tpu
on these groups; tests/test_torch_cuda.py and chip_smoke.py hold the
kernel against the plain version on them, at R 16 and at plan_fill's R.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import MODE_HW, MODE_NW, MODE_OV, MODE_SW

# (qlen, tlen, bottom, top, plant, limit)
SHORT = (
    (16, 1, 15, 0, 1, "exact"),     # one column
    (16, 31, 15, 30, 16, "exact"),  # qlen R, tlen 31
    (20, 33, 19, 32, 20, "exact"),  # tlen 33, a stop 13 columns from it
    (9, 33, 0, 0, 9, "exact"),      # a band one row wide
    (12, 31, 1, 0, 12, "exact"),    # two rows wide
    (16, 33, 1, 1, 0, "exact"),     # three rows wide, no run
    (16, 31, 15, 30, 10, "below"),  # the max passes the limit
    (16, 33, 15, 32, 8, "above"),   # the limit is never reached
)
TALL = (
    (512, 120, 511, 119, 100, "exact"),    # 32 x 16 rows; SW stops near tlen
    (513, 200, 3, 3, 60, "exact"),         # one row past; SW stops far
    (1024, 120, 40, 40, 100, "below"),     # 32 x 32 rows
    (1025, 150, 1024, 149, 130, "below"),  # one row past
    (1025, 90, 1, 1, 60, "exact"),         # a narrow band, 2 or 3 passes
    (700, 64, 2, 0, 0, "above"),
)
# (name, lanes, mode, go, ge): six groups, one launch each
GROUPS = (
    ("short_sw", SHORT, MODE_SW, 3, 1),
    ("tall_sw", TALL, MODE_SW, 5, 5),
    ("mixed_nw", SHORT + TALL, MODE_NW, 10, 2),
    ("mixed_hw", SHORT + TALL, MODE_HW, 3, 1),
    ("mixed_ov", SHORT + TALL, MODE_OV, 7, 3),
    ("mixed_sw", SHORT + TALL, MODE_SW, 1, 1),
)
NO_LIMIT = 1 << 27


def edge_groups(matrix, seed=9, device="cuda"):
    """[(name, mode, go, ge, jobs)]: each group's lanes as pack_group's jobs
    (index, limit, aq, at, bottom, top), their limits set from the plain
    version on `device` (exact int32: the same on every device)."""
    from ..engine import device_fill

    A = matrix.shape[0]
    rng = np.random.default_rng(seed)
    device = torch.device(device)
    mat = torch.from_numpy(np.ascontiguousarray(matrix, np.int32)).to(device)
    out = []
    for name, lanes, mode, go, ge in GROUPS:
        jobs = []
        for i, (ql, tl, bottom, top, plant, _) in enumerate(lanes):
            aq = rng.integers(0, A - 4, size=ql).astype(np.uint8)
            at = rng.integers(0, A - 4, size=tl).astype(np.uint8)
            at[:plant] = aq[:plant]
            jobs.append((i, NO_LIMIT, aq, at, bottom, top))
        args = device_fill.pack_group(jobs, device)
        score = device_fill.fill_walk_plain(*args, go, ge, mat, mode)[0]
        shift = {"exact": 0, "above": 1, "below": -1}
        jobs = [j[:1] + (int(s) + shift[lane[5]],) + j[2:]
                for j, s, lane in zip(jobs, score.tolist(), lanes)]
        out.append((name, mode, go, ge, jobs))
    return out
