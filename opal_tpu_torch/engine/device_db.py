"""Resident database: the length-sorted blocks, uploaded to the device once.

Searching many queries against one upload is the production serving model
and amortises the host->device copy. Letters (int8) and lengths (int32)
live on the engine's device in the layout the ragged_dp kernel reads
(kernels.Stream).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import kernels
from .batching import Block, plan_blocks


class DeviceDatabase:
    """Length-bucketed, padded DB blocks with letters/lengths on device."""

    def __init__(self, db: Sequence[np.ndarray], block_size: int, device):
        self.n = len(db)
        self.raw = db  # kept for partial rescoring
        self.block_size = block_size
        self.blocks: list[Block] = plan_blocks(db, block_size)
        self.total_residues = int(sum(len(s) for s in db))
        self.max_len = max((len(s) for s in db), default=0)
        # largest letter index, checked against the matrix at search time
        self.max_letter = (int(np.concatenate(db).max())
                           if self.total_residues else -1)
        self.stream = kernels.pack_stream(
            [b.letters for b in self.blocks],
            [b.lengths for b in self.blocks], block_size, device)
        self._lane_indices = None

    @property
    def device(self):
        return self.stream.letters.device

    @property
    def lane_indices(self):
        """[NB, B] int32 on the device: the DB index of each lane, -1 for
        padding lanes (engine/ranked.py's selection key). Uploaded at
        first use and kept."""
        if self._lane_indices is None:
            idx = np.full((len(self.blocks), self.block_size), -1, np.int32)
            for bi, blk in enumerate(self.blocks):
                idx[bi, :blk.n] = blk.indices
            self._lane_indices = torch.from_numpy(idx).to(self.device)
        return self._lane_indices

    def __len__(self) -> int:
        return self.n


def stream_from_jax_numpy(blocks, meta, letters, lengths,
                          device) -> kernels.Stream:
    """opal_tpu's host chunk stream -> this port's resident layout.

    Takes what opal_tpu.engine.device_db.DeviceDatabase._build_stream_np
    returns for `blocks` (its Block list): meta [6, C] int32 with rows
    (block, first, last, t0, active, ncols), letters [C, 64, B] int8 and
    lengths [NB_pad, 1, B] int32, all numpy. Inert padding chunks
    (active == 0) and padding block rows are dropped."""
    meta = np.asarray(meta)
    letters = np.asarray(letters)
    nb = len(blocks)
    B = letters.shape[2]
    chunks = [[] for _ in range(nb)]
    t_pad = [0] * nb
    for c in np.nonzero(meta[4] == 1)[0]:
        b = int(meta[0, c])
        chunks[b].append(letters[c])
        if meta[2, c] == 1:  # the block's last chunk: t0 + its real columns
            t_pad[b] = int(meta[3, c] + meta[5, c])
    block_letters = []
    for b in range(nb):
        if t_pad[b] != blocks[b].letters.shape[0]:
            raise ValueError(f"block {b}: stream holds {t_pad[b]} columns, "
                             f"the block {blocks[b].letters.shape[0]}")
        block_letters.append(np.concatenate(chunks[b])[: t_pad[b]])
    return kernels.pack_stream(
        block_letters, np.asarray(lengths)[:nb, 0], B, device)
