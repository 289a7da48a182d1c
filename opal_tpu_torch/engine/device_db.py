"""Resident database: the length-sorted blocks, uploaded to the device once.

Searching many queries against one upload is the production serving model
and amortises the host->device copy. Letters (int8) and lengths (int32)
live on the device in the layout the ragged_dp kernel reads
(kernels.Stream), in parts: one part on the engine's device, or, with a
mesh (parallel/shard.py), one part per mesh device, each a contiguous run
of the length-sorted blocks (split_blocks). The backend launches each
part's kernels on the part's device and joins the results in block order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import kernels
from .batching import Block, plan_blocks


def split_blocks(blocks: Sequence[Block], n_parts: int) -> list:
    """Cut the length-sorted blocks into n_parts contiguous groups of about
    equal cost, a block's cost being its padded columns x lanes (the cells
    per query row its lanes could need). The cut rule is opal_tpu's
    (DeviceDatabase.flat_sharded): group j ends after the block whose
    prefix cost first reaches (j + 1) / n_parts of the total, so equal
    blocks give one block per part. Groups may be empty when there are
    fewer blocks than parts."""
    cost = np.array([b.letters.shape[0] * b.letters.shape[1]
                     for b in blocks], np.int64)
    prefix = np.cumsum(cost)
    total = int(prefix[-1]) if len(prefix) else 0
    groups, lo = [], 0
    for j in range(1, n_parts):
        c = int(np.searchsorted(prefix, total * j / n_parts))
        cut = min(max(c + 1, lo), len(blocks))
        groups.append(list(blocks[lo:cut]))
        lo = cut
    groups.append(list(blocks[lo:]))
    return groups


@dataclasses.dataclass
class Part:
    """A contiguous run of the database's blocks, resident on one device."""
    blocks: list               # [Block], in the database's block order
    stream: kernels.Stream     # their letters and lengths on the device
    _lane_indices: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.stream.letters.device

    @property
    def lane_indices(self) -> torch.Tensor:
        """[NB, B] int32 on the part's device: the (global) DB index of
        each lane, -1 for padding lanes (engine/ranked.py's selection
        key). Uploaded at first use and kept."""
        if self._lane_indices is None:
            B = self.stream.lengths.shape[1]
            idx = np.full((len(self.blocks), B), -1, np.int32)
            for bi, blk in enumerate(self.blocks):
                idx[bi, :blk.n] = blk.indices
            self._lane_indices = torch.from_numpy(idx).to(self.device)
        return self._lane_indices


class DeviceDatabase:
    """Length-bucketed, padded DB blocks with letters/lengths on device.

    Without a mesh the blocks form one part on `device`; with one, part i
    (split_blocks) lives on mesh.devices[i] and `device` is not used."""

    def __init__(self, db: Sequence[np.ndarray], block_size: int, device,
                 mesh=None):
        self.n = len(db)
        self.raw = db  # kept for partial rescoring
        self.block_size = block_size
        self.blocks: list[Block] = plan_blocks(db, block_size)
        self.total_residues = int(sum(len(s) for s in db))
        self.max_len = max((len(s) for s in db), default=0)
        # largest letter index, checked against the matrix at search time
        self.max_letter = (int(np.concatenate(db).max())
                           if self.total_residues else -1)
        if mesh is None:
            groups, devices = [self.blocks], [device]
        else:
            groups, devices = split_blocks(self.blocks, mesh.size), \
                mesh.devices
        self.parts = [Part(g, kernels.pack_stream(
            [b.letters for b in g], [b.lengths for b in g], block_size, d))
            for g, d in zip(groups, devices)]

    @property
    def device(self) -> torch.device:
        """The first part's device (the mesh's first device)."""
        return self.parts[0].device

    @property
    def stream(self) -> kernels.Stream:
        """The whole database's stream, when it is in one part."""
        if len(self.parts) != 1:
            raise ValueError(f"the database is in {len(self.parts)} parts; "
                             "use .parts")
        return self.parts[0].stream

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
