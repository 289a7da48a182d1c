"""The database search over several processes (a port of opal_tpu's
parallel/multihost.py), merged over torch.distributed.

The database is sharded over processes (one per host, or several sharing
a card), the query goes to every process, each searches its own shard on
its local devices (a mesh of them through Engine(mesh=...)), and the
per-sequence results merge with an all-gather into one global ranking,
identical on every process.

Usage (one process per host; the caller initialises the process group):

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="env://")
    from opal_tpu_torch.parallel.multihost import MultiHostSearch

    mh = MultiHostSearch(db_paths=all_shard_paths, matrix=sm)
    ranked = mh.ranked(query, top_k=10)

Without a process group there is one process. Each process reads only its
own FASTA shards (shard_for_process deals the path list round-robin by
rank). The merge all-gathers fixed-width int32 records: the score alone for
score-only searches, (score, end_q, end_t) with ends; a global top k
gathers only each process's k device-selected records, and
search_aligned one more fixed-width table of the winners' paths, each
process aligning only its own winners.

The tables go through dist.all_gather as equal-shape int32 tensors: on the
CPU under gloo, on the process's current CUDA device under NCCL.

Run one process of a multi-process search:

    python -m opal_tpu_torch.parallel.multihost --init-method
        tcp://localhost:PORT --rank R --world-size N --query q.fa
        --out result.json [--device cpu] [--mesh PARTS]
        [--block-size 1024] shard.fa ...

It joins a gloo process group, runs ranked top 10 at score and at score +
end, and search_aligned top 5, and writes them as JSON to OUT.R, with the
process's kernel launches and plain-version calls (kernels.LAUNCHES,
kernels.PLAIN_CALLS).
"""
from __future__ import annotations

import argparse
import datetime
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import MODE_SW, SEARCH_SCORE, SEARCH_SCORE_END
from ..engine import kernels
from ..engine.search import Engine, search_database_arrays
from ..fasta import read_fasta_file

SCORE_PAD = np.iinfo(np.int32).min  # padding rows sort last


def shard_for_process(paths: Sequence[str], process_index: int,
                      process_count: int) -> list[str]:
    """Round-robin assignment of DB shard files to processes."""
    return [p for i, p in enumerate(paths)
            if i % process_count == process_index]


def _process_group():
    """(rank, world size) of the caller's process group, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather(arr: np.ndarray) -> np.ndarray:
    """Every process's int32 array of one shape -> [world, *shape]."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def allgather_records(local: np.ndarray, max_len: int) -> np.ndarray:
    """All-gather per-process [n, k] int32 record tables (padded to
    max_len rows with SCORE_PAD) across processes; returns
    [process_count, max_len, k]."""
    k = local.shape[1]
    padded = np.full((max_len, k), SCORE_PAD, np.int32)
    padded[: len(local)] = local
    return _allgather(padded)


class MultiHostSearch:
    def __init__(self, db_paths: Sequence[str], matrix, gap_open: int = 3,
                 gap_ext: int = 1, engine: Optional[Engine] = None,
                 local_mesh=None, device="cuda"):
        self.matrix = matrix
        self.gap_open = gap_open
        self.gap_ext = gap_ext
        self.process_index, self.process_count = _process_group()
        self.local_paths = shard_for_process(
            list(db_paths), self.process_index, self.process_count)
        lut = (matrix.letter_index() if hasattr(matrix, "letter_index")
               else None)
        self._matrix_array = (matrix.matrix if hasattr(matrix, "matrix")
                              else np.asarray(matrix))
        self.db = []
        for p in self.local_paths:
            seqs, _ = read_fasta_file(p, lut)
            self.db.extend(seqs)
        self.engine = engine or Engine(device=device, mesh=local_mesh)
        self.ddb = self.engine.upload(self.db) if self.db else None
        # fixed gather width: the largest shard over the processes
        if self.process_count > 1:
            self.shard_sizes = [int(x) for x in _allgather(
                np.array([len(self.db)], np.int32)).reshape(-1)]
        else:
            self.shard_sizes = [len(self.db)]
        self.max_local = max(self.shard_sizes)

    def _local_search(self, query, mode, search_type):
        """[n_local, k] int32 records: score (+ end_q, end_t for x1/x2)."""
        cols = (["score", "end_q", "end_t"]
                if search_type != SEARCH_SCORE else ["score"])
        if self.ddb is None:
            return np.zeros((0, len(cols)), np.int32)
        out = search_database_arrays(
            query, self.ddb, self.gap_open, self.gap_ext,
            self._matrix_array, mode=mode, search_type=search_type,
            engine=self.engine)
        return np.stack([out[c].astype(np.int32) for c in cols], axis=1)

    def search(self, query, mode: int = MODE_SW,
               search_type: int = SEARCH_SCORE):
        """Search every process's shard; returns (shard_sizes, records):
        records is [process_count, max_local, k] int32 (k = 1 for
        score-only, 3 for score+ends), identical on all processes; padding
        rows carry SCORE_PAD."""
        local = self._local_search(query, mode, search_type)
        if self.process_count == 1:
            full = np.full((1, self.max_local, local.shape[1]), SCORE_PAD,
                           np.int32)
            full[0, : len(local)] = local
            return self.shard_sizes, full
        return self.shard_sizes, allgather_records(local, self.max_local)

    def _rank(self, table):
        """(score desc, shard asc, index asc) over the gathered table, by
        one lexsort."""
        P, M = table.shape[:2]
        scores = table[:, :, 0].reshape(-1).astype(np.int64)
        shard = np.repeat(np.arange(P, dtype=np.int64), M)
        idx = np.tile(np.arange(M, dtype=np.int64), P)
        valid = idx < np.asarray(self.shard_sizes, np.int64)[shard]
        order = np.lexsort((idx, shard, -scores))
        return order[valid[order]], scores, shard, idx

    def _global_topk(self, query, mode, search_type, k):
        """Global top-k records through each process's device top-k
        (engine/ranked.py): each process gathers only k records. Exact:
        each process's k records hold its local top k, and the global top
        k is a subset of their union. Returns (score, shard, index[,
        end_q, end_t]) tuples, identical on every process."""
        if k <= 0:
            return []
        track_end = search_type != SEARCH_SCORE
        cols = ["score", "end_q", "end_t"] if track_end else ["score"]
        if self.ddb is None:
            local = np.zeros((0, 1 + len(cols)), np.int32)
        else:
            out = search_database_arrays(
                query, self.ddb, self.gap_open, self.gap_ext,
                self._matrix_array, mode=mode, search_type=search_type,
                engine=self.engine, top_k=k)
            local = np.stack(
                [out[c].astype(np.int32) for c in cols]
                + [out["index"].astype(np.int32)], axis=1)
        if self.process_count > 1:
            table = allgather_records(local, k)
        else:
            table = np.full((1, k, local.shape[1]), SCORE_PAD, np.int32)
            table[0, : len(local)] = local
        P, M, W = table.shape
        scores = table[:, :, 0].reshape(-1).astype(np.int64)
        idx = table[:, :, W - 1].reshape(-1).astype(np.int64)
        shard = np.repeat(np.arange(P, dtype=np.int64), M)
        valid = idx >= 0  # padding rows carry SCORE_PAD in every column
        order = np.lexsort((idx, shard, -scores))
        order = order[valid[order]][:k]
        flat = table.reshape(-1, W)
        rows = []
        for o in order.tolist():
            base = (int(scores[o]), int(shard[o]), int(idx[o]))
            if track_end:
                base += (int(flat[o, 1]), int(flat[o, 2]))
            rows.append(base)
        return rows

    def ranked(self, query, mode: int = MODE_SW, top_k: int = 0,
               search_type: int = SEARCH_SCORE):
        """Globally ranked records, identical on every process. Each row is
        (score, shard, index-in-shard), plus (end_q, end_t) when
        search_type tracks ends. top_k > 0 takes the device-ranked path
        (k records per process cross the process group); top_k == 0
        gathers the full per-sequence tables."""
        if top_k:
            return self._global_topk(query, mode, search_type, top_k)
        _, table = self.search(query, mode=mode, search_type=search_type)
        order, scores, shard, idx = self._rank(table)
        ends = table.reshape(-1, table.shape[2])[order]
        rows = []
        for j, o in enumerate(order.tolist()):
            base = (int(scores[o]), int(shard[o]), int(idx[o]))
            if table.shape[2] == 3:
                base += (int(ends[j, 1]), int(ends[j, 2]))
            rows.append(base)
        return rows

    @staticmethod
    def _pack_ops_rows(local_ops, n_rows, width):
        """Per-winner alignment records as fixed-width int32 rows
        [start_q, start_t, op_len, ops...]; -2 marks a winner another
        process owns, op_len -1 one without a path. One packer serves the
        gathered and the one-process branch alike."""
        buf = np.full((n_rows, 3 + width), -2, np.int32)
        for j, (sq, st, ops) in local_ops.items():
            n = 0 if ops is None else len(ops)
            buf[j, :3] = (sq, st, n if ops is not None else -1)
            if n:
                buf[j, 3: 3 + n] = ops
        return buf

    def search_aligned(self, query, mode: int = MODE_SW, top_k: int = 10):
        """Global top-k full-alignment search: one score+end pass over every
        shard, a global ranking, then each process reconstructs the paths
        of its own winners only; the paths merge with one fixed-width
        all-gather. Returns ranked dicts (identical on every process)
        {score, shard, index, end_q, end_t, start_q, start_t, ops}, ops a
        uint8 array (None where there is no path or SW scores 0)."""
        from ..traceback import AlignmentError, align_pair_reverse_trick

        query = np.asarray(query, dtype=np.uint8)
        rows = self._global_topk(query, mode, SEARCH_SCORE_END, top_k)
        winners = [dict(score=r[0], shard=r[1], index=r[2], end_q=r[3],
                        end_t=r[4]) for r in rows]
        local_ops = {}
        for j, w in enumerate(winners):
            if w["shard"] != self.process_index:
                continue
            if mode == MODE_SW and w["score"] == 0:
                # reference: src/opal.cpp:1479-1483 (no path for score 0)
                local_ops[j] = (-1, -1, None)
                continue
            try:
                sq, st, ops = align_pair_reverse_trick(
                    query, self.db[w["index"]], self.gap_open,
                    self.gap_ext, self._matrix_array, w["score"],
                    w["end_q"], w["end_t"], mode)
                local_ops[j] = (sq, st, np.asarray(ops, np.uint8))
            except AlignmentError:
                local_ops[j] = (-1, -1, None)

        width = max((0 if o is None else len(o)
                     for _, _, o in local_ops.values()), default=0)
        if self.process_count > 1:
            # fixed gather width: the longest path over the processes
            width = int(_allgather(np.array([width], np.int32)).max())
            gathered = _allgather(self._pack_ops_rows(
                local_ops, len(winners), width))
            merged = gathered[np.asarray([w["shard"] for w in winners],
                                         np.int64),
                              np.arange(len(winners))]
        else:
            merged = self._pack_ops_rows(local_ops, len(winners), width)

        for j, w in enumerate(winners):
            sq, st, n = (int(merged[j, 0]), int(merged[j, 1]),
                         int(merged[j, 2]))
            w["start_q"], w["start_t"] = sq, st
            w["ops"] = (merged[j, 3: 3 + n].astype(np.uint8)
                        if n >= 0 else None)
            if mode == MODE_SW and w["score"] == 0:
                w["end_q"] = w["end_t"] = -1
        return winners


def main(argv=None) -> int:
    from ..matrices import ScoreMatrix
    from .shard import db_mesh

    ap = argparse.ArgumentParser(
        description="one process of a multi-process database search")
    ap.add_argument("--init-method", required=True,
                    help="torch.distributed init method, e.g. "
                    "tcp://localhost:PORT")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--query", required=True, help="FASTA; its first "
                    "sequence is searched")
    ap.add_argument("--out", required=True, help="writes OUT.<rank>")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mesh", type=int, default=0,
                    help="parts of the local database on the device")
    ap.add_argument("--block-size", type=int, default=1024)
    ap.add_argument("shards", nargs="+", help="FASTA shards, all of them")
    a = ap.parse_args(argv)

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=a.init_method,
                            rank=a.rank, world_size=a.world_size,
                            timeout=datetime.timedelta(seconds=60))
    try:
        sm = ScoreMatrix.blosum50()
        mesh = db_mesh([a.device] * a.mesh) if a.mesh else None
        mh = MultiHostSearch(db_paths=a.shards, matrix=sm, gap_open=3,
                             gap_ext=1, engine=Engine(
                                 device=a.device, block_size=a.block_size,
                                 mesh=mesh))
        qs, _ = read_fasta_file(a.query, sm.letter_index())
        out = {"ranked": mh.ranked(qs[0], top_k=10),
               "ranked_ends": mh.ranked(qs[0], top_k=10,
                                        search_type=SEARCH_SCORE_END),
               "aligned": mh.search_aligned(qs[0], top_k=5),
               "sizes": mh.shard_sizes,
               "launches": dict(kernels.LAUNCHES),
               "plain_calls": dict(kernels.PLAIN_CALLS)}
        for w in out["aligned"]:
            w["ops"] = None if w["ops"] is None else w["ops"].tolist()
        with open(f"{a.out}.{a.rank}", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
