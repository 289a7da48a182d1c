"""Top-level database search: the public API of the engine.

Mirrors opal_tpu/engine/search.py (itself the contract of the reference's
``opalSearchDatabase``, src/opal.h:150-154): dispatch on mode (SW / NW / HW
/ OV) and search type, and the skip semantics: sequences whose passed-in
results already carry a score (and end location when needed) are not
recomputed (src/opal.cpp:1446-1451).

The port covers score (search_type 0) and score + end (1), for one query
(the ragged_dp kernel) and for many (search_database_multi_arrays: stacked
groups through the multi_dp kernel), with the top k selected on the device
(engine/ranked.py). Full alignment (2) and the adaptive precision cascade
raise NotImplementedError until their slices land (ROADMAP.md, queue A).

Every entry point runs on the engine's device, "cuda" unless the caller
asks for "cpu"; without CUDA the default engine raises.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_ALIGNMENT,
    SEARCH_SCORE,
)
from ..result import SearchResult
from . import kernels, ranked
from .backend import RaggedBackend
from .device_db import DeviceDatabase


def _db_fingerprint(db) -> bytes:
    """Cheap content fingerprint of a sequence list: the count plus the
    full bytes of a deterministic ~17-sequence sample (first, last, evenly
    strided)."""
    h = hashlib.blake2b(digest_size=16)
    n = len(db)
    h.update(n.to_bytes(8, "little"))
    if n:
        step = max(1, n // 16)
        for i in sorted({*list(range(0, n, step))[:16], n - 1}):
            a = np.asarray(db[i])
            h.update(i.to_bytes(8, "little"))
            h.update(int(a.shape[0]).to_bytes(8, "little"))
            h.update(a.tobytes())
    return h.digest()


# Resident DeviceDatabases kept per Engine (LRU)
_RESIDENT_LRU_SIZE = 4


def resolve_device(device) -> torch.device:
    """torch.device for an engine; CUDA must be present when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch version on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


@dataclasses.dataclass
class EngineConfig:
    device: str = "cuda"
    block_size: int = 1024    # sequences per scored block (lanes)
    precision: str = "int32"  # "adaptive" comes with the cascade slice


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None, **kw):
        self.config = config or EngineConfig(**kw)
        if self.config.precision != "int32":
            raise NotImplementedError(
                f"precision={self.config.precision!r}: the adaptive cascade "
                "comes with a later slice of the port (ROADMAP.md A.8)")
        self.device = resolve_device(self.config.device)
        self._backend = RaggedBackend(self.device)
        # Bounded LRU of resident DeviceDatabases (most-recent last)
        self._resident_cache: "collections.OrderedDict" = (
            collections.OrderedDict())

    def upload(self, db: Sequence[np.ndarray]) -> DeviceDatabase:
        """Upload the DB to the device once (resident-database mode)."""
        return DeviceDatabase(db, self.config.block_size, self.device)

    def _get_resident(self, db) -> DeviceDatabase:
        if isinstance(db, DeviceDatabase):
            if db.device != self.device:
                raise ValueError(f"database is resident on {db.device}, "
                                 f"the engine runs on {self.device}")
            return db
        # Keyed by id() AND a sampled content fingerprint, so a list
        # mutated in place is not served stale
        key = (id(db), _db_fingerprint(db))
        cached = self._resident_cache.get(key)
        if cached is None:
            cached = DeviceDatabase(db, self.config.block_size, self.device)
            self._resident_cache[key] = cached
            while len(self._resident_cache) > _RESIDENT_LRU_SIZE:
                self._resident_cache.popitem(last=False)
        else:
            self._resident_cache.move_to_end(key)
        return cached

    def score_blocks(
        self,
        query: np.ndarray,
        db,
        gap_open: int,
        gap_ext: int,
        matrix: np.ndarray,
        mode: int,
        search_type: int,
        subset=None,
        top_k: int = 0,
    ):
        """Score (a subset of) the DB. Returns (indices, columns) where
        columns is a dict of per-index arrays (score [+ end_q/end_t]).
        top_k > 0: only the k best rows, ranked by (score desc, DB index
        asc); on the whole database they are selected on the device and
        only candidates are downloaded (engine/ranked.py), on a subset the
        host ranks them."""
        backend = self._backend
        matrix = np.asarray(matrix, dtype=np.int32)
        qprofile = np.ascontiguousarray(
            matrix[np.asarray(query, dtype=np.int64)].T)  # [A, Q]
        A, Q = qprofile.shape
        db_list = db.raw if isinstance(db, DeviceDatabase) else db
        if subset is None or len(subset) == len(db_list):
            ddb = self._get_resident(db)
            index_map = None
        else:
            # partial rescoring (skip semantics): ad-hoc upload
            index_map = np.fromiter(subset, dtype=np.int64)
            ddb = DeviceDatabase([db_list[i] for i in index_map],
                                 self.config.block_size, self.device)
        absmax = int(np.abs(qprofile).max()) if Q else 0
        if not backend.supports(Q, gap_open, gap_ext, A, absmax,
                                ddb.max_len):
            raise ValueError(
                f"search outside the kernel's range (Q={Q}, alphabet {A}, "
                f"|matrix| <= {absmax}, gaps {gap_open}/{gap_ext}, longest "
                f"target {ddb.max_len})")
        if ddb.max_letter >= A:
            raise ValueError(f"database letter {ddb.max_letter} outside the "
                             f"{A}-letter matrix")
        profile = backend.prepare_query(qprofile, gap_open, gap_ext)
        handle = backend.dispatch_many(profile, ddb, gap_open, gap_ext,
                                       mode, search_type)
        if top_k and index_map is None:
            out = ranked.topk_from_handle(handle, ddb, mode, search_type, Q,
                                          top_k)
            return out.pop("index"), out
        per_block = backend.collect_many(handle, ddb, mode, search_type, Q)
        all_idx = []
        cols: dict[str, list] = {}
        for blk, out in per_block:
            idxs = blk.indices if index_map is None else index_map[blk.indices]
            all_idx.append(idxs)
            for k, v in out.items():
                cols.setdefault(k, []).append(v)
        if not all_idx:
            return np.zeros(0, np.int64), {}
        idx = np.concatenate(all_idx)
        cols = {k: np.concatenate(v) for k, v in cols.items()}
        if top_k:
            from ..ranking import rank_rows

            return rank_rows(idx, cols, top_k)
        return idx, cols


def _finish_cols(out, mode, search_type, n=0):
    """Normalize a result-column dict in place: an empty database yields
    no blocks, hence no columns, so synthesize the expected (empty)
    arrays; then apply the reference's SW zero-score end masking (end
    locations report -1, src/opal_aligner.cpp semantics)."""
    if "score" not in out:
        out["score"] = np.zeros(n, np.int32)
    if search_type != SEARCH_SCORE:
        for k in ("end_q", "end_t"):
            if k not in out:
                out[k] = np.zeros(n, np.int32)
        if mode == MODE_SW:
            zero = out["score"] == 0
            out["end_q"] = np.where(zero, -1, out["end_q"])
            out["end_t"] = np.where(zero, -1, out["end_t"])
    return out


def search_database_arrays(
    query,
    db,
    gap_open: int = 3,
    gap_ext: int = 1,
    matrix=None,
    mode: int = MODE_SW,
    search_type: int = SEARCH_SCORE,
    engine: Optional[Engine] = None,
    top_k: int = 0,
):
    """Array-level search: returns a dict of [n] numpy arrays in DB order
    ("score" [+ "end_q"/"end_t"]).

    top_k > 0: returns the RANKED shape instead — {"index", "score"
    [, "end_q", "end_t"]} arrays of the k best sequences (score desc,
    index asc)."""
    if matrix is None:
        raise ValueError("matrix is required")
    if search_type == SEARCH_ALIGNMENT:
        raise NotImplementedError(_X2_LATER)
    engine = engine or get_default_engine()
    query = np.asarray(query, dtype=np.uint8)
    n = db.n if isinstance(db, DeviceDatabase) else len(db)
    if top_k:
        idx, cols = engine.score_blocks(
            query, db, gap_open, gap_ext, matrix, mode, search_type,
            top_k=top_k,
        )
        out = {"index": idx, **cols}
        return _finish_cols(out, mode, search_type)
    idx, cols = engine.score_blocks(
        query, db, gap_open, gap_ext, matrix, mode, search_type
    )
    out = {}
    for k, v in cols.items():
        arr = np.empty(n, dtype=v.dtype)
        arr[idx] = v
        out[k] = arr
    return _finish_cols(out, mode, search_type, n=n)


_X2_LATER = ("search_type=2 (full alignment) comes with a later slice of "
             "the port (ROADMAP.md A.7); scores and end locations are "
             "available with search_type 0/1")


def plan_groups(queries, fits):
    """Stacked groups of query positions, as opal_tpu forms them
    (opal_tpu/engine/search.py:359-434): a stable sort on the 16-quantized
    length, then groups grown along it while `fits(group)` holds, at most
    MULTI_MAX_SEGS each. A group of one runs on the single-query path."""
    perm = sorted(range(len(queries)),
                  key=lambda i: (len(queries[i]) + 15) // 16)
    groups, i = [], 0
    while i < len(perm):
        j = i + 1
        while (j < len(perm) and j - i < kernels.MULTI_MAX_SEGS
               and fits([queries[p] for p in perm[i:j + 1]])):
            j += 1
        groups.append(perm[i:j])
        i = j
    return groups


def search_database_multi_arrays(
    queries,
    db,
    gap_open: int = 3,
    gap_ext: int = 1,
    matrix=None,
    mode: int = MODE_SW,
    search_type: int = SEARCH_SCORE,
    engine: Optional[Engine] = None,
    top_k: int = 0,
):
    """Many queries against one database. Returns one array-dict per query
    (see search_database_arrays), in query order; top_k > 0 switches each
    to the ranked shape ({"index", "score"[, ends]} of the k best), selected
    on the device.

    Queries are grouped by length (plan_groups); each group of two or more
    runs as one stacked multi_dp pass per wave of blocks, a group of one
    through search_database_arrays. The grouping decides launches only: each
    query's result equals its own single-query search."""
    if matrix is None:
        raise ValueError("matrix is required")
    if search_type == SEARCH_ALIGNMENT:
        raise NotImplementedError(_X2_LATER)
    engine = engine or get_default_engine()
    backend = engine._backend
    queries = [np.asarray(q, dtype=np.uint8) for q in queries]
    ddb = engine._get_resident(db)
    matrix_np = np.asarray(matrix, dtype=np.int32)
    A = matrix_np.shape[0]

    def fits(group):
        return backend.supports_multi(group, gap_open, gap_ext, A, matrix_np,
                                      ddb.max_len)

    out: list = [None] * len(queries)
    for group in plan_groups(queries, fits):
        if len(group) == 1:
            out[group[0]] = search_database_arrays(
                queries[group[0]], ddb, gap_open, gap_ext, matrix_np,
                mode=mode, search_type=search_type, engine=engine,
                top_k=top_k)
            continue
        if ddb.max_letter >= A:
            raise ValueError(f"database letter {ddb.max_letter} outside the "
                             f"{A}-letter matrix")
        handle = backend.dispatch_multi(
            [np.ascontiguousarray(matrix_np[queries[p].astype(np.int64)].T)
             for p in group], ddb, gap_open, gap_ext, mode, search_type)
        if top_k:
            for p, cols in zip(group, ranked.topk_from_multi_handle(
                    handle, ddb, top_k)):
                out[p] = _finish_cols(cols, mode, search_type)
            continue
        for p, per_block in zip(group, backend.collect_multi(handle, ddb)):
            cols: dict = {}
            for blk, blk_cols in per_block:
                for k, v in blk_cols.items():
                    cols.setdefault(k, np.empty(ddb.n, np.int32))[
                        blk.indices] = v
            out[p] = _finish_cols(cols, mode, search_type, n=ddb.n)
    return out


_default_engine: Optional[Engine] = None


def get_default_engine() -> Engine:
    """A process-wide Engine() on "cuda" (raises without CUDA)."""
    global _default_engine
    if _default_engine is None:
        _default_engine = Engine()
    return _default_engine


def search_database(
    query,
    db,
    gap_open: int = 3,
    gap_ext: int = 1,
    matrix=None,
    mode: int = MODE_SW,
    search_type: int = SEARCH_SCORE,
    results: Optional[list[SearchResult]] = None,
    engine: Optional[Engine] = None,
) -> list[SearchResult]:
    """Search the database with the query; see module docstring.

    query: uint8 alphabet-index array. db: list of uint8 index arrays or a
    DeviceDatabase. matrix: [A, A] int array. results: optional pre-filled
    results to reuse (skip semantics). Returns the (possibly passed-in)
    list of SearchResult.
    """
    if mode not in (MODE_NW, MODE_HW, MODE_OV, MODE_SW):
        raise ValueError(f"invalid mode {mode}")
    if matrix is None:
        raise ValueError("matrix is required")
    if search_type == SEARCH_ALIGNMENT:
        raise NotImplementedError(_X2_LATER)
    engine = engine or get_default_engine()
    query = np.asarray(query, dtype=np.uint8)
    db_list = db.raw if isinstance(db, DeviceDatabase) else db
    n = len(db_list)
    track_end = search_type != SEARCH_SCORE
    if results is None:
        results = [SearchResult() for _ in range(n)]
        todo = np.arange(n)
    else:
        # Skip already-calculated sequences (reference:
        # src/opal.cpp:1446-1451).
        skip = np.array(
            [
                (not r.is_empty())
                and (
                    search_type == SEARCH_SCORE
                    or (r.end_location_query >= 0
                        and r.end_location_target >= 0)
                )
                for r in results
            ],
            dtype=bool,
        )
        todo = np.nonzero(~skip)[0]

    if todo.size:
        if todo.size == n:
            idx, cols = engine.score_blocks(
                query, db, gap_open, gap_ext, matrix, mode, search_type)
        else:
            idx, cols = engine.score_blocks(
                query, db_list, gap_open, gap_ext, matrix, mode, search_type,
                subset=todo)
        scores = cols["score"].tolist()
        end_qs = cols["end_q"].tolist() if track_end else None
        end_ts = cols["end_t"].tolist() if track_end else None
        for j, i in enumerate(idx.tolist()):
            r = results[i]
            r.score_set = 1
            r.score = scores[j]
            if track_end and not (mode == MODE_SW and scores[j] == 0):
                r.end_location_query = end_qs[j]
                r.end_location_target = end_ts[j]
            else:
                r.end_location_query = -1
                r.end_location_target = -1

    # reference: src/opal.cpp:1508-1515
    for r in results:
        r.alignment = None
        r.alignment_length = -1
        r.start_location_query = -1
        r.start_location_target = -1
    return results
