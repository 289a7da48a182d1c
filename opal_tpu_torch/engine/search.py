"""Top-level database search: the public API of the engine.

Mirrors opal_tpu/engine/search.py (itself the contract of the reference's
``opalSearchDatabase``, src/opal.h:150-154): dispatch on mode (SW / NW / HW
/ OV) and search type, and the skip semantics: sequences whose passed-in
results already carry a score (and end location when needed) are not
recomputed (src/opal.cpp:1446-1451).

Scoring runs on the card: one query through the ragged_dp kernel (in
query panels when it is taller than kernels.PANEL_ROWS), many through
stacked multi_dp groups (search_database_multi_arrays; a long query runs
alone), with the top k selected on the device (engine/ranked.py). A long
query needs no other method: the port's lane width never depends on Q, so
opal_tpu's lane-width downshift (preferred_block_size) has no counterpart. Full alignment (search
type 2) scores with ends on the card, then reconstructs each path on the
host (alignment_pass: the reverse-pair banded traceback of traceback.py,
in C where a compiler is present), or with OPAL_TPU_DEVICE_FILL=1 fills
and walks the winners on the card (engine/device_fill.py).
Engine(precision="adaptive") runs the kernel with its overflow-flag rows
and reports in last_search_stats which reference precision each sequence
needed (engine/cascade.py).

Every entry point runs on the engine's device, "cuda" unless the caller
asks for "cpu"; without CUDA the default engine raises. With a mesh
(EngineConfig.mesh, parallel/shard.py's db_mesh) the resident database is
in one part per mesh device, each scored on its own device, and the
engine's device is the mesh's first (where x2's device fill runs).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    OVERFLOW_BUCKETS,
    SEARCH_ALIGNMENT,
    SEARCH_SCORE,
)
from ..ranking import rank_rows, rank_scores
from ..result import SearchResult
from ..traceback import AlignmentError, align_pair_reverse_trick
from . import cascade, kernels, ranked
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
    # "int32", or "adaptive": search_database also reports which reference
    # precision (8, 16 or 32 bits) each sequence needed (last_search_stats)
    precision: str = "int32"
    # a parallel.shard.Mesh: the database in one part per mesh device
    mesh: object = None


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None, **kw):
        self.config = config or EngineConfig(**kw)
        if self.config.precision not in ("int32", "adaptive"):
            raise ValueError(f"precision={self.config.precision!r}: "
                             "'int32' or 'adaptive'")
        mesh = self.config.mesh
        if mesh is None:
            self.device = resolve_device(self.config.device)
        else:
            self.device = mesh.devices[0]
            if torch.device(self.config.device).type != self.device.type:
                raise ValueError(f"device={self.config.device!r}, the mesh "
                                 f"is on {self.device.type}")
        self.last_search_stats: Optional[dict] = None
        self._backend = RaggedBackend(self.device)
        # Bounded LRU of resident DeviceDatabases (most-recent last)
        self._resident_cache: "collections.OrderedDict" = (
            collections.OrderedDict())

    def upload(self, db: Sequence[np.ndarray]) -> DeviceDatabase:
        """Upload the DB to the device once (resident-database mode), in
        one part per mesh device with a mesh."""
        return DeviceDatabase(db, self.config.block_size, self.device,
                              self.config.mesh)

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
            cached = self.upload(db)
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
        with_flags: bool = False,
        top_k: int = 0,
    ):
        """Score (a subset of) the DB. Returns (indices, columns) where
        columns is a dict of per-index arrays (score [+ end_q/end_t], and
        the overflow-flag columns when with_flags). top_k > 0: only the k
        best rows, ranked by (score desc, DB index asc); on the whole
        database without flags they are selected on the device and only
        candidates are downloaded (engine/ranked.py), otherwise the host
        ranks them."""
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
            # partial rescoring (skip semantics): ad-hoc upload, over the
            # mesh too
            index_map = np.fromiter(subset, dtype=np.int64)
            ddb = self.upload([db_list[i] for i in index_map])
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
                                       mode, search_type, with_flags)
        if top_k and index_map is None and not with_flags:
            out = ranked.topk_from_handle(handle, ddb, mode, search_type, Q,
                                          top_k)
            return out.pop("index"), out
        per_block = backend.collect_many(handle, ddb, mode, search_type, Q,
                                         with_flags)
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
    index asc). At search_type 2 the columns are those of score+end:
    paths come from search_database."""
    if matrix is None:
        raise ValueError("matrix is required")
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
    runs as one stacked multi_dp pass over the database, a group of one
    through search_database_arrays. The grouping decides launches only: each
    query's result equals its own single-query search. As in opal_tpu,
    search_type 2 and an adaptive engine do not stack: each query runs on
    the single-query path."""
    if matrix is None:
        raise ValueError("matrix is required")
    engine = engine or get_default_engine()
    backend = engine._backend
    queries = [np.asarray(q, dtype=np.uint8) for q in queries]
    ddb = engine._get_resident(db)
    matrix_np = np.asarray(matrix, dtype=np.int32)
    A = matrix_np.shape[0]

    def fits(group):
        return backend.supports_multi(group, gap_open, gap_ext, A, matrix_np,
                                      ddb.max_len)

    stackable = (search_type != SEARCH_ALIGNMENT
                 and engine.config.precision != "adaptive")
    groups = (plan_groups(queries, fits) if stackable
              else [[i] for i in range(len(queries))])
    out: list = [None] * len(queries)
    for group in groups:
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


def alignment_pass(query, db_list, gap_open, gap_ext, matrix, mode,
                   results, cand, device="cuda"):
    """Reconstruct alignment paths for the candidate indices (opal_tpu's
    alignment_pass, opal_tpu/engine/search.py:437-556).

    results[i] must already carry the exact score and end locations for
    every i in cand (any indexable container of SearchResult works: a dict
    for sparse top-k passes). Zero-score SW sequences get the reference's
    no-alignment treatment (src/opal.cpp:1479-1483); non-reconstructible
    degenerate optima keep exact score/end and omit the path (the
    reference aborts there, src/opal.cpp:1497). The per-pair traceback is
    host work, and its native C path releases the GIL, so 32 or more pairs
    run on a thread pool across the host's cores: OPAL_TPU_TRACEBACK_WORKERS
    threads (0 or 1: serially), min(cores, 16) when it is unset.

    OPAL_TPU_DEVICE_FILL=1 (opal_tpu's switch, read where it reads it):
    two or more pairs are first filled and walked on `device`
    (engine/device_fill.py, the device_fill kernel on "cuda", its plain
    version on "cpu"; without CUDA the default raises); the lanes it does
    not return go on to the host path, so the output is the same either
    way. OPAL_TPU_DEVICE_FILL_CHECK=1 audits that: every device-filled
    lane is recomputed on the host path, and a lane that differs warns
    (RuntimeWarning) and takes the host result."""

    def _align_one(i):
        r = results[i]
        try:
            return i, align_pair_reverse_trick(
                query, db_list[i], gap_open, gap_ext, matrix,
                r.score, r.end_location_query, r.end_location_target,
                mode,
            ), None
        except AlignmentError as exc:
            return i, None, exc

    todo_align = []
    for i in cand:
        r = results[i]
        if mode == MODE_SW and r.score == 0:
            # reference: src/opal.cpp:1479-1483
            r.alignment = None
            r.alignment_length = 0
            r.start_location_query = r.start_location_target = -1
            r.end_location_query = r.end_location_target = -1
        else:
            todo_align.append(i)

    if os.environ.get("OPAL_TPU_DEVICE_FILL") == "1" and len(todo_align) >= 2:
        from .device_fill import align_winners_device

        winners = [(i, results[i].score, results[i].end_location_query,
                    results[i].end_location_target) for i in todo_align]
        device_done = align_winners_device(
            query, db_list, gap_open, gap_ext, matrix, mode, winners,
            device=device)
        if os.environ.get("OPAL_TPU_DEVICE_FILL_CHECK") == "1":
            # replay validation pins score, ends and the path's validity;
            # the audit pins the path itself to the host one
            for i in list(device_done):
                _, host_out, exc = _align_one(i)
                if exc is not None or (
                        host_out[:2] != device_done[i][:2]
                        or not np.array_equal(host_out[2],
                                              device_done[i][2])):
                    warnings.warn(
                        f"device fill lane {i} differs from host path; "
                        "using host result", RuntimeWarning, stacklevel=2)
                    del device_done[i]
        for i, (sq, st, ops) in device_done.items():
            r = results[i]
            r.start_location_query = sq
            r.start_location_target = st
            r.alignment = ops
            r.alignment_length = len(ops)
        todo_align = [i for i in todo_align if i not in device_done]

    workers = os.environ.get("OPAL_TPU_TRACEBACK_WORKERS")
    workers = int(workers) if workers else min(os.cpu_count() or 1, 16)
    if workers > 1 and len(todo_align) >= 32:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            outcomes = list(pool.map(_align_one, todo_align))
    else:
        outcomes = [_align_one(i) for i in todo_align]

    for i, out, exc in outcomes:
        r = results[i]
        if exc is not None:
            # Degenerate optimum not representable as an anchored path
            # (e.g. a pure-deletion HW/OV alignment consuming zero target
            # letters). The reference aborts on its reverse-pass assert
            # here (src/opal.cpp:1497); the score and end stay exact and
            # the path is omitted.
            warnings.warn(
                f"sequence {i}: alignment path not reconstructible "
                f"({exc}); score/end locations remain exact",
                RuntimeWarning,
                stacklevel=2,
            )
            r.alignment = None
            r.alignment_length = 0
            r.start_location_query = -1
            r.start_location_target = -1
            continue
        sq, st, ops = out
        r.start_location_query = sq
        r.start_location_target = st
        r.alignment = ops
        r.alignment_length = len(ops)


def _search_stats(idx, cols, mode, n, overflow_method):
    """Adaptive-precision bookkeeping (opal_tpu/engine/search.py:651-686):
    which reference precision each scored sequence needed, and what each
    cascade stage would rerun under the overflow method. Outputs are
    already exact (engine/cascade.py), so this is observability, not a
    recompute trigger. Masks and buckets follow database order (the
    reference's buckets are 1024 consecutive sequences, src/opal.cpp:502);
    skipped sequences count as 8-bit (never rerun)."""
    prec = cascade.classify_precision(cols, mode)
    prec_db = np.full(n, 8, dtype=np.int32)
    prec_db[idx] = prec
    return {
        "precision_bits": dict(zip(idx.tolist(), prec.tolist())),
        # what each stage would rerun (reference: src/opal.cpp:512-529):
        # stage 8 = the char->short escalation set, 16 = short->int
        "rerun_mask_stage8": cascade.simulate_overflow_method(
            prec_db, overflow_method, 8),
        "rerun_mask_stage16": cascade.simulate_overflow_method(
            prec_db, overflow_method, 16),
        "precision_counts": {b: int((prec == b).sum()) for b in (8, 16, 32)},
        "bucket_escalations": cascade.bucket_escalation_counts(prec_db),
        "overflow_method": overflow_method,
    }


def search_database(
    query,
    db,
    gap_open: int = 3,
    gap_ext: int = 1,
    matrix=None,
    mode: int = MODE_SW,
    search_type: int = SEARCH_SCORE,
    overflow_method: int = OVERFLOW_BUCKETS,
    results: Optional[list[SearchResult]] = None,
    engine: Optional[Engine] = None,
    align_top_k: int = 0,
) -> list[SearchResult]:
    """Search the database with the query; see module docstring.

    query: uint8 alphabet-index array. db: list of uint8 index arrays or a
    DeviceDatabase. matrix: [A, A] int array. results: optional pre-filled
    results to reuse (skip semantics). Returns the (possibly passed-in)
    list of SearchResult. With an adaptive engine, engine.last_search_stats
    reports the precisions and what overflow_method would rerun.

    align_top_k: with SEARCH_ALIGNMENT, reconstruct alignment paths only for
    the k best-scoring sequences (score desc, index asc); the rest keep
    exact score + end locations (as if searched with SEARCH_SCORE_END).
    0 = align everything (the reference's behavior).
    """
    if mode not in (MODE_NW, MODE_HW, MODE_OV, MODE_SW):
        raise ValueError(f"invalid mode {mode}")
    if matrix is None:
        raise ValueError("matrix is required")
    if search_type == SEARCH_ALIGNMENT and gap_ext > gap_open:
        # With gap_ext > gap_open the DP's effective gap model lets interior
        # gaps re-open (cost go per residue) while boundary gaps cannot, so
        # optimal scores are not reversal-invariant and reconstructed paths
        # would not replay to their reported affine score. The reference
        # would abort on its reverse-pass assert (src/opal.cpp:1497);
        # scores (SEARCH_SCORE/SCORE_END) remain exact.
        raise ValueError(
            "alignment reconstruction requires gap_ext <= gap_open "
            "(scores are still available via search_type 0/1)"
        )
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

    adaptive = engine.config.precision == "adaptive"
    if todo.size:
        if todo.size == n:
            idx, cols = engine.score_blocks(
                query, db, gap_open, gap_ext, matrix, mode, search_type,
                with_flags=adaptive)
        else:
            idx, cols = engine.score_blocks(
                query, db_list, gap_open, gap_ext, matrix, mode, search_type,
                subset=todo, with_flags=adaptive)
        if adaptive:
            engine.last_search_stats = _search_stats(idx, cols, mode, n,
                                                     overflow_method)
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

    if search_type == SEARCH_ALIGNMENT:
        align_set = None
        if align_top_k:
            if todo.size and todo.size == n:
                all_scores = np.empty(n, np.int64)
                all_scores[idx] = cols["score"]
            else:
                all_scores = np.array(
                    [r.score if r.score_set else -(2**62) for r in results])
            align_set = set(rank_scores(all_scores, align_top_k).tolist())
        # non-top-k sequences keep exact score/end and no path; only the
        # candidates need a pass
        cand = range(n) if align_set is None else sorted(align_set)
        alignment_pass(query, db_list, gap_open, gap_ext, matrix, mode,
                       results, cand, device=engine.device)
    else:
        # reference: src/opal.cpp:1508-1515
        for r in results:
            r.alignment = None
            r.alignment_length = -1
            r.start_location_query = -1
            r.start_location_target = -1
    return results
