"""Native (C) host components, loaded with ctypes (a copy of opal_tpu's
_native loader; the port keeps its own sources and build).

Two C files: the FASTA tokenizer (a 194 MB database must not be parsed
line by line in Python) and the banded traceback of the alignment pass
(traceback.find_alignment's hot path). They compile with the system C
compiler at first use into `_build/` beside this file (git-ignored), one
library named after a hash of the sources. Where no C compiler works,
or OPAL_TPU_NO_NATIVE is set when the library would first load,
`available()` is false and callers take the pure-Python paths, which give
identical output.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [
    os.path.join(_HERE, "fasta_parse.c"),
    os.path.join(_HERE, "banded_align.c"),
]
BUILD_DIR = os.path.join(_HERE, "_build")

_lib = None
_tried = False
_lock = threading.Lock()


def _build_and_load():
    h = hashlib.sha256()
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"opal_native_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        built = False
        for flags in (["-O3", "-march=native"], ["-O3"]):
            for cc in ("cc", "gcc", "clang"):
                try:
                    subprocess.run(
                        [cc, *flags, "-shared", "-fPIC", "-o", tmp,
                         *_SOURCES],
                        check=True, capture_output=True)
                except (OSError, subprocess.CalledProcessError):
                    continue
                os.replace(tmp, so_path)
                built = True
                break
            if built:
                break
        if not built:
            return None
    lib = ctypes.CDLL(so_path)
    fn = lib.opal_fasta_parse
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fa = lib.opal_find_alignment
    fa.restype = ctypes.c_int64
    fa.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,   # query, Q
        ctypes.c_void_p, ctypes.c_int64,   # target, T
        ctypes.c_int32, ctypes.c_int32,    # go, ge
        ctypes.c_void_p, ctypes.c_int64,   # matrix, alpha
        ctypes.c_int32, ctypes.c_int32,    # score_limit, mode
        ctypes.c_int64, ctypes.c_int64,    # bottom, top
        ctypes.c_int64, ctypes.c_int64,    # step, off (storage mapping)
        ctypes.c_int64,                    # ck (0 = full store)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # Hm, Em, Fm
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # Hk, Ek, Fk
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # score, eq, et
        ctypes.c_void_p, ctypes.c_void_p,  # ops, ops_len
    ]
    return lib


def _get_lib():
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            if not os.environ.get("OPAL_TPU_NO_NATIVE"):
                try:
                    _lib = _build_and_load()
                except OSError:  # a library that does not load
                    _lib = None
    return _lib


def available() -> bool:
    """Whether the native library built (or was found) and loaded."""
    return _get_lib() is not None


class _WorkBuffers(threading.local):
    """Per-thread DP work buffers: ctypes releases the GIL during the C
    call, so the alignment pass runs one traceback per thread."""

    def __init__(self):
        self.size = 0
        self.ksize = 0
        self.H = self.E = self.F = None
        self.Hk = self.Ek = self.Fk = None


_work = _WorkBuffers()

# Above this many stored cells (rows * T), the DP switches to checkpointed
# storage: keep every ck-th column (ck ~ sqrt(T)), re-derive ck-column
# blocks during the backtrace — O(band * sqrt(T)) memory, bit-identical
# outputs, at most one extra fill's worth of recompute. 32M cells = 384 MB
# of full-store matrices at the threshold. OPAL_TPU_TB_FULL_CELLS, read at
# each call, replaces it.
FULL_CELLS = 32_000_000


def find_alignment_native(query, target, go, ge, matrix, score_limit, mode,
                          bottom, top):
    """Native banded find_alignment; returns (score, end_q, end_t, ops) or
    None when native is unavailable or reports a fallback condition."""
    lib = _get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(query, dtype=np.uint8)
    t = np.ascontiguousarray(target, dtype=np.uint8)
    m = np.ascontiguousarray(matrix, dtype=np.int32)
    Q, T = len(q), len(t)
    # band-relative storage when the band is narrower than the matrix:
    # O(band * T) cells instead of the reference's O(Q * T)
    W = int(bottom) + int(top) + 1
    if W < Q:
        rows, step, off = W, 1, int(top)
    else:
        rows, step, off = Q, 0, 0
    full_cells = int(os.environ.get("OPAL_TPU_TB_FULL_CELLS", FULL_CELLS))
    ck = 0
    if rows * T > full_cells:
        ck = max(1, math.isqrt(T - 1) + 1)  # ceil(sqrt(T))
    if ck:
        need = rows * ck
        kneed = rows * (T // ck)
    else:
        need = rows * T
        kneed = 0
    w = _work
    if w.size < need:
        w.H = np.empty(need, np.int32)
        w.E = np.empty(need, np.int32)
        w.F = np.empty(need, np.int32)
        w.size = need
    if kneed and w.ksize < kneed:
        w.Hk = np.empty(kneed, np.int32)
        w.Ek = np.empty(kneed, np.int32)
        w.Fk = np.empty(kneed, np.int32)
        w.ksize = kneed
    score = np.zeros(1, np.int32)
    end_q = np.zeros(1, np.int64)
    end_t = np.zeros(1, np.int64)
    ops = np.empty(Q + T + 2, np.uint8)
    ops_len = np.zeros(1, np.int64)
    rc = lib.opal_find_alignment(
        q.ctypes.data, Q, t.ctypes.data, T,
        np.int32(go), np.int32(ge), m.ctypes.data, m.shape[0],
        np.int32(score_limit), np.int32(mode), int(bottom), int(top),
        step, off, ck,
        w.H.ctypes.data, w.E.ctypes.data, w.F.ctypes.data,
        w.Hk.ctypes.data if ck else None,
        w.Ek.ctypes.data if ck else None,
        w.Fk.ctypes.data if ck else None,
        score.ctypes.data, end_q.ctypes.data, end_t.ctypes.data,
        ops.ctypes.data, ops_len.ctypes.data,
    )
    if rc != 0:
        return None
    n = int(ops_len[0])
    return int(score[0]), int(end_q[0]), int(end_t[0]), ops[:n].copy()


def parse_fasta_buffer(buf: bytes, lut):
    """Parse an in-memory FASTA buffer with the native tokenizer.

    Returns a list of np.uint8 index arrays, or None if native is
    unavailable. Raises ValueError on invalid residue bytes."""
    lib = _get_lib()
    if lib is None:
        return None
    n = len(buf)
    max_seqs = buf.count(b">") + 1
    out_res = np.empty(n, dtype=np.uint8)
    out_starts = np.empty(max_seqs, dtype=np.int64)
    out_lens = np.empty(max_seqs, dtype=np.int64)
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    rc = lib.opal_fasta_parse(
        buf, n, lut.ctypes.data,
        out_res.ctypes.data, out_starts.ctypes.data, out_lens.ctypes.data,
    )
    if rc < 0:
        pos = -(rc + 1)
        raise ValueError(
            f"invalid residue byte {buf[pos]!r} at offset {pos}"
        )
    return [
        out_res[out_starts[i] : out_starts[i] + out_lens[i]].copy()
        for i in range(rc)
    ]
