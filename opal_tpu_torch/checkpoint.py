"""Durable checkpoint/resume for whole-database scans (a copy of
opal_tpu's checkpoint.py).

The reference's only resumability is in-memory result reuse plus restartable
1 GiB FASTA streaming (reference: src/opal.h:118-122, src/opal_aligner.cpp:
125-201 — nothing survives a process death). For long scans over
billion-residue databases interruption must be cheap, so the CLI
can journal per-chunk results to disk: each completed DB chunk appends one
JSON line; on restart with the same file, completed chunks replay from the
journal (the FASTA is still parsed to keep deterministic chunk boundaries)
and the search resumes at the first unfinished chunk.

The journal is keyed by a digest of everything that determines the results
(query residues, mode/search level/gaps, score matrix, DB identity); a
mismatched journal is refused rather than silently misused.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import numpy as np

from .result import SearchResult

_V = 1


def search_key(queries, mode, search_type, gap_open, gap_ext, matrix,
               db_path: str, chunk_residues=None, align_top_k=0) -> str:
    """Digest of all result-determining inputs — including the chunking
    budget (it sets the journal's chunk boundaries) and align_top_k (it
    sets which records carry alignment paths), and the DB file's
    size+mtime (a same-size content rewrite must invalidate the journal)."""
    h = hashlib.sha256()
    h.update(
        f"v{_V}|{mode}|{search_type}|{gap_open}|{gap_ext}"
        f"|{chunk_residues}|{align_top_k}|".encode()
    )
    for q in queries:
        h.update(np.asarray(q, np.uint8).tobytes())
        h.update(b"|")
    h.update(np.ascontiguousarray(matrix, np.int64).tobytes())
    try:
        st = os.stat(db_path)
        h.update(f"|{os.path.abspath(db_path)}|{st.st_size}"
                 f"|{st.st_mtime_ns}".encode())
    except OSError:
        h.update(db_path.encode())
    return h.hexdigest()


def _encode_result(r: SearchResult) -> list:
    ops = (base64.b64encode(np.asarray(r.alignment, np.uint8).tobytes())
           .decode() if r.alignment is not None else None)
    return [int(r.score_set), int(r.score),
            int(r.end_location_query), int(r.end_location_target),
            int(r.start_location_query), int(r.start_location_target), ops]


def _decode_result(row: list) -> SearchResult:
    r = SearchResult()
    (r.score_set, r.score, r.end_location_query, r.end_location_target,
     r.start_location_query, r.start_location_target) = map(int, row[:6])
    if row[6] is not None:
        r.alignment = np.frombuffer(
            base64.b64decode(row[6]), dtype=np.uint8
        ).copy()
        r.alignment_length = len(r.alignment)
    else:
        r.alignment = None
        r.alignment_length = 0 if r.start_location_query >= 0 else -1
    return r


class Checkpoint:
    """Append-only per-chunk result journal (JSON lines).

    Journal lines are size-capped: a chunk whose encoded record exceeds
    SIDECAR_BYTES (e.g. a giant -x 2 chunk with inline alignments) is
    stored as a gzip sidecar file next to the journal, and the journal
    line carries only {"chunk", "ext", "sha"}. Sidecars are fsynced
    BEFORE their journal line is appended, so a journal line never
    references an incomplete sidecar; load verifies the digest. Resume
    memory stays bounded — sidecar payloads are read lazily per chunk."""

    SIDECAR_BYTES = 4 * 1024 * 1024

    def __init__(self, path: str, key: str):
        self.path = path
        self.key = key
        self._done: dict[int, object] = {}  # chunk -> rows | ("ext", f, sha)
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "r+") as f:
                first = f.readline()
                header = None
                if first.endswith("\n"):
                    try:
                        header = json.loads(first)
                    except json.JSONDecodeError:
                        header = None
                    if not isinstance(header, dict):
                        header = None  # parseable but non-dict == corrupt
                if header is None:
                    # torn/corrupt header: a crash between file creation
                    # and the (fsynced) header write. No record can follow
                    # a torn first line, so recreate the journal cleanly.
                    f.seek(0)
                    f.truncate(0)
                    f.write(json.dumps({"v": _V, "key": key}) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                    self._reap_orphan_sidecars()
                    return
                if header.get("key") != key:
                    raise ValueError(
                        f"checkpoint {path} belongs to a different search "
                        "(query/db/flags changed); remove it or pass a "
                        "different file"
                    )
                valid_end = f.tell()
                while True:
                    line = f.readline()
                    if not line:
                        break
                    if not line.endswith("\n") or not line.strip():
                        break  # torn tail write from an interrupted run
                    try:
                        rec = json.loads(line)
                        chunk = int(rec["chunk"])
                        if "ext" in rec:
                            entry = ("ext", rec["ext"], rec["sha"])
                        else:
                            entry = rec["q"]
                    except (json.JSONDecodeError, KeyError, TypeError,
                            ValueError):
                        break  # malformed record == torn tail
                    self._done[chunk] = entry
                    valid_end = f.tell()
                # drop any torn tail so later appends stay parseable
                f.truncate(valid_end)
        else:
            with open(path, "w") as f:
                f.write(json.dumps({"v": _V, "key": key}) + "\n")
                f.flush()
                os.fsync(f.fileno())
        self._reap_orphan_sidecars()

    def _reap_orphan_sidecars(self) -> None:
        """Delete this journal's sidecar files that no surviving record
        references. Torn-header recreation, torn-tail truncation, and
        'remove the journal and restart' recovery all orphan sidecars
        otherwise (multi-MB .chunkNNNNNN.json.gz files accumulating
        forever next to restarted large -x 2 runs)."""
        import glob

        referenced = {
            e[1] for e in self._done.values()
            if isinstance(e, tuple) and e[0] == "ext"
        }
        d = os.path.dirname(os.path.abspath(self.path))
        base = os.path.basename(self.path)
        pattern = os.path.join(
            glob.escape(d), glob.escape(base) + ".chunk*.json.gz")
        for p in glob.glob(pattern):
            if os.path.basename(p) not in referenced:
                try:
                    os.remove(p)
                except OSError:
                    pass  # best-effort hygiene; never block a resume

    def has(self, chunk: int) -> bool:
        return chunk in self._done

    def _rows(self, chunk: int):
        entry = self._done[chunk]
        if isinstance(entry, tuple) and entry[0] == "ext":
            import gzip

            sidecar = os.path.join(
                os.path.dirname(os.path.abspath(self.path)), entry[1])
            try:
                with open(sidecar, "rb") as f:
                    blob = f.read()
            except FileNotFoundError:
                raise ValueError(
                    f"checkpoint sidecar {entry[1]} is missing (crash "
                    "between journal append and sidecar durability?); "
                    "remove the journal and restart"
                ) from None
            if hashlib.sha256(blob).hexdigest() != entry[2]:
                raise ValueError(
                    f"checkpoint sidecar {entry[1]} is corrupt "
                    "(digest mismatch); remove the journal and restart"
                )
            return json.loads(gzip.decompress(blob).decode())
        return entry

    def load(self, chunk: int) -> list[list[SearchResult]]:
        """Per-query result lists for a completed chunk."""
        return [
            [_decode_result(row) for row in per_q]
            for per_q in self._rows(chunk)
        ]

    def save(self, chunk: int, per_query: list[list[SearchResult]]) -> None:
        rows = [[_encode_result(r) for r in rs] for rs in per_query]
        payload = json.dumps({"chunk": chunk, "q": rows})
        if len(payload) > self.SIDECAR_BYTES:
            import gzip

            blob = gzip.compress(
                json.dumps(rows).encode(), compresslevel=1)
            name = (os.path.basename(self.path)
                    + f".chunk{chunk:06d}.json.gz")
            sidecar = os.path.join(
                os.path.dirname(os.path.abspath(self.path)), name)
            with open(sidecar, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            # the sidecar's DIRECTORY ENTRY must be durable before the
            # journal references it (file fsync alone doesn't persist the
            # name on POSIX)
            dfd = os.open(os.path.dirname(sidecar) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
            sha = hashlib.sha256(blob).hexdigest()
            payload = json.dumps({"chunk": chunk, "ext": name, "sha": sha})
            entry = ("ext", name, sha)
        else:
            entry = rows
        with open(self.path, "a") as f:
            f.write(payload + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._done[chunk] = entry
