"""FASTA input (a copy of opal_tpu's fasta.py, with its native fast path).

Streaming, memory-bounded FASTA reading with the same observable semantics as
the reference CLI's reader (reference: src/opal_aligner.cpp:240-301):

- Sequences are returned as numpy uint8 arrays of alphabet *indices*, mapped
  through a 128-entry LUT where '*' (if present in the alphabet) absorbs every
  character not otherwise in the alphabet.
- Header lines ('>' ...) are skipped; '\r' and '\n' never contribute residues;
  a sequence may span multiple lines; empty lines do not terminate a sequence.
- Reading stops (returning eof=False) once more than ``max_residues`` residues
  of *completed* sequences have been accumulated and a new sequence is about
  to start; the file position is rewound to the start of that new sequence so
  a subsequent call resumes there (reference: src/opal_aligner.cpp:282-289).

Where the rest of a stream fits the residue budget (the usual case: the
budget is 1 GiB), the whole buffer goes to the native C tokenizer
(_native.parse_fasta_buffer); the line loop runs only where a budget cut
falls inside the stream, or where no C compiler is present.
"""
from __future__ import annotations

from typing import BinaryIO

import numpy as np

from ._native import parse_fasta_buffer

DEFAULT_MAX_RESIDUES = 1073741824  # 1 GiB, reference: src/opal_aligner.cpp:286


class PushbackReader:
    """Binary line reader with arbitrary-size byte pushback.

    The chunked reader's "rewind" is un-reading bytes that overflowed the
    residue budget (one line on the slow path; a whole probed buffer on
    the fast path). On a GzipFile a backward seek re-decompresses from
    the START of the file, making a multi-chunk gzipped scan
    O(n_chunks^2); buffering on the Python side makes every input O(n)
    and also drops the per-line tell() overhead. Pending bytes are kept
    as (buffer, offset) so line extraction never re-copies the tail."""

    def __init__(self, f: BinaryIO):
        self._f = f
        self._buf = b""
        self._off = 0

    def readline(self) -> bytes:
        if self._off < len(self._buf):
            i = self._buf.find(b"\n", self._off)
            if i >= 0:
                line = self._buf[self._off : i + 1]
                self._off = i + 1
                if self._off == len(self._buf):
                    self._buf, self._off = b"", 0
                return line
            line = self._buf[self._off :]
            self._buf, self._off = b"", 0
            return line + self._f.readline()
        return self._f.readline()

    def unread(self, data: bytes) -> None:
        """Prepend bytes (a line, or a whole probed buffer) to the stream."""
        rest = self._buf[self._off :]
        self._buf = data + rest if rest else data
        self._off = 0

    def read(self, n: int = -1) -> bytes:
        pend = self._buf[self._off :]
        self._buf, self._off = b"", 0
        if n is None or n < 0:
            return pend + self._f.read()
        if len(pend) >= n:
            self._buf = pend[n:]
            return pend[:n]
        return pend + self._f.read(n - len(pend))

    def close(self):
        return self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return self._f.__exit__(*exc)


def read_fasta_sequences(
    f: BinaryIO,
    letter_idx: np.ndarray,
    max_residues: int = DEFAULT_MAX_RESIDUES,
    return_names: bool = False,
):
    """Read (a chunk of) a FASTA file opened in binary mode.

    letter_idx: 128-entry uint8 LUT (see ScoreMatrix.letter_index()); entries
        of 255 mean "invalid letter" and raise ValueError.
    Returns (seqs, eof) or (seqs, names, eof) when return_names is True.
    """
    lut = np.asarray(letter_idx, dtype=np.uint8)

    # Fast path: the rest of the stream, if it fits the residue budget,
    # through the native tokenizer. A stream longer than the probe is
    # pushed back untouched and parsed by the exact-semantics line loop
    # below (budget cut + rewind).
    if not return_names and hasattr(f, "unread"):
        # residues <= bytes, so budget + slack bytes always either reach
        # EOF or contain more than a full budget of residues
        want = min(max_residues + (1 << 20), 2**62)
        buf = f.read(want)
        if len(buf) < want:
            seqs_fast = parse_fasta_buffer(buf, lut)
            # the budget cut triggers before starting sequence k iff the
            # residues completed so far exceed it: no cut over this whole
            # buffer iff all but the last fit the budget
            if seqs_fast is not None and (
                    len(seqs_fast) <= 1
                    or sum(a.size for a in seqs_fast)
                    - seqs_fast[-1].size <= max_residues):
                return seqs_fast, True
        f.unread(buf)

    seqs: list[np.ndarray] = []
    names: list[str] = []
    parts: list[bytes] = []  # raw residue byte-chunks of the current sequence
    in_sequence = False
    completed_residues = 0
    pending_name = ""
    cur_name = ""
    eof = True

    def flush_current():
        nonlocal parts, completed_residues
        raw = b"".join(parts)
        parts = []
        arr = lut[np.frombuffer(raw, dtype=np.uint8) & 0x7F]
        # Reject bytes >= 128 or letters with no mapping.
        if (np.frombuffer(raw, dtype=np.uint8) > 127).any() or (arr == 255).any():
            raise ValueError("sequence contains letters outside the alphabet")
        seqs.append(arr)
        names.append(cur_name)
        completed_residues += arr.size

    can_unread = hasattr(f, "unread")
    while True:
        line_start = None if can_unread else f.tell()
        line = f.readline()
        if not line:
            break
        if line.startswith(b">"):
            if in_sequence:
                flush_current()
            in_sequence = False
            pending_name = line[1:].strip().decode("utf-8", "replace")
            continue
        stripped = line.rstrip(b"\r\n").replace(b"\r", b"")
        if not stripped:
            continue
        if not in_sequence:
            # About to start a new sequence: enforce the residue budget.
            if completed_residues > max_residues:
                # Un-read (or seek back to) the overflowing line so a
                # subsequent call resumes there. unread is O(1) on any
                # stream; the seek fallback is O(file) on gzip.
                if can_unread:
                    f.unread(line)
                else:
                    f.seek(line_start)
                eof = False
                # The header of the rewound sequence was consumed; rewinding to
                # the residue line matches the reference, which also re-enters
                # mid-record (it rewinds to the first residue character).
                break
            in_sequence = True
            cur_name = pending_name
        parts.append(stripped)

    if in_sequence:
        flush_current()
    if return_names:
        return seqs, names, eof
    return seqs, eof


def open_fasta(path: str):
    """Open a FASTA file for binary reading, transparently decompressing
    gzip (sniffed by magic bytes, so any extension works). Real-world
    sequence databases ship gzipped; the reference reader does not
    support this."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        import gzip

        return PushbackReader(gzip.open(path, "rb"))
    return PushbackReader(open(path, "rb"))


def read_fasta_file(path: str, letter_idx: np.ndarray, return_names: bool = False):
    """Read an entire FASTA file (no residue budget); gzip transparent.
    Without names, the buffer goes through the native tokenizer where it
    is available."""
    if not return_names:
        with open_fasta(path) as f:
            buf = f.read()
        seqs = parse_fasta_buffer(buf, letter_idx)
        if seqs is not None:
            return seqs, True
    with open_fasta(path) as f:
        return read_fasta_sequences(
            f, letter_idx, max_residues=2**62, return_names=return_names
        )
