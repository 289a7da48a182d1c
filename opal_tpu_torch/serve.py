"""Resident-database search server (a port of opal_tpu's serve.py).

The database is uploaded to the card once; the server then answers query
requests indefinitely, amortising the upload and the kernel build over the
deployment's lifetime. Protocol, the same as opal_tpu.serve's byte for
byte: one JSON object per line on stdin, one JSON response per line on
stdout.

Request fields:
  id          echoed back (any JSON value)
  query       residue string, or "queries": [str, ...] for a batch
  mode        "SW" | "NW" | "HW" | "OV"      (default SW)
  gap_open / gap_ext                          (default 3 / 1)
  top_k       number of hits to return        (default 10; 0 = all)
  names       true => append the DB FASTA header to each hit
  align       true => each hit also carries its alignment

Response: {"id": ..., "hits": [[db_index, score], ...]} ranked by
(score desc, index asc); a batch gets one hit list per query. With align,
each hit is [db_index, score, start_q, start_t, end_q, end_t, cigar]
(cigar null where no path exists). Errors are
{"id": ..., "error": "<type>: <message>"}. Batched requests run as stacked
multi_dp launches (engine/search.py::search_database_multi_arrays), and
the top k are selected on the device. An align request scores with ends
in one such stacked pass, then reconstructs only each query's winners on
the host (engine/search.py::alignment_pass).

Run: ``python -m opal_tpu_torch.serve db.fasta [--matrix NAME]
[--block-size N] [--device cuda|cpu]``. With ``--listen PORT`` the same
line protocol is served over TCP (one JSON object per line per connection;
concurrent connections are accepted, and their requests are batched
through the one engine).
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import OrderedDict

import numpy as np

from .constants import MODE_CODES, MODE_SW, SEARCH_SCORE, SEARCH_SCORE_END
from .engine.search import (
    Engine,
    alignment_pass,
    search_database_arrays,
    search_database_multi_arrays,
)
from .fasta import read_fasta_file
from .matrices import ScoreMatrix
from .ranking import rank_scores
from .render import ops_to_cigar
from .result import SearchResult


class Server:
    CACHE_BUDGET_BYTES = 64 * 1024 * 1024
    # responses above this never enter the cache (one giant all-hits dump
    # must not evict the whole working set)
    CACHE_MAX_ENTRY_BYTES = 8 * 1024 * 1024

    def __init__(self, db_path: str, matrix_name: str = "Blosum50",
                 matrix_file: str | None = None, block_size: int = 1024,
                 device: str = "cuda"):
        sm = (ScoreMatrix.from_file(matrix_file) if matrix_file
              else ScoreMatrix.from_name(matrix_name))
        db, names, _ = read_fasta_file(db_path, sm.letter_index(),
                                       return_names=True)
        self._setup(db, names, sm, block_size, device)

    @classmethod
    def from_sequences(cls, db, names, sm: ScoreMatrix | None = None,
                       block_size: int = 1024,
                       device: str = "cuda") -> "Server":
        """A server over an in-memory database: db is a list of uint8
        alphabet-index arrays (as read_fasta_file returns them), names its
        FASTA headers, sm the score matrix (BLOSUM50 by default)."""
        if len(names) != len(db):
            raise ValueError(f"{len(names)} names for {len(db)} sequences")
        srv = cls.__new__(cls)
        srv._setup(db, names, sm or ScoreMatrix.blosum50(), block_size,
                   device)
        return srv

    def _setup(self, db, names, sm, block_size, device):
        self.sm = sm
        self.lut = sm.letter_index()
        self.db, self.names = db, names
        self.engine = Engine(device=device, block_size=block_size)
        self.ddb = self.engine.upload(self.db)
        # request identity -> (encoded response, bytes): an LRU (hits
        # refresh recency) bounded by payload, not entry count; one
        # top_k=0 response over a large DB can be tens of MB
        self._cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._cache_bytes = 0

    def warm(self, lengths, gap_open: int = 3, gap_ext: int = 1,
             mode: int = MODE_SW) -> None:
        """Build the kernels and run one search of each kind the serving
        path takes (single-query and stacked, score and score+end) for the
        given query lengths, so the first request pays neither."""
        rng = np.random.default_rng(0)
        A = self.sm.matrix.shape[0]
        qs = [rng.integers(0, A, size=int(L), dtype=np.uint8)
              for L in lengths]
        for q in qs:
            for st in (SEARCH_SCORE, SEARCH_SCORE_END):
                search_database_arrays(
                    q, self.ddb, gap_open, gap_ext, self.sm.matrix,
                    mode=mode, search_type=st, engine=self.engine)
        batch = qs if len(qs) >= 2 else qs * 2  # stacking needs >= 2
        for st in (SEARCH_SCORE, SEARCH_SCORE_END):
            search_database_multi_arrays(
                batch, self.ddb, gap_open, gap_ext, self.sm.matrix,
                mode=mode, search_type=st, engine=self.engine)

    def _encode_query(self, s: str) -> np.ndarray:
        if not s:
            raise ValueError("empty query")
        idx = self.lut[np.frombuffer(s.upper().encode(), dtype=np.uint8)]
        if (idx == 255).any():
            bad = s[int(np.nonzero(idx == 255)[0][0])]
            raise ValueError(f"invalid residue {bad!r}")
        return idx.astype(np.uint8)

    def handle(self, req: dict) -> dict:
        """Dict-level convenience wrapper (tests, library callers); the
        serving loop uses handle_encoded to avoid re-serialising."""
        return json.loads(self.handle_encoded(req))

    def handle_encoded(self, req: dict) -> str:
        """Answer a request as its JSON-encoded body (no "id" key). The body
        is serialised once; the LRU keeps the encoded string, and _splice
        adds the request id without reparsing. Identical requests are
        answered from the cache."""
        ckey = json.dumps(
            {k: v for k, v in req.items() if k != "id"}, sort_keys=True)
        cached = self._cache.get(ckey)
        if cached is not None:
            self._cache.move_to_end(ckey)  # LRU: hits refresh recency
            return cached[0]
        body = json.dumps(self._handle(req))
        self._cache_put(ckey, body)
        return body

    def _parse(self, req: dict):
        """Validate and encode a request into (qs, single, fields)."""
        queries = req.get("queries")
        single = queries is None
        if single:
            queries = [req["query"]]
        with_names = bool(req.get("names", False))
        qs = [self._encode_query(q) for q in queries]
        mode = MODE_CODES[req.get("mode", "SW")]
        go = int(req.get("gap_open", 3))
        ge = int(req.get("gap_ext", 1))
        top_k = int(req.get("top_k", 10))
        if top_k < 0:
            # a negative top_k would slice all but the worst in
            # rank_scores; reject it at the protocol boundary
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        align = bool(req.get("align", False))
        return qs, single, (mode, go, ge, top_k, align, with_names)

    def _handle(self, req: dict) -> dict:
        qs, single, fields = self._parse(req)
        answers = self._answers(qs, fields)
        return {"hits": answers[0]} if single else {"hits": answers}

    def _answers(self, qs, fields) -> list:
        """One ranked answer list per encoded query (the batch-shaped core:
        cross-request batching concatenates compatible requests' queries
        and calls this once)."""
        mode, go, ge, top_k, align, with_names = fields
        if align:
            return self._align_answers(qs, mode, go, ge, top_k, with_names)
        outs = search_database_multi_arrays(
            qs, self.ddb, go, ge, self.sm.matrix, mode=mode,
            search_type=SEARCH_SCORE, engine=self.engine, top_k=top_k)
        answers = []
        for out in outs:
            if top_k:
                pairs = zip(out["index"], out["score"])
            else:
                pairs = ((i, out["score"][i])
                         for i in rank_scores(out["score"], top_k))
            answers.append([
                [int(i), int(s)] + ([self.names[int(i)]] if with_names else [])
                for i, s in pairs
            ])
        return answers

    def _align_answers(self, qs, mode, go, ge, top_k, with_names) -> list:
        """align=true: one stacked score+end pass for the whole batch (top
        k selected on the device), then each query aligns only its ranked
        winners on the host (opal_tpu/serve.py:173-227)."""
        if ge > go:
            raise ValueError(
                "alignment requires gap_ext <= gap_open "
                "(scores are available without align)")
        outs = search_database_multi_arrays(
            qs, self.ddb, go, ge, self.sm.matrix, mode=mode,
            search_type=SEARCH_SCORE_END, engine=self.engine, top_k=top_k)
        answers = []
        for q, out in zip(qs, outs):
            if top_k:
                order = [int(i) for i in out["index"]]
                rows = {int(out["index"][j]): (
                    int(out["score"][j]), int(out["end_q"][j]),
                    int(out["end_t"][j])) for j in range(len(order))}
            else:
                order = [int(i) for i in rank_scores(out["score"], top_k)]
                rows = {i: (int(out["score"][i]), int(out["end_q"][i]),
                            int(out["end_t"][i])) for i in order}
            results = {}
            for i in order:
                r = SearchResult()
                r.score_set = 1
                r.score, r.end_location_query, r.end_location_target = \
                    rows[i]
                results[i] = r
            alignment_pass(q, self.db, go, ge, self.sm.matrix, mode,
                           results, order)
            answers.append([
                [i, results[i].score,
                 int(results[i].start_location_query),
                 int(results[i].start_location_target),
                 int(results[i].end_location_query),
                 int(results[i].end_location_target),
                 ops_to_cigar(results[i].alignment)
                 if results[i].alignment is not None else None]
                + ([self.names[i]] if with_names else [])
                for i in order
            ])
        return answers

    def _respond(self, line: str) -> str:
        try:
            req = json.loads(line)
            return self._splice(req, self.handle_encoded(req))
        except Exception as exc:  # noqa: BLE001 (protocol boundary)
            try:
                rid = json.loads(line).get("id")
            except Exception:  # noqa: BLE001 (any malformed line)
                rid = None
            return json.dumps(
                {"id": rid, "error": f"{type(exc).__name__}: {exc}"})

    def _respond_many(self, lines: list) -> list:
        """Answer a batch of request lines, concatenating compatible
        requests (same mode / gaps / top_k / align / names) into one stacked
        multi-query search, so concurrent single-query clients share kernel
        launches. Responses are byte-identical to per-line _respond; cache,
        errors and id splicing behave per request."""
        outs: list = [None] * len(lines)
        groups: dict = {}
        for idx, line in enumerate(lines):
            try:
                req = json.loads(line)
                ckey = json.dumps(
                    {k: v for k, v in req.items() if k != "id"},
                    sort_keys=True)
                cached = self._cache.get(ckey)
                if cached is not None:
                    self._cache.move_to_end(ckey)
                    outs[idx] = self._splice(req, cached[0])
                    continue
                qs, single, fields = self._parse(req)
            except Exception:  # noqa: BLE001 (answered per line below)
                outs[idx] = self._respond(line)  # error-path parity
                continue
            groups.setdefault(fields, []).append(
                (idx, req, ckey, qs, single))
        for fields, items in groups.items():
            try:
                flat = [q for _, _, _, qs, _ in items for q in qs]
                answers = self._answers(flat, fields)
            except Exception:  # noqa: BLE001 (isolate a poisoned request)
                # answer per request, so one bad request cannot fail the
                # batch it shares
                for idx, _, _, _, _ in items:
                    outs[idx] = self._respond(lines[idx])
                continue
            off = 0
            for idx, req, ckey, qs, single in items:
                part = answers[off:off + len(qs)]
                off += len(qs)
                body = json.dumps({"hits": part[0] if single else part})
                self._cache_put(ckey, body)
                outs[idx] = self._splice(req, body)
        return outs

    def _splice(self, req: dict, body: str) -> str:
        rid = json.dumps(req.get("id"))
        if body == "{}":
            return '{"id": ' + rid + "}"
        return '{"id": ' + rid + ", " + body[1:]

    def _cache_put(self, ckey: str, body: str) -> None:
        if ckey in self._cache:
            return
        size = len(body)
        if size <= self.CACHE_MAX_ENTRY_BYTES:
            self._cache[ckey] = (body, size)
            self._cache_bytes += size
            while self._cache_bytes > self.CACHE_BUDGET_BYTES:
                _, (_, old_size) = self._cache.popitem(last=False)
                self._cache_bytes -= old_size

    def _ready_banner(self) -> str:
        return json.dumps({"ready": True, "n_db": len(self.db),
                           "residues": int(self.ddb.total_residues)})

    def run(self, fin=None, fout=None) -> int:
        fin = fin or sys.stdin
        fout = fout or sys.stdout
        print(self._ready_banner(), file=fout, flush=True)
        for line in fin:
            line = line.strip()
            if not line:
                continue
            print(self._respond(line), file=fout, flush=True)
        return 0

    def serve_tcp(self, port: int, host: str = "127.0.0.1",
                  batch_window: float = 0.004) -> int:
        """TCP front end for the same line protocol: each connection gets
        the ready banner, then one JSON response line per request line.
        Requests of all connections go through one dispatcher thread that
        gathers arrivals for `batch_window` seconds and answers them with
        _respond_many, so compatible concurrent requests share stacked
        launches. batch_window=0 answers strictly one request at a time."""
        import queue as _queue
        import socketserver
        import threading
        import time as _time

        outer = self
        lock = threading.Lock()
        inbox: _queue.Queue = _queue.Queue()
        BATCH_CAP = 32  # requests per dispatcher round

        def dispatcher():
            while True:
                batch = [inbox.get()]
                deadline = _time.monotonic() + batch_window
                while len(batch) < BATCH_CAP:
                    left = deadline - _time.monotonic()
                    if left <= 0:
                        break
                    try:
                        batch.append(inbox.get(timeout=left))
                    except _queue.Empty:
                        break
                try:
                    outs = outer._respond_many([b[0] for b in batch])
                except Exception as exc:  # noqa: BLE001 (keep serving)
                    outs = [json.dumps(
                        {"id": None,
                         "error": f"{type(exc).__name__}: {exc}"})
                        for _ in batch]
                for (_, ev, slot), out in zip(batch, outs):
                    slot["out"] = out
                    ev.set()

        if batch_window > 0:
            threading.Thread(target=dispatcher, daemon=True).start()

        def respond(line):
            if batch_window <= 0:
                with lock:
                    return outer._respond(line)
            ev = threading.Event()
            slot: dict = {}
            inbox.put((line, ev, slot))
            ev.wait()
            return slot["out"]

        MAX_LINE = 16 * 1024 * 1024  # request-size cap (network surface)

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                self.wfile.write((outer._ready_banner() + "\n").encode())
                while True:
                    raw = self.rfile.readline(MAX_LINE + 1)
                    if not raw:
                        return
                    if len(raw) > MAX_LINE:
                        self.wfile.write(json.dumps(
                            {"id": None, "error":
                             "RequestTooLarge: line exceeds 16 MiB"}
                        ).encode() + b"\n")
                        return  # the stream is mid-line: drop it
                    line = raw.decode(errors="replace").strip()
                    if not line:
                        continue
                    out = respond(line)
                    try:
                        self.wfile.write((out + "\n").encode())
                    except (BrokenPipeError, ConnectionResetError):
                        return

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # the default accept backlog (5) drops connections under a
            # burst of concurrent clients
            request_queue_size = 128

        with Srv((host, port), Handler) as srv:
            self.tcp_server = srv  # lets a caller shut it down
            print(json.dumps({"listening": True, "host": host,
                              "port": srv.server_address[1]}), flush=True)
            try:
                srv.serve_forever()
            except KeyboardInterrupt:
                pass
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="opal_tpu_torch.serve",
                                description=__doc__.split("\n")[0])
    p.add_argument("db")
    p.add_argument("--matrix", default="Blosum50")
    p.add_argument("--matrix-file", default=None)
    p.add_argument("--block-size", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain PyTorch "
                        "versions)")
    p.add_argument("--warm", default=None, metavar="L1,L2,...",
                   help="build the kernels and run one search of each kind "
                        "for these query lengths at startup")
    p.add_argument("--listen", type=int, default=None, metavar="PORT",
                   help="serve the line protocol over TCP on this port "
                        "(default: stdin/stdout)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --listen (default: loopback)")
    p.add_argument("--batch-window", type=float, default=0.004,
                   metavar="SECONDS",
                   help="cross-request batching window for --listen: "
                        "compatible requests arriving within it share "
                        "stacked kernel launches (0 = strictly serial)")
    args = p.parse_args(argv)
    srv = Server(args.db, matrix_name=args.matrix,
                 matrix_file=args.matrix_file, block_size=args.block_size,
                 device=args.device)
    if args.warm:
        srv.warm(int(x) for x in args.warm.split(","))
    if args.listen is not None:
        return srv.serve_tcp(args.listen, host=args.host,
                             batch_window=args.batch_window)
    return srv.run()


if __name__ == "__main__":
    sys.exit(main())
