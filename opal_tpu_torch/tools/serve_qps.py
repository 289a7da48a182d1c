"""Server QPS: cross-request batching against serial dispatch (the card's
counterpart of tools/serve_qps.py).

    python -m opal_tpu_torch.tools.serve_qps [--clients 8] [--reqs 12]
        [--db-seqs 20000] [--qlen 110] [--window 0.004]
        [--curve N1,N2,...] [--device cuda|cpu]

The server (opal_tpu_torch.serve.Server) holds `db-seqs` random sequences
(np.random.default_rng(5): lengths 80-399, letters uniform over the 20
standard residues) resident and answers the line protocol over TCP on a
free loopback port (Server.bind_tcp). `clients` concurrent clients each
send `reqs` unique single queries of `qlen` residues (SW, top 5), one at a
time; one untimed round of other queries warms the server first. The same
queries run with the batching window `window` and with batch_window=0
(strictly serial), the response cache cleared between; the two runs'
responses must be identical, or the tool raises. `--curve` adds, for each
client count and both windows, the QPS and the p50 / p95 / max latency.

One JSON line. Every socket has a timeout, so a hang fails. On the CPU
(`--device cpu`) the plain versions run at a small size (60 sequences, 3
clients x 2 queries of 24 residues) and no time is reported.
"""
from __future__ import annotations

import argparse
import json
import socket
import threading
import time

import numpy as np

from . import CPU_BLOCK, report, require

TIMEOUT = 300.0  # seconds any socket, barrier or join may wait


def start_server(srv, window: float):
    """srv's TCP front end on a free loopback port, serving from a daemon
    thread; its server_address[1] is the port, close() stops it."""
    tcp = srv.bind_tcp(0, batch_window=window)
    threading.Thread(target=tcp.serve_forever, daemon=True).start()
    return tcp


def connect(port: int, timeout: float = TIMEOUT):
    """A connection to the server on `port` and its line file, the ready
    banner read (a few tries ride out a burst on the accept queue)."""
    last = None
    for _ in range(5):
        try:
            c = socket.create_connection(("127.0.0.1", port),
                                         timeout=timeout)
            break
        except OSError as exc:
            last = exc
            time.sleep(0.2)
    else:
        raise last
    f = c.makefile("rw")
    require(json.loads(f.readline()).get("ready"), "no ready banner")
    return c, f


def request(f, req: dict):
    """(seconds, response) of one request line on an open connection."""
    t0 = time.perf_counter()
    f.write(json.dumps(req) + "\n")
    f.flush()
    line = f.readline()
    dt = time.perf_counter() - t0
    require(line, "the server closed the connection")
    return dt, json.loads(line)


def run_clients(port, n_clients, n_reqs, queries, collect, latencies=None,
                top_k=5):
    """Seconds from a common start until `n_clients` clients, each sending
    its `n_reqs` of `queries` one at a time, have all their answers.
    collect[(client, request)] receives each hit list and `latencies` each
    request's seconds. A client's failure raises here."""
    barrier = threading.Barrier(n_clients + 1)
    errors = []

    def client(ci):
        try:
            c, f = connect(port)
            with c:
                barrier.wait(timeout=TIMEOUT)
                for r in range(n_reqs):
                    dt, resp = request(f, {
                        "id": [ci, r], "query": queries[ci * n_reqs + r],
                        "top_k": top_k})
                    require("hits" in resp, f"error response {resp}")
                    collect[(ci, r)] = resp["hits"]
                    if latencies is not None:
                        latencies.append(dt)
        except BaseException as exc:  # noqa: BLE001 (raised below)
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(n_clients)]
    for t in threads:
        t.start()
    try:
        barrier.wait(timeout=TIMEOUT)
    except threading.BrokenBarrierError:
        pass
    t0 = time.perf_counter()
    for t in threads:
        t.join(TIMEOUT)
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    require(not any(t.is_alive() for t in threads), "a client hung")
    return dt


def random_queries(rng, alphabet, n, qlen):
    return ["".join(alphabet[j] for j in rng.integers(0, 20, size=qlen))
            for _ in range(n)]


def _clear_cache(srv):
    srv._cache.clear()
    srv._cache_bytes = 0


def run(srv, clients=8, reqs=12, qlen=110, window=0.004, curve=None,
        seed=5):
    """The A/B of the module docstring on a Server `srv` (its resident
    database as it is), and the curve over the client counts `curve`.
    Returns the result dict; "answers" holds the batched run's hit list of
    each query."""
    alpha = srv.sm.alphabet
    rng = np.random.default_rng(seed)
    n_total = clients * reqs
    queries = random_queries(rng, alpha, n_total, qlen)
    warmq = random_queries(rng, alpha, n_total, qlen)
    srv.warm([qlen] * min(8, clients))
    _clear_cache(srv)

    def one_run(win, qs, collect, latencies=None, n_clients=clients):
        tcp = start_server(srv, win)
        try:
            return run_clients(tcp.server_address[1], n_clients, reqs, qs,
                               collect, latencies)
        finally:
            tcp.close()

    one_run(window, warmq, {})
    batched = {}
    dt_b = one_run(window, queries, batched)
    _clear_cache(srv)
    serial = {}
    dt_s = one_run(0.0, queries, serial)
    require(batched == serial, "batched responses differ from serial")
    res = {"n_db": len(srv.db), "residues": int(srv.ddb.total_residues),
           "clients": clients, "reqs": reqs, "qlen": qlen, "window": window,
           "batched_s": dt_b, "serial_s": dt_s,
           "batched_qps": n_total / dt_b, "serial_qps": n_total / dt_s,
           "speedup": dt_s / dt_b, "identical": True}
    points = []
    for win in ((window, 0.0) if curve else ()):
        for nc in curve:
            _clear_cache(srv)
            n = nc * reqs
            one_run(win, random_queries(rng, alpha, n, qlen), {},
                    n_clients=nc)
            lat = []
            dt = one_run(win, random_queries(rng, alpha, n, qlen), {},
                         lat, n_clients=nc)
            lat_ms = np.sort(np.array(lat) * 1e3)
            points.append({
                "clients": nc, "window": win, "qps": n / dt,
                "p50_ms": float(np.percentile(lat_ms, 50)),
                "p95_ms": float(np.percentile(lat_ms, 95)),
                "max_ms": float(lat_ms[-1])})
    if curve:
        res["curve"] = points
    res["answers"] = {queries[ci * reqs + r]: hits
                      for (ci, r), hits in batched.items()}
    return res


def random_fasta_db(n, lut, alphabet, seed=5):
    """The tool's database: n sequences of 80-399 uniform residues, as
    alphabet indices, and their names."""
    rng = np.random.default_rng(seed)
    db = []
    for _ in range(n):
        L = int(rng.integers(80, 400))
        s = "".join(alphabet[j] for j in rng.integers(0, 20, size=L))
        db.append(lut[np.frombuffer(s.encode(), np.uint8)])
    return db, [f"t{i}" for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--reqs", type=int, default=12)
    ap.add_argument("--db-seqs", type=int, default=20000)
    ap.add_argument("--qlen", type=int, default=110)
    ap.add_argument("--window", type=float, default=0.004)
    ap.add_argument("--curve", default=None, metavar="N1,N2,...",
                    help="client counts to sweep, each with the window on "
                         "and off")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..engine.search import resolve_device
    from ..matrices import ScoreMatrix
    from ..serve import Server

    dev = resolve_device(a.device)
    if dev.type == "cpu":
        a.db_seqs, a.clients, a.reqs, a.qlen = (min(a.db_seqs, 60),
                                                min(a.clients, 3),
                                                min(a.reqs, 2),
                                                min(a.qlen, 24))
    sm = ScoreMatrix.blosum50()
    db, names = random_fasta_db(a.db_seqs, sm.letter_index(), sm.alphabet)
    srv = Server.from_sequences(
        db, names, sm, block_size=CPU_BLOCK if dev.type == "cpu" else 1024,
        device=str(dev))
    curve = [int(c) for c in a.curve.split(",")] if a.curve else None
    res = run(srv, a.clients, a.reqs, a.qlen, a.window, curve)
    res.pop("answers")
    report("serve_qps", dev, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
