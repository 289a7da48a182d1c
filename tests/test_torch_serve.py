"""The port's server (opal_tpu_torch.serve, on the CPU) against opal_tpu's
(opal_tpu.serve.Server with its xla engine): both load
tests/port_data/uniprot_sprot15.fasta and answer the same request script,
line for line. The one expected difference is align=true, which the port
answers with the protocol's error line until full alignment is ported."""
import io
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from opal_tpu.serve import Server as JaxServer
from opal_tpu_torch import serve
from opal_tpu_torch.engine import kernels
from opal_tpu_torch.fasta import read_fasta_file
from opal_tpu_torch.matrices import ScoreMatrix
from opal_tpu_torch.serve import Server

HERE = os.path.dirname(os.path.abspath(__file__))
DB = os.path.join(HERE, "port_data", "uniprot_sprot15.fasta")
B = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def servers():
    return (Server(DB, block_size=B, device="cpu"),
            JaxServer(DB, block_size=B, backend="xla"))


def _script():
    """Request lines: single queries (pieces of database sequences and
    random ones), batches, the other modes, top_k 0, names, gaps, a cache
    hit, align, and malformed lines."""
    alpha = ScoreMatrix.blosum50().alphabet
    rng = np.random.default_rng(2)
    db_text = open(DB).read().split(">")[1:]
    seqs = ["".join(chunk.splitlines()[1:]) for chunk in db_text]
    rnd = ["".join(alpha[j] for j in rng.integers(0, 20, size=n))
           for n in (25, 61, 17)]
    pieces = [seqs[3][10:50], seqs[7][:33], seqs[0][100:118]]
    reqs = [
        {"id": 1, "query": pieces[0], "top_k": 5},
        {"id": 2, "queries": pieces + rnd, "top_k": 3},
        {"id": 3, "query": pieces[1], "mode": "NW", "top_k": 4},
        {"id": 4, "queries": [rnd[0], pieces[2]], "mode": "HW"},
        {"id": 5, "queries": [pieces[0], rnd[1]], "mode": "OV",
         "top_k": 0},
        {"id": 6, "query": rnd[2], "top_k": 0, "names": True},
        {"id": "seven", "query": pieces[2], "gap_open": 10, "gap_ext": 2,
         "names": True},
        {"id": 8, "query": pieces[0], "top_k": 5},  # a cache hit
        {"id": 9, "query": pieces[1], "top_k": 2, "align": True},
        {"id": 10, "query": ""},
        {"id": 11, "nonsense": True},
        {"id": 12, "query": "ACDE", "top_k": -5},
        {"id": 13, "query": "ACDE", "mode": "XX"},
        {"id": 14, "queries": []},
        {"query": pieces[1], "top_k": 1},
    ]
    return [json.dumps(r) for r in reqs] + [
        "this is not json", "[1, 2, 3]", '{"query": 42}']


def _assert_lines_equal(got, want, lines):
    assert len(got) == len(want) == len(lines)
    for g, w, line in zip(got, want, lines):
        if json.loads(line).get("align") if line.startswith("{") else False:
            resp = json.loads(g)
            assert resp["error"].startswith("NotImplementedError"), g
            assert resp["id"] == json.loads(w)["id"]
            continue
        assert g == w, line


def test_run_matches_jax_line_for_line(servers):
    mine, theirs = servers
    lines = _script()
    outs = []
    for srv in (mine, theirs):
        srv._cache.clear()
        fout = io.StringIO()
        srv.run(io.StringIO("\n".join(lines) + "\n\n"), fout)
        outs.append(fout.getvalue().splitlines())
    assert outs[0][0] == outs[1][0]  # the ready banner
    assert json.loads(outs[0][0]) == {"ready": True, "n_db": 15,
                                      "residues": 4491}
    _assert_lines_equal(outs[0][1:], outs[1][1:], lines)
    assert json.loads(outs[0][1])["hits"] == json.loads(outs[0][8])["hits"]


def test_respond_many_matches_jax(servers):
    """Cross-request batching: compatible requests share stacked launches
    and still answer byte for byte as opal_tpu does."""
    mine, theirs = servers
    lines = _script()
    mine._cache.clear()
    theirs._cache.clear()
    calls = kernels.PLAIN_CALLS["multi_score_plain"]
    got = mine._respond_many(lines)
    assert kernels.PLAIN_CALLS["multi_score_plain"] > calls
    _assert_lines_equal(got, theirs._respond_many(lines), lines)
    # and each equals the per-line answer of a cold server
    mine._cache.clear()
    assert got == [mine._respond(line) for line in lines]


def test_from_sequences_equals_fasta_constructor(servers):
    mine, _ = servers
    sm = ScoreMatrix.blosum50()
    db, names, _ = read_fasta_file(DB, sm.letter_index(), return_names=True)
    other = Server.from_sequences(db, names, sm, block_size=B, device="cpu")
    req = {"queries": ["MAFSAEDVLKEYDRRRRM", "KVLSDLDAKIKAY"], "top_k": 4,
           "names": True}
    assert other.handle(req) == mine.handle(req)
    assert other._ready_banner() == mine._ready_banner()
    with pytest.raises(ValueError):
        Server.from_sequences(db, names[:3], sm, device="cpu")


def test_warm_runs_every_search_kind(servers):
    mine, _ = servers
    calls = dict(kernels.PLAIN_CALLS)
    mine.warm([18, 33])
    mine.warm([25])  # one length: stacks a duplicated pair
    assert kernels.PLAIN_CALLS["multi_score_plain"] == (
        calls["multi_score_plain"] + 4)
    assert kernels.PLAIN_CALLS["ragged_score_plain"] > (
        calls["ragged_score_plain"])


def test_main_answers_stdin(monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO(
        '{"id": 1, "query": "MAFSAEDVLKEY", "top_k": 2}\n'))
    assert serve.main([DB, "--device", "cpu", "--block-size", "16"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[0])["ready"]
    resp = json.loads(out[1])
    assert resp["id"] == 1 and len(resp["hits"]) == 2


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(DB)


def test_serve_tcp_loopback(servers):
    """TCP on port 0: concurrent clients inside one batch window get the
    answers of per-request handling, and a malformed line its error."""
    mine, _ = servers
    mine._cache.clear()
    t = threading.Thread(target=mine.serve_tcp, args=(0,),
                         kwargs={"batch_window": 0.05}, daemon=True)
    t.start()
    for _ in range(200):
        if getattr(mine, "tcp_server", None) is not None:
            break
        threading.Event().wait(0.05)
    port = mine.tcp_server.server_address[1]
    queries = ["MAFSAEDVLKEYDRR", "KVLSDLDAKIKAYNLTV", "GHGPDGPDILT",
               "QHVAAFLKELRHSKQY"]
    results = {}

    def client(i):
        with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
            f = c.makefile("rw")
            assert json.loads(f.readline())["ready"]
            f.write(json.dumps({"id": i, "query": queries[i], "top_k": 3})
                    + "\n")
            f.flush()
            results[i] = json.loads(f.readline())
            f.write("not json\n")
            f.flush()
            results[i, "bad"] = json.loads(f.readline())

    try:
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(queries))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(60)
        assert not any(c.is_alive() for c in clients)
        for i, q in enumerate(queries):
            assert results[i]["id"] == i
            assert results[i]["hits"] == mine.handle(
                {"query": q, "top_k": 3})["hits"]
            assert "error" in results[i, "bad"]
    finally:
        mine.tcp_server.shutdown()
        t.join(10)
    assert not t.is_alive()
