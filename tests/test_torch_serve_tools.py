"""The port's package level, ranking, server keepalive and flags, and its
serving tools (opal_tpu_torch.tools.serve_qps, serve_latency) on the CPU,
against opal_tpu on the same inputs. Every comparison is exact equality.

- Every public package-level name of opal_tpu exists on opal_tpu_torch,
  the constants with equal values.
- ranking.top_k_results and merge_shard_scores equal opal_tpu's: unset and
  score-0 results, ties, padded shard rows.
- Server.start_keepalive beats beside requests without changing them
  (tests/test_serve.py::test_serve_keepalive_thread on the port), stops
  when asked, and ends by itself when a beat fails; --keepalive parses
  (default 30, 0 off), and every flag of opal_tpu.serve but --backend
  parses on the port to the same value.
- serve_qps' and serve_latency's served hits equal opal_tpu's server's
  (opal_tpu.serve.Server, xla engine) for every query.
"""
import argparse
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

import opal_tpu
import opal_tpu.ranking as jax_ranking
import opal_tpu.serve as jax_serve
import opal_tpu_torch
from opal_tpu.result import SearchResult as JaxResult
from opal_tpu_torch import ranking, serve
from opal_tpu_torch.matrices import ScoreMatrix
from opal_tpu_torch.result import SearchResult
from opal_tpu_torch.tools import serve_latency, serve_qps

B = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db_path(tmp_path_factory):
    """A FASTA file of 40 random sequences of 30-119 residues (seed 31)."""
    alpha = ScoreMatrix.blosum50().alphabet
    rng = np.random.default_rng(31)
    path = tmp_path_factory.mktemp("db") / "db.fa"
    with open(path, "w") as f:
        for i in range(40):
            s = "".join(alpha[j] for j in rng.integers(
                0, 20, size=int(rng.integers(30, 120))))
            f.write(f">s{i}\n{s}\n")
    return str(path)


@pytest.fixture(scope="module")
def servers(db_path):
    return (serve.Server(db_path, block_size=B, device="cpu"),
            jax_serve.Server(db_path, block_size=B, backend="xla"))


# ------------------------------------------------------------ package level

LAZY = ("search_database", "search_database_arrays",
        "search_database_multi_arrays", "Engine", "EngineConfig",
        "search_database_char_sw")


def test_every_public_package_name_exists_on_the_port():
    names = [n for n in dir(opal_tpu) if not n.startswith("_")]
    for name in names + list(LAZY):
        assert hasattr(opal_tpu_torch, name), name
        want = getattr(opal_tpu, name)
        if isinstance(want, (int, str)):
            assert getattr(opal_tpu_torch, name) == want, name
    for name in ("ALIGN_MATCH", "ALIGN_DEL", "ALIGN_INS", "ALIGN_MISMATCH"):
        assert getattr(opal_tpu_torch, name) == getattr(opal_tpu, name)


# ------------------------------------------------------------------ ranking

def _results(cls, scores):
    out = []
    for s in scores:
        r = cls()
        if s is not None:
            r.score, r.score_set = s, 1
        out.append(r)
    return out


@pytest.mark.parametrize("k", [0, 1, 3, 7, 20])
def test_top_k_results_matches_jax(k):
    """Ties, score 0, negative scores and unset results (which rank
    last)."""
    scores = [5, None, 0, 5, -3, 9, None, 0, 5, 2, 9, -3]
    got = ranking.top_k_results(_results(SearchResult, scores), k)
    want = jax_ranking.top_k_results(_results(JaxResult, scores), k)
    assert [i for i, _ in got] == [i for i, _ in want]
    assert [(r.score, r.score_set) for _, r in got] == \
        [(r.score, r.score_set) for _, r in want]


@pytest.mark.parametrize("shape", ["vectors", "tables", "none"])
def test_merge_shard_scores_matches_jax(shape):
    """Padded all-gather rows trimmed to each shard's size, shard order."""
    rng = np.random.default_rng(8)
    sizes = [3, 0, 5, 1]
    if shape == "vectors":
        rows = [rng.integers(-50, 50, size=6, dtype=np.int32)
                for _ in sizes]
    elif shape == "tables":
        rows = [rng.integers(-50, 50, size=(6, 4), dtype=np.int32)
                for _ in sizes]
    else:
        rows, sizes = [], []
    got = ranking.merge_shard_scores(rows, sizes)
    want = jax_ranking.merge_shard_scores(rows, sizes)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- the keepalive

def _roundtrip(srv, reqs):
    fin = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
    fout = io.StringIO()
    srv.run(fin, fout)
    return fout.getvalue().splitlines()[1:]


def _beats():
    return [t for t in threading.enumerate() if t.name == "opal-keepalive"]


def test_serve_keepalive_thread(servers):
    """The heartbeat runs beside request handling without disturbing the
    responses, and stops when asked."""
    srv, _ = servers
    alpha = srv.sm.alphabet
    rng = np.random.default_rng(3)
    q = "".join(alpha[j] for j in rng.integers(0, 20, size=22))
    before = _roundtrip(srv, [{"id": 1, "query": q, "top_k": 3}])
    old = set(_beats())
    stop = srv.start_keepalive(interval=0.05)
    mine = [t for t in _beats() if t not in old]
    try:
        assert len(mine) == 1 and mine[0].daemon
        time.sleep(0.3)  # several heartbeats
        after = _roundtrip(srv, [{"id": 1, "query": q, "top_k": 3}])
        assert before == after
    finally:
        stop()
    mine[0].join(5)
    assert not mine[0].is_alive()


def test_keepalive_beat_that_fails_ends_quietly(servers, monkeypatch):
    """A beat that raises ends the thread and nothing else."""
    srv, _ = servers
    monkeypatch.setattr(srv.engine, "device", torch.device("meta"))
    old = set(_beats())
    stop = srv.start_keepalive(interval=0.01)
    mine = [t for t in _beats() if t not in old]
    try:
        for t in mine:
            t.join(5)
        assert not any(t.is_alive() for t in mine)
    finally:
        stop()
    monkeypatch.undo()
    assert "hits" in srv.handle({"query": "MKVLA", "top_k": 1})


def _jax_parser():
    """opal_tpu.serve's argument parser, caught as its main() parses."""
    class Caught(Exception):
        pass

    box = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, *a, **kw):
        box["p"] = self
        raise Caught

    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(Caught):
            jax_serve.main(["db.fa"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return box["p"]


SAMPLE = {int: "7", float: "0.5"}


def test_every_jax_serve_flag_parses_on_the_port():
    jp = _jax_parser()
    argv = ["db.fa"]
    dests = []
    for act in jp._actions:
        flag = next((o for o in act.option_strings if o.startswith("--")),
                    None)
        if flag in (None, "--help", "--backend"):
            continue
        dests.append(act.dest)
        argv.append(flag)
        if act.nargs != 0:
            argv.append("10,20" if flag == "--warm"
                        else SAMPLE.get(act.type, "x"))
    assert "keepalive" in dests
    mine = serve.arg_parser().parse_args(argv)
    theirs = jp.parse_args(argv + ["--backend", "xla"])
    for d in dests:
        assert getattr(mine, d) == getattr(theirs, d), d


def test_keepalive_flag_default_and_off(db_path, monkeypatch):
    assert serve.arg_parser().parse_args(["db.fa"]).keepalive == 30.0
    assert serve.arg_parser().parse_args(
        ["db.fa", "--keepalive", "0"]).keepalive == 0.0
    started = []
    monkeypatch.setattr(serve.Server, "start_keepalive",
                        lambda self, interval=30.0: started.append(interval))
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    out = io.StringIO()
    monkeypatch.setattr("sys.stdout", out)
    base = [db_path, "--device", "cpu", "--block-size", str(B)]
    assert serve.main(base + ["--keepalive", "0"]) == 0
    assert started == []
    assert serve.main(base + ["--keepalive", "2.5"]) == 0
    assert serve.main(base) == 0
    assert started == [2.5, 30.0]


# ------------------------------------------------------------ serve tools

def _jax_hits(jsrv, q, top_k, align=False):
    return jsrv.handle({"query": q, "top_k": top_k, "align": align})["hits"]


def test_serve_qps_hits_match_jax(servers):
    """Batched equals serial inside the tool; every query's hits equal
    opal_tpu's server's."""
    srv, jsrv = servers
    res = serve_qps.run(srv, clients=3, reqs=2, qlen=20, curve=[1, 2])
    assert res["identical"] and len(res["answers"]) == 6
    assert [(p["clients"], p["window"]) for p in res["curve"]] == [
        (1, 0.004), (2, 0.004), (1, 0.0), (2, 0.0)]
    for q, hits in res["answers"].items():
        assert hits == _jax_hits(jsrv, q, 5), q


@pytest.mark.parametrize("align", [False, True])
def test_serve_latency_hits_match_jax(servers, align):
    srv, jsrv = servers
    res = serve_latency.run(srv, qlen=25, top_k=4, reps=2, align=align)
    assert len(res["request_ms"]) == 2 and res["align"] is align
    for q, hits in res["answers"].items():
        assert hits == _jax_hits(jsrv, q, 4, align), q


def test_serve_tools_raise_on_a_short_answer(servers, monkeypatch):
    """serve_latency's equality (min(top_k, n) hits) is a hard failure."""
    from opal_tpu_torch.tools import Mismatch

    srv, _ = servers
    monkeypatch.setattr(srv, "_answers", lambda qs, fields: [[]] * len(qs))
    srv._cache.clear()
    try:
        with pytest.raises(Mismatch):
            serve_latency.run(srv, qlen=21, top_k=4, reps=1)
    finally:
        srv._cache.clear()
