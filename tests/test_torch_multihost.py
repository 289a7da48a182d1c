"""The port's multi-process search against opal_tpu's, the two-process run
over gloo, the dry run and the scaling tool on the CPU.

MultiHostSearch in one process is held against opal_tpu's MultiHostSearch
(xla engine) on the same FASTA shards, record by record. Two OS processes
(python -m opal_tpu_torch.parallel.multihost, a gloo process group on
localhost) must agree with each other and with a single-process search
over the same shard layout. Every wait is bounded: the processes by
subprocess timeouts, the process group by its 60 s timeout.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from opal_tpu.engine.search import Engine as JaxEngine
from opal_tpu.matrices import ScoreMatrix as JaxScoreMatrix
from opal_tpu.parallel.multihost import MultiHostSearch as JaxMultiHost
from opal_tpu_torch.constants import (
    MODE_HW,
    MODE_SW,
    SEARCH_ALIGNMENT,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from opal_tpu_torch.engine.search import Engine, search_database
from opal_tpu_torch.fasta import read_fasta_file
from opal_tpu_torch.matrices import ScoreMatrix
from opal_tpu_torch.parallel.dryrun import dryrun_multichip
from opal_tpu_torch.parallel.multihost import (
    MultiHostSearch,
    shard_for_process,
)
from opal_tpu_torch.parallel.shard import db_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """4 FASTA shards of 5 sequences (one of them a copy of another, for a
    tie across shards) and a query file."""
    d = tmp_path_factory.mktemp("shards")
    alpha = ScoreMatrix.blosum50().alphabet
    rng = np.random.default_rng(99)
    paths = []
    seqs = []
    for s in range(4):
        lines = []
        for i in range(5):
            seq = "".join(alpha[j] for j in rng.integers(
                0, 20, size=int(rng.integers(20, 80))))
            if (s, i) == (3, 4):
                seq = seqs[1]
            seqs.append(seq)
            lines.append(f">s{s}_{i}\n{seq}\n")
        p = d / f"shard{s}.fa"
        p.write_text("".join(lines))
        paths.append(str(p))
    q = "".join(alpha[j] for j in rng.integers(0, 20, size=40))
    qpath = d / "q.fa"
    qpath.write_text(f">q\n{q}\n")
    return paths, str(qpath)


def _query(qpath):
    qs, _ = read_fasta_file(qpath, ScoreMatrix.blosum50().letter_index())
    return qs[0]


def test_shard_for_process():
    paths = ["a", "b", "c", "d", "e"]
    assert shard_for_process(paths, 0, 2) == ["a", "c", "e"]
    assert shard_for_process(paths, 1, 2) == ["b", "d"]
    assert shard_for_process(paths, 0, 1) == paths
    assert shard_for_process(paths, 3, 4) == ["d"]
    assert shard_for_process(["a"], 1, 2) == []


@pytest.mark.parametrize("mode", [MODE_SW, MODE_HW])
@pytest.mark.parametrize("search_type", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("top_k", [0, 10])
def test_one_process_matches_jax(shards, mode, search_type, top_k):
    """ranked (every record, and the device-ranked top 10) in one process,
    on a 3-part mesh, against opal_tpu's MultiHostSearch."""
    paths, qpath = shards
    query = _query(qpath)
    mh = MultiHostSearch(paths, ScoreMatrix.blosum50(), engine=Engine(
        device="cpu", block_size=4, mesh=db_mesh(["cpu"] * 3)))
    jmh = JaxMultiHost(paths, JaxScoreMatrix.blosum50(),
                       engine=JaxEngine(backend="xla", block_size=8))
    assert mh.shard_sizes == jmh.shard_sizes == [20]
    assert len([p for p in mh.ddb.parts if p.blocks]) > 1
    got = mh.ranked(query, mode=mode, top_k=top_k, search_type=search_type)
    want = jmh.ranked(query, mode=mode, top_k=top_k,
                      search_type=search_type)
    assert got == want
    sizes, table = mh.search(query, mode=mode, search_type=search_type)
    jsizes, jtable = jmh.search(query, mode=mode, search_type=search_type)
    assert sizes == jsizes
    np.testing.assert_array_equal(table, jtable)


@pytest.mark.parametrize("mode", [MODE_SW, MODE_HW])
def test_one_process_aligned_matches_jax(shards, mode):
    paths, qpath = shards
    query = _query(qpath)
    mh = MultiHostSearch(paths, ScoreMatrix.blosum50(), engine=Engine(
        device="cpu", block_size=4, mesh=db_mesh(["cpu"] * 2)))
    jmh = JaxMultiHost(paths, JaxScoreMatrix.blosum50(),
                       engine=JaxEngine(backend="xla", block_size=8))
    got = mh.search_aligned(query, mode=mode, top_k=6)
    want = jmh.search_aligned(query, mode=mode, top_k=6)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            if k == "ops":
                assert (g[k] is None) == (w[k] is None)
                if g[k] is not None:
                    np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_ranking(shards, tmp_path):
    """Two OS processes in one gloo group, each on its 2 of the 4 shards
    (a 2-part mesh each): both write the same global results, equal to a
    single-process search over the same shard layout."""
    paths, qpath = shards
    out = str(tmp_path / "out.json")
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "opal_tpu_torch.parallel.multihost",
         "--init-method", init, "--rank", str(r), "--world-size", "2",
         "--query", qpath, "--out", out, "--device", "cpu", "--mesh", "2",
         "--block-size", "4", *paths], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        outs = [p.communicate(timeout=90) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
    res = []
    for r in range(2):
        with open(f"{out}.{r}") as f:
            res.append(json.load(f))
    for r in res:  # each process ran the plain versions, on its 2 parts
        assert r.pop("plain_calls")["ragged_score_plain"] >= 2
        assert r.pop("launches")["ragged_dp"] == 0
    assert res[0] == res[1]
    assert res[0]["sizes"] == [10, 10]

    sm = ScoreMatrix.blosum50()
    query = _query(qpath)
    lut = sm.letter_index()
    eng = Engine(device="cpu", block_size=8)
    want, full = [], {}
    for s in range(2):
        shard = [seq for p in shard_for_process(paths, s, 2)
                 for seq in read_fasta_file(p, lut)[0]]
        for i, r in enumerate(search_database(
                query, shard, 3, 1, sm.matrix, mode=MODE_SW,
                search_type=SEARCH_ALIGNMENT, engine=eng)):
            want.append((r.score, s, i))
            full[(s, i)] = r
    want.sort(key=lambda t: (-t[0], t[1], t[2]))
    assert [tuple(r) for r in res[0]["ranked"]] == want[:10]
    assert [tuple(r[:3]) for r in res[0]["ranked_ends"]] == want[:10]
    for sc, s, i, eq, et in res[0]["ranked_ends"]:
        r = full[(s, i)]
        assert (eq, et) == (r.end_location_query, r.end_location_target)
    assert [(w["score"], w["shard"], w["index"])
            for w in res[0]["aligned"]] == want[:5]
    for w in res[0]["aligned"]:
        r = full[(w["shard"], w["index"])]
        assert (w["start_q"], w["start_t"], w["end_q"], w["end_t"]) == (
            r.start_location_query, r.start_location_target,
            r.end_location_query, r.end_location_target)
        assert w["ops"] == (None if r.alignment is None
                            else list(r.alignment))


def test_dryrun_multichip_cpu(capsys):
    """The dry run over 8 mesh devices, the CPU named 8 times."""
    out = dryrun_multichip(8, devices=["cpu"] * 8)
    assert out["devices"] == 8 and out["distinct_devices"] == 1
    assert out["live_parts"] > 1
    assert [r["devices"] for r in out["scaling"]] == [1, 2, 4, 8]
    text = capsys.readouterr().out
    assert "repeated round-robin" in text
    assert text.strip().splitlines()[-1].startswith(
        "dryrun_multichip(8): OK")


def test_scaling_bench_cpu(capsys):
    """The scaling tool on the CPU: one JSON line per mesh size, the
    partitioning checked and said to be no measure of speedup."""
    from opal_tpu_torch.tools import scaling_bench

    assert scaling_bench.main(["--device", "cpu", "--n-seqs", "300",
                               "--query-len", "20", "--block-size", "16",
                               "--mesh", "4"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["device"] == "cpu" and "seconds" not in r
        assert r["blocks"] == 19
        assert 1 < r["parts_with_blocks"] <= r["devices"] or (
            r["devices"] == 1 and "note" not in r)
        if r["devices"] > 1:
            assert "not the speedup" in r["note"]
