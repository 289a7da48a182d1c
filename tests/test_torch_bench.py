"""The port's headline bench (opal_tpu_torch.bench), its synthetic-database
tool (opal_tpu_torch.synth) and its compile-check entry
(opal_tpu_torch.parallel.dryrun.entry) on the CPU, against the JAX
package's bench.py inputs, tools/make_synth_db.py and
__graft_entry__.entry.

Everything here is exact (int32 scores, bytes): tolerance 0. The bench's
protocol runs with the plain versions on a small database (BENCH_SEQS
300); on the card tests/test_torch_cuda.py runs it at 20,000 sequences
through ragged_dp.
"""
import gzip
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from opal_tpu.constants import MODE_SW as JAX_MODE_SW
from opal_tpu.constants import SEARCH_SCORE as JAX_SEARCH_SCORE
from opal_tpu.engine import search as jax_search
from opal_tpu_torch import bench, synth, tools
from opal_tpu_torch.matrices import ScoreMatrix
from opal_tpu_torch.parallel.dryrun import entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_synth_db():
    """tools/make_synth_db.py as a module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "tpu_tool_make_synth_db", os.path.join(ROOT, "tools",
                                               "make_synth_db.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,seed", [(40, 12071), (25, 3)])
def test_make_db_matches_the_jax_tool(n, seed):
    assert synth.make_db(n, seed) == _make_synth_db().make_db(n, seed)


def test_make_db_arrays_matches_the_jax_tool():
    want = _make_synth_db().make_db_arrays(60, seed=12071)
    got = synth.make_db_arrays(60, seed=12071)
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_write_fasta_equals_the_committed_fixture(tmp_path):
    out = tmp_path / "synth12071.fasta"
    synth.write_fasta(str(out), synth.make_db(12071, 12071))
    with gzip.open(os.path.join(ROOT, "tests", "data",
                                "synth12071.fasta.gz"), "rb") as f:
        want = f.read()
    assert out.read_bytes() == want


def test_synth_cli_writes_the_jax_tools_bytes(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = {}
    for tag, cmd in (("port", [sys.executable, "-m", "opal_tpu_torch.synth"]),
                     ("jax", [sys.executable, os.path.join(
                         ROOT, "tools", "make_synth_db.py")])):
        out = tmp_path / f"{tag}.fasta"
        r = subprocess.run(cmd + [str(out), "40", "7"], capture_output=True,
                           text=True, timeout=120, cwd=ROOT, env=env)
        assert r.returncode == 0, r.stderr
        runs[tag] = (out.read_bytes(), r.stdout.replace(str(out), "OUT"))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0].startswith(b">synth|000000 synthetic sequence")


@pytest.mark.parametrize("block", [64, 128])
def test_measure_matches_jax_search(block):
    """bench.measure's protocol on the CPU: the scores of every run equal
    opal_tpu's xla search of the same query and database; the counts and
    the GCUPS arithmetic are bench.py's."""
    sm = ScoreMatrix.blosum50()
    query = tools.port_query("O74807", sm.letter_index())
    engine, ddb, _, _ = bench.database(300, block, "cpu", sm)
    res = bench.measure(query, ddb, engine, sm)

    want = jax_search.search_database_arrays(
        query, ddb.raw, 3, 1, sm.matrix, mode=JAX_MODE_SW,
        search_type=JAX_SEARCH_SCORE,
        engine=jax_search.Engine(backend="xla", block_size=64))["score"]
    np.testing.assert_array_equal(res["scores"], np.asarray(want))
    assert res["runs_differ"] == 0 and res["gate_mismatches"] == 0
    assert res["gate_seqs"] == bench.GATE_SEQS

    assert res["blocks"] == -(-300 // block) and res["block_size"] == block
    assert res["residues"] == sum(len(s) for s in ddb.raw) and res["Q"] == 110
    assert res["searches"] in (11, 17) and len(res["runs_s"]) == res[
        "searches"]
    assert (res["searches"] == 17) == (
        max(res["runs_s"][:11]) / min(res["runs_s"][:11]) > 1.3)
    assert res["best_s"] == min(res["runs_s"])
    assert res["gcups"] == res["residues"] * 110 / res["best_s"] / 1e9
    # the plain version ran every timed search, and ragged_dp never
    assert res["launches"] == 0 and res["plain_calls"] >= res["searches"]
    assert bench.faults(res, cuda=False) == []
    assert bench.faults(res, cuda=True) == [
        f"the plain version ran {res['plain_calls']} times",
        "a search launched no ragged_dp"]
    line = bench.headline(res["gcups"])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["vs_baseline"] == round(res["gcups"] / 4.08, 2)


def _lines(out):
    return [json.loads(ln) for ln in out.strip().splitlines()]


def test_main_on_the_cpu_reports_no_time(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_SEQS", "40")
    monkeypatch.setenv("BENCH_BLOCK", "16")
    assert bench.main(["--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert lines[-1] == {"metric": "SW_score_GCUPS_per_chip", "value": None,
                         "unit": "GCUPS", "vs_baseline": None,
                         "device": "cpu"}
    by = {ln["bench"]: ln for ln in lines[:-1]}
    assert set(by) == {"setup", "launches", "gate"}
    assert by["setup"]["sequences"] == 40 and by["setup"]["blocks"] == 3
    assert by["launches"]["plain_calls"] > 0
    assert by["launches"]["ragged_dp_per_search"] == 0
    assert by["gate"] == {"bench": "gate", "sample": 40, "mismatches": 0,
                          "runs_differ": 0}
    assert all(tools.untimed(ln) == ln and "card" not in ln
               for ln in lines)


def test_main_on_the_cpu_needs_a_small_database(monkeypatch):
    monkeypatch.delenv("BENCH_SEQS", raising=False)
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu"])
    monkeypatch.setenv("BENCH_SEQS", str(bench.CPU_MAX_SEQS + 1))
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu"])


def test_main_without_cuda_prints_the_error_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert _lines(capsys.readouterr().out) == [{
        "metric": "SW_score_GCUPS_per_chip", "value": 0.0, "unit": "GCUPS",
        "vs_baseline": 0.0, "error": "no CUDA device"}]


def test_a_wrong_score_fails_the_bench(monkeypatch, capsys):
    """A gate mismatch prints an error line and exits 1."""
    monkeypatch.setenv("BENCH_SEQS", "40")
    monkeypatch.setenv("BENCH_BLOCK", "16")
    measure = bench.measure

    def wrong(*args):
        res = measure(*args)
        res["gate_mismatches"] = 1
        return res

    monkeypatch.setattr(bench, "measure", wrong)
    assert bench.main(["--device", "cpu"]) == 1
    last = _lines(capsys.readouterr().out)[-1]
    assert last["value"] == 0.0 and "gate" in last["error"]


def test_entry_matches_the_jax_entry():
    fn, args = entry(device="cpu")
    got = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    for (a, b) in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jfn(*jargs)
    assert set(got) == {"score", "end_q", "end_t"}
    for k, v in got.items():
        assert v.dtype == torch.int32 and tuple(v.shape) == (128,)
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_entry_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
