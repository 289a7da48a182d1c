"""The port's host knobs, panel knobs and search tools on the CPU, against
opal_tpu (its xla engine) on the same inputs. Every comparison is exact
equality.

- OPAL_TPU_TRACEBACK_WORKERS 0, 1 and 4 give the same x2 output;
  OPAL_TPU_TB_FULL_CELLS low enough to checkpoint gives the output of the
  default and of opal_tpu under the same setting; OPAL_TPU_NO_NATIVE=1
  gives the same output through the pure-Python path.
- OPAL_TPU_FORCE_PANELS at panel heights 16, 32 and 48
  (OPAL_TPU_PANEL_ROWS) and OPAL_TPU_NO_PANELS give, in 4 modes at x0 and
  x1, the results of no knob and of opal_tpu; each takes its route; a bad
  height raises; a forced search never stacks.
- The tools' run(..., on the CPU) answers: exp_x1_gap's x0/x1 results,
  exp_topk's top-k rows, exp_align_topk's alignments, perf's 4 modes (and
  its stacked pass), tb_scaling's alignments across worker counts, and
  the panel tools' results equal opal_tpu's.
"""
import numpy as np
import pytest
import torch

from opal_tpu.engine.search import Engine as JaxEngine
from opal_tpu.engine.search import alignment_pass as jax_alignment_pass
from opal_tpu.engine.search import search_database as jax_search_database
from opal_tpu.engine.search import \
    search_database_arrays as jax_search_arrays
from opal_tpu.result import SearchResult as JaxResult
from opal_tpu_torch import _native
from opal_tpu_torch.constants import (MODE_CODES, MODE_SW,
                                      SEARCH_ALIGNMENT, SEARCH_SCORE_END)
from opal_tpu_torch.engine import backend, kernels
from opal_tpu_torch.engine.search import (Engine, search_database,
                                          search_database_arrays,
                                          search_database_multi_arrays)
from opal_tpu_torch.matrices import ScoreMatrix
from opal_tpu_torch.tools import (exp_align_topk, exp_panel_mesh,
                                  exp_panel_rows, exp_panels, exp_topk,
                                  exp_x1_gap, perf, port_query, tb_scaling)

B = 16
MODES = ("SW", "NW", "HW", "OV")
KNOBS = ("OPAL_TPU_FORCE_PANELS", "OPAL_TPU_NO_PANELS", "OPAL_TPU_PANEL_ROWS",
         "OPAL_TPU_TRACEBACK_WORKERS", "OPAL_TPU_TB_FULL_CELLS",
         "OPAL_TPU_NO_NATIVE", "OPAL_TPU_DEVICE_FILL")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def problem():
    """BLOSUM50, a 37-residue query and 40 sequences of 1..90 letters."""
    rng = np.random.default_rng(4321)
    sm = ScoreMatrix.blosum50()
    query = rng.integers(0, 20, size=37).astype(np.uint8)
    db = [rng.integers(0, 20, size=int(n)).astype(np.uint8)
          for n in rng.integers(1, 91, size=40)]
    return sm, query, db


@pytest.fixture(scope="module")
def engines():
    return Engine(device="cpu", block_size=B), JaxEngine(backend="xla",
                                                         block_size=B)


def _fields(res):
    return [(r.score, r.end_location_query, r.end_location_target,
             r.start_location_query, r.start_location_target,
             None if r.alignment is None else bytes(r.alignment))
            for r in res]


def _x2(problem, engine, jax=False, mode=MODE_SW):
    sm, query, db = problem
    fn = jax_search_database if jax else search_database
    return _fields(fn(query, db, 3, 1, sm.matrix, mode=mode,
                      search_type=SEARCH_ALIGNMENT, engine=engine))


# ---------------------------------------------------------- the host knobs

@pytest.mark.parametrize("mode", ["SW", "OV"])
def test_traceback_workers_give_the_same_paths(problem, engines, mode,
                                               monkeypatch):
    """40 pairs (>= 32: the pool runs unless the knob says serial)."""
    eng, _ = engines
    outs = []
    for w in ("0", "1", "4"):
        monkeypatch.setenv("OPAL_TPU_TRACEBACK_WORKERS", w)
        outs.append(_x2(problem, eng, mode=MODE_CODES[mode]))
    assert outs[0] == outs[1] == outs[2]


def _spy_checkpoints(monkeypatch):
    """The `ck` argument (0: full store, else checkpointed) of every native
    traceback call from now on."""
    seen = []
    lib = _native._get_lib()

    class Spy:
        def __getattr__(self, name):
            return getattr(lib, name)

        def opal_find_alignment(self, *args):
            seen.append(args[14])
            return lib.opal_find_alignment(*args)

    monkeypatch.setattr(_native, "_get_lib", lambda: Spy())
    return seen


def test_checkpointed_traceback_matches_default_and_jax(problem, engines,
                                                        monkeypatch):
    """OPAL_TPU_TB_FULL_CELLS is read at each call: 50 cells checkpoints
    (ck > 0) and changes no output."""
    eng, jeng = engines
    assert _native.available()
    seen = _spy_checkpoints(monkeypatch)
    default = _x2(problem, eng)
    assert seen and not any(seen)
    monkeypatch.setenv("OPAL_TPU_TB_FULL_CELLS", "50")
    del seen[:]
    low = _x2(problem, eng)
    assert any(seen)  # the pairs above 50 stored cells
    assert low == default
    assert low == _x2(problem, jeng, jax=True)


def test_no_native_takes_the_python_path(problem, engines, monkeypatch):
    eng, _ = engines
    with_native = _x2(problem, eng)
    builds = []
    monkeypatch.setenv("OPAL_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_build_and_load",
                        lambda: builds.append(1))
    assert not _native.available()
    assert _x2(problem, eng) == with_native
    assert builds == []


# --------------------------------------------------------- the panel knobs

@pytest.fixture(scope="module")
def long_problem():
    """A 70-residue query and 30 sequences of 1..60 letters."""
    rng = np.random.default_rng(77)
    query = rng.integers(0, 20, size=70).astype(np.uint8)
    db = [rng.integers(0, 20, size=int(n)).astype(np.uint8)
          for n in rng.integers(1, 61, size=30)]
    return ScoreMatrix.blosum50().matrix, query, db


@pytest.fixture(scope="module")
def long_want(long_problem, engines):
    """{(mode, x): opal_tpu's result} of the long problem."""
    m, query, db = long_problem
    _, jeng = engines
    return {(mode, x): jax_search_arrays(query, db, 3, 1, m,
                                         mode=MODE_CODES[mode],
                                         search_type=x, engine=jeng)
            for mode in MODES for x in (0, 1)}


def _equal(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


@pytest.mark.parametrize("knobs,route", [
    ({}, "sweep"),
    ({"OPAL_TPU_FORCE_PANELS": "1", "OPAL_TPU_PANEL_ROWS": "16"}, 5),
    ({"OPAL_TPU_FORCE_PANELS": "1", "OPAL_TPU_PANEL_ROWS": "32"}, 3),
    ({"OPAL_TPU_FORCE_PANELS": "1", "OPAL_TPU_PANEL_ROWS": "48"}, 2),
    ({"OPAL_TPU_FORCE_PANELS": "1"}, 1),
    ({"OPAL_TPU_NO_PANELS": "1", "OPAL_TPU_FORCE_PANELS": "1"}, "sweep"),
], ids=["none", "force16", "force32", "force48", "force_default",
        "no_panels"])
def test_panel_knobs_give_the_same_results(long_problem, long_want, engines,
                                           knobs, route, monkeypatch):
    m, query, db = long_problem
    eng, _ = engines
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    plan = backend.panel_plan(len(query))
    assert (plan is None) if route == "sweep" else len(plan) == route
    for (mode, x), want in long_want.items():
        kernels.reset_counts()
        got = search_database_arrays(query, db, 3, 1, m,
                                     mode=MODE_CODES[mode], search_type=x,
                                     engine=eng)
        assert _equal(got, want), (mode, x)
        panels = kernels.PLAIN_CALLS["ragged_panel_plain"]
        assert (panels == 0) if route == "sweep" else panels == route


def test_a_tall_query_under_no_panels_runs_in_one_sweep(long_problem,
                                                        long_want, engines,
                                                        monkeypatch):
    """Taller than kernels.PANEL_ROWS (32 here), one sweep all the same."""
    m, query, db = long_problem
    eng, _ = engines
    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    assert len(backend.panel_plan(len(query))) == 3
    monkeypatch.setenv("OPAL_TPU_NO_PANELS", "1")
    assert backend.panel_plan(len(query)) is None
    kernels.reset_counts()
    got = search_database_arrays(query, db, 3, 1, m, search_type=1,
                                 engine=eng)
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] == 0
    assert _equal(got, long_want[("SW", 1)])


@pytest.mark.parametrize("bad", ["0", "8", "40", "-16", "abc"])
def test_a_bad_panel_height_raises(long_problem, engines, bad, monkeypatch):
    m, query, db = long_problem
    eng, _ = engines
    monkeypatch.setenv("OPAL_TPU_FORCE_PANELS", "1")
    monkeypatch.setenv("OPAL_TPU_PANEL_ROWS", bad)
    with pytest.raises(ValueError, match="OPAL_TPU_PANEL_ROWS"):
        search_database_arrays(query, db, 3, 1, m, engine=eng)


def test_forced_panels_never_stack(long_problem, engines, monkeypatch):
    m, query, db = long_problem
    eng, _ = engines
    qs = [query[:20], query[20:45], query]
    be = eng._backend
    assert be.supports_multi(qs, 3, 1, 24, m)
    unforced = search_database_multi_arrays(qs, db, 3, 1, m, engine=eng)
    monkeypatch.setenv("OPAL_TPU_FORCE_PANELS", "1")
    assert not be.supports_multi(qs, 3, 1, 24, m)
    kernels.reset_counts()
    forced = search_database_multi_arrays(qs, db, 3, 1, m, engine=eng)
    assert kernels.PLAIN_CALLS["multi_score_plain"] == 0
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] == 3
    assert all(_equal(a, b) for a, b in zip(forced, unforced))


# ---------------------------------------------------------------- the tools

@pytest.fixture(scope="module")
def resident(problem, engines):
    _, _, db = problem
    eng, _ = engines
    return eng.upload(db)


def test_exp_x1_gap_matches_jax(problem, engines, resident):
    sm, query, db = problem
    eng, jeng = engines
    res = exp_x1_gap.run(eng, resident, {"q": query}, sm.matrix,
                         modes=("SW", "OV"), repeats=1)
    assert [r["mode"] for r in res["rows"]] == ["SW", "OV"]
    assert res["x1_payload_bytes"] == 12 * len(db)
    for (_, mode, tag), got in res["answers"].items():
        want = jax_search_arrays(query, db, 3, 1, sm.matrix,
                                 mode=MODE_CODES[mode],
                                 search_type=int(tag[1]), engine=jeng)
        assert _equal(got, want), (mode, tag)


def test_exp_topk_matches_jax(problem, engines, resident):
    sm, _, db = problem
    eng, jeng = engines
    res = exp_topk.run(eng, resident, sm.matrix, top_k=7, reps=1,
                       qlens=(24, 40))
    rng = np.random.default_rng(1)
    for qlen in (24, 40):
        query = rng.integers(0, 20, size=qlen, dtype=np.uint8)
        for x, tag in ((0, "x0"), (1, "x1")):
            want = jax_search_arrays(query, db, 3, 1, sm.matrix,
                                     search_type=x, engine=jeng, top_k=7)
            assert _equal(res["answers"][(qlen, tag)], want), (qlen, tag)


def test_exp_align_topk_matches_jax(problem, engines, resident):
    sm, _, db = problem
    eng, jeng = engines
    res = exp_align_topk.run(eng, resident, sm.matrix, top_k=9, qlen=30)
    query = np.random.default_rng(1).integers(0, 20, size=30,
                                              dtype=np.uint8)
    jres = jax_search_database(query, db, 3, 1, sm.matrix,
                               search_type=SEARCH_ALIGNMENT, align_top_k=9,
                               engine=jeng)
    want = [(i, r.score, r.start_location_query, r.start_location_target,
             r.end_location_query, r.end_location_target,
             bytes(r.alignment)) for i, r in enumerate(jres)
            if r.alignment is not None]
    assert res["answers"] == want and res["paths"] == 9


def test_perf_matches_jax_in_four_modes(problem, engines, resident):
    sm, _, db = problem
    eng, jeng = engines
    lut = sm.letter_index()
    queries = {"O74807": port_query("O74807", lut),
               "P18080": port_query("P18080", lut)[:90]}
    res = perf.run(eng, resident, queries, sm.matrix, repeats=1,
                   search_type=1, multi=True)
    assert res["missing"] == ["P19930", "Q3ZAI3"]
    assert len(res["rows"]) == 8 and len(res["stacked"]) == 4
    for (qname, mode), got in res["answers"].items():
        want = jax_search_arrays(queries[qname], db, 3, 1, sm.matrix,
                                 mode=MODE_CODES[mode], search_type=1,
                                 engine=jeng)
        assert _equal(got, want), (qname, mode)


def test_tb_scaling_matches_jax(problem, engines):
    """The alignments are equal across worker counts inside the tool, and
    equal to opal_tpu's alignment_pass."""
    sm, query, db = problem
    eng, _ = engines
    x1 = search_database_arrays(query, db, 3, 1, sm.matrix,
                                search_type=SEARCH_SCORE_END, engine=eng)
    golden = {i: (int(s), int(eq), int(et)) for i, (s, eq, et) in
              enumerate(zip(x1["score"], x1["end_q"], x1["end_t"]))}
    res = tb_scaling.run(query, db, golden, sm.matrix, workers=(1, 2, 4),
                         n_pairs=36, device="cpu")
    assert [r["workers"] for r in res["rows"]] == [1, 2, 4]
    cand = sorted(golden, key=lambda i: (-golden[i][0], i))[:36]
    jres = {}
    for i in cand:
        r = jres[i] = JaxResult()
        r.set_score(golden[i][0])
        r.end_location_query, r.end_location_target = golden[i][1:]
    jax_alignment_pass(query, db, 3, 1, sm.matrix, MODE_SW, jres, cand)
    assert res["answers"] == [
        (jres[i].start_location_query, jres[i].start_location_target,
         None if jres[i].alignment is None else bytes(jres[i].alignment))
        for i in cand]


def test_tb_scaling_reads_the_golden_file():
    x1 = tb_scaling.golden_x1("P18080", "SW")
    assert len(x1) == 12071
    assert x1[0] == (291, 354, 179)


@pytest.fixture(scope="module")
def panel_problem():
    db, matrix, rng = exp_panels.panel_inputs(20)
    return db, matrix, rng.integers(0, exp_panels.A, 70, dtype=np.uint8)


def test_exp_panels_matches_jax(panel_problem, engines):
    db, matrix, query = panel_problem
    eng, jeng = engines
    res = exp_panels.run(eng, eng.upload(db), {70: query}, matrix, reps=1,
                         check=True, panel_rows=32)
    assert res["rows"][0]["checked_seqs"] == exp_panels.CHECK_SEQS
    want = jax_search_arrays(query, db, 3, 1, matrix, engine=jeng)
    assert _equal(res["answers"][70], want)


def test_exp_panel_rows_matches_jax(panel_problem, engines):
    db, matrix, query = panel_problem
    eng, jeng = engines
    res = exp_panel_rows.run(eng, eng.upload(db), query, matrix,
                             rows=("default", 48, 32, 16), reps=1, st=1)
    assert [p["panels"] for p in res["points"]] == [1, 2, 3, 5]
    want = jax_search_arrays(query, db, 3, 1, matrix, search_type=1,
                             engine=jeng)
    assert _equal(res["answers"], want)


def test_exp_panel_mesh_matches_jax(engines):
    _, jeng = engines
    query, db, matrix = exp_panel_mesh.mesh_inputs(50, 6)
    res = exp_panel_mesh.run("cpu", db, query, matrix, reps=1, x=1,
                             block_size=B, panel_rows=16)
    want = jax_search_arrays(query, db, 3, 1, matrix, search_type=1,
                             engine=jeng)
    assert _equal(res["answers"], want)


def test_a_tool_raises_when_two_paths_differ(panel_problem, engines,
                                            monkeypatch):
    """exp_panels' equality of panels and one sweep is a hard failure."""
    from opal_tpu_torch.tools import Mismatch

    db, matrix, query = panel_problem
    eng, _ = engines
    real = kernels.finalize_panels_device

    def off_by_one(*a, **kw):
        cols = real(*a, **kw)
        cols["score"] = cols["score"] + 1
        return cols

    monkeypatch.setattr(kernels, "finalize_panels_device", off_by_one)
    with pytest.raises(Mismatch, match="panels differ"):
        exp_panels.run(eng, eng.upload(db), {70: query}, matrix, reps=1,
                       panel_rows=32)
