"""The port's public search API on the CPU against opal_tpu's xla backend.

Both engines search the same random protein database through
search_database_arrays and search_database; every field must be equal
(integer DP, no tolerance). Covers x0/x1, top_k, skip semantics, several
block sizes with a partial first block, a resident database, and the
API's x2 and adaptive-precision entry points.
"""
import numpy as np
import pytest
import torch

from opal_tpu.engine.search import Engine as JaxEngine
from opal_tpu.engine.search import search_database as jax_search_database
from opal_tpu.engine.search import (
    search_database_arrays as jax_search_database_arrays,
)
from opal_tpu.matrices import ScoreMatrix as JaxScoreMatrix
from opal_tpu.result import SearchResult as JaxSearchResult
from opal_tpu_torch import search_database, search_database_arrays
from opal_tpu_torch.constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_ALIGNMENT,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from opal_tpu_torch.engine.search import Engine, search_database_multi_arrays
from opal_tpu_torch.result import SearchResult

MODES = [MODE_SW, MODE_NW, MODE_HW, MODE_OV]
XS = [SEARCH_SCORE, SEARCH_SCORE_END]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """BLOSUM50, a 40-residue query and 70 sequences of 1..120 letters
    (70 is no multiple of the block sizes below: the first block is
    partial), with one empty sequence."""
    rng = np.random.default_rng(1234)
    matrix = JaxScoreMatrix.blosum50().matrix
    A = matrix.shape[0]
    query = rng.integers(0, A, size=40).astype(np.uint8)
    db = [rng.integers(0, A, size=int(L)).astype(np.uint8)
          for L in rng.integers(1, 121, size=70)]
    db[17] = np.zeros(0, np.uint8)
    return query, db, matrix


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(backend="xla", block_size=64)


def _assert_cols_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
        assert got[k].shape == np.asarray(want[k]).shape, k


@pytest.mark.parametrize("block_size", [16, 64])
@pytest.mark.parametrize("x", XS)
@pytest.mark.parametrize("mode", MODES)
def test_arrays_match_jax(problem, jax_engine, mode, x, block_size):
    query, db, matrix = problem
    want = jax_search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                      search_type=x, engine=jax_engine)
    engine = Engine(device="cpu", block_size=block_size)
    got = search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                 search_type=x, engine=engine)
    _assert_cols_equal(got, want)
    # the same search on a resident upload
    ddb = engine.upload(db)
    again = search_database_arrays(query, ddb, 3, 1, matrix, mode=mode,
                                   search_type=x, engine=engine)
    _assert_cols_equal(again, want)


@pytest.mark.parametrize("x", XS)
@pytest.mark.parametrize("mode", MODES)
def test_top_k_matches_jax(problem, jax_engine, mode, x):
    query, db, matrix = problem
    want = jax_search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                      search_type=x, engine=jax_engine,
                                      top_k=9)
    got = search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                 search_type=x, top_k=9,
                                 engine=Engine(device="cpu", block_size=32))
    _assert_cols_equal(got, want)
    assert len(got["index"]) == 9


def _fields(r):
    return (r.score_set, r.score, r.end_location_query,
            r.end_location_target, r.start_location_query,
            r.start_location_target, r.alignment, r.alignment_length)


@pytest.mark.parametrize("x", XS)
@pytest.mark.parametrize("mode", MODES)
def test_search_database_matches_jax(problem, jax_engine, mode, x):
    query, db, matrix = problem
    want = jax_search_database(query, db, 3, 1, matrix, mode=mode,
                               search_type=x, engine=jax_engine)
    got = search_database(query, db, 3, 1, matrix, mode=mode,
                          search_type=x,
                          engine=Engine(device="cpu", block_size=16))
    assert [_fields(r) for r in got] == [_fields(r) for r in want]


@pytest.mark.parametrize("mode,x", [(MODE_SW, SEARCH_SCORE),
                                    (MODE_SW, SEARCH_SCORE_END),
                                    (MODE_OV, SEARCH_SCORE_END)])
def test_skip_semantics_match_jax(problem, jax_engine, mode, x):
    """Pre-filled results are trusted and not recomputed; a score+end
    search recomputes results that lack an end location."""
    query, db, matrix = problem
    pre = {3: (999, 5, 6), 11: (-7, -1, -1), 40: (12, 1, 2)}

    def prefilled(cls):
        res = [cls() for _ in db]
        for i, (s, eq, et) in pre.items():
            res[i].score_set, res[i].score = 1, s
            res[i].end_location_query, res[i].end_location_target = eq, et
        return res

    want = jax_search_database(query, db, 3, 1, matrix, mode=mode,
                               search_type=x, engine=jax_engine,
                               results=prefilled(JaxSearchResult))
    got = search_database(query, db, 3, 1, matrix, mode=mode, search_type=x,
                          engine=Engine(device="cpu", block_size=16),
                          results=prefilled(SearchResult))
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert got[3].score == 999


def test_gap_pairs_match_jax(problem, jax_engine):
    """gap_ext > gap_open and gap_open == gap_ext == 0 run on the port's
    own path (no fallback anywhere)."""
    query, db, matrix = problem
    for go, ge in ((1, 3), (0, 0)):
        want = jax_search_database_arrays(query, db[:20], go, ge, matrix,
                                          mode=MODE_OV, search_type=1,
                                          engine=jax_engine)
        got = search_database_arrays(query, db[:20], go, ge, matrix,
                                     mode=MODE_OV, search_type=1,
                                     engine=Engine(device="cpu",
                                                   block_size=16))
        _assert_cols_equal(got, want)


def test_empty_database(problem, jax_engine):
    query, _, matrix = problem
    for x in XS:
        want = jax_search_database_arrays(query, [], 3, 1, matrix,
                                          mode=MODE_SW, search_type=x,
                                          engine=jax_engine)
        got = search_database_arrays(query, [], 3, 1, matrix, mode=MODE_SW,
                                     search_type=x,
                                     engine=Engine(device="cpu"))
        _assert_cols_equal(got, want)


def test_later_slices_raise(problem, jax_engine):
    """The entry points that raised until x2 and the cascade were ported
    (the name is kept): x2 and precision="adaptive" now answer as
    opal_tpu's do."""
    query, db, matrix = problem
    engine = Engine(device="cpu", block_size=16)
    got = search_database(query, db, 3, 1, matrix,
                          search_type=SEARCH_ALIGNMENT, engine=engine)
    want = jax_search_database(query, db, 3, 1, matrix,
                               search_type=SEARCH_ALIGNMENT,
                               engine=jax_engine)
    assert [_fields(r)[:6] + (r.alignment_length,) for r in got] == [
        _fields(r)[:6] + (r.alignment_length,) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(
            np.asarray(a.alignment if a.alignment is not None else []),
            np.asarray(b.alignment if b.alignment is not None else []))
    _assert_cols_equal(
        search_database_arrays(query, db, 3, 1, matrix,
                               search_type=SEARCH_ALIGNMENT, engine=engine),
        jax_search_database_arrays(query, db, 3, 1, matrix,
                                   search_type=SEARCH_ALIGNMENT,
                                   engine=jax_engine))
    pair = [query, query[:20]]
    for prec in ("int32", "adaptive"):
        eng = Engine(device="cpu", block_size=16, precision=prec)
        for x in (SEARCH_SCORE, SEARCH_ALIGNMENT):
            outs = search_database_multi_arrays(pair, db, 3, 1, matrix,
                                                search_type=x, engine=eng,
                                                top_k=5)
            for q, o in zip(pair, outs):
                _assert_cols_equal(o, jax_search_database_arrays(
                    q, db, 3, 1, matrix, search_type=x, engine=jax_engine,
                    top_k=5))
    adaptive = Engine(device="cpu", block_size=16, precision="adaptive")
    jax_adaptive = JaxEngine(backend="xla", block_size=64,
                             precision="adaptive")
    got = search_database(query, db, 3, 1, matrix, engine=adaptive)
    want = jax_search_database(query, db, 3, 1, matrix, engine=jax_adaptive)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert (adaptive.last_search_stats["precision_bits"]
            == jax_adaptive.last_search_stats["precision_bits"])
    with pytest.raises(ValueError):
        Engine(device="cpu", precision="int8")


def test_inputs_outside_the_kernel_raise(problem):
    query, db, matrix = problem
    engine = Engine(device="cpu")
    with pytest.raises(ValueError):  # letter 30 outside a 24-letter matrix
        search_database_arrays(query, [np.array([30], np.uint8)], 3, 1,
                               matrix, engine=engine)
    with pytest.raises(ValueError):  # DP values past the int32 headroom
        search_database_arrays(query, db, 3, 2**28, matrix, engine=engine)
    with pytest.raises(ValueError):
        search_database(query, db, 3, 1, matrix, mode=7, engine=engine)


def _large_score_problem(diag, off):
    """A 4-letter matrix (diagonal `diag`, off-diagonal `off`), a
    600-letter query from default_rng(1) and a database of the query itself
    and one 300-letter sequence drawn after it."""
    matrix = np.full((4, 4), off, np.int32)
    np.fill_diagonal(matrix, diag)
    rng = np.random.default_rng(1)
    query = rng.integers(0, 4, 600).astype(np.uint8)
    return query, [query, rng.integers(0, 4, 300).astype(np.uint8)], matrix


# The upper edge of backend.UPPER_BOUND for Q = 600, ge = 1: Q (M + ge)
# < 2^31 holds for M = 3,579,138 and fails for M = 3,579,139.
_M_INSIDE = 2**31 // 600 - 1


@pytest.mark.parametrize("diag,off", [(2**20, -1), (2**21, -699051),
                                      (_M_INSIDE, -1)])
@pytest.mark.parametrize("mode", MODES)
def test_large_scores_inside_the_bound_match_jax(diag, off, mode):
    """Scores past 2^29 (to within 1,000 of 2^31) that opal_tpu answers
    exactly: the port equals it field by field."""
    query, db, matrix = _large_score_problem(diag, off)
    got = search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                 search_type=SEARCH_SCORE_END,
                                 engine=Engine(device="cpu", block_size=16))
    want = jax_search_database_arrays(
        query, db, 3, 1, matrix, mode=mode, search_type=SEARCH_SCORE_END,
        engine=JaxEngine(backend="xla", block_size=16))
    _assert_cols_equal(got, want)
    assert int(got["score"][0]) == 600 * diag
    if diag == 2**20 and mode == MODE_NW:
        assert got["score"].tolist() == [629145600, 271580626]
        assert got["end_q"].tolist() == [599, 599]
        assert got["end_t"].tolist() == [599, 299]


def test_searches_past_the_bound_raise():
    """Just past either edge of the derived bound: the same ValueError as
    any search outside the kernel's range; just inside the lower edge (a
    huge gap_ext), the port equals opal_tpu."""
    query, db, matrix = _large_score_problem(_M_INSIDE + 1, -1)
    engine = Engine(device="cpu", block_size=16)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        search_database_arrays(query, db, 3, 1, matrix, engine=engine)
    query, db, matrix = _large_score_problem(5, -4)
    # 3 go + (Q + T + 1) ge < 2^30, with Q = T = 600
    ge_out = -(-(2**30 - 9) // 1201)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        search_database_arrays(query, db, 3, ge_out, matrix, engine=engine)
    got = search_database_arrays(query, db, 3, ge_out - 1, matrix,
                                 mode=MODE_OV, search_type=SEARCH_SCORE_END,
                                 engine=engine)
    want = jax_search_database_arrays(
        query, db, 3, ge_out - 1, matrix, mode=MODE_OV,
        search_type=SEARCH_SCORE_END,
        engine=JaxEngine(backend="xla", block_size=16))
    _assert_cols_equal(got, want)
