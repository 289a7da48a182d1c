"""The adaptive precision cascade of the port on the CPU against opal_tpu's.

The plain version of ragged_dp with its overflow-flag rows (K4) is held
against opal_tpu's int32 twin (engine/xla.py::build_score_fn with
with_flags) and against opal_tpu's Pallas ragged kernel in interpret mode;
then Engine(precision="adaptive").last_search_stats, key by key, and
search_database_char_sw against opal_tpu's xla engine. Integer DP: every
comparison is exact. The kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from opal_tpu.engine import cascade as jax_cascade
from opal_tpu.engine.search import Engine as JaxEngine
from opal_tpu.engine.search import search_database as jax_search_database
from opal_tpu.engine.xla import build_score_fn
from opal_tpu.result import SearchResult as JaxSearchResult
from opal_tpu_torch.constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    OVERFLOW_BUCKETS,
    OVERFLOW_SIMPLE,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from opal_tpu_torch.engine import batching, cascade, kernels
from opal_tpu_torch.engine.search import Engine, search_database
from opal_tpu_torch.result import SearchResult

MODES = [MODE_SW, MODE_NW, MODE_HW, MODE_OV]
GAPS = [(3, 1), (2, 2), (1, 3), (0, 0)]
B = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain_flags(query, db, matrix, mode, x, go, ge):
    """The plain version's finalized columns (flags included), one
    {col: [B] array} per block, and the blocks."""
    blocks = batching.plan_blocks(db, B)
    stream = kernels.pack_stream([b.letters for b in blocks],
                                 [b.lengths for b in blocks], B, "cpu")
    profile = torch.from_numpy(kernels.build_profile(matrix[query].T))
    tr = kernels.ragged_score(profile, stream, mode, x, go, ge,
                              with_flags=True)
    cols = kernels.finalize_device(tr, stream.lengths, mode, x, len(query),
                                   with_flags=True)
    return blocks, [{k: v[bi].numpy() for k, v in cols.items()}
                    for bi in range(len(blocks))]


@pytest.mark.parametrize("go,ge", GAPS)
@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", MODES)
def test_plain_flags_match_xla_twin(mode, x, go, ge):
    """Flag columns (and scores) of the plain version against the twin's,
    on queries whose length is no multiple of 16. The matrix scales its
    columns by 1, 30 or 3,000 in letter pairs, and each sequence draws on
    one pair, so that lanes need 8, 16 and 32 bits."""
    rng = np.random.default_rng(1000 + 100 * mode + 10 * go + ge + x)
    small = ge > go  # the row loop of both versions is slow
    A, tmax = 6, (60 if small else 160)
    Q = int(rng.choice([7, 17, 23] if small else [17, 33, 45]))
    weight = np.array([1, 1, 30, 30, 3000, 3000])
    matrix = (rng.integers(-4, 7, size=(A, A)) * weight).astype(np.int32)
    query = rng.integers(0, A, size=Q)
    lens = rng.integers(1, tmax + 1, size=37)
    lens[0], lens[-1] = 1, tmax
    db = [rng.integers(2 * (i % 3), 2 * (i % 3) + 2,
                       size=int(L)).astype(np.uint8)
          for i, L in enumerate(lens)]
    blocks, got = _plain_flags(query, db, matrix, mode, x, go, ge)
    fn = build_score_fn(mode, x, Q, go, ge, with_flags=True)
    flag_cols = (["max_ulhp"] if mode == MODE_SW
                 else ["min_e", "min_f", "max_h"])
    seen = set()
    for bi, blk in enumerate(blocks):
        letters = np.full((tmax, B), batching.PAD_LETTER, np.int32)
        letters[: blk.t_pad] = blk.letters
        want = {k: np.asarray(v) for k, v in
                fn(matrix[query].T, letters, blk.lengths).items()}
        assert set(got[bi]) == {"score", *flag_cols} | (
            {"end_q", "end_t"} if x else set())
        for k, v in got[bi].items():  # every lane, padding lanes included
            np.testing.assert_array_equal(v, want[k], err_msg=f"{k} {bi}")
        seen |= set(cascade.classify_precision(
            {k: got[bi][k][: blk.n] for k in flag_cols}, mode).tolist())
    assert seen == {8, 16, 32}


@pytest.mark.parametrize("mode", [MODE_SW, MODE_NW])
def test_plain_flags_match_pallas_interpret(mode):
    """opal_tpu's Pallas ragged kernel with flags, in interpret mode (set
    up as tests/test_pallas_interpret.py runs it), against the port's plain
    version through Engine.score_blocks."""
    from opal_tpu.engine.pallas_backend import PallasBackend

    from util import random_problem

    rng = np.random.default_rng(29)
    query, db, matrix = random_problem(rng, n_seqs=12, query_len=18,
                                       min_len=8, max_len=70, match=5)
    jeng = JaxEngine(backend="pallas", block_size=8, precision="adaptive")
    jeng._backend = PallasBackend(interpret=True)
    jidx, jcols = jeng.score_blocks(query, db, 3, 1, matrix, mode,
                                    SEARCH_SCORE, with_flags=True)
    idx, cols = Engine(device="cpu", block_size=8).score_blocks(
        query, db, 3, 1, matrix, mode, SEARCH_SCORE, with_flags=True)
    assert set(cols) == set(jcols)
    jo, o = np.argsort(jidx), np.argsort(idx)
    np.testing.assert_array_equal(idx[o], jidx[jo])
    for k in jcols:
        np.testing.assert_array_equal(cols[k][o], np.asarray(jcols[k])[jo],
                                      err_msg=k)


@pytest.fixture(scope="module")
def wide_problem():
    """A 40-residue query and 1,100 sequences (two 1024-sequence buckets)
    under a matrix whose diagonal is 1,000: copies of the query need 32
    bits, sequences sharing a letter with it 16, and sequences of letters
    the query lacks (they mismatch everything) 8."""
    rng = np.random.default_rng(77)
    A = 6
    matrix = np.full((A, A), -1, np.int32)
    np.fill_diagonal(matrix, 1000)
    query = rng.integers(0, 4, size=40).astype(np.uint8)
    db = []
    for i in range(1100):
        L = int(rng.integers(0 if i == 5 else 1, 30))
        if i % 7 == 0:
            db.append(rng.integers(4, 6, size=L).astype(np.uint8))
        else:
            db.append(rng.integers(0, 4, size=L).astype(np.uint8))
    db[3] = query.copy()
    db[1050] = np.concatenate([query, query[:10]])
    return query, db, matrix


def _assert_stats_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "bucket_escalations":
            assert set(g) == set(w)
            for kk in w:
                np.testing.assert_array_equal(g[kk], w[kk], err_msg=kk)
        else:
            assert g == w, k


@pytest.mark.parametrize("method", [OVERFLOW_BUCKETS, OVERFLOW_SIMPLE])
@pytest.mark.parametrize("mode", MODES)
def test_search_stats_match_jax(wide_problem, mode, method):
    query, db, matrix = wide_problem
    eng = Engine(device="cpu", block_size=128, precision="adaptive")
    jeng = JaxEngine(backend="xla", block_size=128, precision="adaptive")
    got = search_database(query, db, 3, 1, matrix, mode=mode,
                          overflow_method=method, engine=eng)
    want = jax_search_database(query, db, 3, 1, matrix, mode=mode,
                               overflow_method=method, engine=jeng)
    assert [r.score for r in got] == [r.score for r in want]
    _assert_stats_equal(eng.last_search_stats, jeng.last_search_stats)
    counts = eng.last_search_stats["precision_counts"]
    assert all(counts[b] > 0 for b in (8, 16, 32)), counts
    # skip semantics: pre-filled results are not rescored, and count as
    # 8-bit in the rerun masks
    pre = {3: 7, 900: 11, 1050: 13}

    def prefilled(cls):
        res = [cls() for _ in db]
        for i, s in pre.items():
            res[i].score_set, res[i].score = 1, s
        return res

    got = search_database(query, db, 3, 1, matrix, mode=mode,
                          overflow_method=method, engine=eng,
                          results=prefilled(SearchResult))
    want = jax_search_database(query, db, 3, 1, matrix, mode=mode,
                               overflow_method=method, engine=jeng,
                               results=prefilled(JaxSearchResult))
    assert [r.score for r in got] == [r.score for r in want]
    assert got[1050].score == 13
    _assert_stats_equal(eng.last_search_stats, jeng.last_search_stats)
    assert 1050 not in eng.last_search_stats["precision_bits"]


def test_char_sw_matches_jax(wide_problem):
    query, db, matrix = wide_problem
    db = db[:300]
    got = cascade.search_database_char_sw(
        query, db, 3, 1, matrix, engine=Engine(device="cpu", block_size=64))
    want = jax_cascade.search_database_char_sw(
        query, db, 3, 1, matrix,
        engine=JaxEngine(backend="xla", block_size=64))

    def fields(r):
        return (r.score_set, r.score, r.end_location_query,
                r.end_location_target, r.start_location_query,
                r.start_location_target, r.alignment, r.alignment_length)

    assert [fields(r) for r in got] == [fields(r) for r in want]
    assert sum(r.score_set == 0 for r in got) > 0
    assert sum(r.score_set == 1 for r in got) > 0


def test_classify_and_buckets_match_jax():
    rng = np.random.default_rng(3)
    for mode in MODES:
        flags = {"max_ulhp": rng.integers(-10, 40000, size=3000),
                 "min_e": rng.integers(-40000, 1, size=3000),
                 "min_f": rng.integers(-40000, 1, size=3000),
                 "max_h": rng.integers(-10, 40000, size=3000)}
        prec = cascade.classify_precision(flags, mode)
        np.testing.assert_array_equal(
            prec, jax_cascade.classify_precision(flags, mode))
        for method in (OVERFLOW_BUCKETS, OVERFLOW_SIMPLE):
            for stage in (8, 16):
                np.testing.assert_array_equal(
                    cascade.simulate_overflow_method(prec, method, stage),
                    jax_cascade.simulate_overflow_method(prec, method,
                                                         stage))
        got = cascade.bucket_escalation_counts(prec)
        want = jax_cascade.bucket_escalation_counts(prec)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
