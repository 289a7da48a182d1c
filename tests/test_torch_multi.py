"""The port's stacked multi-query search against opal_tpu.

`multi_score_plain` is the plain PyTorch version of the multi_dp CUDA
kernel, and what `multi_score` runs for CPU tensors. Here it is held
against opal_tpu's stacked Pallas kernel (build_pallas_multi_fn_raw) in
interpret mode on the same stream and stacked profile, and the port's
search_database_multi_arrays against opal_tpu's, with its xla engine and
with its interpret engine. Integer DP: every comparison is exact. The
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Length-0 lanes are left to the xla comparison: opal_tpu's Pallas path
clips their NW/HW/OV scores to int16 (ROADMAP.md, queue C).
"""
import dataclasses

import numpy as np
import pytest
import torch

from opal_tpu.engine import pallas_kernels as pk
from opal_tpu.engine.device_db import DeviceDatabase as JaxDeviceDatabase
from opal_tpu.engine.pallas_backend import PallasBackend
from opal_tpu.engine.search import Engine as JaxEngine
from opal_tpu.engine.search import (
    search_database_multi_arrays as jax_multi_arrays,
)
from opal_tpu_torch.constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from opal_tpu_torch.engine import kernels
from opal_tpu_torch.engine.backend import RaggedBackend
from opal_tpu_torch.engine.device_db import stream_from_jax_numpy
from opal_tpu_torch.engine.search import (
    Engine,
    plan_groups,
    search_database_arrays,
    search_database_multi_arrays,
)

MODES = [MODE_SW, MODE_NW, MODE_HW, MODE_OV]
XS = [SEARCH_SCORE, SEARCH_SCORE_END]
B = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n_seqs=40, A=20, empty=False):
    """A random matrix and n_seqs database sequences of 1..120 letters
    (one of them empty when asked)."""
    rng = np.random.default_rng(seed)
    matrix = rng.integers(-4, 6, size=(A, A)).astype(np.int32)
    np.fill_diagonal(matrix, rng.integers(3, 9, size=A))
    db = [rng.integers(0, A, size=int(L)).astype(np.uint8)
          for L in rng.integers(1, 121, size=n_seqs)]
    if empty:
        db[n_seqs // 3] = np.zeros(0, np.uint8)
    return rng, matrix, db


def _jax_stream(db):
    jdb = JaxDeviceDatabase(db, B)
    c_real = sum(-(-b.letters.shape[0] // pk.T_CHUNK) for b in jdb.blocks)
    return jdb, jdb._build_stream_np(jdb.blocks, c_real + 1,
                                     len(jdb.blocks) + 1)


@pytest.mark.parametrize("segs,go,ge", [
    ([1, 16, 17, 40], 3, 1),
    ([3, 20, 16, 33, 2, 40, 9, 17], 3, 1),
    ([3, 20, 16, 33, 2, 40, 9, 17], 2, 2),
])
@pytest.mark.parametrize("x", XS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_multi_interpret(mode, x, segs, go, ge):
    """multi_score on CPU tensors (the plain version) against opal_tpu's
    stacked kernel in interpret mode: the same stream, carried across with
    stream_from_jax_numpy, and the same stacked profile."""
    import jax.numpy as jnp

    rng, matrix, db = _problem(10 * mode + x + go)
    qprofiles = [matrix[rng.integers(0, 20, size=q)].T for q in segs]
    jdb, (meta, letters, lengths) = _jax_stream(db)
    qp, seg_qpads, seg_qs = pk.prepare_qp_multi(qprofiles, ge)
    fn = pk.build_pallas_multi_fn_raw(
        mode, tuple(zip(seg_qs, seg_qpads)), go, ge, B=B, interpret=True,
        track_end=x == SEARCH_SCORE_END)
    want = np.asarray(fn(jnp.asarray(meta), jnp.asarray(qp, jnp.bfloat16),
                         jnp.asarray(letters), jnp.asarray(lengths)))

    profile, my_qs = kernels.prepare_profile_multi(qprofiles)
    assert my_qs == tuple(seg_qs)
    # the stacked operand is opal_tpu's, less its P + Ge offset
    np.testing.assert_array_equal(
        profile, np.where(qp == pk.PAD_NEG, pk.PAD_NEG, qp - ge))
    calls = kernels.PLAIN_CALLS["multi_score_plain"]
    got = kernels.multi_score(
        torch.from_numpy(profile), my_qs,
        stream_from_jax_numpy(jdb.blocks, meta, letters, lengths, "cpu"),
        mode, x, go, ge).numpy()
    assert kernels.PLAIN_CALLS["multi_score_plain"] == calls + 1
    assert got.shape == (len(jdb.blocks), len(segs) * (1 + 2 * x), B)
    for bi, blk in enumerate(jdb.blocks):
        np.testing.assert_array_equal(got[bi, :, :blk.n],
                                      want[bi, :, :blk.n], err_msg=str(bi))


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("top_k", [0, 9])
@pytest.mark.parametrize("x", XS)
@pytest.mark.parametrize("mode", MODES)
def test_multi_search_matches_jax_xla(mode, x, top_k):
    """Eleven queries (groups of 8 and 3, stacked) against a database with
    an empty sequence, against opal_tpu's xla engine (one query at a
    time there)."""
    rng, matrix, db = _problem(100 + mode, n_seqs=45, empty=True)
    queries = [rng.integers(0, 20, size=int(n)).astype(np.uint8)
               for n in (5, 40, 17, 16, 33, 70, 1, 12, 90, 25, 8)]
    want = jax_multi_arrays(queries, db, 3, 1, matrix, mode=mode,
                            search_type=x, top_k=top_k,
                            engine=JaxEngine(backend="xla", block_size=B))
    got = search_database_multi_arrays(queries, db, 3, 1, matrix, mode=mode,
                                       search_type=x, top_k=top_k,
                                       engine=Engine(device="cpu",
                                                     block_size=B))
    _assert_results_equal(got, want)


def _interpret_engine():
    eng = JaxEngine(backend="pallas", block_size=B)
    eng._backend = PallasBackend(interpret=True)
    return eng


@pytest.mark.parametrize("top_k", [0, 9])
@pytest.mark.parametrize("x", XS)
@pytest.mark.parametrize("mode", MODES)
def test_multi_search_matches_jax_interpret_ties(mode, x, top_k):
    """A tie-heavy 0/2 matrix over 3 letters: scores and end locations tie
    everywhere, so the tie-breaks of the stacked emit and of the device
    top-k both decide; opal_tpu runs its stacked kernel in interpret
    mode."""
    rng = np.random.default_rng(77 + mode)
    matrix = np.where(np.eye(3, dtype=bool), 2, 0).astype(np.int32)
    queries = [rng.integers(0, 3, int(n)).astype(np.uint8)
               for n in (9, 30, 17, 45)]
    db = [rng.integers(0, 3, int(n)).astype(np.uint8)
          for n in rng.integers(4, 100, size=30)]
    want = jax_multi_arrays(queries, db, 1, 1, matrix, mode=mode,
                            search_type=x, top_k=top_k,
                            engine=_interpret_engine())
    got = search_database_multi_arrays(queries, db, 1, 1, matrix, mode=mode,
                                       search_type=x, top_k=top_k,
                                       engine=Engine(device="cpu",
                                                     block_size=B))
    _assert_results_equal(got, want)


def test_groups_match_jax(monkeypatch):
    """The port stacks the same groups as opal_tpu: a stable sort on the
    16-quantized length, at most 8 per group, a group of one on the
    single-query path."""
    rng, matrix, db = _problem(5, n_seqs=20)
    lens = (5, 40, 17, 16, 33, 70, 1, 12, 90, 25, 8, 120, 3, 66, 64, 18,
            200)
    queries = [rng.integers(0, 20, size=n).astype(np.uint8) for n in lens]
    seen = {"jax": [], "port": []}

    def spy(who, orig):
        def dispatch(self, qprofiles, *a, **kw):
            seen[who].append([qp.shape[1] for qp in qprofiles])
            return orig(self, qprofiles, *a, **kw)
        return dispatch

    monkeypatch.setattr(PallasBackend, "dispatch_multi",
                        spy("jax", PallasBackend.dispatch_multi))
    monkeypatch.setattr(RaggedBackend, "dispatch_multi",
                        spy("port", RaggedBackend.dispatch_multi))
    want = jax_multi_arrays(queries, db, 3, 1, matrix,
                            engine=_interpret_engine())
    got = search_database_multi_arrays(
        queries, db, 3, 1, matrix, engine=Engine(device="cpu", block_size=B))
    _assert_results_equal(got, want)
    assert seen["port"] == seen["jax"]
    assert [len(g) for g in seen["port"]] == [8, 8]  # and 200 alone
    order = [n for g in seen["port"] for n in g]
    assert [(n + 15) // 16 for n in order] == sorted(
        (n + 15) // 16 for n in order)


def test_plan_groups():
    queries = [np.zeros(n) for n in (20, 3, 50, 17, 5)]
    assert plan_groups(queries, lambda g: True) == [[1, 4, 0, 3, 2]]
    assert plan_groups(queries, lambda g: len(g) <= 2) == [
        [1, 4], [0, 3], [2]]
    assert plan_groups(queries, lambda g: False) == [[1], [4], [0], [3],
                                                     [2]]
    many = [np.zeros(7)] * 19
    assert [len(g) for g in plan_groups(many, lambda g: True)] == [8, 8, 3]
    assert plan_groups([], lambda g: True) == []


def test_any_gap_pair_stacks():
    """gap_ext > gap_open stacks too (the kernel's F chain is exact for
    every pair); results equal the single-query searches."""
    rng, matrix, db = _problem(8, n_seqs=12)
    queries = [rng.integers(0, 20, size=n).astype(np.uint8)
               for n in (7, 20, 11)]
    engine = Engine(device="cpu", block_size=B)
    calls = kernels.PLAIN_CALLS["multi_score_plain"]
    got = search_database_multi_arrays(queries, db, 1, 3, matrix,
                                       mode=MODE_OV, search_type=1,
                                       engine=engine)
    assert kernels.PLAIN_CALLS["multi_score_plain"] == calls + 1
    for q, g in zip(queries, got):
        want = search_database_arrays(q, db, 1, 3, matrix, mode=MODE_OV,
                                      search_type=1, engine=engine)
        _assert_results_equal([g], [want])


def test_multi_wrapper_checks_and_devices():
    rng, matrix, db = _problem(9, n_seqs=10)
    ddb = Engine(device="cpu", block_size=B).upload(db)
    profile, seg_qs = kernels.prepare_profile_multi(
        [matrix[rng.integers(0, 20, size=q)].T for q in (3, 17)])
    profile = torch.from_numpy(profile)
    assert profile.shape == (16 + 32, kernels.PROFILE_WIDTH)
    launches = dict(kernels.LAUNCHES)
    out = kernels.multi_score(profile, seg_qs, ddb.stream, MODE_SW, 1, 3, 1)
    assert kernels.LAUNCHES == launches
    assert out.shape == (len(ddb.blocks), 6, B) and out.dtype == torch.int32
    with pytest.raises(ValueError):  # rows do not match the segments
        kernels.multi_score(profile[:32], seg_qs, ddb.stream, MODE_SW, 0,
                            3, 1)
    with pytest.raises(ValueError):
        kernels.prepare_profile_multi([matrix[:, :4]] * 9)
    with pytest.raises(ValueError):  # a device with no kernel
        kernels.multi_score(profile.to("meta"), seg_qs, dataclasses.replace(
            ddb.stream, letters=ddb.stream.letters.to("meta"),
            offsets=ddb.stream.offsets.to("meta"),
            lengths=ddb.stream.lengths.to("meta")), MODE_SW, 0, 3, 1)


@pytest.mark.parametrize("top_k", [0, 4])
def test_empty_database_multi(top_k):
    rng, matrix, _ = _problem(11)
    queries = [rng.integers(0, 20, size=n).astype(np.uint8) for n in (6, 30)]
    for x in XS:
        want = jax_multi_arrays(queries, [], 3, 1, matrix, search_type=x,
                                top_k=top_k,
                                engine=JaxEngine(backend="xla", block_size=B))
        got = search_database_multi_arrays(
            queries, [], 3, 1, matrix, search_type=x, top_k=top_k,
            engine=Engine(device="cpu", block_size=B))
        _assert_results_equal(got, want)
