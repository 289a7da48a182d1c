"""The port's database over a device mesh against opal_tpu's.

The port's Engine(device="cpu", mesh=db_mesh(["cpu"] * 8)) cuts the
resident database into 8 parts (the CPU named 8 times, as opal_tpu's tests
use 8 virtual host devices) and runs each part's plain version; opal_tpu's
Engine(mesh=db_mesh(jax.devices()[:8])) runs the same search on its own
mesh (conftest forces the 8 host devices). Integer DP: every field is
compared exactly. The kernels on a mesh on the card are in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import numpy as np
import pytest
import torch

from opal_tpu.engine.device_db import DeviceDatabase as JaxDeviceDatabase
from opal_tpu.engine.pallas_backend import PallasBackend
from opal_tpu.engine.pallas_kernels import T_CHUNK
from opal_tpu.engine.search import Engine as JaxEngine
from opal_tpu.engine.search import search_database as jax_search
from opal_tpu.engine.search import (
    search_database_arrays as jax_arrays,
)
from opal_tpu.engine.search import (
    search_database_multi_arrays as jax_multi_arrays,
)
from opal_tpu.parallel.shard import db_mesh as jax_db_mesh
from opal_tpu.parallel.shard import (
    sharded_score_step as jax_sharded_score_step,
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
from opal_tpu_torch.engine.device_db import (
    DeviceDatabase,
    split_blocks,
    stream_from_jax_numpy,
)
from opal_tpu_torch.engine.search import (
    Engine,
    search_database,
    search_database_arrays,
    search_database_multi_arrays,
)
from opal_tpu_torch.parallel.shard import db_mesh, sharded_score_step

from util import random_problem

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


@pytest.fixture(scope="module")
def jax_mesh():
    devices = jax.devices()
    assert len(devices) >= 8, "conftest forces 8 host devices"
    return jax_db_mesh(devices[:8])


@pytest.fixture(scope="module")
def mesh():
    return db_mesh(["cpu"] * 8)


def _fields(results):
    return [(r.score, r.end_location_query, r.end_location_target)
            for r in results]


def _live_parts(ddb):
    return sum(1 for p in ddb.parts if p.blocks)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("search_type", XS)
def test_sharded_engine_matches_jax(mode, search_type, mesh, jax_mesh):
    """4 modes x x0/x1 over 8 parts, one ragged_dp run per part, against
    opal_tpu's sharded engine; the parts are launched, none twice."""
    rng = np.random.default_rng(1000 + 2 * mode + search_type)
    query, db, matrix = random_problem(rng, n_seqs=60, query_len=40,
                                       min_len=5, max_len=150)
    eng = Engine(device="cpu", block_size=B, mesh=mesh)
    ddb = eng.upload(db)
    assert len(ddb.parts) == 8 and _live_parts(ddb) > 1
    kernels.reset_counts()
    got = search_database(query, ddb, 3, 1, matrix, mode=mode,
                          search_type=search_type, engine=eng)
    assert kernels.PLAIN_CALLS["ragged_score_plain"] == _live_parts(ddb)
    want = jax_search(query, db, 3, 1, matrix, mode=mode,
                      search_type=search_type,
                      engine=JaxEngine(backend="xla", block_size=B,
                                       mesh=jax_mesh))
    assert _fields(got) == _fields(want)


def test_sharded_wide_mesh(mesh, jax_mesh):
    """More parts than blocks: 2 blocks over 8 devices; the 6 empty parts
    are never launched."""
    rng = np.random.default_rng(77)
    query, db, matrix = random_problem(rng, n_seqs=20, query_len=25,
                                       min_len=5, max_len=40)
    eng = Engine(device="cpu", block_size=B, mesh=mesh)
    ddb = eng.upload(db)
    assert [len(p.blocks) for p in ddb.parts].count(0) == 6
    kernels.reset_counts()
    got = search_database(query, ddb, 3, 1, matrix, mode=MODE_SW,
                          search_type=SEARCH_SCORE_END, engine=eng)
    assert kernels.PLAIN_CALLS["ragged_score_plain"] == 2
    want = jax_search(query, db, 3, 1, matrix, mode=MODE_SW,
                      search_type=SEARCH_SCORE_END,
                      engine=JaxEngine(backend="xla", block_size=B,
                                       mesh=jax_mesh))
    assert _fields(got) == _fields(want)


def test_sharded_split_balance(mesh, jax_mesh):
    """Equal-mass blocks give one block per part, as opal_tpu's
    flat_sharded gives one per device; on a random database every block
    lies in exactly one part, contiguous and in order, and each part's
    stream equals opal_tpu's chunk stream of the same blocks."""
    rng = np.random.default_rng(5)
    db = [rng.integers(0, 4, size=T_CHUNK - 3, dtype=np.uint8)
          for _ in range(32)]
    ddb = Engine(device="cpu", block_size=4, mesh=mesh).upload(db)
    assert len(ddb.blocks) == 8
    assert [len(p.blocks) for p in ddb.parts] == [1] * 8
    jdb = JaxEngine(backend="xla", block_size=4, mesh=jax_mesh).upload(db)
    assert [len(g) for g in jdb.flat_sharded()[0]] == [1] * 8

    _, db, _ = random_problem(rng, n_seqs=150, min_len=1, max_len=300)
    for n_parts in (1, 3, 8):
        ddb = DeviceDatabase(db, B, "cpu", db_mesh(["cpu"] * n_parts))
        assert [id(b) for p in ddb.parts for b in p.blocks] == [
            id(b) for b in ddb.blocks]
        assert [[id(b) for b in g]
                for g in split_blocks(ddb.blocks, n_parts)] == [
            [id(b) for b in p.blocks] for p in ddb.parts]
        jdb = JaxDeviceDatabase(db, B)
        first = 0
        for part in ddb.parts:
            jblocks = jdb.blocks[first:first + len(part.blocks)]
            first += len(part.blocks)
            c = sum(-(-b.letters.shape[0] // T_CHUNK) for b in jblocks)
            want = stream_from_jax_numpy(
                jblocks, *jdb._build_stream_np(jblocks, c + 1,
                                               len(jblocks) + 1), "cpu")
            for name in ("letters", "offsets", "lengths"):
                torch.testing.assert_close(getattr(part.stream, name),
                                           getattr(want, name), rtol=0,
                                           atol=0, msg=name)
            for bi, blk in enumerate(part.blocks):
                np.testing.assert_array_equal(
                    part.lane_indices[bi, :blk.n].numpy(), blk.indices)
        # the cut balances the parts' cost to within one block
        costs = [sum(b.letters.size for b in p.blocks) for p in ddb.parts]
        biggest = max(b.letters.size for b in ddb.blocks)
        assert max(costs) - min(costs) <= 2 * biggest


@pytest.mark.parametrize("mode", MODES)
def test_sharded_score_step(mode, mesh, jax_mesh):
    """The explicit step (profile replicated, lanes split) against
    opal_tpu's shard_map step, score and ends."""
    rng = np.random.default_rng(3 + mode)
    query, db, matrix = random_problem(rng, n_seqs=16, query_len=30,
                                       min_len=10, max_len=60)
    T = max(len(s) for s in db)
    letters = np.zeros((T, 16), np.int8)
    lengths = np.zeros((1, 16), np.int32)
    for i, s in enumerate(db):
        letters[: len(s), i] = s
        lengths[0, i] = len(s)
    qprofile = matrix[query.astype(np.int64)].T.astype(np.int32)
    got = sharded_score_step(mode, SEARCH_SCORE_END, len(query), 3, 1,
                             mesh)(qprofile, letters, lengths)
    want = jax_sharded_score_step(mode, SEARCH_SCORE_END, len(query), 3, 1,
                                  jax_mesh)(qprofile, letters, lengths)
    for k in ("score", "end_q", "end_t"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("search_type", XS)
def test_sharded_stacked_multi_query(search_type, mesh, jax_mesh):
    """A stacked group runs multi_dp once per live part; each query's
    columns equal opal_tpu's search_database_multi_arrays on its mesh."""
    rng = np.random.default_rng(900 + search_type)
    _, db, matrix = random_problem(rng, n_seqs=50, query_len=30, min_len=5,
                                   max_len=120)
    queries = [rng.integers(0, 4, size=q, dtype=np.uint8)
               for q in (20, 33, 17)]
    eng = Engine(device="cpu", block_size=B, mesh=mesh)
    ddb = eng.upload(db)
    kernels.reset_counts()
    got = search_database_multi_arrays(queries, ddb, 3, 1, matrix,
                                       mode=MODE_SW,
                                       search_type=search_type, engine=eng)
    assert kernels.PLAIN_CALLS["multi_score_plain"] == _live_parts(ddb)
    want = jax_multi_arrays(queries, db, 3, 1, matrix, mode=MODE_SW,
                            search_type=search_type,
                            engine=JaxEngine(backend="xla", block_size=B,
                                             mesh=jax_mesh))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("search_type", XS)
def test_sharded_panels_match_jax(mode, search_type, mesh, jax_mesh,
                                  monkeypatch):
    """A query taller than PANEL_ROWS (16 here) runs in panels over every
    part, each part's panels handing rows on within the part; opal_tpu's
    mesh runs its panel kernel under shard_map (OPAL_TPU_FORCE_PANELS,
    16-row panels, interpret mode)."""
    monkeypatch.setattr(kernels, "PANEL_ROWS", 16)
    monkeypatch.setenv("OPAL_TPU_FORCE_PANELS", "1")
    monkeypatch.setenv("OPAL_TPU_PANEL_ROWS", "16")
    rng = np.random.default_rng(4000 + 2 * mode + search_type)
    query, db, matrix = random_problem(rng, n_seqs=40, query_len=40,
                                       min_len=5, max_len=60)
    eng = Engine(device="cpu", block_size=B, mesh=mesh)
    ddb = eng.upload(db)
    kernels.reset_counts()
    got = search_database(query, ddb, 3, 1, matrix, mode=mode,
                          search_type=search_type, engine=eng)
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] == 3 * _live_parts(ddb)
    jeng = JaxEngine(backend="pallas", block_size=B, mesh=jax_mesh)
    jeng._backend = PallasBackend(interpret=True)
    want = jax_search(query, db, 3, 1, matrix, mode=mode,
                      search_type=search_type, engine=jeng)
    assert any(k[0] == "panel" for k in jeng._backend._sharded_cache)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_top_k(mode, mesh, jax_mesh):
    """Device top k per part, merged by union, against opal_tpu's ranked
    search on its mesh, k from 1 past the database size."""
    rng = np.random.default_rng(40 + mode)
    query, db, matrix = random_problem(rng, n_seqs=45, query_len=23,
                                       min_len=1, max_len=50)
    db[7] = db[30].copy()  # a tie across parts
    eng = Engine(device="cpu", block_size=4, mesh=mesh)
    jeng = JaxEngine(backend="xla", block_size=B, mesh=jax_mesh)
    for k in (1, 10, 45, 60):
        got = search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                     search_type=SEARCH_SCORE_END,
                                     engine=eng, top_k=k)
        want = jax_arrays(query, db, 3, 1, matrix, mode=mode,
                          search_type=SEARCH_SCORE_END, engine=jeng,
                          top_k=k)
        assert sorted(got) == sorted(want)
        for c in got:
            np.testing.assert_array_equal(got[c], np.asarray(want[c]),
                                          err_msg=f"k={k} {c}")


@pytest.mark.parametrize("mode", [MODE_SW, MODE_NW])
def test_sharded_cascade_stats(mode, mesh):
    """The adaptive cascade on a mesh (flag rows per part, and the ad-hoc
    upload of a partial rescore over the same mesh) reports the same
    results and last_search_stats as the unsharded port."""
    rng = np.random.default_rng(60 + mode)
    A = 6
    matrix = (np.eye(A, dtype=np.int32) * 40 - 8)
    query = rng.integers(0, A, size=50, dtype=np.uint8)
    db = [rng.integers(0, A, size=int(n), dtype=np.uint8)
          for n in rng.integers(1, 140, size=70)]
    db[3] = query.copy()  # a score past 127
    runs = []
    for m in (None, mesh):
        eng = Engine(device="cpu", block_size=B, precision="adaptive",
                     mesh=m)
        res = search_database(query, db, 3, 1, matrix, mode=mode,
                              search_type=SEARCH_SCORE_END, engine=eng)
        stats = eng.last_search_stats
        part = search_database(query, db, 3, 1, matrix, mode=mode,
                               search_type=SEARCH_SCORE_END, engine=eng,
                               results=[r if i % 3 else type(r)()
                                        for i, r in enumerate(res)])
        runs.append((_fields(res), _fields(part), stats,
                     eng.last_search_stats))
    assert runs[0][:2] == runs[1][:2]
    for st0, st1 in zip(runs[0][2:], runs[1][2:]):
        assert sorted(st0) == sorted(st1)
        for k in st0:
            if isinstance(st0[k], np.ndarray):
                np.testing.assert_array_equal(st0[k], st1[k], err_msg=k)
            else:
                assert st0[k] == st1[k], k
    assert runs[0][2]["precision_counts"][16] > 0


def test_db_mesh_and_engine_devices(monkeypatch):
    """A mesh may repeat a device, may not mix CPU and CUDA, and sets the
    engine's device; an engine asked for another device type refuses it."""
    mesh = db_mesh(["cpu", torch.device("cpu")])
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.size == 2 and mesh.axis_names == ("db",)
    assert Engine(device="cpu", mesh=mesh).device == torch.device("cpu")
    with pytest.raises(ValueError):
        db_mesh([])
    with pytest.raises(ValueError):
        Engine(device="cuda", mesh=mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="mixes"):
        db_mesh(["cpu", "cuda:0"])
