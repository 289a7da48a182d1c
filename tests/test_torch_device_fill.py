"""The device alignment fill of the port (engine/device_fill.py) on the CPU.

The setup is tests/test_device_fill.py's: BLOSUM50, seed 23, a 90-letter
query and 120 targets with planted prefix ties and a 1-letter target. The
plain version runs on the CPU (the CUDA kernel is held against it on the
card: tests/test_torch_cuda.py, chip_smoke.py) and must equal opal_tpu's
jitted _fill_walk_fn exactly on all five outputs; align_winners_device
and x2 search_database with OPAL_TPU_DEVICE_FILL=1 must equal opal_tpu's
and the port's host path, field by field and byte for byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu.engine import device_fill as jax_fill
from opal_tpu.engine.search import Engine as JaxEngine
from opal_tpu.engine.search import search_database as jax_search_database
from opal_tpu.matrices import ScoreMatrix as JaxScoreMatrix
from opal_tpu_torch.constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_ALIGNMENT,
    SEARCH_SCORE_END,
)
from opal_tpu_torch.engine import device_fill, kernels
from opal_tpu_torch.engine import search as port_search
from opal_tpu_torch.engine.search import (
    Engine,
    alignment_pass,
    search_database,
    search_database_arrays,
)
from opal_tpu_torch.result import SearchResult
from opal_tpu_torch.traceback import AlignmentError, align_pair_reverse_trick

MODES = [MODE_SW, MODE_NW, MODE_HW, MODE_OV]
GAPS = [(3, 1), (5, 5), (10, 2), (1, 1), (7, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    matrix = JaxScoreMatrix.blosum50().matrix
    A = matrix.shape[0]
    rng = np.random.default_rng(23)
    q = rng.integers(0, A - 4, size=90, dtype=np.uint8)
    db = [rng.integers(0, A - 4, size=int(rng.integers(4, 260)),
                       dtype=np.uint8) for _ in range(120)]
    # adversarial: repeats of query prefixes (ties), a 1-letter target
    for i in range(0, 120, 9):
        db[i] = q[: int(rng.integers(3, 90))].copy()
    db[5] = q[:1].copy()
    return matrix, q, db


_WINNERS = {}


def _winners(setup, mode, go=3, ge=1):
    """(index, score, end_q, end_t) of every pair with an alignment, from
    the port's x1 search on the CPU."""
    key = (mode, go, ge)
    if key not in _WINNERS:
        matrix, q, db = setup
        out = search_database_arrays(
            q, db, go, ge, matrix, mode=mode, search_type=SEARCH_SCORE_END,
            engine=Engine(device="cpu", block_size=128))
        _WINNERS[key] = [
            (i, int(out["score"][i]), int(out["end_q"][i]),
             int(out["end_t"][i]))
            for i in range(len(db))
            if not (mode == MODE_SW and out["score"][i] == 0)]
    return _WINNERS[key]


def _one_group(setup, mode, winners, go=3, ge=1):
    """All device-fillable lanes of `winners` as one group, packed as
    align_winners_device packs them, with the last lane's limit raised by
    one (a lane whose score never reaches its limit: ok is False)."""
    matrix, q, db = setup
    host = dict.fromkeys(("no_end", "no_band", "value_bound", "budget"), 0)
    jobs = device_fill.make_jobs(q, db, go, ge, matrix, mode, winners, host)
    (group,) = device_fill.plan_groups(jobs, 512, 1 << 40, host)
    group[-1] = group[-1][:1] + (group[-1][1] + 1,) + group[-1][2:]
    return device_fill.pack_group(group, torch.device("cpu"))


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_opal_tpu_fill_walk(setup, mode):
    matrix = setup[0]
    args = _one_group(setup, mode, _winners(setup, mode))
    Qp, B = args[0].shape
    Tp = args[1].shape[0]
    calls = kernels.PLAIN_CALLS["fill_walk_plain"]
    got = device_fill.fill_walk(*args, 3, 1, torch.from_numpy(
        matrix.astype(np.int32)), mode)
    assert kernels.PLAIN_CALLS["fill_walk_plain"] == calls + 1
    fn = jax_fill._fill_walk_fn(mode, Qp, Tp, B, False, use_f32=False)
    want = fn(*(jnp.asarray(a.numpy()) for a in args), jnp.int32(3),
              jnp.int32(1), jnp.asarray(matrix, jnp.int32))
    names = ("score", "rend_q", "rend_t", "ok", "codes")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    ok = got[3].numpy()
    assert not ok[-1] and ok.sum() >= 0.9 * B  # the planted lane, the rest


def _same_paths(got, want):
    assert set(got) == set(want)
    for i in got:
        assert got[i][:2] == want[i][:2], i
        np.testing.assert_array_equal(got[i][2], want[i][2], err_msg=str(i))


@pytest.mark.parametrize("mode,go,ge", [(m, 3, 1) for m in MODES]
                         + [(MODE_SW, go, ge) for go, ge in GAPS[1:]])
def test_align_winners_matches_opal_tpu(setup, mode, go, ge):
    matrix, q, db = setup
    winners = _winners(setup, mode, go, ge)
    got = device_fill.align_winners_device(q, db, go, ge, matrix, mode,
                                           winners, device="cpu")
    want = jax_fill.align_winners_device(q, db, go, ge, matrix, mode,
                                         winners)
    _same_paths(got, want)
    stats = device_fill.LAST_STATS
    assert stats["device_lanes"] == len(got)
    assert stats["device_lanes"] + sum(stats["host_lanes"].values()) == len(
        winners)


@pytest.mark.parametrize("mode", MODES)
def test_align_winners_matches_host_path(setup, mode):
    matrix, q, db = setup
    winners = _winners(setup, mode)
    got = device_fill.align_winners_device(q, db, 3, 1, matrix, mode,
                                           winners, lanes=64, device="cpu")
    n_checked = 0
    for i, score, eq, et in winners:
        try:
            want = align_pair_reverse_trick(q, db[i], 3, 1, matrix, score,
                                            eq, et, mode)
        except AlignmentError:
            assert i not in got
            continue
        if i in got:
            assert got[i][:2] == want[:2], i
            np.testing.assert_array_equal(got[i][2], want[2])
            n_checked += 1
    assert n_checked >= 0.9 * len(winners), (n_checked, len(winners))


def _fields(res):
    return [(r.score, r.score_set, r.start_location_query,
             r.start_location_target, r.end_location_query,
             r.end_location_target, r.alignment_length,
             None if r.alignment is None else bytes(r.alignment))
            for r in res]


@pytest.mark.parametrize("mode", MODES)
def test_search_with_the_switch_matches(setup, monkeypatch, mode):
    matrix, q, db = setup
    monkeypatch.delenv("OPAL_TPU_DEVICE_FILL", raising=False)
    host = search_database(q, db, 3, 1, matrix, mode=mode,
                           search_type=SEARCH_ALIGNMENT,
                           engine=Engine(device="cpu", block_size=128))
    monkeypatch.setenv("OPAL_TPU_DEVICE_FILL", "1")
    kernels.reset_counts()
    dev = search_database(q, db, 3, 1, matrix, mode=mode,
                          search_type=SEARCH_ALIGNMENT,
                          engine=Engine(device="cpu", block_size=128))
    assert kernels.PLAIN_CALLS["fill_walk_plain"] == 1
    assert device_fill.LAST_STATS["device_lanes"] >= 0.9 * len(
        _winners(setup, mode))
    ref = jax_search_database(q, db, 3, 1, matrix, mode=mode,
                              search_type=SEARCH_ALIGNMENT,
                              engine=JaxEngine(backend="xla",
                                               block_size=128))
    assert _fields(dev) == _fields(host) == _fields(ref)


def test_audit_replaces_a_wrong_lane(setup, monkeypatch):
    matrix, q, db = setup
    winners = _winners(setup, MODE_SW)
    real = device_fill.align_winners_device
    planted = winners[3][0]

    def wrong(*a, **kw):
        out = real(*a, **kw)
        sq, st, ops = out[planted]
        out[planted] = (sq, st, ops[::-1].copy())
        return out

    def run():
        res = [SearchResult() for _ in db]
        for i, s, eq, et in winners:
            res[i].score, res[i].score_set = s, 1
            res[i].end_location_query, res[i].end_location_target = eq, et
        alignment_pass(q, db, 3, 1, matrix, MODE_SW, res,
                       [w[0] for w in winners], device="cpu")
        return res

    monkeypatch.delenv("OPAL_TPU_DEVICE_FILL", raising=False)
    host = run()
    monkeypatch.setattr(device_fill, "align_winners_device", wrong)
    monkeypatch.setenv("OPAL_TPU_DEVICE_FILL", "1")
    monkeypatch.setenv("OPAL_TPU_DEVICE_FILL_CHECK", "1")
    with pytest.warns(RuntimeWarning, match=f"lane {planted} differs"):
        audited = run()
    assert _fields(audited) == _fields(host)
    monkeypatch.delenv("OPAL_TPU_DEVICE_FILL_CHECK")
    unaudited = run()  # without the audit the planted path stands
    assert bytes(unaudited[planted].alignment) != bytes(
        host[planted].alignment)


def test_no_device_fill_for_ge_above_go_or_zero_gaps(setup):
    matrix, q, db = setup
    for go, ge in ((1, 5), (0, 0)):
        assert device_fill.align_winners_device(
            q, db, go, ge, matrix, MODE_SW, [(0, 10, 5, 5)],
            device="cpu") == {}


def test_budget_splits_groups(setup, monkeypatch):
    matrix, q, db = setup
    winners = _winners(setup, MODE_OV)
    whole = device_fill.align_winners_device(q, db, 3, 1, matrix, MODE_OV,
                                             winners, device="cpu")
    assert device_fill.LAST_STATS["groups"] == 1
    # room for four 128 x 320 lanes: many groups, and no lane left out
    monkeypatch.setattr(device_fill, "FILL_BUDGET_BYTES", 4 * 128 * 320)
    split = device_fill.align_winners_device(q, db, 3, 1, matrix, MODE_OV,
                                             winners, device="cpu")
    assert device_fill.LAST_STATS["groups"] > 4
    assert all(b * qp * tp <= 4 * 128 * 320
               for b, qp, tp in device_fill.LAST_STATS["shapes"])
    _same_paths(split, whole)
    # a budget below one lane's bits: those lanes go to the host path
    monkeypatch.setattr(device_fill, "FILL_BUDGET_BYTES", 64 * 128)
    small = device_fill.align_winners_device(q, db, 3, 1, matrix, MODE_OV,
                                             winners, device="cpu")
    assert device_fill.LAST_STATS["host_lanes"]["budget"] > 0
    assert set(small) < set(whole)
    _same_paths(small, {i: whole[i] for i in small})


def test_switch_without_cuda_raises(setup, monkeypatch):
    matrix, q, db = setup
    winners = _winners(setup, MODE_SW)[:4]
    res = {}
    for i, s, eq, et in winners:
        r = res[i] = SearchResult()
        r.score, r.score_set = s, 1
        r.end_location_query, r.end_location_target = eq, et
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("OPAL_TPU_DEVICE_FILL", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        alignment_pass(q, db, 3, 1, matrix, MODE_SW, res, list(res))
    monkeypatch.delenv("OPAL_TPU_DEVICE_FILL")
    alignment_pass(q, db, 3, 1, matrix, MODE_SW, res, list(res))  # host
    assert all(r.alignment is not None for r in res.values())


def test_stats_line(setup, monkeypatch, capsys):
    matrix, q, db = setup
    monkeypatch.setenv("OPAL_TPU_DEVICE_FILL_STATS", "1")
    device_fill.align_winners_device(q, db, 3, 1, matrix, MODE_HW,
                                     _winners(setup, MODE_HW), device="cpu")
    err = capsys.readouterr().err
    assert err.startswith("[device_fill] groups=1 ")
    for key in ("pack=", "dev=", "replay=", "device_lanes=", "host_lanes="):
        assert key in err


def test_wrapper_refuses_bad_input(setup):
    matrix = torch.from_numpy(setup[0].astype(np.int32))
    z = torch.zeros(2, dtype=torch.int32)
    aq = torch.zeros((64, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        device_fill.fill_walk(aq.long(), aq, z, z, z, z, z, 3, 1, matrix,
                              MODE_SW)
    with pytest.raises(ValueError):
        device_fill.fill_walk(aq, aq, z[:1], z, z, z, z, 3, 1, matrix,
                              MODE_SW)
    meta = [t.to("meta") for t in (aq, aq, z, z, z, z, z)]
    with pytest.raises(ValueError, match="no device_fill kernel"):
        device_fill.fill_walk(*meta, 3, 1, matrix.to("meta"), MODE_SW)
    assert port_search.resolve_device("cpu") == torch.device("cpu")
