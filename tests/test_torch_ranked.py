"""The port's device-side top-k (opal_tpu_torch.engine.ranked) against
opal_tpu.engine.ranked, on CPU tensors: the same candidate selection under
heavy ties, k larger than the database, and padding lanes keyed I32_MIN.
torch.topk leaves the order of equal keys unspecified; the selection keys
are unique (-index), and a test pins that the choice does not depend on
it."""
import numpy as np
import pytest
import torch

from opal_tpu.engine import ranked as jax_ranked
from opal_tpu_torch.engine import ranked
from opal_tpu_torch.engine.device_db import DeviceDatabase
from opal_tpu_torch.engine.search import Engine, search_database_arrays
from opal_tpu_torch.matrices import ScoreMatrix
from opal_tpu_torch.ranking import rank_rows


def _lanes(seed, nb, B, n_valid, score_range):
    """Scores, ends and lane DB indices [nb, B]: n_valid lanes hold a
    shuffled DB index, the others -1 (padding)."""
    rng = np.random.default_rng(seed)
    score = rng.integers(*score_range, size=(nb, B)).astype(np.int32)
    end_q = rng.integers(0, 50, size=(nb, B)).astype(np.int32)
    end_t = rng.integers(0, 500, size=(nb, B)).astype(np.int32)
    idx = np.full(nb * B, -1, np.int32)
    lanes = rng.choice(nb * B, n_valid, replace=False)
    idx[lanes] = rng.permutation(n_valid)
    return score, end_q, end_t, idx.reshape(nb, B)


def _valid(cand):
    cand = np.asarray(cand)
    return cand[:, cand[2] != 0]


@pytest.mark.parametrize("k", [1, 5, 17, 50])
@pytest.mark.parametrize("score_range", [(0, 3), (-5, 40), (7, 8)])
@pytest.mark.parametrize("track_end", [False, True])
def test_select_topk_matches_jax(track_end, score_range, k):
    """Tie-heavy scores; k = 50 exceeds the 32 lanes; 9 padding lanes."""
    import jax.numpy as jnp

    score, end_q, end_t, idx = _lanes(k, 4, 8, 23, score_range)
    ends = (end_q, end_t) if track_end else (None, None)
    mine = ranked.select_topk(
        torch.from_numpy(score),
        *(None if e is None else torch.from_numpy(e) for e in ends),
        torch.from_numpy(idx), k).numpy()
    theirs = np.asarray(jax_ranked._select_topk(
        jnp.asarray(score), *(None if e is None else jnp.asarray(e)
                              for e in ends), jnp.asarray(idx), k))
    assert mine.shape == theirs.shape == (5 if track_end else 3,
                                          2 * min(k, 32))
    assert mine.dtype == np.int32
    # the slots of valid candidates are equal; padding slots may pick any
    # of the tied I32_MIN keys
    np.testing.assert_array_equal(_valid(mine), _valid(theirs))
    got = ranked.merge_candidates([mine], k, track_end)
    want = jax_ranked.merge_candidates([theirs], k, track_end)
    assert set(got) == set(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    assert len(got["index"]) == min(k, 23)
    # and the host ranking of every valid lane
    ok = idx.reshape(-1) >= 0
    cols = {"score": score.reshape(-1)[ok]}
    if track_end:
        cols["end_q"] = end_q.reshape(-1)[ok]
        cols["end_t"] = end_t.reshape(-1)[ok]
    ridx, rcols = rank_rows(idx.reshape(-1)[ok], cols, k)
    np.testing.assert_array_equal(got["index"], ridx)
    for c in rcols:
        np.testing.assert_array_equal(got[c], rcols[c], err_msg=c)


@pytest.mark.parametrize("seed", range(4))
def test_selection_ignores_lane_order_under_ties(seed):
    """Every lane scores the same: the k winners are the k smallest DB
    indices wherever those sit among the lanes, because the keys the
    topk calls see are unique."""
    rng = np.random.default_rng(seed)
    n = 200
    idx = torch.from_numpy(rng.permutation(n).astype(np.int32).reshape(
        25, 8))
    score = torch.full((25, 8), 11, dtype=torch.int32)
    cand = ranked.select_topk(score, None, None, idx, 10)
    valid = cand[:, cand[2] != 0]
    assert sorted(valid[0].tolist()) == list(range(10))
    out = ranked.merge_candidates([cand.numpy()], 10, False)
    np.testing.assert_array_equal(out["index"], np.arange(10))


def test_merge_candidates_matches_jax_across_parts():
    """The union of several parts' candidates, with an empty part list."""
    parts = []
    for seed in range(3):
        score, end_q, end_t, idx = _lanes(seed, 2, 8, 12, (0, 4))
        idx = np.where(idx >= 0, idx + 100 * seed, -1)
        parts.append(ranked.select_topk(
            *(torch.from_numpy(a) for a in (score, end_q, end_t, idx)),
            6).numpy())
    for k in (1, 6, 40):
        got = ranked.merge_candidates(parts, k, True)
        want = jax_ranked.merge_candidates(parts, k, True)
        for c in want:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    empty = ranked.merge_candidates([], 5, True)
    assert all(len(v) == 0 for v in empty.values())


def test_lane_indices_cached_on_the_database():
    rng = np.random.default_rng(3)
    db = [rng.integers(0, 20, size=int(n)).astype(np.uint8)
          for n in rng.integers(1, 40, size=21)]
    ddb = DeviceDatabase(db, 8, "cpu")
    (part,) = ddb.parts
    lanes = part.lane_indices
    assert lanes is part.lane_indices
    assert lanes.shape == (len(ddb.blocks), 8) and lanes.dtype == torch.int32
    for bi, blk in enumerate(ddb.blocks):
        np.testing.assert_array_equal(lanes[bi, :blk.n].numpy(),
                                      blk.indices)
        assert (lanes[bi, blk.n:] == -1).all()


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_topk_from_handle_equals_host_ranking(mode):
    """The single-query search's device top-k against the host ranking of
    its full score table, with k past the database size too."""
    sm = ScoreMatrix.blosum50()
    rng = np.random.default_rng(40 + mode)
    query = rng.integers(0, 24, size=23).astype(np.uint8)
    db = [rng.integers(0, 4, size=int(n)).astype(np.uint8)
          for n in rng.integers(1, 30, size=37)]
    engine = Engine(device="cpu", block_size=8)
    full = search_database_arrays(query, db, 3, 1, sm.matrix, mode=mode,
                                  search_type=1, engine=engine)
    for k in (1, 10, 37, 60):
        top = search_database_arrays(query, db, 3, 1, sm.matrix, mode=mode,
                                     search_type=1, engine=engine, top_k=k)
        ridx, rcols = rank_rows(np.arange(len(db)), full, k)
        np.testing.assert_array_equal(top["index"], ridx)
        for c in rcols:
            np.testing.assert_array_equal(top[c], rcols[c], err_msg=c)
