"""The port's ragged DP (opal_tpu_torch.engine.kernels) against opal_tpu.

`ragged_score_plain` is the plain PyTorch version of the ragged_dp CUDA
kernel, and what `ragged_score` runs for CPU tensors. Here it is held
against opal_tpu's int32 twin (engine/xla.py::build_score_fn) on random
blocks, and against opal_tpu's Pallas ragged kernel in interpret mode.
Integer DP: every comparison is exact. The kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from opal_tpu.engine import pallas_kernels as pk
from opal_tpu.engine.xla import build_score_fn
from opal_tpu_torch.constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from opal_tpu_torch.engine import batching, kernels

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


def _problem(seed, go, ge, n=45):
    """Random query, DB and matrix: lengths 1..tmax (both ends present),
    n not a multiple of B so the first block is partial. The plain
    version's F chain runs row by row when ge > go, so that case is
    smaller."""
    rng = np.random.default_rng(seed)
    qmax, tmax = (24, 100) if ge > go else (64, 300)
    A = 6
    matrix = rng.integers(-4, 7, size=(A, A)).astype(np.int32)
    query = rng.integers(0, A, size=int(rng.integers(1, qmax + 1)))
    lens = rng.integers(1, tmax + 1, size=n)
    lens[0], lens[-1] = 1, tmax
    db = [rng.integers(0, A, size=int(L)).astype(np.uint8) for L in lens]
    return query, db, matrix, tmax


def _finalized(tr, blocks, mode, x, Q):
    """kernels.finalize_device's columns of tracker rows [NB, n_rows, B],
    one {col: [B] array} per block."""
    lengths = torch.from_numpy(np.stack([b.lengths for b in blocks]))
    cols = kernels.finalize_device(torch.from_numpy(tr), lengths, mode, x, Q)
    return [{k: c[bi].numpy() for k, c in zip(("score", "end_q", "end_t"),
                                               cols) if c is not None}
            for bi in range(len(blocks))]


def _port_trackers(query, db, matrix, mode, x, go, ge):
    blocks = batching.plan_blocks(db, B)
    stream = kernels.pack_stream([b.letters for b in blocks],
                                 [b.lengths for b in blocks], B, "cpu")
    profile = torch.from_numpy(kernels.build_profile(matrix[query].T))
    tr = kernels.ragged_score_plain(profile, stream, mode, x, go, ge)
    return blocks, tr.numpy()


@pytest.mark.parametrize("go,ge", GAPS)
@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_xla_twin(mode, x, go, ge):
    query, db, matrix, tmax = _problem(100 * mode + 10 * go + ge, go, ge)
    Q = len(query)
    blocks, tr = _port_trackers(query, db, matrix, mode, x, go, ge)
    # the twin at score+end (its score is the same DP either way), every
    # block padded to one shape so it compiles once
    fn = build_score_fn(mode, SEARCH_SCORE_END, Q, go, ge)
    qprofile = matrix[query].T.astype(np.int32)
    final = _finalized(tr, blocks, mode, x, Q)
    for bi, blk in enumerate(blocks):
        letters = np.full((tmax, B), batching.PAD_LETTER, np.int32)
        letters[: blk.t_pad] = blk.letters
        want = {k: np.asarray(v) for k, v in
                fn(qprofile, letters, blk.lengths).items()}
        got = final[bi]
        assert set(got) == ({"score"} if x == SEARCH_SCORE
                            else {"score", "end_q", "end_t"})
        for k, v in got.items():  # every lane, padding lanes included
            np.testing.assert_array_equal(v, want[k], err_msg=f"{k} {bi}")


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_xla_twin_large_alphabet(mode):
    """A 100-letter alphabet: the profile is 100 columns wide and the
    padding letter (31) is a real letter."""
    rng = np.random.default_rng(7 + mode)
    A = 100
    matrix = rng.integers(-6, 9, size=(A, A)).astype(np.int32)
    query = rng.integers(0, A, size=29)
    db = [rng.integers(0, A, size=int(L)).astype(np.uint8)
          for L in rng.integers(1, 81, size=37)]
    blocks, tr = _port_trackers(query, db, matrix, mode, SEARCH_SCORE_END,
                                3, 1)
    fn = build_score_fn(mode, SEARCH_SCORE_END, len(query), 3, 1)
    final = _finalized(tr, blocks, mode, SEARCH_SCORE_END, len(query))
    for bi, blk in enumerate(blocks):
        letters = np.zeros((80, B), np.int32)
        letters[: blk.t_pad] = blk.letters
        want = fn(matrix[query].T, letters, blk.lengths)
        got = final[bi]
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(want[k]),
                                          err_msg=f"{k} {bi}")


@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_interpret(mode, x):
    """One small ragged stream per mode through opal_tpu's Pallas ragged
    kernel (interpret mode, as tests/test_pallas_interpret.py runs it)."""
    import jax.numpy as jnp

    from opal_tpu.engine.device_db import DeviceDatabase

    go, ge = 3, 1
    rng = np.random.default_rng(23 + mode)
    query = rng.integers(0, 4, size=21)
    matrix = np.full((4, 4), -1, np.int32)
    np.fill_diagonal(matrix, 3)
    db = [rng.integers(0, 4, size=int(rng.integers(5, 151))).astype(np.uint8)
          for _ in range(40)]
    Q = len(query)
    jdb = DeviceDatabase(db, B)
    nb = len(jdb.blocks)
    c_real = sum(-(-b.letters.shape[0] // pk.T_CHUNK) for b in jdb.blocks)
    meta, letters, lengths = jdb._build_stream_np(jdb.blocks, c_real + 2,
                                                  nb + 1)
    qprofile = matrix[query].T
    packed = (mode == MODE_SW and x != SEARCH_SCORE
              and pk.sw_end_packed_ok(Q, int(np.abs(qprofile).max()), ge))
    fn = pk.build_pallas_ragged_fn_raw(mode, x, Q, go, ge, B=B,
                                       interpret=True, sw_end_packed=packed)
    tr_jax = np.asarray(fn(jnp.asarray(meta),
                           jnp.asarray(pk.prepare_qp(qprofile, ge),
                                       jnp.bfloat16),
                           jnp.asarray(letters), jnp.asarray(lengths)))
    blocks, tr = _port_trackers(query, db, matrix, mode, x, go, ge)
    assert len(blocks) == nb
    final = _finalized(tr, blocks, mode, x, Q)
    for bi, blk in enumerate(blocks):
        np.testing.assert_array_equal(blk.indices, jdb.blocks[bi].indices)
        want = pk.finalize_trackers(tr_jax[bi].astype(np.int32), mode, x, Q,
                                    blk.lengths)
        got = final[bi]
        for k, v in got.items():
            np.testing.assert_array_equal(v[: blk.n], want[k][: blk.n],
                                          err_msg=f"{k} {bi}")


def test_wrapper_runs_plain_version_on_cpu():
    query, db, matrix, _ = _problem(5, 3, 1, n=20)
    blocks = batching.plan_blocks(db, B)
    stream = kernels.pack_stream([b.letters for b in blocks],
                                 [b.lengths for b in blocks], B, "cpu")
    profile = torch.from_numpy(kernels.build_profile(matrix[query].T))
    launches = dict(kernels.LAUNCHES)
    calls = kernels.PLAIN_CALLS["ragged_score_plain"]
    out = kernels.ragged_score(profile, stream, MODE_OV, 1, 3, 1)
    assert kernels.PLAIN_CALLS["ragged_score_plain"] == calls + 1
    assert kernels.LAUNCHES == launches
    assert out.shape == (len(blocks), 3, B) and out.dtype == torch.int32
    with pytest.raises(ValueError):  # a device with no kernel
        kernels.ragged_score(profile.to("meta"), dataclasses.replace(
            stream, letters=stream.letters.to("meta"),
            offsets=stream.offsets.to("meta"),
            lengths=stream.lengths.to("meta")), MODE_SW, 0, 3, 1)


def test_profile_rejects_oversized_alphabet():
    with pytest.raises(ValueError):
        kernels.build_profile(np.zeros((kernels.MAX_ALPHABET + 1, 4)))
    prof = kernels.build_profile(np.arange(40 * 3).reshape(40, 3))
    assert prof.shape == (3, 40)


def test_plan_waves_cover_blocks_in_order(monkeypatch):
    offsets = np.cumsum([0, 5, 7, 30, 1, 1, 2])
    monkeypatch.setattr(kernels, "WAVE_CELLS", 10)
    waves = kernels.plan_waves(offsets)
    assert waves == [(0, 1), (1, 1), (2, 1), (3, 3)]
    monkeypatch.setattr(kernels, "WAVE_CELLS", 10**9)
    assert kernels.plan_waves(offsets) == [(0, 6)]
