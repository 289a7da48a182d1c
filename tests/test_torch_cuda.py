"""ragged_dp and multi_dp on the card: the CUDA kernels against their plain
versions, and the serving path on the card against the CPU.

These tests need an NVIDIA GPU with nvcc and skip without one. They import
neither JAX nor opal_tpu, so they also run where only PyTorch is installed:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from opal_tpu_torch.constants import MODE_OV, MODE_SW
from opal_tpu_torch.engine import batching, kernels
from opal_tpu_torch.engine.search import (
    Engine,
    search_database_arrays,
    search_database_multi_arrays,
)
from opal_tpu_torch.matrices import ScoreMatrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _stream(seed, n, max_len, B, A, device):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, size=n)
    lens[-1] = max_len
    db = [rng.integers(0, A, size=int(L)).astype(np.uint8) for L in lens]
    blocks = batching.plan_blocks(db, B)
    return kernels.pack_stream([b.letters for b in blocks],
                               [b.lengths for b in blocks], B, device)


@pytest.mark.parametrize("go,ge", [(3, 1), (1, 3), (0, 0)])
@pytest.mark.parametrize("x", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_kernel_matches_plain(cuda, mode, x, go, ge):
    matrix = ScoreMatrix.blosum50().matrix
    rng = np.random.default_rng(mode)
    for Q in (1, 17, 70):
        profile = torch.from_numpy(kernels.build_profile(
            matrix[rng.integers(0, 24, size=Q)].T)).to(cuda)
        stream = _stream(Q, 300, 200, 96, 24, cuda)
        launches = kernels.LAUNCHES["ragged_dp"]
        got = kernels.ragged_score(profile, stream, mode, x, go, ge)
        assert kernels.LAUNCHES["ragged_dp"] > launches
        want = kernels.ragged_score_plain(profile, stream, mode, x, go, ge)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_kernel_matches_plain_large_alphabet(cuda, mode):
    """A 100-letter alphabet: a 100-column profile in shared memory."""
    rng = np.random.default_rng(mode)
    matrix = rng.integers(-6, 9, size=(100, 100))
    profile = torch.from_numpy(kernels.build_profile(
        matrix[rng.integers(0, 100, size=45)].T)).to(cuda)
    stream = _stream(mode, 200, 300, 128, 100, cuda)
    got = kernels.ragged_score(profile, stream, mode, 1, 3, 1)
    want = kernels.ragged_score_plain(profile, stream, mode, 1, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_waves_match_one_launch(cuda, monkeypatch):
    matrix = ScoreMatrix.blosum50().matrix
    profile = torch.from_numpy(kernels.build_profile(
        matrix[np.arange(40) % 24].T)).to(cuda)
    stream = _stream(5, 1000, 700, 64, 24, cuda)
    whole = kernels.ragged_score(profile, stream, MODE_OV, 1, 3, 1)
    monkeypatch.setattr(kernels, "WAVE_CELLS",
                        int(stream.host_offsets[-1]) // 5)
    before = kernels.LAUNCHES["ragged_dp"]
    waves = kernels.ragged_score(profile, stream, MODE_OV, 1, 3, 1)
    assert kernels.LAUNCHES["ragged_dp"] - before >= 5
    torch.testing.assert_close(waves, whole, rtol=0, atol=0)


def test_search_on_card_matches_cpu(cuda):
    sm = ScoreMatrix.blosum50()
    rng = np.random.default_rng(11)
    query = rng.integers(0, 24, size=110).astype(np.uint8)
    db = [rng.integers(0, 24, size=int(L)).astype(np.uint8)
          for L in rng.integers(1, 900, size=700)]
    for x in (0, 1):
        on_card = search_database_arrays(query, db, 3, 1, sm.matrix,
                                         mode=MODE_SW, search_type=x,
                                         engine=Engine(block_size=128))
        on_cpu = search_database_arrays(query, db, 3, 1, sm.matrix,
                                        mode=MODE_SW, search_type=x,
                                        engine=Engine(device="cpu",
                                                      block_size=128))
        for k in on_cpu:
            np.testing.assert_array_equal(on_card[k], on_cpu[k])


def test_kernel_rejects_a_stream_on_another_device(cuda):
    stream = _stream(1, 10, 20, 8, 24, cuda)
    profile = torch.zeros((5, 32), dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError):
        kernels.ragged_score(profile, stream, MODE_SW, 0, 3, 1)
    with pytest.raises(ValueError):
        kernels.ragged_score(profile.to(cuda), dataclasses.replace(
            stream, lengths=stream.lengths.to(torch.int64)), MODE_SW, 0, 3, 1)


def _multi_profile(matrix, seg_qs, rng, device):
    prof, qs = kernels.prepare_profile_multi(
        [matrix[rng.integers(0, matrix.shape[0], size=q)].T for q in seg_qs])
    return torch.from_numpy(prof).to(device), qs


@pytest.mark.parametrize("segs", [[1, 37], [16, 17, 110],
                                  [3, 60, 16, 90, 33, 2, 20, 47]])
@pytest.mark.parametrize("go,ge", [(3, 1), (2, 2), (1, 3)])
@pytest.mark.parametrize("x", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_multi_kernel_matches_plain(cuda, mode, x, go, ge, segs):
    matrix = ScoreMatrix.blosum50().matrix
    rng = np.random.default_rng(mode + 10 * x)
    profile, seg_qs = _multi_profile(matrix, segs, rng, cuda)
    stream = _stream(len(segs), 300, 200, 96, 24, cuda)
    launches = kernels.LAUNCHES["multi_dp"]
    got = kernels.multi_score(profile, seg_qs, stream, mode, x, go, ge)
    assert kernels.LAUNCHES["multi_dp"] > launches
    want = kernels.multi_score_plain(profile, seg_qs, stream, mode, x, go,
                                     ge)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_multi_waves_match_one_launch(cuda, monkeypatch):
    matrix = ScoreMatrix.blosum50().matrix
    profile, seg_qs = _multi_profile(matrix, [40, 7, 130],
                                     np.random.default_rng(3), cuda)
    stream = _stream(6, 1000, 700, 64, 24, cuda)
    whole = kernels.multi_score(profile, seg_qs, stream, MODE_OV, 1, 3, 1)
    monkeypatch.setattr(kernels, "WAVE_CELLS",
                        int(stream.host_offsets[-1]) // 5)
    before = kernels.LAUNCHES["multi_dp"]
    waves = kernels.multi_score(profile, seg_qs, stream, MODE_OV, 1, 3, 1)
    assert kernels.LAUNCHES["multi_dp"] - before >= 5
    torch.testing.assert_close(waves, whole, rtol=0, atol=0)


@pytest.mark.parametrize("top_k", [0, 7])
def test_multi_search_on_card_matches_cpu(cuda, top_k):
    sm = ScoreMatrix.blosum50()
    rng = np.random.default_rng(12)
    queries = [rng.integers(0, 24, size=int(n)).astype(np.uint8)
               for n in (30, 110, 17, 64, 5, 250, 16, 41, 90, 12)]
    db = [rng.integers(0, 24, size=int(L)).astype(np.uint8)
          for L in rng.integers(1, 600, size=500)]
    for x in (0, 1):
        on_card = search_database_multi_arrays(
            queries, db, 3, 1, sm.matrix, search_type=x, top_k=top_k,
            engine=Engine(block_size=128))
        on_cpu = search_database_multi_arrays(
            queries, db, 3, 1, sm.matrix, search_type=x, top_k=top_k,
            engine=Engine(device="cpu", block_size=128))
        for a, b in zip(on_card, on_cpu):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
