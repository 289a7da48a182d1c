"""The grouped entry point of the port (kernels.grouped_score, opal_tpu's
build_pallas_score_fn_raw) on the CPU against opal_tpu's.

One query against G dense [T, B] blocks: the port lays them out as a
ragged_dp stream on their device (kernels.grouped_stream) and scores them
there; opal_tpu runs its grouped Pallas kernel in interpret mode, built as
tests/test_pallas_interpret.py builds it. The tracker rows must be equal,
exactly, on every real lane, in 4 modes x x0/x1, with and without the
overflow-flag rows. On the card grouped_score launches ragged_dp and is
held against grouped_score_plain (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu.engine import pallas_kernels as pk
from opal_tpu_torch.constants import MODE_SW, SEARCH_SCORE, SEARCH_SCORE_END
from opal_tpu_torch.engine import batching, kernels

from util import random_problem

B = 128  # opal_tpu's lane width


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(db, G, T):
    """letters [G, T, B] int8 (PAD_LETTER padding) and lengths [G, B]
    int32: sequence i in block i % G, lane i // G."""
    letters = np.full((G, T, B), batching.PAD_LETTER, np.int8)
    lengths = np.zeros((G, B), np.int32)
    for i, s in enumerate(db):
        letters[i % G, : len(s), i // G] = s
        lengths[i % G, i // G] = len(s)
    return letters, lengths


@pytest.mark.parametrize("with_flags", [False, True])
@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_grouped_rows_match_jax(mode, x, with_flags):
    rng = np.random.default_rng(600 + 10 * mode + 2 * x + with_flags)
    query, db, matrix = random_problem(rng, n_seqs=15, query_len=25,
                                       min_len=5, max_len=64, match=5)
    G, T = 2, 64
    letters, lengths = _dense(db, G, T)
    fn = pk.build_pallas_score_fn(mode, x, len(query), 3, 1, B=B,
                                  with_flags=with_flags, interpret=True)
    qp = pk.prepare_qp(matrix[query.astype(np.int64)].T, 1)
    want = np.asarray(fn(jnp.asarray(qp, jnp.bfloat16),
                         jnp.asarray(letters),
                         jnp.asarray(lengths[:, None, :])))
    profile = torch.from_numpy(kernels.build_profile(
        matrix[query.astype(np.int64)].T))
    got = kernels.grouped_score(profile, torch.from_numpy(letters),
                                torch.from_numpy(lengths), mode, x, 3, 1,
                                with_flags)
    assert got.shape == want.shape == (
        G, len(kernels.tracker_rows(mode, x, with_flags)), B)
    assert kernels.tracker_rows(mode, x, with_flags) == pk.tracker_rows(
        mode, x, with_flags)
    real = lengths > 0
    for j in range(got.shape[1]):
        np.testing.assert_array_equal(got[:, j].numpy()[real],
                                      want[:, j][real], err_msg=f"row {j}")


@pytest.mark.parametrize("T", [61, 64, 130])
def test_grouped_stream_is_the_packed_layout(T):
    """grouped_stream equals pack_stream of the same blocks, T padded to
    whole 4-column words, and grouped_score equals grouped_score_plain
    and ragged_score_plain on that stream."""
    rng = np.random.default_rng(T)
    query, db, matrix = random_problem(rng, n_seqs=40, query_len=21,
                                       min_len=1, max_len=T)
    G = 3
    letters, lengths = _dense(db, G, T)
    stream = kernels.grouped_stream(torch.from_numpy(letters),
                                    torch.from_numpy(lengths))
    ref = kernels.pack_stream(list(letters), list(lengths), B, "cpu")
    torch.testing.assert_close(stream.letters, ref.letters, rtol=0, atol=0)
    torch.testing.assert_close(stream.offsets, ref.offsets, rtol=0, atol=0)
    torch.testing.assert_close(stream.lengths, ref.lengths, rtol=0, atol=0)
    np.testing.assert_array_equal(stream.host_offsets, ref.host_offsets)
    profile = torch.from_numpy(kernels.build_profile(
        matrix[query.astype(np.int64)].T))
    for mode in range(4):
        got = kernels.grouped_score(profile, torch.from_numpy(letters),
                                    torch.from_numpy(lengths), mode, 1, 3, 1)
        for want in (kernels.grouped_score_plain(
                profile, torch.from_numpy(letters),
                torch.from_numpy(lengths), mode, 1, 3, 1),
                kernels.ragged_score_plain(profile, ref, mode, 1, 3, 1)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_grouped_rejects_bad_inputs():
    profile = torch.zeros((5, 32), dtype=torch.int32)
    letters = torch.zeros((2, 8, 4), dtype=torch.int8)
    lengths = torch.full((2, 4), 3, dtype=torch.int32)
    kernels.grouped_score(profile, letters, lengths, MODE_SW, 0, 3, 1)
    for bad_letters, bad_lengths in (
            (letters.to(torch.int32), lengths),
            (letters, lengths.to(torch.int64)),
            (letters, lengths[:1]),
            (letters, torch.full((2, 4), 9, dtype=torch.int32)),
            (letters, torch.full((2, 4), -1, dtype=torch.int32))):
        with pytest.raises(ValueError):
            kernels.grouped_score(profile, bad_letters, bad_lengths,
                                  MODE_SW, 0, 3, 1)
