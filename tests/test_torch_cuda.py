"""ragged_dp (with and without its overflow-flag rows, in query panels and
through the grouped entry point) and multi_dp on the card: the CUDA kernels
against their plain versions, and the serving path, the adaptive search,
long queries and the CLI on the card against the CPU.

These tests need an NVIDIA GPU with nvcc and skip without one. They import
neither JAX nor opal_tpu, so they also run where only PyTorch is installed:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from opal_tpu_torch import cli
from opal_tpu_torch.constants import MODE_NW, MODE_OV, MODE_SW
from opal_tpu_torch.engine import batching, kernels
from opal_tpu_torch.engine.search import (
    Engine,
    search_database,
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
    # one lane per thread: three passes through scratch, in waves
    monkeypatch.setattr(kernels, "MAX_GROUP", 1)
    monkeypatch.setattr(kernels, "SCRATCH_CELLS",
                        int(stream.host_offsets[-1]) // 5)
    before = kernels.LAUNCHES["ragged_dp"]
    waves = kernels.ragged_score(profile, stream, MODE_OV, 1, 3, 1)
    assert kernels.LAUNCHES["ragged_dp"] - before >= 5
    torch.testing.assert_close(waves, whole, rtol=0, atol=0)


def _mixed_stream(seed, n_blocks, B, max_len, A, device):
    """Blocks whose lanes have unsorted lengths 0..max_len, a fifth of them
    empty, so one warp holds lanes of every length."""
    rng = np.random.default_rng(seed)
    letters, lengths = [], []
    for _ in range(n_blocks):
        lens = rng.integers(0, max_len + 1, size=B)
        lens[rng.random(B) < 0.2] = 0
        letters.append(rng.integers(0, A, size=(max(1, int(lens.max())),
                                                B)).astype(np.int8))
        lengths.append(lens.astype(np.int32))
    return kernels.pack_stream(letters, lengths, B, device)


@pytest.mark.parametrize("max_group", [1, 2, 4, 8])
@pytest.mark.parametrize("Q", [1, 15, 16, 17, 127, 128, 129, 1000])
def test_strip_groups_match_plain(cuda, monkeypatch, Q, max_group):
    """Every G (MAX_GROUP caps the plan's choice), queries at and across
    the strip and group boundaries (passes past the first through
    scratch), lanes of mixed lengths and empty lanes in one warp, 4 modes
    at x1 (and SW with flags)."""
    monkeypatch.setattr(kernels, "MAX_GROUP", max_group)
    rng = np.random.default_rng(Q + max_group)
    matrix = ScoreMatrix.blosum50().matrix
    stream = _mixed_stream(Q, 3, 72, 90 if Q == 1000 else 300, 24, cuda)
    profile = torch.from_numpy(kernels.build_profile(
        matrix[rng.integers(0, 24, size=Q)].T)).to(cuda)
    for mode, flags in ((0, False), (1, False), (2, False), (3, False),
                        (3, True)):
        got = kernels.ragged_score(profile, stream, mode, 1, 3, 1, flags)
        want = kernels.ragged_score_plain(profile, stream, mode, 1, 3, 1,
                                          flags)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mixed_groups_in_one_launch_match_plain(cuda, monkeypatch):
    """A tall query over blocks of very different lengths with a small
    resident-thread estimate: the plan gives short blocks G = 1 and long
    ones larger G in the same launch."""
    monkeypatch.setattr(kernels, "RESIDENT_THREADS_PER_SM", 8)
    matrix = ScoreMatrix.blosum50().matrix
    stream = _stream(9, 900, 1200, 64, 24, cuda)
    Q = 300
    profile = torch.from_numpy(kernels.build_profile(
        matrix[np.random.default_rng(9).integers(0, 24, size=Q)].T)).to(cuda)
    threads = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    plan = kernels.plan_launch(stream.host_offsets, 64, -(-Q // 16), False,
                               threads)
    assert set(plan.groups.tolist()) == {1, 2, 4, 8}
    for mode in range(4):
        got = kernels.ragged_score(profile, stream, mode, 1, 3, 1)
        want = kernels.ragged_score_plain(profile, stream, mode, 1, 3, 1)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_large_scores_on_card_match_cpu(cuda):
    """Scores past 2^29 inside the derived int32 bound (backend.py): the
    card equals the CPU, which equals opal_tpu (test_torch_search.py)."""
    rng = np.random.default_rng(1)
    query = rng.integers(0, 4, 600).astype(np.uint8)
    db = [query, rng.integers(0, 4, 300).astype(np.uint8)]
    for diag, off in ((2**20, -1), (2**21, -699051)):
        matrix = np.full((4, 4), off, np.int32)
        np.fill_diagonal(matrix, diag)
        for mode in range(4):
            got = search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                         search_type=1,
                                         engine=Engine(block_size=16))
            want = search_database_arrays(query, db, 3, 1, matrix,
                                          mode=mode, search_type=1,
                                          engine=Engine(device="cpu",
                                                        block_size=16))
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            assert int(got["score"][0]) == 600 * diag


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


@pytest.mark.parametrize("segs", [
    [1, 37], [16, 17, 110], [3, 60, 16, 90, 33, 2, 20, 47],
    [1, 33, 31, 2, 64],  # strips of 32 rows that are mostly padding
    [300, 290, 310, 305, 295, 280, 320, 301],  # several passes, scratch
])
@pytest.mark.parametrize("go,ge", [(3, 1), (2, 2), (1, 3)])
@pytest.mark.parametrize("x", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_multi_kernel_matches_plain(cuda, mode, x, go, ge, segs):
    matrix = ScoreMatrix.blosum50().matrix
    rng = np.random.default_rng(mode + 10 * x)
    profile, seg_qs = _multi_profile(matrix, segs, rng, cuda)
    # the plain version's row loop (ge > go) costs rows x columns: the tall
    # stack runs on shorter targets
    stream = _stream(len(segs), 300, 200 if sum(segs) < 1000 else 64, 96,
                     24, cuda)
    launches = kernels.LAUNCHES["multi_dp"]
    got = kernels.multi_score(profile, seg_qs, stream, mode, x, go, ge)
    assert kernels.LAUNCHES["multi_dp"] > launches
    want = kernels.multi_score_plain(profile, seg_qs, stream, mode, x, go,
                                     ge)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_multi_waves_match_one_launch(cuda, monkeypatch):
    matrix = ScoreMatrix.blosum50().matrix
    # 13 strips: more than a pass of 8, so every block hands rows on
    # through scratch and the scratch budget cuts the launch into waves
    profile, seg_qs = _multi_profile(matrix, [40, 7, 290],
                                     np.random.default_rng(3), cuda)
    stream = _stream(6, 1000, 700, 64, 24, cuda)
    whole = kernels.multi_score(profile, seg_qs, stream, MODE_OV, 1, 3, 1)
    monkeypatch.setattr(kernels, "SCRATCH_CELLS",
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


@pytest.mark.parametrize("go,ge", [(3, 1), (2, 2), (0, 0), (1, 3)])
@pytest.mark.parametrize("x", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_flag_kernel_matches_plain(cuda, mode, x, go, ge):
    """ragged_dp with its flag rows: queries of 1, 16, 17 and 110 rows
    (partial last strips), partial first blocks, and the matrix scaled by
    1, 40 and 400 so that the flags reach 16 and 32 bits."""
    matrix = ScoreMatrix.blosum50().matrix
    rng = np.random.default_rng(100 + 10 * mode + x)
    for Q, scale in ((1, 1), (16, 40), (17, 400), (110, 40)):
        profile = torch.from_numpy(kernels.build_profile(
            scale * matrix[rng.integers(0, 24, size=Q)].T)).to(cuda)
        stream = _stream(Q + go, 300, 250, 96, 24, cuda)
        launches = kernels.LAUNCHES["ragged_dp_flags"]
        got = kernels.ragged_score(profile, stream, mode, x, go, ge, True)
        assert kernels.LAUNCHES["ragged_dp_flags"] > launches
        want = kernels.ragged_score_plain(profile, stream, mode, x, go, ge,
                                          True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_adaptive_search_on_card_matches_cpu(cuda):
    sm = ScoreMatrix.blosum50()
    rng = np.random.default_rng(13)
    query = rng.integers(0, 24, size=110).astype(np.uint8)
    db = [rng.integers(0, 24, size=int(L)).astype(np.uint8)
          for L in rng.integers(1, 900, size=1500)]
    for mode, x in ((MODE_SW, 0), (MODE_NW, 1)):
        engines = [Engine(block_size=128, precision="adaptive"),
                   Engine(device="cpu", block_size=128, precision="adaptive")]
        launches = kernels.LAUNCHES["ragged_dp_flags"]
        card, cpu = (search_database(query, db, 3, 1, sm.matrix * 20,
                                     mode=mode, search_type=x, engine=e)
                     for e in engines)
        assert kernels.LAUNCHES["ragged_dp_flags"] > launches
        assert [(r.score, r.end_location_query, r.end_location_target)
                for r in card] == [(r.score, r.end_location_query,
                                    r.end_location_target) for r in cpu]
        a, b = (e.last_search_stats for e in engines)
        assert a["precision_bits"] == b["precision_bits"]
        assert a["precision_counts"] == b["precision_counts"]
        for k in ("rerun_mask_stage8", "rerun_mask_stage16"):
            np.testing.assert_array_equal(a[k], b[k])


def test_cli_x2_on_card_matches_cpu(cuda, capsys):
    here = os.path.dirname(os.path.abspath(__file__))
    args = ["-x", "2", "-a", "OV", "--block-size", "16",
            os.path.join(here, "port_data", "O74807.fasta"),
            os.path.join(here, "port_data", "uniprot_sprot15.fasta")]
    outs = []
    for dev in ("cuda", "cpu"):
        assert cli.main(["--device", dev] + args) == 0
        out = capsys.readouterr().out
        outs.append(out[: out.index("\nCpu time")])
    assert outs[0] == outs[1]
    assert len(re.findall(r"^#\d+: ", outs[0], re.M)) == 15


def _panel_chain_plain(profile, stream, mode, x, go, ge, with_flags, panels):
    outs, top = [], None
    for row0, rows in panels:
        tr, top = kernels.ragged_panel_plain(profile, stream, mode, x, go, ge,
                                             with_flags, row0, rows, top)
        outs.append(tr)
    return outs


@pytest.mark.parametrize("go,ge", [(3, 1), (2, 2), (0, 0), (1, 3)])
@pytest.mark.parametrize("x", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_panel_kernel_matches_plain(cuda, monkeypatch, mode, x, go, ge):
    """The panel role of ragged_dp, panel by panel, against the plain
    chain: queries of 17, 33 and 80 rows in 16- and 32-row panels (tails
    of 1 and 16 rows), with and without flags, a partial first block."""
    matrix = ScoreMatrix.blosum50().matrix
    rng = np.random.default_rng(200 + 10 * mode + x)
    stream = _stream(go + 7, 300, 150 if ge > go else 250, 96, 24, cuda)
    for Q, rows in ((17, 16), (33, 16), (33, 32), (80, 32)):
        monkeypatch.setattr(kernels, "PANEL_ROWS", rows)
        panels = kernels.plan_panels(Q)
        profile = torch.from_numpy(kernels.build_profile(
            matrix[rng.integers(0, 24, size=Q)].T)).to(cuda)
        for flags in (False, True):
            launches = kernels.LAUNCHES["ragged_dp_panel"]
            got = kernels.ragged_panel_score(profile, stream, mode, x, go,
                                             ge, flags)
            assert kernels.LAUNCHES["ragged_dp_panel"] - launches == len(
                panels)
            want = _panel_chain_plain(profile, stream, mode, x, go, ge,
                                      flags, panels)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_panel_waves_match_one_launch(cuda, monkeypatch):
    """Panels inside several waves equal the one-sweep columns."""
    matrix = ScoreMatrix.blosum50().matrix
    profile = torch.from_numpy(kernels.build_profile(
        matrix[np.arange(100) % 24].T)).to(cuda)
    stream = _stream(5, 1000, 700, 64, 24, cuda)
    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    monkeypatch.setattr(kernels, "SCRATCH_CELLS",
                        int(stream.host_offsets[-1]) // 5)
    for mode in range(4):
        whole = kernels.finalize_device(
            kernels.ragged_score(profile, stream, mode, 1, 3, 1),
            stream.lengths, mode, 1, 100)
        before = kernels.LAUNCHES["ragged_dp_panel"]
        events = []
        trs = kernels.ragged_panel_score(profile, stream, mode, 1, 3, 1,
                                         events=events)
        assert kernels.LAUNCHES["ragged_dp_panel"] - before >= 5 * 4
        assert len(events) == kernels.LAUNCHES["ragged_dp_panel"] - before
        got = kernels.finalize_panels_device(trs, kernels.plan_panels(100),
                                             stream.lengths, mode, 1)
        for k in whole:
            torch.testing.assert_close(got[k], whole[k], rtol=0, atol=0)


def test_long_query_search_on_card_matches_cpu(cuda, monkeypatch):
    """search_database_arrays with a 300-residue query in 64-row panels:
    the card against the CPU and against the one sweep, x0 and x1, top_k
    too."""
    sm = ScoreMatrix.blosum50()
    rng = np.random.default_rng(14)
    query = rng.integers(0, 24, size=300).astype(np.uint8)
    db = [rng.integers(0, 24, size=int(L)).astype(np.uint8)
          for L in rng.integers(1, 500, size=700)]
    for x in (0, 1):
        for k in (0, 9):
            monkeypatch.setattr(kernels, "PANEL_ROWS", 4096)
            sweep = search_database_arrays(query, db, 3, 1, sm.matrix,
                                           search_type=x, top_k=k,
                                           engine=Engine(block_size=128))
            monkeypatch.setattr(kernels, "PANEL_ROWS", 64)
            launches = kernels.LAUNCHES["ragged_dp_panel"]
            panels = search_database_arrays(query, db, 3, 1, sm.matrix,
                                            search_type=x, top_k=k,
                                            engine=Engine(block_size=128))
            assert kernels.LAUNCHES["ragged_dp_panel"] > launches
            cpu = search_database_arrays(query, db, 3, 1, sm.matrix,
                                         search_type=x, top_k=k,
                                         engine=Engine(device="cpu",
                                                       block_size=128))
            for c in cpu:
                np.testing.assert_array_equal(panels[c], sweep[c])
                np.testing.assert_array_equal(panels[c], cpu[c])


@pytest.mark.parametrize("with_flags", [False, True])
@pytest.mark.parametrize("x", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_grouped_kernel_matches_plain(cuda, mode, x, with_flags):
    """grouped_score (ragged_dp over dense [G, T, B] blocks laid out on the
    card) against grouped_score_plain; T is no multiple of 4."""
    matrix = ScoreMatrix.blosum50().matrix
    rng = np.random.default_rng(300 + mode)
    G, T, Bw = 3, 201, 96
    lengths = rng.integers(0, T + 1, size=(G, Bw)).astype(np.int32)
    letters = rng.integers(0, 24, size=(G, T, Bw)).astype(np.int8)
    profile = torch.from_numpy(kernels.build_profile(
        matrix[rng.integers(0, 24, size=45)].T)).to(cuda)
    args = (profile, torch.from_numpy(letters).to(cuda),
            torch.from_numpy(lengths).to(cuda), mode, x, 3, 1, with_flags)
    launches = kernels.LAUNCHES["ragged_dp_grouped"]
    got = kernels.grouped_score(*args)
    assert kernels.LAUNCHES["ragged_dp_grouped"] > launches
    torch.testing.assert_close(got, kernels.grouped_score_plain(*args),
                               rtol=0, atol=0)


# the measurement tools' probes (opal_tpu_torch.tools, csrc/*.cu)

@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("variant", ["f32", "i32", "dpx", "max3"])
def test_peak_probe_matches_plain(cuda, variant, unroll):
    from opal_tpu_torch.tools import LAUNCHES, roofline

    for seed in (0, 1):
        st = roofline.peak_state(variant, 1000, cuda, seed=seed)
        launches = LAUNCHES["roofline_peak"]
        got = roofline.peak(st, 5, unroll, variant)
        assert LAUNCHES["roofline_peak"] > launches
        torch.testing.assert_close(
            got, roofline.peak_plain(st, 5, unroll, variant), rtol=0, atol=0)


@pytest.mark.parametrize("qp", [16, 32, 48, 64, 80, 96, 112, 128])
def test_scan_probe_matches_plain(cuda, qp):
    from opal_tpu_torch.tools import LAUNCHES, roofline

    H = torch.from_numpy(np.random.default_rng(qp).integers(
        -300, 300, (qp, 300)).astype(np.int32)).to(cuda)
    launches = LAUNCHES["roofline_scan"]
    got = roofline.scan(H, 7, 3)
    assert LAUNCHES["roofline_scan"] > launches
    torch.testing.assert_close(got, roofline.scan_plain(H, 7, 3), rtol=0,
                               atol=0)


@pytest.mark.parametrize("G", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["base", "fold2", "dpx", "dpx_fold2",
                                     "r8", "r32", "hooks"])
def test_unroll_probe_matches_plain(cuda, variant, G):
    """Every column-body variant at the plan's G and at every G against the
    plain version and ragged_dp, on lanes of ragged (odd and even, 0 too)
    lengths in one block; Q 1, 8, 40 and 72 leave 24 or more padding rows
    in a 32-row strip (where nvcc 12.8 miscompiled r32 unpinned), Q 104
    and 200 run several passes at small G."""
    from opal_tpu_torch.tools import LAUNCHES, exp_unroll

    matrix = ScoreMatrix.blosum50().matrix
    rng = np.random.default_rng(40)
    B = 300
    lengths = rng.integers(0, 131, size=B).astype(np.int32)
    lengths[:2] = 0
    letters = rng.integers(0, 24, size=(132, B)).astype(np.int8)
    stream = kernels.pack_stream([letters], [lengths], B, cuda)
    for Q in (1, 8, 17, 40, 72, 104, 200):
        profile = torch.from_numpy(kernels.build_profile(
            matrix[rng.integers(0, 24, size=Q)].T)).to(cuda)
        # base is ragged_dp's own launch, the others the probe's
        count = (kernels.LAUNCHES, "ragged_dp") if variant == "base" else \
            (LAUNCHES, "exp_unroll")
        launches = count[0][count[1]]
        got = exp_unroll.unroll_score(profile, stream, variant, G=G)
        assert count[0][count[1]] > launches
        want = exp_unroll.unroll_plain(profile, stream)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(exp_unroll.single(profile, stream), want,
                                   rtol=0, atol=0)
    a = exp_unroll.attrs(variant, G or 8)
    assert a["blocks_per_sm"] > 0 and a["registers"] > 0


@pytest.mark.parametrize("G", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("noprof", [False, True])
@pytest.mark.parametrize("S", [1, 2, 4, "strips2"])
def test_sstack_probe_matches_plain(cuda, S, noprof, G):
    """lanes<S> and strips2, with and without the profile lookup, at the
    plan's G and at every G against the plain version: one pass, several
    passes through scratch, the main path's 7 strips."""
    from opal_tpu_torch.tools import LAUNCHES, exp_sstack_ablate as ss

    kind = dict(S=1, strips2=True) if S == "strips2" else dict(S=S)
    for qpad in (16, 37, 110, 200):
        profile, stream, meta, nb = ss.random_inputs(qpad, 200, 5, 4, 2, 1,
                                                     qpad, cuda)
        launches = LAUNCHES["exp_sstack"]
        got = ss.sstack_score(profile, stream, meta, nb, noprof=noprof, G=G,
                              **kind)
        assert LAUNCHES["exp_sstack"] > launches
        torch.testing.assert_close(
            got, ss.sstack_plain(profile, stream, meta, nb, noprof), rtol=0,
            atol=0)
    a = ss.attrs(noprof=noprof, G=G or 8, **kind)
    assert a["blocks_per_sm"] > 0 and a["registers"] > 0


# the device alignment fill (engine/device_fill.py, csrc/device_fill.cu)

def _fill_problem(cuda, mode, go, ge):
    """tests/test_device_fill.py's problem (seed 23: a 90-letter query, 120
    targets with planted prefix ties and a 1-letter target), its winners
    from an x1 search on the card, and their jobs."""
    from opal_tpu_torch.constants import SEARCH_SCORE_END
    from opal_tpu_torch.engine import device_fill

    matrix = ScoreMatrix.blosum50().matrix
    A = matrix.shape[0]
    rng = np.random.default_rng(23)
    q = rng.integers(0, A - 4, size=90, dtype=np.uint8)
    db = [rng.integers(0, A - 4, size=int(rng.integers(4, 260)),
                       dtype=np.uint8) for _ in range(120)]
    for i in range(0, 120, 9):
        db[i] = q[: int(rng.integers(3, 90))].copy()
    db[5] = q[:1].copy()
    out = search_database_arrays(q, db, go, ge, matrix, mode=mode,
                                 search_type=SEARCH_SCORE_END,
                                 engine=Engine(device="cuda",
                                               block_size=128))
    winners = [(i, int(out["score"][i]), int(out["end_q"][i]),
                int(out["end_t"][i])) for i in range(len(db))
               if not (mode == MODE_SW and out["score"][i] == 0)]
    host = dict.fromkeys(("no_end", "no_band", "value_bound", "budget"), 0)
    jobs = device_fill.make_jobs(q, db, go, ge, matrix, mode, winners, host)
    return matrix, q, db, winners, jobs


@pytest.mark.parametrize("go,ge", [(3, 1), (5, 5), (10, 2)])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_fill_kernel_matches_plain(cuda, mode, go, ge):
    """All five outputs, exact, on one group of every winner and on a
    1-lane group; the last lane's limit is raised by one (ok is False)."""
    from opal_tpu_torch.engine import device_fill

    matrix, _, _, _, jobs = _fill_problem(cuda, mode, go, ge)
    jobs[-1] = jobs[-1][:1] + (jobs[-1][1] + 1,) + jobs[-1][2:]
    mat = torch.from_numpy(matrix.astype(np.int32)).to(cuda)
    for group in (jobs, jobs[:1]):
        args = device_fill.pack_group(group, cuda)
        launches = kernels.LAUNCHES["device_fill"]
        got = device_fill.fill_walk(*args, go, ge, mat, mode)
        assert kernels.LAUNCHES["device_fill"] == launches + 1
        want = device_fill.fill_walk_plain(*args, go, ge, mat, mode)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert len(group) == 1 or not bool(got[3][-1])


@pytest.fixture(scope="module")
def fill_edges():
    """opal_tpu_torch.tools.fill_shapes' groups by name."""
    from opal_tpu_torch.tools import fill_shapes

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    matrix = ScoreMatrix.blosum50().matrix
    return {g[0]: g for g in fill_shapes.edge_groups(matrix, device="cuda")}


@pytest.mark.parametrize("rows", [None, 16])
@pytest.mark.parametrize("name", ["short_sw", "tall_sw", "mixed_nw",
                                  "mixed_hw", "mixed_ov", "mixed_sw"])
def test_fill_kernel_at_edges(cuda, fill_edges, monkeypatch, name, rows):
    """The kernel against its plain version on opal_tpu_torch.tools.
    fill_shapes' groups (tlen 1/31/33, qlen one past a pass, bands 1-3 rows
    wide, stops near and far from tlen), at plan_fill's strip height and at
    16 rows (a lane of 1,025 rows then takes three passes)."""
    from opal_tpu_torch.engine import device_fill

    matrix = ScoreMatrix.blosum50().matrix
    _, mode, go, ge, jobs = fill_edges[name]
    monkeypatch.setattr(device_fill, "FILL_ROWS", rows)
    mat = torch.from_numpy(matrix.astype(np.int32)).to(cuda)
    args = device_fill.pack_group(jobs, cuda)
    launches = kernels.LAUNCHES["device_fill"]
    got = device_fill.fill_walk(*args, go, ge, mat, mode)
    assert kernels.LAUNCHES["device_fill"] == launches + 1
    want = device_fill.fill_walk_plain(*args, go, ge, mat, mode)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_fill_budget_split_on_card(cuda, monkeypatch):
    """Groups cut by a small byte budget give the paths of one group."""
    from opal_tpu_torch.engine import device_fill

    matrix, q, db, winners, _ = _fill_problem(cuda, MODE_OV, 3, 1)
    whole = device_fill.align_winners_device(q, db, 3, 1, matrix, MODE_OV,
                                             winners)
    assert device_fill.LAST_STATS["groups"] == 1
    monkeypatch.setattr(device_fill, "FILL_BUDGET_BYTES", 4 * 128 * 320)
    launches = kernels.LAUNCHES["device_fill"]
    split = device_fill.align_winners_device(q, db, 3, 1, matrix, MODE_OV,
                                             winners)
    groups = device_fill.LAST_STATS["groups"]
    assert groups > 4 and kernels.LAUNCHES["device_fill"] == launches + groups
    assert set(split) == set(whole) and len(whole) >= 0.9 * len(winners)
    for i in whole:
        assert split[i][:2] == whole[i][:2]
        np.testing.assert_array_equal(split[i][2], whole[i][2])


def test_fill_build_failure_raises(cuda, monkeypatch):
    from opal_tpu_torch.engine import _build, device_fill

    monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ["--no-such-flag"])
    monkeypatch.setattr(_build, "_loaded", {})
    z = torch.ones(1, dtype=torch.int32, device=cuda)
    aq = torch.zeros((64, 1), dtype=torch.int32, device=cuda)
    mat = torch.zeros((4, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        device_fill.fill_walk(aq, aq, z, z, z, z, z, 3, 1, mat, MODE_SW)


def _mesh_problem(seed, n=700, max_len=300):
    rng = np.random.default_rng(seed)
    matrix = ScoreMatrix.blosum50().matrix
    db = [rng.integers(0, 24, size=int(L)).astype(np.uint8)
          for L in rng.integers(1, max_len, size=n)]
    return rng, matrix, db


@pytest.mark.parametrize("x", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_mesh_search_on_card_matches_unsharded(cuda, mode, x):
    """A 2-part mesh on the one card (each part its own ragged_dp launch)
    against the unsharded engine, every column."""
    from opal_tpu_torch.parallel.shard import db_mesh

    rng, matrix, db = _mesh_problem(10 + mode)
    query = rng.integers(0, 24, size=90).astype(np.uint8)
    eng = Engine(device="cuda", block_size=128,
                 mesh=db_mesh(["cuda", "cuda"]))
    ddb = eng.upload(db)
    assert [bool(p.blocks) for p in ddb.parts] == [True, True]
    before = kernels.LAUNCHES["ragged_dp"]
    got = search_database_arrays(query, ddb, 3, 1, matrix, mode=mode,
                                 search_type=x, engine=eng)
    assert kernels.LAUNCHES["ragged_dp"] - before >= 2
    want = search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                  search_type=x,
                                  engine=Engine(device="cuda",
                                                block_size=128))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("x", [0, 1])
def test_mesh_panels_multi_topk_on_card(cuda, monkeypatch, x):
    """On a 2-part mesh on the card: a query in 32-row panels, a stacked
    group of 3 (multi_dp per part) and the top 10 selected per part, all
    equal to the unsharded engine."""
    from opal_tpu_torch.parallel.shard import db_mesh

    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    rng, matrix, db = _mesh_problem(20 + x)
    eng = Engine(device="cuda", block_size=128,
                 mesh=db_mesh(["cuda", "cuda"]))
    ref = Engine(device="cuda", block_size=128)
    ddb = eng.upload(db)
    tall = rng.integers(0, 24, size=100).astype(np.uint8)
    short = [rng.integers(0, 24, size=q).astype(np.uint8)
             for q in (20, 31, 12)]
    before = dict(kernels.LAUNCHES)
    runs = []
    for e, d in ((eng, ddb), (ref, db)):
        runs.append((
            search_database_arrays(tall, d, 3, 1, matrix, mode=MODE_SW,
                                   search_type=x, engine=e),
            search_database_multi_arrays(short, d, 3, 1, matrix,
                                         mode=MODE_OV, search_type=x,
                                         engine=e),
            search_database_multi_arrays(short + [tall], d, 3, 1, matrix,
                                         mode=MODE_SW, search_type=x,
                                         engine=e, top_k=10)))
        if e is eng:
            assert kernels.LAUNCHES["ragged_dp_panel"] \
                - before["ragged_dp_panel"] >= 2 * 4
            assert kernels.LAUNCHES["multi_dp"] - before["multi_dp"] >= 4
    (p0, m0, t0), (p1, m1, t1) = runs
    for g, w in zip([p0] + m0 + t0, [p1] + m1 + t1):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_dryrun_on_card(cuda, capsys):
    """The dry run over a 2-device mesh on the card (the card named
    twice when it is the only one)."""
    from opal_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2)
    assert out["live_parts"] == 2
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "dryrun_multichip(2): OK")


# ------------------------------------------- panel knobs, serving tools

@pytest.mark.parametrize("x", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_panel_knobs_on_card_match_one_sweep(cuda, monkeypatch, mode, x):
    """OPAL_TPU_FORCE_PANELS at heights 16, 48 and the default against
    OPAL_TPU_NO_PANELS (one sweep) and the CPU, with the panel role
    launched where forced."""
    rng = np.random.default_rng(40 + mode)
    matrix = ScoreMatrix.blosum50().matrix
    query = rng.integers(0, 20, size=150).astype(np.uint8)
    db = [rng.integers(0, 20, size=int(n)).astype(np.uint8)
          for n in rng.integers(1, 400, size=300)]
    eng = Engine(device="cuda", block_size=128)
    ddb = eng.upload(db)

    def search():
        return search_database_arrays(query, ddb, 3, 1, matrix, mode=mode,
                                      search_type=x, engine=eng)

    monkeypatch.setenv("OPAL_TPU_NO_PANELS", "1")
    sweep = search()
    monkeypatch.delenv("OPAL_TPU_NO_PANELS")
    monkeypatch.setenv("OPAL_TPU_FORCE_PANELS", "1")
    for rows in ("16", "48", None):
        if rows is None:
            monkeypatch.delenv("OPAL_TPU_PANEL_ROWS", raising=False)
        else:
            monkeypatch.setenv("OPAL_TPU_PANEL_ROWS", rows)
        before = kernels.LAUNCHES["ragged_dp_panel"]
        got = search()
        assert kernels.LAUNCHES["ragged_dp_panel"] > before
        for k in sweep:
            np.testing.assert_array_equal(got[k], sweep[k], err_msg=k)
    cpu = search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                 search_type=x,
                                 engine=Engine(device="cpu", block_size=128))
    for k in sweep:
        np.testing.assert_array_equal(cpu[k], sweep[k], err_msg=k)


def test_serve_qps_batched_equals_serial_on_card(cuda):
    """The tool's own check (batched answers == serial ones, raising
    otherwise) on a small resident database, with multi_dp launched."""
    from opal_tpu_torch.serve import Server
    from opal_tpu_torch.tools import serve_qps

    sm = ScoreMatrix.blosum50()
    db, names = serve_qps.random_fasta_db(500, sm.letter_index(),
                                          sm.alphabet)
    srv = Server.from_sequences(db, names, sm, block_size=128,
                                device="cuda")
    before = kernels.LAUNCHES["multi_dp"]
    res = serve_qps.run(srv, clients=8, reqs=3, qlen=60, curve=[1, 4])
    assert res["identical"] and len(res["answers"]) == 24
    assert kernels.LAUNCHES["multi_dp"] > before
    for q, hits in list(res["answers"].items())[:4]:
        assert hits == srv.handle({"query": q, "top_k": 5})["hits"]


def test_keepalive_on_card(cuda):
    """The heartbeat touches the card beside requests, changes no answer,
    and stops when asked."""
    import threading
    import time

    from opal_tpu_torch.serve import Server

    sm = ScoreMatrix.blosum50()
    rng = np.random.default_rng(9)
    db = [rng.integers(0, 20, size=int(n)).astype(np.uint8)
          for n in rng.integers(10, 200, size=200)]
    srv = Server.from_sequences(db, [f"s{i}" for i in range(len(db))], sm,
                                block_size=128, device="cuda")
    q = "".join(sm.alphabet[j] for j in rng.integers(0, 20, size=30))
    before = srv.handle({"query": q, "top_k": 3})
    srv._cache.clear()
    old = {t for t in threading.enumerate() if t.name == "opal-keepalive"}
    stop = srv.start_keepalive(interval=0.02)
    mine = [t for t in threading.enumerate()
            if t.name == "opal-keepalive" and t not in old]
    try:
        time.sleep(0.3)
        assert mine and mine[0].is_alive()
        assert srv.handle({"query": q, "top_k": 3}) == before
    finally:
        stop()
    mine[0].join(5)
    assert not mine[0].is_alive()


def test_bench_on_card(cuda, monkeypatch, capsys):
    """python -m opal_tpu_torch.bench at 20,000 sequences: every search
    launched ragged_dp, the plain version never ran, the 48-sequence gate
    passed, and the last line is bench.py's four keys."""
    import json

    from opal_tpu_torch import bench

    monkeypatch.setenv("BENCH_SEQS", "20000")
    monkeypatch.delenv("BENCH_BLOCK", raising=False)
    assert bench.main([]) == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    by = {ln["bench"]: ln for ln in lines[:-1]}
    assert by["launches"]["ragged_dp_per_search"] >= 1
    assert by["launches"]["plain_calls"] == 0
    assert by["gate"]["sample"] == 48 and by["gate"]["mismatches"] == 0
    assert 0 <= by["idle"]["device_idle_share"] < 1
    assert list(lines[-1]) == ["metric", "value", "unit", "vs_baseline"]
    assert lines[-1]["value"] > 0


def test_entry_on_card_matches_cpu(cuda):
    from opal_tpu_torch.parallel.dryrun import entry

    before = kernels.LAUNCHES["ragged_dp_grouped"]
    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    got = fn(*args)
    assert kernels.LAUNCHES["ragged_dp_grouped"] > before
    fn_cpu, args_cpu = entry(device="cpu")
    want = fn_cpu(*args_cpu)
    for k in ("score", "end_q", "end_t"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=0)
