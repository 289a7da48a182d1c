"""Long queries of the port in query panels, on the CPU, against opal_tpu's
panel path.

A query taller than kernels.PANEL_ROWS is cut into panels that hand their
last row to the next (kernels.ragged_panel_score; the CUDA panel role of
ragged_dp on the card). Here PANEL_ROWS is monkeypatched to 32 (or 16), and
opal_tpu runs its own panel path as tests/test_panels.py runs it: the
Pallas interpret backend with OPAL_TPU_FORCE_PANELS=1 and
OPAL_TPU_PANEL_ROWS=32. Held equal, exactly (integer DP):

- each panel's tracker rows, and panel 0's boundary rows (opal_tpu's
  bh_out / bx_out of build_pallas_panel_fn_raw);
- the merged columns (kernels.finalize_panels_device) against opal_tpu's
  xla engine, ties across panels included;
- the entry points above it: top_k, search_database at x2, the adaptive
  cascade, a served batch and the CLI.

The kernel itself is held against ragged_panel_plain on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu import cli as jax_cli
from opal_tpu.engine import pallas_kernels as pk
from opal_tpu.engine.device_db import DeviceDatabase as JaxDeviceDatabase
from opal_tpu.engine.search import Engine as JaxEngine
from opal_tpu.engine.search import search_database as jax_search_database
from opal_tpu.engine.search import (
    search_database_arrays as jax_search_database_arrays,
)
from opal_tpu.serve import Server as JaxServer
from opal_tpu_torch import cli
from opal_tpu_torch.constants import (
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_ALIGNMENT,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from opal_tpu_torch.engine import backend, batching, kernels
from opal_tpu_torch.engine.search import (
    Engine,
    search_database,
    search_database_arrays,
)
from opal_tpu_torch.serve import Server

from util import random_problem

MODES = [MODE_SW, MODE_NW, MODE_HW, MODE_OV]
B = 128  # opal_tpu's interpret-mode lane width
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def panels32(monkeypatch):
    """32-row panels in the port and in opal_tpu (forced there)."""
    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    monkeypatch.setenv("OPAL_TPU_FORCE_PANELS", "1")
    monkeypatch.setenv("OPAL_TPU_PANEL_ROWS", "32")


def _stream(db, block_size=B):
    blocks = batching.plan_blocks(db, block_size)
    return blocks, kernels.pack_stream([b.letters for b in blocks],
                                       [b.lengths for b in blocks],
                                       block_size, "cpu")


def _profile(matrix, query):
    return torch.from_numpy(kernels.build_profile(
        np.asarray(matrix)[np.asarray(query, np.int64)].T))


def _jax_panel_rows(query, db, matrix, go, ge, mode, x, with_flags):
    """opal_tpu's per-panel tracker rows ([NB, n_rows, B] numpy, one per
    panel), its blocks and the panel offsets, through PallasBackend's
    dispatch_many and gather in interpret mode."""
    jeng = JaxEngine(backend="pallas-interpret", block_size=B)
    be = jeng._resolve_backend()
    qprep = be.prepare_query(
        np.ascontiguousarray(np.asarray(matrix)[np.asarray(query,
                                                           np.int64)].T),
        go, ge)
    ddb = jeng._get_resident(db)
    kind, payload = be.gather(be.dispatch_many(qprep, ddb, go, ge, mode, x,
                                               with_flags))
    assert kind == "panel"
    parts, offsets, qs = payload
    assert len(parts) == 1
    blocks, trs = parts[0]
    return blocks, [np.asarray(t)[: len(blocks)].astype(np.int64)
                    for t in trs], offsets, qs


def _check_panel_rows(query, db, matrix, go, ge, mode, x, with_flags):
    """Port panels against opal_tpu's, row by row on real lanes. Skipped:
    an interior NW/HW panel's filler row (the merge reads nothing there),
    and SW end rows where the panel's best is 0 (no end exists)."""
    jblocks, jtrs, offsets, qs = _jax_panel_rows(query, db, matrix, go, ge,
                                                 mode, x, with_flags)
    blocks, stream = _stream(db)
    assert [list(b.indices) for b in blocks] == [list(b.indices)
                                                 for b in jblocks]
    panels = kernels.plan_panels(len(query))
    assert tuple(r0 for r0, _ in panels) == tuple(offsets)
    assert tuple(n for _, n in panels) == tuple(qs)
    calls = kernels.PLAIN_CALLS["ragged_panel_plain"]
    trs = kernels.ragged_panel_score(_profile(matrix, query), stream, mode,
                                     x, go, ge, with_flags)
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] - calls == len(panels)
    compared = 0
    for p, (tr, jtr) in enumerate(zip(trs, jtrs)):
        final = p == len(panels) - 1
        rows = kernels.panel_tracker_rows(mode, x, with_flags, final)
        assert rows == pk.panel_tracker_rows(mode, x, with_flags, final)
        assert tr.shape == jtr.shape
        filler = (mode in (MODE_NW, MODE_HW) and not final
                  and not with_flags)
        for bi, blk in enumerate(blocks):
            got = tr[bi, :, : blk.n].numpy().astype(np.int64)
            want = jtr[bi, :, : blk.n]
            for j, r in enumerate(rows):
                if filler:
                    continue
                keep = np.ones(blk.n, bool)
                if mode == MODE_SW and r in (kernels.TR_BEST_R,
                                             kernels.TR_BEST_C):
                    keep = got[rows.index(kernels.TR_BEST)] > 0
                np.testing.assert_array_equal(
                    got[j][keep], want[j][keep],
                    err_msg=f"panel {p} row {r} block {bi}")
                compared += int(keep.sum())
    assert compared > 0


@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", MODES)
def test_panel_rows_match_jax(panels32, mode, x):
    """Q = 80 in 32/32/16-row panels, gaps 3/1."""
    rng = np.random.default_rng(300 + 10 * mode + x)
    query, db, matrix = random_problem(rng, n_seqs=11, query_len=80,
                                       min_len=8, max_len=60)
    _check_panel_rows(query, db, matrix, 3, 1, mode, x, False)


@pytest.mark.parametrize("mode", MODES)
def test_panel_flag_rows_match_jax(panels32, mode):
    """The overflow-flag rows of every panel, Q = 65 (32/32/1), x1."""
    rng = np.random.default_rng(320 + mode)
    query, db, matrix = random_problem(rng, n_seqs=9, query_len=65,
                                       min_len=8, max_len=60, match=6)
    _check_panel_rows(query, db, matrix, 3, 1, mode, SEARCH_SCORE_END, True)


@pytest.mark.parametrize("go,ge", [(2, 2), (4, 0), (0, 0)])
def test_panel_rows_match_jax_gaps(panels32, go, ge):
    """go == ge, ge == 0 and no gap cost, Q = 65 (32/32/1), 4 modes x1."""
    rng = np.random.default_rng(340 + 10 * go + ge)
    query, db, matrix = random_problem(rng, n_seqs=7, query_len=65,
                                       min_len=10, max_len=60)
    for mode in MODES:
        _check_panel_rows(query, db, matrix, go, ge, mode,
                          SEARCH_SCORE_END, False)


@pytest.mark.parametrize("mode", MODES)
def test_first_panel_boundary_matches_jax(mode):
    """Panel 0's bottom (H, F of its last row per column) against
    opal_tpu's bh_out / bx_out: bh[t] = H[t-1] (the mode's wall at t = 0)
    and bx[t] = max(H[t] - go, F[t] - ge), for t < len."""
    go, ge, P = 3, 1, 32
    rng = np.random.default_rng(360 + mode)
    query, db, matrix = random_problem(rng, n_seqs=10, query_len=70,
                                       min_len=5, max_len=100)
    blocks, stream = _stream(db)
    _, bottom = kernels.ragged_panel_plain(_profile(matrix, query), stream,
                                           mode, SEARCH_SCORE_END, go, ge,
                                           rows=P)
    H, F = (b.numpy().astype(np.int64) for b in bottom)

    jddb = JaxDeviceDatabase(db, B)
    (jblocks, meta, letters, lengths), = jddb.flat_parts(1)
    fn = pk.build_pallas_panel_fn_raw(mode, SEARCH_SCORE_END, P, go, ge, B=B,
                                      interpret=True, first=True,
                                      final=False)
    qp = pk.prepare_qp(np.asarray(matrix)[query[:P].astype(np.int64)].T, ge)
    _, bh, bx = fn(meta, jnp.asarray([0], jnp.int32),
                   jnp.asarray(qp, jnp.bfloat16), letters, lengths)
    meta, bh, bx = (np.asarray(a) for a in (meta, bh, bx))
    wall = -go - (P - 1) * ge if mode in (MODE_NW, MODE_HW) else 0
    n_cells = 0
    for c in np.nonzero(meta[4] == 1)[0]:
        b, t0 = int(meta[0, c]), int(meta[3, c])
        lens = blocks[b].lengths
        for tt in range(bh.shape[1]):
            t = t0 + tt
            lanes = np.nonzero(t < lens)[0]
            if not lanes.size:
                continue
            col = b * B + lanes
            want_bh = wall if t == 0 else H[t - 1, col]
            np.testing.assert_array_equal(bh[c, tt, lanes], want_bh)
            np.testing.assert_array_equal(
                bx[c, tt, lanes],
                np.maximum(H[t, col] - go, F[t, col] - ge))
            n_cells += lanes.size
    assert n_cells == sum(int(b.lengths.sum()) for b in blocks)


@pytest.mark.parametrize("go,ge", [(3, 1), (2, 2), (4, 0), (0, 0), (1, 3)])
@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", MODES)
def test_merged_columns_match_xla(monkeypatch, mode, x, go, ge):
    """Engine.score_blocks through panels (16 rows; Q = 65: five panels,
    the last of one row) against opal_tpu's xla engine, with the flag
    columns."""
    monkeypatch.setattr(kernels, "PANEL_ROWS", 16)
    rng = np.random.default_rng(400 + 20 * mode + 5 * x + go)
    small = ge > go  # the row loop of the F chain is slow
    query, db, matrix = random_problem(
        rng, n_seqs=9 if small else 30, query_len=65, min_len=1,
        max_len=25 if small else 70, match=5)
    calls = kernels.PLAIN_CALLS["ragged_panel_plain"]
    idx, cols = Engine(device="cpu", block_size=16).score_blocks(
        query, db, go, ge, matrix, mode, x, with_flags=True)
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] - calls == 5
    jidx, jcols = JaxEngine(backend="xla", block_size=16).score_blocks(
        query, db, go, ge, matrix, mode, x, with_flags=True)
    # opal_tpu's xla engine also returns the other modes' flag columns
    flag_cols = ({"max_ulhp"} if mode == MODE_SW
                 else {"min_e", "min_f", "max_h"})
    assert set(cols) == {"score", *flag_cols} | (
        {"end_q", "end_t"} if x else set())
    assert set(cols) <= set(jcols)
    o, jo = np.argsort(idx), np.argsort(jidx)
    np.testing.assert_array_equal(idx[o], jidx[jo])
    for k in cols:
        want = np.asarray(jcols[k])[jo]
        got = cols[k][o]
        if mode == MODE_SW and k in ("end_q", "end_t"):
            got, want = got[cols["score"][o] > 0], want[cols["score"][o] > 0]
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("with_flags", [False, True])
@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", MODES)
def test_single_panel_equals_one_sweep(mode, x, with_flags):
    """One panel (first == final): its rows merge into the columns of
    ragged_score_plain, and for SW, NW and HW they are the same rows."""
    rng = np.random.default_rng(500 + 10 * mode + 2 * x + with_flags)
    query, db, matrix = random_problem(rng, n_seqs=40, query_len=37,
                                       min_len=1, max_len=80)
    _, stream = _stream(db, 16)
    profile = _profile(matrix, query)
    tr, bottom = kernels.ragged_panel_plain(profile, stream, mode, x, 3, 1,
                                            with_flags)
    assert bottom is None
    one = kernels.ragged_score_plain(profile, stream, mode, x, 3, 1,
                                     with_flags)
    if mode != MODE_OV:
        torch.testing.assert_close(tr, one, rtol=0, atol=0)
    got = kernels.finalize_panels_device([tr], ((0, len(query)),),
                                         stream.lengths, mode, x, with_flags)
    want = kernels.finalize_device(one, stream.lengths, mode, x, len(query),
                                   with_flags)
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_tie_break_across_panels(panels32):
    """A repeated motif makes the best score attainable in several panels;
    the merge keeps the smallest end_t, then end_q (tests/test_panels.py's
    case)."""
    motif = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.uint8)
    query = np.tile(motif, 12)  # 96 rows -> 3 panels, motif in each
    db = [np.tile(motif, 3), motif.copy(), np.tile(motif, 2)]
    matrix = np.full((4, 4), -1, np.int32)
    np.fill_diagonal(matrix, 3)
    for mode in (MODE_SW, MODE_OV):
        got = search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                     search_type=SEARCH_SCORE_END,
                                     engine=Engine(device="cpu",
                                                   block_size=B))
        want = jax_search_database_arrays(query, db, 3, 1, matrix,
                                          mode=mode,
                                          search_type=SEARCH_SCORE_END,
                                          engine=JaxEngine(backend="xla"))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _check_panel_rows(query, db, matrix, 3, 1, MODE_SW, SEARCH_SCORE_END,
                      False)


def test_long_query_routing(monkeypatch):
    """Queries up to PANEL_ROWS take the one-sweep path, taller ones
    panels; a stacked group refuses a query taller than PANEL_ROWS; a
    PANEL_ROWS that is not whole strips raises."""
    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    rng = np.random.default_rng(9)
    matrix = np.eye(4, dtype=np.int32) * 4 - 1
    db = [rng.integers(0, 4, size=20).astype(np.uint8) for _ in range(5)]
    eng = Engine(device="cpu", block_size=8)
    ddb = eng.upload(db)
    be = eng._backend
    for Q, panel in ((32, False), (33, True)):
        prof = be.prepare_query(matrix[rng.integers(0, 4, size=Q)].T, 3, 1)
        (h,) = be.dispatch_many(prof, ddb, 3, 1, MODE_SW, SEARCH_SCORE)
        assert isinstance(h, backend.PanelRows) == panel
        if panel:
            assert h.panels == ((0, 32), (32, 1))
    short, tall = ([rng.integers(0, 4, size=n).astype(np.uint8)]
                   for n in (32, 33))
    assert be.supports_multi(short * 2, 3, 1, 4, matrix)
    assert not be.supports_multi(short + tall, 3, 1, 4, matrix)
    assert kernels.plan_panels(80) == ((0, 32), (32, 32), (64, 16))
    for bad in (8, 40):
        monkeypatch.setattr(kernels, "PANEL_ROWS", bad)
        with pytest.raises(ValueError):
            kernels.plan_panels(100)
    stream = ddb.stream
    with pytest.raises(ValueError):  # not whole strips before the last
        kernels.ragged_panel_score(_profile(matrix, np.zeros(40, np.uint8)),
                                   stream, MODE_SW, 0, 3, 1,
                                   panels=((0, 20), (20, 20)))


@pytest.fixture(scope="module")
def long_problem():
    """A 70-residue query (three 32-row panels) against 120 sequences, a
    few of them pieces of the query."""
    rng = np.random.default_rng(77)
    query, db, matrix = random_problem(rng, n_seqs=120, query_len=70,
                                       min_len=1, max_len=90,
                                       alphabet_len=6, match=4)
    db[5] = query[10:60].copy()
    db[40] = np.concatenate([query[:30], query[35:]])
    return query, db, matrix


@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", MODES)
def test_top_k_matches_jax(monkeypatch, long_problem, mode, x):
    """top_k through the panel handle, ranked on the device after the
    merge (opal_tpu ranks panel payloads on the host)."""
    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    query, db, matrix = long_problem
    calls = kernels.PLAIN_CALLS["ragged_panel_plain"]
    got = search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                 search_type=x, top_k=7,
                                 engine=Engine(device="cpu", block_size=32))
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] - calls == 3
    want = jax_search_database_arrays(query, db, 3, 1, matrix, mode=mode,
                                      search_type=x, top_k=7,
                                      engine=JaxEngine(backend="xla",
                                                       block_size=32))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_alignment_matches_jax(monkeypatch, long_problem, mode):
    """search_database at x2: scores and ends from the panels, paths on
    the host, every field as opal_tpu gives it."""
    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    query, db, matrix = long_problem
    db = db[:50]
    calls = kernels.PLAIN_CALLS["ragged_panel_plain"]
    got = search_database(query, db, 3, 1, matrix, mode=mode,
                          search_type=SEARCH_ALIGNMENT,
                          engine=Engine(device="cpu", block_size=32))
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] > calls
    want = jax_search_database(query, db, 3, 1, matrix, mode=mode,
                               search_type=SEARCH_ALIGNMENT,
                               engine=JaxEngine(backend="xla",
                                                block_size=32))

    def fields(r):
        return (r.score_set, r.score, r.end_location_query,
                r.end_location_target, r.start_location_query,
                r.start_location_target, r.alignment_length,
                None if r.alignment is None else list(r.alignment))

    assert [fields(r) for r in got] == [fields(r) for r in want]
    assert sum(r.alignment is not None for r in got) > 10


@pytest.mark.parametrize("mode", MODES)
def test_adaptive_matches_jax(monkeypatch, long_problem, mode):
    """precision="adaptive" through the panels' flag rows: results and
    last_search_stats equal opal_tpu's in every key."""
    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    query, db, matrix = long_problem
    matrix = matrix * np.array([1, 1, 40, 40, 900, 900], np.int32)
    eng = Engine(device="cpu", block_size=32, precision="adaptive")
    jeng = JaxEngine(backend="xla", block_size=32, precision="adaptive")
    calls = kernels.PLAIN_CALLS["ragged_panel_plain"]
    got = search_database(query, db, 3, 1, matrix, mode=mode,
                          search_type=SEARCH_SCORE_END, engine=eng)
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] - calls == 3
    want = jax_search_database(query, db, 3, 1, matrix, mode=mode,
                               search_type=SEARCH_SCORE_END, engine=jeng)
    assert [(r.score, r.end_location_query, r.end_location_target)
            for r in got] == [(r.score, r.end_location_query,
                               r.end_location_target) for r in want]
    a, b = eng.last_search_stats, jeng.last_search_stats
    assert set(a) == set(b)
    for k, w in b.items():
        if k == "bucket_escalations":
            for kk in w:
                np.testing.assert_array_equal(a[k][kk], w[kk], err_msg=kk)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(a[k], w, err_msg=k)
        else:
            assert a[k] == w, k
    assert len({b for b in a["precision_bits"].values()}) >= 2


def test_served_batch_with_a_long_query_matches_jax(monkeypatch):
    """One batch request mixing a query taller than PANEL_ROWS with short
    ones (stacked through multi_dp's plain version; the long one alone
    through panels), and the same long query with align: true."""
    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    db_path = os.path.join(HERE, "port_data", "uniprot_sprot15.fasta")
    seqs = ["".join(c.splitlines()[1:])
            for c in open(db_path).read().split(">")[1:]]
    long_q = seqs[2][:90]
    reqs = [{"id": 1, "queries": [seqs[0][:20], long_q, seqs[5][3:30],
                                  seqs[9][:25]], "top_k": 5},
            {"id": 2, "query": long_q, "mode": "OV", "top_k": 0},
            {"id": 3, "query": long_q, "align": True, "top_k": 3}]
    lines = [json.dumps(r) for r in reqs]
    mine = Server(db_path, block_size=16, device="cpu")
    theirs = JaxServer(db_path, block_size=16, backend="xla")
    counts = dict(kernels.PLAIN_CALLS)
    got = [mine._respond(line) for line in lines]
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] - counts[
        "ragged_panel_plain"] == 3 * 3
    assert kernels.PLAIN_CALLS["multi_score_plain"] > counts[
        "multi_score_plain"]
    assert got == [theirs._respond(line) for line in lines]
    assert all("hits" in json.loads(g) for g in got)
    out = io.StringIO()
    mine._cache.clear()
    mine.run(io.StringIO(lines[0] + "\n"), out)
    assert out.getvalue().splitlines()[1] == got[0]


@pytest.mark.parametrize("x", [0, 2])
def test_cli_matches_jax(monkeypatch, capsys, x):
    """The in-process CLI with O74807 (110 residues) in 32-row panels:
    stdout equals opal_tpu.cli's except the timing values."""
    import re

    monkeypatch.setattr(kernels, "PANEL_ROWS", 32)
    args = ["--block-size", "16", "-a", "OV", "-x", str(x),
            os.path.join(HERE, "port_data", "O74807.fasta"),
            os.path.join(HERE, "port_data", "uniprot_sprot15.fasta")]
    calls = kernels.PLAIN_CALLS["ragged_panel_plain"]
    assert cli.main(["--device", "cpu"] + args) == 0
    mine = capsys.readouterr().out
    assert kernels.PLAIN_CALLS["ragged_panel_plain"] - calls == 4
    assert jax_cli.main(["--backend", "xla"] + args) == 0
    theirs = capsys.readouterr().out

    def untimed(text):
        text = re.sub(r"(Cpu time of searching:) [\d.]+", r"\1 T", text)
        return re.sub(r"(GCUPS \(giga cell updates per second\):) [\d.]+",
                      r"\1 G", text)

    assert untimed(mine) == untimed(theirs)
    assert mine.count("\n#") >= 15
