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
    return [{k: c[bi].numpy() for k, c in cols.items()}
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
    """plan_launch: every block in exactly one launch, longest block first
    in each; one launch while the scratch fits SCRATCH_CELLS, else the
    fewest waves, dealt round-robin, whose scratch fits; jobs cover every
    lane of a block with THREADS / G lanes per CUDA block."""
    cols = np.array([8, 12, 60, 4, 4, 20])
    Bl = 16
    offsets = np.concatenate([[0], np.cumsum(cols * Bl)])
    plan = kernels.plan_launch(offsets, Bl, 40, False, 10**6)
    assert len(plan.waves) == 1
    assert list(plan.waves[0]) == [2, 5, 1, 0, 3, 4]  # longest first
    monkeypatch.setattr(kernels, "SCRATCH_CELLS", 70 * Bl)
    plan = kernels.plan_launch(offsets, Bl, 40, False, 10**6)
    assert sorted(b for w in plan.waves for b in w) == list(range(6))
    for w, jobs, off in zip(plan.waves, plan.jobs, plan.scratch_offsets):
        assert list(w) == sorted(w, key=lambda b: -cols[b])
        assert int((cols[list(w)] * Bl).sum()) <= 70 * Bl or len(w) == 1
        assert set(np.flatnonzero(off >= 0)) == set(w)
        for b in w:  # lanes 0..B-1, THREADS / G at a time
            G = int(plan.groups[b])
            lane0 = jobs[jobs[:, 0] == b, 1]
            assert list(lane0) == list(range(0, Bl, kernels.THREADS // G))
    assert len(plan.waves) == 3  # the 60-column block alone, then 2 more
    assert plan.scratch_cells == max(int((cols[list(w)] * Bl).sum())
                                     for w in plan.waves)


@pytest.mark.parametrize("n_strips,want", [(1, 1), (2, 2), (3, 4), (7, 8),
                                            (8, 8)])
def test_plan_one_pass_needs_no_scratch(n_strips, want):
    """A query of up to MAX_GROUP strips: every block takes the smallest
    power of two G >= its strips, in one launch with no scratch; panels
    (handoff) need scratch for every block."""
    cols = np.array([4, 40, 400, 4000])
    offsets = np.concatenate([[0], np.cumsum(cols * 32)])
    plan = kernels.plan_launch(offsets, 32, n_strips, False, 10**4)
    assert plan.groups.tolist() == [want] * 4
    assert plan.scratch_cells == 0 and len(plan.waves) == 1
    assert (plan.scratch_offsets[0] == -1).all()
    plan = kernels.plan_launch(offsets, 32, n_strips, True, 10**4)
    assert plan.scratch_cells == int(cols.sum()) * 32
    # laid out longest block first, back to back
    assert plan.scratch_offsets[0].tolist() == [
        4440 * 32, 4400 * 32, 4000 * 32, 0]


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_plan_takes_a_given_group(G):
    """plan_launch with G: every block at G threads per lane, scratch
    exactly where a lane's strips need more than one pass (here 3 strips),
    jobs of THREADS / G lanes; any other G is refused."""
    cols = np.array([4, 40, 400])
    offsets = np.concatenate([[0], np.cumsum(cols * 32)])
    plan = kernels.plan_launch(offsets, 32, 3, False, 10**4, G=G)
    assert plan.groups.tolist() == [G] * 3
    assert plan.scratch_cells == (int(cols.sum()) * 32 if G < 3 else 0)
    for b in range(3):
        lane0 = plan.jobs[0][plan.jobs[0][:, 0] == b, 1]
        assert list(lane0) == list(range(0, 32, kernels.THREADS // G))
    with pytest.raises(ValueError):
        kernels.plan_launch(offsets, 32, 3, False, 10**4, G=3)


def test_plan_groups_follow_lengths(monkeypatch):
    """A query taller than MAX_GROUP strips: the smallest G whose longest
    chain fits half the work per resident thread; longer blocks take larger
    G, and scratch is sized only where passes remain (Q > 16 G)."""
    cols = np.array([32, 64, 700, 1500, 5000])
    ns, threads = 64, 96
    work = ns * int(cols.sum()) * 8
    got = kernels.plan_groups(cols, 8, ns, threads)
    for c, g in zip(cols, got):
        fits = [G for G in (1, 2, 4, 8)
                if 2 * -(-ns // G) * (c + G - 1) * threads <= work]
        assert g == (fits[0] if fits else 8)
    assert list(got) == sorted(got) and got[0] < got[-1]
    monkeypatch.setattr(kernels, "MAX_GROUP", 2)
    assert set(kernels.plan_groups(cols, 8, 7, threads).tolist()) <= {1, 2}
    assert kernels.plan_groups(cols, 8, 2, threads).tolist() == [2] * 5
    monkeypatch.setattr(kernels, "MAX_GROUP", 8)
    offsets = np.concatenate([[0], np.cumsum(cols * 8)])
    plan = kernels.plan_launch(offsets, 8, 7, False, threads)
    assert plan.scratch_cells == 0  # 7 strips, G = 8: one pass
    plan = kernels.plan_launch(offsets, 8, 200, False, threads)
    assert plan.scratch_cells == int(cols.sum()) * 8  # 200 > 16 x 8


# ----------------------------------------------------------------------
# A transcription of the kernels' strip groups (csrc/strip_group.cuh): the
# DP over whole strips (padding rows at PAD_NEG included), what each strip
# leaves for the merge, and the group's merge in the kernels' order and
# with their tie rules. It must equal the plain versions.


def _strip_cells(prof, letters, lens, mode, go, ge):
    """H, E, F and the diagonal candidate d, [T, rows, L] int64, of the
    recurrence over every row of prof [rows, W] (padding rows included) for
    L lanes (letters [T, L]), with the kernels' walls."""
    rows, T, L = prof.shape[0], letters.shape[0], letters.shape[1]
    sw, wall = mode == MODE_SW, mode in (MODE_NW, MODE_HW)
    neg = kernels.NEG
    Hc = np.array([(-go - r * ge) if wall else 0 for r in range(rows)],
                  np.int64)[:, None].repeat(L, 1)
    Ec = np.full((rows, L), 0 if sw else neg, np.int64)
    out = {k: np.zeros((T, rows, L), np.int64) for k in "HEFd"}
    for t in range(T):
        P = prof[:, letters[t]]  # [rows, L]
        hu = np.full(L, -go - t * ge if mode == MODE_NW else 0, np.int64)
        fu = np.full(L, 0 if sw else neg, np.int64)
        diag = np.full(L, 0 if (t == 0 or mode != MODE_NW)
                       else -go - (t - 1) * ge, np.int64)
        for r in range(rows):
            e = np.maximum(Hc[r] - go, Ec[r] - ge)
            f = np.maximum(hu - go, fu - ge)
            d = diag + P[r]
            h = np.maximum(np.maximum(e, f), d)
            if sw:
                h = np.maximum(h, 0)
            diag = Hc[r].copy()
            Hc[r], Ec[r], hu, fu = h, e, h, f
            for k, v in zip("HEFd", (h, e, f, d)):
                out[k][t, r] = v
    return out


def _strip_outs(cells, lens, l, s, Q, last, mode, track_end,
                R=kernels.STRIP_ROWS):
    """What strip s (rows R s .. R s + R - 1 of its frame) of lane l leaves
    for the merge (strip_group.cuh's StripOut)."""
    n = int(lens[l])
    r0 = s * R
    H = cells["H"][:n, r0:r0 + R, l]
    o = dict(sb=0, st=0, sr=0, cm=kernels.NEG, cr=0, lr=kernels.NEG, lr_c=0,
             plrm=kernels.NEG, nw=kernels.NEG)
    if n == 0:
        return o
    if mode == MODE_SW:
        m = int(H.max())
        if m > 0:  # strict first improvement, columns outer, rows inner
            t = int(np.flatnonzero(H.max(axis=1) == m)[0])
            o.update(sb=m, st=t, sr=r0 + int(np.flatnonzero(H[t] == m)[0]))
    real = min(R, Q - r0) if last else R
    col = H[n - 1, :real]
    o.update(cm=int(col.max()), cr=r0 + int(np.argmax(col)))
    if last:
        lastrow = H[:, Q - 1 - r0]
        o["lr"] = int(lastrow.max())
        o["lr_c"] = int(np.argmax(lastrow))
        o["plrm"] = int(lastrow[:-1].max()) if n > 1 else kernels.NEG
        o["nw"] = int(lastrow[-1])
    return o


def _merge_group(outs, G, row0=0):
    """The group's merge of strip outputs [StripOut, ...] in strip order,
    pass by pass (thread g2 of pass p holds strip p G + g2)."""
    tr = dict(best=0, best_r=row0, best_c=0, ocm=kernels.NEG, orow=row0)
    for p in range(-(-len(outs) // G)):
        for g2 in range(G):
            if p * G + g2 >= len(outs):
                break
            o = outs[p * G + g2]
            if (o["sb"] > tr["best"] or (o["sb"] == tr["best"] and o["sb"] > 0
                                          and o["st"] < tr["best_c"])):
                tr.update(best=o["sb"], best_c=o["st"], best_r=o["sr"])
            if o["cm"] > tr["ocm"]:
                tr.update(ocm=o["cm"], orow=o["cr"])
    tr.update({k: outs[-1][k] for k in ("lr", "lr_c", "plrm", "nw")})
    return tr


def _flags_group(cells, lens, l, Q, G, mode):
    """Each thread's flags over its strips' real rows, then the group's
    butterfly (min / max)."""
    n = int(lens[l])
    ns = -(-Q // kernels.STRIP_ROWS)
    per = []
    for g in range(G):
        rows = [r for s in range(g, ns, G)
                for r in range(s * 16, min(s * 16 + 16, Q))]
        c = {k: cells[k][:n, rows, l] for k in "HEFd"}
        if n == 0 or not rows:
            per.append((kernels.NEG, 0, 0, kernels.NEG))
            continue
        per.append((int(c["d"].max()), min(0, int(c["E"].min())),
                    min(0, int(c["F"].min())), int(c["H"].max())))
    return (max(p[0] for p in per), min(p[1] for p in per),
            min(p[2] for p in per), max(p[3] for p in per))


def _planted(seed, Q, A=12, n=40):
    """A query whose motifs repeat in different strips, and lanes that hold
    them in crossed order, so SW ends and OV last-column maxima tie across
    strips owned by different threads; n lanes, some empty."""
    rng = np.random.default_rng(seed)
    matrix = np.where(np.eye(A, dtype=bool), 5, -4).astype(np.int32)
    query = rng.integers(0, A, size=Q)
    x, y = rng.integers(0, A, size=6), rng.integers(0, A, size=6)
    for at, m in ((3, x), (21, y), (37, x), (53, y)):
        if at + 6 <= Q:
            query[at:at + 6] = m
    db = []
    for i in range(n):
        L = int(rng.integers(0, 60))
        t = rng.integers(0, A, size=L)
        if L >= 30 and i % 3:
            a, b = (y, x) if i % 2 else (x, y)
            t[4:10], t[L - 6:] = a, b
        db.append(t.astype(np.uint8))
    return query, db, matrix


@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", MODES)
def test_group_merge_transcription_matches_plain(mode, x, flags):
    """The strip-group merge, at every G, equals ragged_score_plain on a
    query of 5 strips with ties planted across strips."""
    Q, go, ge = 70, 3, 1
    query, db, matrix = _planted(11 + mode, Q)
    blocks = batching.plan_blocks(db, B)
    stream = kernels.pack_stream([b.letters for b in blocks],
                                 [b.lengths for b in blocks], B, "cpu")
    prof = kernels.build_profile(matrix[query].T)
    want = kernels.ragged_score_plain(torch.from_numpy(prof), stream, mode,
                                      x, go, ge, flags).numpy()
    ns = -(-Q // kernels.STRIP_ROWS)
    padded = np.full((ns * kernels.STRIP_ROWS, prof.shape[1]),
                     kernels.PAD_NEG, np.int64)
    padded[:Q] = prof
    lens = np.concatenate([b.lengths for b in blocks])
    letters = np.concatenate([np.pad(b.letters, ((0, int(lens.max()) + 1
                                                  - b.t_pad), (0, 0)))
                              for b in blocks], axis=1).astype(np.int64)
    cells = _strip_cells(padded, letters[:max(1, int(lens.max()))], lens,
                         mode, go, ge)
    rows = kernels.tracker_rows(mode, x, flags)
    ties = 0
    for G in (1, 2, 4, 8):
        got = np.zeros_like(want)
        for l in range(len(lens)):
            outs = [_strip_outs(cells, lens, l, s, Q, s == ns - 1, mode, x)
                    for s in range(ns)]
            sws = [o["sb"] for o in outs if o["sb"] > 0]
            ties += len(sws) != len(set(sws))
            tr = _merge_group(outs, G)
            n = int(lens[l])
            if mode == MODE_OV:  # the kernel's final OV rule
                in_last = tr["ocm"] > tr["plrm"]
                vals = {kernels.TR_BEST: max(tr["ocm"], tr["lr"]),
                        kernels.TR_BEST_R: tr["orow"] if in_last else Q - 1,
                        kernels.TR_BEST_C: n - 1 if in_last else tr["lr_c"]}
            else:
                vals = {kernels.TR_BEST: tr["best"] if mode == MODE_SW
                        else tr["lr"],
                        kernels.TR_BEST_R: tr["best_r"],
                        kernels.TR_BEST_C: tr["best_c"] if mode == MODE_SW
                        else tr["lr_c"], kernels.TR_NW: tr["nw"]}
            fl = _flags_group(cells, lens, l, Q, G, mode)
            vals.update({kernels.TR_ULHP: fl[0], kernels.TR_MIN_E: fl[1],
                         kernels.TR_MIN_F: fl[2], kernels.TR_MAX_H: fl[3]})
            got[l // B, :, l % B] = [vals[r] for r in rows]
        np.testing.assert_array_equal(got, want, err_msg=f"G={G}")
    if mode == MODE_SW:
        assert ties > 0  # the planted ties reached several strips


@pytest.mark.parametrize("x", [SEARCH_SCORE, SEARCH_SCORE_END])
@pytest.mark.parametrize("mode", MODES)
def test_group_merge_transcription_matches_multi_plain(mode, x):
    """multi_dp's merge: segments over stacked strips, a segment's first
    strip on the wall wherever it falls in a pass, fresh trackers per
    segment, final values after its last strip; equals multi_score_plain
    at every G."""
    go, ge = 2, 1
    query, db, matrix = _planted(40 + mode, 78)
    seg_q = (5, 40, 16, 17)  # segments of 1, 2, 1, 1 strips
    R = kernels.MULTI_STRIP_ROWS
    cuts = np.cumsum((0,) + seg_q)
    queries = [query[cuts[i]:cuts[i + 1]] for i in range(len(seg_q))]
    blocks = batching.plan_blocks(db, B)
    stream = kernels.pack_stream([b.letters for b in blocks],
                                 [b.lengths for b in blocks], B, "cpu")
    prof, qs = kernels.prepare_profile_multi([matrix[q].T for q in queries])
    want = kernels.multi_score_plain(torch.from_numpy(prof), qs, stream,
                                     mode, x, go, ge).numpy()
    lens = np.concatenate([b.lengths for b in blocks])
    letters = np.concatenate([np.pad(b.letters, ((0, int(lens.max()) + 1
                                                  - b.t_pad), (0, 0)))
                              for b in blocks], axis=1).astype(np.int64)
    segs, strip_of = [], []  # (segment, strip within it) per stacked strip
    off = 0
    for i, q in enumerate(seg_q):
        rows_i = kernels.segment_rows(q)
        segs.append(_strip_cells(prof[off:off + rows_i].astype(np.int64),
                                 letters[:int(lens.max())], lens, mode, go,
                                 ge))
        strip_of += [(i, s) for s in range(rows_i // R)]
        off += rows_i
    n_seg = len(seg_q)
    for G in (1, 2, 4, 8):
        got = np.zeros_like(want)
        for l in range(len(lens)):
            n = int(lens[l])
            carry, done = [], {}
            for p in range(-(-len(strip_of) // G)):  # passes, strip order
                for g2 in range(G):
                    k = p * G + g2
                    if k >= len(strip_of):
                        break
                    i, s = strip_of[k]
                    ns_i = kernels.segment_rows(seg_q[i]) // R
                    carry.append(_strip_outs(segs[i], lens, l, s, seg_q[i],
                                             s == ns_i - 1, mode, x, R))
                    if s == ns_i - 1:
                        done[i] = _merge_group(carry, 1)
                        carry = []
            for i, tr in done.items():
                Qs = seg_q[i]
                if mode == MODE_NW:
                    v = (tr["nw"], Qs - 1, n - 1)
                elif mode == MODE_SW:
                    v = (tr["best"], tr["best_r"], tr["best_c"])
                elif mode == MODE_HW:
                    v = (tr["lr"], Qs - 1, tr["lr_c"])
                else:
                    in_last = tr["ocm"] > tr["plrm"]
                    v = (max(tr["ocm"], tr["lr"]),
                         tr["orow"] if in_last else Qs - 1,
                         n - 1 if in_last else tr["lr_c"])
                for j in range(3 if x else 1):
                    got[l // B, j * n_seg + i, l % B] = v[j]
        np.testing.assert_array_equal(got, want, err_msg=f"G={G}")
