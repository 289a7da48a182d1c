"""The port's measurement tools (opal_tpu_torch.tools) on the CPU against
the TPU tools they replace (tools/roofline.py, tools/exp_unroll.py,
tools/exp_sstack_ablate.py), run unchanged in Pallas interpret mode.

Each TPU tool is loaded from its file with importlib; inside a test
`jax.experimental.pallas.pallas_call` is wrapped so that it runs with
interpret=True and without TPU compiler parameters. On the CPU each probe's
wrapper runs its plain version, which must equal the TPU kernel's output
exactly: peak's f32 state (the int forms 8 x it), scan's row 0 (and the
whole H against a numpy transcription of tools/roofline.py:127-135),
exp_unroll's best score against every TPU variant, and exp_sstack's
emitted rows (every variant of one probe shares its plain function, apart
from exp_sstack's noprof and s1ctl; G and S choose only how the card runs
it). The CUDA kernels themselves, every variant at every G and S, are held
against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
exp_device_fill (the device alignment fill against the host path) runs
here only as an entry point; its plain version is held against opal_tpu
in tests/test_torch_device_fill.py. So do the ten tools of the engine's
paths (serve_qps, serve_latency, exp_x1_gap, exp_topk, exp_align_topk,
perf, tb_scaling, exp_panel_mesh, exp_panels, exp_panel_rows); their
answers are held against opal_tpu in tests/test_torch_serve_tools.py and
tests/test_torch_search_tools.py.
"""
import functools
import importlib.util
import json
import os

import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu.engine import pallas_kernels as pk
from opal_tpu_torch.tools import exp_align_topk as port_align_topk
from opal_tpu_torch.tools import exp_device_fill as port_device_fill
from opal_tpu_torch.tools import exp_panel_mesh as port_panel_mesh
from opal_tpu_torch.tools import exp_panel_rows as port_panel_rows
from opal_tpu_torch.tools import exp_panels as port_panels
from opal_tpu_torch.tools import exp_sstack_ablate as port_sstack
from opal_tpu_torch.tools import exp_topk as port_topk
from opal_tpu_torch.tools import exp_unroll as port_unroll
from opal_tpu_torch.tools import exp_x1_gap as port_x1_gap
from opal_tpu_torch.tools import perf as port_perf
from opal_tpu_torch.tools import roofline as port_roofline
from opal_tpu_torch.tools import serve_latency as port_serve_latency
from opal_tpu_torch.tools import serve_qps as port_serve_qps
from opal_tpu_torch.tools import tb_scaling as port_tb_scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG = -(2.0**30)


def _tool(name):
    """tools/<name>.py as a module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_PALLAS_CALL = jpl.pallas_call


def _interpret_pallas(mp):
    """Make `mp` (a MonkeyPatch) run pallas_call in interpret mode, without
    TPU compiler parameters."""
    def pallas_call(*args, **kw):
        kw.pop("compiler_params", None)
        kw["interpret"] = True
        return _PALLAS_CALL(*args, **kw)

    mp.setattr(jpl, "pallas_call", pallas_call)


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode, without TPU compiler parameters."""
    _interpret_pallas(monkeypatch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- peak (P1)

def _peak_numpy(st, iters, unroll, c):
    """tools/roofline.py:77-89, the chain updates, in numpy."""
    st = [np.array(x) for x in st]
    for _ in range(iters * unroll):
        for j in range(8):
            st[j] = np.maximum(st[j] + c[j], st[(j + 1) % 8]) - c[j]
    return np.stack(st)


def test_peak_matches_the_tpu_kernel(interpret):
    R, B, K, G, U = 8, 128, 2, 2, 2
    tool = _tool("roofline")
    want = np.asarray(tool.build_peak_kernel(R, B, K, G, U)())  # [1, B]
    f32 = port_roofline.peak(port_roofline.peak_state("f32", R * B, "cpu"),
                             K * G, U, "f32")
    np.testing.assert_array_equal(f32[0, :B].numpy(), want[0])
    for v in ("i32", "dpx", "max3"):
        got = port_roofline.peak(port_roofline.peak_state(v, R * B, "cpu"),
                                 K * G, U, v)
        np.testing.assert_array_equal(got.numpy(), 8 * f32.numpy())


@pytest.mark.parametrize("variant", port_roofline.VARIANTS)
def test_peak_moving_state_matches_numpy(variant):
    """From a seeded state (the tool's init is a fixed point) the state
    moves; every form equals the TPU update transcribed, f32 x 8."""
    n, iters, unroll = 300, 3, 2
    st0 = port_roofline.peak_state("f32", n, "cpu", seed=7).numpy()
    _, c = port_roofline.peak_constants("f32")
    want = _peak_numpy(st0, iters, unroll, np.asarray(c, np.float32))
    assert not np.array_equal(want, st0)
    got = port_roofline.peak(port_roofline.peak_state(variant, n, "cpu",
                                                      seed=7),
                             iters, unroll, variant).numpy()
    scale = 1 if variant == "f32" else 8
    np.testing.assert_array_equal(got, scale * want)


def test_peak_constants_are_the_tools():
    init, c = port_roofline.peak_constants("f32")
    assert init == [1.0 + 0.25 * j for j in range(8)]
    assert c == [1.0 + 0.125 * j for j in range(8)]
    for v in ("i32", "dpx", "max3"):
        i8, c8 = port_roofline.peak_constants(v)
        assert i8 == [8 * x for x in init] and c8 == [8 * x for x in c]


# ---------------------------------------------------------------- scan (P2)

def _scan_numpy(H, tc, g):
    """tools/roofline.py:127-135 in numpy (roll + masked Hillis-Steele)."""
    Q = H.shape[0]
    rows = np.arange(Q)[:, None]
    H = H.astype(np.float64)
    for _ in range(g):
        for tt in range(tc):
            X = np.roll(H, 1, axis=0) - 2.0
            X[0] = -3.0
            k = 1
            while k < Q:
                X = np.maximum(X, np.where(rows >= k, np.roll(X, k, axis=0),
                                           NEG))
                k *= 2
            H = np.maximum(H, X - tt)
    return H


def test_scan_matches_the_tpu_kernel(interpret):
    Q, B, TC, G = 16, 128, 4, 2
    tool = _tool("roofline")
    want = np.asarray(tool.build_scan_kernel(Q, B, TC, G)())  # [1, B]
    H0 = port_roofline.scan_state(Q, B, "cpu")
    got = port_roofline.scan(H0, TC, G)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got.numpy(), _scan_numpy(H0.numpy(), TC, G))


@pytest.mark.parametrize("qp", [16, 48])
def test_scan_moving_state_matches_numpy(qp):
    """A random start H (the tool's init, the row index, is a fixed
    point) against the transcription."""
    H0 = torch.from_numpy(np.random.default_rng(qp).integers(
        -50, 50, (qp, 40)).astype(np.int32))
    got = port_roofline.scan(H0, 5, 3).numpy()
    want = _scan_numpy(H0.numpy(), 5, 3)
    assert not np.array_equal(want, H0.numpy())
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ exp_unroll (P3)

@functools.lru_cache(maxsize=None)
def _tpu_unroll(Q_pad):
    """(qprofile, letters, lengths, {TPU variant: best [B]}) of the TPU
    tool in interpret mode: B lanes of C chunks, lane lengths from 0 to
    C x 64 (letters past a lane's length are the padding letter, whose
    profile column is PAD_NEG, so the TPU kernel's best over all columns is
    the best over the lane's own)."""
    B, C = 128, 2
    tool = _tool("exp_unroll")
    rng = np.random.default_rng(Q_pad)
    meta = np.zeros((6, C), np.int32)
    letters = rng.integers(0, 20, size=(C, pk.T_CHUNK, B)).astype(np.int8)
    lengths = rng.integers(0, C * pk.T_CHUNK + 1, size=B).astype(np.int32)
    lengths[:4] = [0, 1, C * pk.T_CHUNK, 0]
    flat = letters.reshape(C * pk.T_CHUNK, B)
    flat[np.arange(C * pk.T_CHUNK)[:, None] >= lengths[None]] = pk.A_PAD - 1
    qprofile = rng.integers(-4, 12, size=(24, Q_pad - 8)).astype(np.int32)
    qp = pk.prepare_qp(qprofile, 1)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        _interpret_pallas(mp)
        for v in ("base", "unroll2", "unroll4", "unroll8"):
            out = tool.build(v, Q_pad, B)(jnp.asarray(meta),
                                          jnp.asarray(qp, jnp.bfloat16),
                                          jnp.asarray(letters), 2)
            want[v] = np.asarray(out[0])[0, 0]
    return qprofile, letters, lengths, want


@pytest.mark.parametrize("Q_pad", [32, 48])
def test_unroll_matches_every_tpu_variant(Q_pad):
    """The variants' plain function against every TPU variant, on lanes of
    length 0 to 128, at Q 24 and 40 (Q 40: r32's second strip holds 24
    padding rows, r16's third 8)."""
    from opal_tpu_torch.engine import kernels

    qprofile, letters, lengths, want = _tpu_unroll(Q_pad)
    qp = pk.prepare_qp(qprofile, 1)
    np.testing.assert_array_equal(port_unroll.prepare_qp(qprofile, 1), qp)
    profile, _ = port_unroll.inputs(qp, Q_pad - 8, letters, 1, "cpu")
    C, tc, B = letters.shape
    stream = kernels.pack_stream([letters.reshape(C * tc, B)], [lengths], B,
                                 "cpu")
    got = port_unroll.unroll_score(profile, stream).numpy()
    assert got[0] == got[3] == 0
    for tv, w in want.items():
        np.testing.assert_array_equal(got, w, err_msg=f"vs {tv}")


def test_unroll_input_is_the_tools_sequence():
    """Lane b of the port's stream holds letters[:, :, b] in order."""
    rng = np.random.default_rng(1)
    letters = rng.integers(0, 20, size=(3, 64, 8)).astype(np.int8)
    qp = port_unroll.prepare_qp(np.ones((24, 5), np.int32), 1)
    _, stream = port_unroll.inputs(qp, 5, letters, 1, "cpu")
    lanes = stream.letters.view(-1, 8, 4).permute(0, 2, 1).reshape(-1, 8)
    np.testing.assert_array_equal(lanes.numpy(), letters.reshape(-1, 8))


# ----------------------------------------------------- exp_sstack_ablate (P4)

def _tool_meta(S, C, per_block):
    """The meta of tools/exp_sstack_ablate.py:213-219."""
    meta = np.zeros((5 * S, C), np.int32)
    for s in range(S):
        meta[5 * s + 0] = np.arange(C) // per_block
        meta[5 * s + 1] = (np.arange(C) % per_block == 0)
        meta[5 * s + 2] = (np.arange(C) % per_block == per_block - 1)
        meta[5 * s + 3] = (np.arange(C) % per_block) * pk.T_CHUNK
        meta[5 * s + 4] = 1
    return meta


def test_sstack_meta_is_the_tools():
    np.testing.assert_array_equal(port_sstack.make_meta(3, 12, 4),
                                  _tool_meta(3, 12, 4))


@functools.lru_cache(maxsize=None)
def _tpu_sstack(S, Q_pad, zero_letters=False):
    """(qp, letters, meta, nb, [S, nb, B] emitted rows) of the TPU tool's
    `full` variant in interpret mode: S stacked streams of C chunks, B
    lanes (all letters 0 with zero_letters)."""
    C, per_block, B = 4, 2, 128
    tool = _tool("exp_sstack_ablate")
    rng = np.random.default_rng(S * Q_pad)
    nb = C // per_block + 2
    meta = _tool_meta(S, C, per_block)
    letters = rng.integers(0, 20, size=(C, S * pk.T_CHUNK, B)).astype(
        np.int8)
    qp = rng.integers(-4, 12, size=(Q_pad, pk.A_PAD)).astype(np.float32)
    run = np.zeros_like(letters) if zero_letters else letters
    qp_bd = np.einsum("qa,st->sqat", qp, np.eye(S, dtype=np.float32)
                      ).reshape(S * Q_pad, pk.A_PAD * S)
    with pytest.MonkeyPatch.context() as mp:
        _interpret_pallas(mp)
        outs = tool.build_variant("full", S, Q_pad, B)(
            jnp.asarray(meta), jnp.asarray(qp_bd, jnp.bfloat16),
            jnp.asarray(run), nb)
    return qp, letters, meta, nb, np.stack([np.asarray(o)[:, 0]
                                            for o in outs])


@pytest.mark.parametrize("kind, S_tpu, Q_pad", [
    ("lanes", 2, 16), ("lanes", 4, 32), ("noprof", 4, 32), ("s1ctl", 4, 32)])
def test_sstack_matches_the_tpu_full_variant(kind, S_tpu, Q_pad):
    """The three plain functions against the TPU `full` variant: lanes<S>'
    and strips2's on S_tpu stacked streams; noprof's against `full` on
    letters that are all 0; s1ctl's (the query tiled S_tpu times against
    stream 0) against `full` on one stream of the tiled query."""
    qp, letters, meta, nb, want = _tpu_sstack(S_tpu, Q_pad,
                                              kind == "noprof")
    profile, stream, meta_t = port_sstack.inputs(qp, letters, meta, 1, "cpu")
    emitted = sorted({int(meta[5 * s, c]) for s in range(S_tpu)
                      for c in range(meta.shape[1])
                      if meta[5 * s + 2, c] == 1})
    assert emitted == [0, 1]
    if kind == "s1ctl":
        profile, stream, meta_t = port_sstack.s1ctl_inputs(
            profile, stream, meta_t, S_tpu)
        tiled = np.tile(qp, (S_tpu, 1))
        tool = _tool("exp_sstack_ablate")
        with pytest.MonkeyPatch.context() as mp:
            _interpret_pallas(mp)
            out = tool.build_variant("full", 1, S_tpu * Q_pad, 128)(
                jnp.asarray(meta[:5]), jnp.asarray(tiled, jnp.bfloat16),
                jnp.asarray(letters[:, :pk.T_CHUNK]), nb)
        want = np.stack([np.asarray(out[0])[:, 0]])
    got = port_sstack.sstack_score(profile, stream, meta_t, nb,
                                   noprof=kind == "noprof")
    assert got.shape == (want.shape[0], nb, 128)
    np.testing.assert_array_equal(got.numpy()[:, emitted],
                                  want[:, emitted])


def test_sstack_plain_variants_agree():
    """noprof is full on all-0 letters; s1ctl is the tiled query against
    block 0; single's final best is full's last emit."""
    from opal_tpu_torch.constants import MODE_SW, SEARCH_SCORE
    from opal_tpu_torch.engine import kernels

    profile, stream, meta, nb = port_sstack.random_inputs(
        20, 16, 4, 2, 2, 1, 3, "cpu")
    full = port_sstack.sstack_score(profile, stream, meta, nb, 2)
    zero = kernels.Stream(torch.zeros_like(stream.letters), stream.offsets,
                          stream.lengths, stream.host_offsets)
    np.testing.assert_array_equal(
        port_sstack.sstack_score(profile, stream, meta, nb, 2, True).numpy(),
        port_sstack.sstack_score(profile, zero, meta, nb, 2).numpy())
    tiled, sub, meta0 = port_sstack.s1ctl_inputs(profile, stream, meta, 2)
    assert tiled.shape[0] == 40 and sub.lengths.shape[0] == 1
    ragged = kernels.ragged_score_plain(profile, stream, MODE_SW,
                                        SEARCH_SCORE, 3, 1)
    np.testing.assert_array_equal(ragged[:, 0].numpy(), full[:, 1].numpy())


# ------------------------------------------------------------ entry points

ENTRY_POINTS = [port_roofline, port_unroll, port_sstack, port_device_fill,
                port_serve_qps, port_serve_latency, port_x1_gap, port_topk,
                port_align_topk, port_perf, port_tb_scaling, port_panel_mesh,
                port_panels, port_panel_rows]

@pytest.mark.parametrize("module", ENTRY_POINTS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_point_on_the_cpu_prints_one_json_line(module, capsys):
    assert module.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["device"] == "cpu" and res["measured"] is False

    def keys(d):
        for k, v in d.items():
            yield k
            if isinstance(v, dict):
                yield from keys(v)

    assert not {"ms", "gcups", "instr_per_sm_clk"} & set(keys(res))
    assert not [k for k in keys(res) if k.endswith(("_s", "_ms"))]


@pytest.mark.parametrize("module", ENTRY_POINTS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_point_default_needs_cuda(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])
    assert capsys.readouterr().out == ""


def test_wrappers_refuse_bad_input():
    with pytest.raises(ValueError):
        port_roofline.peak(torch.zeros((8, 4), dtype=torch.int32), 1, 1,
                           "f32")
    with pytest.raises(ValueError):
        port_roofline.peak(torch.zeros((8, 4)), 1, 3, "f32")
    with pytest.raises(ValueError):
        port_roofline.scan(torch.zeros((20, 4), dtype=torch.int32), 1, 1)
    profile, stream, meta, nb = port_sstack.random_inputs(
        16, 8, 2, 2, 2, 1, 0, "cpu")
    with pytest.raises(ValueError):
        port_sstack.sstack_score(profile, stream, meta, nb, 4)
    with pytest.raises(ValueError):
        port_sstack.sstack_score(profile, stream, meta[:5], nb, 1)
    with pytest.raises(ValueError):
        port_sstack.sstack_score(profile, stream, meta, nb, 2, strips2=True)
    with pytest.raises(ValueError):
        port_sstack.sstack_score(profile, stream, meta, nb, 1, G=3)
    with pytest.raises(ValueError):
        port_unroll.unroll_score(profile, stream, "base")  # two blocks
    one = port_unroll.random_stream(8, 64, 0, "cpu")
    prof, _ = port_unroll.random_profile(32, device="cpu")
    with pytest.raises(ValueError):
        port_unroll.unroll_score(prof, one, "base", G=16)
    with pytest.raises(ValueError):
        port_unroll.unroll_score(prof, one, "r16")
