"""The device fill at the shapes its warp wavefront makes hard, on the CPU.

opal_tpu_torch/tools/fill_shapes.py builds six groups of lanes: tlen 1, 31
and 33; qlen at a strip's 16 rows, at a pass's 32 x 16 and 32 x 32 rows and
one past each; bands one to three rows wide; SW stops within 31 columns of
tlen and far from it; lanes whose max passes the limit or never reaches
it. The plain version (which the CUDA kernel is held against on the card:
tests/test_torch_cuda.py, chip_smoke.py) must equal opal_tpu's jitted
_fill_walk_fn on all five outputs. The kernel's pure launch planning
(plan_fill, computed_columns) is tested here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu.engine import device_fill as jax_fill
from opal_tpu.matrices import ScoreMatrix as JaxScoreMatrix
from opal_tpu_torch.constants import MODE_NW, MODE_SW
from opal_tpu_torch.engine import device_fill
from opal_tpu_torch.tools import fill_shapes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def groups():
    matrix = JaxScoreMatrix.blosum50().matrix
    return matrix, {g[0]: g for g in fill_shapes.edge_groups(
        matrix, device="cpu")}


@pytest.mark.parametrize("name", [g[0] for g in fill_shapes.GROUPS])
def test_plain_matches_opal_tpu_at_edges(groups, name):
    matrix, by_name = groups
    _, mode, go, ge, jobs = by_name[name]
    args = device_fill.pack_group(jobs, torch.device("cpu"))
    Qp, B = args[0].shape
    Tp = args[1].shape[0]
    got = device_fill.fill_walk(*args, go, ge, torch.from_numpy(
        matrix.astype(np.int32)), mode)
    fn = jax_fill._fill_walk_fn(mode, Qp, Tp, B, False, use_f32=False)
    want = fn(*(jnp.asarray(a.numpy()) for a in args), jnp.int32(go),
              jnp.int32(ge), jnp.asarray(matrix, jnp.int32))
    names = ("score", "rend_q", "rend_t", "ok", "codes")
    for n, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, n
        np.testing.assert_array_equal(g.numpy(), w, err_msg=n)

    # the shapes the group is meant to reach
    score, _, rend_t, ok, _ = (g.numpy() for g in got)
    qlen, tlen, limit = (a.numpy() for a in (args[2], args[3], args[6]))
    kinds = [lane[5] for lane in
             {g[0]: g[1] for g in fill_shapes.GROUPS}[name]]
    above = np.array([kind == "above" for kind in kinds])
    below = np.array([kind == "below" for kind in kinds])
    assert not ok[above].any()
    assert (score[below] >= limit[below]).all()
    assert (below & (score > limit) & ~ok).any()  # the max passes the limit
    assert ok[~above & ~below].sum() >= (~above & ~below).sum() - 1
    if mode == MODE_SW:
        stopped = ok & (rend_t < tlen - 1)
        assert (stopped & (rend_t >= tlen - 32)).any()  # near tlen
        if name == "tall_sw":
            assert (stopped & (rend_t < tlen - 32)).any()  # far from it
    if mode == MODE_NW:
        np.testing.assert_array_equal(rend_t, tlen - 1)
    if name.startswith("mixed"):
        assert set(qlen) >= {16, 512, 513, 1024, 1025}
        assert set(tlen) >= {1, 31, 33}


def test_plan_fill_rows_passes_scratch():
    p = device_fill.plan_fill(64, 64, 10)
    assert p == {"rows": 16, "passes": 1, "scratch_bytes": 0, "blocks": 3}
    assert device_fill.plan_fill(512, 4160, 512)["rows"] == 16
    p = device_fill.plan_fill(576, 4160, 488)
    assert (p["rows"], p["passes"], p["scratch_bytes"]) == (32, 1, 0)
    assert p["blocks"] == 122
    p = device_fill.plan_fill(1088, 256, 14)
    assert (p["rows"], p["passes"]) == (32, 2)
    assert p["scratch_bytes"] == 14 * 256 * 24  # int2 rows + int4 summaries
    p = device_fill.plan_fill(1088, 256, 14, rows=16)
    assert (p["rows"], p["passes"]) == (16, 3)
    assert device_fill.plan_fill(576, 64, 1, rows=16)["passes"] == 2
    with pytest.raises(ValueError):
        device_fill.plan_fill(64, 64, 1, rows=8)


def test_computed_columns():
    tlen = np.array([1, 40, 200, 200, 33])
    executed = np.array([1, 40, 20, 190, 2])
    np.testing.assert_array_equal(
        device_fill.computed_columns(tlen, executed, MODE_SW),
        [1, 40, 51, 200, 33])
    np.testing.assert_array_equal(
        device_fill.computed_columns(tlen, executed, MODE_NW), tlen)
