"""The port stands alone: opal_tpu_torch (its CLI, server, cascade,
traceback and measurement tools included) and chip_smoke.py import nothing
of JAX or opal_tpu, importing the package builds and touches nothing, and
the default (CUDA) entry points raise instead of running on the CPU when
CUDA is absent."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "opal_tpu"}


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "opal_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_opal_tpu_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_package_import_pulls_in_no_jax():
    code = ("import sys; import opal_tpu_torch; "
            "import opal_tpu_torch.engine.search; "
            "import opal_tpu_torch.cli, opal_tpu_torch.serve; "
            "import opal_tpu_torch.engine.cascade; "
            "import opal_tpu_torch.traceback, opal_tpu_torch.checkpoint; "
            "import opal_tpu_torch.bench, opal_tpu_torch.synth; "
            "import opal_tpu_torch.tools.roofline, "
            "opal_tpu_torch.tools.exp_unroll, "
            "opal_tpu_torch.tools.exp_sstack_ablate, "
            "opal_tpu_torch.tools.exp_device_fill, "
            "opal_tpu_torch.tools.fill_shapes, "
            "opal_tpu_torch.tools.scaling_bench, "
            "opal_tpu_torch.tools.serve_qps, "
            "opal_tpu_torch.tools.serve_latency, "
            "opal_tpu_torch.tools.exp_x1_gap, opal_tpu_torch.tools.exp_topk, "
            "opal_tpu_torch.tools.exp_align_topk, "
            "opal_tpu_torch.tools.perf, opal_tpu_torch.tools.tb_scaling, "
            "opal_tpu_torch.tools.exp_panel_mesh, "
            "opal_tpu_torch.tools.exp_panels, "
            "opal_tpu_torch.tools.exp_panel_rows, "
            "opal_tpu_torch.engine.device_fill; "
            "import opal_tpu_torch.parallel.shard, "
            "opal_tpu_torch.parallel.multihost, "
            "opal_tpu_torch.parallel.dryrun; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'opal_tpu')))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_default_engine_needs_cuda(monkeypatch):
    from opal_tpu_torch.engine import search

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(search, "_default_engine", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        search.Engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        search.search_database_arrays(
            np.zeros(3, np.uint8), [np.zeros(4, np.uint8)],
            matrix=np.eye(2, dtype=np.int32))
    with pytest.raises(ValueError):
        search.Engine(device="mps")
    assert search.Engine(device="cpu").device == torch.device("cpu")


def test_default_mesh_needs_cuda(monkeypatch):
    """db_mesh() and the dry run default to the CUDA devices and raise
    without them; a CPU mesh is asked for by name."""
    from opal_tpu_torch.parallel import dryrun, shard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        shard.db_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        shard.db_mesh(["cuda:0"])
    assert shard.db_mesh(["cpu"]).devices == (torch.device("cpu"),)


def test_chip_smoke_refuses_without_the_card_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where CUDA is
    absent, and in a directory that holds nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    runs = [subprocess.run([sys.executable, str(lone)], capture_output=True,
                           text=True, timeout=120, cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, "chip_smoke.py"], capture_output=True,
            text=True, timeout=120, cwd=ROOT))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
