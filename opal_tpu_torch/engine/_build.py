"""Builds CUDA sources with nvcc and loads them with ctypes.

Each `<csrc>/<name>.cu` exports a plain C interface and compiles, at first
use, into `_build/lib<name>-<hash>.so` beside this file (the directory is
git-ignored). `csrc` is this package's `csrc/` (ragged_dp, multi_dp,
device_fill) unless a caller names another source directory
(opal_tpu_torch/tools/csrc holds the probes, which include this package's
strip_group.cuh); names are unique across the directories. The hash
covers the source, the headers (`*.cuh`) of its directory and of this
package's csrc/, and the flags, so an edited source or header builds anew
and an unchanged one loads what is there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("ragged_dp", "multi_dp", "device_fill")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]
# asks ptxas for its register / spill report; the binary is the same
REPORT_FLAGS = ["-Xptxas", "-v"]

_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc; raises when the CUDA toolkit is absent."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return found


def _target(name: str, csrc: Path = CSRC) -> Path:
    deps = set(Path(csrc).resolve().glob("*.cuh")) | set(CSRC.glob("*.cuh"))
    src = (Path(csrc) / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(deps))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def so_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library of `csrc/<name>.cu` is (or will be) built."""
    return _target(name, csrc)


def build_all(names=KERNELS, report: bool = False, csrc: Path = CSRC) -> dict:
    """Compile every missing library of `names` (sources in `csrc`), one
    nvcc per source, all started together.

    Returns {name: {"seconds": build time (0.0 when already built),
    "log": nvcc's output, with ptxas's register report when `report`}}.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    out, running = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = _target(name, csrc)
        if so.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, *(REPORT_FLAGS if report else []),
               "-o", str(tmp), str(Path(csrc) / f"{name}.cu")]
        running[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (so, tmp, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, so)
        out[name] = {"seconds": time.perf_counter() - t0,
                     "log": log.strip()}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The built library `name` (source `csrc/<name>.cu`), building it
    first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        so = _target(name, csrc)
        if not so.exists():
            build_all((name,), csrc=csrc)
        lib = _loaded[name] = ctypes.CDLL(str(so))
    return lib
