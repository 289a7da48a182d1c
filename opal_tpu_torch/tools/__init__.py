"""Measurement tools of the port: the card's own counterparts of the TPU
probes in the repository's tools/ (roofline.py, exp_unroll.py,
exp_sstack_ablate.py), which sized the DP kernel on the TPU.

Each module runs as `python -m opal_tpu_torch.tools.<name>` and prints one
JSON line. The probes are CUDA C++ kernels under `csrc/` (built by
engine/_build.py into the git-ignored engine/_build/, bound with ctypes);
each has a plain PyTorch version beside it, which a CPU tensor runs and
which the card's checks hold the kernel against. The modules run on
"cuda" by default and raise without it; `--device cpu` runs the plain
versions at a small size and reports no time.

This module holds what the three share: the launch counts, the library
loader, CUDA-event timing, the SM clock sampled while a probe runs, and
the SASS opcode counts of a built library.
"""
from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
PROBES = ("roofline", "exp_unroll", "exp_sstack")

# Launches of each probe kernel (the wrappers count; plain versions do not)
LAUNCHES = {"roofline_peak": 0, "roofline_scan": 0, "exp_unroll": 0,
            "exp_sstack": 0}

# opcodes that the probes' inner loops are made of
SASS_OPS = ("IADD3", "VIADD", "IMAD", "MOV", "SEL", "IMNMX", "VIMNMX",
            "VIMNMX3", "VIADDMNMX", "FADD", "FMNMX", "ISETP", "BRA", "LDS",
            "LDG", "STG")
# the max-type opcodes: they issue on the 64-lane integer pipe only
SASS_MAX_OPS = ("IMNMX", "VIMNMX", "VIMNMX3", "VIADDMNMX")


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lib(name: str, sigs: dict) -> ctypes.CDLL:
    """The built probe library `name` with the C signatures `sigs`
    ({function: argtypes}, each returning int) declared."""
    from ..engine import _build

    so = _build.load(name, CSRC)
    for fname, args in sigs.items():
        fn = getattr(so, fname)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return so


def check_launch(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def cu_stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs (CUDA events, warmed up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nvidia_smi(query: str) -> str:
    """nvidia-smi's answer for the first card, e.g. "name,power.limit"."""
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def timed_under_load(fn, seconds: float = 1.0):
    """(mean ms of one fn(), median SM clock in MHz, clock samples): fn is
    run back to back for about `seconds` while nvidia-smi samples the SM
    clock every 50 ms; the sampler is stopped before this returns."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "50"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.2)  # the sampler's first reading
        reps = 0
        t0 = time.perf_counter()
        start.record()
        while time.perf_counter() - t0 < seconds:
            fn()
            reps += 1
            torch.cuda.synchronize()
        stop.record()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    samples = [int(x) for x in re.findall(r"^\s*(\d+)\s*$", out, re.M)]
    if not samples:
        raise RuntimeError("nvidia-smi gave no SM clock sample")
    # the readings taken while the loop ran (the first is the idle one)
    loaded = samples[1:] or samples
    return (start.elapsed_time(stop) / reps, statistics.median(loaded),
            samples)


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def sass(name: str) -> dict:
    """{function: [(address, opcode, branch target or None)]} of the built
    probe library `name`, from `cuobjdump -sass`."""
    from ..engine import _build

    _build.load(name, CSRC)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", str(_build.so_path(name, CSRC))],
                       capture_output=True, text=True, timeout=120,
                       check=True)
    out, fn, labels, pending = {}, None, {}, []
    for ln in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*\.(L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9]*)(.*)", ln)
        if m and fn is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            target = None
            if m.group(2) == "BRA":
                t = re.search(r"(0x[0-9a-f]+)|\.(L_x_\d+)", m.group(3))
                if t:
                    target = int(t.group(1), 16) if t.group(1) else t.group(2)
            fn.append((addr, m.group(2), target))
    # labels resolve once every address is known
    return {f: [(a, op, labels.get(t, t)) for a, op, t in ins]
            for f, ins in out.items()}


def _count(ins) -> dict:
    counts = {"total": len(ins)}
    for _, op, _ in ins:
        if op in SASS_OPS:
            counts[op] = counts.get(op, 0) + 1
    return counts


def sass_counts(name: str) -> dict:
    """{function: {"all": {opcode: count}, "loop": {opcode: count}}} of the
    built probe library `name`: opcodes of SASS_OPS and the total, in the
    whole function and in its hot loop (of the instruction ranges from the
    target of a backward branch to the branch, the one densest in max-type
    instructions, FMNMX included; the innermost on a tie)."""
    out = {}
    for fn, ins in sass(name).items():
        best, loop = None, []
        for a, op, t in ins:
            if op != "BRA" or not isinstance(t, int) or t > a:
                continue
            body = [i for i in ins if t <= i[0] <= a]
            n_max = sum(i[1] in SASS_MAX_OPS + ("FMNMX",) for i in body)
            key = (n_max / len(body), -len(body))
            if best is None or key > best:
                best, loop = key, body
        out[fn] = {"all": _count(ins), "loop": _count(loop)}
    return out
