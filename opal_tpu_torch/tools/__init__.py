"""Measurement tools of the port: the card's own counterparts of the
repository's tools/.

Each module runs as `python -m opal_tpu_torch.tools.<name>` and prints one
JSON line. Three of them (roofline, exp_unroll, exp_sstack_ablate) are the
TPU probes that sized the DP kernel: CUDA C++ kernels under `csrc/` (built
by engine/_build.py into the git-ignored engine/_build/, bound with
ctypes), each with a plain PyTorch version beside it, which a CPU tensor
runs and which the card's checks hold the kernel against. The others
measure the engine's own paths: serving (serve_qps, serve_latency), the
host's share of a search (exp_x1_gap), the device top k (exp_topk), the
alignment pass (exp_align_topk, exp_device_fill, tb_scaling), the four
modes (perf), long queries (exp_panels, exp_panel_rows, exp_panel_mesh)
and the mesh (scaling_bench). Each has a run(...) that takes an existing
Server or Engine and its resident database. The modules run on "cuda" by
default and raise without it; `--device cpu` runs the plain versions at a
small size and reports no time.

This module holds what they share: the launch counts, the library loader,
CUDA-event timing, the SM clock sampled while a probe runs, the SASS
opcode counts of a built library, the card's idle share in a profiler
trace, the test queries, the synthetic database, and the one output
line.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# the repository's test queries (tests/port_data/<name>.fasta)
PORT_DATA = Path(__file__).resolve().parents[2] / "tests" / "port_data"
# lanes per block where a tool runs the plain versions at a small size
CPU_BLOCK = 16
# name endings of a result's times and rates, which a CPU run drops
TIMED = ("_s", "_ms", "gcups", "qps", "_per_s", "speedup")
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
ALU_PER_SM_CLK = 64
# the max-type instructions an SW score-only cell needs at least, with the
# DPX forms (engine/csrc/ragged_dp.cu's header)
CELL_MAXES = 3.5


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


def cell_bound_ms(cells: int, maxes: float = CELL_MAXES) -> float:
    """The least milliseconds this card takes for `cells` SW score-only
    cells: `maxes` max-type instructions each on the ALU pipe
    (ALU_PER_SM_CLK per SM per clock), at its SM count and highest SM
    clock."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return cells * maxes / (ALU_PER_SM_CLK * sm_count() * mhz * 1e6) * 1e3


def idle_share(trace_path) -> dict:
    """The card's busy and idle share within a torch.profiler Chrome trace:
    the union of kernel intervals over the span from the first to the last
    event of the trace. Raises if the trace holds no kernel."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and "ts" in e]
    kern = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "kernel")
    if not kern:
        raise RuntimeError(f"{trace_path}: no kernel in the trace")
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in kern:
        if cur_e is None or a > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    return {"trace_window_ms": window / 1e3, "kernel_busy_ms": busy / 1e3,
            "kernels_in_trace": len(kern),
            "device_idle_share": 1 - busy / window}


def sass(name: str, csrc: Path = CSRC) -> dict:
    """{function: [(address, opcode, branch target or None)]} of the built
    library `name` (a probe's, or a kernel's with csrc its sources'
    directory), from `cuobjdump -sass`."""
    from ..engine import _build

    _build.load(name, csrc)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", str(_build.so_path(name, csrc))],
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


def sass_counts(name: str, csrc: Path = CSRC) -> dict:
    """{function: {"all": ..., "loop": ..., "main": ...}} of the built
    library `name` (see sass), each {opcode: count} of SASS_OPS and the
    total: in the whole function; in its hot loop (of the instruction
    ranges from the target of a backward branch to the branch, the one
    densest in max-type instructions, FMNMX included; the innermost on a
    tie); and in its main loop (the innermost range that holds at least
    half the max-type instructions the fullest range holds: a strip-group
    sweep's column loop, whose masked steps branch back early)."""
    out = {}
    for fn, ins in sass(name, csrc).items():
        ranges = []
        for a, op, t in ins:
            if op != "BRA" or not isinstance(t, int) or t > a:
                continue
            body = [i for i in ins if t <= i[0] <= a]
            ranges.append((sum(i[1] in SASS_MAX_OPS + ("FMNMX",)
                               for i in body), body))
        loop = max(ranges, key=lambda r: (r[0] / len(r[1]), -len(r[1])),
                   default=(0, []))[1]
        most = max((n for n, _ in ranges), default=0)
        main = min((r for r in ranges if 2 * r[0] >= most),
                   key=lambda r: len(r[1]), default=(0, []))[1]
        out[fn] = {"all": _count(ins), "loop": _count(loop),
                   "main": _count(main)}
    return out


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for a block (a value of None unsets one),
    and restore them after it."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Mismatch(AssertionError):
    """Two paths that must agree gave different answers."""


def require(cond, what: str) -> None:
    if not cond:
        raise Mismatch(what)


def sync(dev) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def seconds(fn) -> float:
    """Host seconds of fn(), ended by a synchronize of every CUDA device."""
    t0 = time.perf_counter()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def port_query(name: str, lut):
    """The alphabet indices of tests/port_data/<name>.fasta's query."""
    from ..fasta import read_fasta_file

    qs, _ = read_fasta_file(str(PORT_DATA / f"{name}.fasta"), lut)
    return qs[0]


def synth_db(n: int, lut, seed: int = 12071):
    """n synthetic sequences (opal_tpu_torch.synth) as alphabet indices."""
    from ..synth import make_db_arrays

    return [lut[a] for a in make_db_arrays(n, seed=seed)]


def untimed(obj):
    """obj without the keys that hold a time or a rate (TIMED endings), at
    any depth of dicts and lists."""
    if isinstance(obj, dict):
        return {k: untimed(v) for k, v in obj.items()
                if not k.endswith(TIMED)}
    if isinstance(obj, list):
        return [untimed(v) for v in obj]
    return obj


def report(tool: str, dev, res: dict) -> dict:
    """Print a tool's one JSON line: res with the tool, the device and, on
    the card, its name and power limit; a CPU run keeps no time. Returns
    the printed object."""
    cuda = torch.device(dev).type == "cuda"
    out = {"tool": tool, "device": torch.device(dev).type, "measured": cuda,
           **res}
    if cuda:
        out["card"] = nvidia_smi("name,power.limit")
    else:
        out = untimed(out)
    print(json.dumps(out), flush=True)
    return out
