#!/usr/bin/env python3
"""The port's kernels on their user paths on one card, for comparing two
trees in one call.

Run from the root of a checkout (the tree under test), with a label and,
optionally, --no-long to leave out the 100,000-residue query, or
--kernels-only to print only the kernels' build facts (the last item):

    python3 /path/to/ab_main_path.py LABEL [--no-long | --kernels-only]

It builds the kernels from that checkout, uploads the 541,762 synthetic
sequences (seed 12071) as a server's resident database, and prints one
JSON line with, for that tree:

- main: the main path, O74807 (SW x0, BLOSUM50, gaps 3/1) through
  search_database_arrays, best and all of 7 searches after a warm-up, and
  ragged_dp alone (CUDA events, mean of 5) with its per-launch split;
- flags: ragged_dp with the overflow-flag rows, the same search (SW x0);
- multi: multi_dp on the first stacked group of 8 of the 15 queries of
  tests/port_data/uniprot_sprot15.fasta (mean of 3), and that batch as one
  served request (best of 3, cache cleared);
- grouped: grouped_score on 64 dense blocks around the database's median
  length (mean of 5);
- long: the 100,000-residue query (synth.FREQ, seed 100,000) through the
  panel role, one run, kernel ms summed over its launches;
- ptxas's registers of the kernels' SW instantiations (of every
  instantiation of ragged_dp and multi_dp with --kernels-only), and per
  function of those two libraries (with --kernels-only device_fill's too)
  its SASS instruction count and a digest of its SASS text (cuobjdump
  -sass, addresses and encodings left out), so two trees' builds compare
  instruction for instruction.

To compare a parent tree with a change, unpack the parent (git archive)
into a git-ignored directory and run parent, change, change, parent in one
chip call.
"""
import hashlib
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    dense_blocks,
    long_query,
    multi_profile,
    ptxas_summary,
    read_queries,
    time_cuda,
)
from opal_tpu_torch.engine import _build, kernels  # noqa: E402
from opal_tpu_torch.engine.search import (  # noqa: E402
    plan_groups,
    search_database_arrays,
)
from opal_tpu_torch.fasta import read_fasta_file  # noqa: E402
from opal_tpu_torch.matrices import ScoreMatrix  # noqa: E402
from opal_tpu_torch.serve import Server  # noqa: E402
from opal_tpu_torch.synth import make_db_arrays  # noqa: E402


def launch_ms(fn):
    """(total kernel ms, [ms per launch]) of one fn(events=...) call."""
    events = []
    fn(events)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for *_, a, b in events]
    return sum(ms), ms


def sass_facts(name):
    """{function: [SASS instruction count, digest of its SASS text]} of
    this tree's built library `name`."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(_build.so_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ins, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:  # the anonymous namespace's name depends on the file's path
            fn = ins.setdefault(re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL_",
                                       m.group(1)), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*(?:/\*.*)?$", ln)
        if m and fn is not None:
            fn.append(m.group(1))
    return {f: [len(v), hashlib.sha256("\n".join(v).encode()).hexdigest()
                [:16]] for f, v in ins.items()}


def kernel_facts(log, every=False):
    """ptxas's registers of ragged_dp's and multi_dp's instantiations (the
    SW ones unless `every`) and their SASS facts (with `every`, device_fill's
    too, whose source includes no shared header)."""
    regs = {k: ptxas_summary(v.get("log", "")) for k, v in log.items()}
    return {"ptxas": {k: {n: r for n, r in v.items()
                          if every or n.startswith("mode3")}
                      for k, v in regs.items()
                      if k in ("ragged_dp", "multi_dp")},
            "sass": {k: sass_facts(k) for k in ("ragged_dp", "multi_dp") + (
                ("device_fill",) if every else ())}}


def main():
    label = sys.argv[1] if len(sys.argv) > 1 else ""
    log = _build.build_all(report=True)
    if "--kernels-only" in sys.argv:
        print(json.dumps({"tree": label,
                          "card": torch.cuda.get_device_name(0),
                          **kernel_facts(log, every=True)}), flush=True)
        return
    sm = ScoreMatrix.blosum50()
    lut = sm.letter_index()
    db = [lut[a] for a in make_db_arrays(541762, seed=12071)]
    srv = Server.from_sequences(db, [str(i) for i in range(len(db))], sm,
                                block_size=1024, device="cuda")
    ddb, eng, matrix = srv.ddb, srv.engine, sm.matrix
    query = read_fasta_file(os.path.join("tests", "port_data",
                                         "O74807.fasta"), lut)[0][0]
    out = {"tree": label, "card": torch.cuda.get_device_name(0)}

    def run():
        t = time.perf_counter()
        search_database_arrays(query, ddb, 3, 1, matrix, engine=eng)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run()
    times = [run() for _ in range(7)]
    prof = eng._backend.prepare_query(matrix[query.astype(np.int64)].T, 3, 1)
    split = launch_ms(lambda ev: kernels.ragged_score(
        prof, ddb.stream, 3, 0, 3, 1, events=ev))[1]
    out["main"] = {"best_s": min(times), "times": times,
                   "kernel_ms": time_cuda(lambda: kernels.ragged_score(
                       prof, ddb.stream, 3, 0, 3, 1), 5),
                   "launch_ms": split}
    out["flags"] = {"kernel_ms": time_cuda(lambda: kernels.ragged_score(
        prof, ddb.stream, 3, 0, 3, 1, True), 5)}

    texts = read_queries(os.path.join("tests", "port_data",
                                      "uniprot_sprot15.fasta"))
    qs = [srv._encode_query(t) for t in texts]
    group = [qs[p] for p in plan_groups(qs, lambda g: True)[0]]
    mprof, seg_qs = multi_profile(matrix, group, ddb.device)
    line = json.dumps({"id": "batch", "queries": texts, "top_k": 10})
    srv._respond(line)
    batch_s = []
    for _ in range(3):
        srv._cache.clear()
        t = time.perf_counter()
        srv._respond(line)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t)
    out["multi"] = {"group_rows": sum(seg_qs),
                    "kernel_ms": time_cuda(lambda: kernels.multi_score(
                        mprof, seg_qs, ddb.stream, 3, 0, 3, 1), 3),
                    "serve_batch_best_s": min(batch_s),
                    "serve_batch_s": batch_s}

    G = min(64, len(ddb.blocks))
    letters, lengths = dense_blocks(ddb, (len(ddb.blocks) - G) // 2, G)
    gprof = torch.from_numpy(kernels.build_profile(
        matrix[query.astype(np.int64)].T)).to(ddb.device)
    out["grouped"] = {"kernel_ms": time_cuda(lambda: kernels.grouped_score(
        gprof, letters, lengths, 3, 0, 3, 1), 5)}

    if "--no-long" not in sys.argv:
        lq, _ = long_query(sm, 100_000, 100_000)
        lprof = eng._backend.prepare_query(matrix[lq.astype(np.int64)].T,
                                           3, 1)
        t = time.perf_counter()
        total, ms = launch_ms(lambda ev: kernels.ragged_panel_score(
            lprof, ddb.stream, 3, 0, 3, 1, events=ev))
        out["long"] = {"kernel_ms": total, "launches": len(ms),
                       "launch_ms_max": max(ms),
                       "wall_s": time.perf_counter() - t}
    out.update(kernel_facts(log))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
