#!/usr/bin/env python3
"""The port's main path on one card, for comparing two trees in one call.

Run from the root of a checkout (the tree under test), with a label:

    python3 /path/to/ab_main_path.py LABEL

It builds ragged_dp from that checkout, uploads the 541,762 synthetic
sequences (seed 12071), searches O74807 (SW x0, BLOSUM50, gaps 3/1) once to
warm up and 7 more times, times ragged_dp alone with CUDA events, and
prints one JSON line: the label, the best and all search seconds, the
kernel ms and ptxas's registers of the one-sweep instantiations. To
compare a parent tree with a change, unpack the parent (git archive) into
a git-ignored directory and run parent, change, change, parent in one
chip call.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import ptxas_summary, time_cuda  # noqa: E402
from opal_tpu_torch.engine import _build, kernels  # noqa: E402
from opal_tpu_torch.engine.search import (  # noqa: E402
    Engine,
    search_database_arrays,
)
from opal_tpu_torch.fasta import read_fasta_file  # noqa: E402
from opal_tpu_torch.matrices import ScoreMatrix  # noqa: E402
from opal_tpu_torch.synth import make_db_arrays  # noqa: E402


def main():
    log = _build.build_all(("ragged_dp",), report=True)
    sm = ScoreMatrix.blosum50()
    lut = sm.letter_index()
    db = [lut[a] for a in make_db_arrays(541762, seed=12071)]
    eng = Engine(block_size=1024)
    ddb = eng.upload(db)
    query = read_fasta_file(os.path.join("tests", "port_data",
                                         "O74807.fasta"), lut)[0][0]

    def run():
        t = time.perf_counter()
        search_database_arrays(query, ddb, 3, 1, sm.matrix, engine=eng)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run()
    times = [run() for _ in range(7)]
    prof = eng._backend.prepare_query(sm.matrix[query.astype(np.int64)].T,
                                      3, 1)
    kernel_ms = time_cuda(lambda: kernels.ragged_score(
        prof, ddb.stream, 3, 0, 3, 1), 5)
    regs = ptxas_summary(log.get("ragged_dp", {}).get("log", ""))
    print(json.dumps({"tree": sys.argv[1] if len(sys.argv) > 1 else "",
                      "best_s": min(times), "times": times,
                      "kernel_ms": kernel_ms,
                      "ptxas": {k: v for k, v in regs.items()
                                if not k.endswith("_panel")}}), flush=True)


if __name__ == "__main__":
    main()
