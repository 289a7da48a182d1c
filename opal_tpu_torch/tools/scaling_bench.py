"""DB throughput over a device mesh: DB sequences per second at 1, 2, 4,
... mesh devices (the card's counterpart of tools/scaling_bench.py).

    python -m opal_tpu_torch.tools.scaling_bench [--n-seqs 40000]
        [--query-len 110] [--mesh 4] [--block-size 1024]
        [--reps 3] [--device cuda|cpu]

The database (opal_tpu_torch.synth, seed 12071) is resident in one part per
mesh device (Engine(mesh=...)); an SW score-only search of a random query
(BLOSUM50, gaps 3/1) runs once to warm up, then `reps` times, each ended
by torch.cuda.synchronize(); the best run counts. One JSON line per mesh
size. The mesh's devices are the visible CUDA devices, repeated
round-robin: with fewer devices than parts, several parts share a card
and the table checks the partitioning, not the speedup, as each line's
note says. On the CPU (`--device cpu`) the plain versions run and no
time is reported.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..constants import MODE_SW, SEARCH_SCORE
from ..engine.search import Engine, search_database_arrays
from ..matrices import ScoreMatrix
from ..parallel.dryrun import mesh_devices
from ..parallel.shard import db_mesh
from ..synth import make_db_arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-seqs", type=int, default=40000)
    ap.add_argument("--query-len", type=int, default=110)
    ap.add_argument("--mesh", type=int, default=4,
                    help="the largest mesh, in devices")
    ap.add_argument("--block-size", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)

    cuda = a.device == "cuda"
    devs, _ = mesh_devices(a.mesh, None if cuda else ["cpu"])
    name = torch.cuda.get_device_name(devs[0]) if cuda else "cpu"
    sm = ScoreMatrix.blosum50()
    lut = sm.letter_index()
    db = [lut[s] for s in make_db_arrays(a.n_seqs, seed=12071)]
    residues = sum(len(s) for s in db)
    query = np.random.default_rng(0).integers(0, 20, size=a.query_len,
                                              dtype=np.uint8)
    n = 1
    while n <= a.mesh:
        engine = Engine(device=a.device, block_size=a.block_size,
                        mesh=db_mesh(devs[:n]))
        ddb = engine.upload(db)

        def run():
            t = time.perf_counter()
            search_database_arrays(query, ddb, 3, 1, sm.matrix, mode=MODE_SW,
                                   search_type=SEARCH_SCORE, engine=engine)
            if cuda:
                torch.cuda.synchronize()
            return time.perf_counter() - t

        run()
        best = min(run() for _ in range(a.reps))
        row = {"devices": n,
               "distinct_devices": len(set(devs[:n])),
               "device": name, "n_seqs": len(db), "blocks": len(ddb.blocks),
               "parts_with_blocks": sum(1 for p in ddb.parts if p.blocks)}
        if cuda:
            row.update(seconds=best, db_seqs_per_sec=len(db) / best,
                       gcups=residues * a.query_len / best / 1e9)
        if row["distinct_devices"] < n:
            row["note"] = (f"{n} parts on {row['distinct_devices']} "
                           "device(s): checks the partitioning, not the "
                           "speedup")
        print(json.dumps(row), flush=True)
        n *= 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
