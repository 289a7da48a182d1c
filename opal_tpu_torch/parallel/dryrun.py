"""The entry points of __graft_entry__.py on the port: entry(), the
single-block compile check, and dryrun_multichip, the multi-device dry run
(every sharded path of the port, once, on tiny shapes, against the scalar
oracle).

    python -m opal_tpu_torch.parallel.dryrun N [--device cuda|cpu]

runs dryrun_multichip(N) over N mesh devices: the visible CUDA devices
(or the CPU with --device cpu), repeated round-robin when there are fewer
than N distinct ones (several parts then share a device, as opal_tpu's
virtual host devices share the CPU). The steps:

1. the explicit sharded step (parallel/shard.py, sharded_score_step);
2. the engine-level search on the mesh, 4 modes x score / score + end,
   scores and ends against opal_tpu_torch.oracle;
3. a stacked multi-query group on the mesh (multi_dp per part);
4. a query in 16-row panels on the mesh (kernels.PANEL_ROWS = 16 for the
   call);
5. a weak-scaling table: DB sequences per second at 1, 2, 4, ... mesh
   devices with a fixed number of sequences per device;
6. the MultiHostSearch flow in one process (ranked and aligned top k).

Each step checks that every live part ran its kernel (kernels.LAUNCHES on
the card, kernels.PLAIN_CALLS on the CPU). Raises on any mismatch.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..constants import (
    MODE_CODES,
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from ..engine import kernels
from ..engine.search import (
    Engine,
    resolve_device,
    search_database,
    search_database_arrays,
    search_database_multi_arrays,
)
from ..oracle import search_oracle
from .shard import db_mesh, sharded_score_step


def entry(device="cuda"):
    """(fn, example_args): one SW score + end block, __graft_entry__.entry's
    check on the port. The args are drawn as that entry draws them, from
    np.random.default_rng(0), as tensors on `device`: qprofile [24, 110]
    int32 in [-5, 13) (the [A, Q] profile, matrix[query].T), letters
    [256, 128] int8 in [0, 24) and lengths [1, 128] int32 in [32, 256].
    fn(qprofile, letters, lengths) scores the block at gaps 3/1 through
    kernels.grouped_score (ragged_dp's grouped role on the card) and
    returns {"score", "end_q", "end_t"}, each [128] int32. Runs on the
    card unless device="cpu"; without CUDA the default raises."""
    dev = resolve_device(device)
    Q, B, T = 110, 128, 256
    rng = np.random.default_rng(0)
    qprofile = torch.as_tensor(rng.integers(-5, 13, size=(24, Q)),
                               dtype=torch.int32, device=dev)
    letters = torch.as_tensor(rng.integers(0, 24, size=(T, B)),
                              dtype=torch.int8, device=dev)
    lengths = torch.as_tensor(rng.integers(32, T + 1, size=(1, B)),
                              dtype=torch.int32, device=dev)

    def fn(qprofile, letters, lengths):
        profile = torch.from_numpy(kernels.build_profile(
            qprofile.cpu().numpy())).to(qprofile.device)
        tr = kernels.grouped_score(profile, letters[None], lengths, MODE_SW,
                                   SEARCH_SCORE_END, 3, 1)
        cols = kernels.finalize_device(tr, lengths, MODE_SW,
                                       SEARCH_SCORE_END, qprofile.shape[1])
        return {k: cols[k][0] for k in ("score", "end_q", "end_t")}

    return fn, (qprofile, letters, lengths)


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _runs(kernel, plain):
    """Runs so far of a kernel: its launches on the card plus its plain
    version's calls on the CPU."""
    return kernels.LAUNCHES[kernel] + kernels.PLAIN_CALLS[plain]


def mesh_devices(n_devices: int, devices=None):
    """(n_devices torch.devices, distinct count): `devices` (default every
    visible CUDA device) repeated round-robin up to n_devices."""
    if devices is None:
        resolve_device("cuda")  # raises without CUDA
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    distinct = list(dict.fromkeys(resolve_device(d) for d in devices))
    return [distinct[i % len(distinct)] for i in range(n_devices)], \
        len(distinct)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Steps 1-6 of the module docstring over an n_devices mesh; returns a
    summary {"devices", "distinct_devices", "lanes", "scaling": [...]}."""
    devs, distinct = mesh_devices(n_devices, devices)
    kind = devs[0].type
    sync = torch.cuda.synchronize if kind == "cuda" else (lambda: None)
    note = ("" if distinct >= n_devices else
            f" ({distinct} distinct, repeated round-robin)")
    print(f"dryrun_multichip({n_devices}): {n_devices} mesh devices on "
          f"{kind}{note}", flush=True)
    mesh = db_mesh(devs)

    Q, B, T = 24, 8 * n_devices, 64
    rng = np.random.default_rng(7)
    A = 4
    matrix = np.full((A, A), -1, np.int32)
    np.fill_diagonal(matrix, 3)
    query = rng.integers(0, A, size=Q, dtype=np.uint8)
    db = [rng.integers(0, A, size=int(rng.integers(8, T + 1)),
                       dtype=np.uint8) for _ in range(B)]

    def oracle_equal(res, q, m, st, what):
        want = search_oracle(q, db, 3, 1, matrix, m, st)
        for i, (r, w) in enumerate(zip(res, want)):
            _check(r.score == w.score, f"{what}: lane {i} score {r.score}, "
                   f"oracle {w.score}")
            if st == SEARCH_SCORE_END and not (m == MODE_SW
                                               and w.score == 0):
                _check((r.end_location_query, r.end_location_target)
                       == (w.end_location_query, w.end_location_target),
                       f"{what}: lane {i} ends")

    # 1) the explicit step
    step = sharded_score_step(MODE_SW, SEARCH_SCORE_END, Q, 3, 1, mesh)
    letters = np.zeros((T, B), np.int8)
    lengths = np.zeros((1, B), np.int32)
    for i, s in enumerate(db):
        letters[: len(s), i] = s
        lengths[0, i] = len(s)
    qprofile = matrix[query.astype(np.int64)].T.astype(np.int32)
    out = step(qprofile, letters, lengths)
    want = search_oracle(query, db, 3, 1, matrix, MODE_SW, SEARCH_SCORE_END)
    _check(out["score"].cpu().tolist() == [w.score for w in want],
           "the explicit step's scores")
    print(f"  explicit sharded step: OK ({B} lanes / {n_devices} devices)")

    # 2) the engine on the mesh: every part runs its kernel
    eng = Engine(device=kind, block_size=4, mesh=mesh)
    ddb = eng.upload(db)
    live = sum(1 for p in ddb.parts if p.blocks)
    _check(live >= min(2, n_devices), f"{live} live parts of "
           f"{len(ddb.parts)}: the mesh did not split the database")
    names = {v: k for k, v in MODE_CODES.items()}
    for m in (MODE_SW, MODE_NW, MODE_HW, MODE_OV):
        for st in (SEARCH_SCORE, SEARCH_SCORE_END):
            before = _runs("ragged_dp", "ragged_score_plain")
            res = search_database(query, ddb, 3, 1, matrix, mode=m,
                                  search_type=st, engine=eng)
            _check(_runs("ragged_dp", "ragged_score_plain") - before
                   >= live, f"{names[m]} x{st}: not every part ran")
            oracle_equal(res, query, m, st, f"{names[m]} x{st}")
            print(f"  mesh search {names[m]} x{st}: OK ({len(db)} lanes in "
                  f"{live} parts)")

    # 3) a stacked group: multi_dp on every part
    queries = [rng.integers(0, A, size=q, dtype=np.uint8)
               for q in (18, 30, 24)]
    before = _runs("multi_dp", "multi_score_plain")
    outs = search_database_multi_arrays(queries, ddb, 3, 1, matrix,
                                        mode=MODE_SW,
                                        search_type=SEARCH_SCORE_END,
                                        engine=eng)
    _check(_runs("multi_dp", "multi_score_plain") - before >= live,
           "stacked group: not every part ran multi_dp")
    for q, cols in zip(queries, outs):
        want_q = search_oracle(q, db, 3, 1, matrix, MODE_SW,
                               SEARCH_SCORE_END)
        _check(cols["score"].tolist() == [w.score for w in want_q],
               "stacked group scores")
    print(f"  stacked multi-query: OK ({len(queries)} queries / "
          f"{n_devices} devices)")

    # 4) query panels on the mesh
    saved = kernels.PANEL_ROWS
    kernels.PANEL_ROWS = 16
    try:
        q_long = rng.integers(0, A, size=40, dtype=np.uint8)
        before = _runs("ragged_dp_panel", "ragged_panel_plain")
        res = search_database(q_long, ddb, 3, 1, matrix, mode=MODE_SW,
                              search_type=SEARCH_SCORE_END, engine=eng)
        _check(_runs("ragged_dp_panel", "ragged_panel_plain") - before
               >= 3 * live, "panels: not every part ran its 3 panels")
        oracle_equal(res, q_long, MODE_SW, SEARCH_SCORE_END, "panels")
    finally:
        kernels.PANEL_ROWS = saved
    print(f"  query panels: OK (Q=40 in 16-row panels / {n_devices} "
          "devices)")

    # 5) weak scaling: a fixed number of sequences per device
    per_dev = 16 * B
    print(f"  weak-scaling table ({per_dev} seqs/device)" + (
        "" if distinct >= n_devices else
        " [devices repeated on one: checks the partitioning, not the "
        "speedup]"))
    scaling = []
    n = 1
    while n <= n_devices:
        db_big = [rng.integers(0, A, size=int(rng.integers(16, 2 * T)),
                               dtype=np.uint8) for _ in range(per_dev * n)]
        eng_n = Engine(device=kind, block_size=max(8, B),
                       mesh=db_mesh(devs[:n]))
        ddb_n = eng_n.upload(db_big)
        search_database_arrays(query, ddb_n, 3, 1, matrix, mode=MODE_SW,
                               search_type=SEARCH_SCORE_END, engine=eng_n)
        sync()
        t0 = time.perf_counter()
        search_database_arrays(query, ddb_n, 3, 1, matrix, mode=MODE_SW,
                               search_type=SEARCH_SCORE_END, engine=eng_n)
        sync()
        dt = time.perf_counter() - t0
        row = {"devices": n, "seqs": len(db_big), "seconds": dt,
               "seqs_per_s": len(db_big) / dt,
               "seqs_per_s_per_device": len(db_big) / dt / n}
        scaling.append(row)
        print(f"    devices={n}: {len(db_big)} seqs in {dt * 1e3:,.1f} ms "
              f"= {row['seqs_per_s']:,.0f} seqs/s total, "
              f"{row['seqs_per_s_per_device']:,.0f} seqs/s/device")
        n *= 2

    # 6) the multi-process flow in one process
    from ..matrices import ScoreMatrix
    from .multihost import MultiHostSearch, shard_for_process

    _check(shard_for_process(["a", "b", "c"], 0, 2) == ["a", "c"],
           "shard_for_process")
    sm = ScoreMatrix.blosum50()
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for s in range(2):
            p = os.path.join(td, f"shard{s}.fa")
            with open(p, "w") as f:
                for i in range(6):
                    seq = "".join(sm.alphabet[j] for j in rng.integers(
                        0, 20, size=int(rng.integers(20, 60))))
                    f.write(f">s{s}_{i}\n{seq}\n")
            paths.append(p)
        mh = MultiHostSearch(db_paths=paths, matrix=sm, local_mesh=mesh,
                             device=kind)
        mq = rng.integers(0, 20, size=30, dtype=np.uint8)
        ranked = mh.ranked(mq, top_k=5, search_type=SEARCH_SCORE_END)
        _check(len(ranked) == 5 and ranked[0][0] >= ranked[-1][0],
               "multihost ranked top 5")
        aligned = mh.search_aligned(mq, top_k=3)
        _check(len(aligned) == 3 and all(
            w["ops"] is not None or w["score"] == 0 for w in aligned),
            "multihost aligned top 3")
    print("  multihost ranked + aligned top-k merge: OK")
    print(f"dryrun_multichip({n_devices}): OK - {B} sequences over "
          f"{n_devices} mesh devices ({distinct} distinct): explicit step, "
          "4 modes x x0/x1, stacked multi-query, panels, scaling table, "
          "multihost flow", flush=True)
    return {"devices": n_devices, "distinct_devices": distinct,
            "lanes": B, "live_parts": live, "scaling": scaling}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    dryrun_multichip(a.n_devices,
                     ["cpu"] if a.device == "cpu" else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
