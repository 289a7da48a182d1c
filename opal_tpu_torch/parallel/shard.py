"""The database search over several devices (a port of opal_tpu's
parallel/shard.py).

The database's lanes (independent sequences) are split over a 1D mesh of
devices, the query profile is replicated, and per-sequence results are
gathered: data parallelism over the database, with no traffic between
devices while the DP runs. Two levels:

- ``db_mesh()`` + ``Engine(mesh=...)``: the resident database is cut into
  one part per mesh device (engine/device_db.py), and the ragged_dp and
  multi_dp kernels run once per part, each on its own device's current
  stream;
- ``sharded_score_step``: an explicit step (profile replicated, lanes
  split, per-lane results gathered), the counterpart of opal_tpu's
  shard_map step.

opal_tpu's ``lane_sharding`` and the other ``*_sharding`` helpers are GSPMD
layouts for its xla backend; the port has no such backend, so they have no
counterpart here.

A mesh may name one device several times: several parts then share that
device, as XLA's virtual host devices share the CPU. That is how the CPU
and a single card run a mesh of more than one part.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import SEARCH_SCORE
from ..engine import kernels
from ..engine.search import resolve_device

DB_AXIS = "db"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1D device mesh: one database part per entry of `devices`."""
    devices: tuple            # of torch.device, repeats allowed
    axis_names: tuple = (DB_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def db_mesh(devices=None) -> Mesh:
    """A mesh over every visible CUDA device, or over `devices` (names or
    torch.device, in order, repeats allowed; all CPU or all CUDA). Without
    CUDA the default raises, as the engine's default device does."""
    if devices is None:
        resolve_device("cuda")  # raises without CUDA
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"mesh mixes device types: {devs}")
    return Mesh(devs)


def sharded_score_step(mode, search_type, Q, go, ge, mesh: Mesh):
    """The explicit sharded step: returns step(qprofile [A, Q], letters
    [T, B_total], lengths [1, B_total]) -> {"score"[, "end_q", "end_t"]}
    [B_total] int32 tensors on the mesh's first device, in lane order.
    The lanes are split into mesh.size contiguous slices (as even as
    np.array_split makes them); each slice is one block on its device,
    scored by kernels.ragged_score against the replicated profile."""
    def step(qprofile, letters, lengths):
        qprofile = np.asarray(qprofile, np.int32)
        if qprofile.shape[1] != Q:
            raise ValueError(f"profile of {qprofile.shape[1]} rows, "
                             f"the step was built for Q={Q}")
        profile = torch.from_numpy(kernels.build_profile(qprofile))
        profiles = {}
        outs = []
        for dev, lett, lens in zip(
                mesh.devices,
                np.array_split(np.asarray(letters, np.int8), mesh.size, 1),
                np.array_split(np.asarray(lengths, np.int32), mesh.size, 1)):
            if lett.shape[1] == 0:
                continue
            if dev not in profiles:
                profiles[dev] = profile.to(dev)
            stream = kernels.pack_stream([lett], lens, lett.shape[1], dev)
            tr = kernels.ragged_score(profiles[dev], stream, mode,
                                      search_type, go, ge)
            outs.append(kernels.finalize_device(tr, stream.lengths, mode,
                                                search_type, Q))
        first = mesh.devices[0]
        names = (["score"] if search_type == SEARCH_SCORE
                 else ["score", "end_q", "end_t"])
        return {k: torch.cat([o[k].reshape(-1).to(first) for o in outs])
                for k in names}

    return step
