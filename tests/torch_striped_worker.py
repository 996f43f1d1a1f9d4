"""One rank of a world of four of the port's ranks on the CPU (gloo), for
tests/test_torch_striped_four.py: MeshSolver over a table every rank holds
whole (shard_baby_table False, probe_routing all_gather, the four-card
benchmark cell's mesh options) solves seeded keys, recording

- each solve's pubkey and returned key;
- the jobs of every epoch this rank queued: the super-epoch, the first
  job and the count it asked centers for, and each center's x;
- the hit count this rank put into each super-epoch's gather;
- the recorder's ``gather`` and ``collect`` spans (utils/tracing).

Usage: python torch_striped_worker.py <address> <rank> <seed> <dir>

The rank writes what it found to <dir>/rank<rank>.json. Imports torch and
the port only.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bsgs_tpu_torch.models import solver as S  # noqa: E402
from bsgs_tpu_torch.parallel import mesh as M, striped  # noqa: E402
from bsgs_tpu_torch.utils import ecpy, tracing  # noqa: E402

torch.set_num_threads(1)

WORLD = 4
GEOM = dict(w=256, htsz=6, n_offsets=8, jobs_per_epoch=2, window=16,
            chunk_c=2, lanes_w=4, epoch_phases=1, pipeline=2)
PK = 1 << 21
SUPERS = 3  # super-epochs a range


def keys_of(seed: int, cfg) -> list:
    """Three keys in [PK, PK + SUPERS super-epochs): the first in the last
    super-epoch, so that its solve queues every earlier one."""
    per = WORLD * cfg.jobs_per_epoch * cfg.jobs_span * cfg.stride
    rng = np.random.default_rng(seed)
    last = PK + (SUPERS - 1) * per + int(rng.integers(0, per))
    return [last] + [PK + int(k) for k in rng.integers(0, SUPERS * per, 2)]


def main(address, rank, seed, where):
    M.init_distributed(address, WORLD, rank, backend="gloo")
    try:
        mesh = M.make_mesh(WORLD, device="cpu")
        cfg = S.SolverConfig(**GEOM)
        ms = striped.MeshSolver(S.Solver(cfg, device="cpu"), mesh,
                                shard_baby_table=False,
                                probe_routing="all_gather")
        now = {}  # the solve and super-epoch being queued
        jobs, local = [], []
        epoch, centers, gather = ms._epoch, ms.epoch_centers, mesh.all_gather

        def logged_epoch(q0, e, hit_cap=None):
            now["epoch"] = e
            return epoch(q0, e, hit_cap)

        def logged_centers(q0, first_job, n_jobs):
            cx, cy, cinf = centers(q0, first_job, n_jobs)
            xs = [hex(sum(int(v) << (16 * i) for i, v in enumerate(row)))
                  for row in cx]
            jobs.append(dict(solve=now["solve"], epoch=now["epoch"],
                             first_job=first_job, n_jobs=n_jobs, xs=xs))
            return cx, cy, cinf

        def logged_gather(t):
            local.append(dict(solve=now["solve"], epoch=now["epoch"],
                              count=int(t[0])))
            return gather(t)

        ms._epoch, ms.epoch_centers = logged_epoch, logged_centers
        mesh.all_gather = logged_gather
        tracing.clear()
        tracing.enable()
        solves, spans = [], []
        pke = PK + SUPERS * WORLD * cfg.jobs_per_epoch * cfg.jobs_span \
            * cfg.stride - 1
        for i, k in enumerate(keys_of(seed, cfg)):
            now["solve"] = i
            pub = ecpy.mul(k)
            res = ms.solve(pub, PK, pke)
            solves.append(dict(key=k, pub=[hex(pub[0]), hex(pub[1])],
                               found=res.key))
            spans += [dict(solve=i, name=s.name, epoch=s.epoch,
                           counts=s.counts or {})
                      for s in tracing.records()
                      if s.name in ("gather", "collect")]
            tracing.clear()
        tracing.disable()
        with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
            json.dump(dict(rank=rank, jobs_per_epoch=cfg.jobs_per_epoch,
                           hit_cap=cfg.hit_cap, solves=solves, jobs=jobs,
                           local=local, spans=spans), f)
    finally:
        M.close()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
