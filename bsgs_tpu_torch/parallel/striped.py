"""The scan striped over the ranks of a mesh, in super-epochs.

Counterpart of ``bsgs_tpu/parallel/striped.py``. ``MeshSolver`` subclasses
``models/solver.Solver`` and overrides only the epoch's dispatch, its
collection and the epoch count, so the solve loop, its pipelining,
deferred verification, callbacks and resume are the single card's.

One epoch of the loop is a super-epoch of n * T jobs: rank r runs jobs
e*n*T + r*T ... + T - 1 through the single card's fused epoch, then
gathers every rank's hit count and buffer onto its device (one
``all_gather`` queued on the stream: the host does not wait). Every
rank then decodes, verifies and decides the same things in the same
order, so the ranks' collectives stay matched: an overflow on any rank
makes every rank re-run the super-epoch with the same larger buffer.

The table is either held whole by every rank (the epoch is then exactly
the single card's) or split by bucket range (sharded_table), when each
probe goes through the all_gather route.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import giant, solver as S
from . import sharded_table as st


class MeshSolver(S.Solver):
    """Drives the scan over a mesh (parallel/mesh.Mesh), adopting a base
    Solver's config, table and offsets on this rank's device.

    shard_baby_table splits the dense table by bucket range over the
    ranks: a table built sharded (sharded_table.build_sharded_table) must
    be split over exactly this mesh; a table held whole is split here into
    mesh.world shards (shard_table). Cross-epoch pipelining is not ported,
    here or on one card."""

    def __init__(self, base: S.Solver, mesh,
                 shard_baby_table: bool = False):
        if base.ox_pl.device != mesh.device:
            raise ValueError(f"the solver is on {base.ox_pl.device}, this "
                             f"rank on {mesh.device}")
        self.device = mesh.device
        self.cfg = base.cfg
        self.baby = base.baby
        self.ox_pl, self.oy_pl = base.ox_pl, base.oy_pl
        self.center_step = base.center_step
        self._phases = base._phases
        self.mesh = mesh
        self.shard_baby_table = shard_baby_table
        self._spec = None
        self._probe = giant.dense_probe(self.baby.dense)
        if self.baby.shard is not None:
            if not shard_baby_table:
                raise ValueError("a table built sharded is probed only "
                                 "through shard_baby_table=True")
            if self.baby.n_table_shards != mesh.world:
                raise ValueError(
                    f"table is sharded over {self.baby.n_table_shards} "
                    f"ranks but the mesh has {mesh.world}")
            self._spec = st.spec_from_presharded(self.baby)
        elif shard_baby_table:
            self._spec = st.shard_table(self.baby, mesh.world, mesh.rank)
        if self._spec is not None:
            self._probe = st.make_probe(self._spec, mesh)

    @property
    def _jobs_per_super(self) -> int:
        return self.cfg.jobs_per_epoch * self.mesh.world

    def _dispatch(self, q0, epoch: int, hit_cap: Optional[int] = None):
        """Queue this rank's T jobs of super-epoch ``epoch`` and the gather
        of every rank's hits; returns (epoch, first_job, every rank's count
        and hit buffer (n*(1+cap),) on the device, giant_steps of all
        ranks)."""
        cfg = self.cfg
        first_job = epoch * self._jobs_per_super
        cx, cy, cinf = self._centers_on_device(
            q0, first_job + self.mesh.rank * cfg.jobs_per_epoch)
        idxs, cnt = giant.fused_epoch_probes(
            cx, cy, cinf, self.ox_pl, self.oy_pl, self._probe,
            htsz=cfg.htsz, chunk_c=cfg.chunk_c, lanes_w=cfg.lanes_w,
            hit_cap=hit_cap or cfg.hit_cap, phases=self._phases)
        gs = (2 * cfg.n_offsets + 1) * self._jobs_per_super
        gathered = self.mesh.all_gather(torch.cat((cnt, idxs)))
        return epoch, first_job, gathered, gs

    def _collect(self, pub, pk: int, rec):
        """Decode every rank's hits of one super-epoch, rank c's jobs
        starting at first_job + c*T; raises HitOverflow, on every rank,
        when any rank's buffer was too small."""
        _, first_job, gathered, gs = rec
        n = self.mesh.world
        gathered = gathered.view(n, -1)
        cnts = gathered[:, 0].cpu().numpy()
        cap = gathered.shape[1] - 1
        if int(cnts.max()) > cap:
            raise S.HitOverflow(int(cnts.max()))
        batch = []
        if cnts.any():
            bufs = gathered[:, 1:].cpu().numpy()
            for c in range(n):
                if cnts[c]:
                    batch += self._records(
                        pub, pk, first_job + c * self.cfg.jobs_per_epoch,
                        bufs[c])
        return batch, gs

    def _total_epochs(self, pk: int, pke: int) -> int:
        cfg = self.cfg
        m_max = (pke - pk) // cfg.stride + 1
        total_jobs = (m_max + cfg.jobs_span) // cfg.jobs_span + 1
        return -(-total_jobs // self._jobs_per_super)
