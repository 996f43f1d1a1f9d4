"""The scan striped over the ranks of a mesh, in super-epochs.

Counterpart of ``bsgs_tpu/parallel/striped.py``. ``MeshSolver`` subclasses
``models/solver.Solver`` and overrides only the epoch's dispatch, its
collection and the jobs of an epoch, so the solve loop, its pipelining,
deferred verification, callbacks and resume are the single card's.

One epoch of the loop is a super-epoch of n * T jobs: rank r runs jobs
e*n*T + r*T ... + T - 1 through the single card's epoch (fused, or
unfused when the base solver is: giant.epoch_probes), then
gathers every rank's hit count and buffer onto its device (one
``all_gather`` queued on the stream: the host does not wait). Every
rank then decodes, verifies and decides the same things in the same
order, so the ranks' collectives stay matched: an overflow on any rank
makes every rank re-run the super-epoch with the same larger buffer.

The table is either held whole by every rank (the epoch is then exactly
the single card's) or split by bucket range (sharded_table), when each
probe goes through one of its collective routes, as bsgs_tpu's
``probe_routing`` picks it: all_gather (the default; by (bucket, disc)
keys in the fused epoch, sharded_table.make_probe, by (hi, lo) prefixes
in the unfused one, make_sharded_probe) or all_to_all
(make_alltoall_probe_bd, make_alltoall_probe). Every rank probes streams
of the same lengths, so the collectives stay matched, an overflow re-run
included.

The spans of the single card's loop (utils/tracing) are recorded under
the same names, with the hit gather as ``gather`` inside ``epoch``
(counts ``bytes``, gathered onto this rank, and ``ranks``) and
``collect`` counting ``ranks_with_hits``; each rank keeps its own
records.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import giant, solver as S
from ..ops import _cuda
from ..utils import tracing
from . import sharded_table as st

# probe_routing -> (fused probe, unfused probe) of a sharded table
ROUTES = {
    "all_gather": (st.make_probe, st.make_sharded_probe),
    "all_to_all": (st.make_alltoall_probe_bd, st.make_alltoall_probe),
}


class MeshSolver(S.Solver):
    """Drives the scan over a mesh (parallel/mesh.Mesh), adopting a base
    Solver's config, table and offsets on this rank's device.

    shard_baby_table splits the dense table by bucket range over the
    ranks: a table built sharded (sharded_table.build_sharded_table) must
    be split over exactly this mesh; a table held whole is split here into
    mesh.world shards (shard_table). probe_routing names the collective
    route of a sharded table's probes (ROUTES); it has no effect on a
    table held whole, as in bsgs_tpu, and a name not in ROUTES raises,
    where bsgs_tpu takes it for all_gather. Cross-epoch pipelining stays
    off, as in bsgs_tpu: a super-epoch's hits are gathered as it ends."""

    def __init__(self, base: S.Solver, mesh,
                 shard_baby_table: bool = False,
                 probe_routing: str = "all_gather"):
        if probe_routing not in ROUTES:
            raise ValueError(f"probe_routing {probe_routing!r}: not one of "
                             f"{sorted(ROUTES)}")
        if base.ox_pl.device != mesh.device:
            raise ValueError(f"the solver is on {base.ox_pl.device}, this "
                             f"rank on {mesh.device}")
        self.device = mesh.device
        self.cfg = base.cfg
        self.baby = base.baby
        self.ox_pl, self.oy_pl = base.ox_pl, base.oy_pl
        self.ox_pk, self.oy_pk = base.ox_pk, base.oy_pk
        self.fused = base.fused
        if not self.fused:
            self.ox, self.oy = base.ox, base.oy
        self._centers = S.EpochCenters(self.cfg)
        self._pipelined = False
        self._prev = None
        self._phases = base._phases
        self.mesh = mesh
        self.shard_baby_table = shard_baby_table
        self.probe_routing = probe_routing
        self._spec = None
        # the fused epoch probes (bucket, disc) keys, the unfused one
        # (hi, lo) prefixes
        self._probe = (giant.dense_probe(self.baby.rows) if self.fused
                       else giant.make_probe(self.baby.rows,
                                             htsz=self.cfg.htsz))
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
            fused_probe, unfused_probe = ROUTES[probe_routing]
            self._probe = (fused_probe if self.fused
                           else unfused_probe)(self._spec, mesh)

    @property
    def _jobs_per_super(self) -> int:
        return self.cfg.jobs_per_epoch * self.mesh.world

    def _epoch(self, q0, epoch: int, hit_cap: Optional[int] = None):
        """Queue this rank's T jobs of super-epoch ``epoch`` and the gather
        of every rank's hits; returns (epoch, first_job, every rank's count
        and hit buffer (n*(1+cap),) on the device, giant_steps of all
        ranks)."""
        cfg = self.cfg
        first_job = epoch * self._jobs_per_super
        cap = hit_cap or cfg.hit_cap
        with tracing.span("epoch", epoch) as sp:
            sp.count("T", cfg.jobs_per_epoch)
            cx, cy, cinf = self._centers_on_device(
                q0, first_job + self.mesh.rank * cfg.jobs_per_epoch)
            with tracing.span("launch") as sp:
                sp.delta("launches", _cuda.total_launches)
                if self.fused:
                    idxs, cnt = giant.fused_epoch_probes(
                        cx, cy, cinf, self.ox_pk, self.oy_pk, self._probe,
                        htsz=cfg.htsz, chunk_c=cfg.chunk_c,
                        lanes_w=cfg.lanes_w, hit_cap=cap,
                        phases=self._phases)
                else:
                    idxs, cnt = giant.epoch_probes(
                        cx, cy, cinf, self.ox, self.oy, self._probe,
                        hit_cap=cap)
            with tracing.span("gather") as sp:
                sp.begin_device(self.device)
                mine = torch.cat((cnt, idxs))
                sp.count("bytes", self.mesh.world * mine.numel()
                         * mine.element_size())
                sp.count("ranks", self.mesh.world)
                gathered = self.mesh.all_gather(mine)
        gs = (2 * cfg.n_offsets + 1) * self._jobs_per_super
        return epoch, first_job, gathered, gs

    def _collect(self, pub, pk: int, rec):
        """Decode every rank's hits of one super-epoch, rank c's jobs
        starting at first_job + c*T; raises HitOverflow, on every rank,
        when any rank's buffer was too small."""
        e, first_job, gathered, gs = rec
        n = self.mesh.world
        gathered = gathered.view(n, -1)
        with tracing.span("collect", e) as sp:
            with tracing.span("wait") as sw:
                sw.count("queued", len(self._behind))
                sw.anchor(gathered.device)
                cnts = gathered[:, 0].cpu().numpy()
            sp.count("ranks_with_hits", int((cnts > 0).sum()))
            cap = gathered.shape[1] - 1
            if int(cnts.max()) > cap:
                raise S.HitOverflow(int(cnts.max()))
            batch = []
            if cnts.any():
                bufs = gathered[:, 1:].cpu().numpy()
                for c in range(n):
                    if cnts[c]:
                        batch += self._records(
                            pub, pk,
                            first_job + c * self.cfg.jobs_per_epoch, bufs[c])
            sp.count("hits", len(batch))
        return batch, gs
