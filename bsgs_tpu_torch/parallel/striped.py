"""The scan striped over the ranks of a mesh, in super-epochs.

Counterpart of ``bsgs_tpu/parallel/striped.py``. ``MeshSolver`` subclasses
``models/solver.Solver`` and takes over a base solver's state whole (its
config, table and offset planes, the same tensors); the solve loop, its
epoch (fused or unfused), its read-back and collection, deferred
verification, callbacks and resume are the single card's. What is the
mesh's own: the jobs of an epoch, this rank's stripe of them, the gather
of every rank's hits, and a sharded table's probe.

One epoch of the loop is a super-epoch of n * T jobs: rank r runs jobs
e*n*T + r*T ... + T - 1 through the single card's epoch, then gathers
every rank's hit count and buffer onto its device (one ``all_gather``
queued on the stream) and reads them back as the single card reads its
own (solver.HitReadback, one row a rank: the host waits for that
super-epoch's event alone). Every rank then decodes, verifies and
decides the same things in the same order, so the ranks' collectives
stay matched: an overflow on any rank makes every rank re-run the
super-epoch with the same larger buffer.

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
(counts ``bytes``, gathered onto this rank, and ``ranks``); each rank
keeps its own records.
"""

from __future__ import annotations

import torch

from ..models import solver as S
from ..utils import tracing
from . import sharded_table as st

# probe_routing -> (fused probe, unfused probe) of a sharded table
ROUTES = {
    "all_gather": (st.make_probe, st.make_sharded_probe),
    "all_to_all": (st.make_alltoall_probe_bd, st.make_alltoall_probe),
}


class MeshSolver(S.Solver):
    """Drives the scan over a mesh (parallel/mesh.Mesh) with a base
    Solver's state on this rank's device, taken over whole: its config,
    table and offset planes are the same objects, its centers its own.

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
        vars(self).update(vars(base))
        self.device = mesh.device
        self.mesh = mesh
        self.shard_baby_table = shard_baby_table
        self.probe_routing = probe_routing
        self._centers = S.EpochCenters(self.cfg)
        self._pipelined = False
        self._prev = None
        self._spec = None
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

    @property
    def _jobs_before(self) -> int:
        return self.mesh.rank * self.cfg.jobs_per_epoch

    def _readback(self, idxs, cnt) -> S.HitReadback:
        """Every rank's count and hit buffer, gathered onto this rank's
        device as one 1-D [count, hits...] a rank, read back one row a
        rank."""
        with tracing.span("gather") as sp:
            sp.begin_device(self.device)
            mine = torch.cat((cnt, idxs))
            sp.count("bytes", self.mesh.world * mine.numel()
                     * mine.element_size())
            sp.count("ranks", self.mesh.world)
            gathered = self.mesh.all_gather(mine)
        return S.HitReadback(gathered.view(self.mesh.world, -1))
