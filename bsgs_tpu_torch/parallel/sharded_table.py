"""A baby table split by bucket range over the ranks: its build, its
lookups and its probes.

Counterpart of ``bsgs_tpu/parallel/sharded_table.py`` and of
``build_baby_table_streamed_sharded`` in ``bsgs_tpu/models/table.py``.
Rank s holds rows [s * bps, (s + 1) * bps) of the dense matrix,
bps = 2^htsz / n, so n cards hold a table n times the size one could.
``build_sharded_table`` builds each rank's rows on its own card, and a
lookup reads a row from the rank that owns it.

A probe stream is answered from its (bucket, disc) keys by one of two
routes, each two collectives a stream (parallel/mesh.Mesh):
- all_gather (``make_probe``): every rank gathers every rank's keys
  (buckets and discs in one collective), answers those of its own rows,
  the answers are OR-reduced (a max over uint8), and each rank keeps its
  own segment;
- all_to_all (``make_alltoall_probe_bd``): each key is sent to the one
  rank that owns its bucket, in segments of ``alltoall_cap`` keys a
  destination (route_keys, received_keys), answered there and sent back
  (route_back); a key that finds its segment full comes back found, and
  the host's exact verification rejects it. It moves 1/n of the
  all_gather route's keys but sorts and scatters each stream; which wins
  depends on the link between cards.

Each route's local answer is the probe kernel (ops/probe_kernel.probe_rows)
on the rank's own rows (probe_own_rows). The unfused epoch probes (hi, lo)
prefixes: ``make_sharded_probe`` and ``make_alltoall_probe`` split them
into keys for the two routes. ``*_in_process`` runs n ranks' shares of
either route in one process with the exchanges made by hand.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import solver as S, table as T
from ..models.table import BabyTable
from ..ops import planar as PL, probe_kernel


@dataclasses.dataclass
class ShardedTableSpec:
    """Shard ``shard`` of a table split into n_shards bucket ranges: its
    dense rows, their lengths and every shard's entry count."""

    htsz: int
    window: int
    n_shards: int
    shard: int
    dense: torch.Tensor  # (buckets_per_shard, window) int32: own rows
    row_len: torch.Tensor  # (buckets_per_shard,): their entry counts
    shard_entries: np.ndarray  # (n_shards,) int64

    @property
    def buckets_per_shard(self) -> int:
        return (1 << self.htsz) // self.n_shards

    @property
    def row0(self) -> int:
        return self.shard * self.buckets_per_shard


def _shard_entries(table: BabyTable, n_shards: int) -> np.ndarray:
    bps = (1 << table.htsz) // n_shards
    off = PL.u32_value(table.offsets).cpu().numpy()
    return off[bps::bps] - off[:-1:bps]


def shard_table(table: BabyTable, n_shards: int,
                shard: int = 0) -> ShardedTableSpec:
    """Shard ``shard`` of a table held whole on this rank, split into
    n_shards bucket ranges (its rows and their lengths are views of
    table.dense and table.row_len)."""
    if table.shard is not None:
        raise ValueError("the table is already sharded: use "
                         "spec_from_presharded")
    nb = 1 << table.htsz
    if nb % n_shards or not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} of {n_shards}: 2^{table.htsz} "
                         f"buckets do not split evenly")
    own = slice(shard * (nb // n_shards), (shard + 1) * (nb // n_shards))
    return ShardedTableSpec(
        htsz=table.htsz, window=table.window, n_shards=n_shards, shard=shard,
        dense=table.dense[own], row_len=table.row_len[own],
        shard_entries=_shard_entries(table, n_shards))


def spec_from_presharded(table: BabyTable) -> ShardedTableSpec:
    """The spec of a table built split over the ranks
    (build_sharded_table): table.dense and table.row_len are already this
    rank's rows; the whole matrix exists on no device."""
    if table.shard is None:
        raise ValueError("the table was not built sharded")
    return ShardedTableSpec(
        htsz=table.htsz, window=table.window,
        n_shards=table.n_table_shards, shard=table.shard, dense=table.dense,
        row_len=table.row_len,
        shard_entries=_shard_entries(table, table.n_table_shards))


def build_sharded_table(cfg, mesh) -> BabyTable:
    """The streamed rescan table of a config (models/solver.SolverConfig)
    split by bucket range over the ranks of ``mesh`` (parallel/mesh.Mesh):
    rank s builds and holds rows [s * bps, (s + 1) * bps) on its own
    device (table.build_shard_rows), so no device holds the whole matrix
    and the table may exceed one card; a group of one holds every row.

    Each rank generates the whole baby stream itself, so no chunk crosses
    a process: the build makes no collective until the end, when the
    ranks' bucket counts are gathered into the global offsets (and so a
    bucket overflow raises on every rank). That is why it also runs
    across hosts, where bsgs_tpu's sharded build, which sends each chunk
    from the one device that made it, is single-process only.

    Rescan positions only (6 B a slot): a position plane per slot at a
    size beyond one card defeats the point, so cfg.positions="mirror" is
    refused; bsgs_tpu's sharded build takes it and builds rescan all the
    same. Refuses w >= 2^32."""
    S.check_w(cfg.w)
    if cfg.positions == "mirror":
        raise ValueError("a sharded table holds rescan positions only "
                         "(positions='mirror' was asked for)")
    if mesh.device.type == "cuda":
        S.check_table_fits((1 << cfg.htsz) * cfg.window * 6,
                           device=mesh.device, n_shards=mesh.world)
    bps = (1 << cfg.htsz) // mesh.world
    dense, hint, counts = T.build_shard_rows(
        cfg.w, cfg.htsz, mesh.world, mesh.rank, window=cfg.window,
        device=mesh.device)
    offsets = T.offsets_from_counts(mesh.all_gather(counts), cfg.window,
                                    cfg.htsz)
    return BabyTable(
        w=cfg.w, htsz=cfg.htsz, window=cfg.window, offsets=offsets,
        disc_sorted=None, pos_sorted=None, dense=dense, pos_lo=hint,
        lookup_fn=T.make_strided_lookup(
            cfg.w, dense, hint, cfg.htsz,
            rows=_owner_rows(mesh, dense, hint, bps)),
        n_table_shards=mesh.world, shard=mesh.rank,
    )


def _owner_rows(mesh, dense, hint, bps: int):
    """rows(bucket) for make_strided_lookup on a sharded table: the rank
    that owns the bucket broadcasts its dense row and hint row, packed
    into one int32 tensor, and every rank reads them. Every rank must make
    the same lookups in the same order, which the solve loop does: its
    hit records are the same on every rank."""
    window = dense.shape[1]
    row0 = mesh.rank * bps

    def rows(bucket: int):
        owner = bucket // bps
        buf = torch.empty((2, window), dtype=torch.int32, device=dense.device)
        if owner == mesh.rank:
            buf[0] = dense[bucket - row0]
            buf[1] = hint[bucket - row0].to(torch.int32)
        host = mesh.broadcast(buf, owner).cpu().numpy()
        return host[0].view(np.uint32), host[1].astype(np.uint16)

    return rows


def probe_own_rows(bucket, disc, spec: ShardedTableSpec):
    """found (m,) bool for (m,) int32 keys: whether the key's bucket lies
    in this shard's rows and that row holds its disc. Foreign keys (any
    other bucket, and the all_to_all route's empty slots, bucket -1) ask
    row 0 of the shard, which the probe kernel reads safely (it trusts its
    buckets to be in range), and are masked out after. Buckets are below
    2^31 (htsz <= 31), so int32 arithmetic holds them."""
    local = bucket - spec.row0
    mine = (local >= 0) & (local < spec.buckets_per_shard)
    return probe_kernel.probe_rows(torch.where(mine, local, 0), disc,
                                   spec.dense, spec.row_len) & mine


def alltoall_cap(m: int, n: int, slack: float) -> int:
    """Keys a rank sends each destination of the all_to_all route for a
    stream of m: slack * m / n, rounded up to 128, at least 128 (buckets
    are uniform, so a destination gets m / n on average)."""
    return max(128, -(-int(slack * m / n) // 128) * 128)


def route_keys(bucket, disc, n: int, bps: int, cap: int):
    """The all_to_all route's send side: the keys stably sorted by bucket
    (so by owner) and laid out as n segments of 2 x cap, segment j for
    rank j holding cap buckets, then their cap discs; empty slots hold
    bucket -1 (0xFFFFFFFF, owned by no rank). Returns (send (n*2*cap,)
    int32, plan for route_back)."""
    m = bucket.shape[0]
    dev = bucket.device
    sb, perm = torch.sort(bucket, stable=True)
    owner = (sb // bps).long()
    starts = torch.searchsorted(owner, torch.arange(n, device=dev))
    rank = torch.arange(m, device=dev) - starts[owner]
    ok = rank < cap
    slot = torch.where(ok, owner * cap + rank, n * cap)
    send_b = torch.full((n * cap + 1,), -1, dtype=torch.int32, device=dev)
    send_d = torch.zeros((n * cap + 1,), dtype=torch.int32, device=dev)
    send_b[slot] = sb
    send_d[slot] = disc[perm]
    send = torch.stack((send_b[:-1].view(n, cap), send_d[:-1].view(n, cap)),
                       dim=1)
    return send.view(-1), (slot, ok, perm)


def received_keys(recv, n: int):
    """The keys a rank received on the all_to_all route: (n*2*cap,) of n
    segments, one from each rank -> (bucket, disc), rank order."""
    recv = recv.view(n, 2, -1)
    return recv[:, 0].reshape(-1), recv[:, 1].reshape(-1)


def route_back(answers, plan):
    """The all_to_all route's receive side: answers (n*cap,) bool, segment
    j being rank j's answers to the keys sent to it, -> found (m,) bool in
    the stream's order; a key that found its segment full is found."""
    slot, ok, perm = plan
    got = answers[torch.where(ok, slot, 0)]
    found = torch.empty_like(ok)
    found[perm] = got | ~ok
    return found


def _check_rank(spec: ShardedTableSpec, mesh) -> None:
    if spec.n_shards != mesh.world or spec.shard != mesh.rank:
        raise ValueError(f"shard {spec.shard} of {spec.n_shards} on rank "
                         f"{mesh.rank} of {mesh.world}")


def make_probe(spec: ShardedTableSpec, mesh):
    """The probe (bucket, disc) -> found of this rank's equal-length key
    stream against the sharded table, through the all_gather route: two
    collectives a stream (the keys out, the answers back)."""
    _check_rank(spec, mesh)

    def probe(bucket, disc):
        m = bucket.shape[0]
        keys = mesh.all_gather(torch.stack((bucket, disc)))
        found = probe_own_rows(keys[0::2].reshape(-1),
                               keys[1::2].reshape(-1), spec)
        found = mesh.all_reduce_max(found.to(torch.uint8))
        return found[mesh.rank * m:(mesh.rank + 1) * m].bool()

    return probe


def make_alltoall_probe_bd(spec: ShardedTableSpec, mesh, slack: float = 2.0):
    """The probe (bucket, disc) -> found of the all_to_all route: two
    collectives a stream (each key to the rank that owns its bucket, the
    answers back). Every rank's stream has the same length m, so every
    rank sends segments of the same alltoall_cap(m, world, slack) keys
    and the exchanges match; no size is read back from the device."""
    _check_rank(spec, mesh)
    n, bps = mesh.world, spec.buckets_per_shard

    def probe(bucket, disc):
        cap = alltoall_cap(bucket.shape[0], n, slack)
        send, plan = route_keys(bucket, disc, n, bps, cap)
        found = probe_own_rows(*received_keys(mesh.all_to_all(send), n),
                               spec)
        answers = mesh.all_to_all(found.to(torch.uint8))
        return route_back(answers.bool(), plan)

    return probe


def make_sharded_probe(spec: ShardedTableSpec, mesh):
    """The (hi, lo) prefix probe of the all_gather route (the unfused
    epoch's stream): each prefix's (bucket, disc) split, then make_probe's
    collective probe."""
    core = make_probe(spec, mesh)
    return lambda hi, lo: core(*T.prefix_keys(hi, lo, spec.htsz))


def make_alltoall_probe(spec: ShardedTableSpec, mesh, slack: float = 2.0):
    """The (hi, lo) prefix probe of the all_to_all route (the unfused
    epoch's stream): each prefix's (bucket, disc) split, then
    make_alltoall_probe_bd's collective probe."""
    core = make_alltoall_probe_bd(spec, mesh, slack)
    return lambda hi, lo: core(*T.prefix_keys(hi, lo, spec.htsz))


def make_alltoall_probe_in_process(specs, slack: float = 2.0):
    """make_alltoall_probe of n ranks in one process: probe(his, los) ->
    each rank's found masks, through probe_all_to_all_in_process."""
    htsz = specs[0].htsz

    def probe(his, los):
        keys = [T.prefix_keys(h, lo, htsz) for h, lo in zip(his, los)]
        return probe_all_to_all_in_process([k[0] for k in keys],
                                           [k[1] for k in keys], specs,
                                           slack)

    return probe


def probe_all_gather_in_process(buckets, discs, specs):
    """The all_gather route of n ranks in one process: buckets[r], discs[r]
    are rank r's equal-length streams and specs[r] its shard; returns each
    rank's found masks, as the collective route gives them."""
    bucket, disc = torch.cat(buckets), torch.cat(discs)
    found = probe_own_rows(bucket, disc, specs[0])
    for spec in specs[1:]:
        found |= probe_own_rows(bucket, disc, spec)
    return list(found.split(buckets[0].shape[0]))


def probe_all_to_all_in_process(buckets, discs, specs, slack: float = 2.0):
    """The all_to_all route of n ranks in one process, as
    probe_all_gather_in_process: rank r receives segment r of every rank's
    send buffer, in rank order, and its answers go back the same way."""
    n = len(specs)
    cap = alltoall_cap(buckets[0].shape[0], n, slack)
    sent = [route_keys(b, d, n, specs[0].buckets_per_shard, cap)
            for b, d in zip(buckets, discs)]
    answers = [
        probe_own_rows(*received_keys(torch.cat(
            [send.view(n, -1)[r] for send, _ in sent]), n), specs[r])
        for r in range(n)]
    return [route_back(torch.cat([a.view(n, cap)[r] for a in answers]),
                       plan) for r, (_, plan) in enumerate(sent)]
