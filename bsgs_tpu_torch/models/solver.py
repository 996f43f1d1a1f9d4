"""End-to-end BSGS solver orchestration on one device
(parallel/striped.MeshSolver runs the same loop over several).

Counterpart of ``bsgs_tpu/models/solver.py``: build the baby table and the
giant offsets on the device, scan the key range in epochs, verify every
hit exactly on the host, and report the private key.

An epoch is fused (the epoch kernels, giant.fused_epoch_probes) wherever
the config's chain layout fits N, else unfused (the row-major field/ec
surface, giant.epoch_probes), which takes any N; ``SolverConfig.fused``
forces either. ``SolverConfig.cross_pipeline`` probes each fused epoch's
keys while the next epoch's are computed, on a second CUDA stream
(giant.pipelined_step).

The scan loop is pipelined: up to ``cfg.pipeline`` epochs are queued on
the device before the oldest one's hit count is read back. Job centers are
made on the host and copied from pinned memory without waiting. Behind
each epoch's last launch its hit count and hit buffer are copied into
page-locked host memory and one event is recorded (``HitReadback``); the
wait on that epoch's own event, in ``_collect``, is the only point per
epoch where the host waits for the device, and the epochs queued after it
keep the card busy meanwhile. On the CPU the record holds the count and
buffer themselves, read as they are. parallel/striped.MeshSolver runs this
same epoch on each rank and reads every rank's hits, gathered onto its
device, through the same record. ``solve(epoch_stride=, epoch_offset=)``
stripes the epochs over workers.

With the recorder of ``utils/tracing`` on, the loop records its spans
(solve, epoch, centers, stage, launch, collect, wait, verify, the
checker's passes and the residue scans, and tail, a solve's end; build in
build_table; a pipelined step's probe and keys, giant.pipelined_step),
their counts, and on a card the device bracket of each epoch, anchored at
the event a wait waited on.

Tables of w >= 2^28 are built streamed (table.build_baby_table_streamed;
parallel/sharded_table.py splits one by bucket range over several cards).
On a rescan table a position lookup regenerates part of the baby stream,
so ``solve`` pools the hits of several drained epochs and verifies them in
one batch (``SolverConfig.verify_defer_epochs``); its ``on_epoch`` and
``progress`` callbacks trail that verification.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import _cuda, ec, epoch_kernel as EK, field as F, planar as P
from ..utils import ecpy, tracing
from . import checker, giant, table as tbl

# Device memory kept free beside the dense table for the scan's transients.
MEMORY_RESERVE = 3 << 30

# CSR offsets and baby positions are uint32, and a mirror position of 2^32
# would read as 0, the empty mark: the largest w a table takes.
W_MAX = (1 << 32) - 1

# Hit indices are uint32 and 0xFFFFFFFF is the empty slot (giant.FILL): an
# epoch's probe space, 3*T*N + T, must stay below it.
PROBE_SPACE_LIMIT = (1 << 32) - 1

# Drained epochs over which solve pools the hits of a rescan table before
# one batched verification (the default of SolverConfig.verify_defer_epochs).
VERIFY_DEFER_EPOCHS = 64

# Chain lengths and lane spacings chain_layout chooses from, longest first.
LAYOUT_CHUNKS = (16, 8, 4, 2, 1)
LAYOUT_LANES = (256, 128, 64, 32, 16, 8, 4, 2, 1)


@dataclasses.dataclass
class SolverConfig:
    """Geometry of the scan.

    w: baby-table size (keys covered per giant landing = 2w = stride s).
    htsz: bucket bits of the table (top bits of the 64-bit X prefix);
          None = auto (table.pick_htsz for the window).
    n_offsets: offsets per job.
    jobs_per_epoch: centers per epoch.
    pipeline: epochs in flight before the host reads one back.
    epoch_phases: job groups computed and probed one after another inside
          a fused epoch (bounds the key plane held at once); 1 when it does
          not divide jobs_per_epoch, and in the unfused and pipelined
          epochs.
    chunk_c, lanes_w: chain layout of the epoch kernels (ops/epoch_kernel;
          chain_layout picks one for any n_offsets that has one).
    fused: the fused epoch (True), the unfused one (False), or None: fused
          wherever the chain layout fits n_offsets (layout_fits).
    cross_pipeline: on a fused solver, probe each epoch's keys while the
          next epoch's are computed (giant.pipelined_step), where the
          chain layout fits all T jobs at once; else the epochs run direct.
    positions: how a streamed build maps a hit to baby positions: "mirror",
          "rescan", or "auto" (rescan from tbl.STREAMED_W).
    verify_defer_epochs: drained epochs over which a rescan table's hits
          are pooled before one batched verification (0: every drain).
    """

    w: int
    htsz: Optional[int] = None
    n_offsets: int = 1 << 18
    jobs_per_epoch: int = 16
    window: int = tbl.DEVICE_WINDOW
    hit_cap: int = 512
    table_tile: int = 1 << 18
    chunk_c: int = EK.CHUNK_C
    lanes_w: int = EK.LANES_W
    pipeline: int = 3
    epoch_phases: int = 4
    positions: str = "auto"
    verify_defer_epochs: int = VERIFY_DEFER_EPOCHS
    fused: Optional[bool] = None
    cross_pipeline: bool = False

    def __post_init__(self):
        if self.htsz is None:
            self.htsz = tbl.pick_htsz(self.w, self.window)
        space = (3 * self.n_offsets + 1) * self.jobs_per_epoch
        if space >= PROBE_SPACE_LIMIT:
            raise ValueError(
                f"an epoch of {self.jobs_per_epoch} jobs x {self.n_offsets} "
                f"offsets probes {space} keys; its hit indices are uint32, "
                f"with 0xFFFFFFFF marking an empty slot, so the probe space "
                f"3*T*N + T must stay below {PROBE_SPACE_LIMIT}")

    @property
    def stride(self) -> int:
        return 2 * self.w

    @property
    def jobs_span(self) -> int:
        """Giant indices covered per job."""
        return 2 * self.n_offsets + 1

    @property
    def keys_per_epoch(self) -> int:
        return self.jobs_span * self.jobs_per_epoch * self.stride

    @property
    def phases(self) -> int:
        """Phases an epoch runs in: 1 under cross_pipeline (a pipelined
        step computes all T jobs' keys at once), else direct_phases."""
        return 1 if self.cross_pipeline else self.direct_phases

    @property
    def direct_phases(self) -> int:
        """Phases of a direct epoch: epoch_phases, or 1 where it does not
        divide jobs_per_epoch."""
        p = max(1, self.epoch_phases)
        return p if self.jobs_per_epoch % p == 0 else 1


def layout_fits(n_offsets: int, jobs_per_phase: int, chunk_c: int,
                lanes_w: int) -> bool:
    """Whether the epoch kernels take N offsets in chains of chunk_c spaced
    lanes_w apart: chunk_c * lanes_w divides N, and a phase whose chain
    totals exceed EK.DIRECT_MAX, which folds them through the Montgomery
    kernels, has lanes_w a multiple of 32."""
    return (n_offsets % (chunk_c * lanes_w) == 0
            and (jobs_per_phase * n_offsets // chunk_c <= EK.DIRECT_MAX
                 or lanes_w % 32 == 0))


def chain_layout(n_offsets: int, jobs_per_phase: int) -> tuple[int, int]:
    """(chunk_c, lanes_w) of the epoch kernels for N offsets: the longest
    chains (at most EK.CHUNK_C) whose length divides N, spaced as far apart
    as N allows (at most EK.LANES_W), so EK.CHUNK_C x EK.LANES_W whenever
    4,096 divides N. N without a layout that fits (layout_fits: a fold
    without 32-lane spacing) is refused (ValueError); the unfused epoch
    takes it."""
    if n_offsets < 1:
        raise ValueError(f"n_offsets must be positive (got {n_offsets})")
    c = next(c for c in LAYOUT_CHUNKS if n_offsets % c == 0)
    w = next(w for w in LAYOUT_LANES if (n_offsets // c) % w == 0)
    if not layout_fits(n_offsets, jobs_per_phase, c, w):
        raise ValueError(
            f"n_offsets {n_offsets}: {jobs_per_phase * n_offsets // c} chain "
            f"totals a phase need a Montgomery fold, which takes lanes_w a "
            f"multiple of 32, and chains of {c} x {w} lanes are the widest "
            f"that divide it; use a multiple of {c * 32} for the fused "
            f"epoch, or the unfused one (SolverConfig(fused=False)), which "
            f"takes any N")
    return c, w


class HitOverflow(RuntimeError):
    """An epoch produced more hits than its fixed-capacity buffer; the
    solve loop re-runs that epoch with a larger cap."""

    def __init__(self, count: int):
        super().__init__(f"hit buffer overflow ({count})")
        self.count = count


@dataclasses.dataclass
class SolveResult:
    key: Optional[int]
    giant_steps: int
    elapsed_s: float
    epochs: int
    hits_checked: int


def check_table_fits(table_bytes: int, mem_bytes: Optional[int] = None,
                     device=None, n_shards: int = 1) -> None:
    """Refuse a table (the dense matrix and the planes kept beside it)
    whose slice on each of n_shards cards exceeds a card's memory less
    MEMORY_RESERVE (total memory from torch.cuda.mem_get_info), the one
    reserve that utils/tuner sizes against too."""
    if mem_bytes is None:
        mem_bytes = torch.cuda.mem_get_info(resolve_device(device))[1]
    budget = mem_bytes - MEMORY_RESERVE
    per_card = -(-table_bytes // max(1, n_shards))
    if per_card > budget:
        hint = (
            "use --shard-table over several cards to split the table "
            "across them (parallel/sharded_table.py)"
            if n_shards == 1
            else f"this mesh's {n_shards} cards still hold "
            f"{per_card / 2**30:.1f} GiB each; use more cards"
        )
        raise ValueError(
            f"dense table ({table_bytes / 2**30:.1f} GiB) exceeds the "
            f"{budget / 2**30:.1f} GiB per-card budget "
            f"({mem_bytes / 2**30:.0f} GiB device memory - "
            f"{MEMORY_RESERVE / 2**30:.0f} GiB scan reserve); " + hint
        )


def table_bytes_per_slot(cfg: SolverConfig) -> int:
    """Device bytes per dense slot: 4 for the matrix, plus a streamed
    table's 2-byte hint (rescan) or 4-byte position plane (mirror)."""
    if cfg.w < tbl.STREAMED_W:
        return 4
    return 8 if cfg.positions == "mirror" else 6


def check_w(w: int) -> None:
    """Refuse w >= 2^32 (W_MAX): baby positions are uint32."""
    if w > W_MAX:
        raise ValueError(f"w={w}: baby positions are uint32, so w must "
                         f"stay below 2^32 (a mirror position of 2^32 would "
                         f"be 0, the empty mark)")


def build_table(cfg: SolverConfig, device=None) -> tbl.BabyTable:
    """The on-device table build for a config: one sort pack below
    tbl.STREAMED_W, the streamed build (cfg.positions) from there on
    (parallel/sharded_table.build_sharded_table splits the streamed table
    over the ranks of a mesh). Refuses w >= 2^32."""
    check_w(cfg.w)
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_table_fits(
            (1 << cfg.htsz) * cfg.window * table_bytes_per_slot(cfg),
            device=dev)
    with tracing.span("build") as sp:
        sp.count("w", cfg.w)
        if cfg.w >= tbl.STREAMED_W:
            return tbl.build_baby_table_streamed(
                cfg.w, cfg.htsz, window=cfg.window,
                positions=cfg.positions, device=dev)
        return tbl.build_baby_table_device(
            cfg.w, cfg.htsz, window=cfg.window, tile=cfg.table_tile,
            device=dev)


class HitReadback:
    """Hit counts and hit buffers on their way to the host, as rows
    [count, hits...]: one row for an epoch of one card, one a rank for a
    mesh's gather (parallel/striped).

    On a card the parts, laid side by side, are copied on the current
    stream behind the epoch's last launch into one page-locked buffer of
    PyTorch's caching host allocator, and one event is recorded after the
    copies: reading waits for that event alone, not for the epochs queued
    after it. On the CPU the record holds the rows themselves."""

    __slots__ = ("rows", "event")

    def __init__(self, *parts: torch.Tensor):
        """parts: the columns of the rows, each (rows, k) or, for one row,
        (k,) or a scalar: an epoch's count and its hit buffer, or a
        gather's (ranks, 1 + cap)."""
        n = parts[-1].shape[0] if parts[-1].dim() == 2 else 1
        parts = [p.reshape(n, -1) for p in parts]
        self.event = None
        if parts[0].device.type != "cuda":
            self.rows = torch.cat(parts, 1)
            return
        self.rows = torch.empty(n, sum(p.shape[1] for p in parts),
                                dtype=torch.int32, pin_memory=True)
        col = 0
        for p in parts:
            self.rows[:, col:col + p.shape[1]].copy_(p, non_blocking=True)
            col += p.shape[1]
        self.event = torch.cuda.Event(enable_timing=True)
        self.event.record(torch.cuda.current_stream(parts[0].device))

    def ready(self) -> bool:
        """Whether the copies have landed (no wait)."""
        return self.event is None or self.event.query()

    def read(self):
        """(the rows' counts (rows,), their hit buffers' int32 bits
        (rows, cap)) as numpy, once the copies have landed (the one wait);
        raises HitOverflow when any row's count exceeds its buffer."""
        if self.event is not None:
            self.event.synchronize()
        rows = self.rows.numpy()
        cnts, bufs = rows[:, 0], rows[:, 1:]
        if cnts.max() > bufs.shape[1]:
            raise HitOverflow(int(cnts.max()))
        return cnts, bufs


class EpochCenters:
    """The job centers M_g = Q0 - (g*jobs_span + n_offsets)*S*G of a
    config, g = first_job .. first_job + T - 1, exactly, for any T, and
    with no scalar multiplication while a scan runs:

    - the first center is carried: the last row's first center, if it has
      the same Q0, plus delta*step (step = -jobs_span*S*G) for the delta
      between the two first jobs, one affine addition. delta*step is one
      of the row's multiples, or is made by one scalar multiplication the
      first time the delta is seen and kept. A row of another Q0 takes the
      scalar multiplication of M_g itself;
    - the row is M + i*step from the multiples i*step (made once, longer
      as longer rows ask) with one shared inversion
      (ec.host_row_shared), or the serial ec.host_row where that does not
      apply (a lane at infinity or a doubling).

    After each row ``carried`` says whether its first center came by one
    addition, and ``exact`` whether the row took ec.host_row."""

    def __init__(self, cfg: SolverConfig):
        self.cfg = cfg
        self.step = ecpy.neg(ecpy.mul(cfg.jobs_span * cfg.stride))
        self._multiples = [self.step]  # i*step for i = 1, 2, ...
        self._jumps = {0: None}  # delta*step for the other deltas seen
        self._last = None  # (Q0, first job, first center)
        self.carried = self.exact = False

    def _jump(self, delta: int):
        """(delta*step, whether it was at hand)."""
        if 0 < delta <= len(self._multiples):
            return self._multiples[delta - 1], True
        if delta in self._jumps:
            return self._jumps[delta], True
        pt = ecpy.mul(abs(delta), self.step)
        self._jumps[delta] = pt if delta > 0 else ecpy.neg(pt)
        return self._jumps[delta], False

    def __call__(self, q0, first_job: int, n_jobs: int):
        mults = self._multiples
        while len(mults) < n_jobs:
            mults.append(ecpy.add(mults[-1], self.step))
        last = self._last
        if last is not None and last[0] == q0:
            jump, self.carried = self._jump(first_job - last[1])
            m = ecpy.add(last[2], jump)
        else:
            cfg = self.cfg
            c0 = (first_job * cfg.jobs_span + cfg.n_offsets) * cfg.stride
            m, self.carried = ecpy.sub(q0, ecpy.mul(c0)), False
        self._last = (q0, first_job, m)
        row = ec.host_row_shared(m, mults[:n_jobs - 1])
        self.exact = row is None
        return ec.host_row(m, self.step, n_jobs) if self.exact else row


class Solver:
    _behind = ()  # the records in flight behind the one _collect reads

    def __init__(self, cfg: SolverConfig,
                 baby: Optional[tbl.BabyTable] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.baby = baby if baby is not None else build_table(cfg,
                                                              self.device)
        if self.baby.htsz != cfg.htsz:
            cfg.htsz = self.baby.htsz
        n = cfg.n_offsets
        # a pipelined step computes all T jobs at once; where their chains
        # do not fit the kernels, the epochs run direct, in direct_phases
        pipelined = cfg.cross_pipeline and layout_fits(
            n, cfg.jobs_per_epoch, cfg.chunk_c, cfg.lanes_w)
        phases = cfg.phases if pipelined else cfg.direct_phases
        fits = layout_fits(n, cfg.jobs_per_epoch // phases, cfg.chunk_c,
                           cfg.lanes_w)
        self.fused = fits if cfg.fused is None else cfg.fused
        if self.fused and not fits:
            raise ValueError(
                f"n_offsets {n} does not fit the epoch kernels' chains of "
                f"chunk_c*lanes_w ({cfg.chunk_c}*{cfg.lanes_w}; "
                f"chain_layout picks one); fused=False takes any N")
        self._pipelined = bool(self.fused and pipelined)
        # an unfused epoch is one block of decode_flat's layout
        self._phases = phases if self.fused else 1
        # Giant offsets O_j = j*S*G, j = 1..N, filled as packed (8, N)
        # planes (the fill doubles, so it runs to the next power of two),
        # which the fused epoch reads; unpacked once into planar (16, N)
        # planes for the checks and the unfused epoch, which reads them
        # row-major, as (N, 16) int64 views.
        s_g = ecpy.mul(cfg.stride)
        ox, oy = EK.fill_multiples_packed(
            s_g, s_g, 1 << (n - 1).bit_length(), device=self.device)
        self.ox_pk = ox[:, :n].contiguous()
        self.oy_pk = oy[:, :n].contiguous()
        self.ox_pl = P.unpack_planes(self.ox_pk)
        self.oy_pl = P.unpack_planes(self.oy_pk)
        if not self.fused:
            self.ox, self.oy = self.ox_pl.long().T, self.oy_pl.long().T
        # The fused epoch probes (bucket, disc) keys, the unfused one (hi,
        # lo) prefixes. Each is given the table itself, whose planes it
        # reads at every call.
        self._probe = (giant.dense_probe(self.baby) if self.fused
                       else giant.make_probe(self.baby, htsz=cfg.htsz))
        # Epoch centers: each job's center -(2N+1)*S*G from the last.
        self._centers = EpochCenters(cfg)
        self._verify_offsets()
        self._prev = None  # pipelined: the last dispatched key bundle

    def _verify_offsets(self, checks: int = 4):
        """Spot-verify random offsets against exact host EC: column j must
        hold (j+1)*S*G bit for bit."""
        cfg = self.cfg
        rng = np.random.default_rng(0x61A27)
        for j in {int(rng.integers(0, cfg.n_offsets)) for _ in range(checks)}:
            expect = ecpy.mul((j + 1) * cfg.stride)
            got = (
                F.from_limbs(self.ox_pl[:, j].cpu().numpy()),
                F.from_limbs(self.oy_pl[:, j].cpu().numpy()),
            )
            if got != expect:
                raise ValueError(
                    f"giant offset buffer corrupt at j={j}: {got[0]:#x} "
                    f"!= {expect[0]:#x}"
                )

    # -- center generation -------------------------------------------------
    def epoch_centers(self, q0, first_job: int, n_jobs: int):
        """Host arrays (x (T,16), y (T,16), inf (T,)) of job-center points
        M_g = Q0 - c_g*S*G for g = first_job .. first_job + n_jobs - 1,
        exact, for any T (EpochCenters: the first center carried from the
        last row, the row with one shared inversion); a center at infinity
        has zero coordinates and its lane marked, as bsgs_tpu's fill marks
        it."""
        return self._centers(q0, first_job, n_jobs)

    def _centers_on_device(self, q0, first_job: int):
        """Epoch centers as device tensors (x, y, inf (T,) bool), copied in
        one piece from pinned memory without making the host wait: for a
        fused epoch x and y as packed (8, T) planes, packed on the host, so
        that the epoch adds no launch for them; for an unfused one as rows
        (T, 16). The copy starts the device bracket of the epoch span
        open around it.

        Recorded as ``centers`` (counts ``additions``, T; ``carried``, 1
        where the first center came by one addition; ``exact_rows``, 1
        where the row took the serial ec.host_row) and ``stage``."""
        n = self.cfg.jobs_per_epoch
        with tracing.span("centers") as sp:
            cx, cy, cinf = self.epoch_centers(q0, first_job, n)
            sp.count("additions", n)
            sp.count("carried", int(self._centers.carried))
            sp.count("exact_rows", int(self._centers.exact))
        with tracing.span("stage") as sp:
            inf = cinf.astype(np.int32)
            if self.fused:  # word i: a coordinate's bytes 4i .. 4i+3
                words = [v.astype("<u2").view("<u4").T.view(np.int32)
                         for v in (cx, cy)]
                host = torch.from_numpy(np.ascontiguousarray(
                    np.concatenate(words + [inf[None]])))
            else:
                host = torch.from_numpy(np.concatenate(
                    [cx.astype(np.int32), cy.astype(np.int32),
                     inf[:, None]], axis=1))
            if self.device.type == "cuda":
                host = host.pin_memory()
            tracing.begin_device("epoch", self.device)
            dev = host.to(self.device, non_blocking=True)
            sp.count("bytes", host.nbytes)
        if self.fused:
            w = P.PACKED_ROWS
            return dev[:w], dev[w:2 * w], dev[-1] != 0
        nl = F.NLIMBS
        return dev[:, :nl], dev[:, nl:2 * nl], dev[:, -1] != 0

    @property
    def _jobs_per_super(self) -> int:
        """Jobs of one epoch of the loop (parallel/striped: of all ranks)."""
        return self.cfg.jobs_per_epoch

    @property
    def _jobs_before(self) -> int:
        """Jobs of an epoch of the loop that come before this worker's own
        (parallel/striped: those of the lower ranks)."""
        return 0

    def _total_epochs(self, pk: int, pke: int) -> int:
        cfg = self.cfg
        m_max = (pke - pk) // cfg.stride + 1
        total_jobs = (m_max + cfg.jobs_span) // cfg.jobs_span + 1
        return -(-total_jobs // self._jobs_per_super)

    # -- epoch dispatch ------------------------------------------------------
    def _queue(self, epoch: int, run, q0=None):
        """The steps of every epoch the loop queues: the span ``epoch``
        (counting ``T`` where it stages centers; giant.pipelined_step marks
        it where its probe ran on a second stream); this worker's centers
        of epoch ``epoch``, staged (none without q0, when the device
        bracket starts here); the span ``launch`` around
        ``run(*centers)``, which returns (hit buffer, count); and the
        record's read-back of them (_readback)."""
        with tracing.span("epoch", epoch) as sp:
            if q0 is None:
                sp.begin_device(self.device)
                centers = ()
            else:
                sp.count("T", self.cfg.jobs_per_epoch)
                centers = self._centers_on_device(
                    q0, epoch * self._jobs_per_super + self._jobs_before)
            with tracing.span("launch") as sl:
                sl.delta("launches", _cuda.total_launches)
                idxs, cnt = run(*centers)
            return self._readback(idxs, cnt)

    def _readback(self, idxs, cnt) -> HitReadback:
        """The read-back of an epoch's hit buffer and count
        (parallel/striped: of every rank's, gathered)."""
        return HitReadback(cnt, idxs)

    def _epoch(self, q0, epoch: int, hit_cap: Optional[int] = None):
        """Queue one epoch on the device; returns a record (epoch,
        first_job, HitReadback, giant_steps). Every epoch the loop queues
        comes through here, and its landing keys are this epoch's.

        Direct (fused or unfused), the record is this epoch's. Pipelined,
        the epoch is one step (giant.pipelined_step): its keys, and the
        probe of the previous step's keys, whose record it returns (None
        epoch and no steps for a solve's priming step; _flush probes the
        last step's). An overflow re-run (``hit_cap`` given) takes the
        whole epoch directly, outside the pipeline."""
        cfg = self.cfg
        if self._pipelined and hit_cap is None:
            prev = self._prev

            def step(cx, cy, cinf):
                keys, bc, dc, idxs, cnt = giant.pipelined_step(
                    *(prev[1:] if prev else (None,) * 4), prev is not None,
                    cx, cy, self.ox_pk, self.oy_pk, self.baby.rows,
                    htsz=cfg.htsz, chunk_c=cfg.chunk_c, lanes_w=cfg.lanes_w,
                    hit_cap=cfg.hit_cap)
                self._prev = (epoch, keys, bc, dc, cinf)
                return idxs, cnt

            hits = self._queue(epoch, step, q0)
            if prev is None:
                return None, None, hits, 0
            return self._epoch_record(prev[0], hits)
        cap = hit_cap or cfg.hit_cap

        def run(cx, cy, cinf):
            if self.fused:
                return giant.fused_epoch_probes(
                    cx, cy, cinf, self.ox_pk, self.oy_pk, self._probe,
                    htsz=cfg.htsz, chunk_c=cfg.chunk_c, lanes_w=cfg.lanes_w,
                    hit_cap=cap, phases=self._phases)
            return giant.epoch_probes(cx, cy, cinf, self.ox, self.oy,
                                      self._probe, hit_cap=cap)

        return self._epoch_record(epoch, self._queue(epoch, run, q0))

    def _epoch_record(self, epoch: int, hits: HitReadback):
        """The record of epoch ``epoch``'s hits: (epoch, first_job,
        HitReadback, giant_steps)."""
        return (epoch, epoch * self._jobs_per_super, hits,
                self.cfg.jobs_span * self._jobs_per_super)

    def _dispatch(self, q0, epoch: int):
        """Queue epoch ``epoch`` (_epoch; pipelined, the record is the
        previous step's)."""
        return self._epoch(q0, epoch)

    def _flush(self):
        """Probe the last key bundle of a pipelined scan, on the current
        stream: the one queued step that computes no keys."""
        epoch, keys, bc, dc, cinf = self._prev
        self._prev = None
        return self._epoch_record(epoch, self._queue(
            epoch, lambda: giant.probe_keys_flush(
                keys, bc, dc, cinf, self.baby.rows,
                hit_cap=self.cfg.hit_cap)))

    def _redispatch(self, q0, epoch: int, cap: int):
        """Overflow recovery: re-run one epoch with a larger hit buffer,
        outside the cross-epoch pipeline."""
        return self._epoch(q0, epoch, hit_cap=cap)

    def _collect(self, pub, pk: int, rec):
        """Read one queued epoch's results back and DECODE any hits (no
        verification), row c's jobs starting at first_job + c*T (one row on
        a card, one a rank on a mesh). Returns (hit records, giant_steps);
        raises HitOverflow when a device buffer was too small (on a mesh
        on every rank, which all read the same counts).

        Recorded as ``collect`` (counts ``hits`` and ``ranks_with_hits``,
        the rows with any) and ``wait``: the wait on the epoch's own
        event, with the epochs queued behind it (``queued``), whether its
        copies had landed when the wait began (``ready``), and how many of
        the epochs behind it were still running when it ended (``busy``)."""
        e, first_job, hits, gs = rec
        with tracing.span("collect", e) as sp:
            with tracing.span("wait") as sw:
                if sw:
                    ready = hits.ready()
                    sw.count("queued", len(self._behind))
                    sw.count("ready", int(ready))
                    if not ready:  # it completes within this wait
                        sw.anchor(self.device, hits.event)
                try:
                    cnts, bufs = hits.read()
                finally:
                    if sw:
                        sw.count("busy", sum(not r[2].ready()
                                             for r in self._behind))
            sp.count("ranks_with_hits", int(np.count_nonzero(cnts)))
            batch = []
            for c in range(len(cnts)):
                if cnts[c]:
                    batch += self._records(
                        pub, pk, first_job + c * self.cfg.jobs_per_epoch,
                        bufs[c])
            sp.count("hits", len(batch))
        return batch, gs

    def _records(self, pub, pk: int, job_base: int, idxs: np.ndarray):
        """Decode a hit buffer's int32 bits, job t=0 being job_base, into
        (ctx, code, t, j) records."""
        cfg = self.cfg
        ctx = checker.HitContext(q=pub, pk=pk, s=cfg.stride,
                                 n=cfg.n_offsets, job_base=job_base)
        return [
            (ctx,) + giant.decode_flat_phased(
                int(flat), cfg.jobs_per_epoch, cfg.n_offsets, self._phases)
            for flat in giant.hit_indices(idxs)
        ]

    def _verify(self, pending, pk: int, pke: int):
        """Batched exact verification of hit records. Returns (key or
        None, hits_checked)."""
        with tracing.span("verify") as sp:
            keys, hits_checked = checker.verify_hits_batched(pending,
                                                             self.baby)
            sp.count("records", hits_checked)
            sp.count("keys", len(keys))
        for k in keys:
            if pk <= k <= pke:
                return k, hits_checked
        return None, hits_checked

    # -- main loop ----------------------------------------------------------
    def solve(self, pub: tuple, pk: int, pke: int,
              progress: Optional[Callable] = None,
              epoch_stride: int = 1, epoch_offset: int = 0,
              max_epochs: Optional[int] = None, start_epoch: int = 0,
              on_epoch: Optional[Callable] = None) -> SolveResult:
        """Find k in [pk, pke] with k*G == pub (None key if exhausted).

        The scan runs epochs start_epoch * epoch_stride + epoch_offset, then
        every epoch_stride-th after it (a resumed scan starts past 0;
        epoch_stride/epoch_offset stripe the epochs over workers);
        max_epochs caps the epochs dispatched (a timed scan of part of a
        range). giant_steps counts this call's steps.

        On a rescan table (baby.lookup_fn) hits are pooled for up to
        cfg.verify_defer_epochs drained epochs and verified in one batch;
        a scan that ends with hits still pooled verifies them before it
        returns. Other tables verify at every drain.

        on_epoch(epoch, steps) and progress(epoch + 1, total_epochs, steps,
        seconds) fire for each drained epoch, in order, once no hit of it
        or of an earlier epoch is left unverified: with pipelining and
        deferral they trail the dispatch frontier, so a checkpoint written
        from on_epoch never skips an unverified epoch (the reference's
        min-counter rule, 1_9_7File.pb:3897-3931). steps is this call's
        giant steps up to and including that epoch.

        Recorded as the span ``solve``, with the epochs drained, the giant
        steps and steps_to_key (the steps up to the returned key's landing:
        the rest scanned past it). Inside it the span ``tail`` runs from
        the dispatch of the solve's last epoch to its return: the drain of
        the epochs in flight and the last pooled verification, counting
        the ``epochs`` drained and the ``records`` verified in it, and
        ``found``, 1 where the solve returns a key."""
        with tracing.span("solve") as sp:
            try:
                res = self._scan(pub, pk, pke, progress, epoch_stride,
                                 epoch_offset, max_epochs, start_epoch,
                                 on_epoch)
            finally:
                self._behind = ()
            if sp:
                sp.count("epochs", res.epochs)
                sp.count("steps", res.giant_steps)
                sp.count("steps_to_key", res.giant_steps if res.key is None
                         else min(res.giant_steps, self._steps_to_key(
                             res.key - pk, start_epoch * epoch_stride
                             + epoch_offset, epoch_stride)))
        return res

    def _steps_to_key(self, k0: int, first_epoch: int, stride: int) -> int:
        """Giant steps that a scan from epoch first_epoch, every stride-th,
        takes up to the landing of a key k0 = k - pk (k0 = m*S +- r, r at
        most w: landing m), that landing's step included."""
        cfg = self.cfg
        per_epoch = self._jobs_per_super * cfg.jobs_span
        m = (k0 + cfg.w) // cfg.stride
        e = m // per_epoch
        before = max(0, -(-(e - first_epoch) // stride))
        return before * per_epoch + m - e * per_epoch + 1

    def _scan(self, pub, pk, pke, progress, epoch_stride, epoch_offset,
              max_epochs, start_epoch, on_epoch) -> SolveResult:
        """solve's loop."""
        cfg = self.cfg
        if pub is None or not ecpy.is_on_curve(pub):
            raise ValueError("pubkey is not a point on secp256k1")
        # k0 == 0 means Q == pk*G
        if ecpy.mul(pk) == pub:
            return SolveResult(pk, 0, 0.0, 0, 0)
        q0 = ecpy.sub(pub, ecpy.mul(pk))
        total_epochs = self._total_epochs(pk, pke)

        steps = 0
        hits_checked = 0
        t0 = time.perf_counter()
        epoch = start_epoch * epoch_stride + epoch_offset
        dispatched = 0
        drained = 0
        depth = max(1, cfg.pipeline)
        inflight = collections.deque()
        self._behind = inflight  # after popleft: the records behind rec
        self._prev = None  # pipelined state is per solve

        def may_dispatch():
            return epoch < total_epochs and (max_epochs is None
                                             or dispatched < max_epochs)

        def pending_flush():
            return self._pipelined and self._prev is not None

        defer = (max(0, cfg.verify_defer_epochs)
                 if self.baby.lookup_fn is not None else 0)
        pending = []
        first_pending = 0
        unreported = []  # (epoch, steps) drained, not yet called back
        tail = None  # the span from the last epoch's dispatch to the end
        with contextlib.ExitStack() as ends:
            while may_dispatch() or inflight or pending_flush():
                while may_dispatch() and len(inflight) < depth:
                    inflight.append(self._dispatch(q0, epoch))
                    dispatched += 1
                    epoch += epoch_stride
                if tail is None and not may_dispatch():
                    tail = ends.enter_context(tracing.span("tail"))
                if not inflight:
                    inflight.append(self._flush())
                rec = inflight.popleft()
                e = rec[0]
                while True:
                    try:
                        batch, gs = self._collect(pub, pk, rec)
                        break
                    except HitOverflow as ov:
                        # re-run this epoch with a buffer that fits
                        cap = 1 << max(ov.count.bit_length() + 1, 8)
                        rec = self._redispatch(q0, e, cap)
                steps += gs
                if e is not None:  # not a pipelined scan's priming step
                    drained += 1
                    unreported.append((e, steps))
                    if tail is not None:
                        tail.count("epochs", 1)
                if batch:
                    if not pending:
                        first_pending = drained
                    pending.extend(batch)
                scan_done = not (may_dispatch() or inflight
                                 or pending_flush())
                if pending and (scan_done
                                or drained - first_pending >= defer):
                    key, hc = self._verify(pending, pk, pke)
                    hits_checked += hc
                    pending = []
                    if tail is not None:
                        tail.count("records", hc)
                        tail.count("found", int(key is not None))
                    if key is not None:
                        return SolveResult(
                            key, steps, time.perf_counter() - t0, drained,
                            hits_checked
                        )
                if not pending:
                    for e0, st0 in unreported:
                        if on_epoch is not None:
                            on_epoch(e0, st0)
                        if progress is not None:
                            progress(e0 + 1, total_epochs, st0,
                                     time.perf_counter() - t0)
                    unreported.clear()
            if tail is not None:
                tail.count("found", 0)
            return SolveResult(None, steps, time.perf_counter() - t0,
                               drained, hits_checked)
