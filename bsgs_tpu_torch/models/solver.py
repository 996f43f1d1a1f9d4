"""End-to-end BSGS solver orchestration on one device
(parallel/striped.MeshSolver runs the same loop over several).

Counterpart of ``bsgs_tpu/models/solver.py``: build the baby table and the
giant offsets on the device, scan the key range in epochs, verify every
hit exactly on the host, and report the private key.

An epoch is fused (the epoch kernels, giant.run_epoch_fused) wherever the
config's chain layout fits N, else unfused (the row-major field/ec
surface, giant.run_epoch), which takes any N; ``SolverConfig.fused``
forces either. ``SolverConfig.cross_pipeline`` probes each fused epoch's
keys while the next epoch's are computed, on a second CUDA stream
(giant.pipelined_step).

The scan loop is pipelined: up to ``cfg.pipeline`` epochs are queued on
the device before the oldest one's hit count is read back. Job centers are
made on the host and copied from pinned memory without waiting; the
``int(cnt)`` in ``_collect`` is the only point per epoch where the host
waits for the device. ``solve(epoch_stride=, epoch_offset=)`` stripes the
epochs over workers.

Tables of w >= 2^28 are built streamed (table.build_baby_table_streamed;
parallel/sharded_table.py splits one by bucket range over several cards).
On a rescan table a position lookup regenerates part of the baby stream,
so ``solve`` pools the hits of several drained epochs and verifies them in
one batch (``SolverConfig.verify_defer_epochs``); its ``on_epoch`` and
``progress`` callbacks trail that verification.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import ec, epoch_kernel as EK, field as F, planar as P
from ..utils import ecpy
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
          next epoch's are computed (giant.pipelined_step).
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
    if cfg.w >= tbl.STREAMED_W:
        return tbl.build_baby_table_streamed(
            cfg.w, cfg.htsz, window=cfg.window, positions=cfg.positions,
            device=dev)
    return tbl.build_baby_table_device(cfg.w, cfg.htsz, window=cfg.window,
                                       tile=cfg.table_tile, device=dev)


class Solver:
    def __init__(self, cfg: SolverConfig,
                 baby: Optional[tbl.BabyTable] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.baby = baby if baby is not None else build_table(cfg,
                                                              self.device)
        if self.baby.htsz != cfg.htsz:
            cfg.htsz = self.baby.htsz
        n = cfg.n_offsets
        fits = layout_fits(n, cfg.jobs_per_epoch // cfg.phases, cfg.chunk_c,
                           cfg.lanes_w)
        self.fused = fits if cfg.fused is None else cfg.fused
        if self.fused and not fits:
            raise ValueError(
                f"n_offsets {n} does not fit the epoch kernels' chains of "
                f"chunk_c*lanes_w ({cfg.chunk_c}*{cfg.lanes_w}; "
                f"chain_layout picks one); fused=False takes any N")
        self._pipelined = bool(self.fused and cfg.cross_pipeline)
        # an unfused or pipelined epoch is one block of decode_flat's layout
        self._phases = cfg.phases if self.fused and not self._pipelined \
            else 1
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
        # Epoch center stepping: centers advance by -(2N+1)*S*G.
        self.center_step = ecpy.neg(ecpy.mul(cfg.jobs_span * cfg.stride))
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
        M_g = Q0 - c_g*S*G for g = first_job .. first_job + n_jobs - 1, one
        exact host addition a center (ec.host_row), for any T; a center at
        infinity has its lane marked, as bsgs_tpu's fill marks it."""
        cfg = self.cfg
        c0 = (first_job * cfg.jobs_span + cfg.n_offsets) * cfg.stride
        return ec.host_row(ecpy.sub(q0, ecpy.mul(c0)), self.center_step,
                           n_jobs)

    def _centers_on_device(self, q0, first_job: int):
        """Epoch centers as device tensors (x, y, inf (T,) bool), copied in
        one piece from pinned memory without making the host wait: for a
        fused epoch x and y as packed (8, T) planes, packed on the host, so
        that the epoch adds no launch for them; for an unfused one as rows
        (T, 16)."""
        cx, cy, cinf = self.epoch_centers(q0, first_job,
                                          self.cfg.jobs_per_epoch)
        inf = cinf.astype(np.int32)
        if self.fused:  # word i = limb 2i | limb 2i+1 << 16 (uint32 limbs)
            words = [(v[:, 0::2] | (v[:, 1::2] << 16)).T.view(np.int32)
                     for v in (cx.astype(np.uint32), cy.astype(np.uint32))]
            host = torch.from_numpy(np.ascontiguousarray(
                np.concatenate(words + [inf[None]])))
        else:
            host = torch.from_numpy(np.concatenate(
                [cx.astype(np.int32), cy.astype(np.int32), inf[:, None]],
                axis=1))
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        if self.fused:
            w = P.PACKED_ROWS
            return dev[:w], dev[w:2 * w], dev[-1] != 0
        nl = F.NLIMBS
        return dev[:, :nl], dev[:, nl:2 * nl], dev[:, -1] != 0

    def _total_epochs(self, pk: int, pke: int) -> int:
        cfg = self.cfg
        m_max = (pke - pk) // cfg.stride + 1
        total_jobs = (m_max + cfg.jobs_span) // cfg.jobs_span + 1
        return -(-total_jobs // cfg.jobs_per_epoch)

    # -- epoch dispatch ------------------------------------------------------
    def _epoch(self, q0, epoch: int, hit_cap: Optional[int] = None):
        """Queue one whole epoch on the device (fused or unfused); returns
        a record (epoch, first_job, idxs, cnt, giant_steps) with idxs/cnt
        still on the device."""
        cfg = self.cfg
        first_job = epoch * cfg.jobs_per_epoch
        cx, cy, cinf = self._centers_on_device(q0, first_job)
        cap = hit_cap or cfg.hit_cap
        if self.fused:
            idxs, cnt, gs = giant.run_epoch_fused(
                cx, cy, cinf, self.ox_pk, self.oy_pk, self.baby.rows,
                htsz=cfg.htsz, chunk_c=cfg.chunk_c, lanes_w=cfg.lanes_w,
                hit_cap=cap, phases=self._phases)
        else:
            idxs, cnt, gs = giant.run_epoch(
                cx, cy, cinf, self.ox, self.oy, self.baby.rows,
                htsz=cfg.htsz, hit_cap=cap)
        return epoch, first_job, idxs, cnt, gs

    def _dispatch(self, q0, epoch: int):
        """Queue epoch ``epoch``. Pipelined, this queues its keys and the
        probe of the previously dispatched epoch's, and the record is that
        epoch's (None epoch and no steps for the priming step; _flush
        drains the last one)."""
        if not self._pipelined:
            return self._epoch(q0, epoch)
        cfg = self.cfg
        first_job = epoch * cfg.jobs_per_epoch
        cx, cy, cinf = self._centers_on_device(q0, first_job)
        prev = self._prev
        keys, bc, dc, idxs, cnt = giant.pipelined_step(
            *(prev[1:] if prev else (None,) * 4), prev is not None,
            cx, cy, self.ox_pk, self.oy_pk, self.baby.rows, htsz=cfg.htsz,
            chunk_c=cfg.chunk_c, lanes_w=cfg.lanes_w, hit_cap=cfg.hit_cap)
        self._prev = (first_job, keys, bc, dc, cinf)
        if prev is None:
            return None, None, idxs, cnt, 0
        return (prev[0] // cfg.jobs_per_epoch, prev[0], idxs, cnt,
                (2 * cfg.n_offsets + 1) * cfg.jobs_per_epoch)

    def _flush(self):
        """Probe the last key bundle of a pipelined scan."""
        cfg = self.cfg
        first_job, keys, bc, dc, cinf = self._prev
        self._prev = None
        idxs, cnt = giant.probe_keys_flush(keys, bc, dc, cinf,
                                           self.baby.rows,
                                           hit_cap=cfg.hit_cap)
        return (first_job // cfg.jobs_per_epoch, first_job, idxs, cnt,
                (2 * cfg.n_offsets + 1) * cfg.jobs_per_epoch)

    def _redispatch(self, q0, epoch: int, cap: int):
        """Overflow recovery: re-run one epoch with a larger hit buffer,
        outside the cross-epoch pipeline."""
        return self._epoch(q0, epoch, hit_cap=cap)

    def _collect(self, pub, pk: int, rec):
        """Read one queued epoch's results back and DECODE any hits (no
        verification). Returns (hit records, giant_steps); raises
        HitOverflow when the device buffer was too small."""
        _, first_job, idxs, cnt, gs = rec
        cnt = int(cnt)
        if cnt > idxs.shape[-1]:
            raise HitOverflow(cnt)
        batch = []
        if cnt:
            batch = self._records(pub, pk, first_job, idxs.cpu().numpy())
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
        keys, hits_checked = checker.verify_hits_batched(pending, self.baby)
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
        giant steps up to and including that epoch."""
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
        t0 = time.time()
        epoch = start_epoch * epoch_stride + epoch_offset
        dispatched = 0
        drained = 0
        depth = max(1, cfg.pipeline)
        inflight = collections.deque()
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
        while may_dispatch() or inflight or pending_flush():
            while may_dispatch() and len(inflight) < depth:
                inflight.append(self._dispatch(q0, epoch))
                dispatched += 1
                epoch += epoch_stride
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
            if e is not None:  # not the priming step of a pipelined scan
                drained += 1
                unreported.append((e, steps))
            if batch:
                if not pending:
                    first_pending = drained
                pending.extend(batch)
            scan_done = not (may_dispatch() or inflight or pending_flush())
            if pending and (scan_done or drained - first_pending >= defer):
                key, hc = self._verify(pending, pk, pke)
                hits_checked += hc
                pending = []
                if key is not None:
                    return SolveResult(
                        key, steps, time.time() - t0, drained, hits_checked
                    )
            if not pending:
                for e0, st0 in unreported:
                    if on_epoch is not None:
                        on_epoch(e0, st0)
                    if progress is not None:
                        progress(e0 + 1, total_epochs, st0, time.time() - t0)
                unreported.clear()
        return SolveResult(None, steps, time.time() - t0, drained,
                           hits_checked)
