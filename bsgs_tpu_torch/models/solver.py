"""End-to-end BSGS solver orchestration on one device
(parallel/striped.MeshSolver runs the same loop over several).

Counterpart of the fused path of ``bsgs_tpu/models/solver.py``: build the
baby table and the giant offsets on the device, scan the key range in
epochs, verify every hit exactly on the host, and report the private key.

The scan loop is pipelined: up to ``cfg.pipeline`` epochs are queued on
the device before the oldest one's hit count is read back. Job centers are
made on the host and copied from pinned memory without waiting; the
``int(cnt)`` in ``_collect`` is the only point per epoch where the host
waits for the device.

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
from ..ops import ec, epoch_kernel as EK, field as F
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
    n_offsets: offsets per job; must split into chains of chunk_c*lanes_w.
    jobs_per_epoch: centers per epoch.
    pipeline: epochs in flight before the host reads one back.
    epoch_phases: job groups computed and probed one after another inside
          an epoch (bounds the key plane held at once); 1 when it does not
          divide jobs_per_epoch.
    chunk_c, lanes_w: chain layout of the epoch kernels (ops/epoch_kernel;
          chain_layout picks one for any n_offsets).
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


def chain_layout(n_offsets: int, jobs_per_phase: int) -> tuple[int, int]:
    """(chunk_c, lanes_w) of the epoch kernels for N offsets: the longest
    chains (at most EK.CHUNK_C) whose length divides N, spaced as far apart
    as N allows (at most EK.LANES_W), so EK.CHUNK_C x EK.LANES_W whenever
    4,096 divides N. A phase whose chain totals exceed EK.DIRECT_MAX folds
    them through the Montgomery kernels, which need lanes_w a multiple of
    32: N without such a layout is refused (ValueError)."""
    if n_offsets < 1:
        raise ValueError(f"n_offsets must be positive (got {n_offsets})")
    c = next(c for c in LAYOUT_CHUNKS if n_offsets % c == 0)
    w = next(w for w in LAYOUT_LANES if (n_offsets // c) % w == 0)
    if jobs_per_phase * n_offsets // c > EK.DIRECT_MAX and w % 32:
        raise ValueError(
            f"n_offsets {n_offsets}: {jobs_per_phase * n_offsets // c} chain "
            f"totals a phase need a Montgomery fold, which takes lanes_w a "
            f"multiple of 32, and chains of {c} x {w} lanes are the widest "
            f"that divide it; use a multiple of {c * 32} (the unfused epoch, "
            f"which would take any N, is not ported)")
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
        if n % (cfg.chunk_c * cfg.lanes_w):
            raise ValueError(
                f"n_offsets {n} is not a multiple of chunk_c*lanes_w "
                f"({cfg.chunk_c}*{cfg.lanes_w})")
        # Giant offsets O_j = j*S*G, j = 1..N, as planar (16, N) planes
        # (the fill doubles, so it runs to the next power of two).
        s_g = ecpy.mul(cfg.stride)
        ox, oy = EK.fill_multiples_planar(
            s_g, s_g, 1 << (n - 1).bit_length(), device=self.device)
        self.ox_pl = ox[:, :n].contiguous()
        self.oy_pl = oy[:, :n].contiguous()
        # Epoch center stepping: centers advance by -(2N+1)*S*G.
        self.center_step = ecpy.neg(ecpy.mul(cfg.jobs_span * cfg.stride))
        self._verify_offsets()
        self._phases = cfg.phases

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
        """Epoch centers as device tensors, copied from pinned memory
        without making the host wait."""
        cx, cy, cinf = self.epoch_centers(q0, first_job,
                                          self.cfg.jobs_per_epoch)
        packed = np.concatenate(
            [cx.astype(np.int32), cy.astype(np.int32),
             cinf.astype(np.int32)[:, None]], axis=1)
        host = torch.from_numpy(packed)
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        nl = F.NLIMBS
        return dev[:, :nl], dev[:, nl:2 * nl], dev[:, -1] != 0

    def _total_epochs(self, pk: int, pke: int) -> int:
        cfg = self.cfg
        m_max = (pke - pk) // cfg.stride + 1
        total_jobs = (m_max + cfg.jobs_span) // cfg.jobs_span + 1
        return -(-total_jobs // cfg.jobs_per_epoch)

    # -- epoch dispatch ------------------------------------------------------
    def _dispatch(self, q0, epoch: int, hit_cap: Optional[int] = None):
        """Queue one epoch on the device; returns a record (epoch,
        first_job, idxs, cnt, giant_steps) with idxs/cnt still on the
        device."""
        cfg = self.cfg
        first_job = epoch * cfg.jobs_per_epoch
        cx, cy, cinf = self._centers_on_device(q0, first_job)
        idxs, cnt, gs = giant.run_epoch_fused(
            cx, cy, cinf, self.ox_pl, self.oy_pl, self.baby.dense,
            htsz=cfg.htsz, chunk_c=cfg.chunk_c, lanes_w=cfg.lanes_w,
            hit_cap=hit_cap or cfg.hit_cap, phases=self._phases,
        )
        return epoch, first_job, idxs, cnt, gs

    def _redispatch(self, q0, epoch: int, cap: int):
        """Overflow recovery: re-run one epoch with a larger hit buffer."""
        return self._dispatch(q0, epoch, hit_cap=cap)

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
              max_epochs: Optional[int] = None, start_epoch: int = 0,
              on_epoch: Optional[Callable] = None) -> SolveResult:
        """Find k in [pk, pke] with k*G == pub (None key if exhausted).

        The scan runs epochs start_epoch, start_epoch + 1, ... (a resumed
        scan starts past 0); max_epochs caps the epochs dispatched (a timed
        scan of part of a range). giant_steps counts this call's steps.

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
        end = total_epochs
        if max_epochs is not None:
            end = min(end, start_epoch + max_epochs)

        steps = 0
        hits_checked = 0
        t0 = time.time()
        epoch = start_epoch
        drained = 0
        depth = max(1, cfg.pipeline)
        inflight = collections.deque()
        defer = (max(0, cfg.verify_defer_epochs)
                 if self.baby.lookup_fn is not None else 0)
        pending = []
        first_pending = 0
        unreported = []  # (epoch, steps) drained, not yet called back
        while epoch < end or inflight:
            while epoch < end and len(inflight) < depth:
                inflight.append(self._dispatch(q0, epoch))
                epoch += 1
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
            drained += 1
            unreported.append((e, steps))
            if batch:
                if not pending:
                    first_pending = drained
                pending.extend(batch)
            scan_done = not (epoch < end or inflight)
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
