"""Auto-tuner: suggest a complete solver flag set from device memory.

Counterpart of ``bsgs_tpu/utils/tuner.py`` (the reference's Tune,
1_9_7File.pb:324-431, which sizes -w/-htsz against free VRAM): w doubles
while the scan's working set fits the device's memory less
``solver.MEMORY_RESERVE``, and the build's peak fits the whole memory. The
working set is the port's own device layout:

  table            dense (2^htsz, window) int32 slots, 4 B each, plus the
                   CSR arrays of a one-shot build (disc and position, 8 B
                   a key) or, from table.STREAMED_W on, the streamed
                   build's 2-byte hint (rescan) or 4-byte position plane
                   (mirror) per slot; offsets 4 B a bucket, and the
                   probe's row-length plane, 1 B a bucket (2 B above 255
                   slots a row)
  giant offsets    x and y planes, each packed (32 B an offset, which the
                   fused epoch reads) and as limb planes (64 B): 2 * 96 B
                   per offset
  epoch transients EPOCH_BYTES_PER_PAIR per (job, offset) pair of an epoch
  build peak       the table, plus BUILD_BYTES_PER_KEY per key for the
                   one-shot sort pack, or STREAMED_BUILD_BYTES_PER_BUCKET
                   per bucket for the streamed build

The three transient constants were measured on one NVIDIA H100 80GB HBM3
(700 W power limit) by chip_smoke.py, which holds this module's estimates
against the peaks it measures at w=2^26, w=2^30 and the geometry it
suggests for the card (PERF.md gives the run). The epoch shape is
SolverConfig's: T=16 jobs in 4 phases, 3 epochs in flight, N=2^18.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .. import resolve_device
from ..models import solver as smod, table as tbl
from ..ops import probe_kernel as PK

# Device bytes a scan holds beyond the table and the offset planes, per
# (job, offset) pair of an epoch (74.5 measured at T=16, N=2^18).
EPOCH_BYTES_PER_PAIR = 75
# Device bytes per key that the one-shot build holds at its peak beyond
# the finished table: prefix planes, the sort's keys and permutation, the
# scatter's indices (73.2 measured at w=2^26).
BUILD_BYTES_PER_KEY = 73
# Device bytes per bucket that the streamed build holds at its peak beyond
# the table: the int64 running counts, their prefix sum and the CSR
# offsets made from them, which outweigh a chunk's transients (29.5
# measured at 2^24 buckets on an H100).
STREAMED_BUILD_BYTES_PER_BUCKET = 29.5

# The largest w (solver.build_table refuses more).
W_MAX = smod.W_MAX


def dense_layout(w: int, window: int = tbl.DEVICE_WINDOW):
    """(htsz, window) of the dense device table for a given w: 128-slot
    rows at a mean load of window/2 (table.pick_htsz)."""
    return tbl.pick_htsz(w, window), window


@dataclasses.dataclass
class TuneResult:
    w: int
    htsz: int
    window: int
    n_offsets: int
    jobs_per_epoch: int
    pipeline: int
    streamed_build: bool
    est_table_bytes: int
    est_offsets_bytes: int
    est_transient_bytes: int
    est_build_peak_bytes: int

    @property
    def keys_per_epoch(self) -> int:
        return (2 * self.n_offsets + 1) * self.jobs_per_epoch * 2 * self.w

    @property
    def scan_bytes(self) -> int:
        return (self.est_table_bytes + self.est_offsets_bytes
                + self.est_transient_bytes)

    def flags(self) -> str:
        return (
            f"--w {self.w} --htsz {self.htsz} --window {self.window} "
            f"--n-offsets {self.n_offsets} "
            f"--jobs-per-epoch {self.jobs_per_epoch} "
            f"--pipeline {self.pipeline}"
        )

    def report(self) -> str:
        mib = 1 << 20
        build = ("streamed, rescan positions" if self.streamed_build
                 else "one-shot sort pack")
        return (
            f"suggested: {self.flags()}\n"
            f"  device: table {self.est_table_bytes / mib:.0f} MiB, "
            f"offsets {self.est_offsets_bytes / mib:.0f} MiB, "
            f"epoch transients {self.est_transient_bytes / mib:.0f} MiB, "
            f"build peak {self.est_build_peak_bytes / mib:.0f} MiB "
            f"[{build}]\n"
            f"  host: the table stays on the device (the checker pulls "
            f"rows)\n"
            f"  keys per epoch: 2^{self.keys_per_epoch.bit_length() - 1}"
        )


def device_memory_bytes(device=None) -> int:
    """Total memory of the device a table would live on: the card's
    (torch.cuda.mem_get_info), or the host's physical memory for the
    CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def plan(w: int, window: int = tbl.DEVICE_WINDOW) -> TuneResult:
    """The device bytes of a scan at w with the port's epoch shape (rescan
    positions on a streamed table)."""
    htsz, window = dense_layout(w, window)
    cfg = smod.SolverConfig(w=w, htsz=htsz, window=window)
    streamed = w >= tbl.STREAMED_W
    table_b = ((1 << htsz) * window * smod.table_bytes_per_slot(cfg)
               + 4 * ((1 << htsz) + 1)
               + (1 << htsz) * PK.row_len_dtype(window).itemsize
               + (0 if streamed else 8 * w))
    build_b = int(STREAMED_BUILD_BYTES_PER_BUCKET * (1 << htsz) if streamed
                  else BUILD_BYTES_PER_KEY * w)
    n, t = cfg.n_offsets, cfg.jobs_per_epoch
    return TuneResult(
        w=w, htsz=htsz, window=window, n_offsets=n, jobs_per_epoch=t,
        pipeline=cfg.pipeline, streamed_build=streamed,
        est_table_bytes=table_b, est_offsets_bytes=2 * n * (32 + 64),
        est_transient_bytes=EPOCH_BYTES_PER_PAIR * t * n,
        est_build_peak_bytes=table_b + build_b)


def tune(mem_bytes: int | None = None, range_bits: int | None = None,
         window: int = tbl.DEVICE_WINDOW, device=None) -> TuneResult:
    """Pick the largest safe geometry for the device's memory.

    w doubles from 2^20 while the scan (plan(w).scan_bytes) fits the
    memory less solver.MEMORY_RESERVE and the build's peak with the offset
    planes fits the memory, up to W_MAX; then the 1.5x midpoint is tried
    on a streamed table. A search range caps w near its square root: a
    bigger table than sqrt(range) buys nothing."""
    if mem_bytes is None:
        mem_bytes = device_memory_bytes(device)
    budget = mem_bytes - smod.MEMORY_RESERVE

    def fits(t: TuneResult) -> bool:
        return (t.scan_bytes <= budget and t.w <= W_MAX
                and t.est_build_peak_bytes + t.est_offsets_bytes <= mem_bytes)

    w = 1 << 20
    while fits(plan(w << 1, window)):
        w <<= 1
    if w >= tbl.STREAMED_W and fits(plan(w + w // 2, window)):
        w += w // 2
    if range_bits is not None:
        w = min(w, 1 << max(10, (range_bits + 1) // 2))
    return plan(w, window)
