"""Baby-step table: device build (planar generation + sort pack) and probe.

Counterpart of the device path of ``bsgs_tpu/models/table.py``. Baby
points 1G..wG come out of the planar doubling fill and the add-const
kernel tile by tile; only their 64-bit X prefixes are kept. One stable
sort of the key (bucket << 32 | disc) groups buckets and orders entries
inside them, and a CSR table plus the dense (2^htsz, window) matrix fall
out of a cumsum and a scatter, all on the device.

u32 arrays are int32 tensors holding the same bits (``DENSE_FILL`` is -1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import epoch_kernel as EK, planar as PL
from ..utils import ecpy

# Empty dense slots hold 0xFFFFFFFF. A probe whose own disc equals it
# false-positives (P = 2^-32 per probe); the host checker verifies every hit.
DENSE_FILL = -1

# Row width of the dense matrix: 128 u32 slots, 512 B.
DEVICE_WINDOW = 128


@dataclasses.dataclass
class BabyTable:
    """Packed baby table: the sorted CSR view (offsets, per-entry disc and
    baby position) the checker walks, and the dense (2^htsz, window) bucket
    matrix the epoch probes. ``sorted_pre`` (host uint64, optional) holds
    the full 64-bit prefixes of a host-built table for exact lookups."""

    w: int
    htsz: int
    window: int
    offsets: torch.Tensor  # (2^htsz + 1,) int32 CSR bucket offsets
    disc_sorted: torch.Tensor  # (w,) int32 bits: disc per sorted entry
    pos_sorted: torch.Tensor  # (w,) int32: baby index 1..w per sorted entry
    dense: torch.Tensor  # (2^htsz, window) int32 bits, DENSE_FILL-padded
    sorted_pre: Optional[np.ndarray] = None

    def lookup_positions(self, x_int: int) -> list[int]:
        """All baby indices whose X prefix matches that of x_int: the full
        64 bits when sorted_pre is kept, else the htsz+32 bits the packed
        table stores (the checker verifies every candidate exactly)."""
        pre = x_int & ((1 << 64) - 1)
        if self.sorted_pre is not None:
            p = np.uint64(pre)
            lo = int(np.searchsorted(self.sorted_pre, p, side="left"))
            hi = int(np.searchsorted(self.sorted_pre, p, side="right"))
            return [int(v) for v in self.pos_sorted[lo:hi].tolist()]
        bucket = pre >> (64 - self.htsz)
        disc = (pre >> (32 - self.htsz)) & 0xFFFFFFFF
        lo, hi = (int(v) for v in self.offsets[bucket : bucket + 2].tolist())
        d = self.disc_sorted[lo:hi].cpu().numpy().view(np.uint32)
        p = self.pos_sorted[lo:hi].cpu().numpy()
        return [int(v) for v, m in zip(p, d == np.uint32(disc)) if m]

    def lookup_positions_batch(self, x_ints) -> dict:
        """lookup_positions for many X values, keyed by the 64-bit prefix."""
        pres = sorted({int(x) & ((1 << 64) - 1) for x in x_ints})
        return {p: self.lookup_positions(p) for p in pres}


@dataclasses.dataclass
class TableStats:
    """Build-quality summary: entries, bucket loads and duplicate keys."""

    entries: int
    buckets: int
    max_bucket: int
    mean_load: float
    empty_buckets: int
    window: int
    dup_pairs: int

    def __str__(self):
        return (
            f"table: {self.entries} entries in 2^"
            f"{(self.buckets - 1).bit_length()} buckets, load "
            f"{self.mean_load:.1f} avg / {self.max_bucket} max "
            f"(window {self.window}), {self.empty_buckets} empty, "
            f"{self.dup_pairs} duplicate keys"
        )


def table_stats(t: BabyTable) -> TableStats:
    counts = torch.diff(t.offsets.to(torch.int64))
    sd = t.disc_sorted
    b = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    dup = int(((sd[1:] == sd[:-1]) & (b[1:] == b[:-1])).sum())
    cnt = counts.cpu()
    return TableStats(
        entries=int(cnt.sum()),
        buckets=cnt.numel(),
        max_bucket=int(cnt.max()) if cnt.numel() else 0,
        mean_load=float(cnt.double().mean()) if cnt.numel() else 0.0,
        empty_buckets=int((cnt == 0).sum()),
        window=t.window,
        dup_pairs=dup,
    )


def bucket_disc(hi, lo, htsz: int):
    """(hi32, lo32) prefix as int64 -> (bucket, disc32) int64: the top htsz
    bits of the 64-bit prefix and the next 32."""
    return PL.bucket_disc(hi, lo, htsz)


def pick_htsz(w: int, window: int = DEVICE_WINDOW) -> int:
    """Bucket bits so the expected bucket load is window/2 (e.g. w=2^26,
    window=128 -> htsz=20, mean 64)."""
    target = max(1, window // 2)
    htsz = max(4, (w // target - 1).bit_length())
    return min(htsz, 31)


# ---------------------------------------------------------------------------
# Prefix generation (device tiles)


def _prefix_tiles_planar(w: int, tile: int, device, first: int = 1,
                         stride: int = 1):
    """Yield (hi, lo) (take,) int32 prefix planes of (first + i*stride)G
    tile by tile: the planar fill builds the first tile, the add-const
    kernel advances it by tile*stride*G."""
    tile = min(tile, 1 << max(11, (w - 1).bit_length()))
    if tile & (tile - 1):
        raise ValueError(f"tile must be a power of two (got {tile})")
    xs, ys = EK.fill_multiples_planar(ecpy.mul(first), ecpy.mul(stride),
                                      tile, device=device)
    step = ecpy.mul(tile * stride)
    cxc = PL.const_col(step[0], device).to(torch.int32)
    cyc = PL.const_col(step[1], device).to(torch.int32)
    hi, lo = (PL.u32_bits(v[0]) for v in PL.x_prefix64(xs.long()))
    done = 0
    while done < w:
        take = min(tile, w - done)
        yield hi[:take], lo[:take]
        done += take
        if done < w:
            xs, ys, hi, lo = EK.add_const_planar(xs, ys, cxc, cyc)


# ---------------------------------------------------------------------------
# Device pack: one stable sort + counts + scatter


def _device_pack(hi, lo, *, htsz: int, window: int):
    """(w,) int32 prefix halves -> (offsets, disc_sorted, pos_sorted, dense,
    max bucket load as a 0-d tensor). The stable sort of one int64 key
    keeps equal (bucket, disc) entries in baby order, as lax.sort's stable
    two-key sort in bsgs_tpu does."""
    w = hi.shape[0]
    nb = 1 << htsz
    bucket, disc = bucket_disc(PL.u32_value(hi), PL.u32_value(lo), htsz)
    skey, perm = torch.sort((bucket << 32) | disc, stable=True)
    sb = skey >> 32
    sd = PL.u32_bits(skey & 0xFFFFFFFF)
    sp = (perm + 1).to(torch.int32)
    counts = torch.bincount(sb, minlength=nb)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    rank = torch.arange(w, device=hi.device) - offsets[sb]
    # entries past the window land in a dump slot; the caller refuses the
    # table when any bucket overflows
    flat = torch.where(rank < window, sb * window + rank,
                       torch.full_like(rank, nb * window))
    fp = torch.full((nb * window + 1,), DENSE_FILL, dtype=torch.int32,
                    device=hi.device)
    fp[flat] = sd
    dense = fp[:-1].view(nb, window)
    return offsets.to(torch.int32), sd, sp, dense, counts.max()


def build_baby_table_device(w: int, htsz: Optional[int] = None,
                            window: int = DEVICE_WINDOW,
                            tile: int = 1 << 18, device=None) -> BabyTable:
    """Build the packed table entirely on the device: prefixes, sort, CSR
    and dense matrix never cross to the host."""
    dev = resolve_device(device)
    if htsz is None:
        htsz = pick_htsz(w, window)
    tiles = list(_prefix_tiles_planar(w, tile, dev))
    hi = torch.cat([t[0] for t in tiles])
    lo = torch.cat([t[1] for t in tiles])
    del tiles
    offsets, sd, sp, dense, maxb = _device_pack(hi, lo, htsz=htsz,
                                                window=window)
    maxb = int(maxb)
    if maxb > window:
        raise ValueError(
            f"bucket overflow: max bucket {maxb} > window {window}; "
            f"raise htsz (now {htsz}) or window"
        )
    return BabyTable(w=w, htsz=htsz, window=window, offsets=offsets,
                     disc_sorted=sd, pos_sorted=sp, dense=dense)


# ---------------------------------------------------------------------------
# Probing: an index gather of dense rows plus a compare


def probe_keys(bucket, disc, dense):
    """found[i] = any(dense[bucket[i], :] == disc[i]) for int32 key rows."""
    return (dense[bucket.long()] == disc[:, None]).any(dim=1)


def probe_keys_split(bucket, disc, dense, n_split: int = 8):
    """probe_keys over n_split parts of the stream (any length), so the
    (m, window) gathered rows exist one part at a time."""
    parts = [
        probe_keys(b, d, dense)
        for b, d in zip(torch.tensor_split(bucket, n_split),
                        torch.tensor_split(disc, n_split))
    ]
    return torch.cat(parts)
