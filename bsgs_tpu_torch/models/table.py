"""Baby-step table: device builds (planar generation, then a sort pack or
a streamed scatter), position lookups and the probe.

Counterpart of the device paths of ``bsgs_tpu/models/table.py``. Baby
points 1G..wG come out of the planar doubling fill and the add-const
kernel tile by tile; only their 64-bit X prefixes are kept.

- ``build_baby_table_device``: one stable sort of the key
  (bucket << 32 | disc) groups buckets and orders entries inside them, and
  a CSR table plus the dense (2^htsz, window) matrix fall out of a cumsum
  and a scatter. Holds all w prefixes and the sort at once.
- ``build_baby_table``: the host pack. The prefixes are generated on the
  caller's device (``compute_prefixes``), sorted and packed on the host by
  the native library (``utils/native.py``), and the dense matrix re-derived
  from the CSR arrays on the device (``dense_from_csr``); the table keeps
  the full 64-bit ``sorted_pre`` for exact lookups.
- ``build_baby_table_streamed``: the big-w build. The dense matrix is
  filled chunk by chunk in place, so the device holds the table plus one
  chunk's transients. No CSR arrays: positions come from a slot-aligned
  position plane (``mirror``) or from a 2-byte hint per slot and a
  regeneration of 1/256 of the baby stream per verified hit (``rescan``).
  ``build_shard_rows`` builds any bucket range of that table on its own
  (``parallel/sharded_table.py`` splits a table over the ranks with it).

u32 arrays are int32 tensors holding the same bits (``DENSE_FILL`` is -1);
the uint16 hint plane is an int16 tensor holding the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import (ec, epoch_kernel as EK, field as F, planar as PL,
                   probe_kernel)
from ..utils import ecpy, native, tracing

# Empty dense slots hold 0xFFFFFFFF. A probe whose own disc equals it
# false-positives (P = 2^-32 per probe); the host checker verifies every hit.
DENSE_FILL = -1

# Row width of the dense matrix: 128 u32 slots, 512 B.
DEVICE_WINDOW = 128

# From this w on solver.build_table streams the build (the one-shot device
# build holds all w prefixes and a w-long sort at once) and "auto"
# positions mean rescan.
STREAMED_W = 1 << 28


class ProbeRows(NamedTuple):
    """What a probe reads: the dense (rows, window) bucket matrix and its
    (rows,) row-length plane (probe_kernel.row_len_dtype)."""

    dense: torch.Tensor
    row_len: torch.Tensor


@dataclasses.dataclass
class BabyTable:
    """Packed baby table: the dense (2^htsz, window) bucket matrix the
    epoch probes, and what the checker needs to turn a matched prefix into
    baby positions. Which of the optional fields are set depends on the
    build:

    - device build: the sorted CSR view (``offsets``, ``disc_sorted``,
      ``pos_sorted``);
    - host-built table carried across: the CSR view plus ``sorted_pre``
      (host uint64), the full 64-bit prefixes for exact lookups;
    - streamed build, ``mirror``: ``pos_dense``, the baby position of every
      dense slot (0 = empty), on the table's device;
    - streamed build, ``rescan``: ``pos_lo``, the 16-bit hint of every
      dense slot (low byte: position & 0xFF; high byte: the 8 prefix bits
      below the stored disc), and ``lookup_fn`` (make_strided_lookup);
    - sharded build: as ``rescan``, but ``dense`` and ``pos_lo`` hold only
      this rank's rows [shard * bps, (shard + 1) * bps) of the 2^htsz,
      bps = 2^htsz / n_table_shards; ``offsets`` stay global, and
      ``lookup_fn`` pulls a row from the rank that owns it.

    Every build fills a row from slot 0 and leaves DENSE_FILL after its
    last entry. ``row_len`` holds each of ``dense``'s rows' entry count,
    uint8 up to 255 slots a row and int16 above (1 MiB at htsz 20, 16
    MiB at htsz 24: it stays in the card's L2). It is made from
    ``offsets`` whenever a table is made (one diff; dataclasses.replace
    makes it anew), is not saved in artifacts, and is what the probe
    kernel reads to touch only occupied slots.

    Positions are uint32: the planes hold their bits in int32 tensors and
    are read back as uint32."""

    w: int
    htsz: int
    window: int
    offsets: torch.Tensor  # (2^htsz + 1,) int32 CSR bucket offsets
    disc_sorted: Optional[torch.Tensor]  # (w,) int32 bits, sorted entries
    pos_sorted: Optional[torch.Tensor]  # (w,) int32: baby index 1..w
    dense: torch.Tensor  # (2^htsz, window) int32 bits, DENSE_FILL-padded
    sorted_pre: Optional[np.ndarray] = None
    pos_dense: Optional[torch.Tensor] = None  # (2^htsz, window) int32
    lookup_fn: Optional[object] = None
    pos_lo: Optional[torch.Tensor] = None  # (2^htsz, window) int16 bits
    n_table_shards: int = 1
    shard: Optional[int] = None  # this rank's shard of a sharded build
    # (rows of dense,) entry counts, made from offsets
    row_len: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        rows = self.dense.shape[0]
        row0 = (self.shard or 0) * rows
        counts = torch.diff(PL.u32_value(self.offsets[row0:row0 + rows + 1]))
        self.row_len = probe_kernel.row_lengths(counts, self.window)

    @property
    def rows(self) -> ProbeRows:
        """The dense matrix and its row lengths, as the probe takes them."""
        return ProbeRows(self.dense, self.row_len)

    def lookup_positions(self, x_int: int) -> list[int]:
        """All baby indices whose X prefix matches that of x_int: the full
        64 bits with lookup_fn or sorted_pre, else the htsz+32 bits the
        packed table stores (the checker verifies every candidate
        exactly)."""
        pre = x_int & ((1 << 64) - 1)
        if self.lookup_fn is not None:
            return self.lookup_fn(pre)
        if self.sorted_pre is not None:
            p = np.uint64(pre)
            lo = int(np.searchsorted(self.sorted_pre, p, side="left"))
            hi = int(np.searchsorted(self.sorted_pre, p, side="right"))
            return [int(v) for v in _u32_host(self.pos_sorted[lo:hi])]
        bucket = pre >> (64 - self.htsz)
        disc = np.uint32((pre >> (32 - self.htsz)) & 0xFFFFFFFF)
        if self.pos_dense is not None:
            # streamed mirror build: two row pulls, slot-aligned
            d = _u32_host(self.dense[bucket])
            p = _u32_host(self.pos_dense[bucket])
            return [int(v) for v, dd in zip(p, d) if dd == disc and v != 0]
        lo, hi = (int(v) for v in _u32_host(self.offsets[bucket:bucket + 2]))
        d = _u32_host(self.disc_sorted[lo:hi])
        p = _u32_host(self.pos_sorted[lo:hi])
        return [int(v) for v, m in zip(p, d == disc) if m]

    def lookup_positions_batch(self, x_ints) -> dict:
        """lookup_positions for many X values, keyed by the 64-bit prefix.
        Each distinct prefix is resolved once; a rescan table's lookup
        regenerates one residue class of the baby stream per surviving
        candidate of each prefix."""
        pres = sorted({int(x) & ((1 << 64) - 1) for x in x_ints})
        if not pres:
            return {}
        batch = getattr(self.lookup_fn, "batch", None)
        if batch is not None:
            return batch(pres)
        return {p: self.lookup_positions(p) for p in pres}


def _u32_host(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor's bits as a host uint32 array."""
    return t.cpu().numpy().view(np.uint32)


@dataclasses.dataclass
class TableStats:
    """Build-quality summary: entries, bucket loads and duplicate keys
    (dup_pairs is None for a streamed table, which keeps no sorted disc
    stream)."""

    entries: int
    buckets: int
    max_bucket: int
    mean_load: float
    empty_buckets: int
    window: int
    dup_pairs: Optional[int]

    def __str__(self):
        dup = "n/a" if self.dup_pairs is None else str(self.dup_pairs)
        return (
            f"table: {self.entries} entries in 2^"
            f"{(self.buckets - 1).bit_length()} buckets, load "
            f"{self.mean_load:.1f} avg / {self.max_bucket} max "
            f"(window {self.window}), {self.empty_buckets} empty, "
            f"{dup} duplicate keys"
        )


def table_stats(t: BabyTable) -> TableStats:
    counts = torch.diff(PL.u32_value(t.offsets))
    dup = None
    if t.disc_sorted is not None:
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


def _prefix_tiles(w: int, tile: int, device, first: int = 1,
                  stride: int = 1):
    """Yield (hi, lo) (take,) int32 prefix rows of (first + i*stride)G,
    i = 0..w-1, tile by tile, on the row-major surface: ec.fill_multiples
    builds the first tile (its length rounded to a power of two) and
    ec.extend_tile advances it by tile*stride*G. The same stream as
    _prefix_tiles_planar, which the builds run."""
    tile = min(tile, 1 << max(1, (w - 1).bit_length()))
    bx, by = ec.fill_multiples(ecpy.mul(first), ecpy.mul(stride), tile,
                               device=device)
    step = ecpy.mul(tile * stride)
    c = [torch.from_numpy(F.to_limbs(v).astype(np.int64)).to(device)
         for v in (*step, *ecpy.dbl(step))]
    done = 0
    while done < w:
        take = min(tile, w - done)
        hi, lo = F.x_prefix64(bx)
        yield hi[:take], lo[:take]
        done += take
        if done < w:
            bx, by, _ = ec.extend_tile(bx, by, *c)


def _planar_tile(w: int, tile: int) -> int:
    """The tile _prefix_tiles_planar fills for w points: ``tile``, or the
    power of two that holds w where that is smaller (2^11 at least)."""
    return min(tile, 1 << max(11, (w - 1).bit_length()))


def _prefix_tiles_planar(w: int, tile: int, device, first: int = 1,
                         stride: int = 1):
    """Yield (hi, lo) (take,) int32 prefix planes of (first + i*stride)G
    tile by tile: the fill builds the first tile, the tile advance
    (ops/epoch_kernel.tile_advance_packed: four kernel launches) moves it on
    by tile*stride*G. The tile stays packed ((8, tile) words, 32 bytes a
    point) for the whole build: words 1 and 0 of x are the first tile's
    prefix halves. The builds and the hintless rescan run it; the residue
    scans of make_strided_lookup run _ResidueTiles, which yields the same
    tiles of the stride-256 stream from a first tile kept per lookup (64
    MiB at ``tile`` 2^20, filled by its first scan, whose ``residue`` span
    counts ``kept`` 0)."""
    tile = _planar_tile(w, tile)
    if tile & (tile - 1):
        raise ValueError(f"tile must be a power of two (got {tile})")
    xs, ys = EK.fill_multiples_packed(ecpy.mul(first), ecpy.mul(stride),
                                      tile, device=device)
    step = ecpy.mul(tile * stride)
    cxc, cyc = (PL.packed_col(v, device) for v in step)
    yield from _advancing(xs, ys, xs[1], xs[0], w, tile, cxc, cyc)


def _advancing(xs, ys, hi, lo, w: int, tile: int, cxc, cyc):
    """Yield (hi, lo)[:take] of the packed tile (xs, ys), then of each tile
    advance by the packed step columns (cxc, cyc), until w points."""
    done = 0
    while done < w:
        take = min(tile, w - done)
        yield hi[:take], lo[:take]
        done += take
        if done < w:
            xs, ys, hi, lo = EK.tile_advance_packed(xs, ys, cxc, cyc)


class _ResidueTiles:
    """The residue scans' generator for one table of w baby points:
    ``tiles(first)`` yields (first + 256*i)G, i < (w - first)//256 + 1, for
    a residue class ``first`` in 1..256: the tiles and bits of
    _prefix_tiles_planar(count, tile, device, first=first, stride=256).

    It keeps K = (256*(i+1))G, i < t, packed on the device, t the tile of
    class 1, the largest any class takes (64 MiB at ``tile`` 2^20), and the
    packed columns of the advance's step (t*256)G. Class 256's first tile
    is K; class ``first``'s is K + (first - 256)G, one tile advance with no
    doubling lane, since 256(i+1) is never ±(first - 256). The first scan
    fills K (fill_multiples_packed), so a table that never scans keeps
    nothing."""

    def __init__(self, w: int, tile: int, device):
        self.w, self.tile, self.device = w, tile, device
        self.t = _planar_tile((w - 1) // 256 + 1, tile)
        self.kept = None  # (K's x, K's y, step x column, step y column)

    def tiles(self, first: int):
        count = (self.w - first) // 256 + 1
        t = _planar_tile(count, self.tile)
        dev = self.device
        if self.kept is None:
            kx, ky = EK.fill_multiples_packed(ecpy.mul(256), ecpy.mul(256),
                                              self.t, device=dev)
            step = ecpy.mul(self.t * 256)
            self.kept = (kx, ky, *(PL.packed_col(v, dev) for v in step))
        kx, ky, cxc, cyc = self.kept
        # a class whose tile is narrower than K's fits in that one tile, so
        # every advance below steps by K's own (t*256)G
        xs, ys = kx[:, :t].contiguous(), ky[:, :t].contiguous()
        if first == 256:
            hi, lo = xs[1], xs[0]
        else:
            c = ecpy.neg(ecpy.mul(256 - first))
            xs, ys, hi, lo = EK.tile_advance_packed(
                xs, ys, PL.packed_col(c[0], dev), PL.packed_col(c[1], dev))
        yield from _advancing(xs, ys, hi, lo, count, t, cxc, cyc)


def compute_prefixes(w: int, tile: int = 1 << 18, device=None) -> np.ndarray:
    """64-bit X prefixes of 1G..wG as a host uint64 array, generated on the
    caller's device (_prefix_tiles_planar)."""
    dev = resolve_device(device)
    out = np.empty(w, dtype=np.uint64)
    done = 0
    for hi, lo in _prefix_tiles_planar(w, tile, dev):
        take = hi.shape[0]
        pre = (PL.u32_value(hi) << 32) | PL.u32_value(lo)
        out[done:done + take] = pre.cpu().numpy().view(np.uint64)
        done += take
    return out


def _u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 array -> int32 tensor with the same bits on device."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Host pack: native sort + CSR pack, dense matrix re-derived on the device


def dense_from_csr(offsets, disc, window: int):
    """(2^htsz+1,) CSR offsets + (w,) sorted discs (int32 bits) -> the
    (2^htsz, window) dense bucket matrix, DENSE_FILL in empty slots, on
    their device. Refuses a bucket fuller than the window."""
    off = PL.u32_value(offsets)
    counts = torch.diff(off)
    nb, w = counts.numel(), disc.shape[0]
    maxb = int(counts.max()) if nb else 0
    if maxb > window:
        raise ValueError(f"bucket of {maxb} entries > window {window}")
    bucket = torch.repeat_interleave(
        torch.arange(nb, device=disc.device), counts)
    within = torch.arange(w, device=disc.device) - off[:-1][bucket]
    dense = torch.full((nb, window), DENSE_FILL, dtype=torch.int32,
                       device=disc.device)
    dense[bucket, within] = disc
    return dense


def fit_window(maxb: int, window: int) -> int:
    """Actual probe window: the requested minimum, grown (in steps of 4
    slots) to fit the largest bucket. The hot path asks for DEVICE_WINDOW
    and picks htsz so that growth never happens (pick_htsz)."""
    return max(window, -(-maxb // 4) * 4)


def pack_table(prefixes: np.ndarray, htsz: int, window: int = 16,
               device=None) -> BabyTable:
    """Host pack of 64-bit prefixes: the native radix sort and CSR pack,
    then the dense matrix on the device. ``window`` is a minimum; the row
    grows to the largest bucket (fit_window)."""
    dev = resolve_device(device)
    w = prefixes.shape[0]
    sorted_pre, sorted_pos = native.sort_prefixes(prefixes)
    offsets, disc, maxb = native.csr_pack(sorted_pre, htsz)
    window = fit_window(maxb, window)
    offsets_t = _u32_tensor(offsets, dev)
    disc_t = _u32_tensor(disc, dev)
    return BabyTable(
        w=w, htsz=htsz, window=window, offsets=offsets_t,
        disc_sorted=disc_t, pos_sorted=_u32_tensor(sorted_pos, dev),
        dense=dense_from_csr(offsets_t, disc_t, window),
        sorted_pre=sorted_pre)


def build_baby_table(w: int, htsz: int, window: int = 16,
                     tile: int = 1 << 18, device=None) -> BabyTable:
    """The host-packed table of 1G..wG (prefixes from the device)."""
    return pack_table(compute_prefixes(w, tile, device), htsz, window,
                      device)


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
# Streamed big-w build: incremental scatter, one chunk of transients


def _disc_lo_shift(htsz: int) -> tuple[int, int]:
    """(shift, mask) extracting up to 8 prefix bits just below the htsz+32
    that a dense entry certifies. The 64-bit prefix's low 32 - htsz bits
    are otherwise discarded; 8 of them in the hint let a lookup reject a
    probe false positive without regenerating anything."""
    spare = 32 - htsz
    take = min(8, max(0, spare))
    return spare - take, (1 << take) - 1


def _u16_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^16) -> int16 tensor with the same 16 bits."""
    return (((x + (1 << 15)) & 0xFFFF) - (1 << 15)).to(torch.int16)


def _chunk_scatter(hi, lo, flat_dense, counts, flat_hint, flat_pos,
                   base: int, row0: int, *, htsz: int, window: int) -> None:
    """Insert the entries of one chunk of prefixes (baby positions
    base+1 .. base+m) whose bucket lies in rows [row0, row0 + rows) of the
    table, rows = counts.shape[0] - 1, IN PLACE: nothing the size of the
    table is copied.

    rank in bucket = the bucket's running fill (counts) + the entry's rank
    within the chunk, so entries of one bucket keep baby order across
    chunks, as bsgs_tpu's stable lax.sort gives. Entries of other rows
    take the sort key ``rows``, so the stable sort puts them after the own
    ones and keeps each own bucket's entries in stream order; an entry's
    rank is its index less the first index of its key (a sorted search).
    The whole chunk is sorted rather than filtered first, because a filter
    (nonzero) would make the host wait for every chunk. The last count
    tallies the foreign entries.

    ``flat_dense`` (int32), ``flat_hint`` (int16 or None) and ``flat_pos``
    (int32 or None) are flat (rows * window + 1,) buffers whose last slot
    is a dump: foreign entries and entries past the window land there, and
    the build then refuses the table because a count exceeds the window
    (offsets_from_counts). Hint: low byte = position & 0xFF, high byte =
    the _disc_lo_shift bits. No host wait."""
    m = hi.shape[0]
    rows = counts.shape[0] - 1
    lo_v = PL.u32_value(lo)
    bucket, disc = bucket_disc(PL.u32_value(hi), lo_v, htsz)
    local = bucket - row0
    key = torch.where((local >= 0) & (local < rows), local,
                      torch.full_like(local, rows))
    sk, perm = torch.sort(key, stable=True)
    idx = torch.arange(m, device=hi.device)
    rank = idx - torch.searchsorted(sk, sk) + counts[sk]
    slot = torch.where((sk < rows) & (rank < window), sk * window + rank,
                       torch.full_like(rank, rows * window))
    pos = perm + (base + 1)
    flat_dense[slot] = PL.u32_bits(disc[perm])
    if flat_hint is not None:
        sh, mk = _disc_lo_shift(htsz)
        dlo = (lo_v[perm] >> sh) & mk
        flat_hint[slot] = _u16_bits((pos & 0xFF) | (dlo << 8))
    if flat_pos is not None:
        flat_pos[slot] = PL.u32_bits(pos)
    counts.index_add_(0, sk, torch.ones_like(sk, dtype=counts.dtype))


def _i32(v: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    return ((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _match(hi, lo, pre64: int) -> list[int]:
    """Indices of a generated tile whose 64-bit prefix equals pre64 (every
    one; the host waits for the answer)."""
    m = (hi == _i32(pre64 >> 32)) & (lo == _i32(pre64))
    return torch.nonzero(m).flatten().tolist()


def make_strided_lookup(w: int, dense, pos_lo, htsz: int,
                        tile: int = 1 << 20, rows=None):
    """Position lookup through the slot-aligned 16-bit hint ``pos_lo`` (low
    byte = position & 0xFF, high byte = 8 prefix bits below the stored
    disc), on the device that holds ``dense``:

    1. the bucket's dense row and hint row are pulled to the host (two
       waits; ``rows(bucket)`` -> (uint32 row, uint16 hint row) pulls them
       instead where another rank owns the row); a slot whose disc matches
       but whose extra bits do not is a probe false positive and is
       rejected with no regeneration;
    2. a surviving slot narrows the baby index to r = r_lo (mod 256), and
       only that subsequence, w/256 points, is regenerated and matched on
       the full 64-bit prefix.

    Costs 2 B per slot beside the 4 B dense matrix. The hint only prunes:
    every candidate is still confirmed by exact host EC in the checker.
    ``lookup.batch(pres)`` resolves each prefix in turn (one residue scan
    per surviving residue class of each prefix); ``lookup.stats`` counts
    lookups, slots rejected by the extra bits, and residue scans.

    The residue scans share one kept tile (_ResidueTiles): the first
    scan fills K = (256*(i+1))G, i < t, the first tile of the stride-256
    stream (t = the tile of class 1; 64 MiB on the table's device at
    ``tile`` 2^20, freed with the table), and every scan reaches its
    class's first tile from K with one tile advance. A lookup that never
    scans keeps nothing.

    Each residue scan is recorded as the span ``residue`` (counts
    ``points`` regenerated, ``tiles``, ``kept``, 1 where the class's first
    tile came from the kept tile and 0 where this scan filled it, and
    ``seed_additions``, the host additions of that fill's seed, 0 on a
    kept scan), with no device bracket of its own: the checker's
    ``lookup`` brackets it."""
    sh, mk = _disc_lo_shift(htsz)
    stats = {"lookups": 0, "rejected": 0, "residue_scans": 0}
    stream = _ResidueTiles(w, tile, dense.device)

    def _residue_scan(pre64: int, r_lo: int) -> list:
        first = r_lo if r_lo else 256
        if first > w:
            return []
        stats["residue_scans"] += 1
        count = (w - first) // 256 + 1
        out = []
        done = 0
        with tracing.span("residue") as sp:
            if sp:
                kept = stream.kept is not None
                sp.count("points", count)
                sp.count("tiles", -(-count // _planar_tile(count, tile)))
                sp.count("kept", int(kept))
                sp.count("seed_additions",
                         0 if kept else min(EK.FILL_SEED, stream.t))
            for hi, lo in stream.tiles(first):
                out.extend(first + (done + i) * 256
                           for i in _match(hi, lo, pre64))
                done += hi.shape[0]
        return [r for r in out if 1 <= r <= w]

    def resolve(pre64: int) -> list:
        pre64 = int(pre64) & ((1 << 64) - 1)
        stats["lookups"] += 1
        bucket = pre64 >> (64 - htsz)
        disc = np.uint32((pre64 >> (32 - htsz)) & 0xFFFFFFFF)
        if rows is None:
            row = _u32_host(dense[bucket])
            plo = pos_lo[bucket].cpu().numpy().view(np.uint16)
        else:
            row, plo = rows(bucket)
        want_dlo = (pre64 >> sh) & mk
        r_los = set()
        for p, dd in zip(plo, row):
            if dd != disc:
                continue
            if mk and (int(p) >> 8) != want_dlo:
                stats["rejected"] += 1
                continue
            r_los.add(int(p) & 0xFF)
        res = []
        for r_lo in sorted(r_los):
            res.extend(_residue_scan(pre64, r_lo))
        return sorted(set(res))

    # lookup.batch calls resolve, not lookup: a function whose attribute
    # refers back to it would be a reference cycle, which keeps the table's
    # device memory until the garbage collector runs
    def lookup(pre64: int) -> list:
        return resolve(pre64)

    def lookup_many(pres) -> dict:
        return {p: resolve(p) for p in pres}

    lookup.batch = lookup_many
    lookup.stats = stats
    return lookup


def make_rescan_lookup(w: int, tile: int = 1 << 20, device=None):
    """Position lookup for a streamed table saved without its hint plane:
    regenerate the whole baby stream on the device tile by tile and return
    every index whose 64-bit prefix matches. ``lookup.batch(pres)`` matches
    all the prefixes in one pass (the pass is the cost: w points), with
    one host wait per tile."""
    dev = resolve_device(device)

    def lookup_many(pres) -> dict:
        pres = sorted({int(p) & ((1 << 64) - 1) for p in pres})
        out = {p: [] for p in pres}
        if not pres:
            return out
        th = torch.tensor([_i32(p >> 32) for p in pres], dtype=torch.int32,
                          device=dev)
        tl = torch.tensor([_i32(p) for p in pres], dtype=torch.int32,
                          device=dev)
        done = 0
        for hi, lo in _prefix_tiles_planar(w, tile, dev):
            i, k = torch.nonzero((hi[:, None] == th) & (lo[:, None] == tl),
                                 as_tuple=True)
            for ii, kk in zip(i.tolist(), k.tolist()):
                out[pres[kk]].append(done + ii + 1)
            done += hi.shape[0]
        return out

    def lookup(pre64: int) -> list:
        pre64 = int(pre64) & ((1 << 64) - 1)
        return lookup_many([pre64])[pre64]

    lookup.batch = lookup_many
    return lookup


def build_shard_rows(w: int, htsz: int, n_shards: int = 1, shard: int = 0,
                     window: int = DEVICE_WINDOW, tile: int = 1 << 20,
                     chunk: int = 1 << 21, mirror: bool = False,
                     device=None):
    """Rows [shard * bps, (shard + 1) * bps) of the streamed table of
    1G..wG, bps = 2^htsz / n_shards (every row with the defaults), built
    on ``device`` alone: prefixes are generated tile by tile
    (_prefix_tiles_planar), gathered into chunks of at least ``chunk`` and
    the entries of those rows scattered in place (_chunk_scatter), so peak
    device memory is the rows plus one chunk of transients. A shard needs
    no other shard: each generates the whole stream.

    Returns (dense (bps, window) int32 bits, plane, counts (bps,) int64):
    plane is the int32 position plane with ``mirror``, else the int16 hint
    plane. The counts may exceed the window (offsets_from_counts refuses
    them)."""
    dev = resolve_device(device)
    nb = 1 << htsz
    if nb % n_shards or not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} of {n_shards}: 2^{htsz} buckets "
                         f"do not split evenly")
    bps = nb // n_shards
    slots = bps * window
    flat_dense = torch.full((slots + 1,), DENSE_FILL, dtype=torch.int32,
                            device=dev)
    flat_plane = torch.zeros((slots + 1,), device=dev,
                             dtype=torch.int32 if mirror else torch.int16)
    counts = torch.zeros((bps + 1,), dtype=torch.int64, device=dev)
    buf, have, base = [], 0, 0

    def flush():
        nonlocal buf, have, base
        hi = torch.cat([b[0] for b in buf])
        lo = torch.cat([b[1] for b in buf])
        _chunk_scatter(hi, lo, flat_dense, counts,
                       None if mirror else flat_plane,
                       flat_plane if mirror else None, base, shard * bps,
                       htsz=htsz, window=window)
        base += have
        buf, have = [], 0

    for hi, lo in _prefix_tiles_planar(w, tile, dev):
        buf.append((hi, lo))
        have += hi.shape[0]
        if have >= chunk:
            flush()
    if have:
        flush()
    return (flat_dense[:-1].view(bps, window),
            flat_plane[:-1].view(bps, window), counts[:-1])


def offsets_from_counts(counts, window: int, htsz: int) -> torch.Tensor:
    """The CSR offsets ((2^htsz + 1,) uint32 bits) of a table's int64
    bucket counts; raises when a bucket overflowed the window."""
    maxb = int(counts.max())
    if maxb > window:
        raise ValueError(
            f"bucket overflow: max bucket {maxb} > window {window}; "
            f"raise htsz (now {htsz}) or window"
        )
    return PL.u32_bits(torch.cat([counts.new_zeros(1),
                                  torch.cumsum(counts, 0)]))


def build_baby_table_streamed(w: int, htsz: Optional[int] = None,
                              window: int = DEVICE_WINDOW,
                              tile: int = 1 << 20, chunk: int = 1 << 21,
                              positions: str = "auto",
                              device=None) -> BabyTable:
    """Big-w device build: every row of the table, streamed
    (build_shard_rows), so peak device memory is the table plus one chunk
    of transients.

    ``positions`` says how the checker later maps a matched prefix to baby
    indices:
      "mirror": a slot-aligned int32 position plane beside the dense
        matrix (4 B per slot more), on the same device; no hint plane is
        allocated or filled (bsgs_tpu's mirror build fills one it never
        reads).
      "rescan": the int16 hint plane (2 B per slot) and
        make_strided_lookup: a verified hit regenerates w/256 points.
      "auto": rescan at w >= 2^28, mirror below.
    """
    dev = resolve_device(device)
    if htsz is None:
        htsz = pick_htsz(w, window)
    if positions == "auto":
        positions = "rescan" if w >= STREAMED_W else "mirror"
    if positions not in ("mirror", "rescan"):
        raise ValueError(f"positions must be mirror, rescan or auto "
                         f"(got {positions!r})")
    mirror = positions == "mirror"
    dense, plane, counts = build_shard_rows(
        w, htsz, window=window, tile=tile, chunk=chunk, mirror=mirror,
        device=dev)
    offsets = offsets_from_counts(counts, window, htsz)
    return BabyTable(
        w=w, htsz=htsz, window=window, offsets=offsets, disc_sorted=None,
        pos_sorted=None, dense=dense,
        pos_dense=plane if mirror else None,
        pos_lo=None if mirror else plane,
        lookup_fn=None if mirror
        else make_strided_lookup(w, dense, plane, htsz, tile),
    )


# ---------------------------------------------------------------------------
# Probing


def probe_keys(bucket, disc, rows: ProbeRows):
    """found[i] = any(dense[bucket[i], :] == disc[i]) for int32 key rows,
    reading each row's occupied slots only: the probe kernel on the card,
    its plain version on the CPU (ops/probe_kernel.probe_rows)."""
    return probe_kernel.probe_rows(bucket, disc, rows.dense, rows.row_len)


def prefix_keys(hi, lo, htsz: int):
    """64-bit prefixes (hi32, lo32 as int32 bits) -> their (bucket, disc)
    probe keys as int32 bits."""
    bucket, disc = bucket_disc(PL.u32_value(hi), PL.u32_value(lo), htsz)
    return PL.u32_bits(bucket), PL.u32_bits(disc)


def probe(hi, lo, rows: ProbeRows, *, htsz: int):
    """Membership probe of 64-bit prefixes (hi32, lo32 as int32 bits):
    their probe keys (prefix_keys), then one probe_keys."""
    return probe_keys(*prefix_keys(hi, lo, htsz), rows)


def probe_x(x_limbs, table: BabyTable):
    """Probe full X coordinates ((..., 16) limbs) against a BabyTable."""
    hi, lo = F.x_prefix64(x_limbs)
    return probe(hi.reshape(-1), lo.reshape(-1), table.rows,
                 htsz=table.htsz).reshape(hi.shape)
