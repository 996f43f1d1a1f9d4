"""The epoch and table-generation kernels, and the functions built on them.

Counterpart of ``bsgs_tpu/ops/epoch_kernel.py``. Its six Pallas kernels
are CUDA kernels here (``csrc/epoch_kernels.cu``); each has a wrapper below
and, beside it, a plain PyTorch version of the same function:

=======================  ====================================  ==============
wrapper                  replaces (bsgs_tpu/ops/epoch_kernel)  computes
=======================  ====================================  ==============
epoch_fwd_packed         _fwd_kernel                           d = Ox - Mx
                                                               prefixes
epoch_bwd_packed         _bwd_kernel                           (8, T*N) keys
mont_fwd,                _mont_fwd_kernel                      Montgomery
mont_fwd_points_packed                                         prefixes
mont_bwd,                _mont_bwd_kernel                      Montgomery
mont_bwd_points_packed                                         inverses
fermat                   _fermat_kernel                        1/a, 0 -> 0
add_const_packed         _addc_kernel                          (x, y) + C
=======================  ====================================  ==============

Dispatch: a CUDA tensor launches the kernel (a failed build or launch
raises), a CPU tensor runs the plain version; nothing else is accepted and
nothing falls back. Each launch adds one to ``_cuda.LAUNCHES[name]`` (both
entries of a Montgomery kernel count under its name).

Two layouts (``ops/planar.py``). The inversion's planes (``fermat``, the
Montgomery plane entries ``mont_fwd``/``mont_bwd``, the chain totals) are
``(16, M)`` int32 tensors of 16-bit limbs, as the JAX package's. The planes
that live only inside an epoch or a tile advance are packed, ``(8, M)``
int32 words, 32 bytes an element: the ``*_packed`` kernel wrappers take and
give them, and their plain versions (``*_packed_plain``) unpack, run the
limb-plane plain version beside them and pack. The main path runs the
packed compositions (``epoch_landing_keys_packed``, ``tile_advance_packed``,
``fill_multiples_packed``); the counterparts of the JAX package's functions
(``epoch_landing_keys``, ``add_const_planar``, ``fill_multiples_planar``)
keep their limb planes and their bits by packing around them. Key planes
and prefixes are int32 tensors holding the uint32 bits of the JAX
package's.

A chain is ``chunk_c`` elements spaced ``lanes_w`` apart inside a block of
``chunk_c * lanes_w`` columns, as in the Pallas kernels. The chain layout
changes the intermediate ``pre``/``tot`` planes, never a final inverse,
key plane or point: those are canonical, so every chain length gives the
same bits. The TPU's 64 x 256 chose long chains for VMEM. On the card one
thread walks an epoch chain: ``CHUNK_C`` = 16 was measured best on an H100
among 4, 8, 16 and 32, so a phase of T*N = 2^20 pairs leaves 65,536 chain
totals, as many threads, and one inversion launch.

The inversion (``fermat``) keeps the name of the TPU kernel it replaces
and its function, the canonical a^(p-2); on the card it runs batched
division steps (``csrc/modinv.cuh``) at a seventh of the exponentiation's
latency. So ``batch_inv_planar`` hands a batch of up to ``DIRECT_MAX``
lanes to it unfolded: an epoch launches no Montgomery pass.

The table's tile advance (``tile_advance_packed``) folds once, in chains
of ``TILE_CHUNK_C``, and its Montgomery kernels (``csrc/mont.cuh``) spread
each chain over ``mont_segments`` threads of ``MONT_SEG_LEN`` positions
with a scan in shared memory. Their points entries
(``mont_fwd_points_packed``, ``mont_bwd_points_packed``) form the
denominators from the tile's points, so a tile advance is four launches:
forward pass, inversion of the chain totals, backward pass, add-const.
``mont_fwd_segmented_plain`` and ``mont_bwd_segmented_plain`` repeat the
kernels' split in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..utils import ecpy
from . import _cuda, ec, field as F, planar as P

CHUNK_C = 16
LANES_W = 256
DIRECT_MAX = 1 << 16  # widest batch that the inversion kernel takes unfolded
# The table tile's one fold: chains of TILE_CHUNK_C, MONT_SEG_LEN positions
# a thread. Chosen on an H100 by chip_smoke.py's sweep_mont among chains of
# 4-64 and 1-4 positions a thread (PERF.md, the layout sweep).
TILE_CHUNK_C = 16
MONT_SEG_LEN = 2
MONT_MAX_SEGMENTS = 16  # threads per chain at most (blocks of 32 x 16)
FILL_SEED = 1024  # host-exact points that start a planar doubling fill

_I32 = torch.int32


def _on_cuda(*ts: torch.Tensor, rows: Optional[int] = None,
             views=()) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the plain
    version); anything else raises. rows: the row count every plane must
    have (P.PACKED_ROWS for packed planes). views: tensors the kernel takes
    as column slices of a wider plane, whose rows need only be contiguous;
    the others must be contiguous."""
    dev = ts[0].device
    for t in ts + tuple(views):
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
        if t.dtype != _I32 or t.dim() != 2:
            raise ValueError(f"expected 2-D int32 planes, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if rows is not None and t.shape[0] != rows:
            raise ValueError(f"expected {rows} rows, got {tuple(t.shape)}")
    if dev.type == "cuda":
        if not all(t.is_contiguous() for t in ts) or not all(
                t.stride(1) == 1 or t.shape[1] == 1 for t in views):
            raise ValueError("kernel inputs must be contiguous")
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _chains(m: int, chunk_c: int, lanes_w: int) -> int:
    if chunk_c < 1 or lanes_w < 1 or m <= 0 or m % (chunk_c * lanes_w):
        raise ValueError(f"{m} columns do not split into chains of "
                         f"{chunk_c} x {lanes_w}")
    return m // (chunk_c * lanes_w)


def _ones(n: int, device) -> torch.Tensor:
    """(16, n) int32 plane of the field element 1."""
    v = torch.zeros((F.NLIMBS, n), dtype=_I32, device=device)
    v[0] = 1
    return v


# ---------------------------------------------------------------------------
# Kernel 1: forward pass of the epoch (replaces _fwd_kernel)


def epoch_fwd_plain(ox, cx, *, chunk_c: int, lanes_w: int):
    t_jobs, n = cx.shape[1], ox.shape[1]
    nb = _chains(n, chunk_c, lanes_w)
    C, W = chunk_c, lanes_w
    o = ox.long().view(F.NLIMBS, 1, nb, C, W)
    m = cx.long().view(F.NLIMBS, t_jobs, 1, 1)
    run = _ones(t_jobs * nb * W, ox.device).long().view(
        F.NLIMBS, t_jobs, nb, W)
    one = P.const_like(1, run)
    pre = torch.empty((F.NLIMBS, t_jobs, nb, C, W), dtype=torch.int64,
                      device=ox.device)
    for c in range(C):
        d = P.sub_mod(o[:, :, :, c, :], m)
        d = P.select(P.is_zero(d), one, d)
        pre[:, :, :, c, :] = run
        run = P.mul_mod(run, d)
    return (pre.reshape(F.NLIMBS, t_jobs * n).to(_I32),
            run.reshape(F.NLIMBS, t_jobs * nb * W).to(_I32))


def epoch_fwd_packed_plain(ox, cx, *, chunk_c: int, lanes_w: int):
    """epoch_fwd_plain on packed planes: pre packed, tot (16, ·)."""
    pre, tot = epoch_fwd_plain(P.unpack_planes(ox), P.unpack_planes(cx),
                               chunk_c=chunk_c, lanes_w=lanes_w)
    return P.pack_planes(pre), tot


def _row_stride(cx, cy=None) -> int:
    """The row stride of the centers (a column slice of a wider packed
    plane is taken as it is), shared by cx and cy."""
    ld = cx.stride(0)
    if cy is not None and cy.stride(0) != ld:
        raise ValueError(f"centers with row strides {ld} and "
                         f"{cy.stride(0)}")
    return ld


def epoch_fwd_packed(ox, cx, *, chunk_c: int, lanes_w: int):
    """Packed offsets ox (8, N) and centers cx (8, T) -> (pre packed
    (8, T*N), tot (16, T*nb*W)): d = Ox - Mx (0 -> 1) per pair, pair order
    t*N + j; pre holds each chain's exclusive running products, tot its
    total, as the inversion takes it."""
    if not _on_cuda(ox, rows=P.PACKED_ROWS, views=(cx,)):
        return epoch_fwd_packed_plain(ox, cx, chunk_c=chunk_c,
                                      lanes_w=lanes_w)
    t_jobs, n = cx.shape[1], ox.shape[1]
    nb = _chains(n, chunk_c, lanes_w)
    pre = torch.empty((P.PACKED_ROWS, t_jobs * n), dtype=_I32,
                      device=ox.device)
    tot = torch.empty((F.NLIMBS, t_jobs * nb * lanes_w), dtype=_I32,
                      device=ox.device)
    _cuda.launch("bsgs_epoch_fwd", ox, cx, pre, tot, t_jobs, n, chunk_c,
                 lanes_w, _row_stride(cx))
    _cuda.LAUNCHES["epoch_fwd"] += 1
    return pre, tot


# ---------------------------------------------------------------------------
# Kernel 2: backward pass of the epoch (replaces _bwd_kernel)


def epoch_bwd_plain(ox, oy, cx, cy, pre, itot, *, htsz: int, chunk_c: int,
                    lanes_w: int):
    t_jobs, n = cx.shape[1], ox.shape[1]
    nb = _chains(n, chunk_c, lanes_w)
    C, W = chunk_c, lanes_w
    o_x = ox.long().view(F.NLIMBS, 1, nb, C, W)
    o_y = oy.long().view(F.NLIMBS, 1, nb, C, W)
    mx = cx.long().view(F.NLIMBS, t_jobs, 1, 1)
    my = cy.long().view(F.NLIMBS, t_jobs, 1, 1)
    pr = pre.long().view(F.NLIMBS, t_jobs, nb, C, W)
    run = itot.long().view(F.NLIMBS, t_jobs, nb, W)
    one = P.const_like(1, run)
    out = torch.zeros((8, t_jobs, nb, C, W), dtype=torch.int64,
                      device=ox.device)
    for c in reversed(range(C)):
        oxc, oyc = o_x[:, :, :, c, :], o_y[:, :, :, c, :]
        d = P.sub_mod(oxc, mx)
        exact = P.is_zero(d)
        d = P.select(exact, one, d)
        inv = P.mul_mod(run, pr[:, :, :, c, :])
        run = P.mul_mod(run, d)
        lam_p = P.mul_mod(P.sub_mod(oyc, my), inv)
        xp = P.sub_mod(P.sub_mod(P.sqr_mod(lam_p), mx), oxc)
        lam_m = P.mul_mod(P.add_mod(oyc, my), inv)
        xm = P.sub_mod(P.sub_mod(P.sqr_mod(lam_m), mx), oxc)
        bp, dp = P.bucket_disc(*P.x_prefix64(xp), htsz)
        bm, dm = P.bucket_disc(*P.x_prefix64(xm), htsz)
        for row, v in enumerate((bp, dp, bm, dm, exact.long())):
            out[row, :, :, c, :] = v[0]
    return P.u32_bits(out.reshape(8, t_jobs * n))


def epoch_bwd_packed_plain(ox, oy, cx, cy, pre, itot, *, htsz: int,
                           chunk_c: int, lanes_w: int):
    """epoch_bwd_plain on packed ox, oy, centers and pre."""
    u = P.unpack_planes
    return epoch_bwd_plain(u(ox), u(oy), u(cx), u(cy), u(pre), itot,
                           htsz=htsz, chunk_c=chunk_c, lanes_w=lanes_w)


def epoch_bwd_packed(ox, oy, cx, cy, pre, itot, *, htsz: int, chunk_c: int,
                     lanes_w: int):
    """The backward walk from the inverted chain totals itot (16, ·):
    per pair the landing keys of x(M + O) and x(M - O) and the exact flag
    (Ox == Mx), from packed ox, oy (8, N), centers (8, T) and pre.
    Returns the (8, T*N) key plane: rows bucket+, disc+, bucket-, disc-,
    exact, then three zero rows."""
    on_cuda = _on_cuda(ox, oy, pre, rows=P.PACKED_ROWS, views=(cx, cy))
    if itot.device != ox.device:
        raise ValueError(f"itot on {itot.device}, the planes on "
                         f"{ox.device}")
    _on_cuda(itot, rows=F.NLIMBS)
    if not on_cuda:
        return epoch_bwd_packed_plain(ox, oy, cx, cy, pre, itot, htsz=htsz,
                                      chunk_c=chunk_c, lanes_w=lanes_w)
    if not 1 <= htsz <= 31:
        raise ValueError(f"htsz {htsz} outside [1, 31]")
    t_jobs, n = cx.shape[1], ox.shape[1]
    _chains(n, chunk_c, lanes_w)
    out = torch.empty((8, t_jobs * n), dtype=_I32, device=ox.device)
    _cuda.launch("bsgs_epoch_bwd", ox, oy, cx, cy, pre, itot, out, t_jobs,
                 n, chunk_c, lanes_w, htsz, _row_stride(cx, cy))
    _cuda.LAUNCHES["epoch_bwd"] += 1
    return out


# ---------------------------------------------------------------------------
# Kernels 3-5: planar batch inversion (replace _mont_fwd_kernel,
# _mont_bwd_kernel, _fermat_kernel)


def mont_segments(chunk_c: int) -> int:
    """How many threads (segments) the kernels spread a chain of chunk_c
    over: MONT_SEG_LEN positions each, at most MONT_MAX_SEGMENTS."""
    return min(MONT_MAX_SEGMENTS, max(1, chunk_c // MONT_SEG_LEN))


def _segment_len(chunk_c: int, segments: int) -> int:
    if segments < 1 or chunk_c % segments:
        raise ValueError(f"a chain of {chunk_c} does not split into "
                         f"{segments} segments")
    return chunk_c // segments


def _check_mont_layout(chunk_c: int, lanes_w: int, segments: int) -> None:
    """The layouts the kernels take (csrc/epoch_kernels.cu mont_shape)."""
    seg = _segment_len(chunk_c, segments)
    if (lanes_w % 32 or segments > MONT_MAX_SEGMENTS
            or seg not in (1, 2, 4)):
        raise ValueError(
            f"the Montgomery kernels take W a multiple of 32, at most "
            f"{MONT_MAX_SEGMENTS} segments of 1, 2 or 4 positions (got "
            f"C={chunk_c}, W={lanes_w}, S={segments})")


def mont_fwd_plain(v, *, chunk_c: int, lanes_w: int):
    """The serial walk of each chain, as the TPU kernel does it."""
    m = v.shape[1]
    blocks = _chains(m, chunk_c, lanes_w)
    vv = v.long().view(F.NLIMBS, blocks, chunk_c, lanes_w)
    run = _ones(blocks * lanes_w, v.device).long().view(
        F.NLIMBS, blocks, lanes_w)
    pre = torch.empty_like(vv)
    for c in range(chunk_c):
        pre[:, :, c, :] = run
        run = P.mul_mod(run, vv[:, :, c, :])
    return (pre.reshape(F.NLIMBS, m).to(_I32),
            run.reshape(F.NLIMBS, blocks * lanes_w).to(_I32))


def mont_fwd_segmented_plain(v, *, chunk_c: int, lanes_w: int,
                             segments: int):
    """The kernel's split of each chain into segments, in plain PyTorch:
    local exclusive prefixes and each segment's product, the inclusive
    scan of the segment products in log2(segments) rounds, then each local
    prefix times its segment's offset (the product of the segments before
    it). Same outputs as mont_fwd_plain."""
    m = v.shape[1]
    blocks = _chains(m, chunk_c, lanes_w)
    S, L = segments, _segment_len(chunk_c, segments)
    vv = v.long().view(F.NLIMBS, blocks, S, L, lanes_w)
    one = _ones(blocks * S * lanes_w, v.device).long().view(
        F.NLIMBS, blocks, S, lanes_w)
    loc = torch.empty_like(vv)
    acc = one
    for i in range(L):
        loc[:, :, :, i] = acc
        acc = P.mul_mod(acc, vv[:, :, :, i])
    d = 1
    while d < S:
        nxt = acc.clone()
        nxt[:, :, d:] = P.mul_mod(acc[:, :, :-d], acc[:, :, d:])
        acc, d = nxt, 2 * d
    off = torch.cat([one[:, :, :1], acc[:, :, :-1]], dim=2)
    pre = P.mul_mod(off.unsqueeze(3), loc)
    return (pre.reshape(F.NLIMBS, m).to(_I32),
            acc[:, :, S - 1].reshape(F.NLIMBS, blocks * lanes_w).to(_I32))


def mont_fwd(v, *, chunk_c: int, lanes_w: int):
    """Nonzero v (16, m) -> (pre (16, m), tot (16, blocks*W)): exclusive
    running products along each chain and the chain totals. The kernel
    spreads a chain over mont_segments(chunk_c) threads."""
    if not _on_cuda(v):
        return mont_fwd_plain(v, chunk_c=chunk_c, lanes_w=lanes_w)
    S = mont_segments(chunk_c)
    _check_mont_layout(chunk_c, lanes_w, S)
    m = v.shape[1]
    blocks = _chains(m, chunk_c, lanes_w)
    pre = torch.empty_like(v)
    tot = torch.empty((F.NLIMBS, blocks * lanes_w), dtype=_I32,
                      device=v.device)
    _cuda.launch("bsgs_mont_fwd", v, None, None, pre, tot, m, chunk_c,
                 lanes_w, S)
    _cuda.LAUNCHES["mont_fwd"] += 1
    return pre, tot


def mont_bwd_plain(v, pre, itot, *, chunk_c: int, lanes_w: int):
    """The serial walk back along each chain, as the TPU kernel does it."""
    m = v.shape[1]
    blocks = _chains(m, chunk_c, lanes_w)
    vv = v.long().view(F.NLIMBS, blocks, chunk_c, lanes_w)
    pr = pre.long().view(F.NLIMBS, blocks, chunk_c, lanes_w)
    run = itot.long().view(F.NLIMBS, blocks, lanes_w)
    out = torch.empty_like(vv)
    for c in reversed(range(chunk_c)):
        out[:, :, c, :] = P.mul_mod(run, pr[:, :, c, :])
        run = P.mul_mod(run, vv[:, :, c, :])
    return out.reshape(F.NLIMBS, m).to(_I32)


def mont_bwd_segmented_plain(v, pre, itot, *, chunk_c: int, lanes_w: int,
                             segments: int):
    """The kernel's backward split, in plain PyTorch: each segment's
    product; q = the next segment's product (itot for the last) and its
    inclusive suffix scan, which is the running inverse at each segment's
    end; then the serial walk back over the segment. Same output as
    mont_bwd_plain."""
    m = v.shape[1]
    blocks = _chains(m, chunk_c, lanes_w)
    S, L = segments, _segment_len(chunk_c, segments)
    vv = v.long().view(F.NLIMBS, blocks, S, L, lanes_w)
    pr = pre.long().view(F.NLIMBS, blocks, S, L, lanes_w)
    seg = vv[:, :, :, 0]
    for i in range(1, L):
        seg = P.mul_mod(seg, vv[:, :, :, i])
    it = itot.long().view(F.NLIMBS, blocks, 1, lanes_w)
    acc = torch.cat([seg[:, :, 1:], it], dim=2)
    d = 1
    while d < S:
        nxt = acc.clone()
        nxt[:, :, :S - d] = P.mul_mod(acc[:, :, :S - d], acc[:, :, d:])
        acc, d = nxt, 2 * d
    out = torch.empty_like(vv)
    for i in reversed(range(L)):
        out[:, :, :, i] = P.mul_mod(acc, pr[:, :, :, i])
        acc = P.mul_mod(acc, vv[:, :, :, i])
    return out.reshape(F.NLIMBS, m).to(_I32)


def mont_bwd(v, pre, itot, *, chunk_c: int, lanes_w: int):
    """Each element's inverse from the inverted chain totals itot."""
    if not _on_cuda(v, pre, itot):
        return mont_bwd_plain(v, pre, itot, chunk_c=chunk_c, lanes_w=lanes_w)
    S = mont_segments(chunk_c)
    _check_mont_layout(chunk_c, lanes_w, S)
    m = v.shape[1]
    blocks = _chains(m, chunk_c, lanes_w)
    if pre.shape != v.shape or itot.shape != (F.NLIMBS, blocks * lanes_w):
        raise ValueError(f"pre {tuple(pre.shape)} / itot "
                         f"{tuple(itot.shape)} do not fit v {tuple(v.shape)}")
    out = torch.empty_like(v)
    _cuda.launch("bsgs_mont_bwd", v, None, None, pre, itot, out, m, chunk_c,
                 lanes_w, S)
    _cuda.LAUNCHES["mont_bwd"] += 1
    return out


# The points entry: the table tile's denominators formed in the kernels.


def tile_den_plain(xs, ys, cx):
    """The denominators of add_const_planar: den = Cx - x, or 2y on the
    doubling lanes x == Cx. (16, m) int64."""
    x, cxl = xs.long(), cx.long()
    diff = P.sub_mod(cxl, x)
    return P.select(P.is_zero(diff), P.add_mod(ys.long(), ys.long()), diff)


def _tile_blocks(m: int, chunk_c: int, lanes_w: int) -> int:
    """Blocks of chains over m columns, the last one padded with ones."""
    span = chunk_c * lanes_w
    if chunk_c < 1 or lanes_w < 1 or m <= 0:
        raise ValueError(f"{m} columns in chains of {chunk_c} x {lanes_w}")
    return -(-m // span)


def _padded(v, width: int):
    """(16, m) -> (16, width) with ones in the new columns."""
    pad = width - v.shape[1]
    return torch.cat([v, _ones(pad, v.device).to(v.dtype)], dim=1) if pad \
        else v


def _check_points(xs, ys, cx) -> bool:
    """The points entry's inputs: packed (8, m) xs and ys and a packed
    (8, 1) column, on one device. True for the kernel, False for the plain
    version."""
    on_cuda = _on_cuda(xs, ys, cx, rows=P.PACKED_ROWS)
    if ys.shape != xs.shape or cx.shape != (P.PACKED_ROWS, 1):
        raise ValueError(f"points {tuple(xs.shape)} / {tuple(ys.shape)} and "
                         f"column {tuple(cx.shape)} do not fit")
    return on_cuda


def mont_fwd_points_plain(xs, ys, cx, *, chunk_c: int, lanes_w: int,
                          segments: Optional[int] = None):
    """The points entry's plain version: tile_den_plain, padded with ones
    to whole blocks of chains, then the serial walk (or, given segments,
    the kernel's segmented one)."""
    m = xs.shape[1]
    width = _tile_blocks(m, chunk_c, lanes_w) * chunk_c * lanes_w
    den = _padded(tile_den_plain(xs, ys, cx), width)
    if segments is None:
        pre, tot = mont_fwd_plain(den, chunk_c=chunk_c, lanes_w=lanes_w)
    else:
        pre, tot = mont_fwd_segmented_plain(den, chunk_c=chunk_c,
                                            lanes_w=lanes_w,
                                            segments=segments)
    return pre[:, :m], tot


def mont_bwd_points_plain(xs, ys, cx, pre, itot, *, chunk_c: int,
                          lanes_w: int, segments: Optional[int] = None):
    """The backward pass of mont_fwd_points_plain."""
    m = xs.shape[1]
    width = _tile_blocks(m, chunk_c, lanes_w) * chunk_c * lanes_w
    den = _padded(tile_den_plain(xs, ys, cx), width)
    pre = _padded(pre, width)
    if segments is None:
        out = mont_bwd_plain(den, pre, itot, chunk_c=chunk_c,
                             lanes_w=lanes_w)
    else:
        out = mont_bwd_segmented_plain(den, pre, itot, chunk_c=chunk_c,
                                       lanes_w=lanes_w, segments=segments)
    return out[:, :m]


def mont_fwd_points_packed_plain(xs, ys, cx, *, chunk_c: int, lanes_w: int,
                                 segments: Optional[int] = None):
    """mont_fwd_points_plain on the packed points and column: pre packed,
    tot (16, ·)."""
    u = P.unpack_planes
    pre, tot = mont_fwd_points_plain(u(xs), u(ys), u(cx), chunk_c=chunk_c,
                                     lanes_w=lanes_w, segments=segments)
    return P.pack_planes(pre), tot


def mont_bwd_points_packed_plain(xs, ys, cx, pre, itot, *, chunk_c: int,
                                 lanes_w: int,
                                 segments: Optional[int] = None):
    """mont_bwd_points_plain on packed points, column and pre: the
    inverses packed."""
    u = P.unpack_planes
    return P.pack_planes(mont_bwd_points_plain(
        u(xs), u(ys), u(cx), u(pre), itot, chunk_c=chunk_c, lanes_w=lanes_w,
        segments=segments))


def mont_fwd_points_packed(xs, ys, cx, *, chunk_c: int, lanes_w: int,
                           segments: Optional[int] = None):
    """mont_fwd over the denominators of the tile (xs, ys) + C (packed
    (8, m) points, cx the step's packed (8, 1) x column; tile_den_plain),
    which the kernel forms in registers: no den plane is written. Any width
    m: the last block of chains is padded with ones. Returns (pre packed
    (8, m), tot (16, blocks*W)). On the CPU it runs the plain version of
    the kernel's own split (a few wide steps in place of chunk_c narrow
    ones: the CPU pays per step)."""
    S = mont_segments(chunk_c) if segments is None else segments
    if not _check_points(xs, ys, cx):
        return mont_fwd_points_packed_plain(xs, ys, cx, chunk_c=chunk_c,
                                            lanes_w=lanes_w, segments=S)
    m = xs.shape[1]
    blocks = _tile_blocks(m, chunk_c, lanes_w)
    _check_mont_layout(chunk_c, lanes_w, S)
    pre = torch.empty_like(xs)
    tot = torch.empty((F.NLIMBS, blocks * lanes_w), dtype=_I32,
                      device=xs.device)
    _cuda.launch("bsgs_mont_fwd", xs, ys, cx, pre, tot, m, chunk_c, lanes_w,
                 S)
    _cuda.LAUNCHES["mont_fwd"] += 1
    return pre, tot


def mont_bwd_points_packed(xs, ys, cx, pre, itot, *, chunk_c: int,
                           lanes_w: int, segments: Optional[int] = None):
    """mont_bwd over the tile's denominators (mont_fwd_points_packed): 1/den
    per lane, packed (8, m), from the packed pre and the inverted totals
    itot (16, blocks*W)."""
    S = mont_segments(chunk_c) if segments is None else segments
    on_cuda = _check_points(xs, ys, cx)
    _on_cuda(xs, pre, rows=P.PACKED_ROWS)
    _on_cuda(xs, itot)
    m = xs.shape[1]
    blocks = _tile_blocks(m, chunk_c, lanes_w)
    if pre.shape != xs.shape or itot.shape != (F.NLIMBS, blocks * lanes_w):
        raise ValueError(f"pre {tuple(pre.shape)} / itot "
                         f"{tuple(itot.shape)} do not fit {m} lanes")
    if not on_cuda:
        return mont_bwd_points_packed_plain(xs, ys, cx, pre, itot,
                                            chunk_c=chunk_c, lanes_w=lanes_w,
                                            segments=S)
    _check_mont_layout(chunk_c, lanes_w, S)
    out = torch.empty_like(xs)
    _cuda.launch("bsgs_mont_bwd", xs, ys, cx, pre, itot, out, m, chunk_c,
                 lanes_w, S)
    _cuda.LAUNCHES["mont_bwd"] += 1
    return out


def fermat_plain(x):
    """The plain version: a^(p-2) by the addition chain, an algorithm
    independent of the kernel's."""
    return P.inv_mod_chain(x.long()).to(_I32)


def fermat_divsteps_plain(x):
    """The kernel's own algorithm in plain PyTorch, limb for limb (batched
    division steps). Returns (inverses, batches needed per lane)."""
    inv, batches = P.inv_mod_divsteps(x.long())
    return inv.to(_I32), batches


def fermat(x):
    """Elementwise inverse mod p of a canonical (16, m) plane, the value
    a^(p-2) (0 maps to 0). The kernel computes it by batched division
    steps, the CPU path by the exponentiation; both are canonical, so the
    bits are the same."""
    if not _on_cuda(x):
        return fermat_plain(x)
    if x.shape[1] == 0:
        return torch.empty_like(x)
    out = torch.empty_like(x)
    _cuda.launch("bsgs_modinv", x, out, x.shape[1])
    _cuda.LAUNCHES["fermat"] += 1
    return out


def batch_inv_planar(v, *, chunk_c: int = CHUNK_C, lanes_w: int = LANES_W,
                     direct_max: int = DIRECT_MAX):
    """Elementwise inverse of a planar (16, m) batch of NONZERO values. Up
    to direct_max lanes go to the inversion kernel as they are; a wider
    batch takes one Montgomery fold level (chains of chunk_c) per recursion
    on its chain totals. Pads with ones to a multiple of C*W, as bsgs_tpu's
    batch_inv_planar does. The tree's shape changes no output bit."""
    m = v.shape[1]
    C, W = chunk_c, lanes_w
    if m <= direct_max:
        return fermat(v)
    if m % (C * W):
        vp = _padded(v, -(-m // (C * W)) * C * W)
        return batch_inv_planar(vp, chunk_c=C, lanes_w=W,
                                direct_max=direct_max)[:, :m]
    pre, tot = mont_fwd(v, chunk_c=C, lanes_w=W)
    itot = batch_inv_planar(tot, chunk_c=C, lanes_w=W, direct_max=direct_max)
    return mont_bwd(v, pre, itot, chunk_c=C, lanes_w=W)


# ---------------------------------------------------------------------------
# Kernel 6: add a common point (replaces _addc_kernel)


def add_const_plain(xs, ys, inv, cx, cy):
    x, y, iv = xs.long(), ys.long(), inv.long()
    cxl, cyl = cx.long(), cy.long()
    exact = P.is_zero(P.sub_mod(cxl, x))
    x2 = P.sqr_mod(x)
    num = P.select(exact, P.add_mod(P.add_mod(x2, x2), x2),
                   P.sub_mod(cyl, y))
    lam = P.mul_mod(num, iv)
    x3 = P.sub_mod(P.sqr_mod(lam), P.add_mod(x, cxl))
    y3 = P.sub_mod(P.mul_mod(lam, P.sub_mod(x, x3)), y)
    hi, lo = P.x_prefix64(x3)
    return x3.to(_I32), y3.to(_I32), P.u32_bits(torch.cat([hi, lo]))


def add_const_packed_plain(xs, ys, inv, cx, cy):
    """add_const_plain on packed planes and columns: x3, y3 packed."""
    u = P.unpack_planes
    x3, y3, prefix = add_const_plain(u(xs), u(ys), u(inv), u(cx), u(cy))
    return P.pack_planes(x3), P.pack_planes(y3), prefix


def add_const_packed(xs, ys, inv, cx, cy):
    """(xs, ys) + C lane-wise given inv = 1/den (den = Cx - x, or 2y on the
    doubling lanes x == Cx), every plane packed (8, m), cx and cy packed
    (8, 1) columns. Returns (x3, y3 packed, prefix (2, m)) with prefix rows
    (hi32, lo32) of x3's low 64 bits."""
    if not _on_cuda(xs, ys, inv, cx, cy, rows=P.PACKED_ROWS):
        return add_const_packed_plain(xs, ys, inv, cx, cy)
    m = xs.shape[1]
    if (ys.shape != xs.shape or inv.shape != xs.shape
            or cx.shape != (P.PACKED_ROWS, 1)
            or cy.shape != (P.PACKED_ROWS, 1)):
        raise ValueError(f"points {tuple(xs.shape)}, {tuple(ys.shape)}, "
                         f"{tuple(inv.shape)} and columns {tuple(cx.shape)}, "
                         f"{tuple(cy.shape)} do not fit")
    x3, y3 = torch.empty_like(xs), torch.empty_like(ys)
    prefix = torch.empty((2, m), dtype=_I32, device=xs.device)
    _cuda.launch("bsgs_add_const", xs, ys, inv, cx, cy, x3, y3, prefix, m)
    _cuda.LAUNCHES["add_const"] += 1
    return x3, y3, prefix


def tile_lanes(m: int, chunk_c: int) -> int:
    """Lanes per block of chains for an add-const pass over m lanes:
    LANES_W, or as few multiples of 32 as cover a narrow batch in one
    block, so that padding a fill pass of 1,024 lanes does not make
    LANES_W * chunk_c."""
    return min(LANES_W, 32 * -(-m // (32 * chunk_c)))


def tile_advance_packed(xs, ys, cx_col, cy_col, *,
                        chunk_c: int = TILE_CHUNK_C):
    """Packed (8, m) batch + one common point C (packed (8, 1) columns)
    with one shared batch inversion, any width m: add_const_planar's
    function on packed planes, which the table build and the fills run.
    Lanes with x == Cx are doublings (P == +C; generation never meets
    P == -C). The inversion folds once, in chains of chunk_c (tile_lanes
    apart), over denominators that the Montgomery passes form from the
    points themselves: on the card mont_fwd, the inversion of the chain
    totals, mont_bwd and add_const, four launches and nothing else.
    Returns (x3, y3 packed, prefix_hi, prefix_lo)."""
    kw = dict(chunk_c=chunk_c, lanes_w=tile_lanes(xs.shape[1], chunk_c))
    pre, tot = mont_fwd_points_packed(xs, ys, cx_col, **kw)
    itot = batch_inv_planar(tot)
    inv = mont_bwd_points_packed(xs, ys, cx_col, pre, itot, **kw)
    x3, y3, prefix = add_const_packed(xs, ys, inv, cx_col, cy_col)
    return x3, y3, prefix[0], prefix[1]


def add_const_planar(xs, ys, cx_col, cy_col, *,
                     chunk_c: int = TILE_CHUNK_C):
    """Planar (16, m) batch + one common point C ((16, 1) columns): the
    counterpart of bsgs_tpu's add_const_planar, its bits and signature,
    through tile_advance_packed. Returns (x3, y3, prefix_hi, prefix_lo)."""
    pk = P.pack_planes
    x3, y3, hi, lo = tile_advance_packed(pk(xs), pk(ys), pk(cx_col),
                                         pk(cy_col), chunk_c=chunk_c)
    return P.unpack_planes(x3), P.unpack_planes(y3), hi, lo


def fill_multiples_packed(base_pt, step_pt, n: int, device=None):
    """Packed (8, n) x/y planes of [base + i*step, i = 0..n-1], n a power
    of two: a host-exact seed row of min(FILL_SEED, n) points, packed on
    the host, then doubling passes (tile_advance_packed) that add
    (have*step) to lanes [0, have) and place the sums at [have, 2*have) in
    place. For n <= FILL_SEED the result is the host row.

    No lane may be the point at infinity."""
    dev = resolve_device(device)
    if n < 1 or n & (n - 1):
        raise ValueError(f"n must be a power of two (got {n})")
    seed = min(FILL_SEED, n)
    sx, sy, sinf = ec.host_row(base_pt, step_pt, seed)
    if sinf.any():
        raise ValueError("infinity lane in planar fill seed")
    xs = torch.zeros((P.PACKED_ROWS, n), dtype=_I32)
    ys = torch.zeros((P.PACKED_ROWS, n), dtype=_I32)
    xs[:, :seed] = P.pack_planes(torch.from_numpy(sx.T.astype("int64")))
    ys[:, :seed] = P.pack_planes(torch.from_numpy(sy.T.astype("int64")))
    xs, ys = xs.to(dev), ys.to(dev)
    have = seed
    while have < n:
        c_pt = ecpy.mul(have, step_pt)
        x3, y3, _, _ = tile_advance_packed(
            xs[:, :have].contiguous(), ys[:, :have].contiguous(),
            P.packed_col(c_pt[0], dev), P.packed_col(c_pt[1], dev))
        xs[:, have : 2 * have] = x3
        ys[:, have : 2 * have] = y3
        have *= 2
    return xs, ys


def fill_multiples_planar(base_pt, step_pt, n: int, device=None):
    """Planar (16, n) x/y planes of [base + i*step, i = 0..n-1], n a power
    of two: the counterpart of bsgs_tpu's fill_multiples_planar, through
    fill_multiples_packed. No lane may be the point at infinity."""
    xs, ys = fill_multiples_packed(base_pt, step_pt, n, device=device)
    return P.unpack_planes(xs), P.unpack_planes(ys)


# ---------------------------------------------------------------------------
# The epoch's key plane


def epoch_landing_keys_packed(cx, cy, ox, oy, *, htsz: int,
                              chunk_c: int = CHUNK_C,
                              lanes_w: int = LANES_W):
    """All probe keys of one epoch phase, T centers x N offsets, on packed
    planes: centers (8, T) (a column slice of a wider plane is taken as it
    is), offsets (8, N) with N % (chunk_c * lanes_w) == 0. Returns the
    (8, T*N) key plane (rows: bucket+, disc+, bucket-, disc-, exact; pair
    order t*N + j): forward pass, inversion of the chain totals, backward
    pass."""
    pre, tot = epoch_fwd_packed(ox, cx, chunk_c=chunk_c, lanes_w=lanes_w)
    itot = batch_inv_planar(tot, chunk_c=chunk_c, lanes_w=lanes_w)
    return epoch_bwd_packed(ox, oy, cx, cy, pre, itot, htsz=htsz,
                            chunk_c=chunk_c, lanes_w=lanes_w)


def epoch_landing_keys(centers_x_pl, centers_y_pl, ox_pl, oy_pl, *,
                       htsz: int, chunk_c: int = CHUNK_C,
                       lanes_w: int = LANES_W):
    """All probe keys of one epoch: T centers x N offsets.

    Inputs are planar: centers (16, T), offsets (16, N) with
    N % (chunk_c * lanes_w) == 0. Returns the (8, T*N) key plane (rows:
    bucket+, disc+, bucket-, disc-, exact; pair order t*N + j), the same
    bits as bsgs_tpu's epoch_landing_keys, through
    epoch_landing_keys_packed."""
    pk = P.pack_planes
    return epoch_landing_keys_packed(
        pk(centers_x_pl), pk(centers_y_pl), pk(ox_pl), pk(oy_pl), htsz=htsz,
        chunk_c=chunk_c, lanes_w=lanes_w)
