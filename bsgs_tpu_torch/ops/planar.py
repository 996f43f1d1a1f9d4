"""secp256k1 field arithmetic in PLANAR limb layout, in plain PyTorch.

The counterpart of ``bsgs_tpu/ops/planar.py``. A batch of field elements
is a ``(16, *batch)`` tensor of 16-bit limbs: the limb index in dimension 0
and the batch behind it, so the CUDA kernels (``csrc/field.cuh``) read one
limb plane after another with neighbouring threads on neighbouring
addresses.

These functions are the plain versions of the kernels' arithmetic: the CPU
path and the reference the kernels are held against on the card. They
compute in ``torch.int64`` (PyTorch on the CPU lacks ``+``, ``>>`` and
``>`` on ``uint32``); every 16x16-bit product and every column sum below
fits in 63 bits. Inputs must be canonical (< p); every output is canonical,
so results are bit-identical to the JAX package and to the kernels.

u32 planes that leave the arithmetic (key planes, the dense table) are
stored as ``int32`` tensors holding the same bits; ``u32_bits`` and
``u32_value`` convert.

The kernels' planes that live only inside an epoch or a tile advance are
packed: a ``(8, *batch)`` int32 tensor whose row i holds word i of each
element, limb 2i | limb 2i+1 << 16 (the uint32 bits), 32 bytes an element
where the limb planes take 64. ``pack_planes`` and ``unpack_planes``
convert (plain PyTorch, on either device), ``packed_col`` makes a packed
constant column on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F

NLIMBS = F.NLIMBS
LIMB_BITS = F.LIMB_BITS
LIMB_MASK = F.LIMB_MASK
_I64 = torch.int64


def const_col(x: int, device=None) -> torch.Tensor:
    """Host int -> (16, 1) int64 planar column (broadcasts over lanes)."""
    return torch.from_numpy(F.to_limbs(x).astype(np.int64)).reshape(
        NLIMBS, 1).to(device)


@functools.cache
def _const(x: int, device: torch.device) -> torch.Tensor:
    """(16,) limbs of a constant, made once per device (shared: read-only)."""
    return const_col(x, device).reshape(NLIMBS)


def const_like(x: int, ref: torch.Tensor) -> torch.Tensor:
    """Constant x shaped to broadcast against the (16, *batch) tensor ref."""
    return _const(x, ref.device).view((NLIMBS,) + (1,) * (ref.dim() - 1))


def p_col(device=None) -> torch.Tensor:
    """The prime p as a (16, 1) planar column."""
    return const_col(F.P_INT, device)


def one_col(device=None) -> torch.Tensor:
    """The field element 1 as a (16, 1) planar column."""
    return const_col(1, device)


def from_rows(a: torch.Tensor) -> torch.Tensor:
    """(..., B, 16) row-major -> (..., 16, B) planar (a view)."""
    return a.transpose(-1, -2)


def to_rows(a: torch.Tensor) -> torch.Tensor:
    """(..., 16, B) planar -> (..., B, 16) row-major (a view)."""
    return a.transpose(-1, -2)


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def u32_value(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value as int64."""
    return x.to(_I64) & 0xFFFFFFFF


PACKED_ROWS = NLIMBS // 2


def pack_planes(a: torch.Tensor) -> torch.Tensor:
    """(16, *batch) limbs (any integer type, each in [0, 2^16)) -> the
    packed (8, *batch) int32 plane: row i = limb 2i | limb 2i+1 << 16."""
    if a.shape[0] != NLIMBS:
        raise ValueError(f"expected {NLIMBS} limb rows, got {tuple(a.shape)}")
    a = a.to(_I64)
    return u32_bits(a[0::2] | (a[1::2] << LIMB_BITS))


def unpack_planes(w: torch.Tensor) -> torch.Tensor:
    """Packed (8, *batch) int32 words -> the (16, *batch) int32 limb
    plane; unpack_planes(pack_planes(a)) == a for limbs in [0, 2^16)."""
    if w.shape[0] != PACKED_ROWS:
        raise ValueError(f"expected {PACKED_ROWS} packed rows, got "
                         f"{tuple(w.shape)}")
    v = u32_value(w)
    limbs = torch.stack((v & LIMB_MASK, v >> LIMB_BITS), dim=1)
    return limbs.reshape((NLIMBS,) + tuple(w.shape[1:])).to(torch.int32)


def packed_col(x: int, device=None) -> torch.Tensor:
    """Host int -> (8, 1) packed int32 column, packed on the host."""
    return pack_planes(const_col(x)).to(device)


# ---------------------------------------------------------------------------
# Carry propagation


def _carry(cols: torch.Tensor):
    """(L, *batch) int64 columns (either sign, |c| < 2^62) -> (limbs in
    [0, 2^16), carry out of the top limb (1, *batch)). Exact: the value
    sum(cols[k] * 2^(16k)) equals sum(limbs[k] * 2^(16k)) + carry * 2^(16L)."""
    out = []
    carry = None
    for row in cols.unbind(0):
        t = row if carry is None else row + carry
        out.append(t & LIMB_MASK)
        carry = t >> LIMB_BITS
    return torch.stack(out), carry.unsqueeze(0)


def _fold_canonical(v: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """(16, *batch) limbs v plus top * 2^256, a value below 2p -> value mod p.
    v + top*2^256 - p == v + (2^32 + 977) - (1 - top) * 2^256."""
    t, c = _carry(v + const_like(F.FOLD_INT, v))
    return torch.where((top != 0) | (c != 0), t, v)


# ---------------------------------------------------------------------------
# Add / sub / compare


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(16, *batch) -> (1, *batch) bool."""
    return (a == 0).all(dim=0, keepdim=True)


def eq(a, b):
    """(16, *batch) pair -> (1, *batch) bool: equal limbs."""
    return (a == b).all(dim=0, keepdim=True)


def add_raw(a, b):
    """a + b -> (sum mod 2^256, carry (1, *batch) in {0, 1})."""
    return _carry(a + b)


def sub_raw(a, b):
    """a - b -> (difference mod 2^256, borrow (1, *batch) in {0, 1})."""
    d, c = _carry(a - b)
    return d, -c


def select(mask, a, b):
    """mask (1, *batch) bool: pick a lanes else b lanes."""
    return torch.where(mask, a, b)


def add_mod(a, b):
    s, c = _carry(a + b)
    return _fold_canonical(s, c)


def sub_mod(a, b):
    # a - b + p lies in [1, 2p): one conditional subtraction of p
    ref = a if a.dim() >= b.dim() else b
    d, c = _carry(a - b + const_like(F.P_INT, ref))
    return _fold_canonical(d, c)


def neg_mod(a):
    return sub_mod(torch.zeros_like(a), a)


# ---------------------------------------------------------------------------
# Multiplication


def _mul_cols(a, b):
    """(16, *batch) x (16, *batch) -> (31, *batch) int64 product columns
    (each a sum of at most 16 products < 2^32, so < 2^36)."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    cols = torch.zeros((2 * NLIMBS - 1,) + batch, dtype=_I64, device=a.device)
    for i in range(NLIMBS):
        cols[i : i + NLIMBS] += a[i] * b
    return cols


def reduce_512(cols):
    """(L <= 32, *batch) product columns of a value < 2^512 -> canonical
    (16, *batch) mod p, folding twice by 2^256 = 2^32 + 977."""
    lo, hi = cols[:NLIMBS], cols[NLIMBS:]
    nh = hi.shape[0]
    t = torch.zeros((NLIMBS + 2,) + cols.shape[1:], dtype=_I64,
                    device=cols.device)
    t[:NLIMBS] = lo
    t[:nh] += F.FOLD_977 * hi
    t[2 : 2 + nh] += hi
    # value lo + hi*(2^32+977) < 2^290: the part above 2^256 is < 2^34
    t, c = _carry(t)
    top = t[NLIMBS] + (t[NLIMBS + 1] << LIMB_BITS) + (c[0] << (2 * LIMB_BITS))
    s = t[:NLIMBS].clone()
    s[0] += F.FOLD_977 * top
    s[2] += top
    # now below 2^256 + 2^67: the carry is 0 or 1
    s, c2 = _carry(s)
    return _fold_canonical(s, c2)


def mul_mod(a, b):
    return reduce_512(_mul_cols(a, b))


def _sqr_cols(a):
    """(16, *batch) squared -> (31, *batch) product columns, in triangle
    form: each off-diagonal product once, doubled, plus the diagonal."""
    cols = torch.zeros((2 * NLIMBS - 1,) + a.shape[1:], dtype=_I64,
                       device=a.device)
    for i in range(NLIMBS):
        cols[2 * i] += a[i] * a[i]
        if i + 1 < NLIMBS:
            cols[2 * i + 1 : i + NLIMBS] += 2 * a[i] * a[i + 1 :]
    return cols


def sqr_mod(a):
    return reduce_512(_sqr_cols(a))


# ---------------------------------------------------------------------------
# Inversion (Fermat: a^(p-2) by the addition chain of bsgs_tpu planar)


def _sqr_n(x, n: int):
    for _ in range(n):
        x = sqr_mod(x)
    return x


def inv_mod_chain(a):
    """a^(p-2): 255 squarings and 39 multiplies (0 maps to 0)."""
    x1 = a
    x2 = mul_mod(_sqr_n(x1, 1), x1)
    x4 = mul_mod(_sqr_n(x2, 2), x2)
    x8 = mul_mod(_sqr_n(x4, 4), x4)
    x16 = mul_mod(_sqr_n(x8, 8), x8)
    x32 = mul_mod(_sqr_n(x16, 16), x16)
    x64 = mul_mod(_sqr_n(x32, 32), x32)
    x128 = mul_mod(_sqr_n(x64, 64), x64)
    t = mul_mod(_sqr_n(x128, 64), x64)
    t = mul_mod(_sqr_n(t, 16), x16)
    t = mul_mod(_sqr_n(t, 8), x8)
    t = mul_mod(_sqr_n(t, 4), x4)
    t = mul_mod(_sqr_n(t, 2), x2)
    t = mul_mod(_sqr_n(t, 1), x1)  # a^(2^223 - 1)
    # the low 33 bits of p - 2: 0 then 0xFFFFFC2D, MSB first
    for bit in bin(0xFFFFFC2D)[2:].zfill(33):
        t = sqr_mod(t)
        if bit == "1":
            t = mul_mod(t, x1)
    return t


# ---------------------------------------------------------------------------
# Inversion by division steps: the arithmetic of csrc/modinv.cuh, limb for
# limb (Bernstein-Yang "safegcd" in batches of 30 steps on signed 30-bit
# limbs, as libsecp256k1's modinv32 does it).

DIVSTEP_BITS = 30
DIVSTEP_LIMBS = 9
# The batches that inputs below 2^256 can need: 590 steps are proven enough
# for the half-delta variant (libsecp256k1 runs a fixed 20 x 30). The loop
# ends earlier where every g is 0; the kernel's kMaxBatches is this.
DIVSTEP_BATCH_CAP = 20
_M30 = (1 << DIVSTEP_BITS) - 1
_P_INV30 = pow(F.P_INT, -1, 1 << DIVSTEP_BITS)
# p = 2^256 - 2^32 - 977 as signed 30-bit limbs: 2^16 * 2^240 - 4 * 2^30 - 977
_P_S30 = (-977, -4, 0, 0, 0, 0, 0, 0, 1 << 16)


def _to_limbs30(a):
    """(16, *batch) 16-bit limbs -> (9, *batch) 30-bit limbs."""
    out = []
    for k in range(DIVSTEP_LIMBS):
        j, s = divmod(DIVSTEP_BITS * k, LIMB_BITS)
        acc = a[j] >> s
        for t in (1, 2):
            if j + t < NLIMBS:
                acc = acc | (a[j + t] << (LIMB_BITS * t - s))
        out.append(acc & _M30)
    return out


def _from_limbs30(v):
    """9 limbs in [0, 2^30) of a value below 2^256 -> (16, *batch)."""
    out = []
    for i in range(NLIMBS):
        k, s = divmod(LIMB_BITS * i, DIVSTEP_BITS)
        acc = v[k] >> s
        if s > DIVSTEP_BITS - LIMB_BITS and k + 1 < DIVSTEP_LIMBS:
            acc = acc | (v[k + 1] << (DIVSTEP_BITS - s))
        out.append(acc & LIMB_MASK)
    return torch.stack(out)


def _divsteps_30(zeta, f0, g0):
    """30 division steps on the low limbs of f and g, branch-free (masks).
    zeta = -(delta + 1/2). Returns the new zeta and the matrix (u, v; q, r)
    with 2^30 * (f, g)_new = (u f + v g, q f + r g); |u| + |v| <= 2^30 and
    |q| + |r| <= 2^30."""
    u, v = torch.ones_like(f0), torch.zeros_like(f0)
    q, r = torch.zeros_like(f0), torch.ones_like(f0)
    f, g = f0, g0
    for _ in range(DIVSTEP_BITS):
        c1 = zeta >> 63            # all ones where delta > 0
        mask2 = -(g & 1)           # all ones where g is odd
        mask1 = c1 & mask2         # both: f and g swap roles
        g = g + ((f ^ c1) & mask2) - mask1      # g +- f where g is odd
        q = q + ((u ^ c1) & mask2) - mask1
        r = r + ((v ^ c1) & mask2) - mask1
        zeta = (zeta ^ mask1) - 1  # -zeta - 2 on a swap, else zeta - 1
        f = f + (g & mask1)
        u = (u + (q & mask1)) << 1
        v = (v + (r & mask1)) << 1
        g = g >> 1
    return zeta, u, v, q, r


def _update_fg_30(f, g, u, v, q, r):
    """(f, g) <- (u f + v g, q f + r g) / 2^30, exactly."""
    cf = u * f[0] + v * g[0]
    cg = q * f[0] + r * g[0]
    nf, ng = [], []
    for i in range(1, DIVSTEP_LIMBS):
        cf = (cf >> DIVSTEP_BITS) + u * f[i] + v * g[i]
        cg = (cg >> DIVSTEP_BITS) + q * f[i] + r * g[i]
        nf.append(cf & _M30)
        ng.append(cg & _M30)
    nf.append(cf >> DIVSTEP_BITS)
    ng.append(cg >> DIVSTEP_BITS)
    return nf, ng


def _update_de_30(d, e, u, v, q, r):
    """(d, e) <- (u d + v e, q d + r e) / 2^30 mod p, with d and e kept in
    (-2p, p): p is added once for each negative input, then the multiple
    of p that clears the low 30 bits."""
    sd, se = d[-1] >> 63, e[-1] >> 63
    md = (u & sd) + (v & se)
    me = (q & sd) + (r & se)
    cd = u * d[0] + v * e[0]
    ce = q * d[0] + r * e[0]
    md = md - ((_P_INV30 * (cd & _M30) + md) & _M30)
    me = me - ((_P_INV30 * (ce & _M30) + me) & _M30)
    nd, ne = [], []
    for i in range(DIVSTEP_LIMBS):
        if i:
            cd = cd + u * d[i] + v * e[i]
            ce = ce + q * d[i] + r * e[i]
        if _P_S30[i]:
            cd = cd + _P_S30[i] * md
            ce = ce + _P_S30[i] * me
        if i:
            nd.append(cd & _M30)
            ne.append(ce & _M30)
        cd = cd >> DIVSTEP_BITS
        ce = ce >> DIVSTEP_BITS
    nd.append(cd)
    ne.append(ce)
    return nd, ne


def _carry_30(v):
    for i in range(DIVSTEP_LIMBS - 1):
        v[i + 1] = v[i + 1] + (v[i] >> DIVSTEP_BITS)
        v[i] = v[i] & _M30
    return v


def _normalize_30(d, sign):
    """d in (-2p, p), negated where sign < 0 -> 9 limbs of d mod p."""
    add = d[-1] >> 63
    neg = sign >> 63
    d = _carry_30([((x + (pl & add)) ^ neg) - neg
                   for x, pl in zip(d, _P_S30)])
    add = d[-1] >> 63
    return _carry_30([x + (pl & add) for x, pl in zip(d, _P_S30)])


def inv_mod_divsteps(a):
    """The inverse of canonical a mod p (0 maps to 0) by division steps,
    with the limbs, batches and matrices of the CUDA inversion kernel.
    Starts from f = p, g = a, d = 0, e = 1 (d a = f, e a = g mod p up to
    the powers of two divided out) and runs batches until every g is 0
    (at most DIVSTEP_BATCH_CAP, which is proven enough); then f = +-1 and the inverse is +-d. Returns (inverse (16, *batch),
    batches (*batch) int64: how many batches each lane's g needed)."""
    g = _to_limbs30(a)
    zero = torch.zeros_like(g[0])
    f = [zero + pl for pl in _P_S30]
    d = [zero] * DIVSTEP_LIMBS
    e = [zero + 1] + [zero] * (DIVSTEP_LIMBS - 1)
    zeta = zero - 1
    batches = zero.clone()
    for _ in range(DIVSTEP_BATCH_CAP):
        live = torch.stack(g).ne(0).any(dim=0)
        if not bool(live.any()):
            break
        batches += live
        zeta, u, v, q, r = _divsteps_30(zeta, f[0], g[0])
        d, e = _update_de_30(d, e, u, v, q, r)
        f, g = _update_fg_30(f, g, u, v, q, r)
    return _from_limbs30(_normalize_30(d, f[-1])), batches


# ---------------------------------------------------------------------------
# Prefix extraction (probe keys)


def x_prefix64(x):
    """(16, *batch) -> (hi32, lo32), each (1, *batch) int64: the low 64
    bits of x."""
    lo = x[0:1] | (x[1:2] << LIMB_BITS)
    hi = x[2:3] | (x[3:4] << LIMB_BITS)
    return hi, lo


def bucket_disc(hi, lo, htsz: int):
    """(hi32, lo32) int64 prefix -> (bucket, disc32) int64: the top htsz bits
    of the 64-bit prefix and the 32 bits below them."""
    if not 1 <= htsz <= 31:
        raise ValueError(f"htsz {htsz} outside [1, 31]")
    bucket = hi >> (32 - htsz)
    disc = ((hi << htsz) | (lo >> (32 - htsz))) & 0xFFFFFFFF
    return bucket, disc
