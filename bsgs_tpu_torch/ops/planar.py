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


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def u32_value(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value as int64."""
    return x.to(_I64) & 0xFFFFFFFF


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
