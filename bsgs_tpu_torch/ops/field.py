"""secp256k1 field arithmetic on row-major (..., 16) limb tensors.

Counterpart of ``bsgs_tpu/ops/field.py``: a 256-bit field element is 16
little-endian 16-bit limbs, the batch in the leading dimensions. The host
half converts ints to limbs and back. The device ops are a thin layer over
``planar.py``: each moves the limb axis to the front and runs the planar
op, so the port has one arithmetic, the one the CUDA kernels
(``csrc/field.cuh``) are held against. That also spares the (..., 16, 16)
outer product of the JAX form. Inputs must be canonical (< p) where the
op is modular; outputs are canonical and bit-identical to the JAX
package's, ``inv_mod(0) == 0`` included.
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

# secp256k1 prime and curve constants (host ints)
P_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
# 2^256 mod p = 2^32 + 977
FOLD_INT = (1 << 32) + 977
FOLD_977 = 977


def to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """Host int -> (nlimbs,) uint32 little-endian 16-bit limbs."""
    if not 0 <= x < (1 << (LIMB_BITS * nlimbs)):
        raise ValueError(f"{x:#x} does not fit {nlimbs} limbs")
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimbs)],
        dtype=np.uint32,
    )


def from_limbs(a) -> int:
    """(L,) limbs -> host int (single element only)."""
    a = np.asarray(a)
    if a.ndim != 1:
        raise ValueError(
            "from_limbs takes a single element; use from_limbs_batch")
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a))


def from_limbs_batch(a) -> np.ndarray:
    """(..., L) limbs -> (...,) object array of host ints."""
    a = np.asarray(a)
    out = np.zeros(a.shape[:-1], dtype=object)
    for i in range(a.shape[-1]):
        out = out + (a[..., i].astype(object) << (LIMB_BITS * i))
    return out


def to_limbs_batch(xs, nlimbs: int = NLIMBS) -> np.ndarray:
    """Iterable of host ints -> (len, nlimbs) uint32."""
    return np.stack([to_limbs(int(x), nlimbs) for x in xs])


def broadcast_const(x: int, batch_shape=(), device=None) -> torch.Tensor:
    """Host int -> int64 limbs broadcast to batch_shape + (NLIMBS,)."""
    c = torch.from_numpy(to_limbs(x).astype(np.int64)).to(device)
    return c.expand(tuple(batch_shape) + (NLIMBS,))


# ---------------------------------------------------------------------------
# Device ops on (..., 16) limb tensors: a move of the limb axis, then the
# planar op. The planar form of an output is contiguous, so chained ops
# convert nothing: the row-major view of one op's output is the planar
# input of the next. Limbs are int64 on the way out (any integer dtype
# with canonical values on the way in). planar.py reads this module's
# constants when it is imported, so it is imported after them.

from . import planar as PL  # noqa: E402


def _pl(a: torch.Tensor) -> torch.Tensor:
    return a.movedim(-1, 0).long().contiguous()


def _rows(a: torch.Tensor) -> torch.Tensor:
    return a.movedim(0, -1)


def _pl2(a: torch.Tensor, b: torch.Tensor):
    """_pl of both operands, the one with fewer batch dimensions given
    leading ones, so that the planar forms broadcast as the rows do."""
    nd = max(a.dim(), b.dim())
    return (_pl(a.reshape((1,) * (nd - a.dim()) + a.shape)),
            _pl(b.reshape((1,) * (nd - b.dim()) + b.shape)))


def select(mask, a, b):
    """Where mask (batch bool) pick a else b, over the limb axis."""
    return torch.where(mask[..., None], a, b)


def add_raw(a, b):
    """256-bit a + b -> (sum mod 2^256, carry in {0, 1} int64)."""
    s, c = PL.add_raw(*_pl2(a, b))
    return _rows(s), c[0]


def sub_raw(a, b):
    """256-bit a - b -> (difference mod 2^256, borrow in {0, 1} int64)."""
    d, br = PL.sub_raw(*_pl2(a, b))
    return _rows(d), br[0]


def geq(a, b):
    """a >= b, elementwise over the batch."""
    return sub_raw(a, b)[1] == 0


def eq(a, b):
    return PL.eq(*_pl2(a, b))[0]


def is_zero(a):
    return PL.is_zero(_pl(a))[0]


def add_mod(a, b):
    return _rows(PL.add_mod(*_pl2(a, b)))


def sub_mod(a, b):
    return _rows(PL.sub_mod(*_pl2(a, b)))


def neg_mod(a):
    return _rows(PL.neg_mod(_pl(a)))


def mul_mod(a, b):
    return _rows(PL.mul_mod(*_pl2(a, b)))


def sqr_mod(a):
    return _rows(PL.sqr_mod(_pl(a)))


def mul_small_mod(a, k: int):
    """(a * k) mod p for a host int 0 <= k < 2^16."""
    if not 0 <= k < 1 << LIMB_BITS:
        raise ValueError(f"k={k} is not a 16-bit multiplier")
    return _rows(PL.reduce_512(_pl(a) * k))


def pow_mod_bits(a, e: int):
    """a^e mod p for a host int e > 0, MSB first."""
    if e <= 0:
        raise ValueError(f"exponent {e} must be positive")
    x = _pl(a)
    acc = x
    for bit in bin(e)[3:]:
        acc = PL.sqr_mod(acc)
        if bit == "1":
            acc = PL.mul_mod(acc, x)
    return _rows(acc)


def inv_mod(a):
    """a^(p-2) mod p (inv_mod(0) == 0), by the addition chain."""
    return _rows(PL.inv_mod_chain(_pl(a)))


inv_mod_chain = inv_mod


def sqrt_mod(a):
    """a^((p+1)/4) mod p: a square root where a is a quadratic residue."""
    return pow_mod_bits(a, (P_INT + 1) // 4)


# ---------------------------------------------------------------------------
# Bits and shifts of a 256-bit value


def shr_bits(a, n: int):
    """Logical right shift of a 256-bit value by 0 <= n < 256."""
    limb_sh, bit_sh = divmod(n, LIMB_BITS)
    x = a.long()
    if limb_sh:
        x = torch.cat([x[..., limb_sh:],
                       torch.zeros_like(x[..., :limb_sh])], dim=-1)
    if bit_sh:
        hi_in = torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)
        x = ((x >> bit_sh) | (hi_in << (LIMB_BITS - bit_sh))) & LIMB_MASK
    return x


def shl_bits(a, n: int):
    """Left shift of a 256-bit value by 0 <= n < 256 (mod 2^256)."""
    limb_sh, bit_sh = divmod(n, LIMB_BITS)
    x = a.long()
    if limb_sh:
        x = torch.cat([torch.zeros_like(x[..., :limb_sh]),
                       x[..., :-limb_sh]], dim=-1)
    if bit_sh:
        lo_in = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]],
                          dim=-1)
        x = ((x << bit_sh) | (lo_in >> (LIMB_BITS - bit_sh))) & LIMB_MASK
    return x


def test_bit(a, i: int):
    """Bit i of a 256-bit value, as a batch bool."""
    return ((a[..., i // LIMB_BITS].long() >> (i % LIMB_BITS)) & 1) == 1


def is_even(a):
    return (a[..., 0] & 1) == 0


def x_prefix64(x):
    """The low 64 bits of a field element as (hi32, lo32), each the uint32
    bits in an int32 tensor of the batch's shape."""
    hi, lo = PL.x_prefix64(_pl(x[..., :4]))
    return PL.u32_bits(hi[0]), PL.u32_bits(lo[0])
