"""secp256k1 field constants and host limb conversion.

The host half of ``bsgs_tpu/ops/field.py``: a 256-bit field element is 16
little-endian 16-bit limbs. The device arithmetic lives in ``planar.py``
(plain PyTorch) and ``csrc/field.cuh`` (CUDA, 8x32-bit limbs internally).
"""

from __future__ import annotations

import numpy as np

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
