"""Carry the JAX package's state across to the port's tensors.

``bsgs_tpu`` keeps its table and offset planes as uint32 arrays; the port
keeps the same bits in int32 tensors. These functions take that state as
numpy arrays (``np.asarray`` of the JAX arrays) and return the port's
objects, so both packages can probe one identical table; ``u32`` views a
port tensor back as uint32 for comparison.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .models.table import BabyTable


def from_u32(a, device=None) -> torch.Tensor:
    """uint32 (or any 32-bit) array -> int32 tensor with the same bits."""
    dev = resolve_device(device)
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.itemsize != 4:
        raise ValueError(f"expected a 32-bit array, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(dev)


def u32(t: torch.Tensor) -> np.ndarray:
    """Port int32 tensor -> numpy uint32 array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def baby_table(*, w: int, htsz: int, window: int, offsets, disc_sorted,
               pos_sorted, dense, sorted_pre: Optional[np.ndarray] = None,
               device=None) -> BabyTable:
    """A bsgs_tpu BabyTable's arrays -> the port's BabyTable on device."""
    dev = resolve_device(device)
    return BabyTable(
        w=w, htsz=htsz, window=window,
        offsets=from_u32(offsets, dev),
        disc_sorted=from_u32(disc_sorted, dev),
        pos_sorted=from_u32(pos_sorted, dev),
        dense=from_u32(dense, dev),
        sorted_pre=None if sorted_pre is None
        else np.asarray(sorted_pre, dtype=np.uint64),
    )


def offset_planes(ox_pl, oy_pl, device=None):
    """Planar (16, N) uint32 offset planes -> the port's int32 planes."""
    return from_u32(ox_pl, device), from_u32(oy_pl, device)
