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
from .models.table import BabyTable, make_strided_lookup


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


def _opt_u32(a, dev):
    return None if a is None else from_u32(a, dev)


def baby_table(*, w: int, htsz: int, window: int, offsets, dense,
               disc_sorted=None, pos_sorted=None,
               sorted_pre: Optional[np.ndarray] = None, pos_dense=None,
               pos_lo=None, tile: int = 1 << 20, device=None) -> BabyTable:
    """A bsgs_tpu BabyTable's arrays -> the port's BabyTable on device.

    A packed or device-built table brings its CSR arrays (``disc_sorted``,
    ``pos_sorted``, maybe ``sorted_pre``); a streamed one brings none, but
    its position mirror ``pos_dense`` or its uint16 hint plane ``pos_lo``.
    The hint's bits go into an int16 tensor and ``lookup_fn`` is rebuilt
    over the port's own tensors (make_strided_lookup with ``tile``)."""
    dev = resolve_device(device)
    dense_t = from_u32(dense, dev)
    hint = lookup = None
    if pos_lo is not None:
        bits = np.ascontiguousarray(np.asarray(pos_lo))
        if bits.dtype != np.uint16:
            raise ValueError(f"expected a uint16 hint plane, got "
                             f"{bits.dtype}")
        hint = torch.from_numpy(bits.view(np.int16).copy()).to(dev)
        lookup = make_strided_lookup(w, dense_t, hint, htsz, tile)
    return BabyTable(
        w=w, htsz=htsz, window=window,
        offsets=from_u32(offsets, dev),
        disc_sorted=_opt_u32(disc_sorted, dev),
        pos_sorted=_opt_u32(pos_sorted, dev),
        dense=dense_t,
        sorted_pre=None if sorted_pre is None
        else np.asarray(sorted_pre, dtype=np.uint64),
        pos_dense=_opt_u32(pos_dense, dev),
        pos_lo=hint, lookup_fn=lookup,
    )


def offset_planes(ox_pl, oy_pl, device=None):
    """Planar (16, N) uint32 offset planes -> the port's int32 planes."""
    return from_u32(ox_pl, device), from_u32(oy_pl, device)
