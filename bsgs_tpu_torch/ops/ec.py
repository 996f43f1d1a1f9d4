"""Host-exact rows of curve points (the part of ``bsgs_tpu/ops/ec.py`` the
single-device solve needs): seed rows for the planar doubling fill, and the
per-epoch job centers, which stay on the host for any T."""

from __future__ import annotations

import numpy as np

from . import field as F
from ..utils import ecpy


def host_row(base_pt, step_pt, m: int):
    """[base + i*step for i in range(m)] computed exactly on the host.

    Returns (x (m,16), y (m,16), inf (m,)) numpy arrays; a lane at the point
    at infinity has zero coordinates and inf set."""
    xs = np.zeros((m, F.NLIMBS), np.uint32)
    ys = np.zeros((m, F.NLIMBS), np.uint32)
    inf = np.zeros((m,), bool)
    p = base_pt
    for i in range(m):
        if p is None:
            inf[i] = True
        else:
            xs[i] = F.to_limbs(p[0])
            ys[i] = F.to_limbs(p[1])
        p = ecpy.add(p, step_pt)
    return xs, ys, inf
