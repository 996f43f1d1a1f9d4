"""Host-exact rows of curve points (the part of ``bsgs_tpu/ops/ec.py`` the
single-device solve needs): seed rows for the planar doubling fill, and the
per-epoch job centers, which stay on the host at T <= 64."""

from __future__ import annotations

import numpy as np

from . import field as F
from ..utils import ecpy

HOST_FILL_MAX = 64


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


def fill_multiples(base_pt, step_pt, n: int):
    """Host rows (x (n, 16), y (n, 16), inf (n,)) of [base + i*step, i in
    0..n-1] for n <= HOST_FILL_MAX: the host-exact branch of bsgs_tpu's
    fill_multiples(..., with_inf=True), the same values and infinity
    flags. Larger fills go through ops/epoch_kernel.fill_multiples_planar."""
    if n > HOST_FILL_MAX:
        raise ValueError(
            f"host fill takes n <= {HOST_FILL_MAX} (got {n}); use "
            "epoch_kernel.fill_multiples_planar"
        )
    return host_row(base_pt, step_pt, n)
