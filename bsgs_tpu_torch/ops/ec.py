"""secp256k1 elliptic-curve ops on row-major (..., 16) limb tensors.

Counterpart of ``bsgs_tpu/ops/ec.py``. Points are pairs of field elements
``(x, y)``; the point at infinity is tracked by boolean flags where the
API needs it.

- ``batch_inv`` inverts a (B, 16) batch through ``epoch_kernel``'s
  inversion tree (``batch_inv_planar``): on the card the Montgomery and
  inversion kernels, on the CPU their plain versions. The inverse is
  unique, so the tree's shape changes no bit of it.
- ``add_common`` adds one common point to a batch with one shared
  inversion; ``fill_multiples`` builds [base + i*step] by doubling passes
  of it from a host-exact seed row (``host_row``); ``host_row_shared``
  makes such a row from its multiples with one shared inversion.
- ``point_dbl``, ``point_add_full`` and ``scalar_mul`` are the general,
  cold-path forms (verification and tests).
"""

from __future__ import annotations

import numpy as np
import torch

from . import epoch_kernel as EK, field as F
from ..utils import ecpy


# ---------------------------------------------------------------------------
# Batch inversion


def batch_inv(a):
    """Elementwise inverse of a (B, 16) batch of NONZERO canonical values
    (callers mask zeros to 1 and flag them): one pass of
    EK.batch_inv_planar over the planar form. Returns int64 limbs."""
    v = a.movedim(-1, 0).to(torch.int32).contiguous()
    return EK.batch_inv_planar(v).movedim(0, -1).long()


# ---------------------------------------------------------------------------
# Affine point arithmetic (general, with edge cases: cold paths)


def point_dbl(x, y):
    """Affine doubling; assumes y != 0 (secp256k1 has no point of order 2)."""
    three_x2 = F.mul_small_mod(F.sqr_mod(x), 3)
    inv_2y = F.inv_mod(F.add_mod(y, y))
    lam = F.mul_mod(three_x2, inv_2y)
    x3 = F.sub_mod(F.sub_mod(F.sqr_mod(lam), x), x)
    y3 = F.sub_mod(F.mul_mod(lam, F.sub_mod(x, x3)), y)
    return x3, y3


def point_add_full(x1, y1, inf1, x2, y2, inf2):
    """Fully general affine addition with infinity flags (batched), one
    inversion: P1 at infinity gives P2, P2 at infinity gives P1, P == Q
    doubles and P == -Q flags infinity."""
    same_x = F.eq(x1, x2)
    y_cancel = F.is_zero(F.add_mod(y1, y2))
    use_dbl = same_x & ~y_cancel
    den = F.select(use_dbl, F.add_mod(y1, y1), F.sub_mod(x2, x1))
    num = F.select(use_dbl, F.mul_small_mod(F.sqr_mod(x1), 3),
                   F.sub_mod(y2, y1))
    # no inversion of 0 in degenerate lanes (their result is discarded)
    den = F.select(F.is_zero(den), F.broadcast_const(1, device=den.device),
                   den)
    lam = F.mul_mod(num, F.inv_mod(den))
    x3 = F.sub_mod(F.sub_mod(F.sqr_mod(lam), x1), x2)
    y3 = F.sub_mod(F.mul_mod(lam, F.sub_mod(x1, x3)), y1)
    inf3 = same_x & y_cancel & ~inf1 & ~inf2
    ox = F.select(inf1, x2, F.select(inf2, x1, x3))
    oy = F.select(inf1, y2, F.select(inf2, y1, y3))
    oinf = torch.where(inf1, inf2, torch.where(inf2, inf1, inf3))
    return ox, oy, oinf


def _jacobian_dbl(x, y, z):
    """2P in Jacobian coordinates (a = 0); z = 0 (infinity) stays 0."""
    a = F.sqr_mod(x)
    b = F.sqr_mod(y)
    c = F.sqr_mod(b)
    d = F.sub_mod(F.sub_mod(F.sqr_mod(F.add_mod(x, b)), a), c)
    d = F.add_mod(d, d)
    e = F.mul_small_mod(a, 3)
    x3 = F.sub_mod(F.sqr_mod(e), F.add_mod(d, d))
    y3 = F.sub_mod(F.mul_mod(e, F.sub_mod(d, x3)), F.mul_small_mod(c, 8))
    z3 = F.mul_mod(y, z)
    return x3, y3, F.add_mod(z3, z3)


def _jacobian_add(p, q):
    """P + Q in Jacobian coordinates, every case: either at infinity
    (z = 0), P == Q (the double) and P == -Q (infinity)."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    z1s, z2s = F.sqr_mod(z1), F.sqr_mod(z2)
    u1, u2 = F.mul_mod(x1, z2s), F.mul_mod(x2, z1s)
    s1 = F.mul_mod(y1, F.mul_mod(z2, z2s))
    s2 = F.mul_mod(y2, F.mul_mod(z1, z1s))
    h, r = F.sub_mod(u2, u1), F.sub_mod(s2, s1)
    hh = F.sqr_mod(h)
    hhh = F.mul_mod(h, hh)
    v = F.mul_mod(u1, hh)
    x3 = F.sub_mod(F.sub_mod(F.sqr_mod(r), hhh), F.add_mod(v, v))
    y3 = F.sub_mod(F.mul_mod(r, F.sub_mod(v, x3)), F.mul_mod(s1, hhh))
    z3 = F.mul_mod(F.mul_mod(z1, z2), h)
    same = F.is_zero(h) & F.is_zero(r)
    dx, dy, dz = _jacobian_dbl(x1, y1, z1)
    out = [F.select(same, d, s) for d, s in ((dx, x3), (dy, y3), (dz, z3))]
    inf1, inf2 = F.is_zero(z1), F.is_zero(z2)
    return tuple(F.select(inf1, b, F.select(inf2, a, o))
                 for a, b, o in zip(p, q, out))


def scalar_mul(k_limbs, px, py):
    """k * P over the 256 bits of k (batched; k as 16-bit limbs): the
    doublings 2^i P one after another, then the sum of those whose bit is
    set, pairwise in eight batched additions. The points stay in Jacobian
    coordinates and one inversion ends the sum, where bsgs_tpu inverts at
    every affine addition: the affine result is unique, so it is the same
    bits. Returns (x, y, inf); a lane at infinity holds zeros (k == 0
    gives the zeros bsgs_tpu gives)."""
    one = F.broadcast_const(1, px.shape[:-1], px.device)
    pts = [(px.long(), py.long(), one)]
    for _ in range(255):
        pts.append(_jacobian_dbl(*pts[-1]))
    bits = torch.stack([F.test_bit(k_limbs, i) for i in range(256)])
    x, y, z = (torch.stack(c) for c in zip(*pts))
    z = F.select(bits, z, torch.zeros_like(z))  # unset bits: infinity
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x, y, z = _jacobian_add((x[:h], y[:h], z[:h]),
                                (x[h:], y[h:], z[h:]))
    x, y, z = x[0], y[0], z[0]
    zi = F.inv_mod(z)
    zi2 = F.sqr_mod(zi)
    return (F.mul_mod(x, zi2), F.mul_mod(y, F.mul_mod(zi, zi2)),
            F.is_zero(z))


# ---------------------------------------------------------------------------
# Batched add of a common point


def add_common(px, py, cx, cy, dblx=None, dbly=None):
    """(px, py) + (cx, cy) for a batch of points and one broadcast common
    point, sharing one batch inversion. Degenerate lanes px == cx:
      - py == cy (P == C): the result is 2C, which callers pass as
        (dblx, dbly);
      - py == -cy (P == -C): the sum is infinity, flagged in the returned
        mask (the lane's coordinates are garbage, bsgs_tpu's garbage).
    Without (dblx, dbly) every degenerate lane is flagged. Returns (x3, y3,
    inf)."""
    cxb, cyb = cx.long().expand(px.shape), cy.long().expand(py.shape)
    d = F.sub_mod(px, cxb)
    deg = F.is_zero(d)
    d_safe = F.select(deg, F.broadcast_const(1, device=d.device), d)
    inv_d = batch_inv(d_safe.reshape(-1, F.NLIMBS)).reshape(d.shape)
    lam = F.mul_mod(F.sub_mod(py, cyb), inv_d)
    x3 = F.sub_mod(F.sub_mod(F.sqr_mod(lam), px), cxb)
    y3 = F.sub_mod(F.mul_mod(lam, F.sub_mod(cxb, x3)), cyb)
    same_y = F.eq(py, cyb)
    if dblx is None:
        return x3, y3, deg
    is_dbl = deg & same_y
    x3 = F.select(is_dbl, dblx.long(), x3)
    y3 = F.select(is_dbl, dbly.long(), y3)
    return x3, y3, deg & ~same_y


# ---------------------------------------------------------------------------
# Multiples generation (doubling fill)


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


def host_row_shared(base_pt, multiples):
    """host_row's [base + i*step for i in range(m)] from the multiples
    [i*step for i = 1..m-1], with one modular inversion for the row
    (ecpy.shared_inverses of the differences x_i - x_base). Returns
    host_row's (x, y, inf), or None where the trick does not apply: base
    at infinity, or a difference of zero (base = +-i*step: a doubling, or
    a lane at infinity), which host_row takes."""
    if base_pt is None:
        return None
    p = ecpy.P
    bx, by = base_pt
    invs = ecpy.shared_inverses([x - bx for x, _ in multiples])
    if invs is None:
        return None
    xs, ys = [bx], [by]
    for (mx, my), inv in zip(multiples, invs):
        lam = (my - by) * inv % p
        x = (lam * lam - bx - mx) % p
        xs.append(x)
        ys.append((lam * (bx - x) - by) % p)
    return (F.to_limbs_batch(xs), F.to_limbs_batch(ys),
            np.zeros((len(xs),), bool))


def _limb_point(pt, device):
    return tuple(torch.from_numpy(F.to_limbs(v).astype(np.int64)).to(device)
                 for v in pt)


def fill_multiples(base_pt, step_pt, n: int, with_inf: bool = False,
                   seed: int = 64, device=None):
    """(n, 16) x and y of [base + i*step, i = 0..n-1] on ``device``.

    The first min(seed, n) points are exact host points (host_row), then
    doubling passes: pass k adds (m * 2^k) * step to the first m * 2^k
    lanes (add_common, its double given). n is rounded up to a power of
    two inside; the result is sliced. with_inf=True also returns the mask
    of lanes whose true value is the point at infinity (their coordinates
    are garbage); a lane once at infinity stays flagged."""
    n_pow = 1 << max(0, (n - 1).bit_length())
    m = min(1 << max(0, (min(seed, n_pow) - 1).bit_length()), n_pow)
    sx, sy, sinf = host_row(base_pt, step_pt, m)
    bx = torch.zeros((n_pow, F.NLIMBS), dtype=torch.int64, device=device)
    by = torch.zeros_like(bx)
    binf = torch.zeros((n_pow,), dtype=torch.bool, device=device)
    bx[:m] = torch.from_numpy(sx.astype(np.int64))
    by[:m] = torch.from_numpy(sy.astype(np.int64))
    binf[:m] = torch.from_numpy(sinf)
    have = m
    while have < n_pow:
        c = ecpy.mul(have, step_pt)
        cx, cy = _limb_point(c, device)
        dx, dy = _limb_point(ecpy.dbl(c), device)
        nx, ny, inf = add_common(bx[:have], by[:have], cx, cy, dx, dy)
        bx[have:2 * have] = nx
        by[have:2 * have] = ny
        binf[have:2 * have] = inf | binf[:have]
        have *= 2
    if with_inf:
        return bx[:n], by[:n], binf[:n]
    return bx[:n], by[:n]


def extend_tile(bx, by, cx, cy, dx, dy):
    """Advance a whole tile by a constant point C (its double (dx, dy)
    given): tile + C, one batched add (add_common)."""
    return add_common(bx, by, cx, cy, dx, dy)
