"""secp256k1 in plain Python integers: the benchmark's own curve.

Nothing here comes from the program under test. Affine arithmetic is the
textbook definition; multiples of G go through a fixed-base comb in
Jacobian coordinates, so that a few thousand of them (the traffic's
pubkeys, the judged landings) take well under a second on the host.
"""

from __future__ import annotations

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)

# Points are (x, y) tuples of ints; None is the point at infinity.


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return 0 <= x < P and 0 <= y < P and (y * y - x * x * x - 7) % P == 0


def neg(pt):
    return None if pt is None else (pt[0], (-pt[1]) % P)


def dbl(pt):
    if pt is None or pt[1] == 0:
        return None
    x, y = pt
    lam = 3 * x * x * pow(2 * y, -1, P) % P
    x3 = (lam * lam - 2 * x) % P
    return x3, (lam * (x - x3) - y) % P


def add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0]:
        return dbl(a) if (a[1] + b[1]) % P else None
    lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, P) % P
    x3 = (lam * lam - a[0] - b[0]) % P
    return x3, (lam * (a[0] - x3) - a[1]) % P


def sub(a, b):
    return add(a, neg(b))


def mul(k: int, pt=G):
    """k * pt by double-and-add (any point; slow, for the tests)."""
    k %= N
    acc = None
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = dbl(pt)
        k >>= 1
    return acc


# -- Jacobian (X, Y, Z): x = X/Z^2, y = Y/Z^3; Z == 0 is infinity ----------

def _jdbl(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    yy = Y * Y % P
    s = 4 * X * yy % P
    m = 3 * X * X % P
    x3 = (m * m - 2 * s) % P
    return x3, (m * (s - x3) - 8 * yy * yy) % P, 2 * Y * Z % P


def _jadd_affine(p, q):
    """Jacobian p + affine q (q not infinity)."""
    X, Y, Z = p
    if Z == 0:
        return q[0], q[1], 1
    zz = Z * Z % P
    u2 = q[0] * zz % P
    s2 = q[1] * zz * Z % P
    h = (u2 - X) % P
    r = (s2 - Y) % P
    if h == 0:
        return _jdbl(p) if r == 0 else (1, 1, 0)
    hh = h * h % P
    hhh = h * hh % P
    v = X * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return x3, (r * (v - x3) - Y * hhh) % P, Z * h % P


def to_affine_batch(points):
    """Jacobian points -> affine (None for infinity) with one inversion."""
    zs = [p[2] for p in points]
    pre, acc = [], 1
    for z in zs:
        pre.append(acc)
        if z:
            acc = acc * z % P
    inv = pow(acc, -1, P)
    out = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        X, Y, Z = points[i]
        if not Z:
            continue
        zi = inv * pre[i] % P
        inv = inv * Z % P
        zi2 = zi * zi % P
        out[i] = (X * zi2 % P, Y * zi2 * zi % P)
    return out


class CombG:
    """Fixed-base comb: table[i][d] = d * 2^(8i) * G, grown as scalars
    need more windows."""

    def __init__(self):
        self.table: list[list] = []

    def _grow(self, windows: int):
        while len(self.table) < windows:
            base = G if not self.table else self._times256(self.table[-1][1])
            row, acc = [None, base], (base[0], base[1], 1)
            jac = []
            for _ in range(2, 256):
                acc = _jadd_affine(acc, base)
                jac.append(acc)
            row.extend(to_affine_batch(jac))
            self.table.append(row)

    @staticmethod
    def _times256(pt):
        j = (pt[0], pt[1], 1)
        for _ in range(8):
            j = _jdbl(j)
        return to_affine_batch([j])[0]

    def mul_jacobian(self, k: int):
        k %= N
        self._grow(max(1, -(-k.bit_length() // 8)))
        acc = (1, 1, 0)
        i = 0
        while k:
            d = k & 0xFF
            if d:
                acc = _jadd_affine(acc, self.table[i][d])
            k >>= 8
            i += 1
        return acc

    def mul(self, k: int):
        return to_affine_batch([self.mul_jacobian(k)])[0]

    def mul_many(self, ks):
        return to_affine_batch([self.mul_jacobian(k) for k in ks])


def encode_pubkey(pt) -> str:
    """Compressed SEC1 hex of a point."""
    return ("03" if pt[1] & 1 else "02") + f"{pt[0]:064x}"


def host_additions(count: int = 1000) -> float:
    """Seconds of ``count`` affine additions P += G, a fixed pure-Python
    workload that shows how fast this host runs the interpreter."""
    import time

    pt = dbl(G)
    t0 = time.perf_counter()
    for _ in range(count):
        pt = add(pt, G)
    took = time.perf_counter() - t0
    if not is_on_curve(pt):
        raise AssertionError("host control left the curve")
    return took
