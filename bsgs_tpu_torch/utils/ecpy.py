"""Pure-Python secp256k1 oracle (host-side exact arithmetic).

This is the trusted reference path of the framework: every device-side
candidate hit is independently re-derived here before being reported, the
same "never trust the accelerator" strategy the reference uses with its
CPU checker thread (reference: 1_9_7File.pb:3933-4296), and every device
kernel is unit-tested against this module.

Python integers are arbitrary-precision and exact, so this file is the
simplest possible correct implementation — clarity over speed — with one
exception: a multiplication of the base G, which the checker runs for
every hit record and candidate, goes through a window table of G built
once per process (``mul``). The hot path never runs here.
"""

from __future__ import annotations

import threading

# secp256k1 domain parameters
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
A = 0
B = 7

# Affine points are (x, y) tuples; the point at infinity is None.
G = (GX, GY)
INF = None


def inv_mod(a: int, m: int = P) -> int:
    return pow(a, -1, m)


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + A * x + B)) % P == 0


def neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P)


def add(p1, p2):
    """Affine point addition with full edge-case handling."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return dbl(p1)
    lam = ((y2 - y1) * inv_mod(x2 - x1)) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def dbl(pt):
    if pt is None:
        return None
    x, y = pt
    if y == 0:
        return None
    lam = ((3 * x * x + A) * inv_mod(2 * y)) % P
    x3 = (lam * lam - 2 * x) % P
    y3 = (lam * (x - x3) - y) % P
    return (x3, y3)


WINDOW = 8  # bits of k a row of the fixed-base table covers
DIGIT = (1 << WINDOW) - 1
ROWS = -(-N.bit_length() // WINDOW)
_table = None  # _table[i][d] = d * 2^(8i) * G, d = 1..255 (index 0 unused)
_table_lock = threading.Lock()
_fixed_muls = 0
_count_lock = threading.Lock()


def fixed_muls() -> int:
    """Multiplications of the base G so far in this process (utils/tracing
    counts the change over a span)."""
    return _fixed_muls


def shared_inverses(ds):
    """The inverses mod P of ds with one inversion for all (Montgomery's
    trick): the prefix products, one inverse of their product, then each
    inverse walking back. None where a d is 0 mod P."""
    prods = [1]
    for d in ds:
        prods.append(prods[-1] * d % P)
    if not prods[-1]:
        return None
    inv = inv_mod(prods[-1])
    out = [0] * len(ds)
    for i in range(len(ds) - 1, -1, -1):
        out[i] = inv * prods[i] % P
        inv = inv * ds[i] % P
    return out


def _table_row(base):
    """[d*base for d = 1..2^WINDOW], by doubling levels: level j holds
    d*base for d = 1..2^j and adds top = 2^j*base to each d < 2^j, and
    doubles top, with one shared inversion. No difference is zero: d*base
    = +-top needs d = +-2^j mod N, and d < 2^j < N, the order of base; and
    no y is zero, since N is odd."""
    row = [base]
    for _ in range(WINDOW):
        tx, ty = top = row[-1]
        invs = shared_inverses([x - tx for x, _ in row[:-1]] + [2 * ty])
        for (x, y), inv in zip(row[:-1], invs):
            lam = (y - ty) * inv % P
            x3 = (lam * lam - x - tx) % P
            row.append((x3, (lam * (tx - x3) - ty) % P))
        lam = 3 * tx * tx * invs[-1] % P
        x3 = (lam * lam - 2 * tx) % P
        row.append((x3, (lam * (tx - x3) - ty) % P))
    return row


def _fixed_table():
    """The window table of G, built at the first call in the process."""
    global _table
    with _table_lock:
        if _table is None:
            rows, base = [], G
            for _ in range(ROWS):
                row = _table_row(base)
                rows.append([None] + row[:-1])
                base = row[-1]  # 2^WINDOW * base
            _table = rows
    return _table


def _madd(acc, pt):
    """Jacobian acc (X, Y, Z), or None, plus affine pt (a mixed addition).
    Where H = 0 (acc = +-pt: a doubling or the point at infinity) the
    exact affine ``add`` takes the sum."""
    if acc is None:
        return (pt[0], pt[1], 1)
    x1, y1, z1 = acc
    zz = z1 * z1 % P
    h = (pt[0] * zz - x1) % P
    r = (pt[1] * zz * z1 - y1) % P
    if h == 0:
        s = add(_affine(acc), pt)
        return None if s is None else (s[0], s[1], 1)
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return (x3, (r * (v - x3) - y1 * hhh) % P, z1 * h % P)


def _affine(acc):
    if acc is None:
        return None
    x, y, z = acc
    zi = inv_mod(z)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _mul_fixed(k: int):
    """k*G for 0 < k < N: one mixed addition of the table a nonzero byte
    of k, from the low byte up, and one inversion at the end. The windows
    never meet a doubling or the point at infinity: before window i's
    digit d is added, the partial scalar s (k's low i bytes) is below
    d*2^(8i), and s + d*2^(8i) is at most k < N, so s is neither d*2^(8i)
    nor -d*2^(8i) mod N. _madd keeps the exact add for H = 0 all the
    same, so the function is total."""
    table = _table or _fixed_table()
    acc = None
    i = 0
    while k:
        d = k & DIGIT
        if d:
            acc = _madd(acc, table[i][d])
        k >>= WINDOW
        i += 1
    return _affine(acc)


def mul(k: int, pt=G):
    """Scalar multiplication k*pt: through the window table of G where pt
    is G, else double-and-add. Both give the one affine point k*pt."""
    global _fixed_muls
    k %= N
    if pt == G:
        with _count_lock:
            _fixed_muls += 1
        return _mul_fixed(k) if k else None
    if k == 0 or pt is None:
        return None
    acc = None
    addend = pt
    while k:
        if k & 1:
            acc = add(acc, addend)
        addend = dbl(addend)
        k >>= 1
    return acc


def sub(p1, p2):
    return add(p1, neg(p2))


def sqrt_mod(a: int) -> int | None:
    """Modular square root for p ≡ 3 (mod 4); None if a is a non-residue."""
    r = pow(a, (P + 1) // 4, P)
    if (r * r) % P != a % P:
        return None
    return r


def y_from_x(x: int, odd: bool) -> int | None:
    """Lift an X coordinate to the curve: y with the requested parity.

    Mirrors the reference's YfromX sqrt lift (lib/Curve64.pb:2656-2683).
    """
    y = sqrt_mod((x * x * x + A * x + B) % P)
    if y is None:
        return None
    if (y & 1) != int(odd):
        y = P - y
    return y
