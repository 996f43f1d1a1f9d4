"""Pure-Python secp256k1 oracle (host-side exact arithmetic).

This is the trusted reference path of the framework: every device-side
candidate hit is independently re-derived here before being reported, the
same "never trust the accelerator" strategy the reference uses with its
CPU checker thread (reference: 1_9_7File.pb:3933-4296), and every device
kernel is unit-tested against this module.

Python integers are arbitrary-precision and exact, so this file is the
simplest possible correct implementation — clarity over speed. The hot
path never runs here.
"""

from __future__ import annotations

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


def mul(k: int, pt=G):
    """Scalar multiplication k*pt (double-and-add)."""
    k %= N
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
