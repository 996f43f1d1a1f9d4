"""The port's fixed-base scalar multiplication (utils/ecpy.mul with the base
G, through the window table of G) bit for bit against double-and-add and
against the JAX package's bsgs_tpu.utils.ecpy.mul: edge scalars (0, the
window borders 2^(8i) +- 1, all-0xFF digits, N - 1, N, N + 1, negative),
200 random scalars each of 64, 70 and 256 bits, and hypothesis draws over
[1, N). Also: another base still takes double-and-add; the mixed
addition's H = 0 lanes (a doubling, the point at infinity) go to the exact
add; ``fixed_muls`` counts each multiplication of G and nothing else; and
threads that meet an unbuilt table build it once and count every call."""

import random
import sys
import threading

import pytest
import torch
from hypothesis import given, settings, strategies as st

from bsgs_tpu.utils import ecpy as JE
from bsgs_tpu_torch.utils import ecpy

torch.set_num_threads(2)

N = ecpy.N


def double_and_add(k, pt):
    k %= N
    acc = None
    while k:
        if k & 1:
            acc = ecpy.add(acc, pt)
        pt = ecpy.dbl(pt)
        k >>= 1
    return acc


EDGES = sorted({0, 1, 2, 3, 255, 256, 257, (1 << 256) - 1, N - 1, N, N + 1,
                2 * N + 7, -1, -2, -(1 << 70) - 3, -N}
               | {(1 << 8 * i) + e for i in range(1, 32) for e in (-1, 1)})

def _draws(bits, n=200):
    rng = random.Random(bits)
    return [rng.getrandbits(bits) | 1 << bits - 1 for _ in range(n)]


RANDOM = {bits: _draws(bits) for bits in (64, 70, 256)}
SCALARS = [pytest.param([k], id=f"k={k:#x}") for k in EDGES] + [
    pytest.param(ks, id=f"random{bits}") for bits, ks in RANDOM.items()]


def _check(ks):
    for k in ks:
        got = ecpy.mul(k)
        assert got == double_and_add(k, ecpy.G) == JE.mul(k), hex(k)
        assert (got is None) == (k % N == 0) and ecpy.is_on_curve(got)


@pytest.mark.parametrize("ks", SCALARS)
def test_fixed_base_matches_double_and_add_and_jax(ks):
    _check(ks)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, N - 1))
def test_fixed_base_hypothesis(k):
    _check([k])


def test_other_base_takes_double_and_add():
    base = ecpy.mul(0xC0FFEE)
    before = ecpy.fixed_muls()
    for k in (0, 1, 2, 255, 256, (1 << 70) + 12345, N - 1, N + 1, -3):
        got = ecpy.mul(k, base)
        assert got == double_and_add(k, base) == JE.mul(k, base)
    assert ecpy.mul(5, None) is None
    assert ecpy.fixed_muls() == before  # the table never engaged


@pytest.mark.parametrize("z", [1, 7, ecpy.P - 2])
def test_mixed_addition_takes_exact_add_where_h_is_zero(z):
    pt = ecpy.mul(0xABCDEF)
    acc = (pt[0] * z * z % ecpy.P, pt[1] * z ** 3 % ecpy.P, z)  # pt itself
    assert ecpy._affine(acc) == pt
    assert ecpy._affine(ecpy._madd(acc, pt)) == ecpy.dbl(pt)
    assert ecpy._madd(acc, ecpy.neg(pt)) is None
    other = ecpy.mul(0x1234)
    assert ecpy._affine(ecpy._madd(acc, other)) == ecpy.add(pt, other)


def test_fixed_muls_counts_every_multiplication_of_g():
    base = ecpy.mul(3)
    before = ecpy.fixed_muls()
    for k in (0, 1, N, 12345):
        ecpy.mul(k)
    ecpy.mul(3, ecpy.G)
    ecpy.mul(3, base)
    assert ecpy.fixed_muls() - before == 5


def test_threads_build_the_table_once(monkeypatch):
    rows = []
    build = ecpy._table_row

    def counted(base):
        rows.append(base)
        return build(base)

    monkeypatch.setattr(ecpy, "_table", None)
    monkeypatch.setattr(ecpy, "_table_row", counted)
    ks = [random.Random(t).getrandbits(70) for t in range(16)]
    want = [JE.mul(k) for k in ks]
    before = ecpy.fixed_muls()
    got = [None] * len(ks)

    def work(t):
        for _ in range(20):
            got[t] = ecpy.mul(ks[t])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(len(ks))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert got == want
    assert len(rows) == ecpy.ROWS
    assert ecpy.fixed_muls() - before == 20 * len(ks)


def test_shared_inverses():
    ds = [1, 2, 3, ecpy.P - 1, -5, ecpy.GX, 2 * ecpy.P + 9]
    assert ecpy.shared_inverses(ds) == [pow(d, -1, ecpy.P) for d in ds]
    assert ecpy.shared_inverses([]) == []
    assert ecpy.shared_inverses([3, 0, 4]) is None
    assert ecpy.shared_inverses([3, -ecpy.P]) is None
