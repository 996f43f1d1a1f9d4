"""The port's row-major field surface (ops/field.py) and the planar
leftovers (ops/planar.py) against bsgs_tpu.ops.field / ops.planar, bit for
bit on seeded random and edge lanes (0, 1, p - 1, the worst-case fold,
2^256 - 1 for the raw ops), and the reference's Curve64 self-test vectors
of tests/test_curve64_vectors.py through the port's ops."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.ops import field as JF, planar as JP
from bsgs_tpu_torch.ops import field as F, planar as PL

from test_curve64_vectors import A, B, GX, GY, SQUARES

torch.set_num_threads(2)

P = F.P_INT
EDGE = [0, 1, 2, P - 1, P - 2, 1 << 255, 0xFFFFFFFFFFFFFFFF, F.FOLD_INT,
        P - F.FOLD_INT]


def rand_fe(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def pair(xs):
    """(JAX uint32 limbs, port int64 limbs) of the same values."""
    a = F.to_limbs_batch(xs)
    return jnp.asarray(a), torch.from_numpy(a.astype(np.int64))


def same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def lanes():
    """Random lanes, then every edge value against every edge value."""
    xs = rand_fe(1, 24) + [x for x in EDGE for _ in EDGE]
    ys = rand_fe(2, 24) + EDGE * len(EDGE)
    return pair(xs), pair(ys)


@pytest.mark.parametrize("op", ["add_mod", "sub_mod", "mul_mod", "eq",
                                "geq"])
def test_binary_ops_match_jax(op, lanes):
    (ja, ta), (jb, tb) = lanes
    same(getattr(F, op)(ta, tb), getattr(JF, op)(ja, jb))


@pytest.mark.parametrize("op", ["neg_mod", "sqr_mod", "is_zero", "is_even",
                                "inv_mod"])
def test_unary_ops_match_jax(op, lanes):
    (ja, ta), _ = lanes
    same(getattr(F, op)(ta), getattr(JF, op)(ja))
    if op == "inv_mod":  # one exponentiation a^(p-2), two names
        same(F.inv_mod_chain(ta), JF.inv_mod(ja))


def test_inverse_of_zero_is_zero():
    _, t = pair([0, 1, P - 1])
    assert F.from_limbs_batch(F.inv_mod(t).numpy()).tolist() == [0, 1, P - 1]


@pytest.mark.parametrize("op", ["add_raw", "sub_raw"])
def test_raw_ops_return_carry_and_borrow_as_jax(op):
    """Not folded mod p: values up to 2^256 - 1, the carry (add) and the
    borrow (sub) as JAX gives them."""
    top = (1 << 256) - 1
    xs = rand_fe(3, 8) + [top, top, 0, 5, 0]
    ys = rand_fe(4, 8) + [top, 1, 0, 5, 1]
    (ja, ta), (jb, tb) = pair(xs), pair(ys)
    for g, w in zip(getattr(F, op)(ta, tb), getattr(JF, op)(ja, jb)):
        same(g, w)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 977, 65535])
def test_mul_small_mod_matches_jax(k, lanes):
    (ja, ta), _ = lanes
    same(F.mul_small_mod(ta, k), JF.mul_small_mod(ja, k))


def test_pow_and_sqrt_match_jax():
    xs = rand_fe(5, 4) + [0, 1, P - 1]
    ja, ta = pair(xs)
    for e in (1, 2, 3, 65537):
        same(F.pow_mod_bits(ta, e), JF.pow_mod_bits(ja, e))
    sq = pair([x * x % P for x in xs])
    same(F.sqrt_mod(sq[1]), JF.sqrt_mod(sq[0]))


def test_bit_ops_and_prefix_match_jax():
    xs = rand_fe(6, 6) + [0, 1, (1 << 256) - 1]
    ja, ta = pair(xs)
    for n in (0, 1, 15, 16, 17, 64, 200, 255):
        same(F.shr_bits(ta, n), JF.shr_bits(ja, n))
        same(F.shl_bits(ta, n), JF.shl_bits(ja, n))
    for i in (0, 1, 16, 255):
        same(F.test_bit(ta, i), JF.test_bit(ja, i))
    hi, lo = F.x_prefix64(ta)
    assert hi.dtype == lo.dtype == torch.int32
    for g, w in zip((hi, lo), JF.x_prefix64(ja)):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


def test_batch_shapes_and_broadcast_const():
    """(2, 4, 16) batches, a broadcast constant and (..., 16) int32 input
    give the same limbs as JAX."""
    ja, ta = pair(rand_fe(7, 8))
    jb, tb = pair(rand_fe(8, 8))
    same(F.mul_mod(ta.reshape(2, 4, 16).int(), tb.reshape(2, 4, 16)),
         JF.mul_mod(ja.reshape(2, 4, 16), jb.reshape(2, 4, 16)))
    c = F.broadcast_const(12345, (2, 4))
    assert c.shape == (2, 4, 16)
    same(c, JF.broadcast_const(12345, (2, 4)))
    same(F.add_mod(ta, F.broadcast_const(7)),
         JF.add_mod(ja, JF.broadcast_const(7)))
    same(F.select(torch.tensor([True] * 4 + [False] * 4), ta, tb),
         JF._select(jnp.asarray([True] * 4 + [False] * 4), ja, jb))


def test_planar_leftovers_match_jax():
    xs, ys = rand_fe(9, 6) + [(1 << 256) - 1, 0], rand_fe(10, 6) + [1, 1]
    (ja, ta), (jb, tb) = pair(xs), pair(ys)
    jpa, jpb = JP.from_rows(ja), JP.from_rows(jb)
    pa, pb = PL.from_rows(ta), PL.from_rows(tb)
    assert pa.shape == (16, 8) and torch.equal(PL.to_rows(pa), ta)
    for g, w in zip(PL.add_raw(pa, pb), JP.add_raw(jpa, jpb)):
        same(g, w)
    for g, w in zip(PL.sub_raw(pa, pb), JP.sub_raw(jpa, jpb)):
        same(g, w)
    same(PL.eq(pa, pa.clone()), JP.eq(jpa, jpa))
    same(PL.eq(pa, pb), JP.eq(jpa, jpb))
    same(PL.p_col(), JP.p_col())
    same(PL.one_col(), JP.one_col())


# ---------------------------------------------------------------------------
# The reference's Curve64 self-test vectors (tests/test_curve64_vectors.py)


def row(x):
    return torch.from_numpy(F.to_limbs(x).astype(np.int64))[None]


def as_int(t):
    return F.from_limbs(t[0].numpy())


def test_curve64_vectors_through_the_port():
    assert as_int(F.neg_mod(row(GY))) == (
        0xB7C52588D95C3B9AA25B0403F1EEF75702E84BB7597AABE663B82F6F04EF2777)
    for a, exp in SQUARES:
        assert as_int(F.sqr_mod(row(a))) == exp
        assert F.from_limbs(PL.sqr_mod(row(a).T)[:, 0].numpy()) == exp
    bits = "".join(str(int(F.test_bit(row(A), i)[0]))
                   for i in range(255, -1, -1))
    assert bits == bin(A)[2:].zfill(256)
    s, c = F.add_raw(row(A), row(B))
    assert as_int(s) + (int(c[0]) << 256) == (
        0x11FA6FB7755A3729CAEF029B4C4D959906A60363EA1A608055869AECBD41FA877)
    d, br = F.sub_raw(row(A), row(B))
    assert as_int(d) == (
        0x60115893AF709AE66D1ACB6665BA21F793ABA694A4FE60546E9BA7318953757B)
    assert int(br[0]) == 1
    assert as_int(F.add_mod(row(A), row(B))) == (
        0x1FA6FB7755A3729CAEF029B4C4D959906A60363EA1A608055869AECCD41FAC48)
    assert as_int(F.sub_mod(row(A), row(B))) == (
        0x60115893AF709AE66D1ACB6665BA21F793ABA694A4FE60546E9BA730895371AA)
    assert as_int(F.inv_mod(row(GX))) == (
        0x237AFDF1D2938D86870AAEB8AD77626A67B8E794ABFB076BE61D003687CA9EF6)
    # Gy^2 == Gx^3 + 7
    assert as_int(F.sqr_mod(row(GY))) == as_int(F.add_mod(
        F.mul_mod(F.sqr_mod(row(GX)), row(GX)), row(7)))
