"""The port's row-major EC surface (ops/ec.py) against bsgs_tpu.ops.ec,
bit for bit, on the surface of tests/test_ec.py: doubling, the general
addition with its infinity flags, scalar multiplication (the reference's
Curve64 A*G vector among the scalars), the batch inversion, add_common's
degenerate lanes (P == C takes the given double, P == -C flags infinity),
the doubling fill across a lane at infinity, the tile advance; and the
table's prefix probe (table.probe, probe_x) and its row-major baby stream
(table._prefix_tiles) against the JAX package and compute_prefixes."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.models import table as JT
from bsgs_tpu.ops import ec as JE, field as JF
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import table as T
from bsgs_tpu_torch.ops import ec, field as F
from bsgs_tpu_torch.utils import ecpy

from test_curve64_vectors import A

torch.set_num_threads(2)


def pts(points):
    """(JAX x, y, port x, y) limbs of host points."""
    xs = F.to_limbs_batch([p[0] for p in points])
    ys = F.to_limbs_batch([p[1] for p in points])
    return (jnp.asarray(xs), jnp.asarray(ys),
            torch.from_numpy(xs.astype(np.int64)),
            torch.from_numpy(ys.astype(np.int64)))


def same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def ints(t):
    return [int(v) for v in F.from_limbs_batch(t.numpy())]


def test_point_dbl_matches_jax():
    jx, jy, x, y = pts([ecpy.G, ecpy.mul(2), ecpy.mul(987654321)])
    for g, w in zip(ec.point_dbl(x, y), JE.point_dbl(jx, jy)):
        same(g, w)
    assert list(zip(*map(ints, ec.point_dbl(x, y))))[0] == ecpy.dbl(ecpy.G)


def test_point_add_full_matches_jax():
    """Random pairs, P + P, P + (-P) and P + Q, with every pair of
    infinity flags; every lane's bits, garbage lanes included."""
    g, g2 = ecpy.G, ecpy.dbl(ecpy.G)
    rng = np.random.default_rng(5)
    p1 = [ecpy.mul(int(rng.integers(1, 1 << 62))) for _ in range(4)]
    p2 = [ecpy.mul(int(rng.integers(1, 1 << 62))) for _ in range(4)]
    p1 += [g, g, g2]
    p2 += [g, ecpy.neg(g), g]
    jx1, jy1, x1, y1 = pts(p1)
    jx2, jy2, x2, y2 = pts(p2)
    for inf1, inf2 in ((False, False), (True, False), (False, True),
                       (True, True)):
        f1 = np.full(len(p1), inf1)
        f2 = np.full(len(p1), inf2)
        want = JE.point_add_full(jx1, jy1, jnp.asarray(f1), jx2, jy2,
                                 jnp.asarray(f2))
        got = ec.point_add_full(x1, y1, torch.from_numpy(f1), x2, y2,
                                torch.from_numpy(f2))
        for gv, wv in zip(got, want):
            same(gv, wv)
    got = ec.point_add_full(x1, y1, torch.zeros(7, dtype=torch.bool), x2, y2,
                            torch.zeros(7, dtype=torch.bool))
    assert got[2].tolist() == [False] * 5 + [True, False]
    assert list(zip(*map(ints, got[:2])))[4] == ecpy.dbl(g)


def test_scalar_mul_matches_jax_and_the_oracle():
    """k * G for the scalars of tests/test_ec.py and the reference's A*G
    (tests/test_curve64_vectors.py); k = 0 gives zeros and the flag."""
    ks = [1, 2, 3, 7, 0x1234567890ABCDEF, ecpy.N - 1, A, 0]
    kl = F.to_limbs_batch(ks)
    gx = np.broadcast_to(F.to_limbs(ecpy.GX), (len(ks), 16))
    gy = np.broadcast_to(F.to_limbs(ecpy.GY), (len(ks), 16))
    want = JE.scalar_mul(jnp.asarray(kl), jnp.asarray(gx), jnp.asarray(gy))
    got = ec.scalar_mul(torch.from_numpy(kl.astype(np.int64)),
                        torch.from_numpy(gx.astype(np.int64)),
                        torch.from_numpy(gy.astype(np.int64)))
    for gv, wv in zip(got, want):
        same(gv, wv)
    assert got[2].tolist() == [False] * 7 + [True]
    for i, k in enumerate(ks[:-1]):
        assert (ints(got[0])[i], ints(got[1])[i]) == ecpy.mul(k)


def test_batch_inv_matches_jax():
    rng = np.random.default_rng(9)
    xs = [int.from_bytes(rng.bytes(32), "little") % F.P_INT or 1
          for _ in range(515)]
    a = F.to_limbs_batch(xs)
    same(ec.batch_inv(torch.from_numpy(a.astype(np.int64))),
         JE.batch_inv(jnp.asarray(a), chunk=64))


def test_add_common_degenerate_lanes_match_jax():
    """C = 5G against 1G, 2G, 5G (P == C: the double), 9G, -5G (P == -C:
    flagged infinity, its garbage bits as JAX's), with and without the
    double given."""
    c = ecpy.mul(5)
    d = ecpy.dbl(c)
    jx, jy, x, y = pts([ecpy.mul(k) for k in (1, 2, 5, 9)] + [ecpy.neg(c)])
    jc = pts([c, d])
    for args in ((jc[0][0], jc[1][0], jc[0][1], jc[1][1]),
                 (jc[0][0], jc[1][0])):
        want = JE.add_common(jx, jy, *args, chunk=2)
        port_args = [torch.from_numpy(np.asarray(v).astype(np.int64))
                     for v in args]
        got = ec.add_common(x, y, *port_args)
        for gv, wv in zip(got, want):
            same(gv, wv)
    assert got[2].tolist() == [False, False, True, False, True]
    got = ec.add_common(x, y, *[torch.from_numpy(
        np.asarray(v).astype(np.int64)) for v in (jc[0][0], jc[1][0],
                                                  jc[0][1], jc[1][1])])
    assert got[2].tolist() == [False, False, False, False, True]
    assert [(ints(got[0])[i], ints(got[1])[i]) for i in range(4)] == [
        ecpy.mul(k + 5) for k in (1, 2, 5, 9)]


@pytest.mark.parametrize("base_k, step_k, n, seed", [
    (1, 1, 13, 64), (7, 3, 8, 64), (ecpy.N - 27, 3, 13, 4)],
    ids=["G", "stride", "infinity"])
def test_fill_multiples_matches_jax(base_k, step_k, n, seed):
    """Power-of-two edges, a stride, and (base = -9 * step, seed 4) a lane
    that reaches infinity in a doubling pass: flagged, as is every lane
    the later passes derive from it."""
    base, step = ecpy.mul(base_k), ecpy.mul(step_k)
    want = JE.fill_multiples(base, step, n, with_inf=True, seed=seed)
    got = ec.fill_multiples(base, step, n, with_inf=True, seed=seed,
                            device="cpu")
    for gv, wv in zip(got, want):
        same(gv, wv)
    inf = got[2].tolist()
    for i in range(n):
        p = ecpy.add(base, ecpy.mul(i * step_k)) if i else base
        assert inf[i] == (p is None) or (base_k == ecpy.N - 27 and i > 9)
        if not inf[i]:
            assert (ints(got[0])[i], ints(got[1])[i]) == p
    if base_k == ecpy.N - 27:
        assert inf[9]


def test_extend_tile_matches_jax():
    n = 8
    jbx, jby = JE.fill_multiples(ecpy.G, ecpy.G, n)
    bx, by = ec.fill_multiples(ecpy.G, ecpy.G, n, device="cpu")
    c = ecpy.mul(n)
    jc = pts([c, ecpy.dbl(c)])
    want = JE.extend_tile(jbx, jby, jc[0][0], jc[1][0], jc[0][1], jc[1][1])
    got = ec.extend_tile(bx, by, jc[2][0], jc[3][0], jc[2][1], jc[3][1])
    for gv, wv in zip(got, want):
        same(gv, wv)
    assert [(ints(got[0])[i], ints(got[1])[i]) for i in range(n)] == [
        ecpy.mul(i + 1 + n) for i in range(n)]


# ---------------------------------------------------------------------------
# The table's prefix probe and row-major baby stream


def test_probe_and_probe_x_match_jax():
    jt = JT.build_baby_table(256, 6, window=16, tile=64)
    baby = convert.baby_table(
        w=jt.w, htsz=jt.htsz, window=jt.window, offsets=jt.offsets,
        disc_sorted=jt.disc_sorted, pos_sorted=jt.pos_sorted,
        dense=np.asarray(jt.dense), sorted_pre=jt.sorted_pre, device="cpu")
    ks = [1, 77, 256, 257, 1000, 99991, 5]
    jx, _, x, _ = pts([ecpy.mul(k) for k in ks])
    want = np.asarray(JT.probe_x(jx, jt))
    got = T.probe_x(x, baby)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [True, True, True, False, False, False, True]
    hi, lo = F.x_prefix64(x)
    np.testing.assert_array_equal(
        T.probe(hi, lo, baby.rows, htsz=6).numpy(),
        np.asarray(JT.probe(*JF.x_prefix64(jx), jt.dense, htsz=6)))


@pytest.mark.parametrize("w, tile, first, stride", [
    (300, 64, 1, 1), (100, 32, 5, 7)])
def test_prefix_tiles_match_compute_prefixes(w, tile, first, stride):
    got = np.concatenate([
        (hi.numpy().view(np.uint32).astype(np.uint64) << np.uint64(32))
        | lo.numpy().view(np.uint32)
        for hi, lo in T._prefix_tiles(w, tile, "cpu", first, stride)])
    if (first, stride) == (1, 1):
        np.testing.assert_array_equal(got, T.compute_prefixes(
            w, tile=2048, device="cpu"))
        np.testing.assert_array_equal(got, JT.compute_prefixes(w, tile))
    want = np.concatenate([
        (np.asarray(hi).astype(np.uint64) << np.uint64(32))
        | np.asarray(lo) for hi, lo in JT._prefix_tiles(w, tile, first,
                                                        stride)])
    np.testing.assert_array_equal(got, want)
