"""The inversion by division steps (the arithmetic of the CUDA inversion
kernel, in plain PyTorch on the CPU) against Python's pow, against the
exponentiation that is the kernel's plain version, and against bsgs_tpu's
batch inversion (Pallas in interpret mode), bit for bit: tolerance 0, the
values are integers."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from bsgs_tpu.ops import epoch_kernel as JEK
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.ops import epoch_kernel as EK, field as F, planar as P

torch.set_num_threads(2)

P_INT = F.P_INT
# 0, 1, 2, p-1, p-2, 2^255, every high limb zero, every low limb zero
EDGE = (0, 1, 2, P_INT - 1, P_INT - 2, 1 << 255, 0x1234, 0xABCD << 240)


def _plane(vals):
    return torch.from_numpy(
        F.to_limbs_batch(vals).T.astype(np.int64).copy())


def _ints(plane):
    return [int(x) for x in F.from_limbs_batch(np.asarray(plane).T)]


def _seeded(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P_INT
            for _ in range(n)]


@pytest.mark.parametrize("x", EDGE, ids=lambda x: f"{x:#x}"[:12])
def test_edge_value(x):
    inv, batches = P.inv_mod_divsteps(_plane([x]))
    assert _ints(inv) == [pow(x, P_INT - 2, P_INT)]
    assert int(batches[0]) == 0 if x == 0 else (
        0 < int(batches[0]) <= P.DIVSTEP_BATCH_CAP)


def test_seeded_draws_against_pow():
    """300 seeded lanes with the edge values among them: the inverse of
    every lane, canonical 16-bit limbs, 0 -> 0, and the batch count under
    the cap that csrc/modinv.cuh states (20 batches = 600 steps)."""
    vals = list(EDGE) + _seeded(20261016, 300 - len(EDGE))
    inv, batches = P.inv_mod_divsteps(_plane(vals))
    assert inv.shape == (16, 300) and inv.dtype == torch.int64
    assert int(inv.min()) >= 0 and int(inv.max()) <= F.LIMB_MASK
    got = _ints(inv)
    assert got == [pow(x, P_INT - 2, P_INT) for x in vals]
    assert all(g < P_INT for g in got) and got[0] == 0
    assert batches.shape == (300,)
    assert 17 <= int(batches.max()) <= P.DIVSTEP_BATCH_CAP
    assert int(batches[0]) == 0


def test_short_inputs_need_the_batches_of_long_ones():
    """f starts at p, so an input of few bits still runs 17 or 18
    batches; the largest count seen stays under the cap."""
    rng = np.random.default_rng(5)
    vals = [int(rng.integers(1, 1 << 62)) >> int(rng.integers(0, 60))
            or 1 for _ in range(64)]
    vals += [(1 << k) - 1 for k in range(1, 257, 5) if (1 << k) - 1 < P_INT]
    vals += [P_INT - (1 << k) for k in range(0, 256, 5)]
    inv, batches = P.inv_mod_divsteps(_plane(vals))
    assert _ints(inv) == [pow(x, -1, P_INT) for x in vals]
    assert 17 <= int(batches.min())
    assert int(batches.max()) <= P.DIVSTEP_BATCH_CAP


def test_against_the_exponentiation():
    """EK.fermat_plain (a^(p-2) by the addition chain) stays the kernel's
    plain version; the limb-exact one gives the same bits."""
    vals = list(EDGE) + _seeded(7, 120)
    x = _plane(vals).to(torch.int32)
    inv, batches = EK.fermat_divsteps_plain(x)
    assert inv.dtype == torch.int32 and batches.dtype == torch.int64
    assert torch.equal(inv, EK.fermat_plain(x))
    # a CPU plane through the wrapper takes the plain version
    assert torch.equal(EK.fermat(x), inv)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.one_of(
    st.integers(0, P_INT - 1),
    st.integers(0, 255).map(lambda k: 1 << k),
    st.integers(1, 1 << 33).map(lambda d: P_INT - d),
    st.integers(0, (1 << 64) - 1)), min_size=1, max_size=6))
def test_hypothesis_draws(vals):
    inv, batches = P.inv_mod_divsteps(_plane(vals))
    assert _ints(inv) == [pow(x, P_INT - 2, P_INT) for x in vals]
    assert int(batches.max()) <= P.DIVSTEP_BATCH_CAP


def test_batched_shapes_broadcast():
    """(16, a, b) planes invert lane-wise like (16, a*b) ones."""
    vals = _seeded(11, 24)
    flat, _ = P.inv_mod_divsteps(_plane(vals))
    inv, batches = P.inv_mod_divsteps(_plane(vals).view(16, 4, 6))
    assert inv.shape == (16, 4, 6) and batches.shape == (4, 6)
    assert torch.equal(inv.view(16, 24), flat)


def test_limbs30_round_trip():
    vals = list(EDGE) + _seeded(3, 40)
    a = _plane(vals)
    limbs = P._to_limbs30(a)
    assert len(limbs) == P.DIVSTEP_LIMBS
    assert [sum(int(l[i]) << (30 * k) for k, l in enumerate(limbs))
            for i in range(len(vals))] == vals
    assert all(int(l.max()) < 1 << 30 and int(l.min()) >= 0 for l in limbs)
    assert torch.equal(P._from_limbs30(limbs), a)


def test_divsteps_matrix_is_exact():
    """One batch: 2^30 (f, g)_new == (u f + v g, q f + r g) on whole
    numbers, |u| + |v| <= 2^30 and |q| + |r| <= 2^30, and d, e keep
    d x == f, e x == g (mod p, up to 2^30) inside (-2p, p)."""
    vals = [v or 1 for v in _seeded(13, 32)]
    g = P._to_limbs30(_plane(vals))
    zero = torch.zeros_like(g[0])
    f = [zero + pl for pl in P._P_S30]
    d = [zero] * 9
    e = [zero + 1] + [zero] * 8
    zeta = zero - 1

    def whole(limbs, i):
        return sum(int(l[i]) << (30 * k) for k, l in enumerate(limbs))

    for _ in range(3):
        zeta, u, v, q, r = P._divsteps_30(zeta, f[0], g[0])
        assert int((u.abs() + v.abs()).max()) <= 1 << 30
        assert int((q.abs() + r.abs()).max()) <= 1 << 30
        nd, ne = P._update_de_30(d, e, u, v, q, r)
        nf, ng = P._update_fg_30(f, g, u, v, q, r)
        for i, x in enumerate(vals):
            fi, gi = whole(f, i), whole(g, i)
            assert whole(nf, i) << 30 == int(u[i]) * fi + int(v[i]) * gi
            assert whole(ng, i) << 30 == int(q[i]) * fi + int(r[i]) * gi
            for w, t in ((nd, nf), (ne, ng)):
                assert -2 * P_INT < whole(w, i) < P_INT
                assert (whole(w, i) * x - whole(t, i)) % P_INT == 0
        f, g, d, e = nf, ng, nd, ne


@pytest.fixture(scope="module")
def jax_batch():
    """2048 seeded nonzero lanes and bsgs_tpu's batch inversion of them
    (Pallas kernels in interpret mode)."""
    vals = [v or 1 for v in _seeded(2048, 2048)]
    v = F.to_limbs_batch(vals).T.copy()
    want = np.asarray(JEK.batch_inv_planar(jnp.asarray(v), chunk_c=4,
                                           lanes_w=128, interpret=True))
    return v, want, vals


@pytest.mark.parametrize("direct_max", [128, 512, 1 << 16])
def test_batch_inv_tree_matches_jax(jax_batch, direct_max):
    """The port's tree with the direct width forced small (two folds to
    128 lanes, one fold to 512) and large (no fold): the same bits as the
    JAX package's, whatever the shape of the tree."""
    v, want, _ = jax_batch
    x = torch.from_numpy(v.view(np.int32))
    got = EK.batch_inv_planar(x, chunk_c=4, lanes_w=128,
                              direct_max=direct_max)
    np.testing.assert_array_equal(convert.u32(got), want)


def test_divsteps_match_jax(jax_batch):
    v, want, vals = jax_batch
    inv, batches = EK.fermat_divsteps_plain(
        torch.from_numpy(v.view(np.int32)))
    np.testing.assert_array_equal(convert.u32(inv), want)
    assert _ints(convert.u32(inv))[:8] == [pow(x, -1, P_INT)
                                           for x in vals[:8]]
    assert int(batches.max()) <= P.DIVSTEP_BATCH_CAP


def test_tree_pads_and_folds_to_the_direct_width():
    """m = 1000 is padded to 1024 with ones and folds three times (C=4,
    W=8) to 16 lanes; the default tree inverts it unfolded."""
    vals = [v or 1 for v in _seeded(17, 1000)]
    x = _plane(vals).to(torch.int32)
    want = [pow(a, -1, P_INT) for a in vals]
    folded = EK.batch_inv_planar(x, chunk_c=4, lanes_w=8, direct_max=16)
    assert folded.shape == (16, 1000)
    assert _ints(convert.u32(folded)) == want
    assert torch.equal(EK.batch_inv_planar(x), folded)
