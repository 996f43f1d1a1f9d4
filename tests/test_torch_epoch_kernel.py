"""The port's epoch kernels (plain versions, on the CPU) against bsgs_tpu's
Pallas kernels in interpret mode, bit for bit: the batch inversion on both
sides of the direct width, the add-const pass and the doubling fill, the
epoch key plane (exact lanes included) and the fused epoch's hit array
(its centers and offsets packed, as the solver keeps them)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.models import giant as JG, table as JT
from bsgs_tpu.ops import epoch_kernel as JEK
from bsgs_tpu.utils import ecpy
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import giant as G
from bsgs_tpu_torch.ops import epoch_kernel as EK, field as F, planar as PL

from test_epoch_kernel import _setup
from test_torch_probe_kernel import csr_rows

torch.set_num_threads(2)


def _i32(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _random_nonzero(rng, m):
    vals = [int.from_bytes(rng.bytes(32), "little") % (F.P_INT - 1) + 1
            for _ in range(m)]
    return F.to_limbs_batch(vals).T.copy()


@pytest.mark.parametrize("m", [4096, 16384])
def test_batch_inv_matches_jax(m):
    """With the direct width forced to 8192, m=4096 goes to the inversion
    unfolded; m=16384 folds through the Montgomery passes first (C=4,
    W=128) down to 4096 chain totals, which are inverted at that width.
    (On the CPU the inversion is its plain version, a^(p-2).)"""
    v = _random_nonzero(np.random.default_rng(m), m)
    want = np.asarray(JEK.batch_inv_planar(jnp.asarray(v), chunk_c=4,
                                           lanes_w=128, interpret=True))
    got = EK.batch_inv_planar(_i32(v), chunk_c=4, lanes_w=128,
                              direct_max=8192)
    np.testing.assert_array_equal(convert.u32(got), want)
    # an independent check of a few lanes
    for lane in (0, 1, m - 1):
        x = F.from_limbs(v[:, lane])
        assert F.from_limbs(convert.u32(got)[:, lane]) == pow(x, -1, F.P_INT)


def test_mont_passes_are_exact_prefixes():
    """mont_fwd / mont_bwd in isolation: prefixes, totals, inverses."""
    rng = np.random.default_rng(7)
    v = _random_nonzero(rng, 64)
    pre, tot = EK.mont_fwd(_i32(v), chunk_c=4, lanes_w=8)
    vals = [F.from_limbs(v[:, i]) for i in range(64)]
    pv = [F.from_limbs(c) for c in convert.u32(pre).T]
    tv = [F.from_limbs(c) for c in convert.u32(tot).T]
    for b in range(2):
        for lane in range(8):
            run = 1
            for c in range(4):
                col = b * 32 + c * 8 + lane
                assert pv[col] == run
                run = run * vals[col] % F.P_INT
            assert tv[b * 8 + lane] == run
    itot = EK.fermat(tot)
    inv = EK.mont_bwd(_i32(v), pre, itot, chunk_c=4, lanes_w=8)
    got = [F.from_limbs(c) for c in convert.u32(inv).T]
    assert got == [pow(x, -1, F.P_INT) for x in vals]


@pytest.fixture(scope="module")
def fill_2048():
    """bsgs_tpu's and the port's planar fill of [base + i*step] at n=2048
    (host seed of 1024, one add-const pass)."""
    base, step = ecpy.mul(123456789), ecpy.mul(1 << 40)
    jx, jy = JEK.fill_multiples_planar(base, step, 2048, interpret=True)
    px, py = EK.fill_multiples_planar(base, step, 2048, device="cpu")
    return np.asarray(jx), np.asarray(jy), px, py, base, step


def test_fill_multiples_matches_jax(fill_2048):
    jx, jy, px, py, base, step = fill_2048
    np.testing.assert_array_equal(convert.u32(px), jx)
    np.testing.assert_array_equal(convert.u32(py), jy)
    pt = ecpy.add(base, ecpy.mul(2047, step))
    assert F.from_limbs(convert.u32(px)[:, 2047]) == pt[0]


def test_fill_multiples_small_n_is_host_row():
    base, step = ecpy.mul(99), ecpy.mul(7)
    px, py = EK.fill_multiples_planar(base, step, 16, device="cpu")
    for i in range(16):
        pt = ecpy.add(base, ecpy.mul(i, step)) if i else base
        assert F.from_limbs(convert.u32(px)[:, i]) == pt[0]
        assert F.from_limbs(convert.u32(py)[:, i]) == pt[1]


def test_add_const_matches_jax(fill_2048):
    """One add-const pass over the 2048 filled points with C = the point in
    lane 5, so lane 5 is a doubling lane."""
    jx, jy, px, py, base, step = fill_2048
    cx = jx[:, 5:6].copy()
    cy = jy[:, 5:6].copy()
    want = JEK.add_const_planar(jnp.asarray(jx), jnp.asarray(jy),
                                jnp.asarray(cx), jnp.asarray(cy),
                                interpret=True)
    got = EK.add_const_planar(px, py, _i32(cx), _i32(cy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.u32(g), np.asarray(w))
    c = (F.from_limbs(cx[:, 0]), F.from_limbs(cy[:, 0]))
    assert F.from_limbs(convert.u32(got[0])[:, 5]) == ecpy.dbl(c)[0]


# pairs of the first center land exactly on an offset (M_0 = -5*S*G)
_EXACT_KEY_OFFSET = (256 - 5) * 128 - 123457


@pytest.fixture(scope="module")
def epoch_setup():
    """_setup's epoch (w=64, htsz=6, n=256, T=4) with an exact lane, and a
    table packed from the landing X prefixes of 32 (t, j, branch) pairs so
    that the epoch has many hits."""
    baby, ox, oy, cx, cy, cinf = _setup(t_jobs=4,
                                        key_offset=_EXACT_KEY_OFFSET)
    ox_pl, oy_pl = convert.offset_planes(np.asarray(ox).T, np.asarray(oy).T,
                                         device="cpu")
    mx = F.from_limbs_batch(np.asarray(cx))
    my = F.from_limbs_batch(np.asarray(cy))
    s_g = ecpy.mul(2 * 64)
    pres = []
    for t in range(4):
        m_pt = (int(mx[t]), int(my[t]))
        for j in (1, 17, 100, 256):
            o_pt = ecpy.mul(j, s_g)
            for pt in (ecpy.add(m_pt, o_pt), ecpy.sub(m_pt, o_pt)):
                pres.append(pt[0] & ((1 << 64) - 1))
    table = JT.pack_table(np.array(sorted(pres), dtype=np.uint64),
                          baby.htsz, 16)
    rows = csr_rows(np.asarray(table.offsets), np.asarray(table.dense))
    return baby, ox, oy, cx, cy, cinf, ox_pl, oy_pl, table.dense, rows


def test_landing_keys_match_jax(epoch_setup):
    baby, ox, oy, cx, cy, cinf, ox_pl, oy_pl, _, _ = epoch_setup
    want = np.asarray(JEK.epoch_landing_keys(
        jnp.swapaxes(cx, 0, 1), jnp.swapaxes(cy, 0, 1),
        jnp.swapaxes(ox, 0, 1), jnp.swapaxes(oy, 0, 1),
        htsz=baby.htsz, chunk_c=2, lanes_w=128, interpret=True))
    got = EK.epoch_landing_keys(
        _i32(np.asarray(cx).T), _i32(np.asarray(cy).T), ox_pl, oy_pl,
        htsz=baby.htsz, chunk_c=2, lanes_w=128)
    assert got.shape == (8, 4 * 256)
    np.testing.assert_array_equal(convert.u32(got), want)
    assert convert.u32(got)[4, 4].item() == 1  # t=0, j=5: an exact lane
    assert want[4].sum() >= 1


@pytest.mark.parametrize("phases", [1, 2])
def test_run_epoch_fused_matches_jax(epoch_setup, phases):
    baby, ox, oy, cx, cy, cinf, ox_pl, oy_pl, dense_j, rows = epoch_setup
    kw = dict(htsz=baby.htsz, chunk_c=2, lanes_w=128, phases=phases)
    j_idx, j_cnt, j_gs = JG.run_epoch_fused(
        cx, cy, cinf, jnp.swapaxes(ox, 0, 1), jnp.swapaxes(oy, 0, 1),
        dense_j, hit_cap=64, interpret=True, **kw)
    j_idx, j_cnt = np.asarray(j_idx), int(j_cnt)
    assert j_cnt > 32  # the 32 planted pairs and the exact lane
    centers = (PL.pack_planes(_i32(np.asarray(cx)).T),
               PL.pack_planes(_i32(np.asarray(cy)).T),
               torch.from_numpy(np.array(cinf)))
    offsets = (PL.pack_planes(ox_pl), PL.pack_planes(oy_pl))
    idx, cnt = G.fused_epoch_probes(*centers, *offsets, G.dense_probe(rows),
                                    hit_cap=64, **kw)
    assert j_gs == (2 * ox.shape[0] + 1) * cx.shape[0]  # jobs_span * T
    assert int(cnt) == j_cnt
    np.testing.assert_array_equal(convert.u32(idx), j_idx)
    # an overflowing buffer keeps the first hit_cap hits in ascending
    # order and the full count, as jnp.nonzero(size=hit_cap) does
    cap = j_cnt - 1
    idx_o, cnt_o = G.fused_epoch_probes(*centers, *offsets,
                                        G.dense_probe(rows), hit_cap=cap,
                                        **kw)
    assert int(cnt_o) == j_cnt
    np.testing.assert_array_equal(convert.u32(idx_o), j_idx[:cap])


def test_masks_to_hits_matches_jax():
    rng = np.random.default_rng(3)
    parts = [rng.random(n) < 0.01 for n in (700, 700, 50)]
    for cap in (4, 64):
        w_idx, w_cnt = JG._masks_to_hits([jnp.asarray(p) for p in parts],
                                         cap)
        idx, cnt = G._masks_to_hits([torch.from_numpy(p) for p in parts],
                                    cap)
        np.testing.assert_array_equal(convert.u32(idx), np.asarray(w_idx))
        assert int(cnt[0]) == int(w_cnt[0])


def test_decode_matches_jax():
    for phases in (1, 2, 4):
        for flat in range(0, 3 * 4 * 8 + 4):
            assert (G.decode_flat_phased(flat, 4, 8, phases)
                    == JG.decode_flat_phased(flat, 4, 8, phases))


def test_wrappers_refuse_other_devices_and_types():
    v = torch.zeros((16, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        EK.fermat(v)
    with pytest.raises(ValueError):
        EK.fermat(torch.zeros((16, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        EK.mont_fwd(torch.ones((16, 12), dtype=torch.int32), chunk_c=4,
                    lanes_w=8)
