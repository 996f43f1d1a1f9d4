"""The packed layout of the port (ops/planar.pack_planes, unpack_planes,
packed_col: (8, M) int32 words, word i = limb 2i | limb 2i+1 << 16) and
the packed entries that the epoch and the table build run, on the CPU,
where every kernel wrapper runs its plain version: round trips of the
packing on random, zero, p - 1 and all-0xFFFF-limb elements; the packed
epoch (epoch_landing_keys_packed, its centers as column slices of a wider
plane, as the solver hands them over) against the JAX package's
epoch_landing_keys in interpret mode; the packed tile advance, add-const
pass and fill (tile_advance_packed, add_const_packed,
fill_multiples_packed) against add_const_planar and fill_multiples_planar,
doubling lanes planted; the build's prefix stream over several tiles
against _prefix_tiles_planar. The CUDA kernels are held against the same
plain versions on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.models import table as JT
from bsgs_tpu.ops import epoch_kernel as JEK
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import giant as G, table as T
from bsgs_tpu_torch.ops import epoch_kernel as EK, field as F, planar as PL
from bsgs_tpu_torch.utils import ecpy

from test_epoch_kernel import _setup

torch.set_num_threads(2)

P = F.P_INT
_RNG = np.random.default_rng(13)
ELEMENTS = {
    "random": [int.from_bytes(_RNG.bytes(32), "little") % P
               for _ in range(40)],
    "zero": [0] * 8,
    "p-1": [P - 1] * 8,
    "ffff": [(1 << 256) - 1] * 8,  # every limb 0xFFFF: not canonical
}


def _limbs(vals):
    """Host ints -> (16, m) int32 limb plane."""
    return torch.from_numpy(F.to_limbs_batch(vals).T.astype(np.int32))


def _packed(a):
    """A JAX (16, m) uint32 limb plane -> the port's packed (8, m) plane."""
    return PL.pack_planes(convert.from_u32(np.asarray(a), "cpu"))


@pytest.mark.parametrize("kind", sorted(ELEMENTS))
def test_pack_round_trip(kind):
    vals = ELEMENTS[kind]
    limbs = _limbs(vals)
    words = PL.pack_planes(limbs)
    assert words.dtype == torch.int32 and words.shape == (8, len(vals))
    for col, v in enumerate(vals):  # word i holds bits 32i .. 32i + 31
        got = convert.u32(words[:, col])
        assert [int(w) for w in got] == [(v >> (32 * i)) & 0xFFFFFFFF
                                         for i in range(8)]
    assert torch.equal(PL.unpack_planes(words), limbs)
    # int64 limbs and a batch of more dimensions pack alike
    assert torch.equal(PL.pack_planes(limbs.long()), words)
    cube = limbs.reshape(16, 2, -1)
    assert torch.equal(PL.unpack_planes(PL.pack_planes(cube)), cube)
    assert torch.equal(PL.packed_col(vals[0]), words[:, :1])


def test_pack_refuses_other_row_counts():
    with pytest.raises(ValueError):
        PL.pack_planes(torch.zeros((8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        PL.unpack_planes(torch.zeros((16, 4), dtype=torch.int32))
    # the packed kernel wrappers take packed planes only
    planes = torch.zeros((16, 4096), dtype=torch.int32)
    with pytest.raises(ValueError):
        EK.epoch_fwd_packed(planes, planes[:, :4], chunk_c=16, lanes_w=256)


# ---------------------------------------------------------------------------
# The epoch


@pytest.fixture(scope="module")
def epoch():
    """_setup's epoch (w=64, htsz=6, n=256, T=4) and bsgs_tpu's key plane
    of it (Pallas in interpret mode, chains of 2 x 128)."""
    baby, ox, oy, cx, cy, _ = _setup(t_jobs=4)
    want = np.asarray(JEK.epoch_landing_keys(
        jnp.swapaxes(cx, 0, 1), jnp.swapaxes(cy, 0, 1),
        jnp.swapaxes(ox, 0, 1), jnp.swapaxes(oy, 0, 1),
        htsz=baby.htsz, chunk_c=2, lanes_w=128, interpret=True))
    planes = [convert.from_u32(np.asarray(a).T, "cpu")
              for a in (ox, oy, cx, cy)]
    return baby.htsz, planes, want


def test_landing_keys_packed_match_jax(epoch):
    htsz, (ox, oy, cx, cy), want = epoch
    kw = dict(htsz=htsz, chunk_c=2, lanes_w=128)
    pk = PL.pack_planes
    got = EK.epoch_landing_keys_packed(pk(cx), pk(cy), pk(ox), pk(oy), **kw)
    np.testing.assert_array_equal(convert.u32(got), want)
    # the reference entry on limb planes packs around the same passes
    assert torch.equal(EK.epoch_landing_keys(cx, cy, ox, oy, **kw), got)


@pytest.mark.parametrize("phases", [2, 4])
def test_landing_keys_of_center_slices_match_jax(epoch, phases):
    """The centers as the solver hands them over, rows of one (17, T)
    plane (x words, y words, the infinity flags), each phase a column
    slice of it: the phase's keys are its block of the epoch's key plane,
    and its center keys are words 1 and 0 of x."""
    htsz, (ox, oy, cx, cy), want = epoch
    t_jobs, n = cx.shape[1], ox.shape[1]
    whole = torch.cat([PL.pack_planes(cx), PL.pack_planes(cy),
                       torch.zeros((1, t_jobs), dtype=torch.int32)])
    cxw, cyw = whole[:8], whole[8:16]
    assert cxw.stride() == (t_jobs, 1)
    per = t_jobs // phases
    for p in range(phases):
        sl = slice(p * per, (p + 1) * per)
        got = EK.epoch_landing_keys_packed(
            cxw[:, sl], cyw[:, sl], PL.pack_planes(ox), PL.pack_planes(oy),
            htsz=htsz, chunk_c=2, lanes_w=128)
        np.testing.assert_array_equal(
            convert.u32(got), want[:, p * per * n:(p + 1) * per * n])
    hi, lo = F.x_prefix64(cx.T.contiguous())
    bucket, disc = G.center_keys(cxw, htsz)
    want_b, want_d = T.prefix_keys(hi, lo, htsz)
    assert torch.equal(bucket, want_b) and torch.equal(disc, want_d)


def test_packed_epoch_passes_match_the_limb_plane_ones(epoch):
    """epoch_fwd_packed and epoch_bwd_packed, unpacked, equal the plain
    versions on limb planes: the same pre, totals and key plane."""
    htsz, (ox, oy, cx, cy), want = epoch
    kw = dict(chunk_c=2, lanes_w=128)
    pk = PL.pack_planes
    pre, tot = EK.epoch_fwd_packed(pk(ox), pk(cx), **kw)
    wpre, wtot = EK.epoch_fwd_plain(ox, cx, **kw)
    assert pre.shape == (8, 4 * 256)
    assert torch.equal(PL.unpack_planes(pre), wpre) and torch.equal(tot, wtot)
    itot = EK.batch_inv_planar(tot, **kw)
    keys = EK.epoch_bwd_packed(pk(ox), pk(oy), pk(cx), pk(cy), pre, itot,
                               htsz=htsz, **kw)
    assert torch.equal(keys, EK.epoch_bwd_plain(ox, oy, cx, cy, wpre, itot,
                                                htsz=htsz, **kw))
    np.testing.assert_array_equal(convert.u32(keys), want)


# ---------------------------------------------------------------------------
# The table build's tile

BASE, STEP = ecpy.mul(123456789), ecpy.mul(1 << 40)
DOUBLINGS = (5, 700)  # lanes whose point is C


@pytest.fixture(scope="module")
def tile():
    """bsgs_tpu's fill of [BASE + i*STEP] at n=2048, and its
    add_const_planar of that tile with lane 700 set to lane 5's point and C
    = that point, so that lanes 5 and 700 double (Pallas in interpret
    mode)."""
    jx, jy = JEK.fill_multiples_planar(BASE, STEP, 2048, interpret=True)
    ax = jx.at[:, DOUBLINGS[1]].set(jx[:, DOUBLINGS[0]])
    ay = jy.at[:, DOUBLINGS[1]].set(jy[:, DOUBLINGS[0]])
    cx, cy = ax[:, 5:6], ay[:, 5:6]
    want = JEK.add_const_planar(ax, ay, cx, cy, interpret=True)
    return ([np.asarray(a) for a in (jx, jy, ax, ay, cx, cy)],
            [np.asarray(w) for w in want])


def test_fill_multiples_packed_matches_jax(tile):
    (jx, jy, *_), _ = tile
    xs, ys = EK.fill_multiples_packed(BASE, STEP, 2048, device="cpu")
    assert xs.shape == (8, 2048) and xs.dtype == torch.int32
    assert torch.equal(xs, _packed(jx)) and torch.equal(ys, _packed(jy))
    px, py = EK.fill_multiples_planar(BASE, STEP, 2048, device="cpu")
    np.testing.assert_array_equal(convert.u32(px), jx)
    np.testing.assert_array_equal(convert.u32(py), jy)


@pytest.mark.parametrize("chunk_c", [EK.TILE_CHUNK_C, 12])
def test_tile_advance_packed_matches_jax(tile, chunk_c):
    """The packed tile advance (12 leaves the last block of chains ragged)
    against add_const_planar: x3 and y3 packed, the prefix rows, the
    doubling lanes."""
    (_, _, ax, ay, cx, cy), (x3, y3, hi, lo) = tile
    got = EK.tile_advance_packed(_packed(ax), _packed(ay), _packed(cx),
                                 _packed(cy), chunk_c=chunk_c)
    assert torch.equal(got[0], _packed(x3))
    assert torch.equal(got[1], _packed(y3))
    np.testing.assert_array_equal(convert.u32(got[2]), hi)
    np.testing.assert_array_equal(convert.u32(got[3]), lo)
    c = (F.from_limbs(cx[:, 0]), F.from_limbs(cy[:, 0]))
    for lane in DOUBLINGS:
        assert F.from_limbs(x3[:, lane]) == ecpy.dbl(c)[0]


def test_add_const_packed_matches_jax(tile):
    """The add-const pass on its own, given the inverses of the tile's
    denominators: the packed wrapper against add_const_planar's x3, y3 and
    prefix rows."""
    (_, _, ax, ay, cx, cy), (x3, y3, hi, lo) = tile
    planes = [convert.from_u32(a, "cpu") for a in (ax, ay, cx)]
    inv = EK.fermat(EK.tile_den_plain(*planes).to(torch.int32))
    gx, gy, prefix = EK.add_const_packed(
        _packed(ax), _packed(ay), PL.pack_planes(inv), _packed(cx),
        _packed(cy))
    assert torch.equal(gx, _packed(x3)) and torch.equal(gy, _packed(y3))
    np.testing.assert_array_equal(convert.u32(prefix), np.stack([hi, lo]))


def test_prefix_tiles_match_jax_over_tiles(tile):
    """The build's prefix stream of (first + i*stride)G at w=6000 in tiles
    of 2048 (the fill, two advances, a ragged last tile), as the residue
    scan regenerates one, against the JAX package's, tile for tile."""
    kw = dict(first=5, stride=3)
    want = list(JT._prefix_tiles_planar(6000, 2048, interpret=True, **kw))
    got = list(T._prefix_tiles_planar(6000, 2048, "cpu", **kw))
    assert [h.shape[0] for h, _ in got] == [2048, 2048, 1904]
    assert len(want) == len(got)
    for (h, lo), (jh, jlo) in zip(got, want):
        assert h.dtype == torch.int32 and h.is_contiguous()
        np.testing.assert_array_equal(convert.u32(h), np.asarray(jh)[0])
        np.testing.assert_array_equal(convert.u32(lo), np.asarray(jlo)[0])
    pt = ecpy.mul(5 + 3 * 4097)
    assert convert.u32(got[2][1])[1] == pt[0] & 0xFFFFFFFF
