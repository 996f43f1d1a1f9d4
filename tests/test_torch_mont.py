"""The redesigned Montgomery passes on the CPU: the plain versions of the
kernels' split of a chain into segments against the serial walks, bit for
bit; the points entry (denominators formed from the tile's packed points,
then one fold) against bsgs_tpu's add_const_planar in interpret mode; the
tile stream of the new tree against the JAX package's; and the entries'
refusals. The kernels themselves run only on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.models import table as JT
from bsgs_tpu.ops import epoch_kernel as JEK
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import table as T
from bsgs_tpu_torch.ops import epoch_kernel as EK, field as F, planar as PL
from bsgs_tpu_torch.utils import ecpy

torch.set_num_threads(2)


def _i32(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _random_nonzero(seed, m):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % (F.P_INT - 1) + 1
            for _ in range(m)]
    return _i32(F.to_limbs_batch(vals).T.copy())


# (chunk_c, lanes_w, segments): one segment, one position a segment, an odd
# split, the kernels' four positions a segment, and eight
LAYOUTS = [(8, 4, 1), (8, 4, 8), (15, 2, 5), (16, 2, 4), (16, 3, 2)]


@pytest.mark.parametrize("chunk_c,lanes_w,segments", LAYOUTS)
def test_segmented_forward_matches_serial(chunk_c, lanes_w, segments):
    v = _random_nonzero(chunk_c * lanes_w, 2 * chunk_c * lanes_w)
    kw = dict(chunk_c=chunk_c, lanes_w=lanes_w)
    pre, tot = EK.mont_fwd_plain(v, **kw)
    spre, stot = EK.mont_fwd_segmented_plain(v, segments=segments, **kw)
    assert torch.equal(spre, pre) and torch.equal(stot, tot)
    assert tot.shape == (16, 2 * lanes_w)


@pytest.mark.parametrize("chunk_c,lanes_w,segments", LAYOUTS)
def test_segmented_backward_matches_serial(chunk_c, lanes_w, segments):
    m = 2 * chunk_c * lanes_w
    v = _random_nonzero(m + 1, m)
    kw = dict(chunk_c=chunk_c, lanes_w=lanes_w)
    pre, _ = EK.mont_fwd_plain(v, **kw)
    itot = _random_nonzero(m + 2, 2 * lanes_w)
    want = EK.mont_bwd_plain(v, pre, itot, **kw)
    got = EK.mont_bwd_segmented_plain(v, pre, itot, segments=segments, **kw)
    assert torch.equal(got, want)


def test_segmented_fold_inverts():
    """Forward, inversion of the totals, backward, all segmented: every
    lane's inverse, checked with pow."""
    v = _random_nonzero(5, 96)
    kw = dict(chunk_c=12, lanes_w=4, segments=3)
    pre, tot = EK.mont_fwd_segmented_plain(v, **kw)
    inv = EK.mont_bwd_segmented_plain(v, pre, EK.fermat(tot), **kw)
    for lane in range(96):
        x = F.from_limbs(convert.u32(v)[:, lane])
        assert F.from_limbs(convert.u32(inv)[:, lane]) == pow(x, -1, F.P_INT)


@pytest.fixture(scope="module")
def tile():
    """2048 points base + i*step, with lane 5's point as the step C, so that
    lane 5 is a doubling lane; and bsgs_tpu's add_const_planar of them in
    interpret mode (the JAX package's tile advance)."""
    base, step = ecpy.mul(123456789), ecpy.mul(1 << 40)
    xs, ys = EK.fill_multiples_planar(base, step, 2048, device="cpu")
    cx, cy = xs[:, 5:6].clone(), ys[:, 5:6].clone()
    want = JEK.add_const_planar(*(jnp.asarray(convert.u32(t))
                                  for t in (xs, ys, cx, cy)),
                                interpret=True)
    return xs, ys, cx, cy, [np.asarray(w) for w in want]


@pytest.mark.parametrize("chunk_c", [EK.TILE_CHUNK_C, 12, 4])
def test_points_entry_advance_matches_jax(tile, chunk_c):
    """The points entry's plain path (den, then one fold in chains of
    chunk_c; 12 leaves the last block of chains ragged) and add_const give
    bsgs_tpu's x3, y3 and prefixes, doubling lane included."""
    xs, ys, cx, cy, want = tile
    got = EK.add_const_planar(xs, ys, cx, cy, chunk_c=chunk_c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.u32(g), w)
    c = (F.from_limbs(convert.u32(cx)[:, 0]),
         F.from_limbs(convert.u32(cy)[:, 0]))
    assert F.from_limbs(convert.u32(got[0])[:, 5]) == ecpy.dbl(c)[0]


@pytest.mark.parametrize("chunk_c,lanes_w", [(EK.TILE_CHUNK_C, 32), (12, 32)])
def test_points_entry_is_the_fold_of_the_den_plane(tile, chunk_c, lanes_w):
    """mont_fwd_points_packed / mont_bwd_points_packed, unpacked, equal the
    plane entries on the den plane padded with ones: the same prefixes,
    totals and inverses."""
    xs, ys, cx, _, _ = tile
    pk = (PL.pack_planes(xs), PL.pack_planes(ys), PL.pack_planes(cx))
    kw = dict(chunk_c=chunk_c, lanes_w=lanes_w)
    m = xs.shape[1]
    width = -(-m // (chunk_c * lanes_w)) * chunk_c * lanes_w
    den = EK.tile_den_plain(xs, ys, cx).to(torch.int32)
    padded = torch.cat([den, EK._ones(width - m, "cpu")], dim=1)
    pre, tot = EK.mont_fwd_points_packed(*pk, **kw)
    wpre, wtot = EK.mont_fwd_plain(padded, **kw)
    assert pre.shape == (PL.PACKED_ROWS, m)
    assert torch.equal(PL.unpack_planes(pre), wpre[:, :m])
    assert torch.equal(tot, wtot)
    itot = EK.fermat(tot)
    inv = PL.unpack_planes(EK.mont_bwd_points_packed(*pk, pre, itot, **kw))
    assert torch.equal(inv, EK.mont_bwd_plain(padded, wpre, itot,
                                              **kw)[:, :m])
    for lane in (0, 5, m - 1):
        d = F.from_limbs(convert.u32(den)[:, lane])
        assert F.from_limbs(convert.u32(inv)[:, lane]) == pow(d, -1, F.P_INT)
    # lane 5 doubles: its denominator is 2y
    assert (F.from_limbs(convert.u32(den)[:, 5])
            == 2 * F.from_limbs(convert.u32(ys)[:, 5]) % F.P_INT)


def test_prefix_tiles_match_jax():
    """_prefix_tiles_planar at w=8192 in tiles of 2048 (one fill pass, three
    advances through the new tile tree) gives the JAX package's prefix
    stream, tile for tile."""
    want = list(JT._prefix_tiles_planar(8192, 2048, interpret=True))
    got = list(T._prefix_tiles_planar(8192, 2048, "cpu"))
    assert len(got) == len(want) == 4
    for (hi, lo), (jhi, jlo) in zip(got, want):
        np.testing.assert_array_equal(convert.u32(hi), np.asarray(jhi)[0])
        np.testing.assert_array_equal(convert.u32(lo), np.asarray(jlo)[0])


def test_points_entries_refuse_other_inputs(tile):
    planes = tile[:3]
    xs, ys, cx = (PL.pack_planes(t) for t in planes)
    kw = dict(chunk_c=EK.TILE_CHUNK_C, lanes_w=32)
    pre, tot = EK.mont_fwd_points_packed(xs, ys, cx, **kw)
    itot = EK.fermat(tot)
    bad = [
        (xs.long(), ys, cx),  # dtype
        (xs.to("meta"), ys.to("meta"), cx.to("meta")),  # device
        (xs, ys[:, :100], cx),  # ys shape
        (xs, ys, xs[:, :2]),  # not a column
        planes,  # 16 limb rows, not 8 packed ones
    ]
    for args in bad:
        with pytest.raises(ValueError):
            EK.mont_fwd_points_packed(*args, **kw)
        with pytest.raises(ValueError):
            EK.mont_bwd_points_packed(*args, pre, itot, **kw)
    with pytest.raises(ValueError):
        EK.mont_bwd_points_packed(xs, ys, cx, pre.long(), itot, **kw)
    with pytest.raises(ValueError):  # segments that do not divide the chain
        EK.mont_fwd_points_packed(xs, ys, cx, segments=5, **kw)
    with pytest.raises(ValueError):
        EK.mont_fwd_points_packed(xs, ys, cx, chunk_c=0, lanes_w=32)


def test_kernel_layouts():
    """The layouts the CUDA kernels take are checked before a launch."""
    EK._check_mont_layout(EK.TILE_CHUNK_C, EK.LANES_W,
                          EK.mont_segments(EK.TILE_CHUNK_C))
    EK._check_mont_layout(EK.CHUNK_C, EK.LANES_W, EK.mont_segments(EK.CHUNK_C))
    for args in ((64, 48, 16), (64, 256, 32), (48, 256, 4), (64, 256, 5)):
        with pytest.raises(ValueError):
            EK._check_mont_layout(*args)
