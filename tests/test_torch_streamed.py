"""The port's streamed big-w table build and its position lookups against
bsgs_tpu's, bit for bit, at three small geometries that flush several
chunks: dense, the 16-bit hint plane, offsets and (mirror mode) the
position plane; exact lookups single and batched; the hint's
false-positive filter; overflow.

The result depends on where the chunks are flushed, not on the tile, so the
port generates in larger tiles than the JAX build (each plain add-const
pass costs a Fermat chain on the CPU) while both flush at the same counts.

Deliberate differences from bsgs_tpu, stated where they are tested: the
port's mirror build allocates no hint plane, and its position plane is a
tensor beside the dense matrix instead of a host array."""

import numpy as np
import pytest
import torch

from bsgs_tpu.models import table as JT
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import table as T
from bsgs_tpu_torch.utils import ecpy
from test_torch_probe_kernel import assert_row_lengths

torch.set_num_threads(2)

MASK64 = (1 << 64) - 1

# name: (w, htsz, window, JAX tile, chunk, the port's tile)
GEOMS = {
    "w256": (256, 6, 16, 32, 64, 64),
    "w512": (512, 5, 32, 32, 128, 128),
    "w6144_window512": (6144, 4, 512, 32, 4096, 2048),
}


@pytest.fixture(scope="module")
def built():
    """Lazy cache of (JAX table, port table) per (geometry, positions)."""
    cache = {}

    def get(name, positions):
        key = (name, positions)
        if key not in cache:
            w, htsz, window, jtile, chunk, ptile = GEOMS[name]
            jt = JT.build_baby_table_streamed(
                w, htsz, window=window, tile=jtile, chunk=chunk,
                positions=positions)
            pt = T.build_baby_table_streamed(
                w, htsz, window=window, tile=ptile, chunk=chunk,
                positions=positions, device="cpu")
            cache[key] = (jt, pt)
        return cache[key]

    return get


@pytest.mark.parametrize("field", ["dense", "pos_lo", "offsets"])
@pytest.mark.parametrize("name", list(GEOMS))
def test_rescan_build_matches_jax(built, name, field):
    jt, pt = built(name, "rescan")
    assert (pt.w, pt.htsz, pt.window) == (jt.w, jt.htsz, jt.window)
    want = np.asarray(getattr(jt, field))
    got = getattr(pt, field)
    if field == "pos_lo":
        assert got.dtype == torch.int16 and want.dtype == np.uint16
        got = got.numpy().view(np.uint16)
    else:
        got = convert.u32(got)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", ["dense", "pos_dense", "offsets"])
@pytest.mark.parametrize("name", ["w256", "w512"])
def test_mirror_build_matches_jax(built, name, field):
    jt, pt = built(name, "mirror")
    np.testing.assert_array_equal(convert.u32(getattr(pt, field)),
                                  np.asarray(getattr(jt, field)))


def test_mirror_build_keeps_no_hint_plane(built, monkeypatch):
    """Deliberate difference: bsgs_tpu's mirror build allocates and fills a
    uint16 hint plane that nothing reads; the port's allocates none."""
    jt, pt = built("w256", "mirror")
    assert pt.pos_lo is None and pt.lookup_fn is None
    assert jt.pos_lo is None and jt.lookup_fn is None
    assert pt.disc_sorted is None and pt.pos_sorted is None
    made = []
    zeros = torch.zeros

    def recording(*args, **kw):
        made.append(kw.get("dtype"))
        return zeros(*args, **kw)

    monkeypatch.setattr(torch, "zeros", recording)
    T.build_baby_table_streamed(64, 5, window=16, tile=32, chunk=32,
                                positions="mirror", device="cpu")
    assert torch.int16 not in made and torch.int32 in made


def test_auto_positions_and_bad_positions():
    t = T.build_baby_table_streamed(64, 5, window=16, tile=32, chunk=32,
                                    device="cpu")
    assert t.pos_dense is not None  # auto below 2^28 is mirror, as in JAX
    with pytest.raises(ValueError, match="positions"):
        T.build_baby_table_streamed(64, 5, window=16, tile=32, chunk=32,
                                    positions="host", device="cpu")


@pytest.mark.parametrize("htsz", range(1, 32))
def test_disc_lo_shift_matches_jax(htsz):
    assert T._disc_lo_shift(htsz) == JT._disc_lo_shift(htsz)


def test_table_stats_of_a_streamed_table(built):
    jt, pt = built("w512", "rescan")
    want, got = JT.table_stats(jt), T.table_stats(pt)
    assert got == T.TableStats(**vars(want))
    assert got.dup_pairs is None and "n/a duplicate" in str(got)
    assert got.entries == 512


@pytest.mark.parametrize("positions", ["mirror", "rescan"])
def test_streamed_builds_carry_row_lengths(built, positions):
    """The streamed build (mirror and rescan positions, chunks flushed
    mid-bucket): row_len is the diff of the offsets, FILL past it."""
    _, pt = built("w512", positions)
    assert_row_lengths(pt.dense, pt.row_len, pt.offsets)


def test_streamed_table_probes_members_only(built):
    _, pt = built("w256", "rescan")
    xs = [ecpy.mul(r)[0] & MASK64 for r in list(range(1, 257)) + [300, 999]]
    hi = torch.tensor([x >> 32 for x in xs])
    lo = torch.tensor([x & 0xFFFFFFFF for x in xs])
    b, d = T.bucket_disc(hi, lo, pt.htsz)
    found = T.probe_keys(T.PL.u32_bits(b), T.PL.u32_bits(d), pt.rows)
    assert found[:256].all() and not found[256:].any()


# ---------------------------------------------------------------------------
# Lookups

MEMBERS = [1, 2, 255, 256, 257, 511, 512]
NON_MEMBERS = [512 + 5, 512 + 999]


@pytest.mark.parametrize("r", MEMBERS)
def test_strided_lookup_exact_positions(built, r):
    jt, pt = built("w512", "rescan")
    x = ecpy.mul(r)[0]
    assert pt.lookup_positions(x) == jt.lookup_positions(x) == [r]


def test_strided_lookup_non_members_and_batch(built):
    jt, pt = built("w512", "rescan")
    for k in NON_MEMBERS:
        x = ecpy.mul(k)[0]
        assert pt.lookup_positions(x) == jt.lookup_positions(x) == []
    xs = [ecpy.mul(r)[0] for r in MEMBERS + NON_MEMBERS]
    want = jt.lookup_positions_batch(xs)
    got = pt.lookup_positions_batch(xs + xs[:2])  # duplicates collapse
    assert got == want
    assert [got[x & MASK64] for x in xs] == [[r] for r in MEMBERS] + [[], []]
    assert pt.lookup_positions_batch([]) == {}


def test_false_positive_rejected_without_regeneration(built, monkeypatch):
    """A dense slot that matches a landing's disc but whose hint carries
    other extra bits is a probe false positive: the lookup rejects it from
    the two rows alone and never calls the prefix generator."""
    _, pt0 = built("w512", "rescan")
    dense, hint = pt0.dense.clone(), pt0.pos_lo.clone()
    sh, mk = T._disc_lo_shift(pt0.htsz)
    pre = ecpy.mul(70_001)[0] & MASK64
    bucket = pre >> (64 - pt0.htsz)
    disc = (pre >> (32 - pt0.htsz)) & 0xFFFFFFFF
    free = int((dense[bucket] == T.DENSE_FILL).nonzero()[0])
    wrong = ((pre >> sh) & mk) ^ 0x5A
    dense[bucket, free] = T._i32(disc)
    hint[bucket, free] = int(T._u16_bits(torch.tensor((wrong << 8) | 7)))
    lookup = T.make_strided_lookup(pt0.w, dense, hint, pt0.htsz, tile=128)

    def no_generation(*a, **kw):
        raise AssertionError("the prefix generator was called")

    monkeypatch.setattr(T, "_prefix_tiles_planar", no_generation)
    assert lookup(pre) == []
    assert lookup.batch([pre]) == {pre: []}
    assert lookup.stats == {"lookups": 2, "rejected": 2, "residue_scans": 0}
    monkeypatch.undo()
    # with the right extra bits the slot survives to one residue scan,
    # which finds no baby point with this prefix
    hint[bucket, free] = int(T._u16_bits(
        torch.tensor((((pre >> sh) & mk) << 8) | 7)))
    assert lookup(pre) == []
    assert lookup.stats["residue_scans"] == 1


def test_mirror_lookup_positions(built):
    jt, pt = built("w256", "mirror")
    for r in (1, 2, 63, 64, 65, 200, 256):
        x = ecpy.mul(r)[0]
        assert pt.lookup_positions(x) == jt.lookup_positions(x) == [r]
    assert pt.lookup_positions(ecpy.mul(256 + 7)[0]) == []


def test_jax_streamed_table_carried_across(built):
    """convert.baby_table brings a bsgs_tpu rescan table over with no CSR
    arrays and rebuilds the lookup on the port's tensors."""
    jt, pt = built("w512", "rescan")
    ct = convert.baby_table(
        w=jt.w, htsz=jt.htsz, window=jt.window, offsets=jt.offsets,
        dense=np.asarray(jt.dense), pos_lo=np.asarray(jt.pos_lo), tile=128,
        device="cpu")
    assert ct.disc_sorted is None and ct.lookup_fn is not None
    assert torch.equal(ct.dense, pt.dense)
    assert torch.equal(ct.pos_lo, pt.pos_lo)
    for r in (1, 256, 257, 512):
        assert ct.lookup_positions(ecpy.mul(r)[0]) == [r]
    with pytest.raises(ValueError, match="uint16"):
        convert.baby_table(
            w=jt.w, htsz=jt.htsz, window=jt.window, offsets=jt.offsets,
            dense=np.asarray(jt.dense),
            pos_lo=np.asarray(jt.pos_lo).astype(np.uint8), device="cpu")
    jm, _ = built("w256", "mirror")
    cm = convert.baby_table(
        w=jm.w, htsz=jm.htsz, window=jm.window, offsets=jm.offsets,
        dense=np.asarray(jm.dense), pos_dense=jm.pos_dense, device="cpu")
    assert cm.lookup_positions(ecpy.mul(200)[0]) == [200]


def test_overflow_is_refused_with_the_same_message():
    args = dict(htsz=2, window=16, chunk=64, positions="rescan")
    with pytest.raises(ValueError, match="bucket overflow") as want:
        JT.build_baby_table_streamed(256, tile=32, **args)
    with pytest.raises(ValueError, match="bucket overflow") as got:
        T.build_baby_table_streamed(256, tile=64, device="cpu", **args)
    assert str(got.value) == str(want.value)
