"""The residue scans of make_strided_lookup on the CPU, where every kernel
wrapper runs its plain version: the stream of a residue class made from
the kept first tile (table._ResidueTiles: K = (256*(i+1))G, one tile
advance a class) against the fill's stream,
_prefix_tiles_planar(count, tile, first=first, stride=256), tile for tile
and bit for bit; one fill of K for every scan of a lookup."""

import pytest
import torch

from bsgs_tpu_torch.models import table as T
from bsgs_tpu_torch.ops import epoch_kernel as EK
from bsgs_tpu_torch.utils import ecpy

torch.set_num_threads(2)

MASK64 = (1 << 64) - 1

# (w, tile): one tile a class at tile 2048; several tiles a class (the
# advances by K's step) at tile 8; at w = 524,289 class 1 takes a 4096
# tile and classes 2..256 a 2048 tile, narrower than K
GEOMS = [(6000, 2048), (8192, 2048), (6000, 8), (524_289, 4096)]
FIRSTS = [1, 2, 128, 255, 256]


@pytest.fixture(scope="module")
def streams():
    """One _ResidueTiles a geometry, shared by its classes as a lookup
    shares it: the first class run fills K, the others reuse it."""
    cache = {}

    def get(w, tile):
        if (w, tile) not in cache:
            cache[w, tile] = T._ResidueTiles(w, tile, torch.device("cpu"))
        return cache[w, tile]

    return get


@pytest.mark.parametrize("first", FIRSTS)
@pytest.mark.parametrize("w,tile", GEOMS)
def test_kept_tile_stream_matches_the_fill(streams, w, tile, first):
    count = (w - first) // 256 + 1
    want = list(T._prefix_tiles_planar(count, tile, "cpu", first=first,
                                       stride=256))
    got = list(streams(w, tile).tiles(first))
    assert [h.shape[0] for h, _ in got] == [h.shape[0] for h, _ in want]
    assert sum(h.shape[0] for h, _ in got) == count
    for (h, lo), (wh, wlo) in zip(got, want):
        assert h.dtype == torch.int32
        assert torch.equal(h, wh) and torch.equal(lo, wlo)
    # the last point of the class, from the host
    x = ecpy.mul(first + (count - 1) * 256)[0]
    last_hi, last_lo = got[-1][0][-1], got[-1][1][-1]
    assert (int(last_hi) & 0xFFFFFFFF, int(last_lo) & 0xFFFFFFFF) == (
        (x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF)


def test_kept_tile_is_class_256s_first_tile(streams):
    """K is the first tile of class 256, and the class 1 tile's width."""
    s = streams(524_289, 4096)
    list(s.tiles(1))
    kx, ky, _, _ = s.kept
    assert kx.shape == ky.shape == (8, 4096) == (8, s.t)
    for i in (0, 1, 2047, 4095):
        x = ecpy.mul(256 * (i + 1))[0]
        assert (int(kx[1, i]) & 0xFFFFFFFF, int(kx[0, i]) & 0xFFFFFFFF) == (
            (x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF)


@pytest.fixture(scope="module")
def rescan_table():
    return T.build_baby_table_streamed(512, 5, window=32, tile=128,
                                       chunk=128, positions="rescan",
                                       device="cpu")


def test_one_fill_for_every_scan_of_a_lookup(rescan_table, monkeypatch):
    """A lookup fills K in its first residue scan and never again; a
    lookup that never scans fills nothing."""
    t = rescan_table
    fills = []
    fill = EK.fill_multiples_packed

    def counting(*a, **kw):
        fills.append(a[2] if len(a) > 2 else kw["n"])
        return fill(*a, **kw)

    monkeypatch.setattr(EK, "fill_multiples_packed", counting)
    lookup = T.make_strided_lookup(t.w, t.dense, t.pos_lo, t.htsz, tile=128)
    assert fills == []
    rs = [1, 257, 7, 256, 512, 2]
    for r in rs:
        assert lookup(ecpy.mul(r)[0] & MASK64) == [r]
    assert fills == [128]  # one fill of K, t = the tile of class 1
    assert lookup.stats["residue_scans"] == len(rs)
    got = lookup.batch([ecpy.mul(r)[0] & MASK64 for r in (3, 500)])
    assert sorted(got.values()) == [[3], [500]] and fills == [128]
