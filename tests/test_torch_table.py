"""The port's device table build and probe against bsgs_tpu's, bit for bit:
build_baby_table_device at w=4096 (offsets, disc_sorted, pos_sorted,
dense), probe_keys against T.probe_keys with planted members, and the host
lookups the checker walks. The probe's own cases are in
tests/test_torch_probe_kernel.py, the streamed build's in
tests/test_torch_streamed.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.models import table as JT
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import table as T
from bsgs_tpu_torch.utils import ecpy
from test_torch_probe_kernel import assert_row_lengths, occupied_lengths

torch.set_num_threads(2)

W_BUILD = 4096


@pytest.fixture(scope="module")
def tables():
    jt = JT.build_baby_table_device(W_BUILD)
    pt = T.build_baby_table_device(W_BUILD, device="cpu")
    return jt, pt


@pytest.mark.parametrize("field", ["offsets", "disc_sorted", "pos_sorted",
                                   "dense"])
def test_device_build_matches_jax(tables, field):
    jt, pt = tables
    assert (pt.w, pt.htsz, pt.window) == (jt.w, jt.htsz, jt.window)
    np.testing.assert_array_equal(convert.u32(getattr(pt, field)),
                                  np.asarray(getattr(jt, field)))


def test_device_and_host_builds_carry_row_lengths(tables):
    """The device build and the host pack: row_len is the diff of the
    offsets, with FILL past it in every row, and the probe through it
    answers as bsgs_tpu's whole-row probe of the same table."""
    jt, pt = tables
    host = T.build_baby_table(W_BUILD, pt.htsz, window=16, tile=1024,
                              device="cpu")
    for t in (pt, host):
        assert_row_lengths(t.dense, t.row_len, t.offsets)
        assert t.rows.row_len is t.row_len
    rng = np.random.default_rng(4)
    b = rng.integers(0, 1 << pt.htsz, 4096).astype(np.uint32)
    d = np.where(rng.random(4096) < 0.5, np.asarray(jt.disc_sorted)[
        rng.integers(0, W_BUILD, 4096)], 0xFFFFFFFF).astype(np.uint32)
    want = np.asarray(JT.probe_keys(jnp.asarray(b), jnp.asarray(d),
                                    jt.dense))
    got = T.probe_keys(convert.from_u32(b, "cpu"), convert.from_u32(d, "cpu"),
                       pt.rows)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 4096


def test_table_stats_match_jax(tables):
    jt, pt = tables
    want, got = JT.table_stats(jt), T.table_stats(pt)
    assert got == T.TableStats(**vars(want))
    assert got.entries == W_BUILD and got.max_bucket <= got.window


def test_lookup_positions_on_device_table(tables):
    _, pt = tables
    for r in (1, 2, 1000, W_BUILD):
        assert pt.lookup_positions(ecpy.mul(r)[0]) == [r]
    assert pt.lookup_positions(ecpy.mul(W_BUILD + 5)[0]) == []
    pres = {r: ecpy.mul(r)[0] for r in (3, 77)}
    got = pt.lookup_positions_batch(pres.values())
    for r, x in pres.items():
        assert got[x & ((1 << 64) - 1)] == [r]


def test_lookup_positions_with_sorted_pre():
    """A host-built bsgs_tpu table carried across keeps its exact 64-bit
    lookups (the path the solver tests' checker takes)."""
    jt = JT.build_baby_table(64, 6, window=16, tile=16)
    pt = convert.baby_table(
        w=jt.w, htsz=jt.htsz, window=jt.window, offsets=jt.offsets,
        disc_sorted=jt.disc_sorted, pos_sorted=jt.pos_sorted,
        dense=np.asarray(jt.dense), sorted_pre=jt.sorted_pre, device="cpu")
    for r in (1, 17, 64):
        x = ecpy.mul(r)[0]
        assert pt.lookup_positions(x) == jt.lookup_positions(x) == [r]
    assert pt.lookup_positions(ecpy.mul(65)[0]) == []


@pytest.fixture(scope="module")
def probe_case():
    rng = np.random.default_rng(2026)
    htsz, window, m = 8, 128, 5000
    dense = rng.integers(0, 1 << 32, (1 << htsz, window)).astype(np.uint32)
    dense[3, 100:] = 0xFFFFFFFF  # empty slots
    bucket = rng.integers(0, 1 << htsz, m).astype(np.uint32)
    disc = np.where(
        rng.random(m) < 0.5,
        dense[bucket, rng.integers(0, window, m)],
        rng.integers(0, 1 << 32, m).astype(np.uint32),
    ).astype(np.uint32)
    want = np.asarray(JT.probe_keys(jnp.asarray(bucket), jnp.asarray(disc),
                                    jnp.asarray(dense)))
    assert 0 < want.sum() < m
    port = [convert.from_u32(a, "cpu") for a in (bucket, disc, dense)]
    return port + [occupied_lengths(dense)], want


def test_probe_keys_matches_jax(probe_case):
    (bucket, disc, dense, row_len), want = probe_case
    np.testing.assert_array_equal(
        T.probe_keys(bucket, disc, T.ProbeRows(dense, row_len)).numpy(),
        want)


@pytest.mark.parametrize("w,window", [(1 << 26, 128), (4096, 128),
                                      (100, 16), (1 << 30, 512)])
def test_pick_htsz_matches_jax(w, window):
    assert T.pick_htsz(w, window) == JT.pick_htsz(w, window)


def test_bucket_disc_matches_jax():
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 1 << 32, 64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 64).astype(np.uint32)
    for htsz in (6, 20):
        jb, jd = JT.bucket_disc(jnp.asarray(hi), jnp.asarray(lo), htsz)
        b, d = T.bucket_disc(torch.from_numpy(hi.astype(np.int64)),
                             torch.from_numpy(lo.astype(np.int64)), htsz)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_bucket_overflow_is_refused():
    with pytest.raises(ValueError, match="bucket overflow"):
        T.build_baby_table_device(2048, htsz=4, window=64, device="cpu")
