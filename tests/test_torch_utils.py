"""The port's host utilities against the JAX package's: pubkey codecs,
checkpoint format and fingerprint, the pubkey binding of a resume (a
deliberate difference: the JAX resume is not bound to its pubkey), the
tuner (the port's own memory layout and reserve), and the native host pack
against its numpy versions and the JAX package's loader."""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from bsgs_tpu.utils import checkpoint as jckpt, codecs as jcodecs
from bsgs_tpu.utils import native as jnative
from bsgs_tpu_torch import cli
from bsgs_tpu_torch.models import solver as S, table as T
from bsgs_tpu_torch.utils import checkpoint as ckpt, codecs, ecpy, native
from bsgs_tpu_torch.utils import tuner

torch.set_num_threads(2)

KEYS = [1, 2, 3, 0xCAFE5, ecpy.N - 1, ecpy.N - 2,
        *np.random.default_rng(20261016).integers(1, 1 << 62, 6).tolist()]


def _forms(pt):
    c = codecs.format_pubkey(pt)
    u = codecs.format_pubkey(pt, compressed=False)
    return [c, u, u[2:], "0x" + c.upper(), f"  {u}\n"]


def _same_outcome(fn, jfn, s):
    try:
        want = jfn(s)
    except jcodecs.PubkeyError as e:
        with pytest.raises(codecs.PubkeyError) as got:
            fn(s)
        assert str(got.value) == str(e)
        return
    assert fn(s) == want


@pytest.mark.parametrize("k", KEYS)
def test_pubkey_forms_match_jax(k):
    pt = ecpy.mul(k)
    for s in _forms(pt):
        _same_outcome(codecs.parse_pubkey, jcodecs.parse_pubkey, s)
        assert codecs.parse_pubkey(s) == pt
    for comp in (True, False):
        assert codecs.format_pubkey(pt, comp) == jcodecs.format_pubkey(pt,
                                                                       comp)


@pytest.mark.parametrize("s", [
    "", "zz", "02" + "00" * 32, "05" + "11" * 32, "04" + "11" * 64,
    "11" * 64, "abc", "02" + "ff" * 32])
def test_bad_pubkeys_refused_as_jax_refuses_them(s):
    _same_outcome(codecs.parse_pubkey, jcodecs.parse_pubkey, s)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, ecpy.N - 1), st.booleans())
def test_pubkey_codecs_hypothesis(k, compressed):
    pt = ecpy.mul(k)
    s = codecs.format_pubkey(pt, compressed)
    assert s == jcodecs.format_pubkey(pt, compressed)
    assert codecs.parse_pubkey(s) == jcodecs.parse_pubkey(s) == pt


@settings(max_examples=60, deadline=None)
@given(st.one_of(st.integers(0, 64).map(str),
                 st.floats(0, 64, allow_nan=False).map(lambda v: f"{v:.3f}"),
                 st.integers(65, 1 << 40).map(str)),
       st.integers(0, (1 << 256) - 1))
def test_parse_w_and_scalar_match_jax(w, scalar):
    assert codecs.parse_w(w) == jcodecs.parse_w(w)
    for s in (f"{scalar:x}", f"0x{scalar:X}", f" {scalar:064x} "):
        assert codecs.parse_scalar(s) == jcodecs.parse_scalar(s) == scalar


def test_config_fingerprint_matches_jax():
    params = dict(w=1 << 26, htsz=20, n_offsets=1 << 18, pk=1 << 40,
                  pke=(1 << 41) - 1, jobs_per_epoch=16, devices=0,
                  shard_table=False)
    assert ckpt.config_fingerprint(**params) == \
        jckpt.config_fingerprint(**params)
    assert ckpt.config_fingerprint(**dict(params, w=1 << 27)) != \
        ckpt.config_fingerprint(**params)


def test_checkpoint_round_trip_and_jax_format(tmp_path):
    path = str(tmp_path / "cw.json")
    fp = ckpt.config_fingerprint(w=1024, htsz=8, pk=1, pke=100)
    name = ckpt.pubkey_id(codecs.format_pubkey(ecpy.mul(5)))
    w = ckpt.CheckpointWriter(path, fp, interval_s=0.0)
    assert w.maybe_write(3, name, 7, 12345)
    ck = ckpt.Checkpoint.load(path, fp)
    assert (ck.pub_index, ck.pubkey, ck.next_epoch, ck.giant_steps) == (
        3, name, 7, 12345)
    # the same JSON keys: each package reads the other's file
    jck = jckpt.Checkpoint.load(path, fp)
    assert (jck.pub_index, jck.next_epoch) == (3, 7)
    jckpt.CheckpointWriter(path, fp, 0.0).maybe_write(4, "", 0, 0)
    assert ckpt.Checkpoint.load(path, fp).pub_index == 4
    with open(path) as f:
        assert set(json.load(f)) == set(ck.__dataclass_fields__)
    with pytest.raises(ValueError, match="fingerprint"):
        ckpt.Checkpoint.load(
            path, ckpt.config_fingerprint(w=2048, htsz=8, pk=1, pke=100))


def test_checkpoint_rate_limit(tmp_path):
    path = str(tmp_path / "cw.json")
    w = ckpt.CheckpointWriter(path, "fp", interval_s=9999.0)
    assert w.maybe_write(0, "x", 1, 1)
    assert not w.maybe_write(0, "x", 2, 2)
    assert ckpt.Checkpoint.load(path).next_epoch == 1
    assert w.maybe_write(0, "x", 3, 3, force=True)
    assert ckpt.Checkpoint.load(path).next_epoch == 3


def test_pubkey_id_names_one_point_by_any_form():
    pt = ecpy.mul(77)
    ids = {ckpt.pubkey_id(s) for s in _forms(pt)}
    assert ids == {codecs.format_pubkey(pt)}
    assert ckpt.pubkey_id(None) == ""
    assert ckpt.pubkey_id("  NotAKey \n") == "notakey"


@pytest.mark.parametrize("where", ["mid-scan", "boundary", "end"])
def test_resume_refused_on_another_pubkey(tmp_path, where):
    """A checkpoint names the entry at pub_index: the pubkey being scanned
    (mid-scan), the next one (at a boundary), or none (past the end). Only
    that entry binds; the JAX checkpoint's pubkey is never compared."""
    a, b = (codecs.format_pubkey(ecpy.mul(k)) for k in (11, 12))
    named = {"mid-scan": a, "boundary": b, "end": None}[where]
    path = str(tmp_path / "cw.json")
    ckpt.CheckpointWriter(path, "fp", 0.0).maybe_write(
        1, ckpt.pubkey_id(named), 0 if where != "mid-scan" else 5, 9)
    ck = ckpt.Checkpoint.load(path, "fp")
    ck.bind(named)
    if named is not None:
        ck.bind(codecs.format_pubkey(codecs.parse_pubkey(named), False))
    other = codecs.format_pubkey(ecpy.mul(13))
    for entry in (other, "garbage") + ((None,) if named else ()):
        with pytest.raises(ValueError, match="pubkey mismatch"):
            ck.bind(entry)
    if named is None:
        with pytest.raises(ValueError, match="no entry"):
            ck.bind(a)


def test_tuner_fits_memory_with_the_solver_reserve(monkeypatch):
    for mem in (16 << 30, 40 << 30, 80 << 30):
        t = tuner.tune(mem_bytes=mem)
        assert t.scan_bytes <= mem - S.MEMORY_RESERVE
        assert t.est_build_peak_bytes + t.est_offsets_bytes <= mem
        bigger = tuner.plan(2 * t.w)
        assert (t.w == tuner.W_MAX or tuner.plan(t.w + t.w // 2).scan_bytes
                > mem - S.MEMORY_RESERVE or bigger.scan_bytes
                > mem - S.MEMORY_RESERVE)
    # the reserve is the solver's: a larger one shrinks the suggestion
    w16 = tuner.tune(mem_bytes=16 << 30).w
    monkeypatch.setattr(S, "MEMORY_RESERVE", 10 << 30)
    assert tuner.tune(mem_bytes=16 << 30).w < w16


def test_tuner_range_cap_and_flags():
    t = tuner.tune(mem_bytes=80 << 30, range_bits=30)
    assert t.w == 1 << 15
    args = cli.build_parser().parse_args(t.flags().split())
    assert (int(args.w), args.htsz, args.window, args.n_offsets,
            args.jobs_per_epoch, args.pipeline) == (
        t.w, t.htsz, t.window, t.n_offsets, 16, 3)
    assert "--n-split" not in t.flags()
    assert "suggested:" in t.report() and "keys per epoch" in t.report()


def test_tuner_layout_at_the_two_paths():
    """The one-shot layout at w=2^26 and the streamed rescan layout at
    w=2^30: dense 4 B a slot, plus CSR 8 B a key or a 2 B hint a slot,
    offsets 4 B and row lengths 1 B a bucket; the transients from the
    constants measured on the card."""
    a = tuner.plan(1 << 26)
    assert (a.htsz, a.window, a.streamed_build) == (20, 128, False)
    assert a.est_table_bytes == (1 << 20) * 128 * 4 + 8 * (1 << 26) + 4 * (
        (1 << 20) + 1) + (1 << 20)
    b = tuner.plan(1 << 30)
    assert (b.htsz, b.streamed_build) == (24, True)
    assert b.est_table_bytes == (1 << 24) * 128 * 6 + 4 * ((1 << 24) + 1) + (
        1 << 24)
    assert b.est_build_peak_bytes - b.est_table_bytes == int(
        tuner.STREAMED_BUILD_BYTES_PER_BUCKET * (1 << 24))
    assert a.est_build_peak_bytes - a.est_table_bytes == \
        tuner.BUILD_BYTES_PER_KEY << 26
    assert a.est_offsets_bytes == (1 << 18) * 2 * (32 + 64)
    # twice the memory at least doubles w once the table binds
    assert tuner.tune(mem_bytes=32 << 30).w >= 2 * tuner.tune(
        mem_bytes=16 << 30).w
    assert tuner.device_memory_bytes("cpu") > 0


@pytest.fixture(scope="module")
def prefixes():
    rng = np.random.default_rng(7)
    pre = rng.integers(0, 1 << 63, size=3000, dtype=np.int64).astype(
        np.uint64) << np.uint64(1)
    pre[10] = pre[20] = pre[30]  # equal prefixes keep their order
    pre[40] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return pre


def test_native_sort_matches_plain_and_jax(prefixes):
    got = native.sort_prefixes(prefixes)
    for want in (native.sort_prefixes_plain(prefixes),
                 jnative.sort_prefixes(prefixes)):
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype
            np.testing.assert_array_equal(g, w_)
    assert got[1][np.searchsorted(got[0], prefixes[10])].tolist() == 11


@pytest.mark.parametrize("htsz", [1, 4, 8, 12, 16])
def test_native_csr_pack_matches_plain_and_jax(prefixes, htsz):
    sp = np.sort(prefixes)
    got = native.csr_pack(sp, htsz)
    for want in (native.csr_pack_plain(sp, htsz), jnative.csr_pack(sp, htsz)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    with pytest.raises(ValueError, match="htsz"):
        native.csr_pack(sp, 0)


def test_native_library_builds_apart_from_its_source():
    lib = native.build()
    assert lib.parent == native.BUILD and lib.suffix == ".so"
    assert lib.parent != native.SRC.parent
    assert native.build() == lib  # keyed by the source: built once


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "host_pack.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*"))


def test_compute_prefixes_and_pack_match_jax():
    from bsgs_tpu.models import table as JT

    pre = T.compute_prefixes(300, device="cpu")
    np.testing.assert_array_equal(pre, JT.compute_prefixes(300, tile=64))
    t = T.pack_table(pre, 6, window=8, device="cpu")
    jt = JT.pack_table(pre, 6, window=8)
    assert t.window == jt.window
    np.testing.assert_array_equal(t.dense.numpy().view(np.uint32),
                                  np.asarray(jt.dense))
    for r in (1, 150, 300):
        x = ecpy.mul(r)[0]
        assert t.lookup_positions(x) == jt.lookup_positions(x) == [r]
