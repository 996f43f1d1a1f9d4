"""Table artifacts across the two packages, at small w and exactly: every
kind the port saves loads in the JAX package (with the hint filter on: a
uint16 hint plane) and every kind the JAX package saves loads in the port,
with bit-equal dense matrices and identical lookups; refusals (a corrupted
artifact, a streamed one at a wider window); the host pack's pieces and
the full-rescan lookup against the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bsgs_tpu.models import table as JT
from bsgs_tpu.utils import artifacts as JA
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import table as T
from bsgs_tpu_torch.utils import artifacts as A, ecpy
from test_torch_probe_kernel import assert_row_lengths

torch.set_num_threads(2)

W, HTSZ, WINDOW = 256, 6, 16
MEMBERS = (1, 77, 200, 256)
NON_MEMBER = W + 5


def _prefixes(rs):
    return [ecpy.mul(r)[0] & ((1 << 64) - 1) for r in rs]


def _lookups(table, rs=MEMBERS + (NON_MEMBER,)):
    """Positions of each prefix through lookup_positions_batch (one pass for
    a rescan table), keyed by r."""
    found = table.lookup_positions_batch(_prefixes(rs))
    return {r: sorted(found[p]) for r, p in zip(rs, _prefixes(rs))}


@pytest.fixture(scope="module")
def port_tables():
    kw = dict(window=WINDOW, device="cpu")
    return {
        "host": T.build_baby_table(W, HTSZ, **kw),
        "device": T.build_baby_table_device(W, HTSZ, **kw),
        "streamed": T.build_baby_table_streamed(W, HTSZ, tile=64, chunk=64,
                                                positions="mirror", **kw),
        "streamed-rescan": T.build_baby_table_streamed(
            W, HTSZ, tile=64, chunk=64, positions="rescan", **kw),
    }


@pytest.fixture(scope="module")
def jax_tables():
    return {
        "host": JT.build_baby_table(W, HTSZ, window=WINDOW, tile=64),
        "device": JT.build_baby_table_device(W, HTSZ, window=WINDOW, tile=64),
        "streamed-rescan": JT.build_baby_table_streamed(
            W, HTSZ, window=WINDOW, tile=32, chunk=64, positions="rescan"),
    }


@pytest.mark.parametrize("kind", ["host", "device", "streamed",
                                  "streamed-rescan"])
def test_port_artifact_loads_in_jax(port_tables, kind, tmp_path):
    table = port_tables[kind]
    path = str(tmp_path / "t.npz")
    A.save_baby_table(table, path)
    z = np.load(path)
    assert str(z["kind"]) == kind
    for key in z.files:
        if z[key].ndim:
            assert z[key].dtype in (np.uint32, np.uint16, np.uint64), key
    jt = JA.load_baby_table(path)
    np.testing.assert_array_equal(np.asarray(jt.dense),
                                  convert.u32(table.dense))
    if kind == "streamed-rescan":
        assert jt.pos_lo.dtype == jnp.uint16  # the JAX hint filter is on
        np.testing.assert_array_equal(
            np.asarray(jt.pos_lo), table.pos_lo.numpy().view(np.uint16))
    want = _lookups(table)
    assert _lookups(jt) == want
    assert want[NON_MEMBER] == [] and all(want[r] == [r] for r in MEMBERS)


@pytest.mark.parametrize("kind", ["host", "device", "streamed",
                                  "streamed-rescan"])
def test_artifact_round_trip_makes_row_lengths(port_tables, kind, tmp_path):
    """Artifacts hold no row lengths: the loader makes them from the
    offsets, equal to the saved table's, FILL past them."""
    table = port_tables[kind]
    path = str(tmp_path / "t.npz")
    A.save_baby_table(table, path)
    assert not any("len" in k for k in np.load(path).files)
    got = A.load_baby_table(path, device="cpu")
    assert_row_lengths(got.dense, got.row_len, got.offsets)
    assert torch.equal(got.row_len, table.row_len)


@pytest.mark.parametrize("kind", ["host", "device", "streamed-rescan"])
def test_jax_artifact_loads_in_the_port(jax_tables, kind, tmp_path):
    jt = jax_tables[kind]
    path = str(tmp_path / "t.npz")
    JA.save_baby_table(jt, path)
    table = A.load_baby_table(path, device="cpu")
    assert (table.w, table.htsz, table.window) == (jt.w, jt.htsz, jt.window)
    np.testing.assert_array_equal(convert.u32(table.dense),
                                  np.asarray(jt.dense))
    if kind != "streamed-rescan":
        np.testing.assert_array_equal(convert.u32(table.offsets),
                                      np.asarray(jt.offsets))
    else:
        assert table.pos_lo.dtype == torch.int16
    assert _lookups(table) == _lookups(jt)


def test_rescan_artifact_without_hint_uses_the_full_rescan(jax_tables,
                                                           tmp_path):
    jt = jax_tables["streamed-rescan"]
    path = str(tmp_path / "old.npz")
    np.savez(path, kind="streamed-rescan", w=jt.w, htsz=jt.htsz,
             window=jt.window, dense=np.asarray(jt.dense),
             offsets=np.asarray(jt.offsets))
    table = A.load_baby_table(path, device="cpu")
    assert table.pos_lo is None and table.lookup_fn is not None
    assert _lookups(table) == {r: [r] for r in MEMBERS} | {NON_MEMBER: []}


def test_rescan_lookup_matches_jax():
    rs = (1, 2, 255, 256, NON_MEMBER)
    pres = _prefixes(rs) + [12345]
    got = T.make_rescan_lookup(W, tile=64, device="cpu").batch(pres)
    want = JT.make_rescan_lookup(W).batch(pres)
    assert got == {p: list(v) for p, v in want.items()}
    assert T.make_rescan_lookup(W, device="cpu")(pres[2]) == [255]


@pytest.mark.parametrize("kind", ["host", "device"])
def test_corrupted_artifact_is_refused(port_tables, kind, tmp_path):
    path = str(tmp_path / "bad.npz")
    A.save_baby_table(port_tables[kind], path)
    z = dict(np.load(path))
    key = "sorted_pos" if kind == "host" else "pos_sorted"
    z[key] = z[key][::-1].copy()  # every position moved
    np.savez(path, **z)
    with pytest.raises(ValueError, match="corrupt"):
        A.load_baby_table(path, spot_checks=64, device="cpu")


def test_streamed_artifact_refused_at_a_wider_window(port_tables, tmp_path):
    path = str(tmp_path / "st.npz")
    A.save_baby_table(port_tables["streamed"], path)
    with pytest.raises(ValueError, match="window"):
        A.load_baby_table(path, window=2 * WINDOW, device="cpu")
    assert A.load_baby_table(path, window=WINDOW, device="cpu").window == \
        WINDOW


def test_host_and_device_artifacts_rederive_a_wider_window(port_tables,
                                                           tmp_path):
    for kind in ("host", "device"):
        path = str(tmp_path / f"{kind}.npz")
        A.save_baby_table(port_tables[kind], path)
        t = A.load_baby_table(path, window=32, device="cpu")
        assert t.window == 32 and t.dense.shape == (1 << HTSZ, 32)
        np.testing.assert_array_equal(t.dense[:, :WINDOW],
                                      port_tables[kind].dense)


@pytest.mark.parametrize("window", [12, 16, 24])
def test_dense_from_csr_and_fit_window_match_jax(jax_tables, window):
    jt = jax_tables["host"]
    maxb = int(np.diff(jt.offsets.astype(np.int64)).max())
    for b in (0, 1, 4, 5, maxb, 130):
        assert T.fit_window(b, window) == JT.fit_window(b, window)
    window = T.fit_window(maxb, window)
    got = T.dense_from_csr(convert.from_u32(jt.offsets, "cpu"),
                           convert.from_u32(jt.disc_sorted, "cpu"), window)
    np.testing.assert_array_equal(
        convert.u32(got), JT.dense_from_csr(jt.offsets, jt.disc_sorted,
                                            window))
    with pytest.raises(ValueError, match="window"):
        T.dense_from_csr(convert.from_u32(jt.offsets, "cpu"),
                         convert.from_u32(jt.disc_sorted, "cpu"), maxb - 1)


def test_get_baby_table_builds_once(tmp_path):
    builds = []

    def build():
        builds.append(1)
        return T.build_baby_table_device(W, HTSZ, window=WINDOW,
                                         device="cpu")

    kw = dict(window=WINDOW, cache_dir=str(tmp_path), device="cpu",
              build=build)
    t1 = A.get_baby_table(W, HTSZ, **kw)
    t2 = A.get_baby_table(W, HTSZ, **kw)
    assert builds == [1]
    assert str(np.load(A.baby_table_path(str(tmp_path), W, HTSZ))["kind"]) \
        == "device"
    assert A.baby_table_path("d", W, HTSZ) == JA.baby_table_path("d", W,
                                                                 HTSZ)
    assert torch.equal(t1.dense, t2.dense)
    host = A.get_baby_table(64, 4, window=8, device="cpu")
    assert host.sorted_pre is not None and host.w == 64
