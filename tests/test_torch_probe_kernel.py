"""The port's probe (ops/probe_kernel) against bsgs_tpu's, exactly: the
plain version against T.probe_keys over stream lengths and row widths, and
against the Pallas kernel probe_rows_dma in interpret mode where that
kernel's group size admits the length (whole tiles of 128 x 128 probes).
Edge cases of the contract: an 0xFFFFFFFF disc matches an empty slot, equal
discs in adjacent buckets do not leak, and the kernel's argument check
refuses what the CUDA kernel cannot take. Tolerance: none, bools must be
equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.models import table as JT
from bsgs_tpu.ops.probe_kernel import probe_rows_dma
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import table as T
from bsgs_tpu_torch.ops import _cuda, probe_kernel as PK

torch.set_num_threads(2)

HTSZ = 8
DMA_TILE = 128 * 128  # probe_rows_dma(group=128) takes whole such tiles


def _case(m: int, window: int, seed: int = 2026):
    """Random dense matrix with some empty slots, and m probes of which
    about half are planted members."""
    rng = np.random.default_rng(seed + 7 * m + window)
    dense = rng.integers(0, 1 << 32, (1 << HTSZ, window)).astype(np.uint32)
    dense[3, window // 2:] = 0xFFFFFFFF
    bucket = rng.integers(0, 1 << HTSZ, m).astype(np.uint32)
    disc = np.where(
        rng.random(m) < 0.5,
        dense[bucket, rng.integers(0, window, m)],
        rng.integers(0, 1 << 32, m).astype(np.uint32),
    ).astype(np.uint32)
    return bucket, disc, dense


def _port(*arrays):
    return [convert.from_u32(a, "cpu") for a in arrays]


@pytest.mark.parametrize("window", [16, 128, 512])
@pytest.mark.parametrize("m", [0, 1, 16, 5000, 16384])
def test_plain_matches_jax_probe_keys(m, window):
    bucket, disc, dense = _case(m, window)
    want = np.asarray(JT.probe_keys(jnp.asarray(bucket), jnp.asarray(disc),
                                    jnp.asarray(dense)))
    b, d, t = _port(bucket, disc, dense)
    got = PK.probe_rows_plain(b, d, t)
    assert got.dtype == torch.bool and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), want)
    if m >= 16:
        assert 0 < want.sum() < m
    # the wrapper and models/table.probe_keys take the same road on the CPU
    assert torch.equal(PK.probe_rows(b, d, t), got)
    assert torch.equal(T.probe_keys(b, d, t), got)


def test_plain_matches_pallas_kernel_on_its_own_test_inputs(rng):
    """The inputs of tests/test_table.py's probe_rows_dma test, through the
    Pallas kernel in interpret mode, T.probe_keys and the port."""
    window, m = 128, DMA_TILE
    dense_h = rng.integers(0, 1 << 32, (1 << HTSZ, window)).astype(np.uint32)
    bucket = rng.integers(0, 1 << HTSZ, m).astype(np.uint32)
    disc = np.where(
        rng.random(m) < 0.5,
        dense_h[bucket, rng.integers(0, window, m)],
        rng.integers(0, 1 << 32, m).astype(np.uint32),
    ).astype(np.uint32)
    dense = jnp.asarray(dense_h)
    want = np.asarray(probe_rows_dma(jnp.asarray(bucket), jnp.asarray(disc),
                                     dense, group=128, interpret=True))
    keys = np.asarray(JT.probe_keys(jnp.asarray(bucket), jnp.asarray(disc),
                                    dense))
    got = PK.probe_rows_plain(*_port(bucket, disc, dense_h)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, keys)
    assert want.sum() > 0


def test_plain_walks_the_stream_in_blocks(monkeypatch):
    """A stream longer than PLAIN_BLOCK, and not a multiple of it, gives
    the same answer as one gather."""
    bucket, disc, dense = _case(5000, 16)
    b, d, t = _port(bucket, disc, dense)
    want = (t[b.long()] == d[:, None]).any(dim=1)
    monkeypatch.setattr(PK, "PLAIN_BLOCK", 768)
    assert torch.equal(PK.probe_rows_plain(b, d, t), want)


def test_fill_disc_matches_an_empty_slot():
    """A probe whose disc is 0xFFFFFFFF hits a row with empty slots and
    misses a full row, as in bsgs_tpu."""
    rng = np.random.default_rng(11)
    dense = rng.integers(0, 1 << 31, (4, 16)).astype(np.uint32)
    dense[2, 9:] = 0xFFFFFFFF
    bucket = np.array([2, 1], np.uint32)
    disc = np.array([0xFFFFFFFF, 0xFFFFFFFF], np.uint32)
    want = np.asarray(JT.probe_keys(jnp.asarray(bucket), jnp.asarray(disc),
                                    jnp.asarray(dense)))
    got = PK.probe_rows(*_port(bucket, disc, dense)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [True, False]


def test_probe_respects_bucket_boundaries():
    """Equal discs in adjacent buckets: the probe of bucket 2 must not see
    bucket 3's entry (tests/test_table.py's case, on its packed table)."""
    htsz = 4
    mk = lambda b, d: np.uint64((b << 60) | (d << 28))
    pre = np.array(sorted([mk(2, 111), mk(3, 222)]), dtype=np.uint64)
    tab = JT.pack_table(pre, htsz=htsz, window=8)
    bucket = np.array([2, 3, 2, 3], np.uint32)
    disc = np.array([222, 222, 111, 111], np.uint32)
    want = np.asarray(JT.probe_keys(jnp.asarray(bucket), jnp.asarray(disc),
                                    tab.dense))
    got = PK.probe_rows(*_port(bucket, disc, np.asarray(tab.dense))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [False, True, True, False]


# ---------------------------------------------------------------------------
# What the kernel takes (checked before any launch; no kernel runs here)


def _args(m=8, window=16):
    return _port(*_case(m, window))


def test_check_accepts_the_card_layouts():
    for window in (16, 128, 512):
        PK.check_probe_args(*_args(window=window))
    PK.check_probe_args(*_args(m=0))


@pytest.mark.parametrize("window", [1, 2, 3, 6, 18, 130])
def test_check_refuses_a_window_not_a_multiple_of_4(window):
    b, d, _ = _args()
    dense = torch.zeros((1 << HTSZ, window), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        PK.check_probe_args(b, d, dense)


def test_check_refuses_misaligned_and_strided_rows():
    b, d, dense = _args(window=16)
    flat = torch.zeros(dense.numel() + 1, dtype=torch.int32)
    shifted = flat[1:].view(dense.shape)  # rows 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        PK.check_probe_args(b, d, shifted)
    with pytest.raises(ValueError, match="contiguous"):
        PK.check_probe_args(b, d, dense[:, ::2][:, :4])
    # the streamed build's view of its dump-slot buffer is aligned
    ok = flat[:-1].view(dense.shape)
    PK.check_probe_args(b, d, ok)


def test_check_refuses_wrong_types_and_shapes():
    b, d, dense = _args()
    with pytest.raises(ValueError, match="int32"):
        PK.check_probe_args(b.long(), d, dense)
    with pytest.raises(ValueError, match="int32"):
        PK.check_probe_args(b, d, dense.long())
    with pytest.raises(ValueError, match="differ in length"):
        PK.check_probe_args(b, d[:-1], dense)
    with pytest.raises(ValueError, match="2-D"):
        PK.check_probe_args(b, d, dense.reshape(-1))


def test_launch_counter_covers_seven_kernels_and_stays_zero_on_cpu():
    assert _cuda.KERNELS[-1] == "probe_rows" and len(_cuda.KERNELS) == 7
    assert set(_cuda.LAUNCHES) == set(_cuda.KERNELS)
    assert "bsgs_probe_rows" in _cuda.SIGNATURES
    before = dict(_cuda.LAUNCHES)
    PK.probe_rows(*_args())
    assert _cuda.LAUNCHES == before
