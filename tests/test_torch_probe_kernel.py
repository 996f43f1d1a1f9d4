"""The port's probe (ops/probe_kernel) against bsgs_tpu's, exactly: the
plain version, which reads each row's occupied slots only (row_len),
against T.probe_keys over stream lengths and row widths, and against the
Pallas kernel probe_rows_dma in interpret mode where that kernel's group
size admits the length. bsgs_tpu's whole-row function is the contract: on
a table whose rows hold 0xFFFFFFFF past their length, the occupied-slot
function equals it bit for bit. Edge cases: an 0xFFFFFFFF disc matches an
empty slot, and a real 0xFFFFFFFF entry of a full row; rows of length 0
and of the full window; equal discs in adjacent buckets do not leak; and
the kernel's argument check refuses what the CUDA kernel cannot take.
Tolerance: none, bools must be equal."""

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
FILL = 0xFFFFFFFF


def occupied_lengths(dense: np.ndarray) -> torch.Tensor:
    """The row lengths of a uint32 matrix whose rows hold FILL after their
    last entry: each row's index after its last slot that is not FILL.
    With these lengths the occupied-slot probe is the whole-row probe on
    any matrix."""
    filled = dense != FILL
    last = np.where(filled.any(axis=1),
                    dense.shape[1] - np.argmax(filled[:, ::-1], axis=1), 0)
    return PK.row_lengths(torch.from_numpy(last), dense.shape[1])


def csr_rows(offsets, dense) -> T.ProbeRows:
    """A bsgs_tpu table's CSR offsets and dense matrix -> the port's
    ProbeRows on the CPU: the matrix's bits and its row lengths (the
    offsets' diff)."""
    dense_t = convert.from_u32(dense, "cpu")
    counts = np.diff(np.asarray(offsets).astype(np.int64))
    return T.ProbeRows(dense_t, PK.row_lengths(torch.from_numpy(counts),
                                               dense_t.shape[1]))


def assert_row_lengths(dense, row_len, offsets, row0: int = 0):
    """A build's rows: row_len (of row_len_dtype) equals the diff of the
    CSR offsets over rows row0.. of dense, and every slot past it holds
    FILL (bsgs_tpu's whole-row probe then equals the occupied-slot one)."""
    rows, window = dense.shape
    assert row_len.dtype == PK.row_len_dtype(window)
    off = torch.from_numpy(convert.u32(offsets).astype(np.int64))
    assert torch.equal(row_len.long(), torch.diff(off[row0:row0 + rows + 1]))
    past = torch.arange(window) >= row_len.long()[:, None]
    assert (dense[past] == T.DENSE_FILL).all()
    assert int(row_len.long().sum()) == int((dense != T.DENSE_FILL).sum())


def _case(m: int, window: int, seed: int = 2026):
    """Random dense matrix with some empty slots, and m probes of which
    about half are planted members."""
    rng = np.random.default_rng(seed + 7 * m + window)
    dense = rng.integers(0, 1 << 32, (1 << HTSZ, window)).astype(np.uint32)
    dense[3, window // 2:] = FILL
    bucket = rng.integers(0, 1 << HTSZ, m).astype(np.uint32)
    disc = np.where(
        rng.random(m) < 0.5,
        dense[bucket, rng.integers(0, window, m)],
        rng.integers(0, 1 << 32, m).astype(np.uint32),
    ).astype(np.uint32)
    return bucket, disc, dense


def _port(bucket, disc, dense):
    return [convert.from_u32(a, "cpu") for a in (bucket, disc, dense)] + [
        occupied_lengths(dense)]


@pytest.mark.parametrize("window", [16, 128, 512])
@pytest.mark.parametrize("m", [0, 1, 16, 5000, 16384])
def test_plain_matches_jax_probe_keys(m, window):
    bucket, disc, dense = _case(m, window)
    want = np.asarray(JT.probe_keys(jnp.asarray(bucket), jnp.asarray(disc),
                                    jnp.asarray(dense)))
    b, d, t, n = _port(bucket, disc, dense)
    got = PK.probe_rows_plain(b, d, t, n)
    assert got.dtype == torch.bool and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), want)
    if m >= 16:
        assert 0 < want.sum() < m
    # the wrapper and models/table.probe_keys take the same road on the CPU
    assert torch.equal(PK.probe_rows(b, d, t, n), got)
    assert torch.equal(T.probe_keys(b, d, T.ProbeRows(t, n)), got)


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
    b, d, t, n = _port(bucket, disc, dense)
    want = (t[b.long()] == d[:, None]).any(dim=1)
    monkeypatch.setattr(PK, "PLAIN_BLOCK", 768)
    assert torch.equal(PK.probe_rows_plain(b, d, t, n), want)


def test_fill_disc_matches_an_empty_slot():
    """A probe whose disc is 0xFFFFFFFF hits a row with empty slots and
    misses a full row, as in bsgs_tpu."""
    rng = np.random.default_rng(11)
    dense = rng.integers(0, 1 << 31, (4, 16)).astype(np.uint32)
    dense[2, 9:] = FILL
    bucket = np.array([2, 1], np.uint32)
    disc = np.array([FILL, FILL], np.uint32)
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
    rows = csr_rows(tab.offsets, np.asarray(tab.dense))
    b, d = (convert.from_u32(a, "cpu") for a in (bucket, disc))
    got = PK.probe_rows(b, d, *rows).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [False, True, True, False]


# ---------------------------------------------------------------------------
# Occupied slots only, on tables bsgs_tpu built


def _edge_table(window: int = 128, seed: int = 5):
    """bsgs_tpu's host pack (htsz 4) of prefixes laid out bucket by bucket:
    bucket 0 full without a 0xFFFFFFFF disc, bucket 1 empty, bucket 2
    short and bucket 3 full, each of these two holding a real 0xFFFFFFFF
    entry, the rest random lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, window + 1, 16)
    lengths[:4] = (window, 0, 5, window)
    pres = []
    for b, n in enumerate(lengths):
        discs = rng.integers(1, FILL, n, dtype=np.uint64)
        if b in (2, 3):
            discs[n // 2] = FILL
        low = rng.integers(0, 1 << 28, n, dtype=np.uint64)
        pres += [(b << 60) | (int(d) << 28) | int(lo)
                 for d, lo in zip(discs, low)]
    tab = JT.pack_table(np.array(sorted(pres), dtype=np.uint64), htsz=4,
                        window=window)
    assert tab.window == window
    return tab, lengths


def _edge_probes(tab, lengths, m: int, seed: int = 6):
    """m probes: an 0xFFFFFFFF disc at every bucket, then members of the
    occupied slots (every third) among random discs."""
    rng = np.random.default_rng(seed)
    dense = np.asarray(tab.dense)
    bucket = rng.integers(0, 16, m).astype(np.uint32)
    disc = rng.integers(0, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
    bucket[:16] = np.arange(16)
    disc[:16] = FILL
    members = np.flatnonzero(lengths)
    for i in range(16, m, 3):
        b = rng.choice(members)
        bucket[i], disc[i] = b, dense[b, rng.integers(0, lengths[b])]
    return bucket, disc


def test_occupied_rows_match_jax_and_the_pallas_kernel():
    """On bsgs_tpu's table carried over by csr_rows (lengths from
    the offsets' diff): the plain version equals JT.probe_keys and the
    Pallas kernel in interpret mode, with 0xFFFFFFFF discs against full,
    short and empty rows and real 0xFFFFFFFF entries."""
    tab, lengths = _edge_table()
    rows = csr_rows(tab.offsets, np.asarray(tab.dense))
    np.testing.assert_array_equal(rows.row_len.numpy(), lengths)
    assert rows.row_len.dtype == torch.uint8
    bucket, disc = _edge_probes(tab, lengths, 1024)
    jb, jd = jnp.asarray(bucket), jnp.asarray(disc)
    want = np.asarray(JT.probe_keys(jb, jd, tab.dense))
    dma = np.asarray(probe_rows_dma(jb, jd, tab.dense, group=8,
                                    interpret=True))
    b, d = convert.from_u32(bucket, "cpu"), convert.from_u32(disc, "cpu")
    got = PK.probe_rows_plain(b, d, *rows).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dma)
    # a full row answers an 0xFFFFFFFF disc from its real entry alone
    assert got[:4].tolist() == [False, True, True, True]
    np.testing.assert_array_equal(got[4:16], lengths[4:] < 128)
    assert got[16::3].all()
    assert torch.equal(T.probe_keys(b, d, rows), torch.from_numpy(got))


def test_slots_past_the_length_are_not_read():
    """The function is any(dense[b, :n] == d) | (d == FILL & n < window):
    on a matrix holding entries past a row's length, those slots do not
    answer, and an 0xFFFFFFFF disc is answered from the length alone."""
    window = 16
    rng = np.random.default_rng(8)
    dense = rng.integers(0, 1 << 32, (8, window)).astype(np.uint32)
    lengths = np.array([0, 1, 3, 4, 5, 15, 16, 9])
    dense[7, 9:] = FILL
    bucket, disc = [], []
    for b, n in enumerate(lengths):
        for col in range(window):
            bucket.append(b)
            disc.append(dense[b, col])
        bucket.append(b)
        disc.append(FILL)
    bucket, disc = np.array(bucket, np.uint32), np.array(disc, np.uint32)
    want = np.array([
        (d == FILL and lengths[b] < window) or bool(
            (dense[b, :lengths[b]] == d).any())
        for b, d in zip(bucket, disc)])
    b, d, t = (convert.from_u32(a, "cpu") for a in (bucket, disc, dense))
    n = PK.row_lengths(torch.from_numpy(lengths), window)
    got = PK.probe_rows(b, d, t, n).numpy()
    np.testing.assert_array_equal(got, want)
    # slots 3.. of row 2 hold entries the probe must not see
    assert not got[2 * (window + 1) + 3:3 * (window + 1) - 1].any()
    # a full row: every slot answers, an 0xFFFFFFFF disc does not
    assert got[6 * (window + 1):7 * (window + 1)].tolist() == (
        [True] * window + [False])


@pytest.mark.parametrize("window, dtype", [
    (4, torch.uint8), (128, torch.uint8), (252, torch.uint8),
    (255, torch.uint8), (256, torch.int16), (512, torch.int16)])
def test_row_len_dtype(window, dtype):
    assert PK.row_len_dtype(window) == dtype
    counts = torch.tensor([0, window, window // 2])
    got = PK.row_lengths(counts, window)
    assert got.dtype == dtype and got.long().tolist() == counts.tolist()


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
    b, d, _, _ = _args()
    dense = torch.zeros((1 << HTSZ, window), dtype=torch.int32)
    n = torch.zeros((1 << HTSZ,), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 4"):
        PK.check_probe_args(b, d, dense, n)


def test_check_refuses_misaligned_and_strided_rows():
    b, d, dense, n = _args(window=16)
    flat = torch.zeros(dense.numel() + 1, dtype=torch.int32)
    shifted = flat[1:].view(dense.shape)  # rows 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        PK.check_probe_args(b, d, shifted, n)
    with pytest.raises(ValueError, match="contiguous"):
        PK.check_probe_args(b, d, dense[:, ::2][:, :4], n)
    # the streamed build's view of its dump-slot buffer is aligned
    ok = flat[:-1].view(dense.shape)
    PK.check_probe_args(b, d, ok, n)


def test_check_refuses_wrong_types_and_shapes():
    b, d, dense, n = _args()
    with pytest.raises(ValueError, match="int32"):
        PK.check_probe_args(b.long(), d, dense, n)
    with pytest.raises(ValueError, match="int32"):
        PK.check_probe_args(b, d, dense.long(), n)
    with pytest.raises(ValueError, match="differ in length"):
        PK.check_probe_args(b, d[:-1], dense, n)
    with pytest.raises(ValueError, match="2-D"):
        PK.check_probe_args(b, d, dense.reshape(-1), n)


def test_check_refuses_missing_or_wrong_row_lengths():
    """No path reads whole rows: a probe without the row lengths, or with
    lengths of another shape or type, raises, in the kernel's check and
    in the wrapper on the CPU alike."""
    b, d, dense, n = _args(window=16)
    bad = (None, n.to(torch.int16), n.to(torch.int32), n.long(), n[:-1],
           torch.cat([n, n[:1]]), n[:, None], n.view(2, -1))
    for row_len in bad:
        with pytest.raises(ValueError, match="row len|row_len"):
            PK.check_probe_args(b, d, dense, row_len)
        with pytest.raises(ValueError, match="row len|row_len"):
            PK.probe_rows(b, d, dense, row_len)
    wide = torch.zeros((1 << HTSZ, 256), dtype=torch.int32)
    for row_len in (n, torch.zeros((1 << HTSZ,), dtype=torch.uint8)):
        with pytest.raises(ValueError, match="int16"):
            PK.check_probe_args(b, d, wide, row_len)
    PK.check_probe_args(b, d, wide, torch.zeros((1 << HTSZ,),
                                                dtype=torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        PK.check_probe_args(b, d, dense, torch.stack([n, n], 1)[:, 0])


def test_launch_counter_covers_seven_kernels_and_stays_zero_on_cpu():
    assert _cuda.KERNELS[-1] == "probe_rows" and len(_cuda.KERNELS) == 7
    assert set(_cuda.LAUNCHES) == set(_cuda.KERNELS)
    assert "bsgs_probe_rows" in _cuda.SIGNATURES
    before = dict(_cuda.LAUNCHES)
    PK.probe_rows(*_args())
    assert _cuda.LAUNCHES == before
