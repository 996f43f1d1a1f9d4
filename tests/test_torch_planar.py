"""The port's planar field arithmetic against bsgs_tpu's, bit for bit.

Random canonical batches plus the edge values 0, 1, p-1 and p-2 (every
pairing of them) go through each bsgs_tpu.ops.planar function and its
bsgs_tpu_torch counterpart; the limb planes must be identical."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bsgs_tpu.ops import planar as JP
from bsgs_tpu_torch.ops import field as F, planar as P

torch.set_num_threads(2)

EDGE = [0, 1, F.P_INT - 1, F.P_INT - 2]


def _planes(rng, n):
    """(a, b) host-int lists: every edge pairing plus n random pairs."""
    a = [x for x in EDGE for _ in EDGE]
    b = [y for _ in EDGE for y in EDGE]
    for _ in range(n):
        a.append(int.from_bytes(rng.bytes(32), "little") % F.P_INT)
        b.append(int.from_bytes(rng.bytes(32), "little") % F.P_INT)
    return a, b


def _pl(xs):
    return F.to_limbs_batch(xs).T.copy()  # (16, W) uint32


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(20260)
    a, b = _planes(rng, 112)
    return a, b, _pl(a), _pl(b)


def _port(x):
    return torch.from_numpy(x.astype(np.int64))


BINARY = ["add_mod", "sub_mod", "mul_mod"]
UNARY = ["neg_mod", "sqr_mod", "inv_mod_chain", "is_zero"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_op_matches_jax(operands, name):
    a, b, pa, pb = operands
    want = np.asarray(jax.jit(getattr(JP, name))(jnp.asarray(pa),
                                                 jnp.asarray(pb)))
    got = getattr(P, name)(_port(pa), _port(pb)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("name", UNARY)
def test_unary_op_matches_jax(operands, name):
    _, _, pa, _ = operands
    want = np.asarray(jax.jit(getattr(JP, name))(jnp.asarray(pa)))
    got = getattr(P, name)(_port(pa)).numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_mul_matches_host_ints(operands):
    """An oracle independent of both packages: Python integers."""
    a, b, pa, pb = operands
    got = F.from_limbs_batch(P.mul_mod(_port(pa), _port(pb)).numpy().T)
    assert [int(v) for v in got] == [x * y % F.P_INT for x, y in zip(a, b)]


def test_select_matches_jax(operands):
    _, _, pa, pb = operands
    mask = (np.arange(pa.shape[1]) % 3 == 0)[None]
    want = np.asarray(JP.select(jnp.asarray(mask), jnp.asarray(pa),
                                jnp.asarray(pb)))
    got = P.select(torch.from_numpy(mask), _port(pa), _port(pb)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("htsz", [6, 20, 31])
def test_prefix_and_bucket_disc_match_jax(operands, htsz):
    _, _, pa, _ = operands
    jhi, jlo = JP.x_prefix64(jnp.asarray(pa))
    jb, jd = JP.bucket_disc(jhi, jlo, htsz)
    hi, lo = P.x_prefix64(_port(pa))
    b, d = P.bucket_disc(hi, lo, htsz)
    for got, want in ((hi, jhi), (lo, jlo), (b, jb), (d, jd)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))


def test_const_col_and_u32_bits():
    np.testing.assert_array_equal(
        P.const_col(F.P_INT).numpy(),
        np.asarray(JP.const_col(F.P_INT)).astype(np.int64))
    v = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
    bits = P.u32_bits(v)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  v.numpy().astype(np.uint32))
    np.testing.assert_array_equal(P.u32_value(bits).numpy(), v.numpy())
