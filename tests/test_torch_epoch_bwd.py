"""The epoch's backward pass (epoch_bwd): the port's plain version, which is
EK.epoch_bwd_packed's CPU path, against the JAX package's _bwd_kernel (reached
through bsgs_tpu.ops.epoch_kernel.epoch_landing_keys in interpret mode) and
against the landing keys computed with Python's integers, bit for bit:
chain layouts 8 x 1 and 1 x 1 among them, exact lanes (Ox == Mx), slopes
of 0, edge values, and 1, 20 and 31 bucket bits. On the card chip_smoke.py
holds the CUDA kernel against the same plain version."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.ops import epoch_kernel as JEK
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.ops import epoch_kernel as EK, field as F, planar as PL

torch.set_num_threads(2)

P = F.P_INT
T_JOBS, N_OFFSETS = 3, 32
# canonical edge values: 0, 1, 2, p - 1, p - 2, 2^255, every low limb
# 0xFFFF, p - 2^32
EDGE = (0, 1, 2, P - 1, P - 2, 1 << 255, (1 << 224) - 1, P - (1 << 32))


def _planes(seed: int):
    """Offsets (16, N) and centers (16, T) as uint32 limb planes: random
    values with EDGE in the offsets' first lanes, exact lanes (0, 3),
    (1, 17) and (2, N - 1), a + slope of 0 at (0, 3) (Oy == My) and a -
    slope of 0 at (1, 9) (Oy == -My)."""
    rng = np.random.default_rng(seed)

    def rand(m):
        return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(m)]

    ox, oy = rand(N_OFFSETS), rand(N_OFFSETS)
    cx, cy = rand(T_JOBS), rand(T_JOBS)
    ox[:len(EDGE)] = EDGE
    oy[:len(EDGE)] = EDGE[::-1]
    cx[0], cy[0] = ox[3], oy[3]
    cx[1], cy[1] = ox[17], (P - oy[9]) % P
    cx[2] = ox[N_OFFSETS - 1]
    return [F.to_limbs_batch(v).T.copy() for v in (ox, oy, cx, cy)]


def _python_keys(ox, oy, cx, cy, htsz: int):
    """The (8, T*N) key plane from Python's integers: per pair d = Ox - Mx
    (0 -> 1, exact), x(M +- O) = ((Oy -+ My) / d)^2 - Mx - Ox, its low 64
    bits split into the top htsz bits (bucket) and the 32 below (disc)."""
    val = [[F.from_limbs(p[:, i]) for i in range(p.shape[1])]
           for p in (ox, oy, cx, cy)]
    vox, voy, vcx, vcy = val
    out = np.zeros((8, T_JOBS * N_OFFSETS), dtype=np.uint32)
    for t in range(T_JOBS):
        for j in range(N_OFFSETS):
            d = (vox[j] - vcx[t]) % P
            exact = d == 0
            inv = pow(d or 1, -1, P)
            col = t * N_OFFSETS + j
            for row, lam in ((0, (voy[j] - vcy[t]) * inv),
                             (2, (voy[j] + vcy[t]) * inv)):
                x64 = ((lam * lam - vcx[t] - vox[j]) % P) & ((1 << 64) - 1)
                out[row, col] = x64 >> (64 - htsz)
                out[row + 1, col] = (x64 >> (32 - htsz)) & 0xFFFFFFFF
            out[4, col] = exact
    return out


def _port_keys(ox, oy, cx, cy, htsz: int, chunk_c: int, lanes_w: int):
    """EK.epoch_bwd_packed on packed CPU tensors (its plain version) after
    the port's forward pass and inversion, as a uint32 array."""
    t = [PL.pack_planes(torch.from_numpy(p.view(np.int32)))
         for p in (ox, oy, cx, cy)]
    pre, tot = EK.epoch_fwd_packed(t[0], t[2], chunk_c=chunk_c,
                                   lanes_w=lanes_w)
    itot = EK.batch_inv_planar(tot, chunk_c=chunk_c, lanes_w=lanes_w)
    keys = EK.epoch_bwd_packed(*t, pre, itot, htsz=htsz, chunk_c=chunk_c,
                               lanes_w=lanes_w)
    return convert.u32(keys)


@pytest.mark.parametrize("chunk_c, lanes_w, htsz",
                         [(8, 1, 1), (1, 1, 31), (16, 2, 20)])
def test_epoch_bwd_matches_jax_bwd_kernel(chunk_c, lanes_w, htsz):
    ox, oy, cx, cy = _planes(chunk_c * 100 + lanes_w)
    want = np.asarray(JEK.epoch_landing_keys(
        jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(ox), jnp.asarray(oy),
        htsz=htsz, chunk_c=chunk_c, lanes_w=lanes_w, interpret=True))
    got = _port_keys(ox, oy, cx, cy, htsz, chunk_c, lanes_w)
    np.testing.assert_array_equal(got, want)
    assert got[4].sum() == 3  # the three exact lanes


@pytest.mark.parametrize("htsz", [1, 20, 31])
@pytest.mark.parametrize("chunk_c, lanes_w",
                         [(8, 1), (1, 1), (2, 2), (4, 8), (16, 2)])
def test_epoch_bwd_matches_python_integers(chunk_c, lanes_w, htsz):
    ox, oy, cx, cy = _planes(7 * htsz + chunk_c)
    got = _port_keys(ox, oy, cx, cy, htsz, chunk_c, lanes_w)
    np.testing.assert_array_equal(got, _python_keys(ox, oy, cx, cy, htsz))
