"""uint32 values the port holds as int32 bits, read back as uint32: baby
positions at and above 2^31 through every lookup path against the JAX
package's lookup_positions on the same planes, hit indices at and above
2^31 decoded as the JAX package decodes them, and the geometries whose
values would not fit 32 bits refused (w >= 2^32, a probe space reaching
0xFFFFFFFF)."""

import dataclasses

import numpy as np
import pytest
import torch

from bsgs_tpu.models import giant as JG, table as JT
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import giant as G, solver as S
from bsgs_tpu_torch.utils import ecpy, tuner

torch.set_num_threads(2)

BIG = (1 << 31) + 5
R = 100  # the baby index whose position is replaced by BIG


@pytest.fixture(scope="module")
def host_table():
    return JT.build_baby_table(256, 6, window=16, tile=64)


@pytest.fixture(scope="module")
def mirror_table():
    return JT.build_baby_table_streamed(256, 6, window=16, tile=32, chunk=64,
                                        positions="mirror")


def _with_big_position(jt, path):
    """A copy of the JAX table whose entry for baby R holds position BIG,
    read through ``path``: "sorted_pre" (the host pack's 64-bit prefixes),
    "csr" (offsets and the sorted streams) or "mirror" (the position
    plane of a streamed build)."""
    if path == "mirror":
        pos = jt.pos_dense.copy()
        pos[pos == R] = BIG
        return dataclasses.replace(jt, pos_dense=pos)
    pos = np.asarray(jt.pos_sorted).copy()
    pos[pos == R] = BIG
    return dataclasses.replace(
        jt, pos_sorted=pos,
        sorted_pre=jt.sorted_pre if path == "sorted_pre" else None)


@pytest.mark.parametrize("path", ["sorted_pre", "csr", "mirror"])
def test_positions_above_2_31_read_as_uint32(path, host_table,
                                             mirror_table):
    jt = _with_big_position(
        mirror_table if path == "mirror" else host_table, path)
    pt = convert.baby_table(
        w=jt.w, htsz=jt.htsz, window=jt.window, offsets=jt.offsets,
        dense=np.asarray(jt.dense), disc_sorted=jt.disc_sorted,
        pos_sorted=jt.pos_sorted, sorted_pre=jt.sorted_pre,
        pos_dense=jt.pos_dense, device="cpu")
    x = ecpy.mul(R)[0]
    want = jt.lookup_positions(x)
    assert BIG in want
    assert pt.lookup_positions(x) == want
    pre = x & ((1 << 64) - 1)
    assert pt.lookup_positions_batch([x, ecpy.mul(7)[0]])[pre] == want


def test_build_table_refuses_w_of_2_32(monkeypatch):
    with pytest.raises(ValueError, match="2\\^32"):
        S.build_table(S.SolverConfig(w=1 << 32), device="cpu")
    built = []
    monkeypatch.setattr(S.tbl, "build_baby_table_streamed",
                        lambda w, htsz, **kw: built.append(w))
    S.build_table(S.SolverConfig(w=S.W_MAX), device="cpu")
    assert built == [S.W_MAX] and tuner.W_MAX == S.W_MAX == (1 << 32) - 1


# T=16 jobs of N=2^26 offsets: a probe space of 3*T*N + T > 2^31
T_JOBS, N_OFFS = 16, 1 << 26


@pytest.mark.parametrize("phases", [1, 4])
def test_hit_indices_above_2_31_decode_as_jax(phases):
    """Indices as _masks_to_hits makes them (an int64 position cast to
    int32 bits), read back by giant.hit_indices, FILL dropped, and decoded
    as the JAX package decodes the same uint32."""
    flats = [5, (1 << 31) - 1, 1 << 31, BIG, 3 * T_JOBS * N_OFFS + 7]
    bits = torch.tensor(flats + [(1 << 32) - 1],
                        dtype=torch.int64).to(torch.int32)
    assert int(bits[3]) < 0 and int(bits[-1]) == G.FILL
    got = G.hit_indices(bits.numpy())
    assert got.dtype == np.uint32 and got.tolist() == flats
    for flat in got:
        assert (G.decode_flat_phased(int(flat), T_JOBS, N_OFFS, phases)
                == JG.decode_flat_phased(int(np.uint32(flat)), T_JOBS,
                                         N_OFFS, phases))
    # T*N = 2^30: 2^31 + 5 is the exact-landing block's index 5 (a
    # negative int32 would have decoded as a + branch)
    assert G.decode_flat_phased(BIG, T_JOBS, N_OFFS, 1) == (4, 0, 6)


def test_config_refuses_a_probe_space_reaching_fill():
    """(3N + 1) * T = 2^32 - 1 exactly at T=255, N=5,614,336: refused; one
    offset fewer fits, as does the T=16, N=2^26 space above."""
    assert (3 * 5_614_336 + 1) * 255 == S.PROBE_SPACE_LIMIT == 0xFFFFFFFF
    with pytest.raises(ValueError, match="3\\*T\\*N"):
        S.SolverConfig(w=1 << 30, n_offsets=5_614_336, jobs_per_epoch=255)
    with pytest.raises(ValueError, match="uint32"):
        S.SolverConfig(w=1 << 30, n_offsets=1 << 18, jobs_per_epoch=8192)
    S.SolverConfig(w=1 << 30, n_offsets=5_614_335, jobs_per_epoch=255)
    S.SolverConfig(w=1 << 30, n_offsets=N_OFFS, jobs_per_epoch=T_JOBS)
