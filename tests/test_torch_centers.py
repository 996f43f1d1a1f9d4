"""The port's epoch centers (models/solver.EpochCenters) on the CPU: each
row bit-identical to the serial definition, ec.host_row from the scalar
multiplication of its first center, and to the JAX package's
Solver.epoch_centers, whether the first center was carried from the last
row (consecutive epochs, a MeshSolver rank's stride of 4T, a request going
back as _redispatch makes one, a start_epoch resume) or multiplied, and
wherever a center lies at infinity or the row needs a doubling, which take
the serial row; ec.host_row_shared against host_row; F.to_limbs_batch's
byte read against F.to_limbs; the packed words and limb rows that _centers_on_device stages,
against the packing of the limbs."""

import types

import numpy as np
import pytest
import torch

from bsgs_tpu.models import solver as JS
from bsgs_tpu.utils import ecpy as jecpy
from bsgs_tpu_torch.models import solver as S
from bsgs_tpu_torch.ops import ec, field as F, planar as PL
from bsgs_tpu_torch.utils import ecpy

torch.set_num_threads(2)

GEOM = dict(w=256, htsz=6, n_offsets=8, jobs_per_epoch=4, window=16,
            chunk_c=2, lanes_w=4, epoch_phases=2)
Q0 = ecpy.mul(0x5EED_C0FFEE_1234_5678_9ABC)
TS = (1, 2, 16, 70, 128)

# first jobs of successive requests, in units of T, and whether each
# request's first center is carried (one addition from the last one)
SEQUENCES = {
    "consecutive": ([0, 1, 2, 3, 4], [0, 1, 1, 1, 1]),
    "mesh_rank_stride": ([1, 5, 9, 13], [0, 0, 1, 1]),
    "redispatch_back": ([0, 1, 2, 3, 1, 4, 5], [0, 1, 1, 1, 0, 0, 1]),
    "start_epoch_resume": ([0, 1, 2, 7, 8, 9], [0, 1, 1, 0, 1, 1]),
}


@pytest.fixture(scope="module")
def baby():
    return S.Solver(S.SolverConfig(**GEOM), device="cpu").baby


def _solver(baby, **over):
    return S.Solver(S.SolverConfig(**dict(GEOM, **over)), baby=baby,
                    device="cpu")


def _serial(cfg, q0, first_job, n_jobs):
    """The definition: the first center by scalar multiplication, then one
    exact host addition a center."""
    c0 = (first_job * cfg.jobs_span + cfg.n_offsets) * cfg.stride
    step = ecpy.neg(ecpy.mul(cfg.jobs_span * cfg.stride))
    return ec.host_row(ecpy.sub(q0, ecpy.mul(c0)), step, n_jobs)


def _jax(cfg, q0, first_job, n_jobs):
    """bsgs_tpu's Solver.epoch_centers, on an object holding only what it
    reads (its config and center step, by bsgs_tpu's own ecpy)."""
    jcfg = JS.SolverConfig(w=cfg.w, htsz=cfg.htsz, n_offsets=cfg.n_offsets,
                           jobs_per_epoch=cfg.jobs_per_epoch,
                           window=cfg.window)
    js = types.SimpleNamespace(cfg=jcfg, center_step=jecpy.neg(
        jecpy.mul(jcfg.jobs_span * jcfg.stride)))
    return tuple(np.array(a)
                 for a in JS.Solver.epoch_centers(js, q0, first_job, n_jobs))


def _same(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _at_infinity(cfg, job):
    """Q0 whose center of job ``job`` is the point at infinity."""
    return ecpy.mul((job * cfg.jobs_span + cfg.n_offsets) * cfg.stride)


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
@pytest.mark.parametrize("t", TS)
def test_rows_equal_the_serial_definition(baby, t, seq):
    s = _solver(baby)
    firsts, carried = SEQUENCES[seq]
    got = []
    for k in firsts:
        _same(s.epoch_centers(Q0, k * t, t), _serial(s.cfg, Q0, k * t, t))
        got.append(int(s._centers.carried))
        assert not s._centers.exact
    assert got == carried


@pytest.mark.parametrize("t", TS)
def test_rows_equal_the_jax_package(baby, t):
    s = _solver(baby)
    for k in (0, 1, 2, 6):
        _same(s.epoch_centers(Q0, k * t, t), _jax(s.cfg, Q0, k * t, t))


def test_another_q0_is_multiplied(baby):
    s = _solver(baby)
    q1 = ecpy.add(Q0, ecpy.G)
    for q, first, carried in ((Q0, 0, 0), (Q0, 16, 1), (q1, 0, 0),
                              (q1, 16, 1), (Q0, 32, 0)):
        _same(s.epoch_centers(q, first, 16), _serial(s.cfg, q, first, 16))
        assert s._centers.carried == bool(carried)


@pytest.mark.parametrize("t", (1, 2, 16, 70, 128))
def test_first_center_at_infinity(baby, t):
    """q0 = c0*S*G: lane 0 at infinity (zero coordinates, its flag set),
    by the serial row, multiplied and carried alike."""
    s = _solver(baby)
    q0 = _at_infinity(s.cfg, 3 * t)
    for k, carried, exact in ((3, 0, 1), (2, 0, 0), (3, 1, 1)):
        got = s.epoch_centers(q0, k * t, t)
        _same(got, _serial(s.cfg, q0, k * t, t))
        assert (s._centers.carried, s._centers.exact) == (carried, exact)
    assert got[2][0] and not got[2][1:].any()
    assert not got[0][0].any() and not got[1][0].any()
    _same(got, _jax(s.cfg, q0, 3 * t, t))


@pytest.mark.parametrize("t, i", [(2, 1), (16, 5), (70, 69), (128, 64)])
def test_infinite_center_mid_row(baby, t, i):
    """The center of lane i at infinity: M = -i*step, a zero difference,
    so the serial row. The next row starts at (T - i)*step, so its lane
    T - i is a doubling: the serial row too. The row before takes the
    shared one."""
    s = _solver(baby)
    q0 = _at_infinity(s.cfg, t + i)
    for k in (0, 1, 2):
        got = s.epoch_centers(q0, k * t, t)
        _same(got, _serial(s.cfg, q0, k * t, t))
        assert s._centers.exact == (k > 0)
        assert got[2].tolist() == [k == 1 and j == i for j in range(t)]
    got, want = s.epoch_centers(q0, t, t), _jax(s.cfg, q0, t, t)
    if i >= 64:  # bsgs_tpu's doubling fill past its 64 host lanes leaves
        # an infinite lane's coordinates as they fall; the port zeroes them
        for a in want[:2]:
            a[i] = 0
    _same(got, want)


@pytest.mark.parametrize("t, i", [(2, 1), (16, 3), (70, 40), (128, 127)])
def test_doubling_lane_takes_the_serial_row(baby, t, i):
    """M = +i*step (the center i jobs before the row at infinity): lane i
    is M + i*step = 2M, a doubling."""
    s = _solver(baby)
    q0 = _at_infinity(s.cfg, 4 * t - i)
    got = s.epoch_centers(q0, 4 * t, t)
    assert s._centers.exact and not got[2].any()
    _same(got, _serial(s.cfg, q0, 4 * t, t))
    _same(got, _jax(s.cfg, q0, 4 * t, t))


def test_carried_onto_infinity(baby):
    """The next row's first center at infinity, reached by the carry."""
    s = _solver(baby)
    q0 = _at_infinity(s.cfg, 16)
    for k, exact in ((0, False), (1, True), (2, False)):
        got = s.epoch_centers(q0, 16 * k, 16)
        _same(got, _serial(s.cfg, q0, 16 * k, 16))
        assert (s._centers.carried, s._centers.exact) == (k > 0, exact)


@pytest.mark.parametrize("m", (1, 2, 9, 33))
def test_host_row_shared(m):
    step = ecpy.mul(0xABCDEF)
    mults = [ecpy.mul(i * 0xABCDEF) for i in range(1, m)]
    base = ecpy.mul(0x123456789)
    _same(ec.host_row_shared(base, mults), ec.host_row(base, step, m))
    assert ec.host_row_shared(None, mults) is None
    if m > 1:  # base = -(m-1)*step and base = +(m-1)*step
        assert ec.host_row_shared(ecpy.neg(mults[-1]), mults) is None
        assert ec.host_row_shared(mults[-1], mults) is None


def test_to_limbs_batch_reads_the_little_endian_bytes():
    vals = [0, 1, (1 << 256) - 1, ecpy.P - 1, 0xFFFF << 240, ecpy.GX]
    want = np.stack([F.to_limbs(v) for v in vals])
    got = F.to_limbs_batch(vals)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(F.to_limbs_batch([0x1234_5678_9ABC], 3),
                                  F.to_limbs(0x1234_5678_9ABC, 3)[None])
    for bad in (-1, 1 << 256):
        with pytest.raises(ValueError, match="does not fit"):
            F.to_limbs_batch([1, bad])


@pytest.mark.parametrize("fused", (True, False))
@pytest.mark.parametrize("t", (1, 16, 70))
def test_staged_centers_equal_the_packed_limbs(baby, t, fused):
    """What _centers_on_device copies: for a fused epoch x and y words
    (word i = limb 2i | limb 2i+1 << 16) as packed (8, T) planes, for an
    unfused one the limb rows, each the packing of epoch_centers'
    limbs; an infinite lane included."""
    s = _solver(baby, jobs_per_epoch=t, fused=fused, epoch_phases=1)
    q0 = _at_infinity(s.cfg, t + t // 2)
    for k in (0, 1):
        want = _serial(s.cfg, q0, k * t, t)
        cx, cy, cinf = s._centers_on_device(q0, k * t)
        for got, limbs in ((cx, want[0]), (cy, want[1])):
            if fused:
                old = (limbs[:, 0::2] | (limbs[:, 1::2] << 16)).T.view(
                    np.int32)
                np.testing.assert_array_equal(got.numpy(), old)
                np.testing.assert_array_equal(
                    got.numpy(), PL.pack_planes(torch.from_numpy(
                        limbs.T.astype(np.int32))).numpy())
            else:
                np.testing.assert_array_equal(got.numpy(),
                                              limbs.astype(np.int32))
        np.testing.assert_array_equal(cinf.numpy(), want[2])
