"""Cross-epoch pipelining of the port (giant.pipelined_step,
giant.probe_keys_flush, SolverConfig.cross_pipeline) on the CPU, where the
two halves of a step run one after the other: each step's key bundle and
the previous epoch's hit array against bsgs_tpu's pipelined_step (Pallas
in interpret mode) bit for bit, the flush likewise; and pipelined solves
against the direct solve: the same key, drained records and callbacks,
the same exhaustion counts, and an overflow re-run outside the pipeline."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.models import giant as JG, table as JT
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import giant as G, solver as S
from bsgs_tpu_torch.ops import planar as PL
from bsgs_tpu_torch.utils import ecpy

from test_torch_epoch_kernel import _i32, epoch_setup  # noqa: F401

torch.set_num_threads(2)

KW = dict(chunk_c=2, lanes_w=128, hit_cap=64)


def test_pipelined_steps_and_flush_match_jax(epoch_setup):  # noqa: F811
    """Three epochs of _setup's geometry (the same centers shifted one
    job each time): the priming step, a step that probes epoch 0's keys,
    and the flush of epoch 1's, against bsgs_tpu's. The port's step takes
    the centers and offsets packed."""
    baby, ox, oy, cx, cy, cinf, ox_pl, oy_pl, dense_j, rows = epoch_setup
    htsz = baby.htsz
    epochs = [(cx, cy, cinf), (cx[1:], cy[1:], cinf[1:])]
    epochs[1] = tuple(jnp.concatenate([a, a[:1]]) for a in epochs[1])
    t, n = cx.shape[0], ox.shape[0]
    j_prev = (jnp.zeros((8, t * n), jnp.uint32), jnp.zeros((t,), jnp.uint32),
              jnp.zeros((t,), jnp.uint32), jnp.zeros((t,), bool))
    p_prev = (None,) * 4
    for e, (ecx, ecy, ecinf) in enumerate(epochs):
        want = JG.pipelined_step(
            *j_prev, jnp.asarray(e > 0), ecx, ecy, jnp.swapaxes(ox, 0, 1),
            jnp.swapaxes(oy, 0, 1), dense_j, htsz=htsz, interpret=True,
            **KW)
        got = G.pipelined_step(
            *p_prev, e > 0, PL.pack_planes(_i32(np.asarray(ecx)).T),
            PL.pack_planes(_i32(np.asarray(ecy)).T), PL.pack_planes(ox_pl),
            PL.pack_planes(oy_pl), rows, htsz=htsz, **KW)
        for w, g in zip(want[:4], got[:4]):
            np.testing.assert_array_equal(convert.u32(g), np.asarray(w))
        assert int(got[4]) == int(want[4]) and int(got[4]) == (
            0 if e == 0 else int(want[4]))
        j_prev = (*want[:3], ecinf)
        p_prev = (*got[:3], torch.from_numpy(np.array(ecinf)))
    assert int(want[4]) > 32  # epoch 0's planted pairs and exact lane
    w_idx, w_cnt = JG.probe_keys_flush(*j_prev, dense_j, htsz=htsz,
                                       hit_cap=64)
    idx, cnt = G.probe_keys_flush(*p_prev, rows, hit_cap=64)
    np.testing.assert_array_equal(convert.u32(idx), np.asarray(w_idx))
    assert int(cnt) == int(w_cnt) > 0


# ---------------------------------------------------------------------------
# Pipelined solves against the direct solve

GEOM = dict(w=256, htsz=6, n_offsets=8, jobs_per_epoch=4, window=16,
            table_tile=64, chunk_c=2, lanes_w=4, epoch_phases=2)


@pytest.fixture(scope="module")
def baby():
    jt = JT.build_baby_table(256, 6, window=16, tile=64)
    return convert.baby_table(
        w=jt.w, htsz=jt.htsz, window=jt.window, offsets=jt.offsets,
        disc_sorted=jt.disc_sorted, pos_sorted=jt.pos_sorted,
        dense=np.asarray(jt.dense), sorted_pre=jt.sorted_pre, device="cpu")


def _events(solver, pub, pk, pke, **kw):
    """A solve's drained hit records (decoded, in the order the scan
    drains them) and its callbacks, and its result."""
    events = []
    collect = solver._collect

    def recording(pub_, pk_, rec):
        batch, gs = collect(pub_, pk_, rec)
        if rec[0] is not None:
            events.append(("drain", rec[0],
                           sorted((r[0].job_base,) + r[1:] for r in batch)))
        return batch, gs

    solver._collect = recording
    try:
        res = solver.solve(
            pub, pk, pke,
            on_epoch=lambda e, steps: events.append(("on_epoch", e, steps)),
            progress=lambda done, total, steps, dt: events.append(
                ("progress", done, total, steps)), **kw)
    finally:
        del solver._collect
    return events, res


def test_pipelined_solve_equals_the_direct_solve(baby):
    direct = S.Solver(S.SolverConfig(**GEOM), baby=baby, device="cpu")
    piped = S.Solver(S.SolverConfig(cross_pipeline=True, **GEOM),
                     baby=baby, device="cpu")
    assert piped._pipelined and piped._phases == 1
    assert not direct._pipelined and direct._phases == 2
    cfg = direct.cfg
    pk = 1 << 20
    k = pk + 2 * cfg.keys_per_epoch + 4321  # epoch 2
    pke = pk + 4 * cfg.keys_per_epoch
    got, res_p = _events(piped, ecpy.mul(k), pk, pke)
    want, res_d = _events(direct, ecpy.mul(k), pk, pke)
    assert res_p.key == res_d.key == k
    assert (res_p.giant_steps, res_p.epochs, res_p.hits_checked) == (
        res_d.giant_steps, res_d.epochs, res_d.hits_checked)
    assert got == want and any(e[0] == "drain" and e[2] for e in got)
    # exhaustion: the flush drains the last epoch; same counts
    far = ecpy.mul(pk + (1 << 40))
    r_p = piped.solve(far, pk, pk + 3 * cfg.keys_per_epoch - 1)
    r_d = direct.solve(far, pk, pk + 3 * cfg.keys_per_epoch - 1)
    assert r_p.key is None and r_d.key is None
    assert (r_p.giant_steps, r_p.epochs) == (r_d.giant_steps, r_d.epochs)
    # a one-epoch scan: the priming step and the flush alone
    r1 = piped.solve(ecpy.mul(pk + 4321), pk, pk + 3 * cfg.keys_per_epoch,
                     max_epochs=1)
    assert r1.key == pk + 4321 and r1.epochs == 1


def test_pipelined_overflow_reruns_the_epoch_outside_the_pipeline(baby):
    """A table of every landing prefix of epoch 0 floods a 4-slot buffer:
    the epoch is re-run directly with a larger one, every hit is
    verified and rejected, and the scan goes on through the pipeline."""
    cfg = S.SolverConfig(cross_pipeline=True, hit_cap=4,
                         **dict(GEOM, jobs_per_epoch=2))
    pub = ecpy.mul(987654321)
    pk = 1000
    q0 = ecpy.sub(pub, ecpy.mul(pk))
    s0 = S.Solver(cfg, baby=baby, device="cpu")
    cx, cy, cinf = s0.epoch_centers(q0, 0, cfg.jobs_per_epoch)
    s_g = ecpy.mul(cfg.stride)
    pres = set()
    for t in range(cfg.jobs_per_epoch):
        m_pt = tuple(sum(int(v) << (16 * i) for i, v in enumerate(row))
                     for row in (cx[t], cy[t]))
        for j in range(1, cfg.n_offsets + 1):
            for pt in (ecpy.add(m_pt, ecpy.mul(j, s_g)),
                       ecpy.sub(m_pt, ecpy.mul(j, s_g))):
                pres.add(pt[0] & ((1 << 64) - 1))
    flood = JT.pack_table(np.array(sorted(pres), dtype=np.uint64), 6, 16)
    flood_t = dataclasses.replace(
        baby, dense=convert.from_u32(np.asarray(flood.dense), "cpu"),
        sorted_pre=np.asarray(flood.sorted_pre),
        offsets=convert.from_u32(flood.offsets, "cpu"),
        disc_sorted=convert.from_u32(flood.disc_sorted, "cpu"),
        pos_sorted=convert.from_u32(flood.pos_sorted, "cpu"))
    results = {}
    for name, piped in (("piped", True), ("direct", False)):
        s = S.Solver(dataclasses.replace(cfg, cross_pipeline=piped),
                     baby=flood_t, device="cpu")
        reruns = []
        orig = s._redispatch

        def counting(q0_, epoch, cap, _orig=orig, _reruns=reruns):
            _reruns.append((epoch, cap))
            return _orig(q0_, epoch, cap)

        s._redispatch = counting
        res = s.solve(pub, pk, pk + 2 * cfg.keys_per_epoch - 1)
        results[name] = (res.key, res.giant_steps, res.epochs,
                         res.hits_checked, reruns)
    assert results["piped"] == results["direct"]
    key, _, epochs, checked, reruns = results["piped"]
    assert key is None and epochs == 3 and checked > cfg.hit_cap
    assert reruns and reruns[0][0] == 0


def test_mesh_solver_keeps_pipelining_off(baby):
    from bsgs_tpu_torch.parallel import mesh as M, striped

    created = M.init_distributed(M.free_address(), 1, 0, backend="gloo")
    try:
        base = S.Solver(S.SolverConfig(cross_pipeline=True, **GEOM),
                        baby=baby, device="cpu")
        ms = striped.MeshSolver(base, M.make_mesh(device="cpu"))
        assert base._pipelined and not ms._pipelined
        assert ms._phases == base._phases == 1  # as bsgs_tpu keeps them
        pk = 1 << 21
        k = pk + ms.cfg.keys_per_epoch + 99
        assert ms.solve(ecpy.mul(k), pk, pk + 3 * ms.cfg.keys_per_epoch
                        ).key == k
    finally:
        if created:
            M.close()
