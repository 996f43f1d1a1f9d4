"""Worlds of two ranks of the port on the CPU, each rank a process of its
own joined by gloo, held against bsgs_tpu's MeshSolver at n = 2 on the
same configuration: a replicated table (one super-epoch's decoded hit
records, a planted key, and a forced overflow that both ranks re-run), a
table built split over the ranks (the all_gather probe route finds a
planted key; the owner's broadcast rows resolve lookups on both ranks). The command
line's worlds are tests/test_torch_distributed_cli.py. Every world gets a
free port, an explicit rendezvous timeout (parallel/mesh.TIMEOUT) and a
join timeout."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsgs_tpu.models import solver as JS, table as JT
from bsgs_tpu.parallel import mesh as JM, striped as JSTR
from bsgs_tpu_torch.parallel import mesh as M
from bsgs_tpu_torch.utils import ecpy

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mesh_worker.py")
JOIN_S = 300

GEOM = dict(w=256, htsz=6, n_offsets=8, jobs_per_epoch=2, window=16,
            table_tile=64, pipeline=1)
PORT_CFG = dict(GEOM, chunk_c=2, lanes_w=4, epoch_phases=2)
STRIDE, SPAN = 512, 17  # 2w, 2N + 1
PK = 1 << 21
JOBS_SUPER = 4  # 2 ranks x 2 jobs


def _job_key(job: int, j: int, extra: int) -> int:
    """A key landing j offsets below the center of job ``job``."""
    return PK + ((job * SPAN + 8) - j) * STRIDE + extra


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _run_all(cmds, cwd):
    """Run the commands at once in new sessions; kill every one that is
    still running after JOIN_S seconds. Returns [(code, output)]."""
    procs = [subprocess.Popen(c, cwd=cwd, env=_env(), text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              start_new_session=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        outs += [p.communicate()[0] for p in procs[len(outs):]]
        pytest.fail(f"no exit in {JOIN_S} s:\n" + "\n".join(
            o[-2000:] for o in outs))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _world(case, where):
    address = M.free_address()
    got = _run_all([[sys.executable, WORKER, address, "2", str(r), case,
                     str(where)] for r in (0, 1)], where)
    for r, (code, out) in enumerate(got):
        assert code == 0, f"rank {r}:\n{out[-3000:]}"
    res = [json.loads((where / f"{case}.{r}.json").read_text())
           for r in (0, 1)]
    ranks = [d.pop("rank", None) for d in res]
    assert res[0] == res[1]  # every rank decided the same
    return res[0], ranks


def _save(path, jt):
    np.savez(path, w=jt.w, htsz=jt.htsz, window=jt.window,
             offsets=jt.offsets, disc_sorted=jt.disc_sorted,
             pos_sorted=jt.pos_sorted, dense=np.asarray(jt.dense),
             sorted_pre=jt.sorted_pre)


def _flood(q0, n_jobs):
    """A JAX table of every landing prefix of the first n_jobs jobs: every
    probe of super-epoch 0 hits."""
    pres = set()
    for g in range(n_jobs):
        m_pt = ecpy.sub(q0, ecpy.mul((g * SPAN + 8) * STRIDE))
        for j in range(1, 9):
            o = ecpy.mul(j * STRIDE)
            for pt in (ecpy.add(m_pt, o), ecpy.sub(m_pt, o)):
                if pt is not None:
                    pres.add(pt[0] & ((1 << 64) - 1))
    return JT.pack_table(np.array(sorted(pres), dtype=np.uint64), 6, 16)


def _result(res):
    return dict(key=res.key, giant_steps=res.giant_steps, epochs=res.epochs,
                hits_checked=res.hits_checked)


def test_replicated_world_of_two_matches_jax(tmp_path):
    jt = JT.build_baby_table(256, 6, window=16, tile=64)
    solve = dict(key=_job_key(6, 2, 7), pk=PK,
                 pke=PK + 3 * JOBS_SUPER * SPAN * STRIDE - 1)
    flood_pub = ecpy.mul(987654321)
    flood = dict(key=987654321, pk=1000,
                 pke=1000 + JOBS_SUPER * SPAN * STRIDE - 1, hit_cap=4,
                 max_epochs=1)
    flood_t = _flood(ecpy.sub(flood_pub, ecpy.mul(1000)), JOBS_SUPER)
    _save(tmp_path / "table.npz", jt)
    _save(tmp_path / "flood.npz", flood_t)
    rec_key = _job_key(2, 3, 5)  # rank 1's first job of super-epoch 0
    (tmp_path / "case.json").write_text(json.dumps(dict(
        cfg=PORT_CFG, records_key=rec_key, flood=flood, **solve)))
    got, _ = _world("replicated", tmp_path)

    mesh = JM.make_mesh(2)
    jcfg = JS.SolverConfig(chunk=8, **GEOM)
    jms = JSTR.MeshSolver(JS.Solver(jcfg, baby=jt), mesh)
    pub = ecpy.mul(rec_key)
    batch, gs = jms._collect(pub, PK, jms._dispatch(
        ecpy.sub(pub, ecpy.mul(PK)), 0))
    want = sorted([r[0].job_base, *r[1:]] for r in batch)
    assert got["records"] == want and got["gs"] == gs
    assert [2, 1, 0, 3] in want  # job_base 2, + branch, t 0, j 3
    want = jms.solve(ecpy.mul(solve["key"]), PK, solve["pke"])
    assert got["solve"] == _result(want) and want.key == solve["key"]

    jflood = JSTR.MeshSolver(JS.Solver(
        JS.SolverConfig(chunk=8, **dict(GEOM, hit_cap=4)), baby=flood_t),
        mesh)
    want = jflood.solve(flood_pub, 1000, flood["pke"], max_epochs=1)
    assert got["flood"] == _result(want) and want.key is None
    assert got["flood"]["hits_checked"] > 2 * 4
    assert got["redispatched"] and got["redispatched"][0][0] == 0


def test_sharded_world_of_two_matches_jax(tmp_path):
    solve = dict(key=_job_key(5, 4, 11), pk=PK,
                 pke=PK + 3 * JOBS_SUPER * SPAN * STRIDE - 1)
    (tmp_path / "case.json").write_text(json.dumps(dict(
        cfg=PORT_CFG, lookups=[1, 100, 256, 1000], **solve)))
    got, ranks = _world("sharded", tmp_path)
    # each rank holds its own half of the 2^6 rows
    assert ranks == [[0, 2, [32, 16]], [1, 2, [32, 16]]]
    assert got["lookups"] == [[1], [100], [256], []]

    mesh = JM.make_mesh(2)
    jcfg = JS.SolverConfig(chunk=8, **GEOM)
    jt = JS.build_table(jcfg, mesh=mesh)
    jms = JSTR.MeshSolver(JS.Solver(jcfg, baby=jt), mesh,
                          shard_baby_table=True)
    want = jms.solve(ecpy.mul(solve["key"]), PK, solve["pke"])
    assert got["solve"] == _result(want) and want.key == solve["key"]
