"""Worlds of two ranks of the port on the CPU, each rank a process of its
own joined by gloo, held against bsgs_tpu's MeshSolver at n = 2 on the
same configuration: a replicated table (one super-epoch's decoded hit
records, a planted key, and a forced overflow that both ranks re-run), a
table built split over the ranks (both probe routes find a planted key,
through the fused and the unfused epoch, and the all_to_all route gives
bsgs_tpu's records of a super-epoch; the owner's broadcast rows resolve
lookups on both ranks; Mesh.all_to_all and the all_to_all probe against
its in-process form and bsgs_tpu's, the overflow case included). The
sharded tests share one world, whose ranks also record the spans of a
MeshSolver's solve (utils/tracing). The command line's worlds are
tests/test_torch_distributed_cli.py. Every world gets a free port, an
explicit rendezvous timeout (parallel/mesh.TIMEOUT) and a join timeout."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from bsgs_tpu.models import solver as JS, table as JT
from bsgs_tpu.ops import field as JF
from bsgs_tpu.parallel import (mesh as JM, sharded_table as JST,
                               striped as JSTR)
from bsgs_tpu_torch.parallel import mesh as M
from bsgs_tpu_torch.utils import ecpy

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

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
HTSZ, BPS = 6, 32  # 2^6 buckets, 32 a rank


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


def _probe_keys(seed: int):
    """(bucket, disc) uint32 keys: 512 of baby points 1..256 (members) and
    random points, and 512 flood keys, each in rank 0's buckets with a
    random disc."""
    ks = list(range(1, 257)) + [int(x) for x in np.random.default_rng(
        seed).integers(300, 1 << 48, size=256)]
    hi, lo = JF.x_prefix64(jnp.asarray(JF.to_limbs_batch(
        [ecpy.mul(k)[0] for k in ks])))
    keys = [np.asarray(k) for k in JT.bucket_disc(hi, lo, HTSZ)]
    rng = np.random.default_rng(seed + 1)
    flood = [rng.integers(0, BPS, size=512).astype(np.uint32),
             rng.integers(1, 1 << 32, size=512, dtype=np.uint64).astype(
                 np.uint32)]
    return keys, flood


SHARDED_SOLVE = dict(key=_job_key(5, 4, 11), pk=PK,
                     pke=PK + 3 * JOBS_SUPER * SPAN * STRIDE - 1)
RECORDS_KEY = _job_key(2, 3, 5)  # rank 1's first job of super-epoch 0


@pytest.fixture(scope="module")
def sharded_world(tmp_path_factory):
    """One world of two over a table built split over its ranks: every
    sharded test reads what its ranks found."""
    where = tmp_path_factory.mktemp("sharded")
    keys, flood = _probe_keys(9)
    (where / "case.json").write_text(json.dumps(dict(
        cfg=PORT_CFG, lookups=[1, 100, 256, 1000], records_key=RECORDS_KEY,
        keys=[k.tolist() for k in keys],
        flood_keys=[k.tolist() for k in flood], **SHARDED_SOLVE)))
    got, ranks = _world("sharded", where)
    return got, ranks, keys, flood


@pytest.fixture(scope="module")
def jax_sharded():
    """bsgs_tpu's table built split over a mesh of 2, and its config."""
    mesh = JM.make_mesh(2)
    jcfg = JS.SolverConfig(chunk=8, **GEOM)
    return mesh, jcfg, JS.build_table(jcfg, mesh=mesh)


def test_mesh_solver_records_the_single_cards_spans(sharded_world):
    """Each rank of a MeshSolver records the single card's span tree, the
    hit gather inside the epoch, and one collect an epoch drained. The key
    is found in the solve's tail (after the last super-epoch's dispatch),
    which holds the last collect and the verification with its residue
    scans."""
    got, ranks, _, _ = sharded_world
    tree = [("centers", "epoch"), ("collect", "solve"), ("collect", "tail"),
            ("confirm", "verify"), ("epoch", "solve"), ("gather", "epoch"),
            ("landings", "verify"), ("launch", "epoch"), ("lookup", "verify"),
            ("residue", "lookup"), ("solve", ""), ("stage", "epoch"),
            ("tail", "solve"), ("verify", "tail"), ("wait", "collect")]
    for own in ranks:
        assert [tuple(x) for x in own["spans"]] == tree
        assert own["drained"] == got["solve"]["epochs"]


def test_sharded_world_of_two_matches_jax(sharded_world, jax_sharded):
    got, ranks, _, _ = sharded_world
    # each rank holds its own half of the 2^6 rows
    assert [r["shard"] for r in ranks] == [[0, 2, [32, 16]],
                                           [1, 2, [32, 16]]]
    assert got["lookups"] == [[1], [100], [256], []]

    mesh, jcfg, jt = jax_sharded
    jms = JSTR.MeshSolver(JS.Solver(jcfg, baby=jt), mesh,
                          shard_baby_table=True)
    want = jms.solve(ecpy.mul(SHARDED_SOLVE["key"]), PK,
                     SHARDED_SOLVE["pke"])
    assert got["solve"] == _result(want) and want.key == SHARDED_SOLVE["key"]
    # the unfused epoch's (hi, lo) probe through the same route
    assert got["solve_unfused"] == _result(want)


@pytest.fixture(scope="module")
def jax_all_to_all(jax_sharded):
    """bsgs_tpu's MeshSolver at n = 2 on its sharded table through the
    all_to_all route: super-epoch 0's decoded records and giant steps,
    and the planted solve."""
    mesh, jcfg, jt = jax_sharded
    jms = JSTR.MeshSolver(JS.Solver(jcfg, baby=jt), mesh,
                          shard_baby_table=True, probe_routing="all_to_all")
    pub = ecpy.mul(RECORDS_KEY)
    batch, gs = jms._collect(pub, PK, jms._dispatch(
        ecpy.sub(pub, ecpy.mul(PK)), 0))
    records = sorted([r[0].job_base, *r[1:]] for r in batch)
    solve = jms.solve(ecpy.mul(SHARDED_SOLVE["key"]), PK,
                      SHARDED_SOLVE["pke"])
    return records, gs, _result(solve)


@pytest.mark.parametrize("epoch", ["fused", "unfused"])
def test_sharded_all_to_all_world_of_two_matches_jax(
        epoch, sharded_world, jax_all_to_all):
    """MeshSolver(shard_baby_table=True, probe_routing="all_to_all") over
    the fused and the unfused epoch: bsgs_tpu's records and giant steps
    of super-epoch 0 (rank 1's landing among them) and its solve."""
    got = sharded_world[0][f"all_to_all_{epoch}"]
    records, gs, solve = jax_all_to_all
    assert got["records"] == records and got["gs"] == gs
    assert [2, 1, 0, 3] in records  # job_base 2, + branch, t 0, j 3
    assert got["solve"] == solve and solve["key"] == SHARDED_SOLVE["key"]


def _jax_route(probe_bd, b, d, dense):
    f = jax.jit(shard_map(
        probe_bd, mesh=JM.make_mesh(2),
        in_specs=(P("chips"), P("chips"), P("chips")),
        out_specs=P("chips"), check_vma=False))
    return np.asarray(f(jnp.asarray(b), jnp.asarray(d), dense))


def test_all_to_all_collective_of_two_ranks(sharded_world, jax_sharded):
    """Mesh.all_to_all gives each rank segment r of every rank's tensor in
    rank order; make_alltoall_probe_bd over gloo equals
    probe_all_to_all_in_process on the same keys, bsgs_tpu's
    make_alltoall_probe_bd and the whole table's probe; at slack 0 (cap
    128, every key aimed at rank 0) it equals bsgs_tpu's, the 128 keys of
    each rank that find their segment full coming back found."""
    _, ranks, (b, d), (fb, fd) = sharded_world
    for r, own in enumerate(ranks):
        assert own["all_to_all"] == [100 * s + 3 * r + i for s in (0, 1)
                                     for i in range(3)]
        assert own["all_to_all_rows"] == [
            [50 * s + 6 * r + 3 * i + j for j in range(3)]
            for s in (0, 1) for i in range(2)]
        assert own["probe"] == own["probe_in_process"]
    _, _, jt = jax_sharded
    spec = JST.spec_from_presharded(jt)
    dense = jnp.asarray(np.asarray(jt.dense))
    got = np.concatenate([own["probe"] for own in ranks])
    want = _jax_route(JST.make_alltoall_probe_bd(spec), b, d, dense)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(JT.probe_keys(jnp.asarray(b), jnp.asarray(d),
                                      dense)))
    assert got[:256].all() and not got[256:].any()
    got = np.concatenate([own["probe_slack0"] for own in ranks])
    want = _jax_route(JST.make_alltoall_probe_bd(spec, slack=0.0), fb, fd,
                      dense)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(2, 256).sum(axis=1),
                                  [128, 128])
