"""A world of four of the port's ranks on the CPU, each a process of its
own joined by gloo (tests/torch_striped_worker.py), driving MeshSolver
over a table every rank holds whole, as the four-card deployment does
(one process a card, the range striped in super-epochs of 4 x T jobs):
held against the plain reference of the benchmark
(benchmarks/reference): every returned key is the generated one and
k*G == Q there; in each super-epoch rank r queued jobs e*4T + r*T ...
+ T - 1, whose centers the reference computes again, and the four ranks
cover the super-epoch once; the recorder's ``gather`` counts the bytes
gathered onto the rank and the ranks, and ``collect`` the ranks whose
hit count was above 0."""

import json
import os
import signal
import subprocess
import sys

import pytest

from benchmarks.reference import bsgs as ref, secp256k1 as refec
from bsgs_tpu_torch.parallel import mesh as M

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_striped_worker.py")
JOIN_S = 300
WORLD = 4
SEED = 2**35 + 77


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's record of the same seeded solves."""
    where = tmp_path_factory.mktemp("striped_four")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    address = M.free_address()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, address, str(r), str(SEED), str(where)],
        cwd=where, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"no exit in {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return [json.loads((where / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def test_every_key_found_and_checked_by_the_reference(world):
    solves = world[0]["solves"]
    assert len(solves) == 3
    for s in solves:
        pub = (int(s["pub"][0], 16), int(s["pub"][1], 16))
        assert s["found"] == s["key"]
        assert refec.mul(s["found"]) == pub
    # every rank returned the same keys
    for rank in world[1:]:
        assert [s["found"] for s in rank["solves"]] == \
            [s["found"] for s in solves]


@pytest.mark.parametrize("epoch", [0, 1])
def test_each_rank_takes_its_stripe_of_a_super_epoch(world, epoch):
    """Solve 0's key lies in super-epoch 2, so it queues 0 and 1 whole."""
    T = world[0]["jobs_per_epoch"]
    geo = ref.Geometry(256, 6, 8, T, 1)
    judge = ref.Judge(geo)
    s = world[0]["solves"][0]
    q0 = judge.q0((int(s["pub"][0], 16), int(s["pub"][1], 16)), 1 << 21)
    covered = []
    for r, rank in enumerate(world):
        mine = [j for j in rank["jobs"]
                if j["solve"] == 0 and j["epoch"] == epoch]
        assert len(mine) == 1, mine  # no overflow re-run here
        j = mine[0]
        assert j["first_job"] == epoch * WORLD * T + r * T
        assert j["n_jobs"] == T
        for t, x in enumerate(j["xs"]):
            job = j["first_job"] + t
            want = judge.giant(q0, judge.center_index(job))
            assert int(x, 16) == want[0]
            covered.append(job)
    assert sorted(covered) == list(range(epoch * WORLD * T,
                                         (epoch + 1) * WORLD * T))


def test_gather_and_collect_count_what_they_define(world):
    cap = world[0]["hit_cap"]
    for rank in world:
        local = {}  # (solve, epoch): each rank's count in its gather
        for r, other in enumerate(world):
            for g in other["local"]:
                local.setdefault((g["solve"], g["epoch"]), {})[r] = \
                    g["count"]
        gathers = [s for s in rank["spans"] if s["name"] == "gather"]
        collects = [s for s in rank["spans"] if s["name"] == "collect"]
        assert gathers and collects
        for g in gathers:
            assert g["counts"]["bytes"] == WORLD * (1 + cap) * 4
            assert g["counts"]["ranks"] == WORLD
        seen = []
        for c in collects:
            counts = local[(c["solve"], c["epoch"])]
            assert len(counts) == WORLD
            want = sum(n > 0 for n in counts.values())
            assert c["counts"]["ranks_with_hits"] == want
            seen.append(want)
        # the seeded solves hit on some ranks and not on others
        assert max(seen) > 0 and min(seen) < WORLD
