"""One rank of a world of the port's ranks on the CPU (gloo), for
tests/test_torch_distributed.py: the replicated case, and the sharded
case, which solves through both probe routes and the fused and the
unfused epoch, and checks Mesh.all_to_all and the all_to_all probe.

Usage: python torch_mesh_worker.py <address> <world> <rank> <case> <dir>

<dir> holds the inputs the test wrote (tables of the JAX package as .npz,
the case's parameters as case.json); the rank writes what it found to
<dir>/<case>.<rank>.json. Imports torch and the port only.
"""

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bsgs_tpu_torch import convert  # noqa: E402
from bsgs_tpu_torch.models import solver as S, table as T  # noqa: E402
from bsgs_tpu_torch.ops import probe_kernel as PK  # noqa: E402
from bsgs_tpu_torch.parallel import (  # noqa: E402
    mesh as M, sharded_table as ST, striped)
from bsgs_tpu_torch.utils import ecpy  # noqa: E402

torch.set_num_threads(1)


def load_table(path):
    z = np.load(path)
    return convert.baby_table(
        w=int(z["w"]), htsz=int(z["htsz"]), window=int(z["window"]),
        offsets=z["offsets"], disc_sorted=z["disc_sorted"],
        pos_sorted=z["pos_sorted"], dense=z["dense"],
        sorted_pre=z["sorted_pre"], device="cpu")


def records(ms, pub, pk):
    """The decoded hit records of super-epoch 0, and its giant steps."""
    q0 = ecpy.sub(pub, ecpy.mul(pk))
    batch, gs = ms._collect(pub, pk, ms._dispatch(q0, 0))
    return sorted([r[0].job_base, *r[1:]] for r in batch), gs


def solve(ms, p):
    res = ms.solve(ecpy.mul(p["key"]), p["pk"], p["pke"],
                   max_epochs=p.get("max_epochs"))
    return dict(key=res.key, giant_steps=res.giant_steps, epochs=res.epochs,
                hits_checked=res.hits_checked)


def route_checks(mesh, baby, p):
    """This rank's share of the all_to_all checks: Mesh.all_to_all of
    rank-stamped tensors (1-D int32, 2-D uint8); its share of the probe
    keys through make_alltoall_probe_bd and through
    probe_all_to_all_in_process (every shard's rows built here); and the
    flood keys through make_alltoall_probe_bd at slack 0."""
    n, r = mesh.world, mesh.rank
    flat = torch.arange(3 * n, dtype=torch.int32) + 100 * r
    rows = (torch.arange(6 * n, dtype=torch.uint8) + 50 * r).view(2 * n, 3)
    spec = ST.spec_from_presharded(baby)
    specs = []
    for s in range(n):
        dense, _, counts = T.build_shard_rows(baby.w, baby.htsz, n, s,
                                              window=baby.window,
                                              device="cpu")
        specs.append(ST.ShardedTableSpec(
            baby.htsz, baby.window, n, s, dense,
            PK.row_lengths(counts, baby.window), spec.shard_entries))

    def share(name):
        keys = [convert.from_u32(np.array(k, dtype=np.uint32), "cpu")
                for k in p[name]]
        return [list(k.chunk(n)) for k in keys]

    (bs, ds), (fb, fd) = share("keys"), share("flood_keys")
    return dict(
        all_to_all=mesh.all_to_all(flat).tolist(),
        all_to_all_rows=mesh.all_to_all(rows).tolist(),
        probe=ST.make_alltoall_probe_bd(spec, mesh)(bs[r], ds[r]).tolist(),
        probe_in_process=ST.probe_all_to_all_in_process(
            bs, ds, specs)[r].tolist(),
        probe_slack0=ST.make_alltoall_probe_bd(spec, mesh, slack=0.0)(
            fb[r], fd[r]).tolist())


def main():
    address, world, rank, case, where = sys.argv[1:]
    M.init_distributed(address, int(world), int(rank), backend="gloo")
    try:
        mesh = M.make_mesh(int(world), device="cpu")
        with open(os.path.join(where, "case.json")) as f:
            p = json.load(f)
        cfg = S.SolverConfig(**p["cfg"])
        out = {}
        if case == "replicated":
            s = S.Solver(cfg, baby=load_table(os.path.join(where,
                                                           "table.npz")),
                         device="cpu")
            ms = striped.MeshSolver(s, mesh)
            out["records"], out["gs"] = records(
                ms, ecpy.mul(p["records_key"]), p["pk"])
            out["solve"] = solve(ms, p)
            flood = S.Solver(
                dataclasses.replace(cfg, hit_cap=p["flood"]["hit_cap"]),
                baby=load_table(os.path.join(where, "flood.npz")),
                device="cpu")
            ms = striped.MeshSolver(flood, mesh)
            redispatched = []
            orig = ms._redispatch

            def counting(q0, epoch, cap):
                redispatched.append((epoch, cap))
                return orig(q0, epoch, cap)

            ms._redispatch = counting
            out["flood"] = solve(ms, p["flood"])
            out["redispatched"] = redispatched
        else:
            baby = ST.build_sharded_table(cfg, mesh)
            own = dict(shard=[baby.shard, baby.n_table_shards,
                              list(baby.dense.shape)])
            out["lookups"] = [baby.lookup_positions(ecpy.mul(r)[0])
                              for r in p["lookups"]]
            bases = dict(
                fused=S.Solver(cfg, baby=baby, device="cpu"),
                unfused=S.Solver(dataclasses.replace(cfg, fused=False),
                                 baby=baby, device="cpu"))
            out["solve"] = solve(striped.MeshSolver(
                bases["fused"], mesh, shard_baby_table=True), p)
            out["solve_unfused"] = solve(striped.MeshSolver(
                bases["unfused"], mesh, shard_baby_table=True), p)
            for name, base in bases.items():
                ms = striped.MeshSolver(base, mesh, shard_baby_table=True,
                                        probe_routing="all_to_all")
                recs, gs = records(ms, ecpy.mul(p["records_key"]), p["pk"])
                out[f"all_to_all_{name}"] = dict(records=recs, gs=gs,
                                                 solve=solve(ms, p))
            own.update(route_checks(mesh, baby, p))
            out["rank"] = own
        with open(os.path.join(where, f"{case}.{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        M.close()


if __name__ == "__main__":
    main()
