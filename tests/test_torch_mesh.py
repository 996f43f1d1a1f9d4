"""The port's multi-card layer held against bsgs_tpu/parallel in one
process, on the CPU: the per-shard streamed build (n = 2, 4) against the
JAX sharded build on a mesh of as many CPU devices; both probe routes of n
simulated ranks (their collectives made by hand) against the JAX routes
under shard_map at 2, 4 and 8 devices, the overflow case included;
check_table_fits(n_shards=) against the JAX solver's; and, in a group of
one rank (gloo), the sharded build with its broadcast lookups,
MeshSolver's checks, and the all_to_all route as collectives (two a
stream) under MeshSolver(probe_routing=). The spawned worlds of two ranks
are tests/test_torch_distributed.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bsgs_tpu.models import solver as JS, table as JT
from bsgs_tpu.ops import field as JF
from bsgs_tpu.parallel import (mesh as JM, sharded_table as JST,
                               striped as JSTR)
from bsgs_tpu.utils import tuner as JTU
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import solver as S, table as T
from bsgs_tpu_torch.parallel import mesh as M, sharded_table as ST, striped
from bsgs_tpu_torch.utils import ecpy
from test_torch_probe_kernel import assert_row_lengths

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(2)

W, HTSZ, WINDOW = 256, 6, 16


@pytest.fixture(scope="module")
def jax_table():
    return JT.build_baby_table(W, HTSZ, window=WINDOW, tile=64)


@pytest.fixture(scope="module")
def port_table(jax_table):
    jt = jax_table
    return convert.baby_table(
        w=jt.w, htsz=jt.htsz, window=jt.window, offsets=jt.offsets,
        disc_sorted=jt.disc_sorted, pos_sorted=jt.pos_sorted,
        dense=np.asarray(jt.dense), sorted_pre=jt.sorted_pre, device="cpu")


# ---------------------------------------------------------------------------
# The sharded build


@pytest.mark.parametrize("n", [2, 4])
def test_shard_build_matches_jax_sharded_build(n):
    """Every shard's dense rows, hint rows and counts equal the rows of
    bsgs_tpu's build_baby_table_streamed_sharded on a mesh of n, bit for
    bit (ranks within a bucket included), and the gathered counts its
    offsets."""
    jt = JT.build_baby_table_streamed_sharded(W, HTSZ, JM.make_mesh(n),
                                              window=WINDOW, tile=32,
                                              chunk=64)
    dense, hint = np.asarray(jt.dense), np.asarray(jt.pos_lo)
    bps = (1 << HTSZ) // n
    counts = []
    for s in range(n):
        d, h, c = T.build_shard_rows(W, HTSZ, n, s, window=WINDOW, tile=256,
                                     chunk=64, device="cpu")
        rows = slice(s * bps, (s + 1) * bps)
        np.testing.assert_array_equal(convert.u32(d), dense[rows])
        np.testing.assert_array_equal(h.numpy().view(np.uint16), hint[rows])
        counts.append(c)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(torch.cat(counts), 0)])
    np.testing.assert_array_equal(offsets.numpy(),
                                  np.asarray(jt.offsets).astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_each_shard_carries_its_row_lengths(n, port_table):
    """Each shard of the sharded build (its BabyTable over global offsets,
    and spec_from_presharded of it) holds its own rows' lengths, the diff
    of the offsets there, FILL past them; shard_table of a whole table
    slices its lengths with its rows."""
    whole = T.build_baby_table_streamed(W, HTSZ, window=WINDOW, tile=256,
                                        chunk=64, positions="rescan",
                                        device="cpu")
    bps = (1 << HTSZ) // n
    for s in range(n):
        d, h, c = T.build_shard_rows(W, HTSZ, n, s, window=WINDOW, tile=256,
                                     chunk=64, device="cpu")
        part = T.BabyTable(w=W, htsz=HTSZ, window=WINDOW,
                           offsets=whole.offsets, disc_sorted=None,
                           pos_sorted=None, dense=d, pos_lo=h,
                           n_table_shards=n, shard=s)
        assert_row_lengths(part.dense, part.row_len, whole.offsets,
                           s * bps)
        assert torch.equal(part.row_len.long(), c)
        spec = ST.spec_from_presharded(part)
        assert spec.row_len is part.row_len
        own = ST.shard_table(port_table, n, s)
        assert_row_lengths(own.dense, own.row_len, port_table.offsets,
                           s * bps)


def test_shard_build_equals_the_single_card_rescan_rows():
    t = T.build_baby_table_streamed(W, HTSZ, window=WINDOW, tile=256,
                                    chunk=64, positions="rescan",
                                    device="cpu")
    d, h, c = T.build_shard_rows(W, HTSZ, 4, 3, window=WINDOW, tile=256,
                                 chunk=100, device="cpu")
    assert torch.equal(d, t.dense[48:]) and torch.equal(h, t.pos_lo[48:])
    assert torch.equal(c, torch.diff(t.offsets.long())[48:])
    with pytest.raises(ValueError, match="evenly"):
        T.build_shard_rows(W, HTSZ, 3, 0, device="cpu")


def test_sharded_build_refuses_mirror_positions_which_jax_ignores():
    """A deliberate difference: bsgs_tpu's sharded build takes
    positions="mirror" and builds rescan all the same (ADVICE.md item 1);
    the port's refuses it before building anything, as it refuses
    w >= 2^32."""
    cfg = S.SolverConfig(w=W, htsz=HTSZ, window=WINDOW, positions="mirror")
    with pytest.raises(ValueError, match="rescan positions only"):
        ST.build_sharded_table(cfg, mesh=object())
    with pytest.raises(ValueError, match="uint32"):
        ST.build_sharded_table(S.SolverConfig(w=1 << 32), mesh=object())
    jt = JT.build_baby_table_streamed_sharded(W, HTSZ, JM.make_mesh(2),
                                              window=WINDOW, tile=32,
                                              chunk=64, positions="mirror")
    assert jt.pos_dense is None and jt.lookup_fn is not None


# ---------------------------------------------------------------------------
# The probe routes


def _keys(seed: int, m: int = 256):
    """(bucket, disc) uint32 keys of m probes: baby points 1..m/2 (members)
    and m/2 random points (non-members)."""
    ks = list(range(1, m // 2 + 1)) + [
        int(x) for x in np.random.default_rng(seed).integers(
            300, 1 << 48, size=m // 2)]
    xl = jnp.asarray(JF.to_limbs_batch([ecpy.mul(k)[0] for k in ks]))
    hi, lo = JF.x_prefix64(xl)
    b, d = JT.bucket_disc(hi, lo, HTSZ)
    return np.asarray(b), np.asarray(d)


def _jax_route(probe_bd, n, b, d, dense):
    f = jax.jit(shard_map(
        probe_bd, mesh=JM.make_mesh(n),
        in_specs=(P("chips"), P("chips"), P("chips")),
        out_specs=P("chips"), check_vma=False))
    return np.asarray(f(jnp.asarray(b), jnp.asarray(d), dense))


def _port_route(route, n, b, d, port_table, **kw):
    specs = [ST.shard_table(port_table, n, s) for s in range(n)]
    bs = list(convert.from_u32(b, "cpu").chunk(n))
    ds = list(convert.from_u32(d, "cpu").chunk(n))
    fn = (ST.probe_all_gather_in_process if route == "all_gather"
          else ST.probe_all_to_all_in_process)
    return torch.cat(fn(bs, ds, specs, **kw)).numpy()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("route", ["all_gather", "all_to_all"])
def test_probe_routes_match_jax(route, n, jax_table, port_table):
    b, d = _keys(7 + n)
    jspec = JST.shard_table(jax_table, n)
    jfn = (JST.make_sharded_probe_bd(jspec) if route == "all_gather"
           else JST.make_alltoall_probe_bd(jspec))
    want = _jax_route(jfn, n, b, d, jnp.asarray(jspec.dense))
    got = _port_route(route, n, b, d, port_table)
    np.testing.assert_array_equal(got, want)
    assert got[:128].all() and not got[128:].any()
    whole = T.probe_keys(convert.from_u32(b, "cpu"),
                         convert.from_u32(d, "cpu"), port_table.rows)
    np.testing.assert_array_equal(got, whole.numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_alltoall_prefix_probe_matches_jax(n, jax_table, port_table):
    """make_alltoall_probe_in_process, the (hi, lo) form of the all_to_all
    route (the unfused epoch's stream), n ranks in one process, against
    bsgs_tpu's make_alltoall_probe under shard_map."""
    ks = list(range(1, 129)) + [int(x) for x in np.random.default_rng(
        n).integers(300, 1 << 48, size=128)]
    hi, lo = JF.x_prefix64(jnp.asarray(JF.to_limbs_batch(
        [ecpy.mul(k)[0] for k in ks])))
    jspec = JST.shard_table(jax_table, n)
    want = _jax_route(JST.make_alltoall_probe(jspec), n, np.asarray(hi),
                      np.asarray(lo), jnp.asarray(jspec.dense))
    probe = ST.make_alltoall_probe_in_process(
        [ST.shard_table(port_table, n, s) for s in range(n)])
    got = torch.cat(probe(list(convert.from_u32(hi, "cpu").chunk(n)),
                          list(convert.from_u32(lo, "cpu").chunk(n))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:128].all() and not got[128:].any()


def test_all_to_all_overflow_comes_back_found(jax_table, port_table):
    """Every probe aimed at shard 0's rows: each rank's 256 probes find one
    destination of cap 128 (slack 0), so 128 are answered exactly (all
    missing: random discs) and 128 come back found, as in bsgs_tpu."""
    n = 8
    rng = np.random.default_rng(3)
    bps = (1 << HTSZ) // n
    b = rng.integers(0, bps, size=2048).astype(np.uint32)
    d = rng.integers(1, 1 << 32, size=2048, dtype=np.uint64).astype(
        np.uint32)
    want = _jax_route(JST.make_alltoall_probe_bd(
        JST.shard_table(jax_table, n), slack=0.0), n, b, d,
        jnp.asarray(JST.shard_table(jax_table, n).dense))
    got = _port_route("all_to_all", n, b, d, port_table, slack=0.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(n, 256).sum(axis=1),
                                  np.full(n, 128))
    assert ST.alltoall_cap(256, n, 0.0) == 128
    assert ST.alltoall_cap(1 << 20, 4, 2.0) == 1 << 19


def test_shard_specs_match_jax(jax_table, port_table):
    for n in (1, 2, 8):
        jspec = JST.shard_table(jax_table, n)
        for s in range(n):
            spec = ST.shard_table(port_table, n, s)
            np.testing.assert_array_equal(spec.shard_entries,
                                          jspec.shard_entries)
            bps = jspec.buckets_per_shard
            np.testing.assert_array_equal(
                convert.u32(spec.dense), jspec.dense[s * bps:(s + 1) * bps])
    with pytest.raises(ValueError, match="evenly"):
        ST.shard_table(port_table, 3, 0)
    with pytest.raises(ValueError, match="not built sharded"):
        ST.spec_from_presharded(port_table)


# ---------------------------------------------------------------------------
# The solver's multi-card parameters

GEOM = dict(w=W, htsz=HTSZ, n_offsets=8, jobs_per_epoch=2, window=WINDOW,
            table_tile=64, pipeline=1)


@pytest.fixture(scope="module")
def solvers(jax_table, port_table):
    port = S.Solver(S.SolverConfig(chunk_c=2, lanes_w=4, epoch_phases=2,
                                   **GEOM), baby=port_table, device="cpu")
    jax_s = JS.Solver(JS.SolverConfig(chunk=8, **GEOM), baby=jax_table)
    return port, jax_s


@pytest.mark.parametrize("table_gib, mem_gib, n", [
    (10, 16, 1), (14, 16, 1), (40, 16, 4), (52, 16, 4), (120, 16, 4),
    (20, 32, 1), (150, 80, 2), (160, 80, 2)])
def test_check_table_fits_matches_jax(table_gib, mem_gib, n):
    """Refused exactly where the JAX guard refuses, with its hints. The
    reserve is the port's one MEMORY_RESERVE, which its tuner sizes
    against too; the JAX guard's 3 GiB differs from its tuner's 2.5 GiB
    (ADVICE.md item 2)."""
    assert S.MEMORY_RESERVE == 3 << 30 != JTU._RESERVE_BYTES
    args = (table_gib << 30, mem_gib << 30)
    try:
        JS.check_table_fits(*args, n_shards=n)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None:
        S.check_table_fits(*args, n_shards=n)
        return
    hint = "shard-table" if n == 1 else "more cards"
    with pytest.raises(ValueError, match=hint):
        S.check_table_fits(*args, n_shards=n)
    assert ("shard-table" if n == 1 else "more chips") in refused


# ---------------------------------------------------------------------------
# A group of one rank


@pytest.fixture(scope="module")
def one_rank():
    created = M.init_distributed(M.free_address(), 1, 0, backend="gloo")
    assert created and not M.init_distributed(M.free_address(), 1, 0)
    yield M.make_mesh(device="cpu")
    M.close()


def test_mesh_of_one_refuses_what_it_cannot_be(one_rank):
    assert (one_rank.world, one_rank.rank, one_rank.backend) == (
        1, 0, "gloo")
    with pytest.raises(ValueError, match="2 cards asked for"):
        M.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="card ids"):
        M.make_mesh(device_ids=[0, 1], device="cpu")
    with pytest.raises(ValueError, match="repeat a card"):
        M.make_mesh(device_ids=[0, 0], device="cpu")
    with pytest.raises(ValueError, match="gloo process group"):
        M.make_mesh()  # cuda ranks need nccl
    t = torch.arange(4, dtype=torch.int32)
    assert torch.equal(one_rank.all_gather(t), t)
    assert torch.equal(one_rank.broadcast(t.clone(), 0), t)


def test_sharded_build_of_one_rank_is_the_single_card_rescan_table(
        one_rank):
    """build_sharded_table over a group of one holds every row, equal to
    the single-card streamed rescan table with its offsets, and its
    lookups, through the owner's broadcast rows, find the positions."""
    cfg = S.SolverConfig(w=W, htsz=HTSZ, window=WINDOW)
    got = ST.build_sharded_table(cfg, one_rank)
    want = T.build_baby_table_streamed(W, HTSZ, window=WINDOW,
                                       positions="rescan", device="cpu")
    assert (got.shard, got.n_table_shards) == (0, 1)
    for name in ("dense", "pos_lo", "offsets", "row_len"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert_row_lengths(got.dense, got.row_len, got.offsets)
    assert [got.lookup_positions(ecpy.mul(r)[0]) for r in (1, 77, W)] == [
        [1], [77], [W]]
    assert got.lookup_positions(ecpy.mul(W + 1)[0]) == []


def test_mesh_solver_of_one_rank_is_the_single_card_solve(one_rank, solvers):
    """One super-epoch's records, with the table replicated and split into
    one shard, equal the plain Solver's epoch, decoded; the checks on the
    table."""
    port, _ = solvers
    pk = 1 << 21
    q0 = ecpy.sub(ecpy.mul(pk + 5 * port.cfg.stride), ecpy.mul(pk))
    pub = ecpy.mul(pk + 5 * port.cfg.stride)
    want, _ = port._collect(pub, pk, port._dispatch(q0, 0))
    assert want  # the exact landing of the key, at least
    for kw in ({}, dict(shard_baby_table=True)):
        ms = striped.MeshSolver(port, one_rank, **kw)
        got, gs = ms._collect(pub, pk, ms._dispatch(q0, 0))
        assert got == want and gs == 17 * 2
    sharded = dataclasses.replace(port.baby, n_table_shards=2, shard=0)
    base = S.Solver(port.cfg, baby=sharded, device="cpu")
    with pytest.raises(ValueError, match="sharded over 2"):
        striped.MeshSolver(base, one_rank, shard_baby_table=True)
    with pytest.raises(ValueError, match="shard_baby_table"):
        striped.MeshSolver(base, one_rank)


def test_mesh_solver_takes_its_base_state_whole(one_rank, solvers):
    """A MeshSolver holds its base solver's table and offset planes as the
    same tensors (no second fill, no copy) and the base's probe over a
    table held whole, but EpochCenters of its own, so that no center is
    carried from one to the other; its own state leaves the base as it
    was."""
    port, _ = solvers
    probe = port._probe
    for kw in ({}, dict(shard_baby_table=True)):
        ms = striped.MeshSolver(port, one_rank, **kw)
        assert ms.cfg is port.cfg and ms.baby is port.baby
        for name in ("ox_pk", "oy_pk", "ox_pl", "oy_pl"):
            assert getattr(ms, name) is getattr(port, name), name
        assert (ms._probe is probe) == (not kw)
        assert isinstance(ms._centers, S.EpochCenters)
        assert ms._centers is not port._centers
        assert port._probe is probe and not hasattr(port, "mesh")


def test_unfused_mesh_solver_of_one_rank(one_rank, port_table):
    """MeshSolver over an unfused base solver, its table replicated and
    split into one shard (make_sharded_probe, the (hi, lo) all_gather
    route): one super-epoch's records equal the unfused Solver's, the
    sharded prefix probe equals the whole table's, and a planted key of
    super-epoch 1 is found either way."""
    cfg = S.SolverConfig(fused=False, **GEOM)
    port = S.Solver(cfg, baby=port_table, device="cpu")
    assert not port.fused
    pk = 1 << 21
    pub = ecpy.mul(pk + 5 * cfg.stride)
    q0 = ecpy.sub(pub, ecpy.mul(pk))
    want, _ = port._collect(pub, pk, port._dispatch(q0, 0))
    assert want
    hi, lo = JF.x_prefix64(jnp.asarray(JF.to_limbs_batch(
        [ecpy.mul(k)[0] for k in (1, 2, 300, 256)])))
    hi, lo = convert.from_u32(hi, "cpu"), convert.from_u32(lo, "cpu")
    probe = ST.make_sharded_probe(ST.shard_table(port_table, 1), one_rank)
    assert probe(hi, lo).tolist() == [True, True, False, True]
    assert torch.equal(probe(hi, lo), T.probe(hi, lo, port_table.rows,
                                              htsz=HTSZ))
    k = pk + cfg.keys_per_epoch + 777
    for kw in ({}, dict(shard_baby_table=True)):
        ms = striped.MeshSolver(port, one_rank, **kw)
        assert not ms.fused and ms._phases == 1
        got, gs = ms._collect(pub, pk, ms._dispatch(q0, 0))
        assert got == want and gs == 17 * 2
        res = ms.solve(ecpy.mul(k), pk, pk + 3 * cfg.keys_per_epoch)
        assert res.key == k and res.epochs == 2


def _count_collectives(mesh, monkeypatch) -> list:
    """Record the name of every collective the mesh makes from here on."""
    calls = []
    for kind in ("all_gather", "all_to_all", "all_reduce_max", "broadcast"):
        def counted(*args, _fn=getattr(mesh, kind), _kind=kind):
            calls.append(_kind)
            return _fn(*args)
        monkeypatch.setattr(mesh, kind, counted)
    return calls


def test_alltoall_probe_of_one_rank_is_two_collectives(one_rank, port_table,
                                                       monkeypatch):
    """make_alltoall_probe_bd and its (hi, lo) form over a group of one:
    the whole table's probe, through two all_to_all calls a stream and
    nothing else; a shard of another split is refused."""
    spec = ST.shard_table(port_table, 1, 0)
    b, d = (convert.from_u32(k, "cpu") for k in _keys(5))
    calls = _count_collectives(one_rank, monkeypatch)
    got = ST.make_alltoall_probe_bd(spec, one_rank)(b, d)
    assert calls == ["all_to_all"] * 2
    assert torch.equal(got, T.probe_keys(b, d, port_table.rows))
    assert got[:128].all() and not got[128:].any()
    hi, lo = JF.x_prefix64(jnp.asarray(JF.to_limbs_batch(
        [ecpy.mul(k)[0] for k in (1, 2, 300, 256)])))
    hi, lo = convert.from_u32(hi, "cpu"), convert.from_u32(lo, "cpu")
    got = ST.make_alltoall_probe(spec, one_rank)(hi, lo)
    assert got.tolist() == [True, True, False, True]
    assert calls == ["all_to_all"] * 4
    with pytest.raises(ValueError, match="shard 0 of 2 on rank 0 of 1"):
        ST.make_alltoall_probe_bd(ST.shard_table(port_table, 2, 0), one_rank)


@pytest.mark.parametrize("epoch", ["fused", "unfused"])
def test_alltoall_mesh_solver_of_one_rank_is_the_single_card_solve(
        epoch, one_rank, solvers, port_table, monkeypatch):
    """MeshSolver(probe_routing="all_to_all") of one rank, the table split
    into one shard: the single-card Solver's records of an epoch and its
    solve, through two all_to_all calls a probe stream (five streams a
    fused epoch of two phases, one unfused) and one all_gather of the
    hits; over a table held whole the route has no effect."""
    port = solvers[0] if epoch == "fused" else S.Solver(
        S.SolverConfig(fused=False, **GEOM), baby=port_table, device="cpu")
    cfg, pk = port.cfg, 1 << 21
    pub = ecpy.mul(pk + 5 * cfg.stride)
    q0 = ecpy.sub(pub, ecpy.mul(pk))
    want, _ = port._collect(pub, pk, port._dispatch(q0, 0))
    assert want
    k = pk + cfg.keys_per_epoch + 777
    want_solve = port.solve(ecpy.mul(k), pk, pk + 3 * cfg.keys_per_epoch)
    assert want_solve.key == k
    streams = 2 * port._phases + 1 if port.fused else 1
    calls = _count_collectives(one_rank, monkeypatch)
    for shard, all_to_all in ((True, 2 * streams), (False, 0)):
        ms = striped.MeshSolver(port, one_rank, shard_baby_table=shard,
                                probe_routing="all_to_all")
        assert ms.probe_routing == "all_to_all" and ms.fused == port.fused
        calls.clear()
        got, gs = ms._collect(pub, pk, ms._dispatch(q0, 0))
        assert got == want and gs == 17 * 2
        assert sorted(calls) == ["all_gather"] + ["all_to_all"] * all_to_all
        res = ms.solve(ecpy.mul(k), pk, pk + 3 * cfg.keys_per_epoch)
        assert dataclasses.replace(res, elapsed_s=0) == dataclasses.replace(
            want_solve, elapsed_s=0)


def test_unknown_probe_route_raises_where_jax_takes_all_gather(one_rank,
                                                                solvers):
    """A deliberate difference: bsgs_tpu's MeshSolver takes any
    probe_routing other than "all_to_all" for all_gather
    (bsgs_tpu/parallel/striped.py:66-69, 136-139); the port's raises."""
    port, jax_s = solvers
    for name in ("all-to-all", "alltoall", ""):
        with pytest.raises(ValueError, match="probe_routing"):
            striped.MeshSolver(port, one_rank, shard_baby_table=True,
                               probe_routing=name)
    jms = JSTR.MeshSolver(jax_s, JM.make_mesh(2), shard_baby_table=True,
                          probe_routing="all-to-all")
    assert jms.probe_routing == "all-to-all"
    assert set(striped.ROUTES) == {"all_gather", "all_to_all"}
