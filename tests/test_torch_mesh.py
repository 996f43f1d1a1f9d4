"""The port's multi-card layer held against bsgs_tpu/parallel in one
process, on the CPU: the per-shard streamed build (n = 2, 4) against the
JAX sharded build on a mesh of as many CPU devices; both probe routes of n
simulated ranks (their collectives made by hand) against the JAX routes
under shard_map at 2, 4 and 8 devices, the overflow case included;
check_table_fits(n_shards=) against the JAX solver's; and, in a group of
one rank (gloo), the sharded build with its broadcast lookups and
MeshSolver's checks. The spawned worlds of two ranks are tests/test_torch_distributed.py.
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
from bsgs_tpu.parallel import mesh as JM, sharded_table as JST
from bsgs_tpu.utils import tuner as JTU
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import solver as S, table as T
from bsgs_tpu_torch.parallel import mesh as M, sharded_table as ST, striped
from bsgs_tpu_torch.utils import ecpy

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
                         convert.from_u32(d, "cpu"), port_table.dense)
    np.testing.assert_array_equal(got, whole.numpy())


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
    for name in ("dense", "pos_lo", "offsets"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
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
