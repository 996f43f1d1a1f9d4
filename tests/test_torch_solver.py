"""The port's solver end to end on the CPU, on a bsgs_tpu table carried
across by convert.py: planted keys through every hit code, exhaustion
counts equal to the JAX solver's, overflow redispatch; the streamed solve
on a carried-across rescan table with planted false positives (pooled,
deferred verification; key, giant_steps, epochs and hits_checked equal to
the JAX solver's); and the guards that keep the port free of JAX and off
the CPU unless asked."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsgs_tpu.models import solver as JS, table as JT
from bsgs_tpu_torch import convert
from bsgs_tpu_torch.models import solver as S
from bsgs_tpu_torch.utils import ecpy

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "bsgs_tpu_torch"

# tests/test_solver.py's geometry; chains of 2 x 4 split the 8 offsets
GEOM = dict(w=256, htsz=6, n_offsets=8, jobs_per_epoch=4, window=16,
            table_tile=64)


def _carry(jt, device="cpu"):
    return convert.baby_table(
        w=jt.w, htsz=jt.htsz, window=jt.window, offsets=jt.offsets,
        disc_sorted=jt.disc_sorted, pos_sorted=jt.pos_sorted,
        dense=np.asarray(jt.dense), sorted_pre=jt.sorted_pre, device=device)


@pytest.fixture(scope="module")
def jax_table():
    return JT.build_baby_table(256, 6, window=16, tile=64)


@pytest.fixture(scope="module")
def solver(jax_table):
    cfg = S.SolverConfig(chunk_c=2, lanes_w=4, epoch_phases=2, **GEOM)
    s = S.Solver(cfg, baby=_carry(jax_table), device="cpu")
    codes = []
    collect = s._collect

    def recording(pub, pk, rec):
        batch, gs = collect(pub, pk, rec)
        codes.extend(r[1] for r in batch)
        return batch, gs

    s._collect = recording
    s.codes = codes
    return s


def _solve(s, k, pk, pke):
    s.codes.clear()
    res = s.solve(ecpy.mul(k), pk, pke)
    assert res.key == k, f"expected {k}, got {res.key}"
    return set(s.codes)


def test_offsets_match_host(solver):
    for j in (0, 3, 7):
        pt = ecpy.mul((j + 1) * solver.cfg.stride)
        got = convert.u32(solver.ox_pl)[:, j]
        assert sum(int(v) << (16 * i) for i, v in enumerate(got)) == pt[0]


def test_offset_spot_verify_catches_corruption(solver):
    ox = solver.ox_pl.clone()
    try:
        solver.ox_pl[:, :] = 12345
        with pytest.raises(ValueError, match="corrupt"):
            solver._verify_offsets(checks=16)
    finally:
        solver.ox_pl = ox


def test_solve_both_branches_codes_1_and_2(solver):
    cfg = solver.cfg
    pk = 777_777
    center0 = cfg.n_offsets * cfg.stride
    assert 1 in _solve(solver, pk + center0 - 3 * cfg.stride - 5, pk,
                       pk + (1 << 14))
    assert 2 in _solve(solver, pk + center0 + 3 * cfg.stride + 5, pk,
                       pk + (1 << 14))


def test_solve_exact_giant_landing_code_4(solver):
    pk = 999_999
    assert 4 in _solve(solver, pk + 7 * solver.cfg.stride, pk,
                       pk + (1 << 14))


def test_solve_center_landing_code_5(solver):
    cfg = solver.cfg
    pk = 123_456
    assert 5 in _solve(solver, pk + cfg.n_offsets * cfg.stride, pk,
                       pk + (1 << 14))
    c3 = (3 * cfg.jobs_span + cfg.n_offsets) * cfg.stride
    assert 5 in _solve(solver, pk + c3, pk,
                       pk + 4 * cfg.jobs_span * cfg.stride)


def test_solve_range_edges_and_minus_r(solver):
    pk, pke = 5_000_000, 5_000_000 + (1 << 15)
    for k in (pk, pk + 1, pke):
        _solve(solver, k, pk, pke)
    _solve(solver, 31_337 + 5 * solver.cfg.stride - 13, 31_337,
           31_337 + (1 << 14))


def test_solve_in_a_later_epoch(solver):
    pk = 1 << 20
    k = pk + 2 * solver.cfg.keys_per_epoch + 4321
    _solve(solver, k, pk, pk + 4 * solver.cfg.keys_per_epoch)


def test_exhaustion_matches_jax_solver(solver, jax_table):
    """giant_steps and epochs on an exhausted range equal the JAX
    solver's on the same configuration (its non-fused CPU path)."""
    jcfg = JS.SolverConfig(chunk=8, **GEOM)
    js = JS.Solver(jcfg, baby=jax_table)
    pk = 1 << 22
    pub = ecpy.mul(pk + (1 << 18))
    for pke in (pk + (1 << 13), pk + 3 * solver.cfg.keys_per_epoch + 7):
        want = js.solve(pub, pk, pke)
        got = solver.solve(pub, pk, pke)
        assert got.key is None and want.key is None
        assert (got.giant_steps, got.epochs) == (want.giant_steps,
                                                 want.epochs)
        assert got.giant_steps > 0


def test_overflow_redispatch(jax_table):
    """A table holding every landing prefix of the first epoch floods the
    4-slot hit buffer; the epoch is re-run with a larger one."""
    cfg = S.SolverConfig(chunk_c=2, lanes_w=4, epoch_phases=2, hit_cap=4,
                         **dict(GEOM, w=64, jobs_per_epoch=2))
    s0 = S.Solver(cfg, baby=_carry(JT.build_baby_table(64, 6, window=16,
                                                       tile=32)),
                  device="cpu")
    pub = ecpy.mul(987654321)
    pk = 1000
    q0 = ecpy.sub(pub, ecpy.mul(pk))
    cx, cy, cinf = s0.epoch_centers(q0, 0, cfg.jobs_per_epoch)
    s_g = ecpy.mul(cfg.stride)
    pres = set()
    for t in range(cfg.jobs_per_epoch):
        if cinf[t]:
            continue
        m_pt = tuple(sum(int(v) << (16 * i) for i, v in enumerate(row))
                     for row in (cx[t], cy[t]))
        for j in range(1, cfg.n_offsets + 1):
            for pt in (ecpy.add(m_pt, ecpy.mul(j, s_g)),
                       ecpy.sub(m_pt, ecpy.mul(j, s_g))):
                if pt is not None:
                    pres.add(pt[0] & ((1 << 64) - 1))
    flood = JT.pack_table(np.array(sorted(pres), dtype=np.uint64), 6, 16)
    s = S.Solver(cfg, baby=_carry(flood), device="cpu")
    res = s.solve(pub, pk, pk + cfg.keys_per_epoch - 1, max_epochs=1)
    assert res.key is None  # no real key: every hit verified and rejected
    assert res.hits_checked > cfg.hit_cap


def test_max_epochs_caps_the_scan(solver):
    """A key in the third epoch is out of reach of a 2-epoch scan, which
    dispatches and drains exactly 2 epochs."""
    cfg = solver.cfg
    pk = 2_000_000
    k = pk + 2 * cfg.keys_per_epoch + 29
    res = solver.solve(ecpy.mul(k), pk, pk + 4 * cfg.keys_per_epoch,
                       max_epochs=2)
    assert res.key is None and res.epochs == 2
    assert res.giant_steps == 2 * (2 * cfg.n_offsets + 1) * cfg.jobs_per_epoch
    assert solver.solve(ecpy.mul(k), pk, pk + 4 * cfg.keys_per_epoch,
                        max_epochs=3).key == k


# ---------------------------------------------------------------------------
# The streamed solve: a rescan table, pooled hits, deferred verification

RESCAN_GEOM = dict(w=256, htsz=6, n_offsets=8, jobs_per_epoch=2, window=16,
                   table_tile=64)
RESCAN_PK = 1 << 21


def _plant_false_positive(dense, offsets, cfg, q0, m):
    """A dense entry with the disc of giant index m's landing, in the first
    free slot of its bucket (tests/test_solver.py's _plant_fp on a numpy
    matrix), counted in the bucket's CSR offsets as a built entry is (the
    port's probe reads a row's first offsets-diff slots)."""
    pre = ecpy.sub(q0, ecpy.mul(m * cfg.stride))[0] & ((1 << 64) - 1)
    bucket = pre >> (64 - cfg.htsz)
    free = np.where(dense[bucket] == JT.DENSE_FILL)[0]
    assert free[0] == offsets[bucket + 1] - offsets[bucket]
    dense[bucket, free[0]] = np.uint32((pre >> (32 - cfg.htsz)) & 0xFFFFFFFF)
    offsets[bucket + 1:] += 1


@pytest.fixture(scope="module")
def rescan_case():
    """One bsgs_tpu streamed rescan table with false positives planted in
    epochs 0 and 2 of a 4-epoch range whose key lies in epoch 3, the JAX
    solver's result on it, and the table carried across to the port."""
    import jax.numpy as jnp

    jcfg = JS.SolverConfig(chunk=16, positions="rescan", **RESCAN_GEOM)
    jt = JT.build_baby_table_streamed(256, 6, window=16, tile=32, chunk=64,
                                      positions="rescan")
    k = RESCAN_PK + 3 * jcfg.keys_per_epoch + 1000
    pub = ecpy.mul(k)
    q0 = ecpy.sub(pub, ecpy.mul(RESCAN_PK))
    dense = np.asarray(jt.dense).copy()
    offsets = np.asarray(jt.offsets).copy()
    for m in (5, 70):
        _plant_false_positive(dense, offsets, jcfg, q0, m)
    jt.dense = jnp.asarray(dense)
    pke = RESCAN_PK + 4 * jcfg.keys_per_epoch - 1
    want = JS.Solver(jcfg, baby=jt).solve(pub, RESCAN_PK, pke)
    assert want.key == k and want.hits_checked >= 3
    want_events = _events(
        JS.Solver(dataclasses.replace(jcfg, verify_defer_epochs=1), baby=jt),
        pub, pke)
    baby = convert.baby_table(
        w=jt.w, htsz=jt.htsz, window=jt.window, offsets=offsets,
        dense=dense, pos_lo=np.asarray(jt.pos_lo), tile=64, device="cpu")
    return dict(k=k, pub=pub, pke=pke, want=want, baby=baby,
                want_events=want_events)


def _events(solver, pub, pke):
    """A 3-epoch scan's drains and callbacks, in the order they happen."""
    events = []
    collect = solver._collect

    def recording(pub_, pk, rec):
        events.append(("drain", rec[0]))
        return collect(pub_, pk, rec)

    solver._collect = recording
    res = solver.solve(
        pub, RESCAN_PK, pke, max_epochs=3,
        on_epoch=lambda e, steps: events.append(("on_epoch", e, steps)),
        progress=lambda done, total, steps, dt: events.append(
            ("progress", done, total, steps)))
    assert res.key is None and res.epochs == 3
    return events


def _count_batches(baby):
    """Wrap baby.lookup_fn so that batch and single calls are counted."""
    calls = {"batch": 0, "single": 0}
    orig = baby.lookup_fn

    def counting(pre):
        calls["single"] += 1
        return orig(pre)

    def counting_batch(pres):
        calls["batch"] += 1
        return orig.batch(pres)

    counting.batch = counting_batch
    baby.lookup_fn = counting
    return calls, orig


def _rescan_solver(baby, **kw):
    cfg = S.SolverConfig(chunk_c=2, lanes_w=4, epoch_phases=2, **RESCAN_GEOM,
                         **kw)
    return S.Solver(cfg, baby=baby, device="cpu")


def test_streamed_solve_matches_jax_solver(rescan_case):
    """Default VERIFY_DEFER_EPOCHS: the hits of all four epochs share one
    batched lookup, and the result equals the JAX solver's."""
    c = rescan_case
    calls, orig = _count_batches(c["baby"])
    try:
        got = _rescan_solver(c["baby"]).solve(c["pub"], RESCAN_PK, c["pke"])
    finally:
        c["baby"].lookup_fn = orig
    want = c["want"]
    assert got.key == want.key == c["k"]
    assert (got.giant_steps, got.epochs, got.hits_checked) == (
        want.giant_steps, want.epochs, want.hits_checked)
    assert calls == {"batch": 1, "single": 0}


def test_streamed_solve_without_deferral_verifies_per_drain(rescan_case):
    c = rescan_case
    calls, orig = _count_batches(c["baby"])
    try:
        got = _rescan_solver(c["baby"], verify_defer_epochs=0).solve(
            c["pub"], RESCAN_PK, c["pke"])
    finally:
        c["baby"].lookup_fn = orig
    assert got.key == c["k"]
    assert calls["batch"] >= 2 and calls["single"] == 0
    assert got.hits_checked == c["want"].hits_checked


def test_scan_end_verifies_pooled_hits(rescan_case):
    """A 3-epoch scan stops short of the key with the false positives of
    epochs 0 and 2 still pooled: they are verified before it returns."""
    c = rescan_case
    calls, orig = _count_batches(c["baby"])
    try:
        got = _rescan_solver(c["baby"]).solve(c["pub"], RESCAN_PK, c["pke"],
                                              max_epochs=3)
    finally:
        c["baby"].lookup_fn = orig
    assert got.key is None and got.epochs == 3
    assert got.hits_checked >= 2
    assert calls == {"batch": 1, "single": 0}


def test_callbacks_trail_verification_as_the_jax_solver_does(rescan_case):
    """Drains, on_epoch and progress calls of a 3-epoch scan with hits
    pooled over one drain: the same events in the same order as the JAX
    solver's; no callback fires while a hit of its epoch is pooled."""
    got = _events(_rescan_solver(rescan_case["baby"], verify_defer_epochs=1),
                  rescan_case["pub"], rescan_case["pke"])
    assert got == rescan_case["want_events"]
    # epoch 0's false positive holds its callbacks until epoch 1 drains
    assert [e[:2] for e in got[:4]] == [("drain", 0), ("drain", 1),
                                        ("on_epoch", 0), ("progress", 1)]


def test_start_epoch_skips_the_epochs_before_it(solver):
    """A scan from epoch 2 finds a key of epoch 2 in one drained epoch and
    cannot find a key of epoch 0; its callbacks count epochs from 2."""
    cfg = solver.cfg
    pk = 3_000_000
    k = pk + 2 * cfg.keys_per_epoch + 77
    seen = []
    res = solver.solve(ecpy.mul(k), pk, pk + 4 * cfg.keys_per_epoch,
                       start_epoch=2, on_epoch=lambda e, st: seen.append(e))
    assert res.key == k and res.epochs <= cfg.pipeline
    res = solver.solve(ecpy.mul(pk + 77), pk, pk + 4 * cfg.keys_per_epoch,
                       start_epoch=2, on_epoch=lambda e, st: seen.append(e))
    assert res.key is None and res.epochs == 3
    assert seen[-3:] == [2, 3, 4]


def test_epoch_centers_take_any_count(solver):
    """128 centers (beyond the 64 of a host fill in the JAX package) equal
    the exact host points, an infinite first center included."""
    cfg = solver.cfg
    q0 = ecpy.mul(987654321)
    cx, cy, cinf = solver.epoch_centers(q0, 3, 128)
    for t in (0, 64, 127):
        c = (3 + t) * cfg.jobs_span + cfg.n_offsets
        pt = ecpy.sub(q0, ecpy.mul(c * cfg.stride))
        assert sum(int(v) << (16 * i) for i, v in enumerate(cx[t])) == pt[0]
        assert sum(int(v) << (16 * i) for i, v in enumerate(cy[t])) == pt[1]
    assert not cinf.any()
    c0 = (5 * cfg.jobs_span + cfg.n_offsets) * cfg.stride
    cx, cy, cinf = solver.epoch_centers(ecpy.mul(c0), 5, 70)
    assert cinf.tolist() == [True] + [False] * 69
    assert not cx[0].any() and not cy[0].any()


@pytest.mark.parametrize("n, jobs, want", [
    (1 << 18, 4, (16, 256)), (4096, 4, (16, 256)), (1024, 4, (16, 64)),
    (8, 4, (8, 1)), (12, 4, (4, 1)), (1000, 32, (8, 1)), (7, 1, (1, 1)),
    (1 << 18, 32, (16, 256))])
def test_chain_layout(n, jobs, want):
    assert S.chain_layout(n, jobs) == want


def test_chain_layout_refuses_a_fold_without_warp_lanes():
    # 4 * 65,537 / 1 totals a phase need a fold, and W=1 cannot take one
    with pytest.raises(ValueError, match="unfused"):
        S.chain_layout(65537, 4)
    assert S.chain_layout(65536 * 32, 4) == (16, 256)


def test_deferral_applies_to_rescan_tables_only(jax_table):
    """A table without lookup_fn verifies at every drain whatever
    VERIFY_DEFER_EPOCHS says: the key in epoch 0 ends the scan there."""
    cfg = S.SolverConfig(chunk_c=2, lanes_w=4, epoch_phases=2, pipeline=1,
                         **GEOM)
    assert S.VERIFY_DEFER_EPOCHS == 64
    s = S.Solver(cfg, baby=_carry(jax_table), device="cpu")
    pk = 1 << 20
    res = s.solve(ecpy.mul(pk + 4321), pk, pk + 4 * cfg.keys_per_epoch)
    assert res.key == pk + 4321 and res.epochs == 1


def test_build_table_routes_big_w_to_the_streamed_build(monkeypatch):
    calls = []
    monkeypatch.setattr(
        S.tbl, "build_baby_table_streamed",
        lambda w, htsz, **kw: calls.append(("streamed", w, htsz, kw)))
    monkeypatch.setattr(
        S.tbl, "build_baby_table_device",
        lambda w, htsz, **kw: calls.append(("device", w, htsz, kw)))
    S.build_table(S.SolverConfig(w=1 << 28), device="cpu")
    S.build_table(S.SolverConfig(w=(1 << 28) - 1, htsz=22), device="cpu")
    assert [c[:3] for c in calls] == [("streamed", 1 << 28, 22),
                                      ("device", (1 << 28) - 1, 22)]
    # the config's positions go to the streamed build ("auto": rescan at
    # this size)
    assert calls[0][3]["positions"] == "auto"
    # 6 B per slot with the hint, 8 with the position plane, 4 below 2^28
    big = S.SolverConfig(w=1 << 30)
    assert big.htsz == 24
    assert S.table_bytes_per_slot(big) == 6
    assert S.table_bytes_per_slot(
        dataclasses.replace(big, positions="mirror")) == 8
    assert S.table_bytes_per_slot(S.SolverConfig(w=1 << 26)) == 4
    S.check_table_fits((1 << 24) * 128 * 6, mem_bytes=80 << 30)
    with pytest.raises(ValueError, match="exceeds"):
        S.check_table_fits((1 << 24) * 128 * 6, mem_bytes=14 << 30)


# ---------------------------------------------------------------------------
# Guards


def test_port_imports_no_jax_in_a_fresh_process():
    mods = sorted(
        "bsgs_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'bsgs_tpu' or m.startswith('bsgs_tpu.')]\n"
        "print(len(sys.modules)); sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert len(mods) >= 16
    assert {"bsgs_tpu_torch.cli", "bsgs_tpu_torch.utils.codecs",
            "bsgs_tpu_torch.utils.checkpoint", "bsgs_tpu_torch.utils.native",
            "bsgs_tpu_torch.utils.artifacts", "bsgs_tpu_torch.utils.tuner",
            "bsgs_tpu_torch.ops.field", "bsgs_tpu_torch.ops.ec",
            "bsgs_tpu_torch.models.giant", "bsgs_tpu_torch.models.table",
            "bsgs_tpu_torch.parallel.striped",
            "bsgs_tpu_torch.parallel.sharded_table"} <= set(mods)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_bsgs_tpu_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "bsgs_tpu"), (path, name)


def test_entry_points_refuse_the_cpu_by_default(jax_table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    cfg = S.SolverConfig(**GEOM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.Solver(cfg, baby=_carry(jax_table))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.build_table(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.offset_planes(np.zeros((16, 8), np.uint32),
                              np.zeros((16, 8), np.uint32))


def test_config_defaults_match_bench_geometry():
    cfg = S.SolverConfig(w=1 << 26)
    assert (cfg.htsz, cfg.n_offsets, cfg.jobs_per_epoch, cfg.epoch_phases,
            cfg.pipeline, cfg.table_tile, cfg.positions,
            cfg.verify_defer_epochs) == (
        20, 1 << 18, 16, 4, 3, 1 << 18, "auto", S.VERIFY_DEFER_EPOCHS)
    assert S.chain_layout(cfg.n_offsets, cfg.jobs_per_epoch // cfg.phases) \
        == (cfg.chunk_c, cfg.lanes_w)
    assert dataclasses.replace(cfg, w=64).stride == 128
