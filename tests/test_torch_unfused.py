"""The port's unfused epoch (giant.run_epoch, the row-major field/ec
surface) against bsgs_tpu's run_epoch on one packed table, bit for bit,
with planted hits of codes 1, 2, 4 and 5; an unfused Solver and the
command line at an N that solver.chain_layout refuses, finding a planted
key; and epoch striping (solve(epoch_stride=, epoch_offset=)) covering a
range as tests/test_solver.py's striping test does."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bsgs_tpu.models import giant as JG, table as JT
from bsgs_tpu_torch import cli, convert
from bsgs_tpu_torch.models import giant as G, solver as S
from bsgs_tpu_torch.ops import epoch_kernel as EK, field as F
from bsgs_tpu_torch.utils import codecs, ecpy

from test_torch_probe_kernel import csr_rows

torch.set_num_threads(2)

W, HTSZ, WINDOW = 64, 6, 16
N, T_JOBS = 12, 4  # N = 12 takes no chains of 32 lanes
MASK64 = (1 << 64) - 1


def _limbs(pts):
    return (F.to_limbs_batch([p[0] for p in pts]),
            F.to_limbs_batch([p[1] for p in pts]))


@pytest.fixture(scope="module")
def epoch_case():
    """T=4 centers against N=12 offsets j*S*G: center 1 is O_3 itself (an
    exact landing, code 4), center 2 is flagged at infinity and center 3's
    own x is in the table (code 5), and the table holds x(M_0 + O_2)
    (code 1) and x(M_3 - O_5) (code 2) besides the baby points."""
    s_g = ecpy.mul(2 * W)
    offs = [ecpy.mul(j, s_g) for j in range(1, N + 1)]
    centers = [ecpy.mul(987654321), offs[2], ecpy.mul(555), ecpy.mul(4242)]
    cinf = np.array([False, False, True, False])
    planted = [ecpy.add(centers[0], offs[1]), ecpy.sub(centers[3], offs[4]),
               centers[3]]
    pres = [ecpy.mul(k)[0] & MASK64 for k in range(1, W + 1)]
    pres += [p[0] & MASK64 for p in planted]
    table = JT.pack_table(np.array(sorted(pres), dtype=np.uint64), HTSZ,
                          WINDOW)
    ox, oy = _limbs(offs)
    cx, cy = _limbs(centers)
    return dict(table=table, ox=ox, oy=oy, cx=cx, cy=cy, cinf=cinf,
                rows=csr_rows(np.asarray(table.offsets),
                             np.asarray(table.dense)))


def _port_epoch(c, hit_cap):
    t = [torch.from_numpy(c[k].astype(np.int64))
         for k in ("cx", "cy", "ox", "oy")]
    return G.run_epoch(t[0], t[1], torch.from_numpy(c["cinf"]), t[2], t[3],
                       c["rows"], htsz=HTSZ, hit_cap=hit_cap)


def test_run_epoch_matches_jax(epoch_case):
    c = epoch_case
    j_idx, j_cnt, j_gs = JG.run_epoch(
        *(jnp.asarray(c[k]) for k in ("cx", "cy", "cinf", "ox", "oy")),
        c["table"].dense, htsz=HTSZ, chunk=8, hit_cap=16)
    idx, cnt, gs = _port_epoch(c, 16)
    assert gs == j_gs == (2 * N + 1) * T_JOBS
    assert int(cnt) == int(j_cnt)
    np.testing.assert_array_equal(convert.u32(idx), np.asarray(j_idx))
    codes = {G.decode_flat(int(f), T_JOBS, N)
             for f in G.hit_indices(idx.numpy())}
    assert {(1, 0, 2), (2, 3, 5), (4, 1, 3), (5, 2, 0), (5, 3, 0)} <= codes
    # an overflowing buffer keeps the first hits and the full count
    idx_o, cnt_o, _ = _port_epoch(c, 2)
    assert int(cnt_o) == int(j_cnt)
    np.testing.assert_array_equal(convert.u32(idx_o),
                                  np.asarray(j_idx)[:2])


def test_epoch_probes_takes_a_pluggable_probe(epoch_case):
    """epoch_probes hands the probe one stream of 2TN + T prefixes."""
    c = epoch_case
    seen = []

    def probe(hi, lo):
        seen.append((hi.shape, hi.dtype, lo.dtype))
        return torch.zeros(hi.shape, dtype=torch.bool)

    t = [torch.from_numpy(c[k].astype(np.int64))
         for k in ("cx", "cy", "ox", "oy")]
    idx, cnt = G.epoch_probes(t[0], t[1], torch.from_numpy(c["cinf"]), t[2],
                              t[3], probe, hit_cap=8)
    assert seen == [((2 * T_JOBS * N + T_JOBS,), torch.int32, torch.int32)]
    # no probe hits: the exact lane and the infinite center remain
    assert [G.decode_flat(int(f), T_JOBS, N)
            for f in G.hit_indices(idx.numpy())] == [(4, 1, 3), (5, 2, 0)]


# ---------------------------------------------------------------------------
# The unfused solver

GEOM = dict(w=256, htsz=6, n_offsets=8, jobs_per_epoch=4, window=16,
            table_tile=64)


@pytest.fixture(scope="module")
def jax_table():
    return JT.build_baby_table(256, 6, window=16, tile=64)


def _carry(jt):
    return convert.baby_table(
        w=jt.w, htsz=jt.htsz, window=jt.window, offsets=jt.offsets,
        disc_sorted=jt.disc_sorted, pos_sorted=jt.pos_sorted,
        dense=np.asarray(jt.dense), sorted_pre=jt.sorted_pre, device="cpu")


@pytest.fixture(scope="module")
def unfused(jax_table):
    s = S.Solver(S.SolverConfig(fused=False, **GEOM),
                 baby=_carry(jax_table), device="cpu")
    assert not s.fused and s._phases == 1
    return s


@pytest.mark.parametrize("k_off", [
    8 * 512 - 3 * 512 - 5,  # + branch
    8 * 512 + 3 * 512 + 5,  # - branch
    7 * 512,  # exact giant landing
    8 * 512,  # job center at infinity
    (3 * 17 + 8) * 512])  # a later job's center
def test_unfused_solve_finds_the_key(unfused, k_off):
    pk = 123_456
    res = unfused.solve(ecpy.mul(pk + k_off), pk, pk + (1 << 15))
    assert res.key == pk + k_off


def test_solver_goes_unfused_where_no_chain_layout_fits(monkeypatch,
                                                        jax_table):
    """With the direct width forced to 8, N=12 at 4 jobs a phase needs a
    fold of 12 chain totals in chains of 4 x 1 lanes, which the kernels
    refuse: chain_layout raises, fused=None goes unfused and fused=True
    raises."""
    monkeypatch.setattr(EK, "DIRECT_MAX", 8)
    with pytest.raises(ValueError, match="unfused"):
        S.chain_layout(12, 4)
    cfg = dict(GEOM, n_offsets=12, chunk_c=4, lanes_w=1, epoch_phases=1)
    with pytest.raises(ValueError, match="fused=False"):
        S.Solver(S.SolverConfig(fused=True, **cfg), baby=_carry(jax_table),
                 device="cpu")
    s = S.Solver(S.SolverConfig(**cfg), baby=_carry(jax_table),
                 device="cpu")
    assert not s.fused
    pk = 31_337
    k = pk + (2 * 25 + 12) * 512 - 4 * 512 - 9  # job 2, + branch, j=4
    assert s.solve(ecpy.mul(k), pk, pk + 3 * s.cfg.keys_per_epoch).key == k
    # the default layout fits N=8 at the real direct width
    monkeypatch.undo()
    assert S.Solver(S.SolverConfig(chunk_c=2, lanes_w=4, **GEOM),
                    baby=_carry(jax_table), device="cpu").fused


def test_cli_takes_an_n_that_no_chain_layout_fits(tmp_path, monkeypatch,
                                                   capsys):
    """--n-offsets 12 with the direct width forced to 8: the command line
    solves through the unfused epoch, with the JAX CLI's fingerprint."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(EK, "DIRECT_MAX", 8)
    pk = 1 << 20
    k = pk + (5 * 25 + 12) * 512 + 3 * 512 + 1  # job 5, - branch, j=3
    rc = cli.main(["--pub", codecs.format_pubkey(ecpy.mul(k)), "--pk",
                   f"{pk:x}", "--pke", f"{pk + 8 * 25 * 512:x}", "--w", "8",
                   "--htsz", "6", "--n-offsets", "12", "--jobs-per-epoch",
                   "4", "--pipeline", "1"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0 and f"KEY FOUND: {k:#x}" in out
    assert (tmp_path / "win.txt").read_text().split()[0] == f"{k:064x}"


# ---------------------------------------------------------------------------
# Epoch striping


@pytest.mark.parametrize("fused", [False, True])
def test_epoch_striping_covers_the_range(fused, jax_table):
    """Two workers striding by 2 (offsets 0 and 1) split the epochs of a
    range between them: the worker that owns the key's epoch finds it,
    the other scans its own epochs to the end."""
    s = S.Solver(S.SolverConfig(fused=fused, chunk_c=2, lanes_w=4,
                                epoch_phases=1, pipeline=2, **GEOM),
                 baby=_carry(jax_table), device="cpu")
    assert s.fused == fused
    pk = 2_000_000
    kpe = s.cfg.keys_per_epoch
    pke = pk + 5 * kpe - 1  # epochs 0..5
    k = pk + 3 * kpe + 29_000 % kpe
    seen = {0: [], 1: []}
    results = [s.solve(ecpy.mul(k), pk, pke, epoch_stride=2,
                       epoch_offset=i,
                       on_epoch=lambda e, st, _i=i: seen[_i].append(e))
               for i in (0, 1)]
    assert [r.key for r in results] == [None, k]
    assert seen[0] == [0, 2, 4] and results[0].epochs == 3
    assert results[0].giant_steps == 3 * (2 * 8 + 1) * 4
    # start_epoch counts in strides: epoch 2*1 + 1 = 3, the key's, is the
    # first drained
    res = s.solve(ecpy.mul(k), pk, pke, epoch_stride=2, epoch_offset=1,
                  start_epoch=1)
    assert res.key == k and res.epochs == 1
