#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths once on one GPU.

    python3 chip_smoke.py            # the whole run below
    python3 chip_smoke.py --builds   # only the two builds and a residue
                                     # scan, timed, to compare two trees

Phases, each followed by torch.cuda.synchronize(); any failure exits
nonzero:

1. build the CUDA kernels of bsgs_tpu_torch/csrc with nvcc (sm_90a), and
   read the Montgomery kernels' registers and spills from the build;
2. run each of the six epoch and table kernels and its plain PyTorch
   version on the card at the main path's shapes and require bit-identical
   outputs, timing both; hold the inversion kernel at 2,048, 16,384 and
   131,072 lanes too (edge values planted) against the exponentiation and
   against the plain version of its own algorithm, and require
   x * inv(x) == 1 at the widest; time one epoch phase at chain lengths 8
   and 16 with the totals inverted after one fold and unfolded, and
   require the same key plane from each; hold both entries of the two
   Montgomery kernels against the serial and the segmented plain versions
   at the table tile (doubling lanes planted, and a ragged width) and
   time the tile's inversion under several chain layouts;
3. build the w=2^26 baby table (htsz=20, 128-slot rows, tile 2^18);
4. solve a planted key in the second epoch at N=2^18, T=16, 4 phases,
   3 epochs in flight; read the launch counts of phases 3-4;
5. run the probe kernel and its plain version on that table with the
   keys of a real epoch phase plus planted members (m = 2^20, 16 and an
   odd length) and on synthetic 512-slot and 20-slot tables,
   bit-identical, timed; build the same table streamed and require the
   one-shot build's entries, one for one;
6. time 8-epoch scans of a pubkey with no key in range (giant-steps/s),
   requiring the launches per epoch that the inversion tree should make,
   and profile a short one (device time by kernel, busy share, the host's
   waits for the device, the same with the solve's callbacks set); then
   drive the command line (bsgs_tpu_torch.cli.main, in a scratch
   directory) at w=2^26: a planted pubkey to win.txt, --infile with a
   garbage line, --resume from a checkpoint it wrote (and refused on
   another --w or pubkey), --gen-only (artifact saved, reloaded, checked),
   the progress line's rate, a narrow chain layout (--n-offsets 1000);
   check which chain layouts the epoch kernels take, and time T=128 jobs
   an epoch against T=16; then join a process group of one rank on NCCL
   and drive parallel.striped.MeshSolver over a replicated w=2^26 table
   (its own table, a planted key of super-epoch 1), and time its 8-epoch
   scans beside the plain Solver's in turns, with its host waits;
7. free that table and drive the streamed path: hold the six kernels
   against their plain versions again at this path's shapes (24 bucket
   bits, 2^20-lane tiles), build the w=2^30 table (htsz=24, rescan
   positions: an 8 GiB dense matrix and a 4 GiB hint plane), look
   positions up, solve a planted key in the second epoch through deferred
   verification, read the launch counts of this path, hold the probe
   kernel against its plain version on the 8 GiB table, and time 32-epoch
   scans (giant-steps/s, hits checked, residue scans, host waits), without
   and with a planted slot that survives the hint to a residue scan;
   build the same table over the group of one
   (parallel.sharded_table.build_sharded_table, equal to the single-card
   table), find a planted key through MeshSolver with the table sharded,
   its lookups through the owner's broadcast rows and a slot that survives
   the hint, and time 8-epoch scans through the all_gather route beside
   the plain Solver's; build the table's 4 shards in
   turn (each equal to its rows of the single-card table) and route one
   phase's three probe streams to them by both routes' tensor functions
   (equal to the whole table's probe); compact hits past index 2^31;
   then the command line at w=2^30 (a planted key through deferred
   verification, no checkpoint past a pooled epoch; and --devices 1
   --shard-table, a group of one of its own), --tune on the card
   with the tuner's estimates held against the bytes phases 3, 6 and 7
   measured, and the suggested geometry run with a planted key;
8. profile both table builds (device time by kernel, the builds' parts
   timed one by one), one tile advance at each path's tile (exactly four
   device launches) and one residue scan;
9. print the kernels' JSON line (every kernel launched on each path: the
   two solves, the command line's two, the two MeshSolver paths and the
   command line's --shard-table path), the card's name and power limit,
   and the result line.

Each path's launches must show one forward and one backward Montgomery
pass per add-const pass: a tile advance or fill pass folds once.

Needs one CUDA card; exits nonzero without one, or without the package
beside it.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

SEED = 20261016
# The card's published peaks (H100 SXM data sheet): HBM3 bandwidth, and the
# 32-bit integer instruction rate of 132 SMs x 64 INT32 lanes x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer instructions per field operation in csrc/field.cuh:
# mul_mod = 8 schoolbook rows of 17 + the two folds and the canonical step;
# add_mod / sub_mod = a 9-instruction chain, a second chain, an 8-way select.
OPS_MUL = 206
OPS_ADD = 26
# The inversion (csrc/modinv.cuh), per batch of 30 division steps: 21 a
# step and 290 for the two matrix applications and the loop's test, as
# nvcc 12.8 compiles the loop (compiled_batch_ops reads the built library
# and the run fails if the count differs); once per inversion, the limb
# conversions and the final normalisation. The batches are counted from the run's own inputs. Its
# instructions are spread over the integer pipe (logic, add, shift) and the
# multiplier pipe (IMAD, which also takes moves, adds and shifts by a
# constant), 64 lanes per SM each, so its bound is the rate of both, which
# is what 4 schedulers x 32 lanes per SM can start; the multiply chains of
# the other kernels run on the one pipe that INT32_OPS_PER_S counts.
OPS_INV_BATCH = 30 * 21 + 290
OPS_INV_ONCE = 290
INV_OPS_PER_S = 2 * INT32_OPS_PER_S
P_INT = 2**256 - 2**32 - 977
# cycles of the spin kernel that cuda_ms queues launches behind
QUEUE_CYCLES = 20_000_000
# How far the tuner's table and build-peak estimates may stray from the
# bytes the run measures (they are constants measured on the H100).
TUNER_MARGIN = 0.10
# Kernel launches of one epoch of the main path (T=16 in 4 phases): per
# phase one forward pass, one inversion of its chain totals (no Montgomery
# fold), one backward pass and two probes, plus one probe of the epoch's
# centers.
LAUNCHES_PER_EPOCH = {"epoch_fwd": 4, "epoch_bwd": 4, "mont_fwd": 0,
                      "mont_bwd": 0, "fermat": 4, "add_const": 0,
                      "probe_rows": 9}

TPU_KERNEL = {
    "epoch_fwd": "bsgs_tpu/ops/epoch_kernel.py:48",
    "epoch_bwd": "bsgs_tpu/ops/epoch_kernel.py:64",
    "mont_fwd": "bsgs_tpu/ops/epoch_kernel.py:107",
    "mont_bwd": "bsgs_tpu/ops/epoch_kernel.py:122",
    "fermat": "bsgs_tpu/ops/epoch_kernel.py:132",
    "add_const": "bsgs_tpu/ops/epoch_kernel.py:198",
    "probe_rows": "bsgs_tpu/ops/probe_kernel.py:37",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, queued: bool = True) -> float:
    """Mean device time of fn() over reps launches. Every caller has run
    fn once already, to compare its result: that was the warm-up.

    queued: the device first spins for QUEUE_CYCLES (about 10 ms) while
    the host queues every launch behind it, so the events time the
    kernels back to back and not the host's Python between them (a
    wrapper takes tens of microseconds of host time, more than a small
    kernel runs). The plain versions, whose time is their host's, are
    timed with queued=False."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_planes(rng, rows: int, m: int, device):
    """(rows, m) int32 planes of random canonical field elements (the top
    limb stays below 0xFFFF, so every value is < p), nonzero."""
    import numpy as np
    import torch

    v = rng.integers(0, 1 << 16, (rows, m), dtype=np.int64)
    v[15] = rng.integers(1, 0xFFFF, m)
    return torch.from_numpy(v.astype(np.int32)).to(device)


def plant_edge_lanes(v):
    """Overwrite the first lanes of a (16, m) plane with the inversion's
    edge values: 0, 1, 2, p-1, p-2, 2^255, one value with every high limb
    zero and one with every low limb zero."""
    import torch

    edge = (0, 1, 2, P_INT - 1, P_INT - 2, 1 << 255, 0x1234, 0xABCD << 240)
    limbs = [[(x >> (16 * i)) & 0xFFFF for x in edge] for i in range(16)]
    v[:, :len(edge)] = torch.tensor(limbs, dtype=v.dtype, device=v.device)
    return v


def inversion_bound(m: int, batches):
    """(operations, bytes) of inverting m lanes whose division steps need
    the given batches per lane: what this input needs, not the cap."""
    return (int(batches.sum()) * OPS_INV_BATCH + m * OPS_INV_ONCE,
            2 * 64 * m)


def build_kernels():
    """Build and load the kernels; returns (seconds, shared libraries)."""
    from bsgs_tpu_torch.ops import _cuda

    t0 = time.time()
    libs = _cuda.build(verbose=True)
    _cuda._load()
    took = time.time() - t0
    loop = compiled_batch_ops(libs)
    if loop != OPS_INV_BATCH:
        raise AssertionError(
            f"the inversion's batch loop compiled to {loop} instructions; "
            f"its bound counts {OPS_INV_BATCH}")
    log(f"sass: one batch of the inversion is {loop} instructions as "
        f"compiled, the count its bound uses")
    return took, libs


def mont_resources(libs) -> dict:
    """Registers, stack, shared and local memory of each instantiation of
    the Montgomery kernels, from cuobjdump -res-usage of the built library
    ("mont_fwd L=4 points" etc.). The run fails if the instantiation the
    path uses (MONT_SEG_LEN positions a thread) spills: local memory or a
    stack."""
    from bsgs_tpu_torch.ops import _cuda, epoch_kernel as EK

    lib = next(p for p in libs if p.name.startswith("libepoch_kernels"))
    exe = Path(_cuda._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(exe), "-res-usage", str(lib)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    found = {}
    for name, L, pts, body in re.findall(
            r"Function \S*(mont_[a-z]+)_kernelILi(\d+)ELb([01])E\S*:\s*\n"
            r"\s*([^\n]*)", out):
        use = dict((k, int(v)) for k, v in re.findall(
            r"(REG|STACK|SHARED|LOCAL):(\d+)", body))
        found[f"{name} L={L}{' points' if pts == '1' else ''}"] = use
    if len(found) != 12:
        raise AssertionError(f"mont kernels in the build: {sorted(found)}")
    for key, use in sorted(found.items()):
        log(f"resources: {key}: {use}")
    for key, use in found.items():
        if f"L={EK.MONT_SEG_LEN}" in key and (use["LOCAL"] or use["STACK"]):
            raise AssertionError(f"{key} spills: {use}")
    return found


def compiled_batch_ops(libs) -> int:
    """The SASS instructions of the inversion kernel's one loop (a batch
    of 30 division steps, unrolled, and its matrix applications), from
    cuobjdump -sass of the built library: the span of its backward
    branch."""
    from bsgs_tpu_torch.ops import _cuda

    lib = next(p for p in libs if p.name.startswith("libepoch_kernels"))
    exe = Path(_cuda._nvcc()).with_name("cuobjdump")  # the toolkit's own
    out = subprocess.run([str(exe), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    body = out.stdout.partition("modinv_kernel")[2].partition("Function :")[0]
    instr = [(int(a, 16), t) for a, t in re.findall(
        r"^\s*/\*([0-9a-f]{4,})\*/\s+(\S[^;]*);", body, flags=re.M)]
    loop = 0
    for addr, text in instr:
        target = re.search(r"\bBRA\b.*\b0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) <= addr:
            loop = max(loop, sum(int(target.group(1), 16) <= a <= addr
                                 for a, _ in instr))
    return loop


def check_inversion(device, widths) -> list:
    """The inversion kernel alone at several widths, edge values planted:
    bit-identical to the exponentiation (fermat_plain) and to the plain
    version of its own algorithm (which also says how many batches each
    lane needs), 0 -> 0, and at the widest width x * inv(x) == 1 on every
    nonzero lane through the plain multiply. Timed at each width: below
    about 16,900 lanes (a warp on each of the 528 schedulers) the time is
    one inversion's latency, above it the instruction rate."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL

    rng = np.random.default_rng(SEED + 5)
    out = []
    for m in widths:
        x = plant_edge_lanes(random_planes(rng, 16, m, device))
        got = EK.fermat(x)
        torch.cuda.synchronize()
        steps, batches = EK.fermat_divsteps_plain(x)
        if not torch.equal(got, steps):
            raise AssertionError(f"inversion at m={m}: kernel differs from "
                                 f"the plain version of its algorithm")
        if not torch.equal(got, EK.fermat_plain(x)):
            raise AssertionError(f"inversion at m={m}: kernel differs from "
                                 f"a^(p-2)")
        if int(got[:, 0].abs().max()) != 0:
            raise AssertionError("inversion: 0 does not map to 0")
        if int(batches.max()) > PL.DIVSTEP_BATCH_CAP:
            raise AssertionError(f"inversion: {int(batches.max())} batches")
        if m == max(widths):
            prod = PL.mul_mod(x.long(), got.long())
            one = (prod[0] == 1) & (prod[1:] == 0).all(dim=0)
            nonzero = ~PL.is_zero(x.long())[0]
            if not bool(one[nonzero].all()) or int(nonzero.sum()) != m - 1:
                raise AssertionError("inversion: x * inv(x) != 1")
        ms = cuda_ms(lambda: EK.fermat(x), reps=20)
        ops, nbytes = inversion_bound(m, batches)
        bound_ms = bound(ops, nbytes, INV_OPS_PER_S)[0]
        out.append(dict(m=m, ms=ms, bound_ms=bound_ms,
                        batches_max=int(batches.max()),
                        batches_mean=float(batches.double().mean())))
        log(f"kernel fermat (division steps), m={m}: bit-identical to "
            f"a^(p-2) and to its own plain version, 0 -> 0"
            f"{', x * inv(x) == 1 on every nonzero lane' * (m == max(widths))}"
            f"; {ms:.4f} ms (bound {bound_ms:.4f} ms by operations); batches "
            f"needed: {out[-1]['batches_mean']:.2f} mean, "
            f"{out[-1]['batches_max']} max")
    return out


def check_kernels(device, label: str, htsz: int, m_tab: int,
                  time_trees: bool, T: int = 4, N: int = 1 << 18):
    """Each kernel against its plain version at one path's shapes: one
    epoch phase (T=4 centers x N offsets) with the path's bucket bits, the
    inversion of that phase's chain totals (unfolded), and one table pass
    of m_tab lanes (the path's build tile) for add_const and for the
    Montgomery passes (check_mont), which only the table build and the
    fills launch. One phase must give the same key plane under each shape
    of the inversion tree; time_trees also times them. Returns the
    per-kernel records."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK

    rng = np.random.default_rng(SEED)
    C, W = EK.CHUNK_C, EK.LANES_W
    ox = random_planes(rng, 16, N, device)
    oy = random_planes(rng, 16, N, device)
    cx = random_planes(rng, 16, T, device)
    cy = random_planes(rng, 16, T, device)
    # exact lanes: Ox == Mx for a few (t, j)
    for t, j in ((0, 5), (1, N // 3), (T - 1, N - 1)):
        ox[:, j] = cx[:, t]
    m_tot = T * N // C
    m_fermat = m_tot
    if m_fermat > EK.DIRECT_MAX or m_tab // EK.TILE_CHUNK_C > EK.DIRECT_MAX:
        raise AssertionError(
            f"the inversion tree is not the one measured: {m_fermat} chain "
            f"totals of a phase, or {m_tab // EK.TILE_CHUNK_C} of a tile, "
            f"would fold")
    v_fermat = plant_edge_lanes(random_planes(rng, 16, m_fermat, device))
    xs = random_planes(rng, 16, m_tab, device)
    ys = random_planes(rng, 16, m_tab, device)
    inv = random_planes(rng, 16, m_tab, device)
    ccx = random_planes(rng, 16, 1, device)
    ccy = random_planes(rng, 16, 1, device)
    xs[:, 1234] = ccx[:, 0]  # a doubling lane

    pre, tot = EK.epoch_fwd(ox, cx, chunk_c=C, lanes_w=W)
    itot = EK.batch_inv_planar(tot)
    inv_steps, batches = EK.fermat_divsteps_plain(v_fermat)
    if not torch.equal(EK.fermat(v_fermat), inv_steps):
        raise AssertionError("fermat: kernel differs from the plain version "
                             "of its algorithm")
    torch.cuda.synchronize()

    # name: (kernel, plain version, int32 instructions, field elements read
    # and written, other bytes moved: the key plane and the x3 prefixes)
    cases = {
        "epoch_fwd": (
            lambda: EK.epoch_fwd(ox, cx, chunk_c=C, lanes_w=W),
            lambda: EK.epoch_fwd_plain(ox, cx, chunk_c=C, lanes_w=W),
            T * N * (OPS_ADD + OPS_MUL), N + T + T * N + m_tot, 0),
        "epoch_bwd": (
            lambda: EK.epoch_bwd(ox, oy, cx, cy, pre, itot, htsz=htsz,
                                 chunk_c=C, lanes_w=W),
            lambda: EK.epoch_bwd_plain(ox, oy, cx, cy, pre, itot, htsz=htsz,
                                       chunk_c=C, lanes_w=W),
            T * N * (6 * OPS_MUL + 7 * OPS_ADD),
            2 * N + 2 * T + T * N + m_tot, 8 * T * N * 4),
        "fermat": (
            lambda: EK.fermat(v_fermat),
            lambda: EK.fermat_plain(v_fermat),
            inversion_bound(m_fermat, batches)[0], 2 * m_fermat, 0),
        "add_const": (
            lambda: EK.add_const(xs, ys, inv, ccx, ccy),
            lambda: EK.add_const_plain(xs, ys, inv, ccx, ccy),
            m_tab * (4 * OPS_MUL + 6 * OPS_ADD), 5 * m_tab + 2,
            2 * m_tab * 4),
    }
    shapes = {"epoch_fwd": f"T={T}, N={N}", "epoch_bwd": f"T={T}, N={N}",
              "fermat": f"m={m_fermat}", "add_const": f"m={m_tab}"}
    records = {}
    for name, (kern, plain, ops, elems, other) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                     f"{w.shape}/{w.dtype}")
            diff = (g.long() - w.long()).abs()
            err = max(err, int(diff.max()) if diff.numel() else 0)
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs limb error {err})")
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=1, queued=False)
        # bound_ms: the planes as the kernels take them, 16 int32 words
        # (64 B) per element; bound_ms_packed: the function's own floor,
        # 32 B per element
        rate = INV_OPS_PER_S if name == "fermat" else INT32_OPS_PER_S
        bound_ms, bound_by = bound(ops, 64 * elems + other, rate)
        packed_ms, packed_by = bound(ops, 32 * elems + other, rate)
        records[name] = dict(
            name=name, route="cuda",
            source="bsgs_tpu_torch/csrc/epoch_kernels.cu",
            replaces=TPU_KERNEL[name], launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, bound_ms_packed=packed_ms,
            bound_by_packed=packed_by, shape=shapes[name])
        log(f"kernel {name} [{label}, {shapes[name]}]: bit-identical to "
            f"plain; {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by}, "
            f"{packed_ms:.4f} ms at 32 B per element); "
            f"exact/doubling/edge lanes included")
        torch.cuda.synchronize()
    records["fermat"].update(
        batches_max=int(batches.max()),
        batches_mean=float(batches.double().mean()))

    # The shape of the inversion tree and the chain length change no output
    # bit, only the time: one phase at chain lengths 8 and 16, with the
    # totals inverted after one fold (through the Montgomery kernels of
    # csrc/mont.cuh) and unfolded (16, unfolded: the path's).
    def phase(c, direct_max):
        pre_c, tot_c = EK.epoch_fwd(ox, cx, chunk_c=c, lanes_w=W)
        inv_c = EK.batch_inv_planar(tot_c, chunk_c=c, lanes_w=W,
                                    direct_max=direct_max)
        return EK.epoch_bwd(ox, oy, cx, cy, pre_c, inv_c, htsz=htsz,
                            chunk_c=c, lanes_w=W)

    want = EK.epoch_landing_keys(cx, cy, ox, oy, htsz=htsz)
    trees = []
    for c, direct_max in ((8, 1 << 16), (8, 1 << 17), (16, 1 << 15),
                          (C, EK.DIRECT_MAX)):
        folds, m_inv = 0, T * N // c
        while m_inv > direct_max:
            folds, m_inv = folds + 1, m_inv // c
        if not torch.equal(phase(c, direct_max), want):
            raise AssertionError(f"key planes differ at chain length {c}, "
                                 f"{folds} folds")
        if not time_trees:
            continue
        ms = cuda_ms(lambda: phase(c, direct_max), 20)
        trees.append(dict(chunk_c=c, folds=folds, m_inverted=m_inv, ms=ms))
        log(f"tree [{label}]: chain length {c}, {folds} folds, {m_inv} "
            f"lanes inverted: {ms:.4f} ms per phase (T={T}, N={N}, W={W}, "
            f"htsz={htsz}), key plane equal")
    if time_trees:
        records["fermat"]["phase_ms_by_tree"] = trees
    else:
        log(f"tree [{label}]: key planes equal under all four shapes")
    torch.cuda.synchronize()
    return records


def tile_points(rng, m: int, device):
    """Random (xs, ys) planes of m lanes and a step column (cx, cy), with
    doubling lanes planted (x == Cx at lanes 1234 % m and m - 1)."""
    xs = random_planes(rng, 16, m, device)
    ys = random_planes(rng, 16, m, device)
    cx = random_planes(rng, 16, 1, device)
    cy = random_planes(rng, 16, 1, device)
    for lane in (1234 % m, m - 1):
        xs[:, lane] = cx[:, 0]
    return xs, ys, cx, cy


def mont_work(m: int, chunk_c: int, backward: bool, points: bool,
              doublings: int = 0) -> tuple:
    """(int32 instructions, field elements moved) of one Montgomery pass
    over m lanes in chains of chunk_c: the function's own work, a multiply
    per element forward and two backward; forward reads v and writes pre
    and the totals, backward reads v, pre and the inverted totals and
    writes the inverses. The points entry reads xs in place of v, ys only
    on the doubling lanes, and the step's x column, and adds a sub_mod per
    element (and an add_mod per doubling lane)."""
    ops = m * (2 if backward else 1) * OPS_MUL
    elems = (3 if backward else 2) * m + -(-m // chunk_c)
    if points:
        ops += (m + doublings) * OPS_ADD
        elems += doublings + 1
    return ops, elems


def bound(ops: int, nbytes: int, ops_per_s: float = INT32_OPS_PER_S):
    """(ms, "operations" or "bytes"): the larger of the two floors, the
    instructions at ops_per_s and the bytes at the memory's rate."""
    op_s, byte_s = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(op_s, byte_s), ("operations" if op_s >= byte_s
                                     else "bytes")


def check_mont(device, m: int, label: str) -> dict:
    """The two redesigned Montgomery kernels at one tile width, both
    entries (the points entry the build runs, and the plane entry of the
    inversion's recursion), at the tile chain length: bit-identical to the
    serial plain versions and to the segmented plain versions (the
    kernel's own split), doubling lanes planted; then a ragged width (the
    points entry pads the last block of chains in registers). Times each
    pass and the tile's whole inversion (forward, inversion of the
    totals, backward). Returns the records of the points entry."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK

    rng = np.random.default_rng(SEED + 7)
    C, W = EK.TILE_CHUNK_C, EK.LANES_W
    S = EK.mont_segments(C)
    kw = dict(chunk_c=C, lanes_w=W)

    def same(what, got, *wants):
        got = got if isinstance(got, tuple) else (got,)
        for want in wants:
            want = want if isinstance(want, tuple) else (want,)
            if len(got) != len(want) or not all(
                    g.shape == w.shape and torch.equal(g, w)
                    for g, w in zip(got, want)):
                raise AssertionError(f"{what} [{label}]: kernel differs from "
                                     f"a plain version")

    for width in (m, 5001):
        xs, ys, cx, _ = tile_points(rng, width, device)
        pre, tot = EK.mont_fwd_points(xs, ys, cx, **kw)
        same(f"mont_fwd points m={width}", (pre, tot),
             EK.mont_fwd_points_plain(xs, ys, cx, **kw),
             EK.mont_fwd_points_plain(xs, ys, cx, segments=S, **kw))
        itot = EK.fermat(tot)
        inv = EK.mont_bwd_points(xs, ys, cx, pre, itot, **kw)
        same(f"mont_bwd points m={width}", inv,
             EK.mont_bwd_points_plain(xs, ys, cx, pre, itot, **kw),
             EK.mont_bwd_points_plain(xs, ys, cx, pre, itot, segments=S,
                                      **kw),
             EK.fermat(EK.tile_den_plain(xs, ys, cx).to(torch.int32)))
    xs, ys, cx, _ = tile_points(rng, m, device)
    den = EK.tile_den_plain(xs, ys, cx).to(torch.int32)
    vpre, vtot = EK.mont_fwd(den, **kw)
    same("mont_fwd plane", (vpre, vtot), EK.mont_fwd_plain(den, **kw),
         EK.mont_fwd_segmented_plain(den, segments=S, **kw),
         EK.mont_fwd_points(xs, ys, cx, **kw))
    vitot = EK.fermat(vtot)
    same("mont_bwd plane", EK.mont_bwd(den, vpre, vitot, **kw),
         EK.mont_bwd_plain(den, vpre, vitot, **kw),
         EK.mont_bwd_segmented_plain(den, vpre, vitot, segments=S, **kw))
    torch.cuda.synchronize()

    pre, tot = EK.mont_fwd_points(xs, ys, cx, **kw)
    itot = EK.fermat(tot)
    dbl = int((xs == cx).all(dim=0).sum())
    records = {}
    for name, kern, plain, backward in (
            ("mont_fwd", lambda: EK.mont_fwd_points(xs, ys, cx, **kw),
             lambda: EK.mont_fwd_points_plain(xs, ys, cx, **kw), False),
            ("mont_bwd",
             lambda: EK.mont_bwd_points(xs, ys, cx, pre, itot, **kw),
             lambda: EK.mont_bwd_points_plain(xs, ys, cx, pre, itot, **kw),
             True)):
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=1, queued=False)
        plane_ms = cuda_ms(
            (lambda: EK.mont_bwd(den, vpre, vitot, **kw)) if backward
            else (lambda: EK.mont_fwd(den, **kw)), reps=20)
        ops, elems = mont_work(m, C, backward, True, dbl)
        bound_ms, bound_by = bound(ops, 64 * elems)
        packed_ms, packed_by = bound(ops, 32 * elems)
        plane_ops, plane_elems = mont_work(m, C, backward, False)
        records[name] = dict(
            name=name, route="cuda", source="bsgs_tpu_torch/csrc/mont.cuh",
            replaces=TPU_KERNEL[name], launches=0, max_abs_err=0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, bound_ms_packed=packed_ms,
            bound_by_packed=packed_by,
            shape=f"points entry, m={m}, chains of {C} in {S} segments",
            plane_entry_ms=plane_ms,
            plane_entry_bound_ms=bound(plane_ops, 64 * plane_elems)[0])
        log(f"kernel {name} [{label}, points entry, m={m}, chains of {C} "
            f"in {S} segments]: bit-identical to the serial and the "
            f"segmented plain versions (and at m=5001), {dbl} doubling "
            f"lanes; {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by}: {100 * bound_ms / ms:.0f}%; "
            f"{packed_ms:.4f} ms at 32 B per element); plane entry "
            f"{plane_ms:.4f} ms")

    def fold():
        p_, t_ = EK.mont_fwd_points(xs, ys, cx, **kw)
        i_ = EK.batch_inv_planar(t_)
        return EK.mont_bwd_points(xs, ys, cx, p_, i_, **kw)

    fold_ms = cuda_ms(fold, reps=20)
    records["mont_bwd"]["tile_inversion_ms"] = fold_ms
    log(f"tile inversion [{label}, m={m}]: forward, inversion of {m // C} "
        f"totals, backward: {fold_ms:.4f} ms")
    return records


def sweep_mont(device, m: int, label: str) -> list:
    """The chain length and the segments a chain is spread over, chosen by
    measurement: the tile's whole inversion (the points entry's forward
    pass, the inversion of the m/C totals, the backward pass) at each
    layout, every result bit-identical to the path's layout."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK

    rng = np.random.default_rng(SEED + 9)
    xs, ys, cx, _ = tile_points(rng, m, device)
    W = EK.LANES_W

    def fold(C, S):
        kw = dict(chunk_c=C, lanes_w=W, segments=S)
        p_, t_ = EK.mont_fwd_points(xs, ys, cx, **kw)
        i_ = EK.batch_inv_planar(t_)
        return EK.mont_bwd_points(xs, ys, cx, p_, i_, **kw)

    want = fold(EK.TILE_CHUNK_C, EK.mont_segments(EK.TILE_CHUNK_C))
    out = []
    for C, S in ((4, 1), (16, 4), (16, 8), (16, 16), (32, 8), (32, 16),
                 (64, 16)):
        if not torch.equal(fold(C, S), want):
            raise AssertionError(f"tile inversion differs at C={C}, S={S}")
        kw = dict(chunk_c=C, lanes_w=W, segments=S)
        fwd = cuda_ms(lambda: EK.mont_fwd_points(xs, ys, cx, **kw), 20)
        p_, t_ = EK.mont_fwd_points(xs, ys, cx, **kw)
        i_ = EK.batch_inv_planar(t_)
        bwd = cuda_ms(lambda: EK.mont_bwd_points(xs, ys, cx, p_, i_, **kw),
                      20)
        inv = cuda_ms(lambda: EK.batch_inv_planar(t_), 20)
        whole = cuda_ms(lambda: fold(C, S), 20)
        out.append(dict(chunk_c=C, segments=S, seg_len=C // S, fwd_ms=fwd,
                        bwd_ms=bwd, totals=t_.shape[1], totals_inv_ms=inv,
                        tile_inversion_ms=whole))
        log(f"layout [{label}, m={m}]: chains of {C} in {S} segments of "
            f"{C // S}: forward {fwd:.4f} ms, inversion of {t_.shape[1]} "
            f"totals "
            f"{inv:.4f} ms, backward {bwd:.4f} ms, whole {whole:.4f} ms")
    torch.cuda.synchronize()
    return out


def phase_keys(solver, seed: int):
    """The + branch (bucket, disc) streams of one real epoch phase: the
    first T/phases centers of an epoch of a seeded pubkey."""
    from bsgs_tpu_torch.ops import epoch_kernel as EK
    from bsgs_tpu_torch.utils import ecpy

    cfg = solver.cfg
    per = cfg.jobs_per_epoch // solver._phases
    q0 = ecpy.mul((1 << 190) + seed)
    cx, cy, _ = solver._centers_on_device(q0, 0)
    keys = EK.epoch_landing_keys(
        cx[:per].T.contiguous(), cy[:per].T.contiguous(), solver.ox_pl,
        solver.oy_pl, htsz=cfg.htsz, chunk_c=cfg.chunk_c,
        lanes_w=cfg.lanes_w)
    return keys[0].clone(), keys[1].clone()


def plant_members(bucket, disc, dense, gen, every: int = 8):
    """Overwrite every ``every``-th probe with a random slot of the table
    (a member, or an empty slot's 0xFFFFFFFF, which matches too)."""
    import torch

    idx = torch.arange(0, bucket.shape[0], every, device=bucket.device)
    rows = torch.randint(0, dense.shape[0], idx.shape, generator=gen,
                         device=bucket.device)
    cols = torch.randint(0, dense.shape[1], idx.shape, generator=gen,
                         device=bucket.device)
    bucket[idx] = rows.to(torch.int32)
    disc[idx] = dense[rows, cols]
    return bucket, disc


def check_probe(label: str, bucket, disc, dense, reps: int = 20) -> dict:
    """probe_rows against probe_rows_plain on the card, bit-identical, both
    timed. The bound is bytes: each probe reads its row and its 8-byte key
    and writes one byte (the window compares are negligible beside
    them)."""
    import torch

    from bsgs_tpu_torch.ops import probe_kernel as PK

    got = PK.probe_rows(bucket, disc, dense)
    want = PK.probe_rows_plain(bucket, disc, dense)
    torch.cuda.synchronize()
    if got.dtype != torch.bool or got.shape != want.shape:
        raise AssertionError(f"probe {label}: {got.dtype} {got.shape}")
    err = int((got != want).sum())
    if err:
        raise AssertionError(f"probe {label}: kernel differs from its plain "
                             f"version on {err} probes")
    m, window = bucket.shape[0], dense.shape[1]
    hits = int(want.sum())
    if m >= 16 and not 0 < hits < m:
        raise AssertionError(f"probe {label}: one-sided answers ({hits}/{m})")
    ms = cuda_ms(lambda: PK.probe_rows(bucket, disc, dense), reps)
    plain_ms = cuda_ms(lambda: PK.probe_rows_plain(bucket, disc, dense), 2,
                       queued=False)
    bound_ms = 1e3 * m * (4 * window + 9) / HBM_BYTES_PER_S
    log(f"kernel probe_rows [{label}]: bit-identical to plain ({hits} of "
        f"{m} found); {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms by bytes), table "
        f"{dense.numel() * 4 / 2**20:.0f} MiB, window {window}")
    return dict(label=label, m=m, window=window, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, table_mib=dense.numel() * 4 / 2**20)


def check_probe_on_table(label: str, solver, device) -> list:
    """The probe kernel on a solver's own table: one phase's stream of
    real keys with members planted, then m = 16 and an odd length."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    bucket, disc = plant_members(*phase_keys(solver, SEED), solver.baby.dense,
                                 gen)
    dense = solver.baby.dense
    out = [check_probe(f"{label}, one phase's stream", bucket, disc, dense)]
    for m in (16, 5001):
        out.append(check_probe(f"{label}, m={m}", bucket[:m].clone(),
                               disc[:m].clone(), dense))
    return out


def check_probe_synthetic(device, rows: int, window: int, m: int) -> dict:
    """A seeded random table of another row width, half the probes planted
    members: the 512-slot layout (2^18 rows, 512 MiB, well beyond the 50 MB
    L2) and a narrow row that leaves most of a warp's lanes idle."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + window)
    dense = torch.randint(-(1 << 31), 1 << 31, (rows, window), generator=gen,
                          device=device, dtype=torch.int64).to(torch.int32)
    dense[7, window // 2:] = -1
    bucket = torch.randint(0, rows, (m,), generator=gen,
                           device=device).to(torch.int32)
    disc = torch.randint(-(1 << 31), 1 << 31, (m,), generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)
    bucket, disc = plant_members(bucket, disc, dense, gen, every=2)
    return check_probe(f"synthetic window {window}", bucket, disc, dense)


def check_streamed_against_device_build(baby, device) -> None:
    """The streamed build (mirror positions, 32 chunk flushes) of the same
    w=2^26 table must hold exactly what the one-shot build holds: equal
    offsets, and the (bucket, disc, position) of every filled slot, sorted
    stably by (bucket, disc), equal to the CSR arrays entry for entry."""
    import torch

    from bsgs_tpu_torch.models import table as T
    from bsgs_tpu_torch.ops import planar as PL

    t0 = time.time()
    st = T.build_baby_table_streamed(baby.w, baby.htsz, window=baby.window,
                                     positions="mirror", device=device)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    if not torch.equal(st.offsets, baby.offsets):
        raise AssertionError("streamed build: offsets differ")
    filled = st.pos_dense != 0
    if int(filled.sum()) != baby.w:
        raise AssertionError("streamed build: not every baby has a slot")
    rows = torch.arange(st.dense.shape[0], device=device)[:, None]
    keys = ((rows << 32) | PL.u32_value(st.dense))[filled]
    skey, perm = torch.sort(keys, stable=True)
    if not torch.equal(PL.u32_bits(skey & 0xFFFFFFFF), baby.disc_sorted):
        raise AssertionError("streamed build: discs differ from the CSR's")
    if not torch.equal(st.pos_dense[filled][perm], baby.pos_sorted):
        raise AssertionError("streamed build: positions differ from the "
                             "CSR's")
    log(f"streamed build of the w=2^26 table (mirror positions) in "
        f"{t_build:.2f} s: offsets, discs and positions equal the one-shot "
        f"build's, entry for entry")


def profile_scan(solver, pub, pk: int, epochs: int) -> None:
    """Where an epoch's time goes: torch.profiler over a short scan, device
    time by kernel, the device's busy share of the wall time, and the host
    time spent queueing epochs (Solver._dispatch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = solver.cfg
    host = []
    dispatch = solver._dispatch

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = dispatch(*args, **kw)
        host.append(time.perf_counter() - t0)
        return out

    solver._dispatch = timed
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            solver.solve(pub, pk, pk + epochs * cfg.keys_per_epoch - 1,
                         max_epochs=epochs)
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        del solver._dispatch

    rows = device_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    log(f"profile: {epochs} epochs in {wall * 1e3:.2f} ms wall (profiler "
        f"on); device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%); "
        f"host queueing {1e3 * sum(host) / len(host):.2f} ms per epoch")
    for e in rows[:10]:
        us = e.self_device_time_total
        log(f"profile: {us / 1e3 / epochs:8.3f} ms/epoch "
            f"{100 * us / 1e6 / busy:5.1f}% x{e.count // epochs:<4d} "
            f"{e.key[:80]}")


def count_syncs(solver, pub, pk: int, epochs: int, label: str = "",
                **solve_kw) -> int:
    """The host's waits for the device during a scan, by source line, from
    PyTorch's sync debug mode: the solve loop means to wait once per epoch,
    in Solver._collect's int(cnt), plus hit readback when an epoch hits and,
    on a rescan table, the row pulls and matches of verification. Returns
    the number of waits; solve_kw goes to solve (the callbacks)."""
    import torch

    cfg = solver.cfg
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solver.solve(pub, pk, pk + epochs * cfg.keys_per_epoch - 1,
                         max_epochs=epochs, **solve_kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(
        f"{Path(w.filename).parent.name}/{Path(w.filename).name}:{w.lineno}"
        for w in caught if "synchronizing CUDA operation" in str(w.message))
    log(f"syncs{label}: {sum(sites.values())} host waits in {epochs} epochs "
        f"{dict(sites)}")
    return sum(sites.values())


def device_rows(prof):
    """The profiler's device rows (kernels, copies, fills; not the step
    markers of a profiler schedule), most time first."""
    from torch.autograd import DeviceType

    return sorted(
        (e for e in prof.key_averages()
         if getattr(e, "device_type", None) == DeviceType.CUDA
         and not e.key.startswith("ProfilerStep")),
        key=lambda e: e.self_device_time_total, reverse=True)


def timed_parts(parts: dict):
    """Wrap module functions so that each call is timed on the host clock
    from a synchronise to a synchronise: {label: (module, name)} -> a
    context manager yielding {label: [seconds per call]}. The parts then
    run one after another, so their sum exceeds the untouched build's
    wall time by whatever overlap there was."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        took = {label: [] for label in parts}
        saved = []
        for label, (mod, name) in parts.items():
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def timed(*a, _fn=fn, _label=label, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                took[_label].append(time.perf_counter() - t0)
                return out

            setattr(mod, name, timed)
        try:
            yield took
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    return ctx()


def profile_build(w: int, device) -> dict:
    """Where one table build's time goes: the build as the path runs it
    (host clock ending in a synchronise); the same build under
    torch.profiler (device ms by kernel, PyTorch's own kernels included,
    and the device's busy share); and the same build once more with its
    parts timed one by one: the fill's host seed row (ec.host_row), the
    whole first-tile fill (fill_multiples_planar), the tile advances
    (add_const_planar, fill passes included) and the pack (_device_pack)
    or the chunk scatters (_chunk_scatter)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bsgs_tpu_torch.models import solver as S, table as T
    from bsgs_tpu_torch.ops import ec, epoch_kernel as EK

    cfg = S.SolverConfig(w=w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    baby = S.build_table(cfg, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del baby
    torch.cuda.empty_cache()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        baby = S.build_table(cfg, device=device)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    del baby
    torch.cuda.empty_cache()
    rows = device_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    ours = ("mont_", "add_const", "modinv", "epoch_", "probe_rows")
    own_ms = sum(e.self_device_time_total for e in rows
                 if any(k in e.key for k in ours)) / 1e3

    parts = {"seed row": (ec, "host_row"),
             "fill": (EK, "fill_multiples_planar"),
             "tile advance": (EK, "add_const_planar"),
             "pack": (T, "_device_pack"),
             "chunk scatter": (T, "_chunk_scatter")}
    with timed_parts(parts) as took:
        baby = S.build_table(cfg, device=device)
        torch.cuda.synchronize()
    del baby
    torch.cuda.empty_cache()
    label = f"w=2^{w.bit_length() - 1}"
    out = dict(w=w, wall_s=wall, wall_s_profiled=wall_prof,
               device_busy_ms=busy, device_launches=launches,
               own_kernels_ms=own_ms,
               by_kernel=[dict(kernel=e.key[:100], ms=e.self_device_time_total
                               / 1e3, count=e.count) for e in rows[:14]],
               parts={k: dict(calls=len(v), ms_total=1e3 * sum(v))
                      for k, v in took.items()})
    log(f"build profile [{label}]: {wall:.3f} s as the path runs it "
        f"({wall_prof:.3f} s profiled); device busy {busy:.1f} ms "
        f"({100 * busy / 1e3 / wall_prof:.1f}% of the profiled wall), "
        f"{launches} device launches, {own_ms:.1f} ms in the port's own "
        f"kernels, {busy - own_ms:.1f} ms in PyTorch's")
    for e in rows[:14]:
        log(f"build profile [{label}]: {e.self_device_time_total / 1e3:9.3f}"
            f" ms x{e.count:<6d} {e.key[:90]}")
    for k, v in out["parts"].items():
        log(f"build profile [{label}]: part {k}: {v['calls']} calls, "
            f"{v['ms_total']:.2f} ms (each from a synchronise to a "
            f"synchronise)")
    return out


def profile_tile_advance(tile: int, device, calls: int = 8) -> dict:
    """One tile advance (add_const_planar on a filled tile, its output fed
    back as the build does): the host's time to queue it, its wall time
    with the device's, and the device launches it makes under
    torch.profiler, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL
    from bsgs_tpu_torch.utils import ecpy

    xs, ys = EK.fill_multiples_planar(ecpy.mul(1), ecpy.mul(1), tile,
                                      device=device)
    step = ecpy.mul(tile)
    cx = PL.const_col(step[0], device).to(torch.int32)
    cy = PL.const_col(step[1], device).to(torch.int32)
    xs, ys, _, _ = EK.add_const_planar(xs, ys, cx, cy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        xs, ys, _, _ = EK.add_const_planar(xs, ys, cx, cy)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # two warm-up steps: the tracer misses launches made just after it
    # starts; a trace that still comes back without a device event is
    # taken again (at most three times)
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=2, active=calls,
                                       repeat=1)) as prof:
            for i in range(2 + calls):
                xs, ys, _, _ = EK.add_const_planar(xs, ys, cx, cy)
                if i == 1 + calls:
                    torch.cuda.synchronize()
                prof.step()
        rows = device_rows(prof)
        if rows:
            break
        log(f"tile advance [{tile} lanes]: the trace held no device event "
            f"(attempt {attempt + 1}); profiling again")
    per = sum(e.count for e in rows) / calls
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / calls
    out = dict(tile=tile, host_ms=1e3 * host / calls,
               wall_ms=1e3 * wall / calls, device_ms=dev_ms,
               device_launches=per,
               by_kernel=[dict(kernel=e.key[:100], count=e.count / calls,
                               ms=e.self_device_time_total / 1e3 / calls)
                          for e in rows])
    log(f"tile advance [{tile} lanes]: {out['host_ms']:.3f} ms of host "
        f"queueing, {out['wall_ms']:.3f} ms wall, {dev_ms:.3f} ms of device "
        f"time in {per:g} device launches per advance")
    for e in rows[:12]:
        log(f"tile advance [{tile} lanes]: x{e.count / calls:<5g} "
            f"{e.self_device_time_total / 1e3 / calls:8.4f} ms "
            f"{e.key[:90]}")
    return out


def time_residue_scan(device, w: int = 1 << 30) -> float:
    """Seconds of one lookup that survives the hint on a rescan table of
    this w: two row pulls and one residue scan of w/256 points (4 tiles of
    2^20 lanes at w=2^30). The table is a 16-row stand-in holding one
    planted slot; the scan regenerates the real baby stream."""
    import torch

    from bsgs_tpu_torch.models import table as T
    from bsgs_tpu_torch.utils import ecpy

    htsz, window = 4, T.DEVICE_WINDOW
    dense = torch.full((1 << htsz, window), T.DENSE_FILL, dtype=torch.int32,
                       device=device)
    pos_lo = torch.zeros((1 << htsz, window), dtype=torch.int16,
                         device=device)
    pre = ecpy.mul(w + 12345)[0] & ((1 << 64) - 1)
    sh, mk = T._disc_lo_shift(htsz)
    dense[pre >> (64 - htsz), 0] = T._i32(pre >> (32 - htsz))
    pos_lo[pre >> (64 - htsz), 0] = int(T._u16_bits(
        torch.tensor((((pre >> sh) & mk) << 8) | 7)))
    lookup = T.make_strided_lookup(w, dense, pos_lo, htsz, tile=1 << 20)
    lookup(pre)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = lookup(pre)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    if got != [] or lookup.stats["residue_scans"] != 2:
        raise AssertionError(f"residue scan stand-in: {got}, {lookup.stats}")
    log(f"residue scan: one lookup that survives the hint at w=2^"
        f"{w.bit_length() - 1} ({w // 256} points regenerated): "
        f"{took:.4f} s")
    return took


def build_profiles(device) -> dict:
    """Step one of a table build's measurement: both builds profiled, one
    tile advance at each path's tile, one residue scan. Two small builds
    first load every kernel that the builds use, so that no profiled build
    pays for that."""
    from bsgs_tpu_torch.models import table as T

    for build in (T.build_baby_table_device, T.build_baby_table_streamed):
        build(1 << 22, device=device)
    return dict(
        builds=[profile_build(1 << 26, device),
                profile_build(1 << 30, device)],
        tile_advance=[profile_tile_advance(1 << 18, device),
                      profile_tile_advance(1 << 20, device)],
        residue_scan_s=time_residue_scan(device))


def build_times(device) -> dict:
    """The table builds and one residue scan as the paths run them, host
    clock ending in a synchronise, after the same warm-up builds as
    build_profiles: what `chip_smoke.py --builds` prints, to compare two
    trees on one card."""
    import torch

    from bsgs_tpu_torch.models import solver as S, table as T

    for build in (T.build_baby_table_device, T.build_baby_table_streamed):
        build(1 << 22, device=device)
    out = {}
    for w in (1 << 26, 1 << 30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        baby = S.build_table(S.SolverConfig(w=w), device=device)
        torch.cuda.synchronize()
        out[f"build_s_w2^{w.bit_length() - 1}"] = time.perf_counter() - t0
        del baby
        torch.cuda.empty_cache()
    out["residue_scan_s"] = time_residue_scan(device)
    log(f"build times: {out}")
    return out


def read_launches(path: str, totals: dict) -> None:
    """Record the launch counts of the path just driven (the counters were
    set to 0 just before it) and fail if a kernel was not launched."""
    from bsgs_tpu_torch.ops import _cuda

    launches = dict(_cuda.LAUNCHES)
    totals[path] = launches
    log(f"launches on the {path} path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the {path} "
                             f"path: {launches}")
    # every tile advance and fill pass folds once (one forward and one
    # backward pass around one inversion); the epochs launch neither pass
    passes = {launches[k] for k in ("mont_fwd", "mont_bwd", "add_const")}
    if len(passes) != 1:
        raise AssertionError(f"the {path} path's add-const passes do not "
                             f"each fold once: {launches}")


def timed_scans(solver, pub, pk: int, epochs: int, repeats: int,
                residue_scan: bool = False):
    """Scans of a pubkey with no key in range, as bench.py times them:
    host clock around work that ends in a synchronise. Returns the rates
    (giant-steps/s) and the last result. Unless its verification runs a
    residue scan (which generates points), a scan must launch exactly
    LAUNCHES_PER_EPOCH per epoch: the inversion once a phase and no
    Montgomery pass, so a return to a deeper tree fails here."""
    import torch

    from bsgs_tpu_torch.ops import _cuda

    cfg = solver.cfg
    rates = []
    for _ in range(repeats):
        before = dict(_cuda.LAUNCHES)
        t0 = time.time()
        scan = solver.solve(pub, pk, pk + epochs * cfg.keys_per_epoch - 1,
                            max_epochs=epochs)
        torch.cuda.synchronize()
        rates.append(scan.giant_steps / (time.time() - t0))
        if scan.key is not None or scan.epochs != epochs:
            raise AssertionError(f"unexpected scan result {scan}")
        made = {k: n - before[k] for k, n in _cuda.LAUNCHES.items()}
        want = {k: n * epochs for k, n in LAUNCHES_PER_EPOCH.items()}
        if not residue_scan and made != want:
            raise AssertionError(f"launches in {epochs} epochs: {made}, "
                                 f"expected {want}")
    if not residue_scan:
        log(f"launches per epoch in each of these {repeats} scans of "
            f"{epochs} epochs: {LAUNCHES_PER_EPOCH}")
    return rates, scan


def plant_surviving_slot(baby, cfg, q0, m: int):
    """Write into a free slot of the streamed table the disc of giant index
    m's landing with the landing's own extra bits in the hint, so that the
    probe hits there and the hit survives the hint to one residue scan
    (which finds no baby point with that prefix). Returns the landing's
    64-bit prefix and the slot, for undoing it."""
    import torch

    from bsgs_tpu_torch.models import table as T
    from bsgs_tpu_torch.utils import ecpy

    pre = ecpy.sub(q0, ecpy.mul(m * cfg.stride))[0] & ((1 << 64) - 1)
    bucket = pre >> (64 - cfg.htsz)
    free = torch.nonzero(baby.dense[bucket] == T.DENSE_FILL).flatten()
    col = int(free[0])
    sh, mk = T._disc_lo_shift(cfg.htsz)
    baby.dense[bucket, col] = T._i32(pre >> (32 - cfg.htsz))
    baby.pos_lo[bucket, col] = int(T._u16_bits(
        torch.tensor((((pre >> sh) & mk) << 8) | 7)))
    return pre, (bucket, col)


# ---------------------------------------------------------------------------
# The command line (bsgs_tpu_torch.cli), driven in-process


def run_cli(argv, label: str):
    """cli.main(argv) on the card, its output captured: (exit code, stdout,
    stderr, seconds, ending in a synchronise)."""
    import contextlib
    import io

    import torch

    from bsgs_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    log(f"cli [{label}]: exit {rc} in {took:.2f} s; "
        f"{out.getvalue().strip().splitlines()[-1:] or ''}"
        f"{' stderr: ' + err.getvalue().strip() if err.getvalue() else ''}")
    return rc, out.getvalue(), err.getvalue(), took


@contextlib.contextmanager
def watch_cli():
    """Record, in order, what the command line's solves do: each drained
    epoch and its hit records, each batched verification, each checkpoint
    written and each solve's result (SolveResult)."""
    import dataclasses

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.utils import checkpoint as ckpt

    ev = []
    orig = (S.Solver._collect, S.Solver._verify, S.Solver.solve,
            ckpt.Checkpoint.save)

    def collect(self, pub, pk, rec):
        batch, gs = orig[0](self, pub, pk, rec)
        ev.append(("drain", rec[0], len(batch)))
        return batch, gs

    def verify(self, pending, pk, pke):
        ev.append(("verify", len(pending)))
        return orig[1](self, pending, pk, pke)

    def solve(self, *a, **kw):
        res = orig[2](self, *a, **kw)
        ev.append(("result", res))
        return res

    def save(self, path):
        ev.append(("checkpoint", dataclasses.asdict(self)))
        return orig[3](self, path)

    S.Solver._collect, S.Solver._verify, S.Solver.solve = collect, verify, \
        solve
    ckpt.Checkpoint.save = save
    try:
        yield ev
    finally:
        (S.Solver._collect, S.Solver._verify, S.Solver.solve,
         ckpt.Checkpoint.save) = orig


def checkpoints_trail_verification(ev) -> int:
    """Replay watch_cli's events: no checkpoint may name a next epoch past
    an epoch whose hits are still unverified. Returns the mid-scan
    checkpoints seen."""
    unverified, mid = set(), 0
    for e in ev:
        if e[0] == "drain" and e[2]:
            unverified.add(e[1])
        elif e[0] in ("verify", "result"):
            unverified.clear()
        elif e[0] == "checkpoint" and e[1]["next_epoch"]:
            mid += 1
            if unverified and min(unverified) < e[1]["next_epoch"]:
                raise AssertionError(
                    f"checkpoint {e[1]} passes unverified epochs "
                    f"{sorted(unverified)}")
    return mid


def win_line(key: int) -> str:
    from bsgs_tpu_torch.utils import codecs, ecpy

    return f"{key:064x} {codecs.format_pubkey(ecpy.mul(key))}"


def read_win() -> list:
    with open("win.txt") as f:
        return f.read().splitlines()


def cli_w26(path_launches: dict) -> dict:
    """The command line at w=2^26 (htsz 20, N=2^18, T=16), in the current
    directory: a planted compressed pubkey in a range of three epochs;
    --infile with two planted pubkeys and a garbage line, every checkpoint
    recorded; --resume from the recorded checkpoint that stops before the
    second key's epoch (found in fewer drained epochs); --resume refused on
    another --w and on another pubkey (exit 2); --gen-only (build, save,
    reload, spot checks: file size and seconds), then again (the artifact
    verified); an 8-epoch scan of a pubkey with no key in range (the
    progress line's rate); a planted key at --n-offsets 1000 (a narrow
    chain layout). Its launches are the "cli w=2^26" path."""
    import torch

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.ops import _cuda
    from bsgs_tpu_torch.utils import artifacts as A, codecs, ecpy

    rng = random.Random(SEED + 26)
    kpe = S.SolverConfig(w=1 << 26).keys_per_epoch
    pk = 1 << 41
    pke = pk + 3 * kpe - 1
    common = ["--w", 26, "--pk", f"{pk:x}", "--pke", f"{pke:x}"]
    out = {}
    _cuda.reset_launches()

    key = pk + kpe + rng.randrange(kpe)
    with watch_cli() as ev:
        rc, text, _, took = run_cli(
            ["--pub", codecs.format_pubkey(ecpy.mul(key))] + common,
            "planted key, epoch 1")
    res = [e[1] for e in ev if e[0] == "result"]
    if (rc != 0 or f"KEY FOUND: {key:#x}" not in text
            or read_win() != [win_line(key)] or res[0].key != key):
        raise AssertionError(f"cli planted key: {rc} {text[-300:]}")
    out["planted"] = dict(seconds=took, epochs=res[0].epochs)

    keys = (pk + rng.randrange(kpe), pk + 2 * kpe + rng.randrange(kpe))
    Path("pubs.txt").write_text(
        f"{codecs.format_pubkey(ecpy.mul(keys[0]))}\nnot-a-pubkey\n"
        f"{codecs.format_pubkey(ecpy.mul(keys[1]), compressed=False)}\n")
    infile = common + ["--infile", "pubs.txt", "--checkpoint-interval", 0]
    with watch_cli() as ev:
        rc, text, err, took = run_cli(infile, "--infile, 2 keys + garbage")
    res = [e[1] for e in ev if e[0] == "result"]
    if (rc != 0 or read_win() != [win_line(k) for k in keys]
            or "skipping pubkey #1" not in err or len(res) != 2):
        raise AssertionError(f"cli --infile: {rc} {text[-300:]} {err}")
    mid = checkpoints_trail_verification(ev)
    stops = [e[1] for e in ev if e[0] == "checkpoint"
             and e[1]["pub_index"] == 2 and e[1]["next_epoch"]]
    if not stops:
        raise AssertionError("no checkpoint was written in the second scan")
    with open("resume.json", "w") as f:
        json.dump(stops[-1], f)
    out["infile"] = dict(seconds=took, epochs=[r.epochs for r in res],
                         mid_scan_checkpoints=mid,
                         resume_from=stops[-1]["next_epoch"])

    os.unlink("win.txt")
    with watch_cli() as ev:
        rc, text, _, took = run_cli(infile + ["--resume", "resume.json"],
                                    "--resume before the second key")
    res2 = [e[1] for e in ev if e[0] == "result"]
    if (rc != 0 or read_win() != [win_line(keys[1])] or len(res2) != 1
            or res2[0].epochs >= res[1].epochs):
        raise AssertionError(f"cli --resume: {rc} {text[-300:]} {res2}")
    out["resume"] = dict(seconds=took, epochs=res2[0].epochs,
                         epochs_unresumed=res[1].epochs)
    log(f"cli: resumed at pubkey #2, epoch {stops[-1]['next_epoch']}: key "
        f"found after {res2[0].epochs} drained epochs against "
        f"{res[1].epochs} without the checkpoint")

    Path("other.txt").write_text(
        Path("pubs.txt").read_text().splitlines()[0] + "\nnot-a-pubkey\n"
        + f"{codecs.format_pubkey(ecpy.mul(keys[1] + 1))}\n")
    refusals = {}
    for label, argv in (
            ("another --w", infile[:1] + [27] + infile[2:]),
            ("another pubkey", [a if a != "pubs.txt" else "other.txt"
                                for a in infile])):
        rc, text, err, _ = run_cli(argv + ["--resume", "resume.json"],
                                   f"--resume with {label}")
        if rc != 2 or "cannot resume" not in err or "building" in text:
            raise AssertionError(f"cli --resume with {label}: {rc} {err}")
        refusals[label] = err.strip()
    out["refusals"] = refusals

    t_parts = {"build": (S, "build_table"), "save": (A, "save_baby_table"),
               "load": (A, "load_baby_table")}
    with timed_parts(t_parts) as took_parts:
        rc, text, _, took = run_cli(["--gen-only", "--w", 26, "--cache-dir",
                                     "cache"], "--gen-only w=2^26")
    path = A.baby_table_path("cache", 1 << 26, 20)
    if rc != 0 or "finished ok" not in text or not os.path.exists(path):
        raise AssertionError(f"cli --gen-only: {rc} {text[-300:]}")
    size = os.path.getsize(path)
    rc, text, _, took2 = run_cli(["--gen-only", "--w", 26, "--cache-dir",
                                  "cache"], "--gen-only, artifact present")
    if rc != 0 or "verifying artifact" not in text:
        raise AssertionError(f"cli --gen-only again: {rc} {text[-300:]}")
    out["gen_only"] = dict(
        seconds=took, seconds_present=took2, file_bytes=size,
        **{f"{k}_s": sum(v) for k, v in took_parts.items()})
    log(f"cli: w=2^26 artifact {size / 2**20:.1f} MiB (kind device); "
        f"build {sum(took_parts['build']):.3f} s, save "
        f"{sum(took_parts['save']):.3f} s, load with spot checks "
        f"{sum(took_parts['load']):.3f} s; a second --gen-only loaded and "
        f"verified it in {took2:.2f} s")
    os.unlink(path)

    far = (1 << 200) + 777
    rc, text, _, took = run_cli(
        ["--pub", codecs.format_pubkey(ecpy.mul(far)), "--w", 26, "--pk",
         f"{pk:x}", "--pke", f"{pk + 8 * kpe - 1:x}"],
        "8 epochs, no key in range")
    rates = [float(r) * 1e6 for r in re.findall(r"([\d.]+) Mgsteps/s", text)]
    if rc != 0 or "exhausted range" not in text or not rates:
        raise AssertionError(f"cli scan: {rc} {text[-300:]}")
    out["progress_rate"] = rates[-1]

    kpe = S.SolverConfig(w=1 << 26, n_offsets=1000).keys_per_epoch
    key = pk + kpe + rng.randrange(kpe)
    rc, text, _, took = run_cli(
        ["--pub", codecs.format_pubkey(ecpy.mul(key)), "--w", 26,
         "--n-offsets", 1000, "--pk", f"{pk:x}",
         "--pke", f"{pk + 3 * kpe - 1:x}"],
        "--n-offsets 1000 (chains of 8 x 1)")
    if rc != 0 or read_win() != [win_line(key)]:
        raise AssertionError(f"cli --n-offsets 1000: {rc} {text[-300:]}")
    out["n_offsets_1000"] = dict(seconds=took)
    read_launches("cli w=2^26", path_launches)
    torch.cuda.synchronize()
    return out


def cli_w30(path_launches: dict) -> dict:
    """The command line at w=2^30 (streamed, rescan positions, deferred
    verification): a planted key of epoch 1 in a range of three epochs,
    checkpoints written at every callback; none may pass the pooled,
    unverified epoch. Its launches are the "cli w=2^30" path."""
    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.ops import _cuda
    from bsgs_tpu_torch.utils import codecs, ecpy

    rng = random.Random(SEED + 30)
    kpe = S.SolverConfig(w=1 << 30).keys_per_epoch
    pk = 1 << 61
    key = pk + kpe + rng.randrange(kpe)
    _cuda.reset_launches()
    with watch_cli() as ev:
        rc, text, _, took = run_cli(
            ["--pub", codecs.format_pubkey(ecpy.mul(key)), "--w", 30, "--pk",
             f"{pk:x}", "--pke", f"{pk + 3 * kpe - 1:x}",
             "--checkpoint-interval", 0], "w=2^30, planted key, epoch 1")
    res = [e[1] for e in ev if e[0] == "result"]
    if rc != 0 or read_win() != [win_line(key)] or res[0].epochs < 3:
        raise AssertionError(f"cli w=2^30: {rc} {text[-300:]} {res}")
    mid = checkpoints_trail_verification(ev)
    nexts = [e[1]["next_epoch"] for e in ev if e[0] == "checkpoint"
             and e[1]["next_epoch"]]
    verifies = [e for e in ev if e[0] == "verify"]
    if not nexts or max(nexts) > 1 or len(verifies) != 1:
        raise AssertionError(f"cli w=2^30 checkpoints {nexts}, "
                             f"verifications {verifies}")
    log(f"cli: w=2^30 key {key:#x} found after {res[0].epochs} drained "
        f"epochs, verified once at the scan's end; the mid-scan checkpoints "
        f"named next epochs {nexts}: none passed the pooled epoch 1")
    read_launches("cli w=2^30", path_launches)
    return dict(seconds=took, epochs=res[0].epochs, checkpoints=nexts,
                mid_scan_checkpoints=mid)


def cli_tune(mem: dict) -> dict:
    """--tune on the card, and the tuner's estimates of the table's bytes
    and the build's peak held against what phases 3 and 7 measured
    (TUNER_MARGIN); its epoch transients are logged beside the scans'."""
    from bsgs_tpu_torch.utils import tuner

    rc, text, _, _ = run_cli(["--tune"], "--tune")
    if rc != 0 or "suggested: --w" not in text:
        raise AssertionError(f"cli --tune: {rc} {text}")
    log(f"cli --tune:\n{text.rstrip()}")
    out = dict(report=text)
    for w, got in mem.items():
        plan = tuner.plan(w)
        rows = {"table": (plan.est_table_bytes, got["table"]),
                "build peak": (plan.est_build_peak_bytes, got["build_peak"]),
                "epoch transients": (plan.est_transient_bytes,
                                     got["scan_transients"])}
        out[w] = {k: dict(estimate=e, measured=m) for k, (e, m) in
                  rows.items()}
        for k, (e, m) in rows.items():
            log(f"tuner w=2^{w.bit_length() - 1} {k}: estimate "
                f"{e / 2**20:.1f} MiB, measured {m / 2**20:.1f} MiB "
                f"({100 * (e - m) / m:+.1f}%)")
        for k in ("table", "build peak"):
            e, m = rows[k]
            if abs(e - m) > TUNER_MARGIN * m:
                raise AssertionError(
                    f"tuner w=2^{w.bit_length() - 1} {k}: estimate {e} "
                    f"against {m} measured, beyond {TUNER_MARGIN:.0%}")
    # the suggested geometry itself, on this card: a planted key through
    # the command line, its peak held against the tuner's
    import torch

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.utils import codecs, ecpy

    flags = text.split("suggested: ")[1].splitlines()[0].split()
    plan = tuner.plan(int(flags[flags.index("--w") + 1]))
    kpe = S.SolverConfig(w=plan.w).keys_per_epoch
    pk = 1 << 62
    key = pk + kpe + random.Random(SEED + 62).randrange(kpe)
    gc.collect()  # no garbage of earlier phases may be freed in the run
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rc, text, _, took = run_cli(
        flags + ["--pub", codecs.format_pubkey(ecpy.mul(key)), "--pk",
                 f"{pk:x}", "--pke", f"{pk + 3 * kpe - 1:x}"],
        f"the suggested geometry, w={plan.w}")
    peak = torch.cuda.max_memory_allocated() - before
    want = max(plan.est_build_peak_bytes, plan.scan_bytes)
    if rc != 0 or read_win() != [win_line(key)]:
        raise AssertionError(f"cli at the suggested w={plan.w}: {rc} "
                             f"{text[-300:]}")
    if abs(want - peak) > TUNER_MARGIN * peak:
        raise AssertionError(f"suggested w={plan.w}: peak {peak} against "
                             f"the tuner's {want}")
    out["suggested"] = dict(w=plan.w, seconds=took, peak=peak, estimate=want,
                            device_bytes=tuner.device_memory_bytes())
    log(f"tuner: the suggested w={plan.w} (htsz {plan.htsz}) built and "
        f"found a planted key in {took:.1f} s; peak {peak / 2**30:.2f} GiB "
        f"against the tuner's {want / 2**30:.2f} GiB, of "
        f"{tuner.device_memory_bytes() / 2**30:.2f} GiB on the card")
    log(f"tuner: table and build-peak estimates within {TUNER_MARGIN:.0%} "
        f"of the measured bytes at w=2^26 and w=2^30; implied constants: "
        f"BUILD_BYTES_PER_KEY "
        f"{(mem[1 << 26]['build_peak'] - mem[1 << 26]['table']) / 2**26:.2f}"
        f", STREAMED_BUILD_BYTES_PER_BUCKET "
        f"{(mem[1 << 30]['build_peak'] - mem[1 << 30]['table']) / 2**24:.2f}"
        f" (2^24 buckets), "
        f"EPOCH_BYTES_PER_PAIR "
        f"{mem[1 << 26]['scan_transients'] / (16 << 18):.2f} (w=2^26), "
        f"{mem[1 << 30]['scan_transients'] / (16 << 18):.2f} (w=2^30)")
    return out


# ---------------------------------------------------------------------------
# Several cards (bsgs_tpu_torch.parallel): the collective path in a process
# group of one rank on NCCL, and the 4-way partition of a table in one
# process


def mesh_of_one():
    """A process group of one rank on NCCL at a free localhost port, and
    its Mesh on this card."""
    from bsgs_tpu_torch.parallel import mesh as M

    t0 = time.time()
    M.init_distributed(M.free_address(), 1, 0, backend="nccl")
    mesh = M.make_mesh(1)
    log(f"mesh: a group of one rank on {mesh.backend}, {mesh.device}, in "
        f"{time.time() - t0:.2f} s")
    return mesh


def scans_in_turns(solvers: dict, order, pub, pk: int, epochs: int) -> dict:
    """8-epoch (or so) scans of each solver, taken in the given order
    (A, B, B, A), so that two are compared within one run: rates by name."""
    rates = {name: [] for name in solvers}
    for name in order:
        r, _ = timed_scans(solvers[name], pub, pk, epochs=epochs, repeats=1)
        rates[name] += r
    return rates


def mesh_replicated(mesh, solver, path_launches: dict) -> dict:
    """MeshSolver over a replicated w=2^26 table in the group of one: its
    own table and offsets, a planted key of super-epoch 1, counted as the
    "mesh w=2^26" path; then its 8-epoch scans beside the plain Solver's
    (same card, same table geometry, in turns) and its host waits."""
    import torch

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.ops import _cuda
    from bsgs_tpu_torch.parallel import striped
    from bsgs_tpu_torch.utils import ecpy

    cfg = S.SolverConfig(w=1 << 26)
    rng = random.Random(SEED + 126)
    _cuda.reset_launches()
    t0 = time.time()
    base = S.Solver(cfg, baby=S.build_table(cfg, device=mesh.device),
                    device=mesh.device)
    ms = striped.MeshSolver(base, mesh)
    pk = 1 << 41
    key = pk + cfg.keys_per_epoch + rng.randrange(cfg.keys_per_epoch)
    res = ms.solve(ecpy.mul(key), pk, pk + 3 * cfg.keys_per_epoch - 1)
    torch.cuda.synchronize()
    if res.key != key:
        raise AssertionError(f"mesh w=2^26: planted key {key:#x} not found: "
                             f"{res}")
    log(f"mesh w=2^26 replicated: table, offsets and planted key {key:#x} "
        f"of super-epoch {res.epochs - 1} in {time.time() - t0:.2f} s")
    read_launches("mesh w=2^26", path_launches)
    pub = ecpy.mul((1 << 200) + 12345)
    for s in (solver, ms):
        s.solve(pub, pk, pk + cfg.keys_per_epoch - 1, max_epochs=1)
    rates = scans_in_turns({"plain": solver, "mesh": ms},
                           ("plain", "mesh", "mesh", "plain", "plain",
                            "mesh"), pub, pk, 8)
    log(f"mesh w=2^26: 8-epoch scans, giant-steps/s, plain Solver "
        f"{rates['plain']}, MeshSolver (group of one) {rates['mesh']}")
    profile_scan(ms, pub, pk, epochs=4)
    costs = collective_costs(ms, pub, pk, 4)
    waits = count_syncs(ms, pub, pk, epochs=4, label=" (mesh w=2^26)")
    del base, ms
    torch.cuda.empty_cache()
    return dict(rates=rates, collectives=costs,
                host_waits_per_epoch=waits / 4)


def mesh_sharded(mesh, single, path_launches: dict) -> dict:
    """The w=2^30 table built split over the group of one
    (sharded_table.build_sharded_table: rescan positions, lookups through
    the owner's broadcast rows), equal to the single-card streamed table; a
    planted key of epoch 1 found through deferred verification with a slot
    that survives the hint planted in epoch 0, counted as the "mesh w=2^30
    sharded" path; then 8-epoch scans through the all_gather route beside
    the plain Solver's on the single-card table, in turns, and a profile
    of its epoch."""
    import torch

    from bsgs_tpu_torch.models import solver as S, table as T
    from bsgs_tpu_torch.ops import _cuda
    from bsgs_tpu_torch.parallel import sharded_table as ST, striped
    from bsgs_tpu_torch.utils import ecpy

    cfg = S.SolverConfig(w=1 << 30)
    rng = random.Random(SEED + 130)
    _cuda.reset_launches()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    baby = ST.build_sharded_table(cfg, mesh)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - before
    if (baby.shard, baby.n_table_shards) != (0, 1) or not (
            torch.equal(baby.dense, single.baby.dense)
            and torch.equal(baby.pos_lo, single.baby.pos_lo)
            and torch.equal(baby.offsets, single.baby.offsets)):
        raise AssertionError("the table built over the mesh differs from the "
                             "single-card streamed table")
    stats = baby.lookup_fn.stats
    for r in (1, 256, cfg.w, rng.randrange(1, cfg.w)):
        if baby.lookup_positions(ecpy.mul(r)[0]) != [r]:
            raise AssertionError(f"mesh lookup of baby {r}")
    base = S.Solver(cfg, baby=baby, device=mesh.device)
    ms = striped.MeshSolver(base, mesh, shard_baby_table=True)
    pk = 1 << 59
    key = pk + cfg.keys_per_epoch + rng.randrange(cfg.keys_per_epoch)
    q0 = ecpy.sub(ecpy.mul(key), ecpy.mul(pk))
    pre_fp, (row, col) = plant_surviving_slot(baby, cfg, q0, 12345)
    scans_before = stats["residue_scans"]
    t0 = time.time()
    res = ms.solve(ecpy.mul(key), pk, pk + 3 * cfg.keys_per_epoch - 1)
    torch.cuda.synchronize()
    took = time.time() - t0
    scans = stats["residue_scans"] - scans_before
    if res.key != key or res.epochs < 3 or scans < 1 or res.hits_checked < 2:
        raise AssertionError(f"mesh w=2^30: planted key {key:#x}: {res}, "
                             f"{scans} residue scans")
    baby.dense[row, col] = T.DENSE_FILL
    baby.pos_lo[row, col] = 0
    log(f"mesh w=2^30 sharded: built over the group in {t_build:.2f} s "
        f"(peak {peak} B above what was allocated before), equal to the "
        f"single-card table; planted key {key:#x} of epoch 1 found after "
        f"{res.epochs} drained epochs with the slot planted in epoch 0 "
        f"({res.hits_checked} hits checked, {scans} residue scans through "
        f"the broadcast rows, {took:.2f} s)")
    read_launches("mesh w=2^30 sharded", path_launches)
    pub = ecpy.mul((1 << 200) + 12345)
    solvers = {"plain": single, "all_gather": ms}
    for s in solvers.values():
        s.solve(pub, pk, pk + cfg.keys_per_epoch - 1, max_epochs=1)
    rates = scans_in_turns(solvers, ("plain", "all_gather", "all_gather",
                                     "plain", "plain", "all_gather"),
                           pub, pk, 8)
    log(f"mesh w=2^30: 8-epoch scans, giant-steps/s, plain Solver "
        f"{rates['plain']}, sharded all_gather {rates['all_gather']}")
    profile_scan(ms, pub, pk, epochs=4)
    costs = collective_costs(ms, pub, pk, 4)
    waits = count_syncs(ms, pub, pk, epochs=8, label=" (mesh w=2^30)")
    del solvers, ms, base, baby
    torch.cuda.empty_cache()
    return dict(build_s=t_build, build_peak=peak, solve_s=took,
                residue_scans=scans, rates=rates, collectives=costs,
                host_waits_per_epoch=waits / 8)


def collective_costs(ms, pub, pk: int, epochs: int) -> dict:
    """Per epoch of a MeshSolver scan: the collectives it makes, by kind,
    and the host time spent in each call and in the whole probe; and the
    device allocations (cudaMalloc, which makes the host wait for the
    device) the caching allocator made in the scan."""
    import torch

    mesh = ms.mesh
    calls = collections.Counter()
    host = collections.Counter()

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            host[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return call

    kinds = ("all_gather", "all_reduce_max", "broadcast")
    for kind in kinds:
        setattr(mesh, kind, timed(kind, getattr(mesh, kind)))
    probe = ms._probe
    ms._probe = timed("probe", probe)
    stats0 = torch.cuda.memory_stats()
    try:
        ms.solve(pub, pk, pk + epochs * ms.cfg.keys_per_epoch - 1,
                 max_epochs=epochs)
        torch.cuda.synchronize()
    finally:
        ms._probe = probe
        for kind in kinds:
            delattr(mesh, kind)
    stats1 = torch.cuda.memory_stats()
    out = dict(
        calls_per_epoch={k: calls[k] / epochs for k in calls},
        host_ms_per_epoch={k: 1e3 * host[k] / epochs for k in host},
        device_allocs=stats1.get("num_device_alloc", 0)
        - stats0.get("num_device_alloc", 0))
    log(f"collectives: {json.dumps(out)}")
    return out


def phase_streams(solver, seed: int):
    """The three probe streams of one epoch phase as (bucket, disc): its +
    and - landings (members planted in the first) and the epoch's
    centers."""
    import torch

    from bsgs_tpu_torch.models import table as T
    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL
    from bsgs_tpu_torch.utils import ecpy

    cfg = solver.cfg
    per = cfg.jobs_per_epoch // solver._phases
    cx, cy, _ = solver._centers_on_device(ecpy.mul((1 << 190) + seed), 0)
    keys = EK.epoch_landing_keys(
        cx[:per].T.contiguous(), cy[:per].T.contiguous(), solver.ox_pl,
        solver.oy_pl, htsz=cfg.htsz, chunk_c=cfg.chunk_c,
        lanes_w=cfg.lanes_w)
    gen = torch.Generator(device=cx.device)
    gen.manual_seed(seed)
    plus = plant_members(keys[0].clone(), keys[1].clone(), solver.baby.dense,
                         gen)
    hi, lo = PL.x_prefix64(cx.T.long())
    bc, dc = T.bucket_disc(hi[0], lo[0], cfg.htsz)
    return [plus, (keys[2].clone(), keys[3].clone()),
            (PL.u32_bits(bc), PL.u32_bits(dc))]


def partition_w30(single, n: int = 4) -> dict:
    """The w=2^30 table split 4 ways on this card, in one process: each
    shard built in turn (table.build_shard_rows: the whole stream
    generated, its rows scattered), equal bit for bit to those rows of
    the single-card streamed table (dense, hint, counts), seconds and peak
    each; then one phase's three probe streams, split over 4 simulated
    ranks, through both routes' tensor functions with the exchanges made
    by hand, equal bit for bit to probe_rows on the whole table."""
    import torch

    from bsgs_tpu_torch.models import table as T
    from bsgs_tpu_torch.ops import planar as PL, probe_kernel as PK
    from bsgs_tpu_torch.parallel import sharded_table as ST

    cfg, whole = single.cfg, single.baby
    bps = (1 << cfg.htsz) // n
    counts = torch.diff(PL.u32_value(whole.offsets))
    entries = counts.view(n, bps).sum(1).cpu().numpy()
    specs, builds = [], []
    for s in range(n):
        rows = slice(s * bps, (s + 1) * bps)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        dense, hint, cnt = T.build_shard_rows(cfg.w, cfg.htsz, n, s,
                                              window=cfg.window,
                                              device=whole.dense.device)
        torch.cuda.synchronize()
        took = time.time() - t0
        peak = torch.cuda.max_memory_allocated() - before
        if not (torch.equal(dense, whole.dense[rows])
                and torch.equal(hint, whole.pos_lo[rows])
                and torch.equal(cnt, counts[rows])):
            raise AssertionError(f"shard {s} of {n} differs from rows "
                                 f"{rows} of the single-card table")
        builds.append(dict(seconds=took, peak=peak,
                           dense_bytes=dense.numel() * 4,
                           hint_bytes=hint.numel() * 2))
        del hint
        specs.append(ST.ShardedTableSpec(cfg.htsz, cfg.window, n, s, dense,
                                         entries))
    log(f"partition: {n} shards of the w=2^30 table, each equal to its rows "
        f"of the single-card table: {json.dumps(builds)}")
    routes = []
    for label, (bucket, disc) in zip(("+ landings", "- landings",
                                      "centers"), phase_streams(single,
                                                                SEED)):
        want = PK.probe_rows(bucket, disc, whole.dense)
        bs, ds = list(bucket.chunk(n)), list(disc.chunk(n))
        rec = dict(stream=label, m=bucket.shape[0], found=int(want.sum()))
        for route, fn in (("all_gather", ST.probe_all_gather_in_process),
                          ("all_to_all", ST.probe_all_to_all_in_process)):
            got = torch.cat(fn(bs, ds, specs))
            if not torch.equal(got, want):
                raise AssertionError(f"{route} over {n} shards differs from "
                                     f"the whole table's probe on the "
                                     f"{label} stream")
            rec[f"{route}_ms"] = cuda_ms(lambda: fn(bs, ds, specs), 5,
                                         queued=False)
        rec["whole_ms"] = cuda_ms(
            lambda: PK.probe_rows(bucket, disc, whole.dense), 5,
            queued=False)
        routes.append(rec)
    log(f"partition: both routes over {n} shards equal the whole table's "
        f"probe on one phase's three streams (ms for all {n} ranks' shares "
        f"in one process, host time included): {json.dumps(routes)}")
    del specs
    torch.cuda.empty_cache()
    return dict(builds=builds, routes=routes)


def check_hits_above_2_31(device) -> None:
    """The hit compaction at indices past 2^31 (a probe space of
    2^31 + 64): its int32 bits read back as the uint32 indices."""
    import torch

    from bsgs_tpu_torch.models import giant as G

    m = torch.zeros((1 << 31) + 64, dtype=torch.bool, device=device)
    m[[5, (1 << 31) + 5]] = True
    idxs, cnt = G._masks_to_hits([m[:1 << 30], m[1 << 30:]], 4)
    got = G.hit_indices(idxs.cpu().numpy()).tolist()
    if int(cnt[0]) != 2 or got != [5, (1 << 31) + 5]:
        raise AssertionError(f"hits past 2^31: {got}, count {int(cnt[0])}")
    del m
    torch.cuda.empty_cache()
    log("hits past 2^31: the compaction's int32 bits read back as "
        f"{got}")


def cli_mesh(path_launches: dict) -> dict:
    """python -m bsgs_tpu_torch.cli --devices 1 --shard-table --w 30 in the
    current directory: the command line starts and closes its own group of
    one rank, splits the single-card table into one shard and probes it
    through the collective route; a planted key of epoch 1. Counted as the
    "cli --shard-table w=2^30" path."""
    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.ops import _cuda
    from bsgs_tpu_torch.utils import codecs, ecpy

    rng = random.Random(SEED + 31)
    kpe = S.SolverConfig(w=1 << 30).keys_per_epoch
    pk = 1 << 62
    key = pk + kpe + rng.randrange(kpe)
    _cuda.reset_launches()
    rc, text, err, took = run_cli(
        ["--pub", codecs.format_pubkey(ecpy.mul(key)), "--w", 30, "--pk",
         f"{pk:x}", "--pke", f"{pk + 3 * kpe - 1:x}", "--devices", 1,
         "--shard-table"], "--devices 1 --shard-table, w=2^30")
    if rc != 0 or read_win() != [win_line(key)] or "(rank 0 of 1)" not in \
            text:
        raise AssertionError(f"cli --shard-table: {rc} {text[-400:]} "
                             f"{err[-400:]}")
    read_launches("cli --shard-table w=2^30", path_launches)
    return dict(seconds=took)


def check_layouts(device) -> dict:
    """Which chain layouts the epoch kernels take: one phase (T=4,
    N=4096) under each layout, its key plane equal to the main layout's
    (checked against the plain versions in check_kernels) and, for two
    narrow layouts, to the plain versions on the CPU."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK

    rng = np.random.default_rng(SEED + 11)
    T, N = 4, 4096
    planes = [random_planes(rng, 16, m, device) for m in (N, N, T, T)]
    ox, oy, cx, cy = planes
    ox[:, 17] = cx[:, 1]  # an exact lane
    want = EK.epoch_landing_keys(cx, cy, ox, oy, htsz=20)
    cpu = [p.cpu() for p in planes]
    out = {}
    for c, w in ((16, 256), (16, 128), (16, 64), (16, 16), (8, 32), (8, 1),
                 (4, 4), (2, 2), (1, 1)):
        got = EK.epoch_landing_keys(cx, cy, ox, oy, htsz=20, chunk_c=c,
                                    lanes_w=w)
        ok = torch.equal(got, want)
        if ok and (c, w) in ((8, 1), (1, 1)):
            plain = EK.epoch_landing_keys(cpu[2], cpu[3], cpu[0], cpu[1],
                                          htsz=20, chunk_c=c, lanes_w=w)
            ok = torch.equal(got.cpu(), plain)
        out[f"{c}x{w}"] = ok
    log(f"chain layouts (chunk_c x lanes_w) the epoch kernels take, key "
        f"plane equal: {out}")
    if not all(out.values()):
        raise AssertionError(f"a chain layout gave another key plane: {out}")
    return out


def cost_of_128_jobs(solver, pk: int) -> dict:
    """What T=128 costs per epoch against T=16 on the main path's table:
    the host's time for an epoch's centers (ec.host_row, one exact addition
    a center) and 3-epoch scans of a pubkey with no key in range; then a
    profile of T=128's epochs (device time by kernel, busy share)."""
    import dataclasses

    import torch

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.utils import ecpy

    pub = ecpy.mul((1 << 201) + 99)
    q0 = ecpy.sub(pub, ecpy.mul(pk))
    out = {}
    for t in (16, 128):
        cfg = dataclasses.replace(solver.cfg, jobs_per_epoch=t)
        s = S.Solver(cfg, baby=solver.baby, device=solver.device)
        t0 = time.perf_counter()
        for e in range(4):
            s.epoch_centers(q0, e * t, t)
        centers_ms = 1e3 * (time.perf_counter() - t0) / 4
        s.solve(pub, pk, pk + cfg.keys_per_epoch - 1, max_epochs=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = s.solve(pub, pk, pk + 3 * cfg.keys_per_epoch - 1, max_epochs=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[t] = dict(centers_ms=centers_ms, epoch_ms=1e3 * wall / 3,
                      rate=res.giant_steps / wall)
        log(f"T={t}: centers {centers_ms:.2f} ms of host time per epoch; "
            f"3-epoch scan {1e3 * wall / 3:.2f} ms per epoch, "
            f"{res.giant_steps / wall:.1f} giant-steps/s")
        if t == 128:
            profile_scan(s, pub, pk, epochs=3)
    return out



def main() -> int:
    # one card: on a host with several, use only the first visible one
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from bsgs_tpu_torch.models import solver as S, table as T
        from bsgs_tpu_torch.ops import _cuda
        from bsgs_tpu_torch.parallel import mesh as pmesh
        from bsgs_tpu_torch.utils import checkpoint as ckpt, ecpy
    except ImportError as e:
        print(f"chip_smoke: the bsgs_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    if torch.cuda.device_count() != 1:
        raise AssertionError(f"{torch.cuda.device_count()} cards visible")
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.time()

    # 1. build
    took, libs = build_kernels()
    log(f"phase 1: kernels built in {took:.1f} s")
    torch.cuda.synchronize()
    if sys.argv[1:] == ["--builds"]:
        print(json.dumps(build_times(device)))
        print(card)
        return 0
    resources = mont_resources(libs)

    # 2. each epoch and table kernel against its plain version
    records = check_kernels(device, "w=2^26 shapes", htsz=20,
                            m_tab=1 << 18, time_trees=True)
    records["fermat"]["widths"] = check_inversion(
        device, (2048, 16384, 131072))
    records.update(check_mont(device, 1 << 18, "w=2^26 shapes"))
    for name in ("mont_fwd", "mont_bwd"):
        records[name]["resources"] = {
            k: v for k, v in resources.items() if k.startswith(name)}
    records["mont_fwd"]["layouts"] = sweep_mont(device, 1 << 18,
                                                "w=2^26 tile")
    torch.cuda.synchronize()

    # 3-4. the main path, counted: table build, solver set-up, planted solve
    path_launches = {}
    mem = {}  # w -> device bytes measured: table, build peak, scan transients
    cfg = S.SolverConfig(w=1 << 26)
    _cuda.reset_launches()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    baby = S.build_table(cfg, device=device)
    torch.cuda.synchronize()
    t_table = time.time() - t0
    stats = T.table_stats(baby)
    mem[cfg.w] = dict(table=torch.cuda.memory_allocated() - before,
                      build_peak=torch.cuda.max_memory_allocated() - before)
    log(f"phase 3: w=2^26 table built in {t_table:.2f} s (peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the "
        f"table holds {mem[cfg.w]['table']} B, the build peaked "
        f"{mem[cfg.w]['build_peak']} B above what was allocated before "
        f"it); {stats}")
    torch.cuda.reset_peak_memory_stats()
    if stats.entries != cfg.w or stats.max_bucket > cfg.window:
        raise AssertionError(f"bad table: {stats}")
    rng = random.Random(SEED)
    for r in (1, cfg.w, rng.randrange(1, cfg.w)):
        if r not in baby.lookup_positions(ecpy.mul(r)[0]):
            raise AssertionError(f"baby {r} missing from the table")

    t0 = time.time()
    solver = S.Solver(cfg, baby=baby, device=device)
    torch.cuda.synchronize()
    log(f"phase 3: {cfg.n_offsets} giant offsets filled and spot-checked "
        f"in {time.time() - t0:.2f} s")

    pk = 1 << 40
    key = pk + cfg.keys_per_epoch + rng.randrange(cfg.keys_per_epoch)
    t0 = time.time()
    res = solver.solve(ecpy.mul(key), pk, pk + 3 * cfg.keys_per_epoch - 1)
    torch.cuda.synchronize()
    if res.key != key:
        raise AssertionError(f"planted key {key:#x} not found: {res}")
    log(f"phase 4: planted key {key:#x} found in epoch {res.epochs - 1} "
        f"({res.giant_steps} giant steps, {res.hits_checked} hits checked, "
        f"{time.time() - t0:.2f} s)")
    read_launches("w=2^26", path_launches)

    # 5. the probe kernel against its plain version (launches made here and
    # below count for no path)
    probe = check_probe_on_table("w=2^26 table", solver, device)
    probe.append(check_probe_synthetic(device, 1 << 18, 512, 1 << 18))
    probe.append(check_probe_synthetic(device, 1 << 12, 20, 4099))
    check_streamed_against_device_build(baby, device)
    torch.cuda.synchronize()

    # 6. throughput: 8-epoch scans with no key in range
    torch.cuda.reset_peak_memory_stats()
    pub = ecpy.mul((1 << 200) + 12345)
    solver.solve(pub, pk, pk + cfg.keys_per_epoch - 1, max_epochs=1)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    rates, scan = timed_scans(solver, pub, pk, epochs=8, repeats=3)
    mem[cfg.w]["scan_transients"] = torch.cuda.max_memory_allocated() - held
    log(f"phase 6: 8-epoch scans of {scan.giant_steps} giant steps: "
        f"{', '.join(f'{r:.1f}' for r in rates)} giant-steps/s "
        f"(best {max(rates):.1f}) on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{mem[cfg.w]['scan_transients']} B above the table and offsets")
    profile_scan(solver, pub, pk, epochs=4)
    waits = count_syncs(solver, pub, pk, epochs=4)
    with tempfile.TemporaryDirectory() as tmp:
        writer = ckpt.CheckpointWriter(os.path.join(tmp, "cw.json"), "fp",
                                       0.0)
        lines = []
        waits_cb = count_syncs(
            solver, pub, pk, epochs=4, label=" (progress, on_epoch set)",
            on_epoch=lambda e, st: writer.maybe_write(0, "x", e + 1, st),
            progress=lambda done, total, st, dt: lines.append(
                f"epoch {done}/{total} {st / dt / 1e6:.2f} Mgsteps/s"))
    if waits_cb != waits or len(lines) != 4:
        raise AssertionError(f"callbacks: {waits_cb} host waits against "
                             f"{waits}, {len(lines)} progress lines")
    torch.cuda.synchronize()

    # the command line at w=2^26, in a scratch directory: its own table,
    # solves, checkpoints, resume, artifact, progress line
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            cli_out = dict(w26=cli_w26(path_launches))
        finally:
            os.chdir(here)
    log(f"cli: progress-line rate {cli_out['w26']['progress_rate']:.1f} "
        f"giant-steps/s (8 epochs through cli.main) beside phase 6's "
        f"{', '.join(f'{r:.1f}' for r in rates)} (Solver.solve) in this run; "
        f"host waits per epoch with the callbacks {waits_cb / 4:g}, without "
        f"{waits / 4:g}")
    cli_out["layouts"] = check_layouts(device)
    cli_out["jobs_128"] = cost_of_128_jobs(solver, pk)
    torch.cuda.synchronize()

    # the parallel layer in a group of one rank on NCCL: MeshSolver over a
    # replicated w=2^26 table, its scans beside the plain Solver's
    mesh = mesh_of_one()
    mesh_out = dict(w26=mesh_replicated(mesh, solver, path_launches))
    torch.cuda.synchronize()

    # 7. the streamed path: w=2^30, rescan positions, deferred verification
    del solver, baby
    torch.cuda.empty_cache()
    cfg = S.SolverConfig(w=1 << 30)
    if (cfg.htsz, S.VERIFY_DEFER_EPOCHS) != (24, 64):
        raise AssertionError(f"unexpected big-w defaults: {cfg}")
    # this path gives the six kernels other inputs: 24 bucket bits in the
    # key plane, and 2^20-lane tiles in the build and the residue scans
    records_big = check_kernels(device, "w=2^30 shapes", htsz=cfg.htsz,
                                m_tab=1 << 20, time_trees=False)
    records_big.update(check_mont(device, 1 << 20, "w=2^30 shapes"))
    records["mont_fwd"]["layouts_w30"] = sweep_mont(device, 1 << 20,
                                                    "w=2^30 tile")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    baby = S.build_table(cfg, device=device)
    torch.cuda.synchronize()
    t_table = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    mem[cfg.w] = dict(table=torch.cuda.memory_allocated() - before,
                      build_peak=torch.cuda.max_memory_allocated() - before)
    stats = T.table_stats(baby)
    log(f"phase 7: w=2^30 streamed table built in {t_table:.2f} s (peak "
        f"device memory {peak:.2f} GiB; dense "
        f"{baby.dense.numel() * 4 / 2**30:.0f} GiB + hint "
        f"{baby.pos_lo.numel() * 2 / 2**30:.0f} GiB); {stats}")
    if (stats.entries != cfg.w or stats.max_bucket > cfg.window
            or baby.lookup_fn is None or baby.pos_lo.dtype != torch.int16):
        raise AssertionError(f"bad streamed table: {stats}")
    t0 = time.time()
    members = (1, 256, cfg.w, rng.randrange(1, cfg.w))
    for r in members:
        got = baby.lookup_positions(ecpy.mul(r)[0])
        if got != [r]:
            raise AssertionError(f"lookup of baby {r} gave {got}")
    if baby.lookup_positions(ecpy.mul(cfg.w + 12345)[0]) != []:
        raise AssertionError("a non-member has a position")
    lstats = baby.lookup_fn.stats
    log(f"phase 7: positions of {members} exact and a non-member absent in "
        f"{time.time() - t0:.2f} s ({lstats['residue_scans']} residue scans "
        f"of {cfg.w // 256} points)")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    solver = S.Solver(cfg, baby=baby, device=device)
    torch.cuda.synchronize()
    log(f"phase 7: {cfg.n_offsets} giant offsets filled and spot-checked "
        f"in {time.time() - t0:.2f} s")
    pk = 1 << 60
    key = pk + cfg.keys_per_epoch + rng.randrange(cfg.keys_per_epoch)
    before = dict(lstats)
    t0 = time.time()
    res = solver.solve(ecpy.mul(key), pk, pk + 3 * cfg.keys_per_epoch - 1)
    torch.cuda.synchronize()
    if res.key != key or res.epochs < 3:
        raise AssertionError(f"planted key {key:#x} not found through "
                             f"deferred verification: {res}")
    log(f"phase 7: planted key {key:#x} of epoch 1 found after "
        f"{res.epochs} drained epochs, verification deferred to the scan's "
        f"end ({res.giant_steps} giant steps, {res.hits_checked} hits "
        f"checked, {lstats['residue_scans'] - before['residue_scans']} "
        f"residue scans, {time.time() - t0:.2f} s)")
    read_launches("w=2^30 streamed", path_launches)

    probe_big = check_probe_on_table("w=2^30 table", solver, device)
    torch.cuda.synchronize()

    pub = ecpy.mul((1 << 200) + 12345)
    solver.solve(pub, pk, pk + cfg.keys_per_epoch - 1, max_epochs=1)
    torch.cuda.synchronize()
    before = dict(lstats)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rates, scan = timed_scans(solver, pub, pk, epochs=32, repeats=2)
    mem[cfg.w]["scan_transients"] = torch.cuda.max_memory_allocated() - held
    log(f"phase 7: 32-epoch scans of {scan.giant_steps} giant steps at "
        f"w=2^30: {', '.join(f'{r:.1f}' for r in rates)} giant-steps/s "
        f"(best {max(rates):.1f}) on {card}; per scan "
        f"{scan.hits_checked} hits checked; over both scans "
        f"{lstats['lookups'] - before['lookups']} lookups, "
        f"{lstats['rejected'] - before['rejected']} slots rejected by the "
        f"hint's extra bits, "
        f"{lstats['residue_scans'] - before['residue_scans']} residue "
        f"scans; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_scan(solver, pub, pk, epochs=4)
    count_syncs(solver, pub, pk, epochs=32)
    torch.cuda.synchronize()

    # the same scans with one hit that survives the hint: a planted slot in
    # epoch 10, verified with the pool at the scan's end by one residue scan
    q0 = ecpy.sub(pub, ecpy.mul(pk))
    m_fp = 10 * cfg.jobs_per_epoch * cfg.jobs_span + 12345
    pre_fp, (fp_row, fp_col) = plant_surviving_slot(baby, cfg, q0, m_fp)
    before = dict(lstats)
    t0 = time.time()
    if baby.lookup_fn(pre_fp) != []:
        raise AssertionError("the planted slot resolved to a position")
    t_lookup = time.time() - t0
    if lstats["residue_scans"] - before["residue_scans"] != 1:
        raise AssertionError(f"planted slot not scanned: {lstats}")
    before = dict(lstats)
    rates_fp, scan_fp = timed_scans(solver, pub, pk, epochs=32, repeats=2,
                                    residue_scan=True)
    scans_fp = lstats["residue_scans"] - before["residue_scans"]
    if (scan_fp.hits_checked != scan.hits_checked + 1
            or scans_fp != len(rates_fp)):
        raise AssertionError(
            f"planted slot: {scan_fp.hits_checked} hits checked against "
            f"{scan.hits_checked} without it, {scans_fp} residue scans")
    log(f"phase 7: one lookup that survives the hint (two row pulls and "
        f"one residue scan of {cfg.w // 256} points): {t_lookup:.3f} s; "
        f"32-epoch scans with that slot planted in epoch 10: "
        f"{', '.join(f'{r:.1f}' for r in rates_fp)} giant-steps/s against "
        f"{', '.join(f'{r:.1f}' for r in rates)} without it; per scan "
        f"{scan_fp.hits_checked} hits checked, 1 residue scan, at the "
        f"scan's end")
    baby.dense[fp_row, fp_col] = T.DENSE_FILL
    baby.pos_lo[fp_row, fp_col] = 0
    torch.cuda.synchronize()

    # the parallel layer at w=2^30: the table built over the group of one
    # and scanned through the all_gather route, the 4-way partition in one
    # process, and hit indices past 2^31
    mesh_out["w30"] = mesh_sharded(mesh, solver, path_launches)
    mesh_out["partition"] = partition_w30(solver)
    check_hits_above_2_31(device)
    pmesh.close()
    log(f"mesh: {json.dumps(mesh_out)}")
    torch.cuda.synchronize()

    # the command line at w=2^30 (on one card, and through the mesh path
    # with --devices 1 --shard-table), and the tuner against what was
    # measured
    del solver, baby
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            cli_out["w30"] = cli_w30(path_launches)
            cli_out["mesh"] = cli_mesh(path_launches)
            cli_out["tune"] = cli_tune(mem)
        finally:
            os.chdir(here)
    log(f"cli: {json.dumps(cli_out, default=str)}")
    torch.cuda.empty_cache()

    # 8. where a table build's time goes: both builds profiled, one tile
    # advance at each path's tile (four launches and nothing else), one
    # residue scan
    builds = build_profiles(device)
    for adv in builds["tile_advance"]:
        names = [r["kernel"] for r in adv["by_kernel"]]
        if adv["device_launches"] != 4 or len(names) != 4 or not all(
                sum(k in n for n in names) == 1 for k in (
                    "mont_fwd_kernel", "modinv_kernel", "mont_bwd_kernel",
                    "add_const_kernel")):
            raise AssertionError(
                f"a tile advance of {adv['tile']} lanes made "
                f"{adv['device_launches']} device launches: "
                f"{adv['by_kernel']}")
    log(f"builds: {json.dumps(builds)}")

    # 9. the record
    main_stream, big_stream = probe[0], probe_big[0]
    records["probe_rows"] = dict(
        name="probe_rows", route="cuda",
        source="bsgs_tpu_torch/csrc/probe_kernels.cu",
        replaces=TPU_KERNEL["probe_rows"], launches=0, max_abs_err=0,
        ms=main_stream["ms"], plain_ms=main_stream["plain_ms"],
        bound_ms=main_stream["bound_ms"], bound_by="bytes",
        library_ms=None, bound_ms_packed=main_stream["bound_ms"],
        bound_by_packed="bytes", ms_w30_table=big_stream["ms"],
        plain_ms_w30_table=big_stream["plain_ms"],
        shapes=probe + probe_big)
    for name, rec in records_big.items():
        records[name]["w30_shapes"] = {
            k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "bound_ms_packed")}
    for name in _cuda.KERNELS:
        records[name]["launches"] = sum(
            counts[name] for counts in path_launches.values())
        records[name]["launches_by_path"] = {
            path: counts[name] for path, counts in path_launches.items()}
    log(f"whole run: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [records[k] for k in _cuda.KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
