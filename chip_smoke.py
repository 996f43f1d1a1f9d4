#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths once on one GPU.

    python3 chip_smoke.py             # the whole run below
    python3 chip_smoke.py --builds    # only the two builds and a residue
                                      # scan, timed, to compare two trees
    python3 chip_smoke.py --epoch-bwd # only the build, phase 1 and
                                      # epoch_bwd's study (the parent's
                                      # kernel and the sweep), as JSON
    python3 chip_smoke.py --probe     # only the build, the w=2^26 table
                                      # and the probe's study (the
                                      # parent's kernel and the layouts),
                                      # as JSON
    python3 chip_smoke.py --packed    # only the build and the packed
                                      # layout's study (the parent's
                                      # kernels on limb planes against the
                                      # packed ones), as JSON

Phases, each followed by torch.cuda.synchronize(); any failure exits
nonzero:

1. build the CUDA kernels of bsgs_tpu_torch/csrc with nvcc (sm_90a) and,
   beside them, a side library of one kernel per field operation
   (SIDE_SRC); read from the build each field operation's SASS by pipe and
   the inversion's, which every bound counts (the products on the
   multiplier pipe, an IMAD.WIDE at WIDE_ISSUES, which pipe_probe checks),
   and the Montgomery kernels' and epoch_bwd's registers and spills; hold
   the field operations against Python's integers on edge values, and
   epoch_bwd against its plain version at both paths' shapes, T=32 and
   narrow ones. With --epoch-bwd the side library also holds the study
   (STUDY_SRC): the parent's epoch_bwd (schoolbook multiplies) and the
   layouts of the sweep, held to the same and timed in turns against the
   pipe-counted bound;
2. run each of the six epoch and table kernels and its plain PyTorch
   version on the card at the main path's shapes and require bit-identical
   outputs, timing both (the kernels of packed planes, epoch_fwd, epoch_bwd,
   add_const and the Montgomery points entry, also equal, unpacked, to the
   limb-plane plain versions; epoch_fwd's and add_const's registers read,
   the run failing if either spills); hold the inversion kernel at 2,048,
   16,384 and
   131,072 lanes too (edge values planted) against the exponentiation and
   against the plain version of its own algorithm, and require
   x * inv(x) == 1 at the widest; time one epoch phase at chain lengths 8
   and 16 with the totals inverted after one fold and unfolded, and
   require the same key plane from each; hold both entries of the two
   Montgomery kernels against the serial and the segmented plain versions
   at the table tile (doubling lanes planted, and a ragged width) and
   time the tile's inversion under several chain layouts;
3. build the w=2^26 baby table (htsz=20, 128-slot rows, tile 2^18) and
   check in one pass that its row lengths are the diff of its offsets with
   FILL past them (as for every table built below);
4. solve a planted key in the second epoch at N=2^18, T=16, 4 phases,
   3 epochs in flight; read the launch counts of phases 3-4;
5. run the probe kernel and its plain version on that table with the
   keys of a real epoch phase plus planted members and 0xFFFFFFFF discs
   (m = 2^20, 16 and an odd length) and on synthetic 512-slot and 20-slot
   tables of random row lengths (full and empty rows, real 0xFFFFFFFF
   entries), bit-identical to each other and to the whole-row probe (the
   JAX package's), timed against the bytes of the occupied sectors and of
   whole rows; build the same table streamed and require the one-shot
   build's entries and row lengths, one for one;
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
   then the paths beside the fused epoch: the row-major field and EC
   ops on the card against the CPU, bit for bit; the command line at
   --w 26 --n-offsets 262143, an N that no chain layout fits, solved
   through the unfused epoch, whose 8-epoch scans are timed (launches
   per epoch asserted, peak memory, a profile); one epoch at N=2^18
   through both epochs, the same hit records; cross-epoch pipelining at
   the main path's shapes (a planted key, 8-epoch scans in turns with the
   direct solver, profiles of both with the overlap of the two streams);
   MeshSolver over the unfused epoch, replicated and sharded;
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
9. print the kernels' JSON line (every kernel of a path launched on it:
   the two solves, the command line's two, the two MeshSolver paths, the
   command line's --shard-table path, and the unfused command line, the
   pipelined solve and the two unfused MeshSolver paths, which launch no
   epoch kernel where the epoch is unfused), the card's name and power
   limit, and the result line.

Each path's launches must show one forward and one backward Montgomery
pass per add-const pass: a tile advance or fill pass folds once, and
only the unfused and pipelined epochs add folds of their own.

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
# two 32-bit integer pipes of 132 SMs at 1.98 GHz. The multiplier pipe
# (IMAD forms; the bounds charge it the products alone, an IMAD.WIDE at
# WIDE_ISSUES) and the other integer pipe (adds, logic, shifts, selects,
# compares) each take 64 lanes an SM a clock; the SM's 4 schedulers issue
# 128 lanes a clock over both.
HBM_BYTES_PER_S = 3.35e12
# A field element's bytes: the function's own floor counts 32 (what the
# packed planes move); the (16, M) int32 limb planes move 64, half of them
# zero (bound_ms_planes in the records).
ELEM_BYTES = 32
PLANE_ELEM_BYTES = 64
MUL_PIPE_PER_S = 132 * 64 * 1.98e9
INT_ISSUE_PER_S = 2 * MUL_PIPE_PER_S
P_INT = 2**256 - 2**32 - 977
# cycles of the spin kernel that cuda_ms queues launches behind, and that
# cuda_ms_cold queues each launch behind after its flush
QUEUE_CYCLES = 20_000_000
COLD_CYCLES = 2_000_000
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

# The same for the unfused epoch at N = UNFUSED_N, T=16 (its T*N lanes'
# denominators padded to 2^22 fold twice in chains of 16 x 256, then one
# inversion; one probe of the whole stream), and for the pipelined epoch at
# N=2^18, T=16 (one phase: its 2^18 chain totals fold once; two landing
# probes and the centers' probe of the previous epoch).
UNFUSED_N = (1 << 18) - 1
LAUNCHES_PER_EPOCH_UNFUSED = {"epoch_fwd": 0, "epoch_bwd": 0, "mont_fwd": 2,
                              "mont_bwd": 2, "fermat": 1, "add_const": 0,
                              "probe_rows": 1}
LAUNCHES_PER_EPOCH_PIPELINED = {"epoch_fwd": 1, "epoch_bwd": 1,
                                "mont_fwd": 1, "mont_bwd": 1, "fermat": 1,
                                "add_const": 0, "probe_rows": 3}
# the kernels a path whose epochs are unfused launches (its table build
# and offsets' fill add-const passes, their folds and inversions, and the
# probe): the epoch kernels are not among them
UNFUSED_KERNELS = ("mont_fwd", "mont_bwd", "fermat", "add_const",
                   "probe_rows")
# what the port's own kernels' names hold in a profiler's trace
OWN_KERNEL_SYMBOLS = ("mont_", "add_const", "modinv", "epoch_", "probe_rows")

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


def spun_launch(fn) -> tuple:
    """Events around fn() queued behind a spin kernel of COLD_CYCLES (about
    1 ms, which touches no memory), so that they time the device and not
    the host's Python between the two records: a wrapper's tens of
    microseconds on a busy host would otherwise show as device idle."""
    import torch

    torch.cuda._sleep(COLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    return start, end


def cuda_ms_cold(fn, reps: int, flush_bytes: int = 1 << 28) -> float:
    """Mean device time of fn() with the L2 cold: before each launch a read
    of flush_bytes (five times the 50 MB L2) evicts what the last one left
    and leaves no dirty line to write back, and events time the launch
    alone (spun_launch)."""
    import torch

    buf = torch.ones(flush_bytes, dtype=torch.uint8, device="cuda")
    pairs = []
    for _ in range(reps):
        buf.amax()
        pairs.append(spun_launch(fn))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


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


def build_kernels(side):
    """Build and load the kernels and the side library (both nvcc runs in
    flight at once); returns (seconds, shared libraries, compiled costs)."""
    from bsgs_tpu_torch.ops import _cuda

    t0 = time.time()
    libs = _cuda.build(verbose=True)
    _cuda._load()
    side.load()
    took = time.time() - t0
    return took, libs, compiled_costs(libs, side)


def kernel_resources(paths, pattern: str) -> dict:
    """{function: REG, STACK, SHARED and LOCAL} of the functions of the
    built libraries whose (mangled) names match pattern, from cuobjdump
    -res-usage."""
    from bsgs_tpu_torch.ops import _cuda

    exe = Path(_cuda._nvcc()).with_name("cuobjdump")
    found = {}
    for path in paths:
        out = subprocess.run([str(exe), "-res-usage", str(path)],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
        for name, body in re.findall(r"Function (\S+):\s*\n\s*([^\n]*)",
                                     out):
            if re.search(pattern, name):
                found[name] = dict((k, int(v)) for k, v in re.findall(
                    r"(REG|STACK|SHARED|LOCAL):(\d+)", body))
    return found


def mont_resources(libs) -> dict:
    """Registers, stack, shared and local memory of each instantiation of
    the Montgomery kernels, from cuobjdump -res-usage of the built library
    ("mont_fwd L=4 points" etc.). The run fails if the instantiation the
    path uses (MONT_SEG_LEN positions a thread) spills: local memory or a
    stack."""
    from bsgs_tpu_torch.ops import epoch_kernel as EK

    lib = next(p for p in libs if p.name.startswith("libepoch_kernels"))
    found = {}
    for name, use in kernel_resources([lib], r"mont_[a-z]+_kernelILi").items():
        kind, L, pts = re.search(r"(mont_[a-z]+)_kernelILi(\d+)ELb([01])E",
                                 name).groups()
        found[f"{kind} L={L}{' points' if pts == '1' else ''}"] = use
    if len(found) != 12:
        raise AssertionError(f"mont kernels in the build: {sorted(found)}")
    for key, use in sorted(found.items()):
        log(f"resources: {key}: {use}")
    for key, use in found.items():
        if f"L={EK.MONT_SEG_LEN}" in key and (use["LOCAL"] or use["STACK"]):
            raise AssertionError(f"{key} spills: {use}")
    return found


def compiled_costs(libs, side) -> dict:
    """What the bounds count, read from the build: each field operation's
    instructions by pipe (field_op_counts), and the inversion kernel's, as
    its loop (a batch of 30 division steps, unrolled, with its matrix
    applications: the span of its backward branch) and the rest (the limb
    conversions and the final normalisation, once an element)."""
    probe = pipe_probe(side)
    costs = field_op_counts(side)
    lib = next(p for p in libs if p.name.startswith("libepoch_kernels"))
    body = next(b for n, b in sass_functions(lib).items()
                if "modinv_kernel" in n)
    loop = pipe_split(loop_ops(body))
    whole = pipe_split(sass_ops(sass_instructions(body)))
    costs["inv_batch"] = loop
    costs["inv_once"] = {k: whole[k] - loop[k] for k in loop}
    costs["pipe_probe"] = probe
    log(f"sass: one batch of the inversion is "
        f"{loop['int_total'] + loop['other']} "
        f"instructions as compiled ({loop}), the rest of the kernel "
        f"{costs['inv_once']}")
    return costs


def work(costs: dict, n: int, **per) -> dict:
    """The need of n items that each make per[op] of the field operations
    of costs: multiplier-pipe issues and integer instructions in all."""
    return {key: n * sum(k * costs[op][key] for op, k in per.items())
            for key in ("mul_issues", "int_total")}


def inversion_work(costs: dict, m: int, batches) -> dict:
    """The need of inverting m lanes whose division steps need the given
    batches per lane: what this input needs, not the cap."""
    b = int(batches.sum())
    return {key: b * costs["inv_batch"][key] + m * costs["inv_once"][key]
            for key in ("mul_issues", "int_total")}


def check_inversion(device, widths, costs: dict) -> list:
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
        bound_ms, bound_by = bound(inversion_work(costs, m, batches),
                                   2 * ELEM_BYTES * m)
        out.append(dict(m=m, ms=ms, bound_ms=bound_ms,
                        batches_max=int(batches.max()),
                        batches_mean=float(batches.double().mean())))
        log(f"kernel fermat (division steps), m={m}: bit-identical to "
            f"a^(p-2) and to its own plain version, 0 -> 0"
            f"{', x * inv(x) == 1 on every nonzero lane' * (m == max(widths))}"
            f"; {ms:.4f} ms (bound {bound_ms:.4f} ms by {bound_by}); batches "
            f"needed: {out[-1]['batches_mean']:.2f} mean, "
            f"{out[-1]['batches_max']} max")
    return out


def check_kernels(device, label: str, htsz: int, m_tab: int,
                  time_trees: bool, costs: dict, T: int = 4,
                  N: int = 1 << 18):
    """Each kernel against its plain version at one path's shapes: one
    epoch phase (T=4 centers x N offsets) with the path's bucket bits, the
    inversion of that phase's chain totals (unfolded), and one table pass
    of m_tab lanes (the path's build tile) for add_const and for the
    Montgomery passes (check_mont), which only the table build and the
    fills launch. The kernels of packed planes (epoch_fwd, epoch_bwd,
    add_const) must equal their packed plain versions bit for bit and,
    unpacked, the limb-plane plain versions; the centers are a column slice
    of a wider packed plane, as an epoch's phases take them. One phase must
    give the same key plane under each shape of the inversion tree;
    time_trees also times them. Returns the per-kernel records."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL

    rng = np.random.default_rng(SEED)
    C, W = EK.CHUNK_C, EK.LANES_W
    pk, unpk = PL.pack_planes, PL.unpack_planes
    ox = random_planes(rng, 16, N, device)
    oy = random_planes(rng, 16, N, device)
    cx = random_planes(rng, 16, T, device)
    cy = random_planes(rng, 16, T, device)
    # exact lanes: Ox == Mx for a few (t, j)
    for t, j in ((0, 5), (1, N // 3), (T - 1, N - 1)):
        ox[:, j] = cx[:, t]
    ox_p, oy_p = pk(ox), pk(oy)
    # the centers as column slices of one wider packed plane, strided as
    # an epoch's phases take theirs
    wide = random_planes(rng, 16, 2 * T + 10, device)
    wide[:, 3:T + 3], wide[:, T + 8:2 * T + 8] = cx, cy
    wide = pk(wide)
    cx_p, cy_p = wide[:, 3:T + 3], wide[:, T + 8:2 * T + 8]
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
    plant_edge_lanes(xs)
    plant_edge_lanes(ys)
    add_p = [pk(v) for v in (xs, ys, inv, ccx, ccy)]

    pre_p, tot = EK.epoch_fwd_packed(ox_p, cx_p, chunk_c=C, lanes_w=W)
    pre = unpk(pre_p)
    itot = EK.batch_inv_planar(tot)
    inv_steps, batches = EK.fermat_divsteps_plain(v_fermat)
    if not torch.equal(EK.fermat(v_fermat), inv_steps):
        raise AssertionError("fermat: kernel differs from the plain version "
                             "of its algorithm")
    torch.cuda.synchronize()

    def fwd_planes():
        pre_w, tot_w = EK.epoch_fwd_plain(ox, cx, chunk_c=C, lanes_w=W)
        return pk(pre_w), tot_w

    # name: (kernel, plain version, the limb-plane plain version (its
    # outputs with every packed plane unpacked) or None, the field
    # operations' need (work), field elements read and written, other bytes
    # moved: the key plane and the x3 prefixes)
    cases = {
        "epoch_fwd": (
            lambda: EK.epoch_fwd_packed(ox_p, cx_p, chunk_c=C, lanes_w=W),
            lambda: EK.epoch_fwd_packed_plain(ox_p, cx_p, chunk_c=C,
                                              lanes_w=W),
            fwd_planes,
            work(costs, T * N, mul=1, sub=1), N + T + T * N + m_tot, 0),
        "epoch_bwd": (
            lambda: EK.epoch_bwd_packed(ox_p, oy_p, cx_p, cy_p, pre_p, itot,
                                        htsz=htsz, chunk_c=C, lanes_w=W),
            lambda: EK.epoch_bwd_packed_plain(
                ox_p, oy_p, cx_p, cy_p, pre_p, itot, htsz=htsz, chunk_c=C,
                lanes_w=W),
            lambda: EK.epoch_bwd_plain(ox, oy, cx, cy, pre, itot, htsz=htsz,
                                       chunk_c=C, lanes_w=W),
            work(costs, T * N, mul=4, sqr=2, add=1, sub=6),
            2 * N + 2 * T + T * N + m_tot, 8 * T * N * 4),
        "fermat": (
            lambda: EK.fermat(v_fermat),
            lambda: EK.fermat_plain(v_fermat), None,
            inversion_work(costs, m_fermat, batches), 2 * m_fermat, 0),
        "add_const": (
            lambda: EK.add_const_packed(*add_p),
            lambda: EK.add_const_packed_plain(*add_p),
            lambda: (lambda x3, y3, pre: (pk(x3), pk(y3), pre))(
                *EK.add_const_plain(xs, ys, inv, ccx, ccy)),
            work(costs, m_tab, mul=2, sqr=2, add=1, sub=5),
            5 * m_tab + 2,
            2 * m_tab * 4),
    }
    shapes = {"epoch_fwd": f"T={T}, N={N}", "epoch_bwd": f"T={T}, N={N}",
              "fermat": f"m={m_fermat}", "add_const": f"m={m_tab}"}
    records = {}
    for name, (kern, plain, planes, ops, elems, other) in cases.items():
        got = kern()
        wants = [plain()] + ([planes()] if planes else [])
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        err = 0
        for want in wants:
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want, strict=True):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                         f"{w.shape}/{w.dtype}")
                diff = (g.long() - w.long()).abs()
                err = max(err, int(diff.max()) if diff.numel() else 0)
        if err:
            raise AssertionError(f"{name}: kernel differs from a plain "
                                 f"version (max abs word error {err})")
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=1, queued=False)
        # bound_ms: the function's own floor, ELEM_BYTES (32 B) an element
        # read or written; bound_ms_planes: the same work moving (16, M)
        # int32 limb planes, 64 B an element
        bound_ms, bound_by = bound(ops, ELEM_BYTES * elems + other)
        planes_ms = bound(ops, PLANE_ELEM_BYTES * elems + other)[0]
        records[name] = dict(
            name=name, route="cuda",
            source="bsgs_tpu_torch/csrc/epoch_kernels.cu",
            replaces=TPU_KERNEL[name], launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, bound_ms_planes=planes_ms, shape=shapes[name])
        log(f"kernel {name} [{label}, {shapes[name]}]: bit-identical to "
            f"its plain version"
            f"{' and, unpacked, to the limb-plane one' * bool(planes)}; "
            f"{ms:.4f} ms (plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
            f"by {bound_by}: {100 * bound_ms / ms:.0f}%; {planes_ms:.4f} ms "
            f"at 64 B an element); exact/doubling/edge lanes included")
        torch.cuda.synchronize()
    records["fermat"].update(
        batches_max=int(batches.max()),
        batches_mean=float(batches.double().mean()))

    # The shape of the inversion tree and the chain length change no output
    # bit, only the time: one phase at chain lengths 8 and 16, with the
    # totals inverted after one fold (through the Montgomery kernels of
    # csrc/mont.cuh) and unfolded (16, unfolded: the path's).
    def phase(c, direct_max):
        pre_c, tot_c = EK.epoch_fwd_packed(ox_p, cx_p, chunk_c=c, lanes_w=W)
        inv_c = EK.batch_inv_planar(tot_c, chunk_c=c, lanes_w=W,
                                    direct_max=direct_max)
        return EK.epoch_bwd_packed(ox_p, oy_p, cx_p, cy_p, pre_c, inv_c,
                                   htsz=htsz, chunk_c=c, lanes_w=W)

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


def mont_work(costs: dict, m: int, chunk_c: int, backward: bool,
              points: bool, doublings: int = 0) -> tuple:
    """(need, field elements moved) of one Montgomery pass over m lanes in
    chains of chunk_c: the function's own work, a multiply per element
    forward and two backward; forward reads v and writes pre and the
    totals, backward reads v, pre and the inverted totals and writes the
    inverses. The points entry reads xs in place of v, ys only on the
    doubling lanes, and the step's x column, and adds a sub_mod per
    element (and an add_mod per doubling lane)."""
    need = work(costs, m, mul=2 if backward else 1)
    elems = (3 if backward else 2) * m + -(-m // chunk_c)
    if points:
        extra = work(costs, 1, sub=m, add=doublings)
        need = {k: need[k] + extra[k] for k in need}
        elems += doublings + 1
    return need, elems


def bound(need: dict, nbytes: int) -> tuple:
    """(ms, by): the least time the card could take for the work, the
    largest of three floors: the multiplier pipe's issues
    (need["mul_issues"]) at MUL_PIPE_PER_S, all integer instructions
    (need["int_total"]) at INT_ISSUE_PER_S, and nbytes at the memory's
    rate. by names the floor that binds: "multiplier pipe", "integer
    issue" (both "operations") or "bytes"."""
    floors = {"multiplier pipe": need["mul_issues"] / MUL_PIPE_PER_S,
              "integer issue": need["int_total"] / INT_ISSUE_PER_S,
              "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(floors, key=floors.get)
    return 1e3 * floors[by], by


def check_mont(device, m: int, label: str, costs: dict) -> dict:
    """The two redesigned Montgomery kernels at one tile width, both
    entries (the points entry the build runs, on packed planes, and the
    plane entry of the inversion's recursion), at the tile chain length:
    bit-identical to the serial plain versions and to the segmented plain
    versions (the kernel's own split), the points entry to its packed plain
    versions and, unpacked, to the limb-plane ones, doubling and edge lanes
    planted; then a ragged width (the points entry pads the last block of
    chains in registers). Times each pass and the tile's whole inversion
    (forward, inversion of the totals, backward). Returns the records of
    the points entry."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL

    rng = np.random.default_rng(SEED + 7)
    C, W = EK.TILE_CHUNK_C, EK.LANES_W
    S = EK.mont_segments(C)
    kw = dict(chunk_c=C, lanes_w=W)
    pk, unpk = PL.pack_planes, PL.unpack_planes

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
        plant_edge_lanes(xs)
        pts = (pk(xs), pk(ys), pk(cx))
        pre, tot = EK.mont_fwd_points_packed(*pts, **kw)
        plane_pre, plane_tot = EK.mont_fwd_points_plain(xs, ys, cx, **kw)
        same(f"mont_fwd points m={width}", (pre, tot),
             EK.mont_fwd_points_packed_plain(*pts, **kw),
             EK.mont_fwd_points_packed_plain(*pts, segments=S, **kw),
             (pk(plane_pre), plane_tot))
        itot = EK.fermat(tot)
        inv = EK.mont_bwd_points_packed(*pts, pre, itot, **kw)
        same(f"mont_bwd points m={width}", inv,
             EK.mont_bwd_points_packed_plain(*pts, pre, itot, **kw),
             EK.mont_bwd_points_packed_plain(*pts, pre, itot, segments=S,
                                             **kw),
             pk(EK.mont_bwd_points_plain(xs, ys, cx, unpk(pre), itot, **kw)),
             pk(EK.fermat(EK.tile_den_plain(xs, ys, cx).to(torch.int32))))
    xs, ys, cx, _ = tile_points(rng, m, device)
    pts = (pk(xs), pk(ys), pk(cx))
    den = EK.tile_den_plain(xs, ys, cx).to(torch.int32)
    vpre, vtot = EK.mont_fwd(den, **kw)
    ppre, ptot = EK.mont_fwd_points_packed(*pts, **kw)
    same("mont_fwd plane", (vpre, vtot), EK.mont_fwd_plain(den, **kw),
         EK.mont_fwd_segmented_plain(den, segments=S, **kw),
         (unpk(ppre), ptot))
    vitot = EK.fermat(vtot)
    same("mont_bwd plane", EK.mont_bwd(den, vpre, vitot, **kw),
         EK.mont_bwd_plain(den, vpre, vitot, **kw),
         EK.mont_bwd_segmented_plain(den, vpre, vitot, segments=S, **kw))
    torch.cuda.synchronize()

    pre, tot = EK.mont_fwd_points_packed(*pts, **kw)
    itot = EK.fermat(tot)
    dbl = int((xs == cx).all(dim=0).sum())
    records = {}
    for name, kern, plain, backward in (
            ("mont_fwd", lambda: EK.mont_fwd_points_packed(*pts, **kw),
             lambda: EK.mont_fwd_points_packed_plain(*pts, **kw), False),
            ("mont_bwd",
             lambda: EK.mont_bwd_points_packed(*pts, pre, itot, **kw),
             lambda: EK.mont_bwd_points_packed_plain(*pts, pre, itot, **kw),
             True)):
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=1, queued=False)
        plane_ms = cuda_ms(
            (lambda: EK.mont_bwd(den, vpre, vitot, **kw)) if backward
            else (lambda: EK.mont_fwd(den, **kw)), reps=20)
        ops, elems = mont_work(costs, m, C, backward, True, dbl)
        bound_ms, bound_by = bound(ops, ELEM_BYTES * elems)
        planes_ms = bound(ops, PLANE_ELEM_BYTES * elems)[0]
        plane_ops, plane_elems = mont_work(costs, m, C, backward, False)
        records[name] = dict(
            name=name, route="cuda", source="bsgs_tpu_torch/csrc/mont.cuh",
            replaces=TPU_KERNEL[name], launches=0, max_abs_err=0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, bound_ms_planes=planes_ms,
            shape=f"points entry, m={m}, chains of {C} in {S} segments",
            plane_entry_ms=plane_ms,
            plane_entry_bound_ms=bound(plane_ops,
                                       ELEM_BYTES * plane_elems)[0])
        log(f"kernel {name} [{label}, points entry, m={m}, chains of {C} "
            f"in {S} segments]: bit-identical to the serial and the "
            f"segmented plain versions, packed and unpacked (and at "
            f"m=5001), {dbl} doubling lanes; {ms:.4f} ms (plain "
            f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by}: "
            f"{100 * bound_ms / ms:.0f}%; {planes_ms:.4f} ms at 64 B an "
            f"element); plane entry {plane_ms:.4f} ms")

    def fold():
        p_, t_ = EK.mont_fwd_points_packed(*pts, **kw)
        i_ = EK.batch_inv_planar(t_)
        return EK.mont_bwd_points_packed(*pts, p_, i_, **kw)

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

    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL

    rng = np.random.default_rng(SEED + 9)
    xs, ys, cx = (PL.pack_planes(v) for v in tile_points(rng, m, device)[:3])
    W = EK.LANES_W

    def fold(C, S):
        kw = dict(chunk_c=C, lanes_w=W, segments=S)
        p_, t_ = EK.mont_fwd_points_packed(xs, ys, cx, **kw)
        i_ = EK.batch_inv_planar(t_)
        return EK.mont_bwd_points_packed(xs, ys, cx, p_, i_, **kw)

    want = fold(EK.TILE_CHUNK_C, EK.mont_segments(EK.TILE_CHUNK_C))
    out = []
    for C, S in ((4, 1), (16, 4), (16, 8), (16, 16), (32, 8), (32, 16),
                 (64, 16)):
        if not torch.equal(fold(C, S), want):
            raise AssertionError(f"tile inversion differs at C={C}, S={S}")
        kw = dict(chunk_c=C, lanes_w=W, segments=S)
        fwd = cuda_ms(lambda: EK.mont_fwd_points_packed(xs, ys, cx, **kw),
                      20)
        p_, t_ = EK.mont_fwd_points_packed(xs, ys, cx, **kw)
        i_ = EK.batch_inv_planar(t_)
        bwd = cuda_ms(
            lambda: EK.mont_bwd_points_packed(xs, ys, cx, p_, i_, **kw), 20)
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


# ---------------------------------------------------------------------------
# The field operations as compiled. The side library below is built beside
# the package's: one kernel per field operation, whose SASS less the
# baseline kernel's gives the operation's compiled count by pipe (what
# every bound counts) and which is held against Python's integers on edge
# values; and a probe of the multiplier pipe's rates.

SIDE_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "field.cuh"
using bsgs::Fe;

__device__ __forceinline__ Fe side_ld(const uint4* p, long long g) {
  const uint4 a = p[2 * g], b = p[2 * g + 1];
  Fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

#define OP_KERNEL(name, expr)                                              \
  extern "C" __global__ void name(const uint4* pa, const uint4* pb,        \
                                  uint4* po, int m) {                      \
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;  \
    if (g >= m) return;                                                    \
    const Fe a = side_ld(pa, g), b = side_ld(pb, g);                       \
    const Fe r = expr;                                                     \
    po[2 * g] = make_uint4(r.v[0], r.v[1], r.v[2], r.v[3]);                \
    po[2 * g + 1] = make_uint4(r.v[4], r.v[5], r.v[6], r.v[7]);            \
  }
OP_KERNEL(op_base, bsgs::fe_select(a.v[0] == b.v[1], a, b))
OP_KERNEL(op_mul, bsgs::mul_mod(a, b))
OP_KERNEL(op_sqr, bsgs::sqr_mod(a))
OP_KERNEL(op_add, bsgs::add_mod(a, b))
OP_KERNEL(op_sub, bsgs::sub_mod(a, b))

// 8 independent chains of mad.lo.u32 (IMAD) or mad.wide.u32 (IMAD.WIDE)
extern "C" __global__ void __launch_bounds__(128)
    probe_pipe(uint32_t* o, int iters, uint32_t y, int wide) {
  uint32_t x[8];
  uint64_t z[8];
  for (int k = 0; k < 8; ++k) x[k] = threadIdx.x + k, z[k] = x[k];
  if (wide) {
    for (int it = 0; it < iters; ++it)
#pragma unroll
      for (int k = 0; k < 32; ++k)
        asm volatile("mad.wide.u32 %0, %1, %2, %0;"
                     : "+l"(z[k % 8]) : "r"((uint32_t)z[k % 8]), "r"(y));
  } else {
    for (int it = 0; it < iters; ++it)
#pragma unroll
      for (int k = 0; k < 32; ++k)
        asm volatile("mad.lo.u32 %0, %0, %1, %1;" : "+r"(x[k % 8]) : "r"(y));
  }
  uint32_t r = 0;
  for (int k = 0; k < 8; ++k)
    r ^= x[k] ^ (uint32_t)z[k] ^ (uint32_t)(z[k] >> 32);
  o[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

// which: 0 mul, 1 sqr, 2 add, 3 sub (SIDE_OPS)
extern "C" int side_op(int which, const void* a, const void* b, void* o,
                       int m, void* stream) {
  void (*const ks[])(const uint4*, const uint4*, uint4*, int) = {
      op_mul, op_sqr, op_add, op_sub};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  ks[which]<<<(m + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, (uint4*)o, m);
  return (int)cudaGetLastError();
}

extern "C" int side_probe(void* o, int blocks, int iters, int wide,
                          void* stream) {
  probe_pipe<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      (uint32_t*)o, iters, 12345u, wide);
  return (int)cudaGetLastError();
}
"""

# epoch_bwd's study (python3 chip_smoke.py --epoch-bwd), appended to
# SIDE_SRC in that mode only: the parent's kernel (one thread a chain, every
# product by the schoolbook rows that field.cuh's mul_mod used to be,
# squares as multiplies, limb pairs joined by a shift: "rows"), to time the
# kernel against in turns; the layouts of its sweep; and the schoolbook
# multiply as a field operation of its own (rows_op).
STUDY_SRC = r"""
namespace parent {

__device__ __forceinline__ Fe fe_load(const int32_t* __restrict__ plane,
                                      long long stride, long long col) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t lo = (uint32_t)plane[(2 * i) * stride + col];
    uint32_t hi = (uint32_t)plane[(2 * i + 1) * stride + col];
    r.v[i] = lo | (hi << 16);
  }
  return r;
}

// One schoolbook row: t[0..8] += a * b[0..7] (t[8] enters as 0 or as the
// running top limb; the row sum never overflows 9 limbs).
__device__ __forceinline__ void mul_row(uint32_t* t, uint32_t a,
                                        const Fe& b) {
  asm("mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
      "madc.hi.u32    %8, %9, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a), FE_IN(b));
}

// 512-bit product t[0..15] -> canonical a*b mod p, folding twice by
// 2^256 = 2^32 + 977.
__device__ __forceinline__ Fe reduce_512(const uint32_t* t) {
  // s[0..8] = lo + hi * 977
  uint32_t s[10];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = t[i];
  s[8] = 0;
  s[9] = 0;
  const uint32_t k = 977u;
  asm("mad.lo.cc.u32  %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32    %8, %16, %17, %8;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
        "+r"(s[5]), "+r"(s[6]), "+r"(s[7]), "+r"(s[8])
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]),
        "r"(t[13]), "r"(t[14]), "r"(t[15]), "r"(k));
  // s[1..9] += hi (the 2^32 part of the fold)
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, 0, 0;"
      : "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]),
        "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "=r"(s[9])
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]),
        "r"(t[13]), "r"(t[14]), "r"(t[15]));
  // second fold: top = s8 + s9 * 2^32 (< 2^34) times 2^32 + 977
  uint64_t m = (uint64_t)s[8] * 977u;
  uint64_t v1 = (m >> 32) + (uint64_t)s[9] * 977u + s[8];
  uint32_t x0 = (uint32_t)m;
  uint32_t x1 = (uint32_t)v1;
  uint32_t x2 = (uint32_t)(v1 >> 32) + s[9];
  Fe lo, r;
#pragma unroll
  for (int i = 0; i < 8; ++i) lo.v[i] = s[i];
  uint32_t c = bsgs::fe_add_small(r, lo, x0, x1, x2);
  // c == 1 leaves r below 2^67, so adding 2^256 mod p cannot carry again;
  // after that r < 2^256 < 2p and one conditional subtraction is exact
  bsgs::fe_add_small(r, r, 977u * c, c, 0u);
  return bsgs::fe_canonical(r, 0u);
}

__device__ __forceinline__ Fe mul_mod(const Fe& a, const Fe& b) {
  uint32_t t[17];
#pragma unroll
  for (int i = 0; i < 17; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) mul_row(t + i, a.v[i], b);
  return reduce_512(t);
}

}  // namespace parent

OP_KERNEL(op_mul_rows, parent::mul_mod(a, b))

extern "C" int rows_op(const void* a, const void* b, void* o, int m,
                       void* stream) {
  op_mul_rows<<<(m + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, (uint4*)o, m);
  return (int)cudaGetLastError();
}

// epoch_bwd as the parent built it
__global__ void __launch_bounds__(128)
    rows_epoch_bwd_kernel(const int32_t* __restrict__ ox,
                          const int32_t* __restrict__ oy,
                          const int32_t* __restrict__ cx,
                          const int32_t* __restrict__ cy,
                          const int32_t* __restrict__ pre,
                          const int32_t* __restrict__ itot,
                          int32_t* __restrict__ out, int T, int N, int C,
                          int W, int htsz) {
  const int nb = N / (C * W);
  const long long threads = (long long)T * nb * W;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= threads) return;
  const int t = (int)(g / ((long long)nb * W));
  const int r = (int)(g - (long long)t * nb * W);
  const int jb = r / W;
  const long long base = (long long)jb * C * W + (r - jb * W);
  const long long tn = (long long)T * N;
  const Fe mx = parent::fe_load(cx, T, t);
  const Fe my = parent::fe_load(cy, T, t);
  const Fe one = bsgs::fe_one();
  Fe run = parent::fe_load(itot, threads, g);
  for (int i = 0; i < C; ++i) {
    const long long col = base + (long long)(C - 1 - i) * W;
    const long long pc = (long long)t * N + col;
    const Fe oxv = parent::fe_load(ox, N, col);
    const Fe oyv = parent::fe_load(oy, N, col);
    Fe d = bsgs::sub_mod(oxv, mx);
    const bool exact = bsgs::fe_is_zero(d);
    d = bsgs::fe_select(exact, one, d);
    const Fe inv = parent::mul_mod(run, parent::fe_load(pre, tn, pc));
    run = parent::mul_mod(run, d);
    const Fe lp = parent::mul_mod(bsgs::sub_mod(oyv, my), inv);
    const Fe xp =
        bsgs::sub_mod(bsgs::sub_mod(parent::mul_mod(lp, lp), mx), oxv);
    const Fe lm = parent::mul_mod(bsgs::add_mod(oyv, my), inv);
    const Fe xm =
        bsgs::sub_mod(bsgs::sub_mod(parent::mul_mod(lm, lm), mx), oxv);
    uint32_t bp, dp, bm, dm;
    bsgs::probe_key(xp, htsz, bp, dp);
    bsgs::probe_key(xm, htsz, bm, dm);
    out[0 * tn + pc] = (int32_t)bp;
    out[1 * tn + pc] = (int32_t)dp;
    out[2 * tn + pc] = (int32_t)bm;
    out[3 * tn + pc] = (int32_t)dm;
    out[4 * tn + pc] = exact ? 1 : 0;
    out[5 * tn + pc] = 0;
    out[6 * tn + pc] = 0;
    out[7 * tn + pc] = 0;
  }
}

// The layouts the sweep measures beside the package's kernel (one job a
// thread): K jobs of the phase a thread, which load each offset once for
// the K walks and interleave their multiplies; a job past T (K not
// dividing T) repeats job T - 1 and stores nothing. And two halves of the
// package's kernel, to see where its time goes: kMode 1 the arithmetic
// alone (the inputs made in registers), kMode 2 the loads and stores alone.
template <int K, int kMode>
__global__ void __launch_bounds__(128)
    layout_epoch_bwd_kernel(const int32_t* __restrict__ ox,
                            const int32_t* __restrict__ oy,
                            const int32_t* __restrict__ cx,
                            const int32_t* __restrict__ cy,
                            const int32_t* __restrict__ pre,
                            const int32_t* __restrict__ itot,
                            int32_t* __restrict__ out, int T, int N, int C,
                            int W, int htsz, uint64_t step_n,
                            uint64_t step_tn) {
  const long long chains = (long long)(N / (C * W)) * W;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (T + K - 1) / K * chains) return;
  const int t0 = (int)(g / chains) * K;
  const long long r = g - (long long)(t0 / K) * chains;
  const long long jb = r / W;
  Fe mx[K], my[K], run[K];
  for (int k = 0; k < K; ++k) {
    const int t = min(t0 + k, T - 1);
    mx[k] = bsgs::fe_load(cx + t, 4ull * T);
    my[k] = bsgs::fe_load(cy + t, 4ull * T);
    run[k] = bsgs::fe_load(itot + t * chains + r, 4ull * T * chains);
  }
  const Fe one = bsgs::fe_one();
  Fe oxv = mx[0], oyv = my[0], prv = run[0];
  long long col = jb * C * W + (r - jb * W) + (long long)(C - 1) * W;
  for (int i = 0; i < C; ++i, col -= W) {
    if (kMode == 1) {
      for (int j = 0; j < 8; ++j) {
        oxv.v[j] =
            __funnelshift_l(oxv.v[j], oyv.v[(j + 1) & 7], 3) & 0x7FFFFFFF;
        oyv.v[j] ^= prv.v[j] + (uint32_t)col;
        prv.v[j] = (prv.v[j] * 5u) & 0x7FFFFFFF;
      }
    } else {
      oxv = bsgs::fe_load(ox + col, step_n);
      oyv = bsgs::fe_load(oy + col, step_n);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long pc = (long long)min(t0 + k, T - 1) * N + col;
      if (kMode != 1) prv = bsgs::fe_load(pre + pc, step_tn);
      uint32_t row[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (kMode == 2) {
        row[0] = oxv.v[0] ^ prv.v[1];
        row[1] = oyv.v[2] ^ prv.v[3];
        row[2] = oxv.v[4] + oyv.v[5] + prv.v[6];
        row[3] = oxv.v[7] ^ oyv.v[1] ^ prv.v[0];
      } else {
        Fe d = bsgs::sub_mod(oxv, mx[k]);
        const bool exact = bsgs::fe_is_zero(d);
        d = bsgs::fe_select(exact, one, d);
        const Fe inv = bsgs::mul_mod(run[k], prv);
        run[k] = bsgs::mul_mod(run[k], d);
        const Fe lp = bsgs::mul_mod(bsgs::sub_mod(oyv, my[k]), inv);
        const Fe xp =
            bsgs::sub_mod(bsgs::sub_mod(bsgs::sqr_mod(lp), mx[k]), oxv);
        const Fe lm = bsgs::mul_mod(bsgs::add_mod(oyv, my[k]), inv);
        const Fe xm =
            bsgs::sub_mod(bsgs::sub_mod(bsgs::sqr_mod(lm), mx[k]), oxv);
        bsgs::probe_key(xp, htsz, row[0], row[1]);
        bsgs::probe_key(xm, htsz, row[2], row[3]);
        row[4] = exact ? 1u : 0u;
      }
      if (t0 + k >= T) continue;
      char* a = (char*)(out + pc);
#pragma unroll
      for (int j = 0; j < 8; ++j, a += step_tn) *(int32_t*)a = (int32_t)row[j];
    }
  }
}

// layout: 2 or 4 jobs a thread; 5 the arithmetic alone, 6 the memory alone
extern "C" int layout_epoch_bwd(int layout, const void* ox, const void* oy,
                                const void* cx, const void* cy,
                                const void* pre, const void* itot, void* out,
                                int T, int N, int C, int W, int htsz,
                                void* stream) {
  const int K = layout == 2 || layout == 4 ? layout : 1;
  const long long threads = (long long)(T + K - 1) / K * (N / (C * W)) * W;
  const auto kernel = layout == 2   ? layout_epoch_bwd_kernel<2, 0>
                      : layout == 4 ? layout_epoch_bwd_kernel<4, 0>
                      : layout == 5 ? layout_epoch_bwd_kernel<1, 1>
                      : layout == 6 ? layout_epoch_bwd_kernel<1, 2>
                                    : nullptr;
  if (!kernel) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)((threads + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ox, (const int32_t*)oy, (const int32_t*)cx,
      (const int32_t*)cy, (const int32_t*)pre, (const int32_t*)itot,
      (int32_t*)out, T, N, C, W, htsz, 4ull * N, 4ull * T * N);
  return (int)cudaGetLastError();
}

extern "C" int rows_epoch_bwd(const void* ox, const void* oy,
                              const void* cx, const void* cy,
                              const void* pre, const void* itot, void* out,
                              int T, int N, int C, int W, int htsz,
                              void* stream) {
  const long long threads = (long long)T * (N / (C * W)) * W;
  rows_epoch_bwd_kernel<<<(unsigned)((threads + 127) / 128), 128, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)ox, (const int32_t*)oy, (const int32_t*)cx,
      (const int32_t*)cy, (const int32_t*)pre, (const int32_t*)itot,
      (int32_t*)out, T, N, C, W, htsz);
  return (int)cudaGetLastError();
}
"""

# The probe's study (python3 chip_smoke.py --probe), appended to SIDE_SRC in
# that mode only: the parent's probe kernel, one warp a probe reading the
# whole row (a uint4 a lane, one __any_sync), and the package kernel's other
# layouts (groups of G = 8, 16 or 32 lanes a probe; with kPer = 4 a group
# walks 4 probes a grid apart, the next probe's key loaded before the
# current row's loads and its length right after them), uint8 lengths only,
# to time the package's kernel against in turns.
PROBE_STUDY_SRC = r"""
namespace layout_probe {

constexpr int kBlock = 256;
constexpr uint32_t kFill = 0xFFFFFFFFu;

template <int G, int kPer>
__global__ void __launch_bounds__(kBlock)
    probe_rows_kernel(const uint32_t* __restrict__ bucket,
                      const uint32_t* __restrict__ disc,
                      const uint4* __restrict__ dense,
                      const uint8_t* __restrict__ row_len,
                      uint8_t* __restrict__ found, int m, int vecs,
                      int window) {
  constexpr int kUnroll = G >= 32 ? 1 : 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned group_mask =
      G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1) << (lane & ~(G - 1));
  const long long groups = (long long)gridDim.x * (kBlock / G);
  long long p = ((long long)blockIdx.x * kBlock + threadIdx.x) / G;

  uint32_t b = 0, d = 0;
  int n = 0;
  if (p < m) {
    b = __ldg(bucket + p);
    d = __ldg(disc + p);
    n = (int)__ldg(row_len + b);
  }
#pragma unroll 1
  for (int k = 0; k < kPer; ++k) {
    const long long pn = p + groups;
    const bool next = k + 1 < kPer && pn < m;
    uint32_t bn = 0, dn = 0;
    if (next) {
      bn = __ldg(bucket + pn);
      dn = __ldg(disc + pn);
    }
    bool hit = p < m && d == kFill && n < window;
    const int nv = hit ? 0 : (n + 3) >> 2;
    const uint4* row = dense + (long long)b * vecs;
    for (int v0 = sub; v0 < nv; v0 += G * kUnroll) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v0 + u * G < nv) q[u] = __ldg(row + v0 + u * G);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * G;
        if (v < nv) {
          const int rem = n - 4 * v;
          hit |= (q[u].x == d) | ((q[u].y == d) & (rem > 1)) |
                 ((q[u].z == d) & (rem > 2)) | ((q[u].w == d) & (rem > 3));
        }
      }
    }
    const int nn = next ? (int)__ldg(row_len + bn) : 0;
    const unsigned votes = __ballot_sync(0xFFFFFFFFu, hit);
    if (sub == 0 && p < m) found[p] = (votes & group_mask) ? 1 : 0;
    p = pn;
    b = bn;
    d = dn;
    n = nn;
  }
}

template <int G, int kPer>
int launch(const void* bucket, const void* disc, const void* dense,
           const void* row_len, void* found, int m, int vecs,
           cudaStream_t stream) {
  const long long per_block = (long long)(kBlock / G) * kPer;
  const unsigned grid = (unsigned)(((long long)m + per_block - 1) / per_block);
  probe_rows_kernel<G, kPer><<<grid, kBlock, 0, stream>>>(
      (const uint32_t*)bucket, (const uint32_t*)disc, (const uint4*)dense,
      (const uint8_t*)row_len, (uint8_t*)found, m, vecs, 4 * vecs);
  return 0;
}

}  // namespace layout_probe

// lanes (8, 16 or 32) answer a probe; each group walks per (1 or 4) probes;
// 8 lanes and 1 probe a group is the package's kernel, not built here
extern "C" int layout_probe_rows(const void* bucket, const void* disc,
                                 const void* dense, const void* row_len,
                                 void* found, int m, int vecs, int lanes,
                                 int per, void* stream) {
  using namespace layout_probe;
  if (m <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaErrorInvalidValue;
#define LAYOUT(G, K) \
  case G * 10 + K:   \
    err = launch<G, K>(bucket, disc, dense, row_len, found, m, vecs, s); \
    break;
  switch (lanes * 10 + per) {
    LAYOUT(8, 4) LAYOUT(16, 1) LAYOUT(16, 4) LAYOUT(32, 1) LAYOUT(32, 4)
  }
#undef LAYOUT
  if (err) return err;
  return (int)cudaGetLastError();
}

namespace parent_probe {

constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
    probe_rows_kernel(const uint32_t* __restrict__ bucket,
                      const uint32_t* __restrict__ disc,
                      const uint4* __restrict__ dense,
                      uint8_t* __restrict__ found, int m, int vecs) {
  const long long probe =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (probe >= m) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const uint32_t d = __ldg(disc + probe);
  const uint4* row = dense + (long long)__ldg(bucket + probe) * vecs;
  bool hit = false;
  for (int v = lane; v < vecs; v += 32) {
    const uint4 q = __ldg(row + v);
    hit |= (q.x == d) | (q.y == d) | (q.z == d) | (q.w == d);
  }
  hit = __any_sync(0xFFFFFFFFu, hit);
  if (lane == 0) found[probe] = hit ? 1 : 0;
}

}  // namespace parent_probe

extern "C" int parent_probe_rows(const void* bucket, const void* disc,
                                 const void* dense, void* found, int m,
                                 int vecs, void* stream) {
  if (m <= 0) return 0;
  const unsigned grid = (unsigned)(((long long)m
      + parent_probe::kWarpsPerBlock - 1) / parent_probe::kWarpsPerBlock);
  parent_probe::probe_rows_kernel<<<grid, parent_probe::kBlock, 0,
                                    (cudaStream_t)stream>>>(
      (const uint32_t*)bucket, (const uint32_t*)disc, (const uint4*)dense,
      (uint8_t*)found, m, vecs);
  return (int)cudaGetLastError();
}
"""

# The packed layout's study (python3 chip_smoke.py --packed), appended to
# SIDE_SRC in that mode only: a frozen copy of the parent's kernels on
# (16, M) int32 limb planes (epoch_fwd, epoch_bwd, add_const and the
# Montgomery points entry at two positions a thread), to time the packed
# kernels against in turns; and the packed epoch_fwd's other designs
# (VARIANTS_FWD: the grid order, when the offsets are loaded).
PLANE_STUDY_SRC = r"""
#include "mont.cuh"

namespace plane {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    plane_fwd_kernel(const int32_t* __restrict__ ox,
                     const int32_t* __restrict__ cx, int32_t* __restrict__ pre,
                     int32_t* __restrict__ tot, int T, int N, int C, int W) {
  const int nb = N / (C * W);
  const long long threads = (long long)T * nb * W;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= threads) return;
  const int t = (int)(g / ((long long)nb * W));
  const int r = (int)(g - (long long)t * nb * W);
  const int jb = r / W;
  const long long base = (long long)jb * C * W + (r - jb * W);
  const long long tn = (long long)T * N;
  const Fe mx = bsgs::fe_load(cx + t, 4ull * T);
  const Fe one = bsgs::fe_one();
  Fe run = one;
  for (int c = 0; c < C; ++c) {
    const long long col = base + (long long)c * W;
    Fe d = bsgs::sub_mod(bsgs::fe_load(ox + col, 4ull * N), mx);
    d = bsgs::fe_select(bsgs::fe_is_zero(d), one, d);
    bsgs::fe_store(pre, tn, (long long)t * N + col, run);
    run = bsgs::mul_mod(run, d);
  }
  bsgs::fe_store(tot, threads, g, run);
}

__global__ void __launch_bounds__(kBlock)
    plane_bwd_kernel(const int32_t* __restrict__ ox,
                     const int32_t* __restrict__ oy,
                     const int32_t* __restrict__ cx,
                     const int32_t* __restrict__ cy,
                     const int32_t* __restrict__ pre,
                     const int32_t* __restrict__ itot,
                     int32_t* __restrict__ out, int T, int N, int C, int W,
                     int htsz, uint64_t step_n, uint64_t step_tn) {
  const long long chains = (long long)(N / (C * W)) * W;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= T * chains) return;
  const int t = (int)(g / chains);
  const long long r = g - t * chains;
  const long long jb = r / W;
  const Fe mx = bsgs::fe_load(cx + t, 4ull * T);
  const Fe my = bsgs::fe_load(cy + t, 4ull * T);
  const Fe one = bsgs::fe_one();
  Fe run = bsgs::fe_load(itot + g, 4ull * T * chains);
  long long col = jb * C * W + (r - jb * W) + (long long)(C - 1) * W;
  for (int i = 0; i < C; ++i, col -= W) {
    const long long pc = (long long)t * N + col;
    const Fe oxv = bsgs::fe_load(ox + col, step_n);
    const Fe oyv = bsgs::fe_load(oy + col, step_n);
    Fe d = bsgs::sub_mod(oxv, mx);
    const bool exact = bsgs::fe_is_zero(d);
    d = bsgs::fe_select(exact, one, d);
    const Fe inv = bsgs::mul_mod(run, bsgs::fe_load(pre + pc, step_tn));
    run = bsgs::mul_mod(run, d);
    const Fe lp = bsgs::mul_mod(bsgs::sub_mod(oyv, my), inv);
    const Fe xp = bsgs::sub_mod(bsgs::sub_mod(bsgs::sqr_mod(lp), mx), oxv);
    const Fe lm = bsgs::mul_mod(bsgs::add_mod(oyv, my), inv);
    const Fe xm = bsgs::sub_mod(bsgs::sub_mod(bsgs::sqr_mod(lm), mx), oxv);
    uint32_t row[8] = {0, 0, 0, 0, exact ? 1u : 0u, 0, 0, 0};
    bsgs::probe_key(xp, htsz, row[0], row[1]);
    bsgs::probe_key(xm, htsz, row[2], row[3]);
    char* a = (char*)(out + pc);
#pragma unroll
    for (int j = 0; j < 8; ++j, a += step_tn) *(int32_t*)a = (int32_t)row[j];
  }
}

__global__ void __launch_bounds__(kBlock)
    plane_addc_kernel(const int32_t* __restrict__ xs,
                      const int32_t* __restrict__ ys,
                      const int32_t* __restrict__ inv,
                      const int32_t* __restrict__ cx,
                      const int32_t* __restrict__ cy,
                      int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                      int32_t* __restrict__ prefix, int M) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= M) return;
  const Fe cxv = bsgs::fe_load(cx, 4);
  const Fe cyv = bsgs::fe_load(cy, 4);
  const Fe x = bsgs::fe_load(xs + g, 4ull * M);
  const Fe y = bsgs::fe_load(ys + g, 4ull * M);
  const bool dbl = bsgs::fe_is_zero(bsgs::sub_mod(cxv, x));
  const Fe x2 = bsgs::sqr_mod(x);
  const Fe num = dbl ? bsgs::add_mod(bsgs::add_mod(x2, x2), x2)
                     : bsgs::sub_mod(cyv, y);
  const Fe lam = bsgs::mul_mod(num, bsgs::fe_load(inv + g, 4ull * M));
  const Fe xr = bsgs::sub_mod(bsgs::sqr_mod(lam), bsgs::add_mod(x, cxv));
  const Fe yr = bsgs::sub_mod(bsgs::mul_mod(lam, bsgs::sub_mod(x, xr)), y);
  bsgs::fe_store(x3, M, g, xr);
  bsgs::fe_store(y3, M, g, yr);
  prefix[g] = (int32_t)xr.v[1];
  prefix[(long long)M + g] = (int32_t)xr.v[0];
}

// the points entry's denominator on limb planes; 1 past the plane's end
__device__ __forceinline__ Fe plane_den(const int32_t* __restrict__ v,
                                        const int32_t* __restrict__ ys,
                                        const Fe& cx, long long M,
                                        long long col) {
  if (col >= M) return bsgs::fe_one();
  const Fe x = bsgs::fe_load(v + col, 4ull * M);
  const Fe d = bsgs::sub_mod(cx, x);
  if (!bsgs::fe_is_zero(d)) return d;
  const Fe y = bsgs::fe_load(ys + col, 4ull * M);
  return bsgs::add_mod(y, y);
}

template <int L>
__global__ void __launch_bounds__(bsgs::kMontLanes * bsgs::kMontMaxSegments)
    plane_mfwd_kernel(const int32_t* __restrict__ v,
                      const int32_t* __restrict__ ys,
                      const int32_t* __restrict__ cxp,
                      int32_t* __restrict__ pre, int32_t* __restrict__ tot,
                      long long M, long long T, int W) {
  __shared__ bsgs::MontScratch sm;
  const bsgs::MontPlace p = bsgs::mont_place(L, W);
  const Fe cx = bsgs::fe_load(cxp, 4);
  Fe loc[L];
#pragma unroll
  for (int i = 0; i < L; ++i)
    loc[i] = plane_den(v, ys, cx, M, p.base + (long long)(p.s * L + i) * W);
  Fe acc = loc[0];
  loc[0] = bsgs::fe_one();
#pragma unroll
  for (int i = 1; i < L; ++i) {
    const Fe e = loc[i];
    loc[i] = acc;
    acc = bsgs::mul_mod(acc, e);
  }
  bsgs::sm_put(sm, p.s, p.lane, acc);
  __syncthreads();
  for (int d = 1; d < p.S; d <<= 1) {
    const bool take = p.s >= d;
    Fe other;
    if (take) other = bsgs::sm_get(sm, p.s - d, p.lane);
    __syncthreads();
    if (take) {
      acc = bsgs::mul_mod(other, acc);
      bsgs::sm_put(sm, p.s, p.lane, acc);
    }
    __syncthreads();
  }
  if (p.s == p.S - 1) bsgs::fe_store(tot, T, p.chain, acc);
  const bool first = p.s == 0;
  Fe off;
  if (!first) off = bsgs::sm_get(sm, p.s - 1, p.lane);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const long long col = p.base + (long long)(p.s * L + i) * W;
    if (col >= M) break;
    const Fe r = first ? loc[i] : (i == 0 ? off : bsgs::mul_mod(off, loc[i]));
    bsgs::fe_store(pre, M, col, r);
  }
}

template <int L>
__global__ void __launch_bounds__(bsgs::kMontLanes * bsgs::kMontMaxSegments)
    plane_mbwd_kernel(const int32_t* __restrict__ v,
                      const int32_t* __restrict__ ys,
                      const int32_t* __restrict__ cxp,
                      const int32_t* __restrict__ pre,
                      const int32_t* __restrict__ itot,
                      int32_t* __restrict__ out, long long M, long long T,
                      int W) {
  __shared__ bsgs::MontScratch sm;
  const bsgs::MontPlace p = bsgs::mont_place(L, W);
  const Fe cx = bsgs::fe_load(cxp, 4);
  Fe e[L], pr[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const long long col = p.base + (long long)(p.s * L + i) * W;
    e[i] = plane_den(v, ys, cx, M, col);
    pr[i] = col < M ? bsgs::fe_load(pre + col, 4ull * M) : bsgs::fe_one();
  }
  Fe acc = e[0];
#pragma unroll
  for (int i = 1; i < L; ++i) acc = bsgs::mul_mod(acc, e[i]);
  bsgs::sm_put(sm, p.s, p.lane, acc);
  __syncthreads();
  acc = p.s + 1 < p.S ? bsgs::sm_get(sm, p.s + 1, p.lane)
                      : bsgs::fe_load(itot + p.chain, 4ull * T);
  __syncthreads();
  bsgs::sm_put(sm, p.s, p.lane, acc);
  __syncthreads();
  for (int d = 1; d < p.S; d <<= 1) {
    const bool take = p.s + d < p.S;
    Fe other;
    if (take) other = bsgs::sm_get(sm, p.s + d, p.lane);
    __syncthreads();
    if (take) {
      acc = bsgs::mul_mod(acc, other);
      bsgs::sm_put(sm, p.s, p.lane, acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    const long long col = p.base + (long long)(p.s * L + i) * W;
    if (col < M) bsgs::fe_store(out, M, col, bsgs::mul_mod(acc, pr[i]));
    if (i > 0) acc = bsgs::mul_mod(acc, e[i]);
  }
}

// The packed epoch_fwd's other designs: kGrouped puts the T blocks that
// walk the same chains for the T jobs next to each other in the grid
// (block b: job b % T), otherwise job t's chains fill blocks t * nbk ...
// (the parent's order); kBatch 0 loads each offset one step ahead of its
// use, 1 where it is used, and k > 1 loads k offsets at once, then walks
// them, with kAhead the next k loaded before the walk.
template <bool kGrouped, int kBatch, bool kAhead = false>
__global__ void __launch_bounds__(kBlock)
    variant_fwd_kernel(const int32_t* __restrict__ ox,
                       const int32_t* __restrict__ cx,
                       int32_t* __restrict__ pre, int32_t* __restrict__ tot,
                       int T, int N, int C, int W, long long chains,
                       uint64_t step_n, uint64_t step_c, uint64_t step_tn) {
  const long long nbk = (chains + kBlock - 1) / kBlock;
  const int t = kGrouped ? (int)(blockIdx.x % T) : (int)(blockIdx.x / nbk);
  const long long r =
      (kGrouped ? (long long)(blockIdx.x / T)
                : (long long)blockIdx.x - (long long)t * nbk) * kBlock +
      threadIdx.x;
  if (r >= chains) return;
  const long long jb = r / W;
  const long long base = jb * C * W + (r - jb * W);
  const Fe mx = bsgs::fe_load_packed(cx + t, step_c);
  const Fe one = bsgs::fe_one();
  Fe run = one;
  int32_t* out = pre + (long long)t * N + base;
  if constexpr (kBatch > 1) {
    Fe o[kBatch], nx[kBatch];
    if (kAhead) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (k < C)
          nx[k] = bsgs::fe_load_packed(ox + base + (long long)k * W, step_n);
    }
    for (int c0 = 0; c0 < C; c0 += kBatch) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (kAhead) {
          o[k] = nx[k];
          if (c0 + kBatch + k < C)
            nx[k] = bsgs::fe_load_packed(
                ox + base + (long long)(c0 + kBatch + k) * W, step_n);
        } else if (c0 + k < C) {
          o[k] = bsgs::fe_load_packed(ox + base + (long long)(c0 + k) * W,
                                      step_n);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (c0 + k >= C) break;
        Fe d = bsgs::sub_mod(o[k], mx);
        d = bsgs::fe_select(bsgs::fe_is_zero(d), one, d);
        bsgs::fe_store_packed(out + (long long)(c0 + k) * W, step_tn, run);
        run = bsgs::mul_mod(run, d);
      }
    }
  } else {
    Fe o = bsgs::fe_load_packed(ox + base, step_n);
    for (int c = 0; c < C; ++c) {
      if (kBatch == 1 && c > 0)
        o = bsgs::fe_load_packed(ox + base + (long long)c * W, step_n);
      Fe d = bsgs::sub_mod(o, mx);
      if (kBatch == 0 && c + 1 < C)
        o = bsgs::fe_load_packed(ox + base + (long long)(c + 1) * W, step_n);
      d = bsgs::fe_select(bsgs::fe_is_zero(d), one, d);
      bsgs::fe_store_packed(out + (long long)c * W, step_tn, run);
      run = bsgs::mul_mod(run, d);
    }
  }
  bsgs::fe_store(tot, (long long)T * chains, (long long)t * chains + r, run);
}

}  // namespace plane

extern "C" int plane_epoch_fwd(const void* ox, const void* cx, void* pre,
                               void* tot, int T, int N, int C, int W,
                               void* stream) {
  const long long threads = (long long)T * (N / (C * W)) * W;
  plane::plane_fwd_kernel<<<(unsigned)((threads + 127) / 128), 128, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)ox, (const int32_t*)cx, (int32_t*)pre, (int32_t*)tot,
      T, N, C, W);
  return (int)cudaGetLastError();
}

extern "C" int plane_epoch_bwd(const void* ox, const void* oy, const void* cx,
                               const void* cy, const void* pre,
                               const void* itot, void* out, int T, int N,
                               int C, int W, int htsz, void* stream) {
  const long long threads = (long long)T * (N / (C * W)) * W;
  plane::plane_bwd_kernel<<<(unsigned)((threads + 127) / 128), 128, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)ox, (const int32_t*)oy, (const int32_t*)cx,
      (const int32_t*)cy, (const int32_t*)pre, (const int32_t*)itot,
      (int32_t*)out, T, N, C, W, htsz, 4ull * N, 4ull * T * N);
  return (int)cudaGetLastError();
}

extern "C" int plane_add_const(const void* xs, const void* ys,
                               const void* inv, const void* cx,
                               const void* cy, void* x3, void* y3,
                               void* prefix, int M, void* stream) {
  plane::plane_addc_kernel<<<(M + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xs, (const int32_t*)ys, (const int32_t*)inv,
      (const int32_t*)cx, (const int32_t*)cy, (int32_t*)x3, (int32_t*)y3,
      (int32_t*)prefix, M);
  return (int)cudaGetLastError();
}

// the points entry on limb planes, chains of C spaced W apart in S
// segments of two positions (C = 2 S), as the package's tile takes them
extern "C" int plane_mont_points(int backward, const void* xs,
                                 const void* ys, const void* cx,
                                 const void* pre, const void* itot,
                                 void* out, void* tot, int M, int C, int W,
                                 int S, void* stream) {
  if (C != 2 * S || W % bsgs::kMontLanes || S > bsgs::kMontMaxSegments)
    return (int)cudaErrorInvalidValue;
  const long long span = (long long)C * W;
  const long long blocks = (M + span - 1) / span;
  const long long T = blocks * W;
  const dim3 grid((unsigned)(blocks * (W / bsgs::kMontLanes)));
  const dim3 block(bsgs::kMontLanes, S);
  if (backward)
    plane::plane_mbwd_kernel<2><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)xs, (const int32_t*)ys, (const int32_t*)cx,
        (const int32_t*)pre, (const int32_t*)itot, (int32_t*)out, M, T, W);
  else
    plane::plane_mfwd_kernel<2><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)xs, (const int32_t*)ys, (const int32_t*)cx,
        (int32_t*)out, (int32_t*)tot, M, T, W);
  return (int)cudaGetLastError();
}

// variant = 100 * ahead + 10 * grouped + batch (VARIANTS_FWD)
extern "C" int variant_epoch_fwd(int variant, const void* ox, const void* cx,
                                 void* pre, void* tot, int T, int N, int C,
                                 int W, int ldc, void* stream) {
  const long long chains = (long long)(N / (C * W)) * W;
  const unsigned grid = (unsigned)((chains + 127) / 128 * T);
  void (*kernel)(const int32_t*, const int32_t*, int32_t*, int32_t*, int,
                 int, int, int, long long, uint64_t, uint64_t, uint64_t) =
      nullptr;
  switch (variant) {
    case 0: kernel = plane::variant_fwd_kernel<false, 0>; break;
    case 1: kernel = plane::variant_fwd_kernel<false, 1>; break;
    case 4: kernel = plane::variant_fwd_kernel<false, 4>; break;
    case 8: kernel = plane::variant_fwd_kernel<false, 8>; break;
    case 10: kernel = plane::variant_fwd_kernel<true, 0>; break;
    case 11: kernel = plane::variant_fwd_kernel<true, 1>; break;
    case 14: kernel = plane::variant_fwd_kernel<true, 4>; break;
    case 2: kernel = plane::variant_fwd_kernel<false, 2>; break;
    case 12: kernel = plane::variant_fwd_kernel<true, 2>; break;
    case 104: kernel = plane::variant_fwd_kernel<false, 4, true>; break;
    case 112: kernel = plane::variant_fwd_kernel<true, 2, true>; break;
    case 114: kernel = plane::variant_fwd_kernel<true, 4, true>; break;
  }
  if (!kernel) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ox, (const int32_t*)cx, (int32_t*)pre, (int32_t*)tot,
      T, N, C, W, chains, 4ull * N, 4ull * ldc, 4ull * T * N);
  return (int)cudaGetLastError();
}
"""

# variant_epoch_fwd's designs of the packed epoch_fwd in the study, beside
# the package's (the parent's order, batches of 2 with the next batch
# ahead): the jobs in the parent's order or grouped (T neighbouring blocks
# walk the same chains), each offset loaded one step ahead or where it is
# used, or in batches of 2-8, with the next batch ahead or not
VARIANTS_FWD = {0: "parent's order, one ahead", 1: "parent's order, in place",
                2: "parent's order, batches of 2",
                4: "parent's order, batches of 4",
                8: "parent's order, batches of 8",
                104: "parent's order, batches of 4, next batch ahead",
                10: "grouped, one ahead", 11: "grouped, in place",
                12: "grouped, batches of 2", 14: "grouped, batches of 4",
                112: "grouped, batches of 2, next batch ahead",
                114: "grouped, batches of 4, next batch ahead"}

# the field operations of SIDE_SRC, in side_op's order, with their values
# as Python integers; the study adds the schoolbook multiply ("mul_rows",
# rows_op)
SIDE_OPS = {"mul": lambda x, y: x * y, "sqr": lambda x, y: x * x,
            "add": lambda x, y: x + y, "sub": lambda x, y: x - y}
# SASS opcodes that issue on neither integer pipe: memory, control, uniform
# datapath, barriers
NON_INT_OPS = ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LDL", "STL", "S2R",
               "S2UR", "CS2R", "EXIT", "BRA", "BSSY", "BSYNC", "CALL", "RET",
               "NOP", "BAR", "WARPSYNC", "UMOV", "UIADD3", "UIMAD", "ULEA",
               "ULOP3", "USHF", "USEL", "UISETP", "UPLOP3", "UPRMT")
# An IMAD.WIDE writes a 64-bit result: every bound charges it two issues of
# the multiplier pipe, whose 32-bit multiply-add rate is 64 lanes an SM a
# clock. pipe_probe measures the rates of IMAD and IMAD.WIDE and fails if
# their ratio leaves WIDE_RATIO (2.49 on an H100 at 700 W: the charge of 2
# keeps the bounds a floor).
WIDE_ISSUES = 2
WIDE_RATIO = (1.9, 3.0)


class SideLib:
    """Build the side library (SIDE_SRC over csrc/field.cuh, STUDY_SRC with
    study, PROBE_STUDY_SRC with probe_study, PLANE_STUDY_SRC with
    plane_study) with nvcc into a temporary directory, started at once so
    that it builds while the package's sources do; .load() waits for it and
    loads it."""

    def __init__(self, study: bool = False, probe_study: bool = False,
                 plane_study: bool = False):
        from bsgs_tpu_torch.ops import _cuda

        self.study = study
        self.probe_study = probe_study
        self.plane_study = plane_study
        self.dir = tempfile.TemporaryDirectory()
        src = Path(self.dir.name) / "side.cu"
        src.write_text(SIDE_SRC + (STUDY_SRC if study else "")
                       + (PROBE_STUDY_SRC if probe_study else "")
                       + (PLANE_STUDY_SRC if plane_study else ""))
        self.path = Path(self.dir.name) / "libside.so"
        self.proc = subprocess.Popen(
            [_cuda._nvcc(), "-gencode", _cuda.ARCH, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(_cuda.CSRC), "-o",
             str(self.path), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lib = None

    def load(self):
        import ctypes

        if self.lib is None:
            log_text, _ = self.proc.communicate()
            if self.proc.returncode:
                raise RuntimeError(f"nvcc failed on the side library:\n"
                                   f"{log_text}")
            lib = ctypes.CDLL(str(self.path))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.side_op.argtypes = [I, P, P, P, I, P]
            lib.side_probe.argtypes = [P, I, I, I, P]
            fns = [lib.side_op, lib.side_probe]
            if self.study:
                lib.rows_epoch_bwd.argtypes = [P] * 7 + [I] * 5 + [P]
                lib.layout_epoch_bwd.argtypes = [I] + [P] * 7 + [I] * 5 + [P]
                lib.rows_op.argtypes = [P, P, P, I, P]
                fns += [lib.rows_epoch_bwd, lib.layout_epoch_bwd, lib.rows_op]
            if self.probe_study:
                lib.parent_probe_rows.argtypes = [P] * 4 + [I] * 2 + [P]
                lib.layout_probe_rows.argtypes = [P] * 5 + [I] * 4 + [P]
                fns += [lib.parent_probe_rows, lib.layout_probe_rows]
            if self.plane_study:
                lib.plane_epoch_fwd.argtypes = [P] * 4 + [I] * 4 + [P]
                lib.plane_epoch_bwd.argtypes = [P] * 7 + [I] * 5 + [P]
                lib.plane_add_const.argtypes = [P] * 8 + [I, P]
                lib.plane_mont_points.argtypes = [I] + [P] * 7 + [I] * 4 + [P]
                lib.variant_epoch_fwd.argtypes = [I] + [P] * 4 + [I] * 5 + [P]
                fns += [lib.plane_epoch_fwd, lib.plane_epoch_bwd,
                        lib.plane_add_const, lib.plane_mont_points,
                        lib.variant_epoch_fwd]
            for fn in fns:
                fn.restype = I
            self.lib = lib
        return self.lib


def sass_functions(path) -> dict:
    """{function name: its SASS} of a built library (cuobjdump -sass)."""
    from bsgs_tpu_torch.ops import _cuda

    exe = Path(_cuda._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(exe), "-sass", str(path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    return {parts[i]: parts[i + 1] for i in range(1, len(parts) - 1, 2)}


def sass_instructions(body: str) -> list:
    """[(address, opcode, operands)] of a function's SASS, predicates
    dropped."""
    return [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);",
        body, flags=re.M)]


def is_product(op: str, operands: str) -> bool:
    """Whether an instruction multiplies: an IMAD form that is not a move,
    shift or add by name (IMAD.MOV, IMAD.SHL, IMAD.IADD) and whose two
    multiplicands are neither RZ nor a power of two (IMAD.X R, R, 0x1, R
    adds with a carry; IMAD.U32 R, R, 0x10000, RZ and IMAD.WIDE R, R, 0x4,
    R shift). ptxas puts such moves and adds on the multiplier pipe, but
    the other pipe could run them: the bounds count them as integer
    instructions only."""
    if not op.startswith("IMAD") or op.split(".")[1:2] in (
            ["MOV"], ["SHL"], ["IADD"]):
        return False
    args = [a.strip() for a in operands.split(",")][1:]
    if args and re.fullmatch(r"U?P[T0-9]", args[0]):
        args = args[1:]  # the carry-out predicate
    for a in args[:2]:
        a = a.lstrip("-~|").split(".")[0]
        if a == "RZ":
            return False
        if a.startswith("0x") and int(a, 16) & (int(a, 16) - 1) == 0:
            return False
    return True


def sass_ops(instructions) -> list:
    """[(opcode, is_product)] of [(address, opcode, operands)]."""
    return [(op, is_product(op, rest)) for _, op, rest in instructions]


def pipe_split(ops) -> dict:
    """Instructions by pipe, from [(opcode, is_product)]: imad (every IMAD
    form, as ptxas places them), products (those that multiply) and
    products_wide (the IMAD.WIDE among them), mul_issues (what the bounds
    charge the multiplier pipe: the products, an IMAD.WIDE at WIDE_ISSUES),
    alu (the other integer and logic instructions), other (memory, control,
    uniform datapath), int_total = imad + alu."""
    c = collections.Counter(ops)
    imad = sum(n for (op, _), n in c.items() if op.startswith("IMAD"))
    products = sum(n for (op, prod), n in c.items() if prod)
    wide = sum(n for (op, prod), n in c.items()
               if prod and op.startswith("IMAD.WIDE"))
    other = sum(n for (op, _), n in c.items()
                if op.split(".")[0] in NON_INT_OPS)
    alu = sum(c.values()) - imad - other
    return dict(imad=imad, products=products, products_wide=wide,
                mul_issues=products + (WIDE_ISSUES - 1) * wide, alu=alu,
                other=other, int_total=imad + alu)


def loop_ops(body: str) -> list:
    """[(opcode, is_product)] of a function's widest loop: the span of its
    widest backward branch."""
    instr = sass_instructions(body)
    lo, hi = 0, -1
    for addr, op, rest in instr:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and target:
            start = int(target.group(1), 16)
            if start <= addr and addr - start > hi - lo:
                lo, hi = start, addr
    return sass_ops([i for i in instr if lo <= i[0] <= hi])


def pipe_probe(side) -> dict:
    """The multiplier pipe's rate for IMAD and for IMAD.WIDE, from 8
    independent chains a thread on every SM; fails if their ratio leaves
    WIDE_RATIO, the range in which the bounds' charge of WIDE_ISSUES an
    IMAD.WIDE is a floor."""
    import torch

    lib = side.load()
    blocks, iters = 132 * 16, 256
    out = torch.empty(blocks * 128, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for wide in (0, 1):
        run = lambda: lib.side_probe(out.data_ptr(), blocks, iters, wide,
                                     stream)
        if run():
            raise RuntimeError("side_probe launch failed")
        ms = cuda_ms(run, reps=5)
        rates["imad_wide" if wide else "imad"] = (
            blocks * 128 * iters * 32 / (ms * 1e-3))
    ratio = rates["imad"] / rates["imad_wide"]
    log(f"pipe probe: IMAD {rates['imad'] / 1e12:.2f} T/s, IMAD.WIDE "
        f"{rates['imad_wide'] / 1e12:.2f} T/s, ratio {ratio:.3f} (the bounds "
        f"charge an IMAD.WIDE {WIDE_ISSUES} issues at "
        f"{MUL_PIPE_PER_S / 1e12:.2f} T/s; allowed {WIDE_RATIO})")
    if not WIDE_RATIO[0] <= ratio <= WIDE_RATIO[1]:
        raise AssertionError(f"IMAD / IMAD.WIDE rate ratio {ratio:.3f} "
                             f"outside {WIDE_RATIO}")
    return dict(imad_per_s=rates["imad"], imad_wide_per_s=rates["imad_wide"],
                ratio=ratio)


def field_op_counts(side) -> dict:
    """Each field operation's compiled instructions by pipe: its kernel's
    SASS less the baseline kernel's (the same loads and stores)."""
    funcs = sass_functions(side.path)

    def ops(name):
        return collections.Counter(sass_ops(sass_instructions(funcs[name])))

    base = ops("op_base")
    out = {}
    for name in list(SIDE_OPS) + (["mul_rows"] if side.study else []):
        # ops the baseline has more of (its select) are not taken off
        out[name] = pipe_split(list((ops(f"op_{name}") - base).elements()))
    log(f"field ops as compiled (SASS less the baseline's): "
        f"{json.dumps(out)}")
    return out


def check_field_ops(side) -> None:
    """The side library's field operations against Python's integers, on
    random values and edge values (0, 1, 2, p-1, p-2, 2^255, values whose
    16-bit limbs are all 0xFFFF: 2^256 - 1, which is not canonical, and
    p + 1 and 2^256 - 2^32 to either side of p): every result canonical
    and right."""
    import numpy as np
    import torch

    lib = side.load()
    rng = np.random.default_rng(SEED + 13)
    m = 4096
    edge = [0, 1, 2, P_INT - 1, P_INT - 2, 1 << 255, (1 << 256) - 1,
            P_INT + 1, (1 << 256) - (1 << 32), 0xFFFF, (1 << 128) - 1]
    a = [int.from_bytes(rng.bytes(32), "little") % P_INT for _ in range(m)]
    b = [int.from_bytes(rng.bytes(32), "little") % P_INT for _ in range(m)]
    for i, x in enumerate(edge):
        for j, y in enumerate(edge):
            a[i * len(edge) + j], b[i * len(edge) + j] = x, y

    def dev(vals):
        raw = b"".join(v.to_bytes(32, "little") for v in vals)
        return torch.frombuffer(bytearray(raw), dtype=torch.int32).cuda()

    da, db = dev(a), dev(b)
    out = torch.empty_like(da)
    stream = torch.cuda.current_stream().cuda_stream
    runs = {name: (lambda w=which: lib.side_op(
        w, da.data_ptr(), db.data_ptr(), out.data_ptr(), m, stream), fn)
        for which, (name, fn) in enumerate(SIDE_OPS.items())}
    if side.study:
        runs["mul_rows"] = (lambda: lib.rows_op(
            da.data_ptr(), db.data_ptr(), out.data_ptr(), m, stream),
            SIDE_OPS["mul"])
    for name, (run, fn) in runs.items():
        if run():
            raise RuntimeError(f"side op {name} launch failed")
        raw = out.cpu().numpy().tobytes()
        got = [int.from_bytes(raw[32 * i:32 * i + 32], "little")
               for i in range(m)]
        # add and sub take canonical inputs only
        lanes = [i for i in range(m) if name not in ("add", "sub")
                 or (a[i] < P_INT and b[i] < P_INT)]
        bad = [i for i in lanes if got[i] != fn(a[i], b[i]) % P_INT]
        if bad:
            i = bad[0]
            raise AssertionError(f"field op {name}({a[i]:#x}, {b[i]:#x}) = "
                                 f"{got[i]:#x}")
    log(f"field ops ({', '.join(runs)}) right on {m} lanes, "
        f"{len(edge) ** 2} of them edge pairs")


def bwd_resources(libs, side) -> dict:
    """Registers and spills of the epoch_bwd kernel and, in the study, of
    the parent's kernel and the K-jobs layouts, from cuobjdump -res-usage;
    the run fails if the package's kernel spills (local memory or a
    stack)."""
    lib = next(p for p in libs if p.name.startswith("libepoch_kernels"))
    found = {}
    for name, use in kernel_resources([lib, side.path],
                                      r"epoch_bwd_kernel").items():
        layout = re.search(r"layout_epoch_bwd_kernelILi(\d)ELi0E", name)
        key = ("rows" if "rows_epoch_bwd" in name
               else f"K={layout.group(1)}" if layout
               else None if "layout_" in name else "package")
        if key:
            found[key] = use
    log(f"resources: epoch_bwd kernels {found}")
    if found["package"]["LOCAL"] or found["package"]["STACK"]:
        raise AssertionError(f"epoch_bwd spills: {found['package']}")
    return found


def bwd_counts(libs, side, costs: dict) -> dict:
    """Per pair, by pipe: the function's need (4 multiplies, 2 squarings, 1
    add and 6 subtracts at the compiled counts of field.cuh's operations;
    in the study also "rows_need", at the schoolbook multiply's, squares as
    multiplies), and the compiled loop of the package's epoch_bwd (in the
    study also of the parent's kernel and of the K-jobs layouts, their loop
    over K)."""
    lib = next(p for p in libs if p.name.startswith("libepoch_kernels"))
    out = dict(need=work(costs, 1, mul=4, sqr=2, add=1, sub=6))
    if "mul_rows" in costs:
        out["rows_need"] = work(costs, 1, mul_rows=6, add=1, sub=6)
    funcs = dict(sass_functions(lib), **sass_functions(side.path))
    loops = {}
    for name, body in funcs.items():
        layout = re.search(r"layout_epoch_bwd_kernelILi(\d)ELi0E", name)
        if "rows_epoch_bwd_kernel" in name:
            loops["rows"] = pipe_split(loop_ops(body))
        elif layout:
            k = int(layout.group(1))
            loops[f"K={k}"] = {key: v / k for key, v in
                               pipe_split(loop_ops(body)).items()}
        elif re.search(r"\d+epoch_bwd_kernel", name):
            loops["package"] = pipe_split(loop_ops(body))
    out["loops"] = loops
    log(f"epoch_bwd per pair: {json.dumps(out)}")
    return out


def bwd_bytes(T: int, N: int, C: int) -> int:
    """Bytes epoch_bwd must move at T x N: ox, oy, the centers, pre and the
    inverted totals read once (ELEM_BYTES an element, the function's
    floor), the (8, T*N) key plane written once."""
    return ELEM_BYTES * (2 * N + 2 * T + T * N + T * N // C) + 32 * T * N


def bwd_inputs(rng, T: int, N: int, device, edge: bool = True):
    """One phase's epoch_bwd inputs at T x N, the chain layout of the main
    path: random limb planes with exact lanes (Ox == Mx) and, with edge,
    edge values in the first lanes of the offsets and in two centers, and
    (pre, itot) from epoch_fwd and the inversion (pre unpacked)."""
    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL

    ox, oy = (random_planes(rng, 16, N, device) for _ in range(2))
    cx, cy = (random_planes(rng, 16, T, device) for _ in range(2))
    if edge:
        plant_edge_lanes(ox)
        plant_edge_lanes(oy)
        # pair (0, 3): Ox == Mx and Oy == My (p - 1), so lambda+ is 0
        cx[:, 0], cy[:, 0] = ox[:, 3], oy[:, 3]
        cy[:, T - 1] = ox[:, 5]
    for t, j in ((0, 5), (T - 1, N // 3), (T // 2, N - 1)):
        ox[:, j] = cx[:, t]
    pre, tot = EK.epoch_fwd_packed(PL.pack_planes(ox), PL.pack_planes(cx),
                                   chunk_c=EK.CHUNK_C, lanes_w=EK.LANES_W)
    itot = EK.batch_inv_planar(tot)
    return ox, oy, cx, cy, PL.unpack_planes(pre), itot


def package_bwd(ox, oy, cx, cy, pre, itot, htsz: int):
    """The package's epoch_bwd on bwd_inputs' limb planes (packed here:
    the kernel reads packed ones)."""
    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL

    pk = PL.pack_planes
    return EK.epoch_bwd_packed(pk(ox), pk(oy), pk(cx), pk(cy), pk(pre), itot,
                               htsz=htsz, chunk_c=EK.CHUNK_C,
                               lanes_w=EK.LANES_W)


def side_bwd(lib, layout, ox, oy, cx, cy, pre, itot, htsz: int):
    """epoch_bwd through the side library on the same inputs: layout
    "rows" (the schoolbook kernel), 2 or 4 (K jobs a thread), or 5 and 6
    (the package's kernel's arithmetic alone and its memory alone)."""
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK

    T, N = cx.shape[1], ox.shape[1]
    out = torch.empty((8, T * N), dtype=torch.int32, device=ox.device)
    args = (ox.data_ptr(), oy.data_ptr(), cx.data_ptr(), cy.data_ptr(),
            pre.data_ptr(), itot.data_ptr(), out.data_ptr(), T, N,
            EK.CHUNK_C, EK.LANES_W, htsz,
            torch.cuda.current_stream().cuda_stream)
    err = (lib.rows_epoch_bwd(*args) if layout == "rows"
           else lib.layout_epoch_bwd(layout, *args))
    if err:
        raise RuntimeError(f"side epoch_bwd {layout} launch failed ({err})")
    return out


def check_epoch_bwd(device, side, shapes) -> None:
    """The package's epoch_bwd (in the study also the parent's kernel and
    the sweep's K-jobs layouts) bit-identical to epoch_bwd_plain at each
    (T, N, htsz) of shapes (edge values and exact lanes planted)."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK

    lib = side.load()
    rng = np.random.default_rng(SEED + 17)
    kw = dict(chunk_c=EK.CHUNK_C, lanes_w=EK.LANES_W)
    for T, N, htsz in shapes:
        ox, oy, cx, cy, pre, itot = bwd_inputs(rng, T, N, device)
        want = EK.epoch_bwd_plain(ox, oy, cx, cy, pre, itot, htsz=htsz,
                                  **kw)
        got = {"package": package_bwd(ox, oy, cx, cy, pre, itot, htsz)}
        for layout in ("rows", 2, 4) if side.study else ():
            got[layout] = side_bwd(lib, layout, ox, oy, cx, cy, pre, itot,
                                   htsz)
        bad = [k for k, v in got.items() if not torch.equal(v, want)]
        if bad:
            raise AssertionError(f"epoch_bwd at T={T}, N={N}, htsz={htsz}: "
                                 f"{bad} differ from the plain version")
        log(f"epoch_bwd at T={T}, N={N}, htsz={htsz}: {list(got)} "
            f"bit-identical to the plain version ({int(want[4].sum())} "
            f"exact lanes, edge values planted)")


def sweep_epoch_bwd(device, side, counts: dict, Ts=(4, 32),
                    N: int = 1 << 18) -> dict:
    """The layout, chosen by measurement: at each T the schoolbook kernel,
    the package's (one job a thread) and K = 2, 4 jobs a thread in turns
    (forward, then backward), each against the pipe-counted bound; then
    the package's kernel's arithmetic alone and its memory alone (on limb
    planes, as the parent read them)."""
    import numpy as np

    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL

    lib = side.load()
    rng = np.random.default_rng(SEED + 19)
    out = {}
    for T in Ts:
        planes = bwd_inputs(rng, T, N, device, edge=False)
        packed = [PL.pack_planes(v) for v in planes[:5]] + [planes[5]]
        runs = {"rows": lambda: side_bwd(lib, "rows", *planes, 20),
                "package": lambda: EK.epoch_bwd_packed(
                    *packed, htsz=20, chunk_c=EK.CHUNK_C,
                    lanes_w=EK.LANES_W)}
        for k in (2, 4):
            runs[f"K={k}"] = lambda k=k: side_bwd(lib, k, *planes, 20)
        order = list(runs) + list(reversed(runs))
        times = collections.defaultdict(list)
        for name in order:
            runs[name]()
            times[name].append(cuda_ms(runs[name], reps=20))
        halves = {name: cuda_ms(lambda m=m: side_bwd(lib, m, *planes, 20),
                                reps=20)
                  for name, m in (("arithmetic_alone", 5),
                                  ("memory_alone", 6))}
        bound_ms, by = bound({k: T * N * v for k, v in counts["need"].items()},
                             bwd_bytes(T, N, EK.CHUNK_C))
        out[T] = dict(bound_ms=bound_ms, bound_by=by, ms=dict(times),
                      **halves)
        log(f"epoch_bwd sweep T={T}, N={N} (in turns {order}): "
            + ", ".join(f"{n} {min(v):.4f} ms ({100 * bound_ms / min(v):.0f}%"
                        f")" for n, v in times.items())
            + f"; bound {bound_ms:.4f} ms by the {by}; the package's "
            f"arithmetic alone {halves['arithmetic_alone']:.4f} ms, its "
            f"memory alone {halves['memory_alone']:.4f} ms")
    return out


def epoch_bwd_checks(libs, side, costs: dict, device) -> dict:
    """epoch_bwd on its own: its registers and spills; the field operations
    against Python's integers; the compiled counts by pipe of the
    function's need and of the kernel's loop; the kernel bit-identical to
    the plain version at the main path's shapes (T=4, htsz 20), the
    streamed path's (htsz 24), a phase of T=128 jobs (T=32) and narrow ones
    (T that 2 and 4 do not divide, htsz 31 and 1). The study (side.study)
    holds the parent's kernel and the K-jobs layouts to the same, then
    runs the sweep."""
    resources = bwd_resources(libs, side)
    check_field_ops(side)
    counts = bwd_counts(libs, side, costs)
    check_epoch_bwd(device, side, ((4, 1 << 18, 20), (4, 1 << 18, 24),
                                   (32, 1 << 18, 20), (3, 4096, 31),
                                   (5, 4096, 1)))
    out = dict(resources=resources, counts=counts,
               pipe_probe=costs["pipe_probe"],
               field_ops={k: costs[k] for k in SIDE_OPS})
    if side.study:
        out["sweep"] = sweep_epoch_bwd(device, side, counts)
    return out


def packed_resources(libs) -> dict:
    """Registers and spills of the packed kernels that no other check
    reads (epoch_fwd and add_const: epoch_bwd_checks reads epoch_bwd's,
    mont_resources the Montgomery kernels'); the run fails if one spills."""
    lib = next(p for p in libs if p.name.startswith("libepoch_kernels"))
    found = kernel_resources([lib], r"epoch_fwd_kernel|add_const_kernel")
    out = {("epoch_fwd" if "epoch_fwd" in k else "add_const"): v
           for k, v in found.items()}
    log(f"resources: packed kernels {out}")
    if sorted(out) != ["add_const", "epoch_fwd"] or any(
            v["LOCAL"] or v["STACK"] for v in out.values()):
        raise AssertionError(f"packed kernels' resources: {out}")
    return out


def sweep_packed(side, libs, costs: dict, device) -> dict:
    """The packed layout's study (--packed): the parent's kernels on (16, M)
    limb planes (PLANE_STUDY_SRC, a frozen copy) and the package's on
    packed planes, on the same values, held equal (the packed outputs
    unpacked; the package's also to their plain versions) and timed in
    turns (plane, packed, ..., packed, plane), launches back to back
    (cuda_ms) and with the L2 flushed before each (cuda_ms_cold), against
    the function's floor (ELEM_BYTES an element) and the planes' (64 B):
    epoch_fwd with its two variants and epoch_bwd at T=4, N=2^18;
    add_const and the Montgomery points entry at both paths' tiles (2^18
    and 2^20 lanes); epoch_bwd's time right after the forward pass and the
    inversion, as an epoch runs it, against its time after an L2 flush
    (what the L2 still holds of pre and the offsets); each kernel's
    registers and spills."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import epoch_kernel as EK, planar as PL

    lib = side.load()
    rng = np.random.default_rng(SEED + 23)
    pk, unpk = PL.pack_planes, PL.unpack_planes
    i32 = torch.int32

    def call(fn, *args):
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"study launch failed ({err})")

    def equal(what, got, want):
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
            raise AssertionError(f"packed study: {what} differ")

    def in_turns(label, runs, need, elems, other=0):
        order = list(runs) + list(reversed(runs))
        warm = collections.defaultdict(list)
        cold = collections.defaultdict(list)
        for name in order:
            warm[name].append(cuda_ms(runs[name], reps=20))
            cold[name].append(cuda_ms_cold(runs[name], reps=10))
        floor, by = bound(need, ELEM_BYTES * elems + other)
        planes = bound(need, PLANE_ELEM_BYTES * elems + other)[0]
        log(f"packed study [{label}] (in turns {order}): "
            + ", ".join(f"{n} {min(warm[n]):.4f} ms "
                        f"({100 * floor / min(warm[n]):.0f}%), L2 flushed "
                        f"{min(cold[n]):.4f} ms "
                        f"({100 * floor / min(cold[n]):.0f}%)" for n in runs)
            + f"; the function's floor {floor:.4f} ms by {by}, "
            f"{planes:.4f} ms at 64 B an element")
        return dict(bound_ms=floor, bound_by=by, bound_ms_planes=planes,
                    ms=dict(warm), ms_l2_cold=dict(cold))

    out = {}
    # the epoch: one phase of T=4 jobs x N=2^18 offsets
    T, N, C, W = 4, 1 << 18, EK.CHUNK_C, EK.LANES_W
    ox, oy = (random_planes(rng, 16, N, device) for _ in range(2))
    cx, cy = (random_planes(rng, 16, T, device) for _ in range(2))
    for t, j in ((0, 5), (1, N // 3), (T - 1, N - 1)):
        ox[:, j] = cx[:, t]
    oxp, oyp, cxp, cyp = (pk(v) for v in (ox, oy, cx, cy))
    kw = dict(chunk_c=C, lanes_w=W)
    pre_pl = torch.empty((16, T * N), dtype=i32, device=device)
    tot_pl = torch.empty((16, T * N // C), dtype=i32, device=device)
    pre_v = torch.empty((8, T * N), dtype=i32, device=device)
    tot_v = torch.empty_like(tot_pl)
    fwd = {
        "plane (parent)": lambda: call(lib.plane_epoch_fwd, ox, cx, pre_pl,
                                       tot_pl, T, N, C, W),
        "packed (package)": lambda: EK.epoch_fwd_packed(oxp, cxp, **kw),
    }
    for v, name in VARIANTS_FWD.items():
        fwd[name] = lambda v=v: call(lib.variant_epoch_fwd, v, oxp, cxp,
                                     pre_v, tot_v, T, N, C, W, T)
    pre_p, tot = fwd["packed (package)"]()
    equal("epoch_fwd and its plain version", (pre_p, tot),
          EK.epoch_fwd_packed_plain(oxp, cxp, **kw))
    fwd["plane (parent)"]()
    equal("epoch_fwd on planes and packed", (pre_pl, tot_pl),
          (unpk(pre_p), tot))
    for v, name in VARIANTS_FWD.items():
        pre_v.zero_()
        call(lib.variant_epoch_fwd, v, oxp, cxp, pre_v, tot_v, T, N, C, W, T)
        equal(f"epoch_fwd {name}", (pre_v, tot_v), (pre_p, tot))
    out["epoch_fwd"] = in_turns(f"epoch_fwd T={T}, N={N}", fwd,
                                work(costs, T * N, mul=1, sub=1),
                                N + T + T * N + T * N // C)
    itot = EK.batch_inv_planar(tot)
    keys_pl = torch.empty((8, T * N), dtype=i32, device=device)
    bwd = {
        "plane (parent)": lambda: call(lib.plane_epoch_bwd, ox, oy, cx, cy,
                                       pre_pl, itot, keys_pl, T, N, C, W,
                                       20),
        "packed (package)": lambda: EK.epoch_bwd_packed(
            oxp, oyp, cxp, cyp, pre_p, itot, htsz=20, **kw),
    }
    keys = bwd["packed (package)"]()
    equal("epoch_bwd and its plain version", (keys,),
          (EK.epoch_bwd_packed_plain(oxp, oyp, cxp, cyp, pre_p, itot,
                                     htsz=20, **kw),))
    bwd["plane (parent)"]()
    equal("epoch_bwd on planes and packed", (keys_pl,), (keys,))
    out["epoch_bwd"] = in_turns(
        f"epoch_bwd T={T}, N={N}", bwd,
        work(costs, T * N, mul=4, sqr=2, add=1, sub=6),
        2 * N + 2 * T + T * N + T * N // C, 32 * T * N)

    def bwd_after_fwd(flush: bool, reps: int = 10) -> float:
        buf = torch.ones(1 << 28, dtype=torch.uint8, device=device)
        pairs = []
        for _ in range(reps):
            p_, t_ = EK.epoch_fwd_packed(oxp, cxp, **kw)
            i_ = EK.batch_inv_planar(t_)
            if flush:
                buf.amax()
            pairs.append(spun_launch(lambda: EK.epoch_bwd_packed(
                oxp, oyp, cxp, cyp, p_, i_, htsz=20, **kw)))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    reuse = {k: [] for k in ("after_fwd", "flushed")}
    for flush in (False, True, True, False):
        reuse["flushed" if flush else "after_fwd"].append(
            bwd_after_fwd(flush))
    out["epoch_bwd"]["pre_in_l2"] = reuse
    log(f"packed study [epoch_bwd after the forward pass and the "
        f"inversion]: {reuse['after_fwd']} ms against {reuse['flushed']} "
        f"ms with the L2 flushed in between (pre is "
        f"{pre_p.numel() * 4 / 1e6:.1f} MB packed)")

    # the tile: add_const and the Montgomery points entry
    for m in (1 << 18, 1 << 20):
        xs, ys, inv = (random_planes(rng, 16, m, device) for _ in range(3))
        ccx, ccy = (random_planes(rng, 16, 1, device) for _ in range(2))
        xs[:, 1234] = ccx[:, 0]
        add_p = [pk(v) for v in (xs, ys, inv, ccx, ccy)]
        x3_pl, y3_pl = (torch.empty((16, m), dtype=i32, device=device)
                        for _ in range(2))
        pfx_pl = torch.empty((2, m), dtype=i32, device=device)
        runs = {
            "plane (parent)": lambda: call(lib.plane_add_const, xs, ys, inv,
                                           ccx, ccy, x3_pl, y3_pl, pfx_pl, m),
            "packed (package)": lambda: EK.add_const_packed(*add_p),
        }
        x3, y3, pfx = runs["packed (package)"]()
        equal(f"add_const m={m} and its plain version", (x3, y3, pfx),
              EK.add_const_packed_plain(*add_p))
        runs["plane (parent)"]()
        equal(f"add_const m={m} on planes and packed", (x3_pl, y3_pl, pfx_pl),
              (unpk(x3), unpk(y3), pfx))
        out[f"add_const m={m}"] = in_turns(
            f"add_const m={m}", runs,
            work(costs, m, mul=2, sqr=2, add=1, sub=5), 5 * m + 2, 8 * m)

        xs, ys, cx_t, _ = tile_points(rng, m, device)
        pts = (pk(xs), pk(ys), pk(cx_t))
        Cm, Wm = EK.TILE_CHUNK_C, EK.tile_lanes(m, EK.TILE_CHUNK_C)
        S = EK.mont_segments(Cm)
        mkw = dict(chunk_c=Cm, lanes_w=Wm)
        dbl = int((xs == cx_t).all(dim=0).sum())
        mpre, mtot = EK.mont_fwd_points_packed(*pts, **mkw)
        mitot = EK.fermat(mtot)
        minv = EK.mont_bwd_points_packed(*pts, mpre, mitot, **mkw)
        equal(f"mont points m={m} and their plain versions", (mpre, mtot, minv),
              EK.mont_fwd_points_packed_plain(*pts, **mkw)
              + (EK.mont_bwd_points_packed_plain(*pts, mpre, mitot, **mkw),))
        mpre_pl = torch.empty((16, m), dtype=i32, device=device)
        mtot_pl = torch.empty_like(mtot)
        minv_pl = torch.empty((16, m), dtype=i32, device=device)
        for backward in (False, True):
            name = "mont_bwd" if backward else "mont_fwd"
            plane = (
                (lambda: call(lib.plane_mont_points, 1, xs, ys, cx_t, mpre_pl,
                              mitot, minv_pl, None, m, Cm, Wm, S))
                if backward else
                (lambda: call(lib.plane_mont_points, 0, xs, ys, cx_t, None,
                              None, mpre_pl, mtot_pl, m, Cm, Wm, S)))
            packed = ((lambda: EK.mont_bwd_points_packed(*pts, mpre, mitot,
                                                         **mkw))
                      if backward else
                      (lambda: EK.mont_fwd_points_packed(*pts, **mkw)))
            plane()
            if backward:
                equal(f"{name} m={m} on planes and packed", (minv_pl,),
                      (unpk(minv),))
            else:
                equal(f"{name} m={m} on planes and packed",
                      (mpre_pl, mtot_pl), (unpk(mpre), mtot))
            need, elems = mont_work(costs, m, Cm, backward, True, dbl)
            out[f"{name} points m={m}"] = in_turns(
                f"{name} points m={m}",
                {"plane (parent)": plane, "packed (package)": packed},
                need, elems)

    lib_main = next(p for p in libs if p.name.startswith("libepoch_kernels"))
    out["resources"] = kernel_resources(
        [lib_main, side.path],
        r"epoch_fwd_kernel|epoch_bwd_kernel|add_const_kernel|"
        r"mont_[a-z]+_kernelILi2ELb1E|plane_|variant_")
    log(f"packed study registers: {out['resources']}")
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
    keys = EK.epoch_landing_keys_packed(
        cx[:, :per], cy[:, :per], solver.ox_pk, solver.oy_pk, htsz=cfg.htsz,
        chunk_c=cfg.chunk_c, lanes_w=cfg.lanes_w)
    return keys[0].clone(), keys[1].clone()


def plant_members(bucket, disc, rows, gen, every: int = 8):
    """Overwrite every ``every``-th probe with a random slot of the table
    (``rows``, its ProbeRows): a member, or an empty slot's 0xFFFFFFFF,
    which matches too; then every (8 * every)-th from the (every / 2)-th
    with an 0xFFFFFFFF disc, in turn against one of the table's 64 longest
    rows (full ones where the table has any: none of a real table's rows
    is) and against a random row."""
    import torch

    dense, row_len = rows
    dev = bucket.device
    idx = torch.arange(0, bucket.shape[0], every, device=dev)
    pick = torch.randint(0, dense.shape[0], idx.shape, generator=gen,
                         device=dev)
    cols = torch.randint(0, dense.shape[1], idx.shape, generator=gen,
                         device=dev)
    bucket[idx] = pick.to(torch.int32)
    disc[idx] = dense[pick, cols]
    fills = torch.arange(every // 2, bucket.shape[0], 8 * every, device=dev)
    longest = torch.topk(row_len.long(), min(64, row_len.shape[0])).indices
    toward = torch.where(
        torch.arange(fills.shape[0], device=dev) % 2 == 0,
        longest[torch.randint(0, longest.shape[0], fills.shape,
                              generator=gen, device=dev)],
        torch.randint(0, dense.shape[0], fills.shape, generator=gen,
                      device=dev))
    bucket[fills] = toward.to(torch.int32)
    disc[fills] = -1
    return bucket, disc


def whole_row_probe(bucket, disc, dense, block: int = 1 << 18):
    """The JAX package's probe, the contract: any(dense[bucket[i], :] ==
    disc[i]) over whole rows, block by block of the stream."""
    import torch

    found = torch.empty(bucket.shape, dtype=torch.bool, device=bucket.device)
    for s in range(0, bucket.shape[0], block):
        sl = slice(s, s + block)
        found[sl] = (dense[bucket[sl].long()] == disc[sl, None]).any(dim=1)
    return found


def probe_bytes(bucket, disc, rows) -> tuple:
    """(bytes this stream's probes need, bytes a whole-row read moves). A
    probe reads its 8-byte key and its row's length and writes one byte,
    and reads the 32-byte sectors of its row's occupied slots: none where
    an 0xFFFFFFFF disc is answered from the length (a row with an empty
    slot). A whole-row read takes 4 * window bytes of row a probe."""
    import torch

    dense, row_len = rows
    m, window = bucket.shape[0], dense.shape[1]
    n = row_len[bucket.long()].long()
    sectors = torch.where((disc == -1) & (n < window), 0, (4 * n + 31) // 32)
    need = 32 * int(sectors.sum()) + m * (9 + row_len.element_size())
    return need, m * (4 * window + 9)


def check_row_lengths(label: str, table, block: int = 1 << 20) -> None:
    """One pass over a built table on the card: row_len equals the diff of
    its offsets over its own rows, and dense[r, row_len[r]:] is all FILL
    (so the occupied-slot probe equals the whole-row one on it)."""
    import torch

    from bsgs_tpu_torch.models import table as T
    from bsgs_tpu_torch.ops import planar as PL

    rows, window = table.dense.shape
    row0 = (table.shard or 0) * rows
    counts = torch.diff(PL.u32_value(table.offsets[row0:row0 + rows + 1]))
    if not torch.equal(table.row_len.long(), counts):
        raise AssertionError(f"{label}: row_len differs from the offsets")
    cols = torch.arange(window, device=table.dense.device)
    bad = torch.zeros((), dtype=torch.int64, device=table.dense.device)
    for s in range(0, rows, block):
        past = cols >= table.row_len[s:s + block].long()[:, None]
        bad += ((table.dense[s:s + block] != T.DENSE_FILL) & past).sum()
    if int(bad):
        raise AssertionError(f"{label}: {int(bad)} slots past row_len hold "
                             f"entries")
    log(f"{label}: row_len ({table.row_len.dtype}, "
        f"{table.row_len.numel() * table.row_len.element_size() / 2**20:.0f}"
        f" MiB) equals the diff of the offsets, FILL past it in all {rows} "
        f"rows; mean {float(counts.double().mean()):.2f} entries a row of "
        f"{window}")


def plant_slot(baby, bucket: int, disc: int) -> int:
    """Write an entry (int32 bits) into the first slot past row bucket's
    entries and count it in row_len; returns its column."""
    col = int(baby.row_len[bucket])
    if col >= baby.window:
        raise AssertionError(f"row {bucket} is full")
    baby.dense[bucket, col] = disc
    baby.row_len[bucket] += 1
    return col


def unplant_slot(baby, bucket: int, col: int) -> None:
    """Undo plant_slot (the last entry planted in that row)."""
    from bsgs_tpu_torch.models import table as T

    baby.dense[bucket, col] = T.DENSE_FILL
    baby.row_len[bucket] -= 1


def check_probe(label: str, bucket, disc, rows, reps: int = 20) -> dict:
    """probe_rows against probe_rows_plain on the card, bit-identical, and
    against the whole-row function (the JAX package's probe) on this table,
    whose rows hold FILL past their lengths; both versions timed, the
    kernel also with the L2 flushed before each launch. The
    bound is bytes: each probe's key, its row's length, its answer and its
    row's occupied sectors (probe_bytes); bound_ms_whole_row charges the
    whole row, the least any whole-row kernel could take."""
    import torch

    from bsgs_tpu_torch.ops import probe_kernel as PK

    got = PK.probe_rows(bucket, disc, *rows)
    want = PK.probe_rows_plain(bucket, disc, *rows)
    whole = whole_row_probe(bucket, disc, rows.dense)
    torch.cuda.synchronize()
    if got.dtype != torch.bool or got.shape != want.shape:
        raise AssertionError(f"probe {label}: {got.dtype} {got.shape}")
    err = int((got != want).sum())
    if err:
        raise AssertionError(f"probe {label}: kernel differs from its plain "
                             f"version on {err} probes")
    err = int((got != whole).sum())
    if err:
        raise AssertionError(f"probe {label}: kernel differs from the "
                             f"whole-row probe on {err} probes")
    m, window = bucket.shape[0], rows.dense.shape[1]
    hits = int(want.sum())
    fills = int((disc == -1).sum())
    if m >= 16 and not 0 < hits < m:
        raise AssertionError(f"probe {label}: one-sided answers ({hits}/{m})")
    ms = cuda_ms(lambda: PK.probe_rows(bucket, disc, *rows), reps)
    ms_cold = cuda_ms_cold(lambda: PK.probe_rows(bucket, disc, *rows), 10)
    plain_ms = cuda_ms(lambda: PK.probe_rows_plain(bucket, disc, *rows), 2,
                       queued=False)
    need, whole_bytes = probe_bytes(bucket, disc, rows)
    bound_ms = 1e3 * need / HBM_BYTES_PER_S
    bound_whole = 1e3 * whole_bytes / HBM_BYTES_PER_S
    log(f"kernel probe_rows [{label}]: bit-identical to plain and to the "
        f"whole-row probe ({hits} of {m} found, {fills} 0xFFFFFFFF discs); "
        f"{ms:.4f} ms back to back, {ms_cold:.4f} ms with the L2 flushed "
        f"(plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by the "
        f"{need / m:.1f} B a probe needs, {100 * bound_ms / ms:.0f}%, "
        f"{100 * bound_ms / ms_cold:.0f}% cold; whole rows "
        f"{bound_whole:.4f} ms), table "
        f"{rows.dense.numel() * 4 / 2**20:.0f} MiB, window {window}")
    return dict(label=label, m=m, window=window, ms=ms, ms_l2_cold=ms_cold,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_ms_whole_row=bound_whole,
                bytes_per_probe=need / m, found=hits, fill_discs=fills,
                table_mib=rows.dense.numel() * 4 / 2**20)


def check_probe_on_table(label: str, solver, device) -> list:
    """The probe kernel on a solver's own table: one phase's stream of
    real keys with members and 0xFFFFFFFF discs planted, then m = 16 and an
    odd length."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = solver.baby.rows
    bucket, disc = plant_members(*phase_keys(solver, SEED), rows, gen)
    out = [check_probe(f"{label}, one phase's stream", bucket, disc, rows)]
    for m in (16, 5001):
        out.append(check_probe(f"{label}, m={m}", bucket[:m].clone(),
                               disc[:m].clone(), rows))
    return out


def check_probe_synthetic(device, rows: int, window: int, m: int) -> dict:
    """A seeded random table of another row width, its rows of random
    lengths with FILL tails: full and empty rows among them, and real
    0xFFFFFFFF entries in the occupied slots of a full and a short row; half
    the probes planted members, 0xFFFFFFFF discs among them. The 512-slot
    layout (2^18 rows, 512 MiB, well beyond the 50 MB L2; int16 lengths)
    and a narrow row that leaves most of a group's lanes idle."""
    import torch

    from bsgs_tpu_torch.models import table as T
    from bsgs_tpu_torch.ops import probe_kernel as PK

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + window)
    dense = torch.randint(-(1 << 31), 1 << 31, (rows, window), generator=gen,
                          device=device, dtype=torch.int64).to(torch.int32)
    n = torch.randint(0, window + 1, (rows,), generator=gen, device=device)
    n[:16] = window
    n[16:32] = 0
    n[40] = window // 2
    dense[torch.arange(window, device=device) >= n[:, None]] = T.DENSE_FILL
    dense[7, window // 3] = T.DENSE_FILL  # a full row's real entry
    dense[40, 1] = T.DENSE_FILL  # a short row's real entry
    table = T.ProbeRows(dense, PK.row_lengths(n, window))
    bucket = torch.randint(0, rows, (m,), generator=gen,
                           device=device).to(torch.int32)
    disc = torch.randint(-(1 << 31), 1 << 31, (m,), generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)
    bucket, disc = plant_members(bucket, disc, table, gen, every=2)
    bucket[:4] = torch.tensor([7, 40, 0, 20], dtype=torch.int32)
    disc[:4] = -1
    rec = check_probe(f"synthetic window {window}", bucket, disc, table)
    want = [True, True, False, True]
    got = whole_row_probe(bucket[:4], disc[:4], dense).tolist()
    if got != want:
        raise AssertionError(f"synthetic window {window}: 0xFFFFFFFF discs "
                             f"against a full row with a real one, a short "
                             f"row with one, a full row and an empty row "
                             f"gave {got}")
    return rec


def sweep_probe(side, libs, device) -> dict:
    """The probe's study (--probe): the w=2^26 table and one phase's
    stream as check_probe_on_table makes them; the package's kernel (8
    lanes a probe), its other layouts (8, 16 or 32 lanes a probe, each
    group walking 1 or 4 probes) and the parent's kernel (one warp a probe
    reading whole rows), both from PROBE_STUDY_SRC, each held
    bit-identical to the plain version and timed in turns against the
    occupied-sector bound and the whole-row one: launches back to back (cuda_ms, as every kernel's time in the
    run) and one at a time after the L2 is flushed (cuda_ms_cold)."""
    import torch

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.ops import probe_kernel as PK

    cfg = S.SolverConfig(w=1 << 26)
    baby = S.build_table(cfg, device=device)
    check_row_lengths("w=2^26 table", baby)
    solver = S.Solver(cfg, baby=baby, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = baby.rows
    bucket, disc = plant_members(*phase_keys(solver, SEED), rows, gen)
    m = bucket.shape[0]
    lib = side.load()
    out = torch.empty((m,), dtype=torch.bool, device=device)

    def parent():
        err = lib.parent_probe_rows(
            bucket.data_ptr(), disc.data_ptr(), rows.dense.data_ptr(),
            out.data_ptr(), m, rows.dense.shape[1] // 4,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent probe launch failed ({err})")

    def layout(lanes, per):
        err = lib.layout_probe_rows(
            bucket.data_ptr(), disc.data_ptr(), rows.dense.data_ptr(),
            rows.row_len.data_ptr(), out.data_ptr(), m,
            rows.dense.shape[1] // 4, lanes, per,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe layout {lanes}x{per} launch failed "
                               f"({err})")

    if rows.row_len.dtype != torch.uint8:
        raise AssertionError(f"probe study: {rows.row_len.dtype} lengths")
    runs = {"parent": parent,
            "lanes=8 per=1 (package)": lambda: PK.launch_probe_rows(
                bucket, disc, *rows, out)}
    for lanes in (8, 16, 32):
        for per in (1, 4):
            if (lanes, per) != (8, 1):
                runs[f"lanes={lanes} per={per}"] = (
                    lambda lanes=lanes, per=per: layout(lanes, per))
    want = PK.probe_rows_plain(bucket, disc, *rows)
    for name, fn in runs.items():
        out.fill_(False)
        fn()
        if not torch.equal(out, want):
            raise AssertionError(f"probe study {name}: differs from the "
                                 f"plain version on "
                                 f"{int((out != want).sum())} probes")
    need, whole = probe_bytes(bucket, disc, rows)
    bound_ms = 1e3 * need / HBM_BYTES_PER_S
    bound_whole = 1e3 * whole / HBM_BYTES_PER_S
    order = list(runs) + list(reversed(runs))
    times = collections.defaultdict(list)
    cold = collections.defaultdict(list)
    for name in order:
        times[name].append(cuda_ms(runs[name], reps=20))
        cold[name].append(cuda_ms_cold(runs[name], reps=10))
    log(f"probe sweep, m={m}, w=2^26 table (in turns {order}): "
        + ", ".join(f"{n} {min(v):.4f} ms ({100 * bound_ms / min(v):.0f}%)"
                    f", L2 cold {min(cold[n]):.4f} ms"
                    for n, v in times.items())
        + f"; bound {bound_ms:.4f} ms by the {need / m:.1f} B a probe "
        f"needs, whole rows {bound_whole:.4f} ms")
    regs = kernel_resources(
        [p for p in libs if p.name.startswith("libprobe_kernels")]
        + [side.path], r"probe_rows_kernel")
    log(f"probe sweep registers: {regs}")
    return dict(m=m, bound_ms=bound_ms, bound_ms_whole_row=bound_whole,
                bytes_per_probe=need / m, ms=dict(times),
                ms_l2_cold=dict(cold), registers=regs)


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
    if not (torch.equal(st.offsets, baby.offsets)
            and torch.equal(st.row_len, baby.row_len)):
        raise AssertionError("streamed build: offsets or row lengths differ")
    check_row_lengths("streamed build of the w=2^26 table", st)
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


def profile_scan(solver, pub, pk: int, epochs: int) -> dict:
    """Where an epoch's time goes: torch.profiler over a short scan, device
    time by kernel, the device's busy share of the wall time, and the host
    time spent queueing epochs (Solver._dispatch). Returns those per epoch
    and, from the trace, how long kernels of two streams ran at once
    (stream_overlap)."""
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
    overlap = stream_overlap(prof)
    log(f"profile: {epochs} epochs in {wall * 1e3:.2f} ms wall (profiler "
        f"on); device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%); "
        f"host queueing {1e3 * sum(host) / len(host):.2f} ms per epoch; "
        f"streams {overlap['streams']}, probe kernels under the epoch's "
        f"others {overlap['overlap_ms']:.3f} ms")
    for e in rows[:10]:
        us = e.self_device_time_total
        log(f"profile: {us / 1e3 / epochs:8.3f} ms/epoch "
            f"{100 * us / 1e6 / busy:5.1f}% x{e.count // epochs:<4d} "
            f"{e.key[:80]}")
    by_kernel = {e.key[:60]: e.self_device_time_total / 1e3 / epochs
                 for e in rows[:10]}
    return dict(wall_ms_per_epoch=1e3 * wall / epochs,
                busy_ms_per_epoch=1e3 * busy / epochs,
                host_ms_per_epoch=1e3 * sum(host) / len(host),
                device_ms_per_epoch_by_kernel=by_kernel, **overlap)


def stream_overlap(prof) -> dict:
    """From a profile's trace: the CUDA streams its kernels ran on, and the
    time during which a probe kernel (probe_rows) ran while an epoch or
    inversion kernel ran on another stream, in ms (0 on one stream)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel" and "dur" in e]
    streams = sorted({e.get("args", {}).get("stream") for e in kernels},
                     key=str)
    probes, others = [], []
    for e in kernels:
        span = (e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"))
        if "probe_rows" in e["name"]:
            probes.append(span)
        elif any(k in e["name"] for k in ("epoch_fwd", "epoch_bwd", "mont_",
                                          "modinv")):
            others.append(span)
    us = 0.0
    for a0, a1, sa in probes:
        for b0, b1, sb in others:
            if sa != sb:
                us += max(0.0, min(a1, b1) - max(a0, b0))
    return dict(streams=len(streams), overlap_ms=us / 1e3)


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
    whole first-tile fill (fill_multiples_packed), the tile advances
    (tile_advance_packed, fill passes included) and the pack (_device_pack)
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
    own_ms = sum(e.self_device_time_total for e in rows
                 if any(k in e.key for k in OWN_KERNEL_SYMBOLS)) / 1e3

    parts = {"seed row": (ec, "host_row"),
             "fill": (EK, "fill_multiples_packed"),
             "tile advance": (EK, "tile_advance_packed"),
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
    """One tile advance (tile_advance_packed on a filled tile, its output
    fed back as the build does): the host's time to queue it, its wall
    time with the device's, and the device launches it makes under
    torch.profiler, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from bsgs_tpu_torch.ops import _cuda, epoch_kernel as EK, planar as PL
    from bsgs_tpu_torch.utils import ecpy

    xs, ys = EK.fill_multiples_packed(ecpy.mul(1), ecpy.mul(1), tile,
                                      device=device)
    step = ecpy.mul(tile)
    cx, cy = (PL.packed_col(v, device) for v in step)
    xs, ys, _, _ = EK.tile_advance_packed(xs, ys, cx, cy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        xs, ys, _, _ = EK.tile_advance_packed(xs, ys, cx, cy)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # two warm-up steps, and a pause once the trace is active: the tracer
    # misses launches made just after it starts, and may file a warm-up
    # step's launch among the active ones. A trace is complete when it
    # holds exactly the launches that the kernel wrappers counted in the
    # active steps; one that does not is taken again (at most five times).
    # The check after this function reads only a complete trace; the
    # per-kernel counts of each trace taken again are kept
    # (discarded_traces), so that a persistent extra launch can be told
    # from a misfiled warm-up one.
    warmup = 2
    discarded = []
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warmup, active=calls,
                                       repeat=1)) as prof:
            for i in range(warmup + calls):
                if i == warmup:
                    torch.cuda.synchronize()
                    time.sleep(0.005)
                    before = dict(_cuda.LAUNCHES)
                xs, ys, _, _ = EK.tile_advance_packed(xs, ys, cx, cy)
                if i == warmup + calls - 1:
                    torch.cuda.synchronize()
                    counted = {k: _cuda.LAUNCHES[k] - before[k]
                               for k in _cuda.KERNELS}
                prof.step()
        rows = device_rows(prof)
        traced = sum(e.count for e in rows
                     if any(k in e.key for k in OWN_KERNEL_SYMBOLS))
        if traced == sum(counted.values()):
            break
        discarded.append({e.key[:100]: e.count for e in rows})
        log(f"tile advance [{tile} lanes]: the trace held {traced} launches "
            f"where the wrappers counted {sum(counted.values())} (attempt "
            f"{attempt + 1}, by kernel {discarded[-1]}); profiling again")
    per = sum(e.count for e in rows) / calls
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / calls
    out = dict(tile=tile, host_ms=1e3 * host / calls,
               wall_ms=1e3 * wall / calls, device_ms=dev_ms,
               device_launches=per,
               counted_launches=sum(counted.values()) / calls,
               trace_attempts=attempt + 1, discarded_traces=discarded,
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


def read_launches(path: str, totals: dict, kernels=None,
                  epoch_folds: bool = False) -> None:
    """Record the launch counts of the path just driven (the counters were
    set to 0 just before it) and fail if a kernel of the path (kernels,
    default all seven) was not launched. Every add-const pass folds once
    (one forward and one backward Montgomery pass); the fused epochs fold
    nothing, the unfused and pipelined ones (epoch_folds) fold too, so
    there the passes may outnumber the add-const passes."""
    from bsgs_tpu_torch.ops import _cuda

    launches = dict(_cuda.LAUNCHES)
    totals[path] = launches
    log(f"launches on the {path} path: {launches}")
    if min(launches[k] for k in (kernels or _cuda.KERNELS)) <= 0:
        raise AssertionError(f"a kernel was not launched on the {path} "
                             f"path: {launches}")
    fwd, bwd, addc = (launches[k] for k in ("mont_fwd", "mont_bwd",
                                            "add_const"))
    if fwd != bwd or (fwd < addc if epoch_folds else fwd != addc):
        raise AssertionError(f"the {path} path's add-const passes do not "
                             f"each fold once: {launches}")


def timed_scans(solver, pub, pk: int, epochs: int, repeats: int,
                residue_scan: bool = False, per_epoch=None):
    """Scans of a pubkey with no key in range, as bench.py times them:
    host clock around work that ends in a synchronise. Returns the rates
    (giant-steps/s) and the last result. Unless its verification runs a
    residue scan (which generates points), a scan must launch exactly
    per_epoch (default LAUNCHES_PER_EPOCH: the inversion once a phase and
    no Montgomery pass) per epoch, so a return to a deeper tree fails
    here."""
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
        want = {k: n * epochs
                for k, n in (per_epoch or LAUNCHES_PER_EPOCH).items()}
        if not residue_scan and made != want:
            raise AssertionError(f"launches in {epochs} epochs: {made}, "
                                 f"expected {want}")
    if not residue_scan:
        log(f"launches per epoch in each of these {repeats} scans of "
            f"{epochs} epochs: {per_epoch or LAUNCHES_PER_EPOCH}")
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
    col = plant_slot(baby, bucket, T._i32(pre >> (32 - cfg.htsz)))
    sh, mk = T._disc_lo_shift(cfg.htsz)
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


def scans_in_turns(solvers: dict, order, pub, pk: int, epochs: int,
                   per_epoch=None) -> dict:
    """8-epoch (or so) scans of each solver, taken in the given order
    (A, B, B, A), so that two are compared within one run: rates by name.
    per_epoch: the launches per epoch by solver name, where not the
    default."""
    rates = {name: [] for name in solvers}
    for name in order:
        r, _ = timed_scans(solvers[name], pub, pk, epochs=epochs, repeats=1,
                           per_epoch=(per_epoch or {}).get(name))
        rates[name] += r
    return rates


def check_mesh_probe(label: str, ms, streams, dense) -> None:
    """A fused MeshSolver's probe (its route's collectives over
    sharded_table.probe_own_rows, or the replicated table's probe) of one
    phase's three streams, bit-identical to the whole-row probe of its
    table (the JAX package's function)."""
    import torch

    found = 0
    for bucket, disc in streams:
        got = ms._probe(bucket, disc)
        if not torch.equal(got, whole_row_probe(bucket, disc, dense)):
            raise AssertionError(f"{label}: the probe differs from the "
                                 f"whole-row probe")
        found += int(got.sum())
    log(f"{label}: the probe of one phase's three streams equals the "
        f"whole-row probe ({found} found)")


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
    check_mesh_probe("mesh w=2^26 replicated", ms,
                     phase_streams(solver, SEED), base.baby.dense)
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
    that survives the hint planted in epoch 0, through the all_gather
    route and then the all_to_all route, counted as the "mesh w=2^30
    sharded" and "mesh w=2^30 sharded all_to_all" paths; both routes'
    decoded records of super-epoch 0 equal; then 8-epoch scans through
    both routes beside the plain Solver's on the single-card table, in
    turns, and a profile, the collectives and the host waits of each
    route's epoch."""
    import torch

    from bsgs_tpu_torch.models import solver as S
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
            and torch.equal(baby.offsets, single.baby.offsets)
            and torch.equal(baby.row_len, single.baby.row_len)):
        raise AssertionError("the table built over the mesh differs from the "
                             "single-card streamed table")
    check_row_lengths("mesh w=2^30 sharded table", baby)
    stats = baby.lookup_fn.stats
    for r in (1, 256, cfg.w, rng.randrange(1, cfg.w)):
        if baby.lookup_positions(ecpy.mul(r)[0]) != [r]:
            raise AssertionError(f"mesh lookup of baby {r}")
    base = S.Solver(cfg, baby=baby, device=mesh.device)
    solvers = {"plain": single}
    pk = 1 << 59
    key = pk + cfg.keys_per_epoch + rng.randrange(cfg.keys_per_epoch)
    q0 = ecpy.sub(ecpy.mul(key), ecpy.mul(pk))
    pre_fp, (row, col) = plant_surviving_slot(baby, cfg, q0, 12345)
    solves = {}
    for route, path in (("all_gather", "mesh w=2^30 sharded"),
                        ("all_to_all", "mesh w=2^30 sharded all_to_all")):
        ms = striped.MeshSolver(base, mesh, shard_baby_table=True,
                                probe_routing=route)
        scans_before = stats["residue_scans"]
        t0 = time.time()
        res = ms.solve(ecpy.mul(key), pk, pk + 3 * cfg.keys_per_epoch - 1)
        torch.cuda.synchronize()
        took = time.time() - t0
        scans = stats["residue_scans"] - scans_before
        if (res.key != key or res.epochs < 3 or scans < 1
                or res.hits_checked < 2):
            raise AssertionError(f"mesh w=2^30 {route}: planted key "
                                 f"{key:#x}: {res}, {scans} residue scans")
        log(f"mesh w=2^30 sharded, {route} route: planted key {key:#x} of "
            f"epoch 1 found after {res.epochs} drained epochs with the slot "
            f"planted in epoch 0 ({res.hits_checked} hits checked, {scans} "
            f"residue scans through the broadcast rows, {took:.2f} s)")
        read_launches(path, path_launches)  # the first counts the build
        _cuda.reset_launches()
        solvers[route] = ms
        solves[route] = dict(solve_s=took, residue_scans=scans,
                             hits_checked=res.hits_checked)
    log(f"mesh w=2^30 sharded: built over the group in {t_build:.2f} s "
        f"(peak {peak} B above what was allocated before), equal to the "
        f"single-card table")
    records = {}
    for route in ("all_gather", "all_to_all"):
        ms = solvers[route]
        batch, _ = ms._collect(ecpy.mul(key), pk, ms._dispatch(q0, 0))
        records[route] = sorted([r[0].job_base, *r[1:]] for r in batch)
    if not records["all_gather"] or (records["all_to_all"]
                                     != records["all_gather"]):
        raise AssertionError(f"super-epoch 0's records by route: {records}")
    log(f"mesh w=2^30 sharded: super-epoch 0 decodes to the same "
        f"{len(records['all_gather'])} records through both routes "
        f"{records['all_gather']}")
    streams = phase_streams(single, SEED)
    for route in ("all_gather", "all_to_all"):
        check_mesh_probe(f"mesh w=2^30 sharded, {route} route",
                         solvers[route], streams, baby.dense)
    del streams
    unplant_slot(baby, row, col)
    baby.pos_lo[row, col] = 0
    pub = ecpy.mul((1 << 200) + 12345)
    for s in solvers.values():
        s.solve(pub, pk, pk + cfg.keys_per_epoch - 1, max_epochs=1)
    rates = scans_in_turns(solvers, ("plain", "all_gather", "all_to_all",
                                     "all_to_all", "all_gather", "plain",
                                     "plain", "all_gather", "all_to_all"),
                           pub, pk, 8)
    log(f"mesh w=2^30: 8-epoch scans, giant-steps/s, plain Solver "
        f"{rates['plain']}, sharded all_gather {rates['all_gather']}, "
        f"sharded all_to_all {rates['all_to_all']}")
    # per epoch, each of its probe streams makes two collectives and the
    # hits one all_gather (a lookup's broadcasts are not counted here)
    streams = 2 * cfg.phases + 1
    expected = dict(
        all_gather=dict(all_gather=streams + 1, all_reduce_max=streams),
        all_to_all=dict(all_to_all=2 * streams, all_gather=1))
    per_route = {}
    for route in ("all_gather", "all_to_all"):
        ms = solvers[route]
        prof = profile_scan(ms, pub, pk, epochs=4)
        costs = collective_costs(ms, pub, pk, 4)
        calls = {k: n for k, n in costs["calls_per_epoch"].items()
                 if k != "broadcast"}
        if calls != dict(expected[route], probe=streams):
            raise AssertionError(f"{route}: collectives per epoch {calls}, "
                                 f"expected {expected[route]} and {streams} "
                                 f"probes")
        waits = count_syncs(ms, pub, pk, epochs=8,
                            label=f" (mesh w=2^30 {route})")
        per_route[route] = dict(profile=prof, collectives=costs,
                                host_waits_per_epoch=waits / 8,
                                **solves[route])
    del solvers, ms, base, baby
    torch.cuda.empty_cache()
    return dict(build_s=t_build, build_peak=peak, records=records,
                rates=rates, routes=per_route)


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

    kinds = ("all_gather", "all_to_all", "all_reduce_max", "broadcast")
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

    from bsgs_tpu_torch.models import giant
    from bsgs_tpu_torch.ops import epoch_kernel as EK
    from bsgs_tpu_torch.utils import ecpy

    cfg = solver.cfg
    per = cfg.jobs_per_epoch // solver._phases
    cx, cy, _ = solver._centers_on_device(ecpy.mul((1 << 190) + seed), 0)
    keys = EK.epoch_landing_keys_packed(
        cx[:, :per], cy[:, :per], solver.ox_pk, solver.oy_pk, htsz=cfg.htsz,
        chunk_c=cfg.chunk_c, lanes_w=cfg.lanes_w)
    gen = torch.Generator(device=cx.device)
    gen.manual_seed(seed)
    plus = plant_members(keys[0].clone(), keys[1].clone(), solver.baby.rows,
                         gen)
    return [plus, (keys[2].clone(), keys[3].clone()),
            giant.center_keys(cx, cfg.htsz)]


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
        part = T.BabyTable(w=cfg.w, htsz=cfg.htsz, window=cfg.window,
                           offsets=whole.offsets, disc_sorted=None,
                           pos_sorted=None, dense=dense, pos_lo=hint,
                           n_table_shards=n, shard=s)
        check_row_lengths(f"partition: shard {s} of {n}", part)
        if not torch.equal(part.row_len.long(), cnt):
            raise AssertionError(f"shard {s} of {n}: row_len differs from "
                                 f"its build's counts")
        specs.append(ST.spec_from_presharded(part))
        del hint, part
    log(f"partition: {n} shards of the w=2^30 table, each equal to its rows "
        f"of the single-card table: {json.dumps(builds)}")
    routes = []
    for label, (bucket, disc) in zip(("+ landings", "- landings",
                                      "centers"), phase_streams(single,
                                                                SEED)):
        want = PK.probe_rows(bucket, disc, *whole.rows)
        if not torch.equal(want, whole_row_probe(bucket, disc, whole.dense)):
            raise AssertionError(f"the {label} stream: the probe differs "
                                 f"from the whole-row probe")
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
            lambda: PK.probe_rows(bucket, disc, *whole.rows), 5,
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
        if t == 128:
            out[t]["profile"] = profile_scan(s, pub, pk, epochs=3)
        log(f"T={t}: centers {centers_ms:.2f} ms of host time per epoch; "
            f"3-epoch scan {1e3 * wall / 3:.2f} ms per epoch, "
            f"{res.giant_steps / wall:.1f} giant-steps/s")
    return out



# ---------------------------------------------------------------------------
# The row-major surface, the unfused epoch (any N) and cross-epoch
# pipelining


def rowmajor_ops(device, m: int = 2048) -> dict:
    """The row-major field and EC ops (ops/field.py, ops/ec.py) on the card
    against the same ops on the CPU, bit for bit, at m lanes: random
    canonical values with the inversion's edge values planted, and points
    of a doubling fill. scalar_mul is left to the CPU tests (its 255
    doublings are some 10^6 small launches here). Returns seconds by
    op, card and CPU."""
    import numpy as np
    import torch

    from bsgs_tpu_torch.ops import ec, field as F
    from bsgs_tpu_torch.utils import ecpy

    rng = np.random.default_rng(SEED + 8)
    a = plant_edge_lanes(random_planes(rng, 16, m, "cpu")).long().T
    b = random_planes(rng, 16, m, "cpu").long().T
    one = F.broadcast_const(1)
    step = ecpy.mul(3 << 100)
    c = ecpy.mul(m << 100)
    col = [torch.from_numpy(F.to_limbs(v).astype(np.int64))
           for v in (*c, *ecpy.dbl(c))]
    ops = {
        "add_raw": lambda x, y, px, py: F.add_raw(x, y),
        "sub_raw": lambda x, y, px, py: F.sub_raw(x, y),
        "geq": lambda x, y, px, py: F.geq(x, y),
        "eq": lambda x, y, px, py: F.eq(x, x) & ~F.eq(x, y),
        "is_zero": lambda x, y, px, py: F.is_zero(x),
        "add_mod": lambda x, y, px, py: F.add_mod(x, y),
        "sub_mod": lambda x, y, px, py: F.sub_mod(x, y),
        "neg_mod": lambda x, y, px, py: F.neg_mod(x),
        "mul_mod": lambda x, y, px, py: F.mul_mod(x, y),
        "sqr_mod": lambda x, y, px, py: F.sqr_mod(x),
        "mul_small_mod": lambda x, y, px, py: F.mul_small_mod(x, 977),
        "pow_mod_bits": lambda x, y, px, py: F.pow_mod_bits(x, 65537),
        "inv_mod": lambda x, y, px, py: F.inv_mod(x),
        "shifts_bits": lambda x, y, px, py: (
            F.shr_bits(x, 17), F.shl_bits(x, 200), F.test_bit(x, 255),
            F.is_even(x)),
        "x_prefix64": lambda x, y, px, py: F.x_prefix64(x),
        "batch_inv": lambda x, y, px, py: ec.batch_inv(
            F.add_mod(y, one.to(y.device))),
        "fill_multiples": lambda x, y, px, py: ec.fill_multiples(
            ecpy.G, step, m, with_inf=True, device=x.device),
        "point_dbl": lambda x, y, px, py: ec.point_dbl(px, py),
        "point_add_full": lambda x, y, px, py: ec.point_add_full(
            px, py, x[:, 0] == 0, px.flip(0), py.flip(0), x[:, 1] == 0),
        "add_common": lambda x, y, px, py: ec.add_common(
            px, py, *(v.to(x.device) for v in col)),
        "extend_tile": lambda x, y, px, py: ec.extend_tile(
            px, py, *(v.to(x.device) for v in col)),
    }
    px, py = ec.fill_multiples(ecpy.G, step, m, device="cpu")
    args = {"cpu": (a, b, px, py),
            "cuda": tuple(v.to(device) for v in (a, b, px, py))}
    took = {}
    for name, fn in ops.items():
        outs = {}
        for where in ("cuda", "cpu"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args[where])
            torch.cuda.synchronize()
            took.setdefault(name, {})[where] = time.perf_counter() - t0
            outs[where] = out if isinstance(out, tuple) else (out,)
        for g, w in zip(*outs.values()):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"row-major {name}: card and CPU "
                                     f"differ at {m} lanes")
    log(f"row-major ops at {m} lanes: card == CPU, bit for bit, for "
        f"{', '.join(ops)}; seconds card/CPU "
        + ", ".join(f"{k} {v['cuda']:.3f}/{v['cpu']:.3f}"
                    for k, v in took.items()))
    return took


def unfused_w26(baby, path_launches: dict) -> dict:
    """The command line at --w 26 --n-offsets 262143, an N that no chain
    layout fits (solver.chain_layout refuses it): a planted key of epoch 1
    found through the unfused epoch, counted as the "cli unfused w=2^26"
    path; then, on phase 3's table, 8-epoch scans timed (LAUNCHES_PER_EPOCH_
    UNFUSED per epoch), the scan's peak device memory above the table and
    offsets, and a profile."""
    import torch

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.ops import _cuda
    from bsgs_tpu_torch.utils import codecs, ecpy

    cfg = S.SolverConfig(w=1 << 26, n_offsets=UNFUSED_N)
    try:
        S.chain_layout(cfg.n_offsets, cfg.jobs_per_epoch // cfg.phases)
        raise AssertionError(f"chain_layout took N={UNFUSED_N}")
    except ValueError:
        pass
    rng = random.Random(SEED + 262143)
    kpe = cfg.keys_per_epoch
    pk = 1 << 42
    key = pk + kpe + rng.randrange(kpe)
    _cuda.reset_launches()
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            rc, text, err, took = run_cli(
                ["--pub", codecs.format_pubkey(ecpy.mul(key)), "--w", 26,
                 "--n-offsets", UNFUSED_N, "--pk", f"{pk:x}",
                 "--pke", f"{pk + 3 * kpe - 1:x}"],
                f"--n-offsets {UNFUSED_N}, unfused")
            if rc != 0 or read_win() != [win_line(key)]:
                raise AssertionError(f"cli unfused: {rc} {text[-300:]} "
                                     f"{err}")
        finally:
            os.chdir(here)
    read_launches("cli unfused w=2^26", path_launches,
                  kernels=UNFUSED_KERNELS, epoch_folds=True)
    solver = S.Solver(cfg, baby=baby, device=baby.dense.device)
    if solver.fused:
        raise AssertionError("the solver took the fused epoch")
    pub = ecpy.mul((1 << 200) + 4242)
    solver.solve(pub, pk, pk + kpe - 1, max_epochs=1)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rates, _ = timed_scans(solver, pub, pk, epochs=8, repeats=2,
                           per_epoch=LAUNCHES_PER_EPOCH_UNFUSED)
    peak = torch.cuda.max_memory_allocated() - held
    log(f"unfused w=2^26, N={UNFUSED_N}, T=16: 8-epoch scans "
        f"{', '.join(f'{r:.1f}' for r in rates)} giant-steps/s; peak device "
        f"memory {peak} B above the table and offsets "
        f"({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB in all)")
    prof = profile_scan(solver, pub, pk, epochs=3)
    return dict(cli_seconds=took, rates=rates, peak_bytes=peak,
                launches_per_epoch=LAUNCHES_PER_EPOCH_UNFUSED, profile=prof)


def _plant_landings(baby, cfg, cx, cy, picks):
    """Write the discs of the landings (code, t, j) (1: x(M_t + O_j), 2:
    x(M_t - O_j), 5: x(M_t)) into free slots of the table; returns the
    slots, for undoing it."""
    from bsgs_tpu_torch.models import table as T
    from bsgs_tpu_torch.ops import field as F
    from bsgs_tpu_torch.utils import ecpy

    slots = []
    for code, t, j in picks:
        m_pt = (F.from_limbs(cx[t]), F.from_limbs(cy[t]))
        o_pt = ecpy.mul(j * cfg.stride)
        pt = {1: lambda: ecpy.add(m_pt, o_pt), 2: lambda: ecpy.sub(m_pt, o_pt),
              5: lambda: m_pt}[code]()
        pre = pt[0] & ((1 << 64) - 1)
        bucket = pre >> (64 - cfg.htsz)
        slots.append((bucket, plant_slot(
            baby, bucket, T._i32((pre >> (32 - cfg.htsz)) & 0xFFFFFFFF))))
    return slots


def unfused_vs_fused(solver, baby) -> dict:
    """One epoch at N=2^18, T=16 through the fused epoch (4 phases) and the
    unfused one, the same centers, on phase 3's table with the landings of
    six (code, t, j) planted: the decoded hit records (code, t, j) are the
    same set, the planted ones in it."""
    import dataclasses

    from bsgs_tpu_torch.models import giant, solver as S
    from bsgs_tpu_torch.utils import ecpy

    cfg = solver.cfg
    un = S.Solver(dataclasses.replace(cfg, fused=False), baby=baby,
                  device=solver.device)
    q0 = ecpy.mul((1 << 150) + 31337)
    cx, cy, _ = solver.epoch_centers(q0, 0, cfg.jobs_per_epoch)
    picks = [(1, 0, 1), (2, 3, 5), (1, 7, cfg.n_offsets), (2, 15, 77777),
             (5, 9, 0), (1, 12, 131072)]
    slots = _plant_landings(baby, cfg, cx, cy, picks)
    try:
        sets = {}
        for name, s in (("fused", solver), ("unfused", un)):
            _, _, idxs, cnt, _ = s._epoch(q0, 0)
            flat = giant.hit_indices(idxs.cpu().numpy())
            if int(cnt) != len(flat):
                raise AssertionError(f"{name}: {int(cnt)} hits, "
                                     f"{len(flat)} decoded")
            sets[name] = {giant.decode_flat_phased(
                int(f), cfg.jobs_per_epoch, cfg.n_offsets, s._phases)
                for f in flat}
    finally:
        for bucket, col in reversed(slots):
            unplant_slot(baby, bucket, col)
    if sets["fused"] != sets["unfused"] or not set(picks) <= sets["fused"]:
        raise AssertionError(f"hit records differ: {sets}")
    log(f"unfused vs fused epoch at N=2^18, T=16: the same "
        f"{len(sets['fused'])} hit records {sorted(sets['fused'])}")
    return dict(records=sorted(sets["fused"]))


def cross_pipeline_w26(solver, baby, path_launches: dict) -> dict:
    """The main path's shapes (w=2^26, T=16, N=2^18) with
    cross_pipeline=True: a planted key of epoch 1 found, counted as the
    "pipelined w=2^26" path; 8-epoch scans of the pipelined and the direct
    solver in turns; a profile of each (host and device-busy ms per
    epoch, and how long probe kernels ran under the epoch's others on
    another stream)."""
    import dataclasses

    import torch

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.ops import _cuda
    from bsgs_tpu_torch.utils import ecpy

    cfg = dataclasses.replace(solver.cfg, cross_pipeline=True)
    rng = random.Random(SEED + 3)
    _cuda.reset_launches()
    ps = S.Solver(cfg, baby=baby, device=solver.device)
    if not ps._pipelined:
        raise AssertionError("the solver is not pipelined")
    pk = 1 << 43
    key = pk + cfg.keys_per_epoch + rng.randrange(cfg.keys_per_epoch)
    res = ps.solve(ecpy.mul(key), pk, pk + 3 * cfg.keys_per_epoch - 1)
    torch.cuda.synchronize()
    if res.key != key:
        raise AssertionError(f"pipelined: planted key {key:#x} not found: "
                             f"{res}")
    log(f"pipelined w=2^26: planted key {key:#x} found after {res.epochs} "
        f"drained epochs")
    read_launches("pipelined w=2^26", path_launches, epoch_folds=True)
    pub = ecpy.mul((1 << 200) + 12345)
    ps.solve(pub, pk, pk + cfg.keys_per_epoch - 1, max_epochs=1)
    rates = scans_in_turns(
        {"direct": solver, "pipelined": ps},
        ("direct", "pipelined", "pipelined", "direct", "direct",
         "pipelined"), pub, pk, 8,
        per_epoch={"pipelined": LAUNCHES_PER_EPOCH_PIPELINED})
    log(f"pipelined w=2^26: 8-epoch scans, giant-steps/s, direct "
        f"{rates['direct']}, pipelined {rates['pipelined']}")
    profiles = {name: profile_scan(s, pub, pk, epochs=4)
                for name, s in (("direct", solver), ("pipelined", ps))}
    if profiles["pipelined"]["streams"] < 2:
        raise AssertionError(f"the pipelined scan ran on one stream: "
                             f"{profiles['pipelined']}")
    return dict(rates=rates, profiles=profiles,
                launches_per_epoch=LAUNCHES_PER_EPOCH_PIPELINED)


def mesh_unfused(mesh, baby, path_launches: dict) -> dict:
    """MeshSolver over an unfused base solver (w=2^26, N=262143) in the
    group of one, the table replicated, and split into one shard probed
    by (hi, lo) prefixes through the all_gather and through the all_to_all
    route: a planted key of super-epoch 1 found through each, counted as
    the "mesh unfused replicated", "mesh unfused sharded" and "mesh
    unfused sharded all_to_all" paths."""
    import torch

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.ops import _cuda
    from bsgs_tpu_torch.parallel import striped
    from bsgs_tpu_torch.utils import ecpy

    cfg = S.SolverConfig(w=1 << 26, n_offsets=UNFUSED_N)
    rng = random.Random(SEED + 5)
    out = {}
    for label, kw in (("replicated", {}),
                      ("sharded", dict(shard_baby_table=True)),
                      ("sharded all_to_all", dict(
                          shard_baby_table=True,
                          probe_routing="all_to_all"))):
        _cuda.reset_launches()
        t0 = time.time()
        base = S.Solver(cfg, baby=baby, device=mesh.device)
        ms = striped.MeshSolver(base, mesh, **kw)
        if ms.fused:
            raise AssertionError("the mesh took the fused epoch")
        pk = 1 << 44
        key = pk + cfg.keys_per_epoch + rng.randrange(cfg.keys_per_epoch)
        res = ms.solve(ecpy.mul(key), pk, pk + 3 * cfg.keys_per_epoch - 1)
        torch.cuda.synchronize()
        if res.key != key:
            raise AssertionError(f"mesh unfused {label}: planted key "
                                 f"{key:#x} not found: {res}")
        out[label] = dict(seconds=time.time() - t0, epochs=res.epochs)
        log(f"mesh unfused {label}: planted key {key:#x} of super-epoch "
            f"{res.epochs - 1} in {out[label]['seconds']:.2f} s")
        read_launches(f"mesh unfused {label}", path_launches,
                      kernels=UNFUSED_KERNELS, epoch_folds=True)
        del base, ms
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

    # 1. build (with the side library of the field operations; with
    # epoch_bwd's study under --epoch-bwd, the probe's under --probe)
    side = SideLib(study=sys.argv[1:] == ["--epoch-bwd"],
                   probe_study=sys.argv[1:] == ["--probe"],
                   plane_study=sys.argv[1:] == ["--packed"])
    took, libs, costs = build_kernels(side)
    log(f"phase 1: kernels built in {took:.1f} s")
    torch.cuda.synchronize()
    if sys.argv[1:] == ["--builds"]:
        print(json.dumps(build_times(device)))
        print(card)
        return 0
    if side.probe_study:
        print(json.dumps(sweep_probe(side, libs, device)))
        print(card)
        return 0
    if side.plane_study:
        print(json.dumps(sweep_packed(side, libs, costs, device)))
        print(card)
        return 0
    bwd = epoch_bwd_checks(libs, side, costs, device)
    if side.study:
        print(json.dumps(bwd))
        print(card)
        return 0
    resources = mont_resources(libs)
    packed_res = packed_resources(libs)

    # 2. each epoch and table kernel against its plain version
    records = check_kernels(device, "w=2^26 shapes", htsz=20,
                            m_tab=1 << 18, time_trees=True, costs=costs)
    records["fermat"]["widths"] = check_inversion(
        device, (2048, 16384, 131072), costs)
    records.update(check_mont(device, 1 << 18, "w=2^26 shapes", costs))
    records["epoch_bwd"]["checks"] = bwd
    for name in ("epoch_fwd", "add_const"):
        records[name]["resources"] = packed_res[name]
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
    check_row_lengths("w=2^26 table", baby)
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
    records["epoch_bwd"]["epoch_profile_t16"] = profile_scan(solver, pub, pk,
                                                          epochs=4)
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
    records["epoch_bwd"]["epoch_profile_t128"] = cli_out["jobs_128"][128][
        "profile"]
    torch.cuda.synchronize()

    # the parallel layer in a group of one rank on NCCL: MeshSolver over a
    # replicated w=2^26 table, its scans beside the plain Solver's
    mesh = mesh_of_one()
    mesh_out = dict(w26=mesh_replicated(mesh, solver, path_launches))
    torch.cuda.synchronize()

    # the row-major surface, the unfused epoch at an N that no chain layout
    # fits, the same hits from both epochs, cross-epoch pipelining, and the
    # mesh over the unfused epoch
    any_n = dict(rowmajor=rowmajor_ops(device))
    any_n["unfused_w26"] = unfused_w26(baby, path_launches)
    any_n["unfused_vs_fused"] = unfused_vs_fused(solver, baby)
    any_n["cross_pipeline_w26"] = cross_pipeline_w26(solver, baby,
                                                     path_launches)
    any_n["mesh_unfused"] = mesh_unfused(mesh, baby, path_launches)
    log(f"unfused and pipelined: {json.dumps(any_n, default=str)}")
    torch.cuda.empty_cache()

    # 7. the streamed path: w=2^30, rescan positions, deferred verification
    del solver, baby
    torch.cuda.empty_cache()
    cfg = S.SolverConfig(w=1 << 30)
    if (cfg.htsz, S.VERIFY_DEFER_EPOCHS) != (24, 64):
        raise AssertionError(f"unexpected big-w defaults: {cfg}")
    # this path gives the six kernels other inputs: 24 bucket bits in the
    # key plane, and 2^20-lane tiles in the build and the residue scans
    records_big = check_kernels(device, "w=2^30 shapes", htsz=cfg.htsz,
                                m_tab=1 << 20, time_trees=False, costs=costs)
    records_big.update(check_mont(device, 1 << 20, "w=2^30 shapes", costs))
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
    check_row_lengths("w=2^30 table", baby)
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
    unplant_slot(baby, fp_row, fp_col)
    baby.pos_lo[fp_row, fp_col] = 0
    torch.cuda.synchronize()

    # the parallel layer at w=2^30: the table built over the group of one
    # and scanned through both probe routes, the 4-way partition in one
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
    # the probe reads no limb planes: its bound_ms_planes is its floor
    records["probe_rows"] = dict(
        name="probe_rows", route="cuda",
        source="bsgs_tpu_torch/csrc/probe_kernels.cu",
        replaces=TPU_KERNEL["probe_rows"], launches=0, max_abs_err=0,
        ms=main_stream["ms"], plain_ms=main_stream["plain_ms"],
        bound_ms=main_stream["bound_ms"], bound_by="bytes",
        library_ms=None, bound_ms_planes=main_stream["bound_ms"],
        bound_ms_whole_row=main_stream["bound_ms_whole_row"],
        ms_l2_cold=main_stream["ms_l2_cold"],
        ms_w30_table=big_stream["ms"],
        ms_l2_cold_w30_table=big_stream["ms_l2_cold"],
        plain_ms_w30_table=big_stream["plain_ms"],
        bound_ms_w30_table=big_stream["bound_ms"],
        bound_ms_whole_row_w30_table=big_stream["bound_ms_whole_row"],
        shapes=probe + probe_big)
    for name, rec in records_big.items():
        records[name]["w30_shapes"] = {
            k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "bound_ms_planes")}
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
