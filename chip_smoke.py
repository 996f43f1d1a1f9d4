#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU.

    python3 chip_smoke.py

Phases, each followed by torch.cuda.synchronize(); any failure exits
nonzero:

1. build the CUDA kernels of bsgs_tpu_torch/csrc with nvcc (sm_90a);
2. run each of the six kernels and its plain PyTorch version on the card
   at the main path's shapes and require bit-identical outputs, timing
   both; time one epoch phase at chain lengths 4, 8 and 16 and require
   the same key plane from each;
3. build the w=2^26 baby table (htsz=20, 128-slot rows, tile 2^18);
4. solve a planted key in the second epoch at N=2^18, T=16, 4 phases,
   3 epochs in flight;
5. time 8-epoch scans of a pubkey with no key in range (giant-steps/s)
   and profile a short one (device time by kernel, busy share, the host's
   waits for the device);
6. print the kernels' JSON line (launch counts from phases 3-4, which
   must all be > 0), the card's name and power limit, and the result line.

Needs one CUDA card; exits nonzero without one, or without the package
beside it.
"""

from __future__ import annotations

import collections
import json
import os
import random
import subprocess
import sys
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
# inv_mod: 255 squarings and 13 + popcount(0xFFFFFC2D) multiplies
OPS_FERMAT = (255 + 13 + bin(0xFFFFFC2D).count("1")) * OPS_MUL

TPU_KERNEL = {
    "epoch_fwd": "bsgs_tpu/ops/epoch_kernel.py:48",
    "epoch_bwd": "bsgs_tpu/ops/epoch_kernel.py:64",
    "mont_fwd": "bsgs_tpu/ops/epoch_kernel.py:107",
    "mont_bwd": "bsgs_tpu/ops/epoch_kernel.py:122",
    "fermat": "bsgs_tpu/ops/epoch_kernel.py:132",
    "add_const": "bsgs_tpu/ops/epoch_kernel.py:198",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def build_kernels() -> float:
    from bsgs_tpu_torch.ops import _cuda

    t0 = time.time()
    _cuda.build(verbose=True)
    _cuda._load()
    return time.time() - t0


def check_kernels(device, T: int = 4, N: int = 1 << 18, htsz: int = 20):
    """Each kernel against its plain version at the main path's shapes:
    one epoch phase (T=4 centers x N offsets), its chain totals for the
    Montgomery passes, the Fermat width they recurse to, and one 2^18-lane
    table pass for add_const. Returns the per-kernel records."""
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
    v_tot = random_planes(rng, 16, m_tot, device)
    m_fermat = m_tot
    while m_fermat > EK.FERMAT_MAX:
        m_fermat = m_fermat // (C * W) * W
    v_fermat = random_planes(rng, 16, m_fermat, device)
    m_tab = N  # one table tile
    xs = random_planes(rng, 16, m_tab, device)
    ys = random_planes(rng, 16, m_tab, device)
    inv = random_planes(rng, 16, m_tab, device)
    ccx = random_planes(rng, 16, 1, device)
    ccy = random_planes(rng, 16, 1, device)
    xs[:, 1234] = ccx[:, 0]  # a doubling lane

    pre, tot = EK.epoch_fwd(ox, cx, chunk_c=C, lanes_w=W)
    itot = EK.batch_inv_planar(tot)
    vpre, _ = EK.mont_fwd(v_tot, chunk_c=C, lanes_w=W)
    vitot = random_planes(rng, 16, m_tot // C, device)
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
        "mont_fwd": (
            lambda: EK.mont_fwd(v_tot, chunk_c=C, lanes_w=W),
            lambda: EK.mont_fwd_plain(v_tot, chunk_c=C, lanes_w=W),
            m_tot * OPS_MUL, 2 * m_tot + m_tot // C, 0),
        "mont_bwd": (
            lambda: EK.mont_bwd(v_tot, vpre, vitot, chunk_c=C, lanes_w=W),
            lambda: EK.mont_bwd_plain(v_tot, vpre, vitot, chunk_c=C,
                                      lanes_w=W),
            m_tot * 2 * OPS_MUL, 3 * m_tot + m_tot // C, 0),
        "fermat": (
            lambda: EK.fermat(v_fermat),
            lambda: EK.fermat_plain(v_fermat),
            m_fermat * OPS_FERMAT, 2 * m_fermat, 0),
        "add_const": (
            lambda: EK.add_const(xs, ys, inv, ccx, ccy),
            lambda: EK.add_const_plain(xs, ys, inv, ccx, ccy),
            m_tab * (4 * OPS_MUL + 6 * OPS_ADD), 5 * m_tab + 2,
            2 * m_tab * 4),
    }
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
        ms = cuda_ms(kern, reps=20 if name != "fermat" else 5)
        plain_ms = cuda_ms(plain, reps=1)
        # bound_ms: the planes as the kernels take them, 16 int32 words
        # (64 B) per element; bound_ms_packed: the function's own floor,
        # 32 B per element
        op_s = ops / INT32_OPS_PER_S
        byte_s = (64 * elems + other) / HBM_BYTES_PER_S
        packed_s = (32 * elems + other) / HBM_BYTES_PER_S
        bound_ms = 1e3 * max(op_s, byte_s)
        bound_by = "operations" if op_s >= byte_s else "bytes"
        records[name] = dict(
            name=name, route="cuda",
            source="bsgs_tpu_torch/csrc/epoch_kernels.cu",
            replaces=TPU_KERNEL[name], launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, bound_ms_packed=1e3 * max(op_s, packed_s),
            bound_by_packed="operations" if op_s >= packed_s else "bytes")
        log(f"kernel {name}: bit-identical to plain; {ms:.4f} ms "
            f"(plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by}, {1e3 * max(op_s, packed_s):.4f} ms at 32 B per "
            f"element); exact/doubling lanes included")
        torch.cuda.synchronize()

    # the chain length changes no output bit, only the time
    keys = {}
    for c in (4, 8, 16):
        def phase(c=c):
            return EK.epoch_landing_keys(cx, cy, ox, oy, htsz=htsz,
                                         chunk_c=c, lanes_w=W)
        keys[c] = phase()
        log(f"chain length {c}: epoch_landing_keys {cuda_ms(phase, 10):.4f}"
            f" ms per phase (T={T}, N={N}, W={W})")
    if any(not torch.equal(keys[c], keys[C]) for c in keys):
        raise AssertionError("key planes differ between chain lengths")
    torch.cuda.synchronize()
    return records


def profile_scan(solver, pub, pk: int, epochs: int) -> None:
    """Where an epoch's time goes: torch.profiler over a short scan, device
    time by kernel, the device's busy share of the wall time, and the host
    time spent queueing epochs (Solver._dispatch)."""
    import torch
    from torch.autograd import DeviceType
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

    rows = sorted(
        (e for e in prof.key_averages()
         if getattr(e, "device_type", None) == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    log(f"profile: {epochs} epochs in {wall * 1e3:.2f} ms wall (profiler "
        f"on); device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%); "
        f"host queueing {1e3 * sum(host) / len(host):.2f} ms per epoch")
    for e in rows[:10]:
        us = e.self_device_time_total
        log(f"profile: {us / 1e3 / epochs:8.3f} ms/epoch "
            f"{100 * us / 1e6 / busy:5.1f}% x{e.count // epochs:<4d} "
            f"{e.key[:80]}")


def count_syncs(solver, pub, pk: int, epochs: int) -> None:
    """The host's waits for the device during a scan, by source line, from
    PyTorch's sync debug mode: the solve loop means to wait once per epoch,
    in Solver._collect's int(cnt), plus hit readback when an epoch hits."""
    import torch

    cfg = solver.cfg
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solver.solve(pub, pk, pk + epochs * cfg.keys_per_epoch - 1,
                         max_epochs=epochs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(
        f"{Path(w.filename).parent.name}/{Path(w.filename).name}:{w.lineno}"
        for w in caught if "synchronizing CUDA operation" in str(w.message))
    log(f"syncs: {sum(sites.values())} host waits in {epochs} epochs "
        f"{dict(sites)}")


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
        from bsgs_tpu_torch.ops import epoch_kernel as EK
        from bsgs_tpu_torch.utils import ecpy
    except ImportError as e:
        print(f"chip_smoke: the bsgs_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    if torch.cuda.device_count() != 1:
        raise AssertionError(f"{torch.cuda.device_count()} cards visible")
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    log(f"phase 1: kernels built in {build_kernels():.1f} s")
    torch.cuda.synchronize()

    # 2. each kernel against its plain version
    records = check_kernels(device)
    torch.cuda.synchronize()

    # 3-4. the main path, counted: table build, solver set-up, planted solve
    cfg = S.SolverConfig(w=1 << 26)
    EK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    baby = S.build_table(cfg, device=device)
    torch.cuda.synchronize()
    t_table = time.time() - t0
    stats = T.table_stats(baby)
    log(f"phase 3: w=2^26 table built in {t_table:.2f} s (peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
        f"{stats}")
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
    launches = dict(EK.LAUNCHES)
    for name in EK.KERNELS:
        records[name]["launches"] = launches[name]
        log(f"kernel {name}: {launches[name]} launches on the main path")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")

    # 5. throughput: 8-epoch scans with no key in range, as bench.py times
    pub = ecpy.mul((1 << 200) + 12345)
    solver.solve(pub, pk, pk + cfg.keys_per_epoch - 1, max_epochs=1)
    torch.cuda.synchronize()
    epochs = 8
    rates = []
    for _ in range(3):
        t0 = time.time()
        scan = solver.solve(pub, pk, pk + epochs * cfg.keys_per_epoch - 1,
                            max_epochs=epochs)
        torch.cuda.synchronize()
        rates.append(scan.giant_steps / (time.time() - t0))
        if scan.key is not None or scan.epochs != epochs:
            raise AssertionError(f"unexpected scan result {scan}")
    log(f"phase 5: {epochs}-epoch scans of {scan.giant_steps} giant steps: "
        f"{', '.join(f'{r:.1f}' for r in rates)} giant-steps/s "
        f"(best {max(rates):.1f}) on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_scan(solver, pub, pk, epochs=4)
    count_syncs(solver, pub, pk, epochs=4)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [records[k] for k in EK.KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
