"""The control and the faults: the timed path broken on purpose, which the
judge must find (``correct`` false). The benchmark's own runs never load
this file.

- ``half_rows`` (the control): the probe reads only the first half of
  each row's entries, the step that would tempt a later change (half the
  probe's bytes), and breaks the configuration's guarantee that every key
  in the range is found;
- ``stale_epoch``: every epoch returns the landing keys of the first one
  (a step that leaves its state unchanged);
- ``half_batch``: each probe answers the first half of its keys and
  reports the rest as absent (half of the batch left out);
- ``altered_key``: the verification returns each key it confirms plus
  one (an answer altered where it is produced);
- ``flipped_disc``: the backward pass flips the low bit of every
  M + O_j disc (a landing key altered where it is produced).
- ``no_exchange`` (cells of several cards): the hits of every rank but
  rank 0 never reach the others, nor their own decoding (the exchange
  between cards left out; the same on every rank, so the ranks stay in
  step).

    python3 benchmarks/control.py --workload <cell> --seconds <s> \
        --faults none,half_rows --seeds 11,12,13

builds the cell's table once, then runs a window and the judge for each
fault and seed in turn (``none``: the program as it is), and prints one
line of compared numbers for each.
"""

import contextlib
import os
import sys
import time
from pathlib import Path

os.environ["OMP_NUM_THREADS"] = "1"  # as run.py runs the program
os.environ["MKL_NUM_THREADS"] = "1"

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def half_rows(cr):
    baby = cr.solver.baby
    full = baby.row_len
    baby.row_len = full // 2
    try:
        yield
    finally:
        baby.row_len = full


@contextlib.contextmanager
def _patch(mod, name, make):
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def stale_epoch(cr):
    from bsgs_tpu_torch.ops import epoch_kernel as EK

    def make(orig):
        first = []

        def keys(*a, **kw):
            if not first:
                first.append(orig(*a, **kw))
            return first[0].clone()
        return keys
    return _patch(EK, "epoch_landing_keys_packed", make)


def half_batch(cr):
    from bsgs_tpu_torch.ops import probe_kernel

    def make(orig):
        def probe(bucket, disc, *a, **kw):
            found = orig(bucket, disc, *a, **kw)
            found[found.shape[0] // 2:] = False
            return found
        return probe
    return _patch(probe_kernel, "probe_rows", make)


def altered_key(cr):
    from bsgs_tpu_torch.models import checker

    def make(orig):
        def verify(records, table):
            keys, checked = orig(records, table)
            return [k + 1 for k in keys], checked
        return verify
    return _patch(checker, "verify_hits_batched", make)


def flipped_disc(cr):
    from bsgs_tpu_torch.ops import epoch_kernel as EK

    def make(orig):
        def bwd(*a, **kw):
            out = orig(*a, **kw)
            out[1] ^= 1
            return out
        return bwd
    return _patch(EK, "epoch_bwd_packed", make)


def no_exchange(cr):
    mesh = cr.mesh

    def make(orig):
        def gather(t):
            out = orig(t)
            out.view(mesh.world, -1)[1:, 0] = 0  # the hit counts
            return out
        return gather
    return _patch(mesh, "all_gather", make)


FAULTS = {"half_rows": half_rows, "stale_epoch": stale_epoch,
          "half_batch": half_batch, "altered_key": altered_key,
          "flipped_disc": flipped_disc}
MESH_FAULTS = {"no_exchange": no_exchange}
ALL_FAULTS = {**FAULTS, **MESH_FAULTS}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the control and the faults")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="none,half_rows")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmarks import harness

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    print(f"card: {harness.card_info()}", flush=True)
    t0 = time.perf_counter()
    first = harness.Run(cell, seeds[0], args.seconds, False)
    built = harness.CellRun(cell, seeds[0], "cuda", t0)
    built.setup(first)
    print(f"set-up {time.perf_counter() - t0:.2f} s (build {first.build_s:.2f}"
          f" s)", flush=True)
    for name in args.faults.split(","):
        fault = None if name == "none" else FAULTS[name]
        for seed in seeds:
            run = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                   root=ROOT, fault=fault,
                                   solver=built.solver)
            print(f"{cell.name} fault={name} seed={seed} correct="
                  f"{run.correct} solves={len(run.solves)} "
                  f"checked={run.checked} compared={run.compared}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
