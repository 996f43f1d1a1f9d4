"""Run one cell of the benchmark of bsgs_tpu_torch once, on the card.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the last lines of standard error are the numbers compared
with the plain reference, each beside its limit. A cell of several cards
runs one process a card (harness.run_ranks). Exits 2, printing no
result, without as many CUDA cards as the cell asks for or without the
package; 3 if the process holds JAX or the JAX package after the window.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with few threads: the solve loop's host work is one Python
# thread, and idle CPU thread pools spinning beside it take the host's
# cores from it (measured: a steadier and lower solve_ms_p95). Set before
# numpy and torch load.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

ROOT = Path(__file__).resolve().parents[1]


def fail(code: int, msg: str) -> int:
    print(f"benchmarks/run.py: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import harness
    from benchmarks.reference import secp256k1

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        return fail(2, "no CUDA device: this benchmark measures the card "
                       "and never runs on the CPU")
    if torch.cuda.device_count() < cell.chips:
        return fail(2, f"{cell.name} needs {cell.chips} cards, "
                       f"{torch.cuda.device_count()} present")
    try:
        import bsgs_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(2, f"the program is not in this checkout: {e}")
    host_s = secp256k1.host_additions(1000)
    print(f"host control: 1000 affine additions in {host_s * 1e3:.3f} ms; "
          f"card: {harness.card_info()}", flush=True)
    if cell.chips > 1:  # one process a card, started here
        run = harness.run_ranks(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda", T_PROCESS, ROOT)
    else:
        run = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_PROCESS, ROOT)
    bad = sorted(set(harness.forbidden_modules()) | set(run.forbidden))
    if bad:
        return fail(3, f"the process holds {bad} after the window")
    out = harness.result(run, torch.cuda.get_device_name(0), ROOT)
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_parts.items())
    print(f"window: {len(run.solves)} solves, {run.epochs} epochs, "
          f"{run.window_s:.3f} s; set-up {run.setup_s:.3f} s (build "
          f"{run.build_s:.3f} s, {parts})", flush=True)
    for line in harness.compared_lines(run):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
