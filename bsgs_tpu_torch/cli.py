"""Command-line solver of the PyTorch/CUDA port:

    python -m bsgs_tpu_torch.cli --pub <pubkey> --pk <hex> --pke <hex> --w 26

Counterpart of ``bsgs_tpu/cli.py`` with the same flags, so that a command
line written for one package runs on the other (the reference binary's
flags, README.md:2-16: -pb, -pk/-pke, -w, -htsz, -infile, -wl, -wt, -sf,
-d). It runs on one CUDA card: the baby table is built on the card (a
rebuild beats loading a file of the same table), every epoch runs the
port's kernels, and every hit is verified on the host.

Found keys are appended to the win file (``<key hex> <pubkey>``) and
printed; checkpoints are written atomically and a resume is refused on
another geometry, range or pubkey. ``main(argv, device="cpu")`` runs the
same flow on the CPU through the kernels' plain versions (the tests).

Not yet in the port: more than one card (``--devices`` > 1,
``--shard-table``, several ``--device-ids``), which exit with code 2.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time


def rate_exponent(rate: float, w: int) -> int:
    """floor(log2(effective keys/s)) for the progress line: rate
    giant-steps/s covers rate * 2w keys/s (the reference's display anchor,
    1_9_7File.pb:5131-5135)."""
    return max(0, int(rate * 2 * w).bit_length() - 1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bsgs_tpu_torch.cli",
        description="secp256k1 BSGS range solver on one CUDA card "
        "(PyTorch/CUDA port of bsgs_tpu)",
    )
    p.add_argument("--pub", "-pb", help="pubkey hex (02/03/04 or 128-hex)")
    p.add_argument("--pk", default="1", help="range start (hex)")
    p.add_argument("--pke", default=None, help="range end (hex)")
    p.add_argument("--w", default="20", help="baby table size: exponent "
                   "(<=64, fractional ok) or decimal count")
    p.add_argument("--htsz", type=int, default=None,
                   help="hash bucket bits (default: auto for the window)")
    p.add_argument("--n-offsets", type=int, default=None,
                   help="giant offsets per job (default: min(2^18, "
                   "max(256, w/4)))")
    p.add_argument("--jobs-per-epoch", type=int, default=None,
                   help="job centers per epoch (default: 16, the port's "
                   "epoch of 4 phases; the JAX CLI's default is 8)")
    p.add_argument("--window", type=int, default=None,
                   help="dense bucket row width (default: 128 slots)")
    p.add_argument("--n-split", type=int, default=8,
                   help="accepted for the JAX CLI's command lines and "
                   "ignored: the port probes an epoch's whole stream in "
                   "one kernel")
    p.add_argument("--pipeline", type=int, default=3,
                   help="epochs in flight before a host sync")
    p.add_argument("--verify-defer-epochs", type=int, default=None,
                   help="drains to pool before batch-verifying hits on "
                   "rescan tables (checkpoints trail verification; "
                   "0 = verify every drain; default 64)")
    p.add_argument("--devices", type=int, default=None,
                   help="number of cards (only 1 in the port so far)")
    p.add_argument("--device-ids", "-d", default=None,
                   help="card index to use (one; the reference's -d)")
    p.add_argument("--shard-table", action="store_true",
                   help="shard the baby table across cards (not yet in "
                   "the port)")
    p.add_argument("--positions", "-sf", default="auto",
                   choices=["auto", "mirror", "rescan"],
                   help="hit-position lookup for streamed big-w builds: "
                   "mirror = a position plane beside the table on the "
                   "card (4 B/slot), rescan = a 2-byte hint per slot and a "
                   "regeneration of 1/256 of the baby stream per surviving "
                   "hit (the reference's -sf file mode); auto = rescan "
                   "from w=2^28")
    p.add_argument("--infile", help="file with one pubkey per line")
    p.add_argument("--resume", "-wl", help="checkpoint file to resume")
    p.add_argument("--checkpoint-file", default="currentwork.json")
    p.add_argument("--checkpoint-interval", "-wt", type=float, default=180.0)
    p.add_argument("--win-file", default="win.txt")
    p.add_argument("--cache-dir", default=".bsgs_cache",
                   help="directory for reusable table artifacts")
    p.add_argument("--tune", action="store_true",
                   help="print suggested geometry for this card and exit")
    p.add_argument("--gen-only", action="store_true",
                   help="build, save and verify the table artifact, then "
                   "exit (the reference's onlygen precompute tool)")
    p.add_argument("--quiet", action="store_true")
    return p


MULTI_DEVICE = ("more than one card (--devices > 1, --shard-table, several "
                "--device-ids) waits for the port's multi-GPU slice; this "
                "port runs on one card")


def _device_line(dev) -> str:
    import torch

    from .utils import tuner

    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
    else:
        name = "cpu"
    return (f"device {dev}: {name}, "
            f"{tuner.device_memory_bytes(dev) / 2**30:.1f} GiB")


def main(argv=None, device=None) -> int:
    """Run the command line; returns the exit code. The run is on ``cuda``
    (``cuda:i`` with ``--device-ids i``) unless ``device`` names another
    device; without a card it raises."""
    args = build_parser().parse_args(argv)

    from . import resolve_device
    from .models import solver as smod, table as tbl
    from .utils import artifacts, checkpoint as ckpt, codecs, tuner

    ids = [int(x) for x in (args.device_ids or "").split(",") if x != ""]
    if (args.devices or 0) > 1 or args.shard_table or len(ids) > 1:
        print(MULTI_DEVICE, file=sys.stderr)
        return 2
    if device is None and ids:
        device = f"cuda:{ids[0]}"
    dev = resolve_device(device)

    if args.tune:
        print(_device_line(dev))
        # size w against the search range when given (the reference's
        # Tune consumes -pk/-pke the same way, 1_9_7File.pb:324-431)
        range_bits = None
        if args.pke is not None:
            pk = codecs.parse_scalar(args.pk)
            pke = codecs.parse_scalar(args.pke)
            if pke > pk:
                range_bits = (pke - pk).bit_length()
        print(tuner.tune(range_bits=range_bits, device=dev).report())
        return 0

    w = codecs.parse_w(args.w)
    window = args.window or tbl.DEVICE_WINDOW
    htsz = args.htsz if args.htsz is not None else tbl.pick_htsz(w, window)

    if args.gen_only:
        cfg = smod.SolverConfig(w=w, htsz=htsz, window=window,
                                positions=args.positions)
        path = artifacts.baby_table_path(args.cache_dir, w, htsz, window)
        if not args.quiet:
            what = "verifying" if os.path.exists(path) else "generating"
            print(f"{what} artifact: w={w} htsz={htsz} -> {path}")
        baby = artifacts.get_baby_table(
            w, htsz, window=window, cache_dir=args.cache_dir, device=dev,
            build=lambda: smod.build_table(cfg, dev))
        if not args.quiet:
            print(tbl.table_stats(baby))
        print("finished ok")
        return 0

    if not args.pub and not args.infile:
        print("need --pub or --infile (or --tune)", file=sys.stderr)
        return 2
    pk = codecs.parse_scalar(args.pk)
    if args.pke is None:
        print("need --pke (range end, hex)", file=sys.stderr)
        return 2
    pke = codecs.parse_scalar(args.pke)
    if pke <= pk:
        print("--pke must be > --pk", file=sys.stderr)
        return 2

    n_offsets = args.n_offsets or min(1 << 18, max(256, w // 4))
    n_devices = len(ids) if ids else (args.devices or 0)
    given = dict(jobs_per_epoch=args.jobs_per_epoch,
                 verify_defer_epochs=args.verify_defer_epochs)
    cfg = smod.SolverConfig(
        w=w, htsz=htsz, n_offsets=n_offsets, window=window,
        pipeline=args.pipeline, positions=args.positions,
        **{k: v for k, v in given.items() if v is not None})
    try:
        cfg.chunk_c, cfg.lanes_w = smod.chain_layout(
            n_offsets, cfg.jobs_per_epoch // cfg.phases)
    except ValueError as e:
        print(f"--n-offsets: {e}", file=sys.stderr)
        return 2
    # the JAX CLI's parameters, so that one geometry has one fingerprint
    fingerprint = ckpt.config_fingerprint(
        w=w, htsz=htsz, n_offsets=n_offsets, pk=pk, pke=pke,
        jobs_per_epoch=cfg.jobs_per_epoch, devices=n_devices,
        shard_table=False,
    )

    def iter_pubs():
        """Lazy pubkey stream: the --pub pubkey first, then --infile one
        line at a time, blank lines skipped (the reference's
        readNextPubFile, 1_9_7File.pb:4370: the file is never loaded
        whole)."""
        if args.pub:
            yield args.pub
        if args.infile:
            with open(args.infile) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield line

    start_index, start_epoch = 0, 0
    if args.resume:
        try:
            ck = ckpt.Checkpoint.load(args.resume, fingerprint)
            ck.bind(next(itertools.islice(iter_pubs(), ck.pub_index, None),
                         None))
        except (ValueError, OSError, KeyError, TypeError) as e:
            print(f"cannot resume: {e}", file=sys.stderr)
            return 2
        start_index, start_epoch = ck.pub_index, ck.next_epoch
        if not args.quiet:
            print(f"resuming at pubkey #{start_index}, epoch {start_epoch}")
    elif os.path.exists(args.win_file):
        # a fresh (non-recovery) start clears the win file, like the
        # reference (1_9_7File.pb:4959-4963)
        os.unlink(args.win_file)

    if not args.quiet:
        print(_device_line(dev))
        print(f"building baby table: w={w} htsz={htsz} ...")
    baby = smod.build_table(cfg, dev)
    if not args.quiet:
        print(tbl.table_stats(baby))
    s = smod.Solver(cfg, baby=baby, device=dev)

    writer = ckpt.CheckpointWriter(
        args.checkpoint_file, fingerprint, args.checkpoint_interval)
    found = 0
    seen = 0
    t_start = time.time()
    stream = iter_pubs()
    following = next(stream, None)
    for idx in itertools.count():
        pub_hex, following = following, next(stream, None)
        if pub_hex is None:
            break
        if idx < start_index:
            continue
        seen += 1
        try:
            pub = codecs.parse_pubkey(pub_hex)
        except codecs.PubkeyError as e:
            print(f"skipping pubkey #{idx}: {e}", file=sys.stderr)
            continue
        pub_id = ckpt.pubkey_id(pub_hex)

        def on_epoch(epoch, steps, _idx=idx, _id=pub_id):
            writer.maybe_write(_idx, _id, epoch + 1, steps)

        def progress(done, total, steps, dt, _w=w):
            # the reference's rate display (1_9_7File.pb:5119-5142):
            # giant-steps/s and the x2w effective keys/s exponent
            if args.quiet or dt <= 0:
                return
            rate = steps / dt
            print(f"\r  epoch {done}/{total}  {rate / 1e6:.2f} Mgsteps/s  "
                  f"(~2^{rate_exponent(rate, _w)} keys/s)", end="",
                  flush=True)

        if not args.quiet:
            note = f" [#{idx + 1}]" if args.infile else ""
            print(f"searching{note} {pub_hex[:24]}... "
                  f"range [{pk:#x}, {pke:#x}]")
        res = s.solve(pub, pk, pke, progress=progress,
                      start_epoch=start_epoch if idx == start_index else 0,
                      on_epoch=on_epoch)
        if not args.quiet:
            print()
        if res.key is not None:
            found += 1
            with open(args.win_file, "a") as f:
                f.write(f"{res.key:064x} {codecs.format_pubkey(pub)}\n")
            print(f"KEY FOUND: {res.key:#x}")
        elif not args.quiet:
            print(f"exhausted range for pubkey #{idx} "
                  f"({res.giant_steps} giant steps, {res.elapsed_s:.1f}s)")
        writer.maybe_write(idx + 1, ckpt.pubkey_id(following), 0, 0,
                           force=True)
    if not args.quiet:
        print(f"done: {found}/{seen} keys in {time.time() - t_start:.1f}s")
    return 0


def _main_with_crashlog(argv=None) -> int:
    """Crash-handler wrapper: dump the traceback to a timestamped error log
    (reference ErrorHandler, 1_9_7File.pb:4299-4367) and re-raise."""
    try:
        return main(argv)
    except KeyboardInterrupt:
        print("\ninterrupted", file=sys.stderr)
        return 130
    except Exception:
        import datetime
        import traceback

        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        path = f"{stamp}_error_log.txt"
        try:
            with open(path, "w") as f:
                f.write(" ".join(sys.argv) + "\n\n")
                traceback.print_exc(file=f)
            print(f"fatal error — details in {path}", file=sys.stderr)
        except OSError:
            pass
        raise


if __name__ == "__main__":
    raise SystemExit(_main_with_crashlog())
