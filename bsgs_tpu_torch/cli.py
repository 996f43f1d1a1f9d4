"""Command-line solver of the PyTorch/CUDA port:

    python -m bsgs_tpu_torch.cli --pub <pubkey> --pk <hex> --pke <hex> --w 26

Counterpart of ``bsgs_tpu/cli.py`` with the same flags, so that a command
line written for one package runs on the other (the reference binary's
flags, README.md:2-16: -pb, -pk/-pke, -w, -htsz, -infile, -wl, -wt, -sf,
-d). The baby table is built on the card (a rebuild beats loading a file
of the same table), every epoch runs the port's kernels (the fused epoch
where a chain layout fits --n-offsets, else the unfused one, which takes
any N), and every hit is verified on the host.

Several cards (``--devices N``, or N ``--device-ids``) run one process a
card, joined by torch.distributed (parallel/): launched plainly, the
command line starts the N ranks itself (``spawn``); under ``torchrun
--nproc-per-node N -m bsgs_tpu_torch.cli ...`` each process joins the
group it finds. The scan is striped over the ranks in super-epochs
(parallel/striped.py); ``--shard-table`` splits the table by bucket range
over them (parallel/sharded_table.py), built split where there are
several. Rank 0 alone prints, writes the win file and checkpoints; the
exit code is not 0 if any rank fails.

Found keys are appended to the win file (``<key hex> <pubkey>``) and
printed; checkpoints are written atomically and a resume is refused on
another geometry, range, pubkey, card count or sharding. ``main(argv,
device="cpu")`` runs the same flow on the CPU through the kernels' plain
versions (the tests), its ranks joined by gloo.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time
from typing import NamedTuple


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
                   help="number of cards, one process each (--tune and "
                   "--gen-only use the first)")
    p.add_argument("--device-ids", "-d", default=None,
                   help="comma-separated card indices to use (the "
                   "reference's -d); their count is the card count")
    p.add_argument("--shard-table", action="store_true",
                   help="split the baby table by bucket range across the "
                   "cards (rescan positions); probes are gathered to "
                   "every card")
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


class Plan(NamedTuple):
    """What the command line resolved from its arguments, the same in
    every rank."""

    pk: int
    pke: int
    cfg: object  # models.solver.SolverConfig
    fingerprint: str
    start_index: int
    start_epoch: int


def _device_line(dev) -> str:
    import torch

    from .utils import tuner

    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
    else:
        name = "cpu"
    return (f"device {dev}: {name}, "
            f"{tuner.device_memory_bytes(dev) / 2**30:.1f} GiB")


def _one_device(device, ids):
    """The device of a run on one card: ``device`` when given, else the
    first of --device-ids, else cuda."""
    from . import resolve_device

    return resolve_device(device if device is not None or not ids
                          else f"cuda:{ids[0]}")


def main(argv=None, device=None) -> int:
    """Run the command line; returns the exit code. The run is on ``cuda``
    (``cuda:i`` with ``--device-ids i``; rank r of several on its own
    card) unless ``device`` names another device; without a card it
    raises."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)

    from .models import solver as smod, table as tbl
    from .parallel import mesh as pmesh
    from .utils import artifacts, codecs, tuner

    ids = [int(x) for x in (args.device_ids or "").split(",") if x != ""]
    if args.tune or args.gen_only:
        dev = _one_device(device, ids)
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
        htsz = args.htsz if args.htsz is not None else tbl.pick_htsz(
            w, window)
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

    plan = _plan(args, ids)
    if isinstance(plan, int):
        return plan
    n = len(ids) if ids else (args.devices or 1)
    if not pmesh.launched() and n > 1:
        return _spawn(argv, n, ids, device)
    return _run(args, plan, ids, device)


def _plan(args, ids):
    """Resolve the arguments into a Plan, or an exit code (2) after saying
    what is wrong; reads the checkpoint of --resume."""
    from .models import solver as smod, table as tbl
    from .parallel import mesh as pmesh
    from .utils import checkpoint as ckpt, codecs

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

    if len(set(ids)) != len(ids):
        print(f"--device-ids {args.device_ids}: each rank needs a card of "
              f"its own, and these repeat one", file=sys.stderr)
        return 2
    w = codecs.parse_w(args.w)
    window = args.window or tbl.DEVICE_WINDOW
    htsz = args.htsz if args.htsz is not None else tbl.pick_htsz(w, window)
    n_offsets = args.n_offsets or min(1 << 18, max(256, w // 4))
    n_devices = len(ids) if ids else (args.devices or pmesh.world_size())
    if args.shard_table and n_devices > 1 and args.positions == "mirror":
        print("--shard-table over several cards builds rescan positions "
              "only: drop --positions mirror", file=sys.stderr)
        return 2
    given = dict(jobs_per_epoch=args.jobs_per_epoch,
                 verify_defer_epochs=args.verify_defer_epochs)
    cfg = smod.SolverConfig(
        w=w, htsz=htsz, n_offsets=n_offsets, window=window,
        pipeline=args.pipeline, positions=args.positions,
        **{k: v for k, v in given.items() if v is not None})
    try:
        cfg.chunk_c, cfg.lanes_w = smod.chain_layout(
            n_offsets, cfg.jobs_per_epoch // cfg.phases)
    except ValueError:
        cfg.fused = False  # no chain layout fits N: the unfused epoch
    # the JAX CLI's parameters, so that one geometry has one fingerprint
    fingerprint = ckpt.config_fingerprint(
        w=w, htsz=htsz, n_offsets=n_offsets, pk=pk, pke=pke,
        jobs_per_epoch=cfg.jobs_per_epoch, devices=n_devices,
        shard_table=bool(args.shard_table),
    )
    start_index, start_epoch = 0, 0
    if args.resume:
        try:
            ck = ckpt.Checkpoint.load(args.resume, fingerprint)
            ck.bind(next(itertools.islice(_pubkeys(args), ck.pub_index,
                                          None), None))
        except (ValueError, OSError, KeyError, TypeError) as e:
            print(f"cannot resume: {e}", file=sys.stderr)
            return 2
        start_index, start_epoch = ck.pub_index, ck.next_epoch
    return Plan(pk, pke, cfg, fingerprint, start_index, start_epoch)


def _pubkeys(args):
    """Lazy pubkey stream: the --pub pubkey first, then --infile one line
    at a time, blank lines skipped (the reference's readNextPubFile,
    1_9_7File.pb:4370: the file is never loaded whole)."""
    if args.pub:
        yield args.pub
    if args.infile:
        with open(args.infile) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


def _spawn(argv, n: int, ids, device) -> int:
    """Start n ranks of this command line on this host, one process each
    (start method spawn), and wait for them: returns 0 when every rank
    returns 0, else the first failure's code, after stopping the others.
    On cuda each rank needs a card of its own."""
    import multiprocessing.connection

    import torch
    import torch.multiprocessing

    from .parallel import mesh as pmesh

    if torch.device(device or "cuda").type == "cuda":
        have = torch.cuda.device_count()
        want = max(ids) + 1 if ids else n
        if want > have:
            print(f"{n} ranks need {n} cards of their own (cards "
                  f"{ids or list(range(n))}); this host has {have}",
                  file=sys.stderr)
            return 2
    ctx = torch.multiprocessing.get_context("spawn")
    address = pmesh.free_address()
    procs = [ctx.Process(target=_rank_main,
                         args=(argv, device, address, n, r))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                print(f"a rank failed with exit code {failed[0]}",
                      file=sys.stderr)
                return failed[0] if failed[0] > 0 else 1
            if all(c == 0 for c in codes):
                return 0
            # the ranks still running when codes was read: one that exits
            # after that read leaves its sentinel ready, never an empty
            # list to wait on for ever
            multiprocessing.connection.wait(
                [p.sentinel for p, c in zip(procs, codes) if c is None])
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()


def _rank_main(argv, device, address: str, world: int, rank: int) -> None:
    """One rank started by _spawn: join the group at address, run the
    command line, leave the group; the process's exit code is main's."""
    from .parallel import mesh as pmesh

    pmesh.init_distributed(address, world, rank,
                           backend=pmesh.backend_for(device))
    try:
        code = main(argv, device)
    finally:
        pmesh.close()
    sys.exit(code)


def _run(args, plan: Plan, ids, device) -> int:
    """Build the table and solve every pubkey: on one device, or as a rank
    of the group this process has joined or a launcher has set up (or, for
    --shard-table on one card, a group of one it starts and closes)."""
    from .parallel import mesh as pmesh

    backend = pmesh.backend_for(device)
    if pmesh.launched():
        created = pmesh.init_distributed(backend=backend)
    elif args.shard_table:
        created = pmesh.init_distributed(pmesh.free_address(), 1, 0,
                                         backend=backend)
    else:
        created = False
    try:
        if pmesh.launched():
            mesh = pmesh.make_mesh(n_devices=len(ids) or args.devices,
                                   device_ids=ids or None, device=device)
            dev = mesh.device
        else:
            mesh = None
            dev = _one_device(device, ids)
        return _solve_all(args, plan, dev, mesh)
    finally:
        if created:
            pmesh.close()


def _solve_all(args, plan: Plan, dev, mesh) -> int:
    """The scan of every pubkey of the stream on dev, striped over mesh's
    ranks when there is one; rank 0 alone prints and writes."""
    from .models import solver as smod, table as tbl
    from .parallel import sharded_table, striped
    from .utils import checkpoint as ckpt, codecs

    lead = mesh is None or mesh.rank == 0
    quiet = args.quiet or not lead
    n_cards = 1 if mesh is None else mesh.world
    pk, pke, cfg = plan.pk, plan.pke, plan.cfg
    w = cfg.w
    start_index, start_epoch = plan.start_index, plan.start_epoch
    if args.resume:
        if not quiet:
            print(f"resuming at pubkey #{start_index}, epoch {start_epoch}")
    elif lead and os.path.exists(args.win_file):
        # a fresh (non-recovery) start clears the win file, like the
        # reference (1_9_7File.pb:4959-4963)
        os.unlink(args.win_file)

    if not quiet:
        print(_device_line(dev) + (f" (rank 0 of {n_cards})"
                                   if mesh is not None else ""))
        print(f"building baby table: w={w} htsz={cfg.htsz} ...")
    if args.shard_table and n_cards > 1:
        baby = sharded_table.build_sharded_table(cfg, mesh)
    else:
        baby = smod.build_table(cfg, dev)
    if not quiet:
        print(tbl.table_stats(baby))
    s = smod.Solver(cfg, baby=baby, device=dev)
    if mesh is not None:
        s = striped.MeshSolver(s, mesh, shard_baby_table=args.shard_table)

    writer = ckpt.CheckpointWriter(
        args.checkpoint_file, plan.fingerprint, args.checkpoint_interval)
    found = 0
    seen = 0
    t_start = time.time()
    stream = _pubkeys(args)
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
            if lead:
                print(f"skipping pubkey #{idx}: {e}", file=sys.stderr)
            continue
        pub_id = ckpt.pubkey_id(pub_hex)

        def on_epoch(epoch, steps, _idx=idx, _id=pub_id):
            if lead:
                writer.maybe_write(_idx, _id, epoch + 1, steps)

        def progress(done, total, steps, dt, _w=w):
            # the reference's rate display (1_9_7File.pb:5119-5142):
            # giant-steps/s (per card and in all) and the x2w effective
            # keys/s exponent
            if quiet or dt <= 0:
                return
            rate = steps / dt
            per_card = (f"{rate / n_cards / 1e6:.2f}x{n_cards} "
                        if n_cards > 1 else "")
            print(f"\r  epoch {done}/{total}  {per_card}{rate / 1e6:.2f} "
                  f"Mgsteps/s  (~2^{rate_exponent(rate, _w)} keys/s)",
                  end="", flush=True)

        if not quiet:
            note = f" [#{idx + 1}]" if args.infile else ""
            print(f"searching{note} {pub_hex[:24]}... "
                  f"range [{pk:#x}, {pke:#x}]")
        res = s.solve(pub, pk, pke, progress=progress,
                      start_epoch=start_epoch if idx == start_index else 0,
                      on_epoch=on_epoch)
        if not quiet:
            print()
        if res.key is not None:
            found += 1
            if lead:
                with open(args.win_file, "a") as f:
                    f.write(f"{res.key:064x} {codecs.format_pubkey(pub)}\n")
                print(f"KEY FOUND: {res.key:#x}")
        elif not quiet:
            print(f"exhausted range for pubkey #{idx} "
                  f"({res.giant_steps} giant steps, {res.elapsed_s:.1f}s)")
        if lead:
            writer.maybe_write(idx + 1, ckpt.pubkey_id(following), 0, 0,
                               force=True)
    if not quiet:
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
