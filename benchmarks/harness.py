"""One run of one cell: set-up, the measured window, the judge.

What belongs to one configuration, traffic mix or metric is found by the
name ``BENCHMARK.json`` gives it: a configuration's file (its ``file``),
``traffic/<name>.json`` and ``metrics/<name>.py`` (a ``read(run)`` each,
which returns the metric or None where the run holds nothing to read, and
may name in ``WATCH`` the program's functions whose calls a traced run
logs for it). A new cell is a new entry and new files; nothing here
changes.

The window is a closed loop over the traffic's requests: each
``Solver.solve`` starts when the last one returned, as the command line's
``--infile`` loop runs them. It ends at the first solve that returns after
``seconds``, or at the first epoch the solve loop drains after it (the
solve in flight is then left unfinished, the keys its drained epochs
covered counted up to its key).
The program is observed from outside, by wrapping the solver's own
methods on the instance and the module functions the timed path calls.

A cell of several cards (``chips`` above 1) runs one process a card, as
the command line's ``--devices`` does: run_ranks starts the ranks, each
joins the process group, builds its table, drives
``parallel.striped.MeshSolver`` (with the configuration's ``mesh``
options) through the same window, and judges its own card's outputs.
The ranks close the window together: each super-epoch's gather of hits
carries one more word a rank, set where that rank's clock has passed the
window's end, and every rank stops at the first super-epoch it collects
with one set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import queue
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from . import trace as tr
from . import traffic as tf
from .reference import bsgs as ref

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "bsgs_tpu")

# Every comparison is exact: each number counts mismatches.
LIMITS = {"wrong_keys": 0, "table_misses": 0, "table_entries_off": 0,
          "landing_key_errs": 0, "unjustified_hits": 0}
TABLE_SAMPLES = 2048  # baby points judged in the table
LANE_JOBS, LANE_OFFSETS = 4, 16  # lanes judged in each sampled phase
LANE_EVERY = 8  # sample every 8th epoch's phases, doubling the gap
LANE_CAP = 64  # past 2 x LANE_CAP sampled phases, which halves them
STRETCH_AT, STRETCH_S = 0.4, 3.0  # the traced stretch: start (share), length


class WindowClosed(Exception):
    """Raised into a solve in flight when the window has closed."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    chips: int
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def geometry(self) -> dict:
        return self.config["geometry"]


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT,
              bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((Path(root) / c["file"]).read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name, config, int(w["chips"]), tf.load(root, w["traffic"]),
                e2e, layer)


def reader(name: str, root: Path = ROOT):
    """metrics/<name>.py as a module: read(run) and, optionally, WATCH."""
    path = Path(root) / "benchmarks" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmarks.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What one run recorded, for the metric readers and the result."""

    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: str = "cuda"
    setup_s: float = 0.0
    build_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0  # giant steps of the epochs drained in the window
    epochs: int = 0  # epochs drained in the window
    # keys of the ranges that the window's solves had to cover: from pk to
    # the key for a solve that finds it, the whole range for one that
    # exhausts it, and for the solve in flight at the close the keys its
    # drained epochs covered, up to its key
    useful_keys: int = 0
    solves: list = dataclasses.field(default_factory=list)  # (t0, t1)
    answers: list = dataclasses.field(default_factory=list)  # (got, want)
    warm_answers: list = dataclasses.field(default_factory=list)
    host: dict = dataclasses.field(default_factory=dict)  # span: [(t0, dt)]
    calls: dict = dataclasses.field(default_factory=dict)  # watched: [args]
    stretch: Optional[tuple] = None  # (t0, t1) on the host clock
    trace: Optional[dict] = None  # trace.reduce_events of the stretch
    setup_parts: dict = dataclasses.field(default_factory=dict)  # seconds
    memory_peak_bytes: Optional[int] = None
    row_len_counts: Optional[dict] = None  # entries a row: rows
    row_len_bytes: int = 1
    compared: dict = dataclasses.field(default_factory=dict)
    checked: dict = dataclasses.field(default_factory=dict)
    forbidden: list = dataclasses.field(default_factory=list)  # of ranks
    rank_traces: list = dataclasses.field(default_factory=list)  # ranks 1..

    @property
    def w(self) -> int:
        return int(self.cell.geometry["w"])

    def in_stretch(self, t0: float, t1: float) -> bool:
        st = self.stretch
        return bool(st) and t0 <= st[1] and t1 >= st[0]

    def host_s(self, span: str) -> list:
        """Seconds of each call of a wrapped span in the window, leaving
        out the calls that overlap the traced stretch (the profiler slows
        the host there)."""
        return [dt for t0, dt in self.host.get(span, [])
                if not self.in_stretch(t0, t0 + dt)]

    def epochs_outside_stretch(self) -> int:
        return len(self.host_s("_collect"))

    @property
    def correct(self) -> bool:
        return (all(v <= LIMITS[k] for k, v in self.compared.items())
                and self.checked.get("solves", 0) > 0
                and self.checked.get("table_samples", 0) > 0
                and self.checked.get("lanes", 1) > 0)


def needed_keys(r) -> int:
    """Keys of a request's range that a scan in order must cover to answer
    it: from pk up to its key, or the whole range where the key lies
    outside it."""
    return (r.key if r.in_range else r.pke) - r.pk + 1


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


class CellRun:
    """Set-up, window and judge of one run of a cell on one device."""

    def __init__(self, cell: Cell, seed: int, device: str = "cuda",
                 t_process: Optional[float] = None, solver=None,
                 mesh=None):
        """solver: one already built and warmed up for this cell (the
        control runs several seeds on one table); this run then leaves it
        to its owner. mesh: this rank's parallel.mesh.Mesh, in a cell of
        several cards."""
        import torch

        self.torch = torch
        self.cell, self.seed = cell, int(seed)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            torch.device(device)
        self.t_process = time.perf_counter() if t_process is None \
            else t_process
        geo = cell.geometry
        self.geo = ref.Geometry(int(geo["w"]), int(geo["htsz"]),
                                int(geo["n_offsets"]),
                                int(geo["jobs_per_epoch"]),
                                int(geo["epoch_phases"]))
        self.judge = ref.Judge(self.geo)
        self.gen = tf.Generator(cell.traffic, seed, comb=self.judge.comb)
        self.solver = solver
        self.owns_solver = solver is None
        self.requests = []
        self.samples, self.hits = [], []
        self._ctx = (0, 0)
        self._req = 0
        self._solve_steps = 0
        self._sampling = False
        self._phase = 0
        self._epochs_seen = 0
        self._keys_calls = 0
        self._every = LANE_EVERY
        self._lanes = {}
        self._closing = False
        self._flags = {}  # id of a gathered hit buffer: the ranks' flags

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    # -- set-up ----------------------------------------------------------
    def setup(self, run: Run) -> None:
        from bsgs_tpu_torch.models import solver as S

        if self.device.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats(self.device)
        self.requests = self.gen.take(int(self.cell.traffic.get("prepare",
                                                                 64)))
        if self.solver is not None:
            return
        warm = self.gen.warmup()
        cfg = S.SolverConfig(**self.cell.geometry)
        self.sync()
        t0 = time.perf_counter()
        run.setup_parts["before_build"] = t0 - self.t_process
        baby = S.build_table(cfg, device=self.device)
        self.sync()
        t1 = time.perf_counter()
        run.build_s = t1 - t0
        self.solver = S.Solver(cfg, baby=baby, device=self.device)
        if self.mesh is not None:
            from bsgs_tpu_torch.parallel.striped import MeshSolver

            self.solver = MeshSolver(self.solver, self.mesh,
                                     **self.cell.config.get("mesh", {}))
        self.sync()
        t2 = time.perf_counter()
        run.setup_parts["solver"] = t2 - t1
        got = self.solver.solve(warm.pub, warm.pk, warm.pke).key
        run.warm_answers.append((got, warm.expected))
        self.sync()
        run.setup_parts["warm_solve"] = time.perf_counter() - t2

    # -- hooks -----------------------------------------------------------
    def _span(self, run: Run, name: str, fn, traced: bool):
        rec = run.host.setdefault(name, [])
        if traced:
            from torch.profiler import record_function

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            if traced:
                with record_function(tr.SPAN_PREFIX + name):
                    out = fn(*a, **kw)
            else:
                out = fn(*a, **kw)
            rec.append((t0, time.perf_counter() - t0))
            return out

        return wrapped

    def _lane_index(self, width: int):
        n = self.geo.n_offsets
        per = width // n
        if per not in self._lanes:
            rng = tf.rng_of(self.seed, 4)
            ts = rng.integers(0, per, LANE_JOBS)
            js = rng.integers(1, n + 1, LANE_OFFSETS)
            idx = [(int(t), int(j)) for t in ts for j in js]
            lanes = self.torch.tensor([t * n + j - 1 for t, j in idx],
                                      dtype=self.torch.long,
                                      device=self.device)
            self._lanes[per] = (lanes, idx, per)
        return self._lanes[per]

    @contextlib.contextmanager
    def hooks(self, run: Run, stretch: Optional[tr.Stretch], watch: set):
        from bsgs_tpu_torch.ops import epoch_kernel as EK

        s, traced, mesh = self.solver, run.traced, self.mesh
        orig = {k: getattr(s, k) for k in
                ("_epoch", "_dispatch", "_collect", "_verify", "_records")}
        orig_keys = EK.epoch_landing_keys_packed
        T = self.geo.jobs_per_epoch
        per_epoch, rank = (T, 0) if mesh is None else (T * mesh.world,
                                                      mesh.rank)
        hit_len = [0]

        def epoch(q0, e, hit_cap=None):
            self._ctx = (self._req, e * per_epoch + rank * T)
            self._phase = 0
            self._epochs_seen += 1
            self._sampling = (self._epochs_seen - 1) % self._every == 0
            hit_len[0] = 1 + (hit_cap or s.cfg.hit_cap)
            rec = orig["_epoch"](q0, e, hit_cap)
            if mesh is not None:
                self._flags[id(rec[2])] = self._last_flags
            return rec

        def gather(t):
            """The hit gather (count and buffer) with one word more: this
            rank's clock past the window's end. Other gathers pass."""
            if t.dim() != 1 or t.shape[0] != hit_len[0]:
                return orig_gather(t)
            late = int(time.perf_counter() >= self.t_end)
            out = orig_gather(self.torch.cat((t, t.new_full((1,), late))))
            parts = out.view(mesh.world, -1)
            self._last_flags = parts[:, -1]
            return parts[:, :-1].reshape(-1)

        def closed(rec) -> bool:
            if mesh is None:
                return time.perf_counter() >= self.t_end
            flags = self._flags.pop(id(rec[2]), None)
            self._closing |= flags is not None and bool(flags.any())
            return self._closing

        def collect(pub, pk, rec):
            if closed(rec):
                raise WindowClosed
            if stretch is not None:
                stretch.poll()
            batch, gs = orig["_collect"](pub, pk, rec)
            run.steps += gs
            self._solve_steps += gs
            run.epochs += rec[0] is not None
            return batch, gs

        def records(pub, pk, job_base, idxs):
            flat = np.asarray(idxs).view(np.uint32)
            self.hits.append((self._req, job_base,
                              flat[flat != 0xFFFFFFFF].tolist()))
            return orig["_records"](pub, pk, job_base, idxs)

        def keys(cx, cy, ox, oy, **kw):
            out = orig_keys(cx, cy, ox, oy, **kw)
            self._keys_calls += 1
            if self._sampling:
                lanes, idx, per = self._lane_index(out.shape[1])
                self.samples.append((self._ctx, self._phase, per, idx,
                                     out[:5].index_select(1, lanes)))
                if len(self.samples) > 2 * LANE_CAP:
                    self.samples = self.samples[1::2]
                    self._every *= 2
            self._phase += 1
            return out

        s._epoch = self._span(run, "_epoch", epoch, traced)
        s._collect = self._span(run, "_collect", collect, traced)
        s._verify = self._span(run, "_verify", orig["_verify"], traced)
        s._records = records
        if traced:
            s._dispatch = self._span(run, "_dispatch", orig["_dispatch"],
                                     traced)
        EK.epoch_landing_keys_packed = keys
        patched = [(EK, "epoch_landing_keys_packed", orig_keys)]
        if mesh is not None:
            orig_gather = mesh.all_gather
            mesh.all_gather = gather
            patched.append((mesh, "all_gather", orig_gather))
        for spec in sorted(watch):  # "module:function"
            target, fn_name = spec.split(":")
            mod = importlib.import_module(target)
            fn = getattr(mod, fn_name)
            log = run.calls.setdefault(spec, [])

            def watched(*a, _fn=fn, _log=log, **kw):
                if stretch is not None and stretch.active:
                    _log.append(([tuple(x.shape) for x in a
                                  if hasattr(x, "shape")],
                                 {k: v for k, v in kw.items()
                                  if isinstance(v, int)}))
                return _fn(*a, **kw)

            setattr(mod, fn_name, watched)
            patched.append((mod, fn_name, fn))
        try:
            yield
        finally:
            for mod, name, fn in reversed(patched):
                setattr(mod, name, fn)
            for k in orig:
                s.__dict__.pop(k, None)
            self._flags.clear()

    # -- window ----------------------------------------------------------
    def window(self, run: Run, seconds: float, watch: set) -> None:
        stretch = None
        if run.traced:
            tr.warm_profiler()
        if self.mesh is not None:  # the ranks start their windows together
            self.mesh.all_reduce_max(self.torch.zeros(1, device=self.device))
            self.sync()
        t_start = time.perf_counter()
        run.setup_s = t_start - self.t_process
        self.t_end = t_start + seconds
        if run.traced:
            stretch = tr.Stretch(t_start + STRETCH_AT * seconds,
                                 min(STRETCH_S, 0.25 * seconds), self.sync)
        i = 0
        t_close = None
        with self.hooks(run, stretch, watch):
            try:
                while True:
                    if i >= len(self.requests):
                        self.requests += self.gen.take(64)
                    r = self.requests[i]
                    self._req = i
                    self._solve_steps = 0
                    t0 = time.perf_counter()
                    try:
                        got = self.solver.solve(r.pub, r.pk, r.pke).key
                    except WindowClosed:
                        run.useful_keys += min(
                            2 * run.w * self._solve_steps, needed_keys(r))
                        break
                    t1 = time.perf_counter()
                    run.solves.append((t0, t1))
                    run.answers.append((got, r.expected))
                    run.useful_keys += needed_keys(r)
                    i += 1
                    # ranks close on the gathered flags alone
                    if self.mesh is None and t1 >= self.t_end:
                        break
            finally:
                t_close = time.perf_counter()
                if stretch is not None:
                    stretch.stop()
        self.sync()
        run.window_s = t_close - t_start
        if stretch is not None and stretch.t0 is not None:
            run.stretch = (stretch.t_req, stretch.t1)
            run.trace = stretch.reduce()

    # -- judge -----------------------------------------------------------
    def judge_run(self, run: Run) -> None:
        torch = self.torch
        self.sync()
        if self.device.type == "cuda":
            run.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
        J, geo, baby = self.judge, self.geo, self.solver.baby
        dev = baby.dense.device

        def rows_of(buckets):
            b = torch.tensor(buckets, dtype=torch.long, device=dev)
            return (baby.dense[b].cpu().numpy().view(np.uint32),
                    baby.row_len[b].long().cpu().numpy(),
                    baby.pos_lo[b].cpu().numpy().view(np.uint16)
                    if baby.pos_lo is not None else None)

        rs = tf.rng_of(self.seed, 3).integers(
            1, geo.w + 1, min(geo.w, TABLE_SAMPLES)).tolist()
        expect = J.table_expectations(rs)
        t_rows, t_lens, t_hints = rows_of([e[0] for e in expect])
        if self.cell.geometry.get("positions") != "rescan":
            t_hints = None
        elif t_hints is None:  # a rescan table must carry its hints
            t_hints = np.full(t_rows.shape, -1)
        entries = int(baby.row_len.long().sum())
        counts = torch.bincount(baby.row_len.long()).cpu().tolist()
        run.row_len_counts = {n: c for n, c in enumerate(counts) if c}
        run.row_len_bytes = baby.row_len.element_size()

        lane_cases = []
        for (req, first_job), phase, per, idx, got in self.samples:
            r = self.requests[req]
            jobs = [first_job + phase * per + t for t, _ in idx]
            lane_cases.append((r, jobs, [j for _, j in idx],
                               got.cpu().numpy().view(np.uint32).T))
        claims, claim_rows = [], []
        for req, job_base, flats in self.hits:
            r = self.requests[req]
            for f in flats:
                c = J.hit_claims(r.pub, r.pk, job_base, f)
                claims.append(c)
                claim_rows.append(c[1] if c[0] == "row" else 0)
        h_rows = rows_of(claim_rows)[0] if claims else []
        baby = None
        if self.owns_solver:
            self.solver = None
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

        run.compared = {
            "wrong_keys": J.wrong_keys(run.warm_answers + run.answers),
            "table_misses": J.table_misses(expect, t_rows, t_lens, t_hints),
            "table_entries_off": abs(entries - geo.w),
            "landing_key_errs": sum(
                J.landing_key_errors(r.pub, r.pk, jobs, js, got)
                for r, jobs, js, got in lane_cases),
            "unjustified_hits": J.unjustified_hits(claims, h_rows),
        }
        run.checked = {"solves": len(run.warm_answers) + len(run.answers),
                       "table_samples": len(expect), "hits": len(claims)}
        if self._keys_calls:  # the path computed landing keys to judge
            run.checked["lanes"] = sum(len(js) for _, _, js, _ in lane_cases)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             root: Path = ROOT, fault: Optional[Callable] = None,
             solver=None, mesh=None) -> Run:
    """Set-up, window and judge of one run. ``fault(cell_run)``, for the
    control and the fault tests only, returns a context manager that
    breaks the timed path beneath the window's hooks and the judge's
    reads; ``solver`` reuses a built one, ``mesh`` is this rank's
    (CellRun)."""
    run = Run(cell, int(seed), float(seconds), bool(traced), str(device))
    watch = set()
    if traced:
        for m in cell.per_layer:
            watch.update(getattr(reader(m["name"], root), "WATCH", ()))
    cr = CellRun(cell, seed, device, t_process, solver, mesh)
    cr.setup(run)
    with (fault(cr) if fault else contextlib.nullcontext()):
        cr.window(run, seconds, watch)
        cr.judge_run(run)
    return run


def rank_main(cell: Cell, seed: int, seconds: float, traced: bool,
              device: str, t_process: float, root: Path, address: str,
              rank: int, results, fault: Optional[str] = None) -> None:
    """One rank of a cell of several cards (run_ranks starts it): join
    the group, run the cell on this rank's card, put (rank, Run) on
    results, leave the group. fault names one of control.py's, for its
    tests only."""
    from bsgs_tpu_torch.parallel import mesh as pmesh

    pmesh.init_distributed(address, cell.chips, rank,
                           backend=pmesh.backend_for(device))
    try:
        mesh = pmesh.make_mesh(cell.chips, device=device)
        broken = None
        if fault:
            from benchmarks import control

            broken = control.ALL_FAULTS[fault]
        run = run_cell(cell, seed, seconds, traced, str(mesh.device),
                       t_process, root, fault=broken, mesh=mesh)
        run.forbidden = forbidden_modules()
        results.put((rank, run))
    finally:
        pmesh.close()


def run_ranks(cell: Cell, seed: int, seconds: float, traced: bool,
              device: str = "cuda", t_process: Optional[float] = None,
              root: Path = ROOT, fault: Optional[str] = None) -> Run:
    """A run of a cell of several cards: one process a rank (start method
    spawn), each a card of its own on cuda (gloo ranks on the CPU, for
    the tests). Returns rank 0's Run with the other ranks' judgements,
    memory peaks, traces and loaded modules merged in; raises, after
    stopping every rank, where one fails."""
    import multiprocessing

    from bsgs_tpu_torch.parallel import mesh as pmesh

    t_process = time.perf_counter() if t_process is None else t_process
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = pmesh.free_address()
    procs = [ctx.Process(target=rank_main,
                         args=(cell, seed, seconds, traced, device,
                               t_process, root, address, r, results, fault))
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    runs = {}
    try:
        while len(runs) < len(procs):
            try:
                rank, r = results.get(timeout=1.0)
                runs[rank] = r
                continue
            except queue.Empty:
                pass
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                raise RuntimeError(f"a rank failed: exit codes {codes}")
            if all(c == 0 for c in codes) and results.empty():
                raise RuntimeError("the ranks ended without a result")
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return merge_ranks([runs[r] for r in sorted(runs)])


def merge_ranks(runs: list) -> Run:
    """Rank 0's Run, holding every rank's worst judgement, least checked,
    highest memory peak, trace and loaded modules."""
    run = runs[0]
    run.compared = {k: max(r.compared.get(k, 0) for r in runs)
                    for k in run.compared}
    run.checked = {k: min(r.checked.get(k, 0) for r in runs)
                   for k in run.checked}
    peaks = [r.memory_peak_bytes for r in runs if r.memory_peak_bytes]
    run.memory_peak_bytes = max(peaks) if peaks else None
    run.rank_traces = [r.trace for r in runs[1:]]
    run.forbidden = sorted({m for r in runs for m in r.forbidden})
    return run


def metrics(run: Run, root: Path = ROOT) -> dict:
    out = {}
    for m in (run.cell.per_layer if run.traced else run.cell.end_to_end):
        v = reader(m["name"], root).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(run: Run, kind: str, root: Path = ROOT) -> dict:
    """The result line. Only a run on a CUDA card has one: a number from
    the CPU never goes under a device metric's name."""
    if not run.device.startswith("cuda"):
        raise ValueError(f"a run on {run.device} has no result")
    device = {"platform": "gpu", "kind": kind, "count": run.cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct, "attempted": len(run.solves),
           "failed": ref.Judge.wrong_keys(run.answers),
           "metrics": metrics(run, root), "device": device}
    if run.traced and run.trace:
        # averaged over the cards used (one trace a rank)
        traces = [run.trace] + [t for t in run.rank_traces if t]
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        out["breakdown"] = {
            "device_ops": tr.top(run.trace["device_s"]),
            "idle_gaps": tr.top(run.trace["idle_s_by_span"])}
    out["compared"] = {k: {"value": v, "limit": LIMITS[k]}
                       for k, v in run.compared.items()}
    return out


def compared_lines(run: Run) -> list:
    lines = [f"checked {k} {v}" for k, v in run.checked.items()]
    lines += [f"compared {k} {v} limit {LIMITS[k]}"
              for k, v in run.compared.items()]
    return lines
