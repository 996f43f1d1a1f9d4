"""The solve loop's recorder (bsgs_tpu_torch/utils/tracing.py): the span
tree of a solve on a rescan table with planted false positives (counts
against the SolveResult, the launch counter and the lookup's stats), the
centers' counts of a new solver (the first center carried after the first
epoch), the recorder off (no records, the same result), a solve's tail
and its residue scans, the ring, the
chrome trace, idle gaps on synthetic brackets, and the command line's
BSGS_TORCH_TRACE.
A MeshSolver's spans are checked in tests/test_torch_distributed.py's
sharded world of two. The ``chip`` case needs a card: no synchronising
call added, every bracket of a finished solve placed on the host clock,
and a collect that leaves the epochs queued behind it running
(``python -m pytest tests/test_torch_tracing.py -m chip --noconftest``
on the card). Imports torch and the port only."""

import collections
import contextlib
import dataclasses
import json
import os
import time
import warnings

import pytest
import torch

from bsgs_tpu_torch import cli
from bsgs_tpu_torch.models import giant as G, solver as S, table as T
from bsgs_tpu_torch.ops import _cuda
from bsgs_tpu_torch.utils import codecs, ecpy, tracing

torch.set_num_threads(2)

GEOM = dict(w=256, htsz=6, n_offsets=8, jobs_per_epoch=2, window=16,
            chunk_c=2, lanes_w=4, epoch_phases=2, positions="rescan",
            verify_defer_epochs=2)
PK = 1 << 21
# each span's possible parents: the tail holds what follows the last
# epoch's dispatch
TREE = {"solve": (None,), "epoch": ("solve",), "centers": ("epoch",),
        "stage": ("epoch",), "launch": ("epoch",),
        "collect": ("solve", "tail"), "wait": ("collect",),
        "verify": ("solve", "tail"), "landings": ("verify",),
        "lookup": ("verify",), "residue": ("lookup",), "confirm": ("verify",),
        "tail": ("solve",)}


@pytest.fixture
def recorder():
    tracing.clear()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.clear()


def _plant(baby, cfg, q0, m, hint_matches):
    """A dense entry with the disc of giant index m's landing in the first
    free slot of its bucket, the row's length moved with it; its hint's
    high byte matches the landing's extra prefix bits (a residue scan that
    finds nothing) or not (rejected without one)."""
    pre = ecpy.sub(q0, ecpy.mul(m * cfg.stride))[0] & ((1 << 64) - 1)
    bucket = pre >> (64 - cfg.htsz)
    slot = int(baby.row_len[bucket])
    disc = (pre >> (32 - cfg.htsz)) & 0xFFFFFFFF
    sh, mk = T._disc_lo_shift(cfg.htsz)
    hi = (pre >> sh) & mk
    hint = ((hi if hint_matches else hi ^ 0x5A) << 8) | 7
    baby.dense[bucket, slot] = disc - (1 << 32) if disc >= 1 << 31 else disc
    baby.pos_lo[bucket, slot] = T._u16_bits(torch.tensor(hint))
    baby.row_len[bucket] += 1


def _case(device):
    """A streamed rescan table on ``device`` with three false positives
    planted in epochs 0, 1 and 2 of a 6-epoch range whose key lies in
    epoch 4, and its solver."""
    cfg = S.SolverConfig(**GEOM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "STREAMED_W", 128)
        baby = S.build_table(cfg, device=device)
    assert baby.lookup_fn is not None and baby.pos_lo is not None
    k = PK + 4 * cfg.keys_per_epoch + 1000
    q0 = ecpy.sub(ecpy.mul(k), ecpy.mul(PK))
    span = cfg.jobs_span
    for m, ok in ((0 * span + 3, False), (2 * span + 5, True),
                  (4 * span + 12, False)):
        _plant(baby, cfg, q0, m, ok)
    return dict(solver=S.Solver(cfg, baby=baby, device=device), key=k,
                pke=PK + 6 * cfg.keys_per_epoch - 1, cfg=cfg)


@pytest.fixture(scope="module")
def case():
    return _case("cpu")


def _solve(c):
    return c["solver"].solve(ecpy.mul(c["key"]), PK, c["pke"])


def _fields(res):
    return (res.key, res.giant_steps, res.epochs, res.hits_checked)


def test_span_tree_of_a_rescan_solve(case, recorder, monkeypatch):
    launches = _cuda.total_launches()
    ran = collections.Counter()  # multiplications of G inside each pass
    mul = ecpy.mul

    def counted(k, pt=ecpy.G):
        for name in ("landings", "confirm"):
            if pt == ecpy.G and recorder.RECORDER.innermost(name):
                ran[name] += 1
        return mul(k, pt)

    monkeypatch.setattr(ecpy, "mul", counted)
    res = _solve(case)
    recs = recorder.records()
    cfg = case["cfg"]
    assert res.key == case["key"] and res.hits_checked >= 4
    assert {r.name for r in recs} == set(TREE)
    for r in recs:
        assert r.parent in TREE[r.name], r.name
        assert r.t0 <= r.t1
    assert len({r.solve for r in recs}) == 1
    by = {n: [r for r in recs if r.name == n] for n in TREE}
    count = lambda n, key: sum(r.counts.get(key, 0) for r in by[n])  # noqa
    assert count("verify", "records") == res.hits_checked
    assert count("collect", "hits") == res.hits_checked
    assert count("verify", "keys") == 1
    # landings and confirm count each multiplication of G they ran
    assert count("landings", "fixed_muls") == ran["landings"] > 0
    assert count("confirm", "fixed_muls") == ran["confirm"] > 0
    drained = [r.epoch for r in by["collect"]
               if r.epoch is not None and "hits" in r.counts]
    assert len(drained) == res.epochs == len(by["wait"])
    # the epochs still queued when the key was found were not drained
    dispatched = [r.epoch for r in by["epoch"]]
    assert dispatched == sorted(dispatched) and set(drained) <= set(
        dispatched) and len(dispatched) - res.epochs < cfg.pipeline
    assert count("launch", "launches") == _cuda.total_launches() - launches
    assert count("epoch", "T") == cfg.jobs_per_epoch * len(dispatched)
    assert count("centers", "additions") == count("epoch", "T")
    assert {r.counts["bytes"] for r in by["stage"]} == {
        (2 * 8 + 1) * cfg.jobs_per_epoch * 4}
    assert all(0 <= r.counts["queued"] < cfg.pipeline for r in by["wait"])
    # on the CPU every epoch's hits are there when its wait begins, and
    # none runs on behind it
    assert all(r.counts["ready"] == 1 and r.counts["busy"] == 0
               for r in by["wait"])
    # the rejected hints cost no residue scan; the matching one and the
    # key's own landing one each
    assert count("lookup", "lookups") >= 4
    assert count("lookup", "rejected") >= 2
    assert count("lookup", "residue_scans") >= 2
    (solve,) = by["solve"]
    assert solve.counts["epochs"] == res.epochs
    assert solve.counts["steps"] == res.giant_steps
    k0 = case["key"] - PK
    assert solve.counts["steps_to_key"] == (k0 + cfg.w) // cfg.stride + 1
    assert solve.counts["steps_to_key"] < res.giant_steps  # overscan
    # every child lies inside its parent
    for r in recs:
        if r.parent_id is not None:
            (p,) = [q for q in recs if q.id == r.parent_id]
            assert p.t0 <= r.t0 <= r.t1 <= p.t1
    assert recorder.idle_gaps() == []  # no brackets on the CPU
    table = recorder.report()
    for name in TREE:
        assert f"\n{name} " in "\n" + table
    for name in ("landings", "confirm"):
        (row,) = [ln for ln in table.splitlines() if ln.startswith(name)]
        assert f"fixed_muls={ran[name]}" in row


# a pipelined step's spans sit in its epoch's launch; the flush's epoch
# comes after the last dispatch, in the tail
PIPELINED = dict(TREE, epoch=("solve", "tail"), probe=("launch",),
                 keys=("launch",))


def test_span_tree_of_a_pipelined_solve(case, recorder):
    """A cross-pipelined solve, one found and one exhausted: each epoch
    dispatched counts T, and its launch holds ``keys`` (T) and, past the
    priming step, the ``probe`` of the previous step's 2TN + T keys; the
    flush's epoch holds neither and, like every epoch on the CPU, counts
    no second stream."""
    cfg = dataclasses.replace(case["cfg"], cross_pipeline=True)
    s = S.Solver(cfg, baby=case["solver"].baby, device="cpu")
    assert s._pipelined and s._phases == 1
    t, n = cfg.jobs_per_epoch, cfg.n_offsets
    far = ecpy.mul(PK + (1 << 40))
    for pub, pke, key in ((ecpy.mul(case["key"]), case["pke"], case["key"]),
                          (far, PK + 3 * cfg.keys_per_epoch - 1, None)):
        recorder.clear()
        assert s.solve(pub, PK, pke).key == key
        recs = recorder.records()
        assert {"probe", "keys"} <= {r.name for r in recs} <= set(PIPELINED)
        for r in recs:
            assert r.parent in PIPELINED[r.name], r.name
        ids = {r.id: r for r in recs}

        def under(name, ep):
            return [r for r in recs if r.name == name
                    and ids[r.parent_id].parent_id == ep.id]

        epochs = [r for r in recs if r.name == "epoch"]
        dispatched = [r for r in epochs if r.counts]
        assert [r.epoch for r in dispatched] == list(
            range(len(dispatched)))
        for i, ep in enumerate(dispatched):
            (keys,) = under("keys", ep)
            assert keys.counts == {"T": t}
            probes = under("probe", ep)
            assert len(probes) == (i > 0)
            for p in probes:
                assert p.counts == {"keys": 2 * t * n + t, "launches": 0}
        flushes = [r for r in epochs if not r.counts]
        assert len(flushes) <= 1 and (flushes or key is not None)
        for ep in flushes:
            assert ep.epoch == dispatched[-1].epoch
            assert not under("probe", ep) and not under("keys", ep)
        assert {tuple(r.counts) for r in dispatched} == {("T",)}
        assert recorder.idle_gaps() == []


def test_centers_carry_the_first_center(case, recorder):
    """A new solver multiplies the first center of its first epoch and
    carries every later epoch's by one addition: ``centers`` counts
    carried 0 then 1, exact_rows 0 and additions T, and the table prints
    them."""
    cfg = case["cfg"]
    s = S.Solver(cfg, baby=case["solver"].baby, device="cpu")
    res = s.solve(ecpy.mul(case["key"]), PK, case["pke"])
    assert res.key == case["key"]
    centers = [r for r in recorder.records() if r.name == "centers"]
    assert len(centers) >= res.epochs >= 3
    assert [r.epoch for r in centers] == list(range(len(centers)))
    assert [r.counts["carried"] for r in centers] == [0] + [1] * (
        len(centers) - 1)
    assert {r.counts["exact_rows"] for r in centers} == {0}
    assert {r.counts["additions"] for r in centers} == {cfg.jobs_per_epoch}
    (row,) = [ln for ln in recorder.report().splitlines()
              if ln.startswith("centers ")]
    assert f"carried={len(centers) - 1}" in row and "exact_rows=0" in row


def test_off_records_nothing_and_changes_nothing(case):
    tracing.clear()
    assert not tracing.enabled()
    assert tracing.span("epoch", 3) is tracing.NULL
    off = _solve(case)
    assert tracing.records() == []
    tracing.enable()
    try:
        on = _solve(case)
    finally:
        tracing.disable()
    assert tracing.records() and _fields(on) == _fields(off)
    tracing.clear()


# a deferral longer than the range, as in a recovery batch: every pooled
# hit is verified in the solve's tail; w = 1000 gives residue scans of 3
# or 4 points
TAIL_GEOM = dict(GEOM, w=1000, htsz=8, verify_defer_epochs=64)


@pytest.fixture(scope="module")
def tail_solver():
    cfg = S.SolverConfig(**TAIL_GEOM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "STREAMED_W", 128)
        baby = S.build_table(cfg, device="cpu")
    return S.Solver(cfg, baby=baby, device="cpu")


@pytest.mark.parametrize("kind", ["found", "exhausted", "off", "again"])
def test_tail_and_residue_spans(tail_solver, kind):
    """A 4-epoch range: a found key's solve records one ``tail`` (found
    1, its pooled records) and the key's residue scan inside ``lookup``
    (points, tiles, ``kept`` and the fill seed's additions: the table's
    first scan fills the kept tile, kept 0 and 1,024 additions); an
    exhausted one a tail with found 0; with the recorder off both spans
    are the null context and nothing is recorded; a second solve of a
    found key (``again``) scans from the kept tile, kept 1 and no
    additions."""
    s = tail_solver
    cfg = s.cfg
    pke = PK + 4 * cfg.keys_per_epoch - 1
    k = (pke if kind == "exhausted" else PK + 2 * cfg.keys_per_epoch) + 777
    if kind == "again":
        assert s.solve(ecpy.mul(k), PK, pke).key == k
    tracing.clear()
    if kind == "off":
        assert tracing.span("tail") is tracing.span("residue") is tracing.NULL
    else:
        tracing.enable()
    try:
        res = s.solve(ecpy.mul(k), PK, pke)
    finally:
        tracing.disable()
    recs = tracing.records()
    tracing.clear()
    assert res.key == (None if kind == "exhausted" else k)
    if kind == "off":
        assert recs == []
        return
    (solve,) = [r for r in recs if r.name == "solve"]
    (tail,) = [r for r in recs if r.name == "tail"]
    assert tail.parent == "solve" and solve.t0 <= tail.t0 <= tail.t1
    assert 1 <= tail.counts["epochs"] <= cfg.pipeline
    assert tail.counts.get("records", 0) == res.hits_checked
    if kind == "exhausted":
        assert tail.counts["found"] == 0
        return
    assert tail.counts["found"] == 1 and tail.counts["records"] >= 1
    residue = [r for r in recs if r.name == "residue"]
    assert residue and {r.parent for r in residue} == {"lookup"}
    assert all(tail.t0 <= r.t0 <= r.t1 <= tail.t1 for r in residue)
    # one 2^11 tile; the "found" case is the table's first solve
    counts = [(r.counts["tiles"], r.counts["kept"], r.counts["seed_additions"])
              for r in residue]
    if kind == "found":
        assert counts == [(1, 0, 1024)] + [(1, 1, 0)] * (len(counts) - 1)
    else:
        assert set(counts) == {(1, 1, 0)}
    k0 = k - PK
    m = (k0 + cfg.w) // cfg.stride
    first = abs(k0 - m * cfg.stride) % 256 or 256  # the key's residue
    assert (cfg.w - first) // 256 + 1 in {r.counts["points"]
                                          for r in residue}


def test_ring_drops_the_oldest():
    rec = tracing.Recorder(capacity=4)
    rec.on = True
    for i in range(6):
        with rec.open("epoch", i) as sp:
            sp.count("T", i)
    got = rec.records()
    assert [r.epoch for r in got] == [2, 3, 4, 5] and rec.dropped == 2
    assert [r.counts["T"] for r in got] == [2, 3, 4, 5]


def test_nesting_epoch_and_deltas():
    rec = tracing.Recorder()
    counter = {"a": 1, "b": 5}
    with rec.open("solve") as s:
        with rec.open("epoch", 7) as e:
            with rec.open("launch") as sp:
                sp.deltas(counter)
                counter["a"] += 3
        with rec.open("collect") as c:
            pass
    launch, epoch, collect, solve = rec.records()
    assert launch.counts == {"a": 3, "b": 0} and launch.epoch == 7
    assert (launch.parent, epoch.parent, collect.parent) == (
        "epoch", "solve", "solve")
    assert collect.epoch is None and solve.parent is None
    assert {launch.solve, epoch.solve, collect.solve} == {solve.id} == {s.id}
    assert e.id == launch.parent_id and c.parent_id == s.id


def _synthetic():
    """Host spans and device brackets on one clock (seconds): two epochs
    whose brackets [1, 3] and [2, 4] overlap, a third [6, 8], a lookup
    bracket [11, 12]."""
    rec = tracing.Recorder()

    def add(name, t0, t1, parent=None, device=None):
        s = tracing.Span(rec, len(rec._ring) + 1, name, parent, None)
        s.t0, s.t1 = t0, t1
        s.device = list(device) if device else None
        rec._ring.append(s)
        return s

    solve = add("solve", 0.0, 20.0)
    add("epoch", 0.5, 1.5, solve, (1.0, 3.0))
    add("epoch", 1.5, 2.5, solve, (2.0, 4.0))
    add("centers", 4.5, 5.5, solve)
    add("epoch", 5.5, 6.5, solve, (6.0, 8.0))
    verify = add("verify", 9.0, 13.0, solve)
    add("lookup", 10.5, 12.5, verify, (11.0, 12.0))
    return rec


def test_idle_gaps_on_synthetic_brackets():
    rec = _synthetic()
    # merged [1, 4], [6, 8], [11, 12]: gaps [4, 6] (midpoint 5 in
    # centers) and [8, 11] (9.5 in verify)
    assert rec.idle_gaps() == [(4.0, 6.0, "centers"),
                               (8.0, 11.0, "verify")]
    # only the brackets that reach into [lo, hi]
    assert rec.idle_gaps(7.0, 30.0) == [(8.0, 11.0, "verify")]
    assert rec.idle_gaps(5.0, 9.0) == rec.idle_gaps(12.5, 30.0) == []
    lone = tracing.Recorder()
    s = tracing.Span(lone, 1, "epoch", None, None)
    s.t0, s.t1, s.device = 0.0, 1.0, [0.0, 1.0]
    lone._ring.append(s)
    s = tracing.Span(lone, 2, "epoch", None, None)
    s.t0, s.t1, s.device = 3.0, 4.0, [3.0, 4.0]
    lone._ring.append(s)
    assert lone.idle_gaps() == [(1.0, 3.0, tracing.OUTSIDE)]
    s.count("streams", 2)  # a second stream, not fenced: gaps not known
    with pytest.raises(ValueError, match="not fenced"):
        lone.idle_gaps()
    assert "not known" in lone.report()


def test_idle_gaps_merge_fenced_streams():
    """A fenced two-stream epoch (counts ``streams`` 2, ``joined`` 1): its
    children's brackets on either stream merge with it, one reaching past
    its end; an unfenced one still refuses."""
    rec = tracing.Recorder()

    def add(name, dev, parent=None, **counts):
        s = tracing.Span(rec, len(rec._ring) + 1, name, parent, None)
        s.t0, s.t1, s.device = dev[0], dev[1], list(dev)
        s.counts = counts or None
        rec._ring.append(s)
        return s

    ep = add("epoch", (0.0, 1.0), streams=2, joined=1)
    add("probe", (0.2, 0.9), ep)  # the second stream
    add("keys", (0.1, 0.8), ep)
    ep = add("epoch", (3.0, 4.0), streams=2, joined=1)
    add("probe", (3.5, 4.5), ep)
    add("epoch", (6.0, 7.0))
    assert rec.idle_gaps() == [(1.0, 3.0, tracing.OUTSIDE),
                               (4.5, 6.0, tracing.OUTSIDE)]
    assert "device idle between brackets: 3500.0 ms" in rec.report()
    ep.counts.pop("joined")
    with pytest.raises(ValueError, match="not fenced"):
        rec.idle_gaps()


def test_fork_and_join_count_on_the_open_bracketed_spans(monkeypatch):
    """fork_streams counts ``streams`` 2 and join_streams ``joined`` 1 on
    the open spans bracketed on the device, and on no other; between the
    two the bracket is not fenced, so idle_gaps refuses it once closed;
    with the recorder off, nothing is counted."""
    card = _FakeCard()
    monkeypatch.setattr(torch.cuda, "Event", _FakeCard.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: card)
    monkeypatch.setattr(torch.cuda, "default_stream", lambda d=None: card)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    rec = tracing.Recorder()
    monkeypatch.setattr(tracing, "RECORDER", rec)
    dev = card.device
    tracing.fork_streams(dev)  # off: nothing open, nothing counted
    rec.on = True
    for join in (False, True):
        with tracing.span("epoch", 0) as ep:
            ep.begin_device(dev)
            with tracing.span("launch") as la:
                tracing.fork_streams(dev)
                if join:
                    tracing.join_streams(dev)
        assert la.counts is None
        assert ep.counts == ({"streams": 2, "joined": 1} if join
                             else {"streams": 2})
        if join:
            assert rec.idle_gaps() == []  # one bracket, merged
        else:
            with pytest.raises(ValueError, match="not fenced"):
                rec.idle_gaps()
            rec.clear()


class _FakeCard:
    """A card for the recorder's clock on the CPU, and a stream of it: an
    event is stamped with the host clock plus OFFSET when recorded and is
    done at once; the stream has nothing queued while ``idle``, keeps
    the events recorded on it and counts its waits."""

    OFFSET = 1000.0

    def __init__(self):
        self.idle = True
        self.device = torch.device("cuda", 0)
        self.events, self.waits = [], 0

    def query(self):
        return self.idle

    def wait_stream(self, other):
        self.waits += 1

    def wait_event(self, event):
        self.waits += 1

    def record_event(self):
        ev = _FakeCard.Event()
        ev.record(self)
        return ev

    class Event:
        def __init__(self, enable_timing=False):
            self.t, self.records = None, 0

        def record(self, stream=None):
            self.t = time.perf_counter() + _FakeCard.OFFSET
            self.records += 1
            if stream is not None:
                stream.events.append(self)

        def query(self):
            return self.t is not None

        def elapsed_time(self, end):
            return 1e3 * (end.t - self.t)


def test_device_clock_anchors_on_the_waited_event_and_idle_streams(
        monkeypatch):
    card = _FakeCard()
    default = [card]
    monkeypatch.setattr(torch.cuda, "Event", _FakeCard.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: card)
    monkeypatch.setattr(torch.cuda, "default_stream",
                        lambda d=None: default[0])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    dev = torch.device("cuda", 0)
    rec = tracing.Recorder()
    rec.on = True

    def epoch(e):
        with rec.open("epoch", e) as sp:
            sp.begin_device(dev)

    epoch(0)  # the stream is idle: an anchor
    first = rec._anchors[0]
    epoch(1)  # under IDLE_ANCHOR_S after it: none
    assert rec._anchors[0] is first
    mine = _FakeCard.Event()
    mine.record()
    with rec.open("wait") as sp:  # the wait on the caller's event
        sp.anchor(dev, mine)
    assert rec._anchors[0][0] is mine and not rec._anchors[0][2]
    card.idle = False
    time.sleep(tracing.IDLE_ANCHOR_S)
    epoch(2)  # the stream is busy: no anchor
    assert rec._anchors[0][0] is mine
    card.idle = True
    time.sleep(tracing.IDLE_ANCHOR_S)
    epoch(3)  # idle again: the recorder's own anchor
    assert rec._anchors[0][0] is not mine and rec._anchors[0][2]
    ours = rec._anchors[0]
    default[0] = _FakeCard()
    time.sleep(tracing.IDLE_ANCHOR_S)
    epoch(4)  # idle, but not the default stream: no anchor
    assert rec._anchors[0] is ours
    # the caller's event is never pooled nor recorded again
    assert mine not in rec._pool and mine.records == 1
    brackets = [r for r in rec.records() if r.device is not None]
    assert [r.epoch for r in brackets] == [0, 1, 2, 3, 4]
    for r in brackets:  # placed on the host clock, within the anchors' error
        d0, d1 = r.device
        assert r.t0 - 1e-3 <= d0 <= d1 <= r.t1 + 1e-3, (r.epoch, r.device)


def test_pipelined_step_brackets_both_streams_on_a_fake_card(
        case, monkeypatch):
    """Two pipelined steps, each inside an epoch bracketed on the fake
    card's main stream: the priming step records ``keys`` alone; the next
    forks, its ``probe`` bracketed on the second stream (not the default
    one: no idle anchor there) inside its epoch's bracket, ``keys`` on the
    main one, and the epoch counts the fork and the join, so idle_gaps
    merges the streams. The recorder
    adds no wait: each stream waits once, as the step itself asks."""
    cfg = dataclasses.replace(case["cfg"], cross_pipeline=True)
    s = S.Solver(cfg, baby=case["solver"].baby, device="cpu")
    q0 = ecpy.sub(ecpy.mul(case["key"]), ecpy.mul(PK))
    centers = [s._centers_on_device(q0, e * cfg.jobs_per_epoch)
               for e in (0, 1)]
    main, side = _FakeCard(), _FakeCard()
    current = [main]

    @contextlib.contextmanager
    def on(stream):
        current[0], was = stream, current[0]
        try:
            yield
        finally:
            current[0] = was

    monkeypatch.setattr(torch.cuda, "Event", _FakeCard.Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: current[0])
    monkeypatch.setattr(torch.cuda, "default_stream", lambda d=None: main)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, st: None)
    monkeypatch.setattr(G, "_fork", lambda dev: (main, side))
    rec = tracing.Recorder()
    rec.on = True
    monkeypatch.setattr(tracing, "RECORDER", rec)
    kw = dict(htsz=cfg.htsz, chunk_c=cfg.chunk_c, lanes_w=cfg.lanes_w,
              hit_cap=cfg.hit_cap)
    planes = (s.ox_pk, s.oy_pk, s.baby.rows)
    out = (None,) * 3
    for e, (cx, cy, cinf) in enumerate(centers):
        with rec.open("epoch", e) as sp:
            sp.begin_device(main.device)
            out = G.pipelined_step(*out[:3], centers[0][2] if e else None,
                                   e > 0, cx, cy, *planes, **kw)
    assert (main.waits, side.waits) == (1, 1)
    # the probe's bracket and the join's event; the anchor is main's
    assert len(side.events) == 3 and current == [main]
    assert rec._anchors[0][0] in main.events
    recs = rec.records()
    by = {n: [r for r in recs if r.name == n]
          for n in ("epoch", "probe", "keys")}
    t, n = cfg.jobs_per_epoch, cfg.n_offsets
    assert [r.counts for r in by["epoch"]] == [
        None, {"streams": 2, "joined": 1}]
    assert [r.epoch for r in by["keys"]] == [0, 1]
    assert {r.counts["T"] for r in by["keys"]} == {t}
    (probe,) = by["probe"]
    assert probe.epoch == 1 and probe.parent == "epoch"
    assert probe.counts == {"keys": 2 * t * n + t, "launches": 0}
    for r in recs:
        (ep,) = [q for q in by["epoch"] if q.epoch == r.epoch]
        assert None not in r.device, r.name
        assert ep.device[0] <= r.device[0] <= r.device[1] <= ep.device[1]
    assert len(rec.idle_gaps()) == 1


def test_dump_writes_a_chrome_trace(tmp_path):
    rec = _synthetic()
    rec._ring[1].count("T", 16)
    rec.dump(tmp_path / "t.json")
    trace = json.loads((tmp_path / "t.json").read_text())
    events = trace["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert {e["ph"] for e in events} == {"M", "X"}
    assert len([e for e in spans if e["tid"] == 0]) == 7
    device = [e for e in spans if e["tid"] == 1]
    assert [(e["ts"], e["dur"]) for e in device] == [
        (1e6, 2e6), (2e6, 2e6), (6e6, 2e6), (11e6, 1e6)]
    assert spans[1]["args"]["T"] == 16 and spans[1]["name"] == "epoch"
    for e in spans:
        assert e["dur"] >= 0 and isinstance(e["ts"], float)
    report = rec.report()
    assert "device idle between brackets: 5000.0 ms" in report
    assert "centers" in report and "verify" in report


def test_cli_writes_the_trace_and_its_table(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "trace.json"
    monkeypatch.setenv(cli.TRACE_ENV, str(path))
    k = 0xC0000 + 2 * 2 * 17 * 512 + 77  # epoch 2
    rc = cli.main(["--pub", codecs.format_pubkey(ecpy.mul(k)), "--pk",
                   "c0000", "--pke", "d0000", "--w", "8", "--htsz", "6",
                   "--n-offsets", "8", "--jobs-per-epoch", "2",
                   "--pipeline", "1"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0 and f"KEY FOUND: {k:#x}" in out
    assert f"trace written to {path}" in out and "self ms" in out
    assert not tracing.enabled()
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e["ph"] == "X"}
    assert {"build", "solve", "epoch", "collect", "verify"} <= names
    tracing.clear()


# -- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda")


def _syncs(fn) -> int:
    """Synchronising CUDA calls fn makes (set_sync_debug_mode warnings)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in got)


@pytest.mark.chip
def test_on_the_card_no_sync_added_and_brackets_resolve(cuda):
    c = _case(cuda)
    s = c["solver"]
    pub = ecpy.mul(c["key"])
    q0 = ecpy.sub(pub, ecpy.mul(PK))

    def one_epoch():  # epoch 3: no hit planted
        s._collect(pub, PK, s._epoch(q0, 3))

    one_epoch()  # build and warm
    off = _syncs(one_epoch)
    tracing.clear()
    tracing.enable()
    try:
        on = _syncs(one_epoch)
        tracing.clear()
        res = _solve(c)
    finally:
        tracing.disable()
    # the wait on the epoch's own event is the one wait, and the sync
    # debug mode does not flag an event's synchronize
    assert on == off == 0
    assert res.key == c["key"]
    torch.cuda.synchronize()
    recs = tracing.records()
    brackets = [r for r in recs if r.device is not None]
    assert {r.name for r in brackets} == {"epoch", "lookup"}
    assert len([r for r in brackets if r.name == "epoch"]) >= res.epochs
    for r in brackets:
        d0, d1 = r.device
        assert d0 is not None and d1 is not None, r.name
        # an event completes after it is recorded, within the anchor's
        # error
        assert r.t0 - 1e-3 <= d0 <= d1, (r.name, r.t0, r.device)
    (solve,) = [r for r in recs if r.name == "solve"]
    gaps = tracing.idle_gaps(solve.t0, solve.t1)
    assert gaps and all(a < b for a, b, _ in gaps)
    assert {n for _, _, n in gaps} <= set(TREE) | {tracing.OUTSIDE}
    tracing.dump(os.devnull)
    tracing.clear()


SPIN_CYCLES = 1 << 28  # about 0.15 s of the H100's clock


@pytest.mark.chip
def test_on_the_card_collect_leaves_the_epochs_behind_it_running(cuda):
    """Epochs 0-2 queued and a spin kernel before epoch 2: collecting
    epoch 0 waits for its own event alone, so it returns while epoch 2's
    is pending, and every bracket still resolves on the host clock."""
    c = _case(cuda)
    s = c["solver"]
    pub = ecpy.mul(c["key"])
    q0 = ecpy.sub(pub, ecpy.mul(PK))
    s._collect(pub, PK, s._epoch(q0, 3))  # build and warm
    torch.cuda.synchronize()
    tracing.clear()
    tracing.enable()
    try:
        recs = [s._epoch(q0, 0), s._epoch(q0, 1)]
        torch.cuda._sleep(SPIN_CYCLES)
        recs.append(s._epoch(q0, 2))
        s._behind = collections.deque(recs[1:])
        batch, _ = s._collect(pub, PK, recs[0])
        returned = time.perf_counter()
        pending = not recs[2][2].ready()
        s._behind = ()
        torch.cuda.synchronize()
        spans = tracing.records()
    finally:
        tracing.disable()
    assert pending and len(batch) >= 1  # epoch 0's planted hit
    (wait,) = [r for r in spans if r.name == "wait"]
    assert wait.counts["queued"] == 2 and wait.counts["busy"] >= 1
    brackets = [r for r in spans if r.device is not None]
    assert sorted(r.epoch for r in brackets) == [0, 1, 2]
    for r in brackets:
        d0, d1 = r.device
        assert d0 is not None and d1 is not None, r.epoch
        assert r.t0 - 1e-3 <= d0 <= d1, (r.epoch, r.t0, r.device)
    (last,) = [r for r in brackets if r.epoch == 2]
    assert last.device[1] > returned  # it ran on after the wait returned
    tracing.clear()
