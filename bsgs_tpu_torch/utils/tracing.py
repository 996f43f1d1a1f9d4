"""Spans, counts and a device clock inside the solve loop.

Off by default, and then ``span(name)`` returns one shared null context:
no clock is read and nothing is allocated. ``enable()`` turns the
process's recorder on. Each span then becomes a record of

- its name and its parent, the innermost span open when it opened;
- its solve (the id every span of one ``Solver.solve`` call shares) and
  its epoch (given where it opens, else its parent's);
- its start and end on ``time.perf_counter``;
- its counts (``count(key, n)``; ``delta``/``deltas`` count the change of
  a counter the program already keeps, such as ``ops/_cuda.LAUNCHES`` or
  a rescan lookup's ``stats``, over the span).

Records are kept in a ring of at most ``RING`` (the oldest go first and
are counted in ``dropped``).

**The device clock.** On a CUDA device a span may bracket the device work
it queues: ``begin_device`` records a timing event on the current stream,
and the span's end records another. Bracket events are put on the host
clock through an anchor, an event whose completion the host saw happen:

- the event a span waited on (``anchor``): the caller's own event, which
  the span's wait blocked on; when the wait returns the event is
  complete, so the host time at the span's end places it;
- the event ``begin_device`` records first where the device's default
  stream is current and has nothing queued (``Stream.query()``): it
  completes as it is recorded. Such an anchor is taken at most every
  ``IDLE_ANCHOR_S`` after the last one, since each one places the pending
  events.

The first covers a card that runs ahead of the host, the second a host
that runs ahead of the card. Every bracket event is placed through its
device's latest anchor, and only once ``query()`` says both are done: the
recorder adds no synchronisation of its own, and never records, pools or
re-records an event it was given. ``idle_gaps`` gives the device's gaps
between consecutive brackets, each with the innermost host span at its
midpoint. The gaps are idle where all the loop's device work lies inside
brackets; idle time inside a bracket (the device catching up with the
host within one epoch) is not seen. Work on a second stream lies inside
a bracket where it is fenced: forked from the bracket's stream after the
bracket began (``fork_streams``) and joined back before it ends
(``join_streams``).

``dump(path)`` writes a chrome trace (Perfetto opens it), host spans and
device brackets on the same clock; ``report()`` gives the table that the
command line prints under ``BSGS_TORCH_TRACE``. One thread drives the
solve loop; the recorder is not meant to be shared between threads.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable, Optional

RING = 1 << 18
IDLE_ANCHOR_S = 0.05  # the least host time between idle-stream anchors
SOLVE = "solve"  # a span of this name starts a new solve id
OUTSIDE = "(no span)"  # the label of a gap outside every host span


class _Null:
    """What span() returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def count(self, key, n):
        pass

    def delta(self, key, read):
        pass

    def deltas(self, counters):
        pass

    def begin_device(self, device):
        pass

    def anchor(self, device, event):
        pass


NULL = _Null()


class Span:
    """One span: the handle inside its ``with`` block, then its record.
    ``device`` is the bracket's [start, end] on the host clock (None while
    an event is unresolved), or None for a span that bracketed nothing."""

    __slots__ = ("id", "name", "parent", "parent_id", "solve", "epoch",
                 "t0", "t1", "counts", "device", "_owner", "_watch",
                 "_anchor", "_bracket")

    def __init__(self, owner, sid, name, parent, epoch):
        self._owner = owner
        self.id = sid
        self.name = name
        self.parent = parent.name if parent is not None else None
        self.parent_id = parent.id if parent is not None else None
        self.solve = (sid if name == SOLVE
                      else parent.solve if parent is not None else None)
        self.epoch = (epoch if epoch is not None
                      else parent.epoch if parent is not None else None)
        self.counts = None
        self.device = None
        self._watch = None
        self._anchor = None
        self._bracket = None  # the device the bracket started on
        self.t1 = None
        self.t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        self._owner._close(self)
        return False

    def count(self, key: str, n) -> None:
        if self.counts is None:
            self.counts = {}
        self.counts[key] = self.counts.get(key, 0) + n

    def delta(self, key: str, read: Callable) -> None:
        """Count the change of ``read()`` from now to the span's end."""
        if self._watch is None:
            self._watch = []
        self._watch.append((key, read, read()))

    def deltas(self, counters: dict) -> None:
        """Count the change of every entry of a dict of counters from now
        to the span's end."""
        for key in counters:
            self.delta(key, lambda k=key: counters[k])

    def begin_device(self, device) -> None:
        """Start this span's device bracket on ``device``'s current stream
        (nothing on another device, or once begun). A span whose work
        forks onto a second stream counts ``streams`` 2 (fork_streams),
        which makes idle_gaps refuse unless it counts ``joined`` too
        (join_streams)."""
        if self.device is None and getattr(device, "type", None) == "cuda":
            self.device = [None, None]
            self._bracket = device
            self._owner._idle_anchor(device)
            self._owner._event(self, 0, device)

    def anchor(self, device, event) -> None:
        """Anchor the device clock at this span's end on ``event``, the
        caller's event that the span's wait blocks on."""
        if getattr(device, "type", None) == "cuda":
            self._anchor = (_index(device), event, False)

    def _finish(self) -> None:
        if self._watch is not None:
            for key, read, base in self._watch:
                self.count(key, read() - base)
            self._watch = None


class Recorder:
    """The ring of span records, the open spans, and the device events
    waiting to be placed on the host clock."""

    def __init__(self, capacity: int = RING):
        self.on = False
        self.capacity = capacity
        self.clear()

    def clear(self) -> None:
        self._ring = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self._stack = []
        self._ids = 0
        self._pending = []  # (device index, event, span, 0 or 1)
        self._anchors = {}  # device index: (event, host time, recorder's)
        self._pool = []

    # -- spans ---------------------------------------------------------
    def open(self, name: str, epoch=None) -> Span:
        parent = self._stack[-1] if self._stack else None
        self._ids += 1
        s = Span(self, self._ids, name, parent, epoch)
        self._stack.append(s)
        return s

    def _close(self, s: Span) -> None:
        if s._bracket is not None:
            self._event(s, 1, s._bracket)
            s._bracket = None
        s._finish()
        if s._anchor is not None:
            self._take_anchor(*s._anchor, s.t1)
            s._anchor = None
        if self._stack and self._stack[-1] is s:  # not after a clear()
            self._stack.pop()
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(s)

    def innermost(self, name: str) -> Optional[Span]:
        for s in reversed(self._stack):
            if s.name == name:
                return s
        return None

    def mark_streams(self, device, key: str, n: int) -> None:
        """Set count ``key`` to ``n`` on each open span whose bracket began
        on ``device``."""
        for s in self._stack:
            if s._bracket is not None and _index(s._bracket) == \
                    _index(device):
                s.counts = dict(s.counts or {}, **{key: n})

    # -- device events -------------------------------------------------
    def _record(self, device):
        """(device index, a pooled timing event recorded now on the
        device's current stream)."""
        import torch

        ev = self._pool.pop() if self._pool else torch.cuda.Event(
            enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return _index(device), ev

    def _event(self, s: Span, which: int, device) -> None:
        self._pending.append(self._record(device) + (s, which))

    def _idle_anchor(self, device) -> None:
        """Anchor on an event recorded now where the device's current
        stream is its default one and has nothing queued (it completes as
        it is recorded), unless the device's last anchor is under
        IDLE_ANCHOR_S old. A second stream that waits on another's event
        may read as empty while its work is still held back."""
        import torch

        last = self._anchors.get(_index(device))
        if last is not None and time.perf_counter() - last[1] < IDLE_ANCHOR_S:
            return
        cur = torch.cuda.current_stream(device)
        if cur == torch.cuda.default_stream(device) and cur.query():
            idx, ev = self._record(device)
            self._take_anchor(idx, ev, True, time.perf_counter())

    def _take_anchor(self, idx, ev, ours: bool, t_host: float) -> None:
        old = self._anchors.get(idx)
        self._anchors[idx] = (ev, t_host, ours)
        if old is not None and old[2]:
            self._pool.append(old[0])
        self._resolve()

    def _resolve(self) -> None:
        """Place every finished bracket event on the host clock through
        its device's latest anchor, once that anchor is done too."""
        left = []
        for p in self._pending:
            idx, ev, s, which = p
            a = self._anchors.get(idx)
            if a is None or not a[0].query() or not ev.query():
                left.append(p)
                continue
            a_ev, t_host, _ = a
            s.device[which] = t_host + a_ev.elapsed_time(ev) / 1e3
            self._pool.append(ev)
        self._pending = left

    # -- reading -------------------------------------------------------
    def records(self) -> list:
        """The closed spans in the ring, oldest first, their finished
        brackets placed on the host clock."""
        self._resolve()
        return list(self._ring)

    def idle_gaps(self, lo: float = float("-inf"),
                  hi: float = float("inf")) -> list:
        """(start, end, innermost host span at the midpoint) of each gap
        between consecutive device brackets, of the brackets that reach
        into [lo, hi], every stream's merged. Raises ValueError where a
        bracket there forked a second stream (fork_streams) that it did not
        join back (join_streams): work on that stream could then lie
        outside every bracket, so the gaps are not known."""
        recs = self.records()
        brackets = []
        for s in recs:
            d = s.device
            if d is None or d[0] is None or d[1] is None:
                continue
            if d[1] < lo or d[0] > hi:
                continue
            if s.counts and s.counts.get("streams", 1) > 1 \
                    and not s.counts.get("joined"):
                raise ValueError(
                    f"span {s.name!r} queued device work on "
                    f"{s.counts['streams']} streams, not fenced: the gaps "
                    f"between its brackets do not say when the device "
                    f"idled")
            brackets.append((d[0], d[1]))
        busy = _merge(brackets)
        gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
        names = _innermost([(s.t0, s.t1, s.name) for s in recs],
                           [(a + b) / 2 for a, b in gaps])
        return [(a, b, n or OUTSIDE) for (a, b), n in zip(gaps, names)]

    def dump(self, path) -> None:
        """Write the records as a chrome trace: host spans on one track,
        device brackets on another, in microseconds of the host clock."""
        pid = os.getpid()
        events = [
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": label}}
            for tid, label in ((0, "host"), (1, "device brackets"))]
        for s in self.records():
            args = dict(s.counts or {}, solve=s.solve, epoch=s.epoch)
            events.append({"ph": "X", "name": s.name, "cat": "host",
                           "pid": pid, "tid": 0, "ts": s.t0 * 1e6,
                           "dur": (s.t1 - s.t0) * 1e6, "args": args})
            d = s.device
            if d is not None and d[0] is not None and d[1] is not None:
                events.append({"ph": "X", "name": s.name,
                               "cat": "device", "pid": pid, "tid": 1,
                               "ts": d[0] * 1e6,
                               "dur": (d[1] - d[0]) * 1e6, "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"dropped": self.dropped}}, f)

    def report(self) -> str:
        """For each span name: count, mean ms, self ms (its time less its
        children's, summed) and its counts summed; then the device's idle
        ms between brackets by the host span it fell in."""
        recs = self.records()
        inner = collections.Counter()
        for s in recs:
            if s.parent_id is not None:
                inner[s.parent_id] += s.t1 - s.t0
        rows = {}
        for s in recs:
            n, tot, own, counts = rows.get(s.name, (0, 0.0, 0.0, None))
            d = s.t1 - s.t0
            counts = counts or collections.Counter()
            counts.update(s.counts or {})
            rows[s.name] = (n + 1, tot + d, own + d - inner[s.id], counts)
        lines = [f"{'span':<12} {'count':>8} {'mean ms':>10} {'self ms':>12}"
                 f"  counts"]
        for name, (n, tot, own, counts) in sorted(
                rows.items(), key=lambda kv: -kv[1][2]):
            summed = " ".join(f"{k}={v}" for k, v in counts.items())
            lines.append(f"{name:<12} {n:>8} {1e3 * tot / n:>10.3f} "
                         f"{1e3 * own:>12.1f}  {summed}".rstrip())
        try:
            gaps = self.idle_gaps()
        except ValueError as e:
            lines.append(f"device idle: not known ({e})")
            gaps = []
        if gaps:
            idle = collections.Counter()
            for a, b, name in gaps:
                idle[name] += b - a
            lines.append(f"device idle between brackets: "
                         f"{1e3 * sum(idle.values()):.1f} ms")
            lines += [f"  {name:<12} {1e3 * sec:>12.1f}"
                      for name, sec in idle.most_common()]
        if self.dropped:
            lines.append(f"({self.dropped} oldest records dropped)")
        return "\n".join(lines)


def _index(device) -> int:
    import torch

    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _merge(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, times) -> list:
    """The name of the innermost of properly nested spans (t0, t1, name)
    that holds each time, or None: one sweep in time order, the stack
    holding the spans open at the time reached."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = [None] * len(times)
    stack, i = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[k] = stack[-1][2]
    return out


RECORDER = Recorder()


def enable() -> None:
    """Turn the recorder on; records already kept stay."""
    RECORDER.on = True


def disable() -> None:
    RECORDER.on = False


def enabled() -> bool:
    return RECORDER.on


def clear() -> None:
    RECORDER.clear()


def span(name: str, epoch=None):
    """A span named ``name`` (its epoch given, else its parent's), or the
    null context while the recorder is off."""
    r = RECORDER
    if not r.on:
        return NULL
    return r.open(name, epoch)


def begin_device(name: str, device) -> None:
    """Start the device bracket of the innermost open span called
    ``name``, from here (nothing while the recorder is off)."""
    if RECORDER.on:
        s = RECORDER.innermost(name)
        if s is not None:
            s.begin_device(device)


def fork_streams(device) -> None:
    """Count ``streams`` 2 on the open spans bracketed on ``device``, where
    the caller forks a second stream from the current one (nothing while
    the recorder is off)."""
    if RECORDER.on:
        RECORDER.mark_streams(device, "streams", 2)


def join_streams(device) -> None:
    """Count ``joined`` 1 on the open spans bracketed on ``device``, where
    the caller joins the stream it forked back into the current one, so
    the spans' brackets fence the second stream's work (nothing while the
    recorder is off)."""
    if RECORDER.on:
        RECORDER.mark_streams(device, "joined", 1)


def records() -> list:
    return RECORDER.records()


def idle_gaps(lo: float = float("-inf"), hi: float = float("inf")) -> list:
    return RECORDER.idle_gaps(lo, hi)


def dump(path) -> None:
    RECORDER.dump(path)


def report() -> str:
    return RECORDER.report()
