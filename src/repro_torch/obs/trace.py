"""Span-based tracer for the FL stack (a copy of ``repro.obs.trace``,
standard library only).

One ``Tracer`` records one run as a flat, append-only event list. Spans
nest; a traced ViT run records (``*`` repeated, ``|`` one of)::

    run > round > download > wire.download
                  local_train > client.train* > local_step*      (sequential)
                                aggregate > wire.upload > wire.upload.client*
                                            fedavg
                              | engine.dispatch > engine.inputs  (vmap)
                                                  local_step*
                                                  wire.upload > ...
                                                  fedavg
                  calibrate > calibrate.step*
                  resources.measure

    local_step, calibrate.step > step.views, step.forward,
                                 step.backward, step.update

``step.views`` is the batch's augmentation on the device (on the
sequential engine with its draws; the vmap engine draws the whole round
in ``engine.inputs``), ``step.forward`` the loss, ``step.backward`` its
``torch.autograd.grad``, ``step.update`` the masked optimizer step and
the target EMA, ``fedavg`` the weighted mean of the decoded uploads. On a
CUDA device calibration's second step is captured as a CUDA graph and
every later one replays it (``server.server_calibrate``): each
``calibrate.step`` carries its ``mode`` (``eager``, ``capture`` or
``replay``), a replayed step holds ``step.views`` alone, and the
``calibrate`` span counts the replays in ``replays``.
Each completed span becomes one Chrome ``trace_event``-shaped record::

    {"ph": "X", "name", "cat", "ts", "dur", "pid", "tid",
     "seq", "parent", "depth", "args"}

``ts``/``dur`` are microseconds (wall-clock by default). ``seq`` is the
span *open* order and ``parent`` the enclosing span's ``seq``, so the
nesting structure is reconstructible from the flat list and — unlike the
timestamps — fully deterministic for a seeded run (the determinism tests
compare ``structure()`` across runs). ``args`` carries the attached
attributes (stage, wire bytes, codec, participants, ...) and, on every
completed span, ``cpu_us``: the process's CPU time over the span
(``time.process_time_ns``, every thread, so autograd's device thread
too). A span whose ``cpu_us`` is far below its ``dur`` is a host that
slept; the two are close for a host at work, and also for one that waits
on the card by spinning, as CUDA's default synchronise and a full launch
queue do (the device trace tells those apart).

Besides wall-clock spans the tracer holds named *virtual tracks*
(``virtual_span``): spans with caller-supplied timestamps on their own
``tid``, used by the fleet simulator to lay each client's simulated round
out on the simulated timeline. Exporters render tracks as threads, so a
simulated 1000-client round reads like a real profile in Perfetto.

While ``ranges`` is set (``Observability.start_profiler`` sets it to
``torch.profiler.record_function`` for as long as its profiler runs),
each span also opens a profiler range of its name, so the profiler's
trace holds the spans on its own clock.

``NOOP_TRACER`` implements the same surface as no-ops; instrumented code
holds an unconditional reference and pays only an attribute lookup and an
empty context manager when observability is off. Spans are host-timed:
on the card a span ends when the host leaves it, not when the work it
enqueued has run, unless something in it waits for the device.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

MAIN_TRACK = "main"


class Span:
    """An open span; a context manager. ``set(**attrs)`` attaches
    attributes any time before exit."""

    __slots__ = ("tracer", "name", "cat", "args", "seq", "parent",
                 "depth", "_t0", "_cpu0", "_range")

    def __init__(self, tracer, name, cat, args, seq, parent, depth, t0):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.seq = seq
        self.parent = parent
        self.depth = depth
        self._t0 = t0
        self._range = None
        self._cpu0 = time.process_time_ns()

    def set(self, **attrs):
        self.args.update(attrs)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.tracer._close(self)
        return False


class Tracer:
    """Collects events; see module docstring for the record shape."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self.events: List[Dict[str, Any]] = []
        self._stack: List[Span] = []
        self._seq = 0
        self._tracks: Dict[str, int] = {MAIN_TRACK: 0}
        self.meta: Dict[str, Any] = {}
        # a context-manager factory called with each span's name (the
        # profiler's ranges), or None
        self.ranges = None

    # -- clock ---------------------------------------------------------------
    def _now_us(self) -> float:
        return (self._clock() - self._epoch) * 1e6

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, cat: str = "fl", **attrs) -> Span:
        parent = self._stack[-1].seq if self._stack else None
        s = Span(self, name, cat, dict(attrs), self._seq, parent,
                 len(self._stack), self._now_us())
        self._seq += 1
        self._stack.append(s)
        if self.ranges is not None:
            s._range = self.ranges(name)
            s._range.__enter__()
        return s

    def _close(self, span: Span):
        cpu1 = time.process_time_ns()
        top = self._stack.pop()
        assert top is span, (top.name, span.name)
        t1 = self._now_us()
        if span._range is not None:
            span._range.__exit__(None, None, None)
        span.args["cpu_us"] = (cpu1 - span._cpu0) / 1e3
        self.events.append({
            "ph": "X", "name": span.name, "cat": span.cat,
            "ts": span._t0, "dur": t1 - span._t0, "pid": 0, "tid": 0,
            "seq": span.seq, "parent": span.parent, "depth": span.depth,
            "args": span.args,
        })

    def instant(self, name: str, cat: str = "fl", **attrs):
        """A zero-duration marker event (``ph: "i"``) at the current
        position in the span stack."""
        parent = self._stack[-1].seq if self._stack else None
        self.events.append({
            "ph": "i", "name": name, "cat": cat, "ts": self._now_us(),
            "dur": 0.0, "pid": 0, "tid": 0, "seq": self._seq,
            "parent": parent, "depth": len(self._stack), "args": dict(attrs),
        })
        self._seq += 1

    def virtual_span(self, name: str, track: str, t0_s: float, dur_s: float,
                     cat: str = "sim", **attrs):
        """A completed span with caller-supplied (simulated) timestamps on
        a named virtual track — its own ``tid``, seconds in, µs out."""
        tid = self._tracks.setdefault(track, len(self._tracks))
        parent = self._stack[-1].seq if self._stack else None
        self.events.append({
            "ph": "X", "name": name, "cat": cat, "ts": t0_s * 1e6,
            "dur": dur_s * 1e6, "pid": 0, "tid": tid, "seq": self._seq,
            "parent": parent, "depth": len(self._stack), "args": dict(attrs),
        })
        self._seq += 1

    # -- views ---------------------------------------------------------------
    @property
    def tracks(self) -> Dict[str, int]:
        return dict(self._tracks)

    def structure(self):
        """The timestamp-free view the determinism tests compare: one
        ``(seq, parent, depth, name, cat, tid, args)`` tuple per event.
        ``mem.``-prefixed args (the live device-memory watermarks the
        driver attaches to round spans) and ``cpu_us`` are environment
        noise, not structure, and are dropped here."""
        return [(e["seq"], e["parent"], e["depth"], e["name"], e["cat"],
                 e["tid"], tuple(sorted(
                     (k, v) for k, v in e["args"].items()
                     if not k.startswith("mem.") and k != "cpu_us")))
                for e in self.events]


class _NoopSpan:
    __slots__ = ()

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class NoopTracer:
    """Same surface as ``Tracer``; does nothing. A singleton
    (``NOOP_TRACER``) so disabled instrumentation allocates nothing."""

    events: List[Dict[str, Any]] = []
    meta: Dict[str, Any] = {}
    _span = _NoopSpan()

    def span(self, name, cat="fl", **attrs):
        return self._span

    def instant(self, name, cat="fl", **attrs):
        pass

    def virtual_span(self, name, track, t0_s, dur_s, cat="sim", **attrs):
        pass

    @property
    def tracks(self):
        return {}

    def structure(self):
        return []


NOOP_TRACER = NoopTracer()


def is_tracing(tracer) -> bool:
    """True when ``tracer`` actually records (not the no-op)."""
    return isinstance(tracer, Tracer)
