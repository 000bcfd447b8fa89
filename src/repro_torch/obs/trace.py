"""Span-based tracer for the FL stack (a copy of ``repro.obs.trace``,
standard library only).

One ``Tracer`` records one run as a flat, append-only event list. Spans
nest (``run > round > {download, local_train, upload, aggregate,
calibrate}`` with per-client / per-codec children); each completed span
becomes one Chrome ``trace_event``-shaped record::

    {"ph": "X", "name", "cat", "ts", "dur", "pid", "tid",
     "seq", "parent", "depth", "args"}

``ts``/``dur`` are microseconds (wall-clock by default). ``seq`` is the
span *open* order and ``parent`` the enclosing span's ``seq``, so the
nesting structure is reconstructible from the flat list and — unlike the
timestamps — fully deterministic for a seeded run (the determinism tests
compare ``structure()`` across runs). ``args`` carries the attached
attributes (stage, wire bytes, codec, participants, ...).

Besides wall-clock spans the tracer holds named *virtual tracks*
(``virtual_span``): spans with caller-supplied timestamps on their own
``tid``, used by the fleet simulator to lay each client's simulated round
out on the simulated timeline. Exporters render tracks as threads, so a
simulated 1000-client round reads like a real profile in Perfetto.

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
                 "depth", "_t0")

    def __init__(self, tracer, name, cat, args, seq, parent, depth, t0):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.seq = seq
        self.parent = parent
        self.depth = depth
        self._t0 = t0

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
        return s

    def _close(self, span: Span):
        top = self._stack.pop()
        assert top is span, (top.name, span.name)
        t1 = self._now_us()
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
        driver attaches to round spans) are environment noise, not
        structure, and are dropped here."""
        return [(e["seq"], e["parent"], e["depth"], e["name"], e["cat"],
                 e["tid"], tuple(sorted(
                     (k, v) for k, v in e["args"].items()
                     if not k.startswith("mem."))))
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
