"""Exporters: JSONL event stream, Chrome ``trace_event`` JSON, metrics
CSV, and the console round-line renderer (a copy of ``repro.obs.export``,
standard library only; the reference's ``repro.launch.trace`` reads the
port's JSONL as its own).

  JSONL        one header line (``{"kind": "repro-trace", "version", ...
               run metadata}``) followed by one event object per line —
               the machine-readable stream ``repro.launch.trace`` and the
               benches analyze.
  Chrome       ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with
               complete (``"X"``) / instant (``"i"``) events plus
               ``thread_name`` metadata for the virtual tracks; loads
               directly in Perfetto / ``chrome://tracing``. Validated by
               ``benchmarks.schemas.validate_chrome_trace``.
  metrics CSV  ``metric,type,field,value`` rows flattened from
               ``MetricsRegistry.to_dict()`` (validated by
               ``benchmarks.schemas.validate_metrics_csv``).
  console      ``format_round_line`` is the one formatter for the
               per-round progress line (the driver and both launcher
               modes route through it), and ``ConsoleRenderer`` optionally
               renders it as a live single-line (``\\r``) status.
"""
from __future__ import annotations

import io
import json
import pathlib
import sys
from typing import Any, Dict, List, Optional, Tuple

TRACE_KIND = "repro-trace"
TRACE_VERSION = 1
METRICS_CSV_HEADER = "metric,type,field,value"


# ---------------------------------------------------------------------------
# JSONL event stream
# ---------------------------------------------------------------------------
def trace_header(tracer, **meta) -> Dict[str, Any]:
    h = {"kind": TRACE_KIND, "version": TRACE_VERSION,
         "tracks": tracer.tracks}
    h.update(tracer.meta)
    h.update(meta)
    return h


def write_jsonl(tracer, path, **meta) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        f.write(json.dumps(trace_header(tracer, **meta)) + "\n")
        for e in tracer.events:
            f.write(json.dumps(e) + "\n")
    return path


def read_jsonl(path) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """(header, events) from a JSONL trace; validates the header kind."""
    lines = pathlib.Path(path).read_text().splitlines()
    if not lines:
        raise ValueError(f"{path}: empty trace")
    header = json.loads(lines[0])
    if header.get("kind") != TRACE_KIND:
        raise ValueError(f"{path}: not a {TRACE_KIND} file "
                         f"(kind={header.get('kind')!r})")
    return header, [json.loads(ln) for ln in lines[1:] if ln.strip()]


# ---------------------------------------------------------------------------
# Chrome trace_event JSON (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------
def chrome_trace_doc(tracer, **meta) -> Dict[str, Any]:
    events: List[Dict[str, Any]] = []
    for name, tid in sorted(tracer.tracks.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": name}})
    for e in tracer.events:
        ev = {"ph": e["ph"], "name": e["name"], "cat": e["cat"],
              "ts": e["ts"], "pid": e["pid"], "tid": e["tid"],
              "args": e["args"]}
        if e["ph"] == "X":
            ev["dur"] = e["dur"]
        else:                      # instants need an explicit scope
            ev["s"] = "t"
        events.append(ev)
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"kind": TRACE_KIND, "version": TRACE_VERSION,
                         **tracer.meta, **meta}}
    return doc


def write_chrome_trace(tracer, path, **meta) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace_doc(tracer, **meta)))
    return path


# ---------------------------------------------------------------------------
# metrics CSV
# ---------------------------------------------------------------------------
def metrics_csv_text(registry) -> str:
    """Flatten ``registry.to_dict()`` into ``metric,type,field,value``
    rows (histograms contribute one row per summary field)."""
    d = registry.to_dict()
    out = io.StringIO()
    out.write(METRICS_CSV_HEADER + "\n")
    for name, v in d["counters"].items():
        out.write(f"{name},counter,value,{v!r}\n")
    for name, v in d["gauges"].items():
        out.write(f"{name},gauge,value,{v!r}\n")
    for name, s in d["histograms"].items():
        for field, v in s.items():
            out.write(f"{name},histogram,{field},{v!r}\n")
    return out.getvalue()


def write_metrics_csv(registry, path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(metrics_csv_text(registry))
    return path


def write_history_json(hist, path, **meta) -> pathlib.Path:
    """Dump an ``FLHistory`` via its versioned ``to_dict`` form — the one
    serialization traces, benches and checkpoints share."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = hist.to_dict()
    if meta:
        doc["meta"] = meta
    path.write_text(json.dumps(doc, indent=1))
    return path


# ---------------------------------------------------------------------------
# console
# ---------------------------------------------------------------------------
def format_round_line(round_idx: int, rounds: int, stage: int, loss: float,
                      *, lr: Optional[float] = None,
                      down_mb: Optional[float] = None,
                      up_mb: Optional[float] = None,
                      wire_mb: Optional[float] = None,
                      extra: str = "") -> str:
    """The per-round progress line — single formatter for the driver and
    both launcher modes (it used to be copy-pasted between them)."""
    parts = [f"round {round_idx + 1}/{rounds} stage {stage} "
             f"loss {loss:.4f}"]
    if lr is not None:
        parts.append(f"lr {lr:.2e}")
    if down_mb is not None:
        parts.append(f"down {down_mb:.2f}MB")
    if up_mb is not None:
        parts.append(f"up {up_mb:.2f}MB")
    if wire_mb is not None:
        parts.append(f"wire {wire_mb:.2f}MB")
    line = " ".join(parts)
    return line + extra


class ConsoleRenderer:
    """Callable console sink for progress lines.

    ``live=True`` rewrites a single status line in place (``\\r``, padded
    to the previous width); ``live=False`` prints one line per call.
    Drop-in for the driver's ``log=`` callback; call ``close()`` (or use
    as a context manager) to terminate a live line with a newline."""

    def __init__(self, live: bool = False, stream=None):
        self.live = live
        self.stream = stream if stream is not None else sys.stdout
        self._last_len = 0

    def __call__(self, line: str):
        if self.live:
            pad = max(0, self._last_len - len(line))
            self.stream.write("\r" + line + " " * pad)
            self.stream.flush()
            self._last_len = len(line)
        else:
            self.stream.write(line + "\n")

    def close(self):
        if self.live and self._last_len:
            self.stream.write("\n")
            self.stream.flush()
            self._last_len = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
