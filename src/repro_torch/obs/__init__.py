"""Structured tracing, metrics and training health for the port's FL stack
(``repro.obs``; the reference's ``resources`` is not ported yet).

Public surface:

  Tracer / NoopTracer / NOOP_TRACER      nested spans, instants, virtual
                                         tracks (repro_torch.obs.trace)
  MetricsRegistry / NOOP_METRICS         counters, gauges, histograms
                                         (repro_torch.obs.metrics)
  HealthMonitor / Alert                  per-round health detectors
                                         (repro_torch.obs.health)
  Observability / make_obs / NOOP_OBS    the bundle the stack threads
                                         through itself, with the
                                         torch.profiler hook
                                         (repro_torch.obs.core)
  write_jsonl / read_jsonl / write_chrome_trace / write_metrics_csv /
  write_history_json / format_round_line / ConsoleRenderer
                                         exporters (repro_torch.obs.export)

Everything is off by default: the drivers, engines and transport hold
``NOOP_OBS`` unless a real bundle is passed in (``run_fedssl(obs=...)``,
``run_lm_fedssl(obs=...)``, ``--trace`` / ``--metrics`` / ``--health`` /
``--profile-dir`` on ``repro_torch.launch.train``). The trace files have
the reference's format, so ``python -m repro.launch.trace`` analyses them.
"""
from repro_torch.obs.core import NOOP_OBS, Observability, make_obs
from repro_torch.obs.export import (ConsoleRenderer, chrome_trace_doc,
                                    format_round_line, metrics_csv_text,
                                    read_jsonl, trace_header,
                                    write_chrome_trace, write_history_json,
                                    write_jsonl, write_metrics_csv)
from repro_torch.obs.health import (HEALTH_VERSION, Alert, HealthMonitor,
                                    write_health_json)
from repro_torch.obs.metrics import NOOP_METRICS, MetricsRegistry
from repro_torch.obs.trace import (NOOP_TRACER, NoopTracer, Span, Tracer,
                                   is_tracing)

__all__ = [
    "NOOP_OBS", "Observability", "make_obs",
    "ConsoleRenderer", "chrome_trace_doc", "format_round_line",
    "metrics_csv_text", "read_jsonl", "trace_header", "write_chrome_trace",
    "write_history_json", "write_jsonl", "write_metrics_csv",
    "HEALTH_VERSION", "Alert", "HealthMonitor", "write_health_json",
    "NOOP_METRICS", "MetricsRegistry",
    "NOOP_TRACER", "NoopTracer", "Span", "Tracer", "is_tracing",
]
