"""The ``Observability`` bundle the FL stack threads through itself
(``repro.obs.core``).

One object carries the tracer, the metrics registry, the health monitor
and the optional profiler hook; ``run_fedssl(obs=...)``,
``run_lm_fedssl(obs=...)``, the engines and the transport all hold a
reference (``NOOP_OBS`` by default: everything off, nothing launched,
allocated or synchronised on the card) and record unconditionally.

``make_obs(trace=..., metrics=..., profile_dir=...)`` builds an enabled
bundle; ``obs.export(...)`` writes whichever artifacts were requested
(JSONL trace, Chrome trace, metrics CSV, health report). The profiler is
``torch.profiler`` (the reference's is ``jax.profiler``): CPU activity,
and CUDA activity where the process sees a card; ``stop_profiler`` writes
its Chrome trace to ``<profile_dir>/torch_profile.json``. A profiler that
fails to start raises: the reference's "continuing untraced" is not
copied. While it runs, each span of a recording tracer also opens a
``torch.profiler.record_function`` range of its name, so the profiler's
trace holds the program's spans on its own clock (and, on the card, the
device time under each as ``gpu_user_annotation`` rows).
"""
from __future__ import annotations

import pathlib
from typing import Optional

from repro_torch.obs import export as export_mod
from repro_torch.obs.metrics import NOOP_METRICS, MetricsRegistry
from repro_torch.obs.trace import NOOP_TRACER, Tracer, is_tracing

PROFILE_TRACE = "torch_profile.json"


class Observability:
    """Tracer + metrics + health + profiler hooks. Prefer ``make_obs``."""

    def __init__(self, tracer=NOOP_TRACER, metrics=NOOP_METRICS,
                 profile_dir: Optional[str] = None, health=None,
                 measure_resources: bool = False):
        self.tracer = tracer
        self.metrics = metrics
        self.profile_dir = profile_dir
        self.health = health
        # the drivers count the FLOPs of each stage's first local step and
        # put them (res.*) on the stage-opening round span
        self.measure_resources = measure_resources
        self._profiler = None

    @property
    def enabled(self) -> bool:
        return (is_tracing(self.tracer)
                or isinstance(self.metrics, MetricsRegistry)
                or self.profile_dir is not None
                or self.health is not None)

    # -- torch.profiler hooks ------------------------------------------------
    def start_profiler(self):
        if self.profile_dir is None or self._profiler is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._profiler = prof
        if is_tracing(self.tracer):
            self.tracer.ranges = torch.profiler.record_function

    def stop_profiler(self):
        """Stop the profiler and write its Chrome trace; returns the path
        (None when no profiler ran)."""
        if self._profiler is None:
            return None
        prof, self._profiler = self._profiler, None
        if is_tracing(self.tracer):
            self.tracer.ranges = None
        prof.stop()
        path = pathlib.Path(self.profile_dir) / PROFILE_TRACE
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        return path

    # -- artifact export -----------------------------------------------------
    def export(self, *, trace_jsonl=None, chrome_trace=None,
               metrics_csv=None, health_json=None, **meta):
        """Write the requested artifacts; returns {kind: path}."""
        written = {}
        if trace_jsonl and is_tracing(self.tracer):
            written["trace_jsonl"] = export_mod.write_jsonl(
                self.tracer, trace_jsonl, **meta)
        if chrome_trace and is_tracing(self.tracer):
            written["chrome_trace"] = export_mod.write_chrome_trace(
                self.tracer, chrome_trace, **meta)
        if metrics_csv and isinstance(self.metrics, MetricsRegistry):
            written["metrics_csv"] = export_mod.write_metrics_csv(
                self.metrics, metrics_csv)
        if health_json and self.health is not None:
            from repro_torch.obs.health import write_health_json
            pathlib.Path(health_json).parent.mkdir(parents=True,
                                                   exist_ok=True)
            write_health_json(health_json, self.health, **meta)
            written["health_json"] = health_json
        return written


NOOP_OBS = Observability()


def make_obs(*, trace: bool = False, metrics: bool = False,
             profile_dir: Optional[str] = None, clock=None,
             health: bool = False, halt_on_unhealthy: bool = False,
             measure_resources: bool = False,
             **meta) -> Observability:
    """Build an enabled bundle; extra kwargs become trace run metadata.
    ``health=True`` attaches a ``HealthMonitor`` the driver feeds each
    round; ``halt_on_unhealthy`` arms its halt-on-fatal hook;
    ``measure_resources`` the per-stage FLOP count
    (``repro_torch.obs.resources``)."""
    if trace:
        tracer = Tracer(clock) if clock is not None else Tracer()
        tracer.meta.update(meta)
    else:
        tracer = NOOP_TRACER
    monitor = None
    if health or halt_on_unhealthy:
        from repro_torch.obs.health import HealthMonitor
        monitor = HealthMonitor(halt_on_fatal=halt_on_unhealthy)
    return Observability(
        tracer=tracer,
        metrics=MetricsRegistry() if metrics else NOOP_METRICS,
        profile_dir=profile_dir, health=monitor,
        measure_resources=measure_resources)
