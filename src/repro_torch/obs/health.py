"""Streaming training-health monitor over the per-round FL signals (a
copy of ``repro.obs.health``, standard library only; the port has no jit
cache, so its drivers pass ``recompiles=0``).

The driver feeds every round's cheap scalars — mean loss, wire
compression ratio, straggler drops, jit-recompile count — into
``HealthMonitor.observe_round``; the monitor keeps streaming statistics
(Welford mean/variance for the loss, per-stage reference ratios) and
returns typed ``Alert``s the driver turns into ``health.*`` instant
events on the trace. Detectors:

  loss_nonfinite    NaN/inf round loss (fatal — the model is gone; no
                    later round recovers it)
  loss_spike        z-score of the round loss against the running
                    per-stage distribution exceeds ``loss_z``. Stage
                    transitions reset the statistics: a new depth has a
                    new loss scale, so cross-stage z-scores are noise.
  compression_drift the wire compression ratio moved more than
                    ``ratio_rtol`` relative to the first ratio observed
                    for the stage — a codec or spec regression, since
                    the ratio is structural for a fixed plan
  drop_rate         cumulative straggler drop rate exceeds
                    ``drop_rate_max`` after ``warmup`` rounds
  recompile_storm   jit cache entries grew on a round that did NOT open
                    a new stage — every legal retrace in the FL loop is
                    tied to a plan-signature change

Observation is read-only: the monitor never touches model state, RNG
chains, or the trace timeline beyond its own instants, so runs with the
monitor attached stay bit-identical to untraced runs (asserted in
tests). ``report()`` serializes to the schema-validated ``health.json``
(``benchmarks.schemas.validate_health_report``); ``should_halt`` is the
driver's opt-in halt-on-fatal hook, modeled on the privacy
epsilon-budget halt.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import List, Optional

HEALTH_VERSION = 1

ALERT_KINDS = ("loss_nonfinite", "loss_spike", "compression_drift",
               "drop_rate", "recompile_storm")
ALERT_LEVELS = ("warn", "fatal")


@dataclass(frozen=True)
class Alert:
    round: int
    kind: str
    level: str
    value: float
    message: str

    def to_dict(self) -> dict:
        v = self.value
        return {"round": self.round, "kind": self.kind,
                "level": self.level,
                "value": None if math.isnan(v) or math.isinf(v)
                else float(v),
                "message": self.message}


@dataclass
class HealthMonitor:
    loss_z: float = 4.0
    ratio_rtol: float = 0.25
    drop_rate_max: float = 0.5
    warmup: int = 5
    halt_on_fatal: bool = False

    alerts: List[Alert] = field(default_factory=list)
    rounds_observed: int = 0
    # Welford accumulators for the current stage's loss distribution
    _n: int = field(default=0, repr=False)
    _mean: float = field(default=0.0, repr=False)
    _m2: float = field(default=0.0, repr=False)
    _ref_ratio: Optional[float] = field(default=None, repr=False)
    _drops: int = field(default=0, repr=False)
    _contacted: int = field(default=0, repr=False)

    @property
    def fatal(self) -> bool:
        return any(a.level == "fatal" for a in self.alerts)

    @property
    def should_halt(self) -> bool:
        return self.halt_on_fatal and self.fatal

    def _alert(self, out, round_idx, kind, level, value, message):
        a = Alert(round=round_idx, kind=kind, level=level,
                  value=float(value), message=message)
        self.alerts.append(a)
        out.append(a)

    def observe_round(self, round_idx: int, *, loss: float,
                      compression_ratio: Optional[float] = None,
                      dropped: int = 0, participants: int = 0,
                      recompiles: int = 0,
                      new_stage: bool = False) -> List[Alert]:
        """Feed one round's signals; returns the alerts *this* round
        raised (all alerts accumulate on ``self.alerts``)."""
        out: List[Alert] = []
        self.rounds_observed += 1
        if new_stage:
            self._n, self._mean, self._m2 = 0, 0.0, 0.0
            self._ref_ratio = None

        loss = float(loss)
        if math.isnan(loss) or math.isinf(loss):
            self._alert(out, round_idx, "loss_nonfinite", "fatal", loss,
                        f"round loss is {loss!r}")
        else:
            if self._n >= max(2, self.warmup):
                std = math.sqrt(self._m2 / (self._n - 1))
                if std > 0.0:
                    z = abs(loss - self._mean) / std
                    if z > self.loss_z:
                        self._alert(
                            out, round_idx, "loss_spike", "warn", z,
                            f"loss {loss:.4g} is {z:.1f} sigma from the "
                            f"stage mean {self._mean:.4g}")
            self._n += 1
            d = loss - self._mean
            self._mean += d / self._n
            self._m2 += d * (loss - self._mean)

        if compression_ratio is not None \
                and math.isfinite(compression_ratio):
            if self._ref_ratio is None:
                self._ref_ratio = float(compression_ratio)
            else:
                rel = abs(compression_ratio / self._ref_ratio - 1.0)
                if rel > self.ratio_rtol:
                    self._alert(
                        out, round_idx, "compression_drift", "warn", rel,
                        f"compression ratio {compression_ratio:.3g} "
                        f"drifted {rel:.0%} from the stage reference "
                        f"{self._ref_ratio:.3g}")

        self._drops += int(dropped)
        self._contacted += int(participants) + int(dropped)
        if self.rounds_observed > self.warmup and self._contacted > 0:
            rate = self._drops / self._contacted
            if rate > self.drop_rate_max:
                self._alert(
                    out, round_idx, "drop_rate", "warn", rate,
                    f"cumulative straggler drop rate {rate:.0%} exceeds "
                    f"{self.drop_rate_max:.0%}")

        if recompiles > 0 and not new_stage:
            self._alert(
                out, round_idx, "recompile_storm", "warn",
                float(recompiles),
                f"{recompiles} jit recompile(s) on a round with no stage "
                f"transition")
        return out

    def report(self) -> dict:
        counts = {k: 0 for k in ALERT_KINDS}
        for a in self.alerts:
            counts[a.kind] = counts.get(a.kind, 0) + 1
        return {
            "version": HEALTH_VERSION,
            "rounds_observed": self.rounds_observed,
            "fatal": self.fatal,
            "halted": self.should_halt,
            "counts": counts,
            "alerts": [a.to_dict() for a in self.alerts],
            "config": {"loss_z": self.loss_z,
                       "ratio_rtol": self.ratio_rtol,
                       "drop_rate_max": self.drop_rate_max,
                       "warmup": self.warmup,
                       "halt_on_fatal": self.halt_on_fatal},
        }


def write_health_json(path, monitor: HealthMonitor, **meta) -> dict:
    """Serialize ``monitor.report()`` (+ caller metadata) to ``path``.
    Returns the written document."""
    doc = monitor.report()
    if meta:
        doc["meta"] = {k: v for k, v in sorted(meta.items())}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc
