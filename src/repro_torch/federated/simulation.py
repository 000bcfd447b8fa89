"""Round clock + pluggable round policies for the device-fleet simulator
(``repro.federated.simulation``).

``repro.federated.fleet`` says *what hardware* each client has; this module
says *what time it costs* and *what the server does about it*. The round
clock prices one client's round as

  download_s   wire download bytes / device downlink bandwidth
  compute_s    max(FLOPs / device FLOP/s, HBM bytes / device mem-BW) —
               the two-term roofline, with FLOPs from the useful-work
               model in ``repro_torch.roofline.analysis`` scaled to the round
               plan's sub-model and active suffix
  upload_s     wire upload bytes / device uplink bandwidth
  energy_j     FLOPs x J/FLOP + wire bytes x J/byte (device coefficients)

and a round policy turns per-client costs into scheduling decisions:

  synchronous     today's behavior — the server waits for every sampled
                  (available) client; round wall-clock is the slowest
                  participant.
  deadline        overcommit the sample (``overcommit`` x clients/round,
                  clamped to the population), drop clients that would
                  finish past the deadline, FedAvg the survivors. The
                  deadline is fixed (``deadline_s``) or adaptive (the
                  ``quantile`` of the cohort's predicted finish times).
                  Dropped-but-started clients still burn device-seconds
                  and energy up to the deadline.
  buffered-async  FedBuff-style: launched clients keep training across
                  round boundaries; the server aggregates as soon as
                  ``buffer`` updates have arrived, weighting each update
                  by its sample count times a polynomial staleness
                  discount ``(1 + staleness)^-alpha``, normalized.
                  Cross-stage stale updates are discarded at stage
                  transitions (the payload layout changes under them).

All scheduling state lives on the host in numpy (fleet draws, availability
draws, the clock), so decisions are identical across the sequential and
vmap engines, fully determined by the seed, and the same as the
reference's for the same cohorts and wire bytes. The training computation
itself still runs through the engines/transport unchanged — with the
synchronous policy and a uniform fleet the driver's numerics are
bit-identical to running without a simulator. The buffered-async flush
averages the held client trees on the device they live on (torch in
place of the reference's ``jnp``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.federated import aggregate
from repro_torch.federated.fleet import Fleet, make_fleet
from repro_torch.obs import NOOP_OBS
from repro_torch.roofline import analysis

POLICIES = ("synchronous", "deadline", "buffered-async")


# ---------------------------------------------------------------------------
# round clock
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ClientRoundCost:
    download_s: float
    compute_s: float
    upload_s: float
    energy_j: float

    @property
    def total_s(self) -> float:
        return self.download_s + self.compute_s + self.upload_s


def plan_step_flops(model_cfg, plan, *, batch: int, tokens: int,
                    num_stages: int) -> float:
    """FLOPs one client spends on one local step under ``plan``.

    Priced with the roofline useful-work model: ``analysis.model_flops``
    gives 6·N·D (2 forward + 4 backward) for the stage-s sub-model; the
    layer-wise schedules run the full forward but backprop only through
    the active suffix, and representation alignment adds one extra
    forward through the global model.
    """
    layers = max(1, round(model_cfg.num_layers * plan.sub_layers
                          / max(1, num_stages)))
    sub_cfg = dataclasses.replace(model_cfg, num_layers=layers)
    shape = ShapeConfig("sim", seq_len=tokens, global_batch=batch,
                        kind="train")
    full = analysis.model_flops(sub_cfg, shape, "train")        # 6 N D
    bwd_frac = (plan.sub_layers - plan.active_from) / max(1, plan.sub_layers)
    mult = (2.0 + 4.0 * bwd_frac + (2.0 if plan.align else 0.0)) / 6.0
    return full * mult


def plan_step_bytes(model_cfg, plan, *, num_stages: int) -> float:
    """HBM-traffic proxy per local step: three fp32 passes over the
    sub-model's parameters (read params, read grads/opt state, write)."""
    layers = max(1, round(model_cfg.num_layers * plan.sub_layers
                          / max(1, num_stages)))
    sub_cfg = dataclasses.replace(model_cfg, num_layers=layers)
    return 3.0 * 4.0 * sub_cfg.param_count()


def price_client_round(dev, *, steps: int, step_flops: float,
                       step_bytes: float, down_bytes: int,
                       up_bytes: int) -> ClientRoundCost:
    """Two-term roofline compute time + link-bound comm time + energy."""
    flops = steps * step_flops
    compute_s = max(flops / dev.flops, steps * step_bytes / dev.mem_bw)
    down_s = down_bytes / dev.down_bw
    up_s = up_bytes / dev.up_bw
    energy = flops * dev.j_per_flop + (down_bytes + up_bytes) * dev.j_per_byte
    return ClientRoundCost(down_s, compute_s, up_s, energy)


def staleness_weights(sample_counts: Sequence[int],
                      staleness: Sequence[int],
                      alpha: float = 0.5) -> np.ndarray:
    """FedBuff-style aggregation weights: sample count x polynomial
    staleness discount ``(1 + s)^-alpha``, normalized to sum to 1.
    Monotonically non-increasing in staleness at fixed sample count."""
    w = (np.asarray(sample_counts, np.float64)
         * (1.0 + np.asarray(staleness, np.float64)) ** (-alpha))
    return w / w.sum()


# ---------------------------------------------------------------------------
# round outcome record
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RoundOutcome:
    """Everything a policy decided for one round (host-side, deterministic
    given the seed — the determinism tests compare these across engines)."""
    round_idx: int
    cohort: Tuple[int, ...]        # sampled (possibly overcommitted) ids
    train_ids: Tuple[int, ...]     # clients that run local training now
    aggregated: Tuple[int, ...]    # ids whose updates enter aggregation
    staleness: Tuple[int, ...]     # per aggregated id, in rounds
    weights: Optional[Tuple[float, ...]]  # None => engine-standard FedAvg
    dropped: Tuple[int, ...]       # launched/sampled but not aggregated
    wall_clock_s: float
    device_seconds: float
    energy_j: float
    deadline_s: Optional[float]


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------
class SynchronousPolicy:
    """Today's behavior: every sampled available client trains and is
    aggregated; the server waits for the slowest one."""

    name = "synchronous"
    overcommit = 1.0
    needs_client_trees = False

    def begin_stage(self):
        pass

    def resolve(self, round_idx, cohort, costs, available):
        alive = [c for c in cohort if available[c]]
        if not alive:   # server re-polls until someone answers
            alive = [min(cohort, key=lambda c: costs[c].total_s)]
        times = [costs[c].total_s for c in alive]
        return RoundOutcome(
            round_idx=round_idx, cohort=tuple(cohort),
            train_ids=tuple(alive), aggregated=tuple(alive),
            staleness=(0,) * len(alive), weights=None,
            dropped=tuple(c for c in cohort if c not in alive),
            wall_clock_s=max(times),
            device_seconds=sum(times),
            energy_j=sum(costs[c].energy_j for c in alive),
            deadline_s=None)


class DeadlinePolicy:
    """Overcommit the sample, drop predicted stragglers past the deadline,
    FedAvg the survivors with plain (sample-count) weights."""

    name = "deadline"
    needs_client_trees = False

    def __init__(self, deadline_s: Optional[float] = None,
                 overcommit: float = 1.5, quantile: float = 0.6):
        if overcommit < 1.0:
            raise ValueError(f"overcommit must be >= 1: {overcommit}")
        if not (0.0 < quantile <= 1.0):
            raise ValueError(f"quantile must be in (0, 1]: {quantile}")
        self.deadline_s = deadline_s
        self.overcommit = float(overcommit)
        self.quantile = float(quantile)

    def begin_stage(self):
        pass

    def resolve(self, round_idx, cohort, costs, available):
        alive = [c for c in cohort if available[c]]
        if not alive:
            alive = [min(cohort, key=lambda c: costs[c].total_s)]
        times = {c: costs[c].total_s for c in alive}
        deadline = (self.deadline_s if self.deadline_s is not None
                    else float(np.quantile(list(times.values()),
                                           self.quantile)))
        survivors = [c for c in alive if times[c] <= deadline]
        if not survivors:
            survivors = [min(alive, key=times.get)]
        cut = [c for c in alive if c not in survivors]
        # survivors run to completion; cut clients burn device time and
        # energy until the deadline, then the server stops waiting
        dev_s = sum(times[c] for c in survivors) + sum(
            min(times[c], deadline) for c in cut)
        energy = sum(costs[c].energy_j for c in survivors) + sum(
            costs[c].energy_j * min(1.0, deadline / max(times[c], 1e-12))
            for c in cut)
        wall = deadline if cut else max(times[c] for c in survivors)
        return RoundOutcome(
            round_idx=round_idx, cohort=tuple(cohort),
            train_ids=tuple(survivors), aggregated=tuple(survivors),
            staleness=(0,) * len(survivors), weights=None,
            dropped=tuple(c for c in cohort if c not in survivors),
            wall_clock_s=wall, device_seconds=dev_s, energy_j=energy,
            deadline_s=deadline)


@dataclass
class _Pending:
    client_id: int
    origin_round: int
    arrival_s: float          # absolute simulated time of arrival
    samples: int
    cost: ClientRoundCost
    tree: object = None       # decoded update, attached after training


class BufferedAsyncPolicy:
    """FedBuff-style buffered asynchronous aggregation.

    Clients launched at round t keep running across round boundaries; the
    server aggregates whenever ``buffer`` updates have arrived, weighting
    each by sample count x ``(1 + staleness)^-alpha`` (normalized). Needs
    per-client update trees from the engine (``needs_client_trees``),
    because stale updates are held and averaged rounds after they were
    computed.
    """

    name = "buffered-async"
    overcommit = 1.0
    needs_client_trees = True

    def __init__(self, buffer: int = 0, alpha: float = 0.5):
        if alpha < 0.0:
            raise ValueError(f"staleness alpha must be >= 0: {alpha}")
        self.buffer = int(buffer)     # 0 => half the cohort, at least 1
        self.alpha = float(alpha)
        self._pending: List[_Pending] = []
        self._clock = 0.0
        self._flushed: List[int] = []

    def begin_stage(self):
        # stale updates have the previous stage's payload semantics —
        # discard them (counted as drops in the next round's outcome)
        self._flushed.extend(p.client_id for p in self._pending)
        self._pending = []

    def _buffer_size(self, cohort_size: int) -> int:
        return self.buffer if self.buffer > 0 else max(1, cohort_size // 2)

    def resolve(self, round_idx, cohort, costs, available):
        busy = {p.client_id for p in self._pending}
        candidates = [c for c in cohort if c not in busy]
        alive = [c for c in candidates if available[c]]
        n_new = max(0, len(cohort) - len(self._pending))
        launch = alive[:n_new]
        if not launch and not self._pending:
            launch = [min(cohort, key=lambda c: costs[c].total_s)]
        unavailable = [c for c in candidates[:n_new] if c not in alive]
        dropped = tuple(unavailable) + tuple(self._flushed)
        self._flushed = []
        # aggregation set / clock / weights are finalized in ``complete``;
        # device time and energy are accounted at launch
        return RoundOutcome(
            round_idx=round_idx, cohort=tuple(cohort),
            train_ids=tuple(launch), aggregated=(), staleness=(),
            weights=None, dropped=dropped,
            wall_clock_s=0.0,
            device_seconds=sum(costs[c].total_s for c in launch),
            energy_j=sum(costs[c].energy_j for c in launch),
            deadline_s=None)

    def complete(self, outcome: RoundOutcome, costs, counts, trees,
                 agg_fn=None):
        """Attach the newly trained update trees, pop the ``buffer``
        earliest arrivals, and return (aggregated model, final outcome).

        ``agg_fn(trees, weights, client_ids)`` replaces the plain FedAvg:
        secure aggregation masks over each flush's arrival set (survivor-
        set re-masking)."""
        for cid, tree in zip(outcome.train_ids, trees):
            self._pending.append(_Pending(
                cid, outcome.round_idx,
                self._clock + costs[cid].total_s, counts[cid],
                costs[cid], tree))
        self._pending.sort(key=lambda p: (p.arrival_s, p.client_id))
        k = min(self._buffer_size(len(outcome.cohort)), len(self._pending))
        arrived, self._pending = self._pending[:k], self._pending[k:]
        t0 = self._clock
        self._clock = max(self._clock, arrived[-1].arrival_s)
        stale = [outcome.round_idx - p.origin_round for p in arrived]
        w = staleness_weights([p.samples for p in arrived], stale,
                              self.alpha)
        if agg_fn is not None:
            new_online = agg_fn([p.tree for p in arrived],
                                tuple(float(x) for x in w),
                                tuple(p.client_id for p in arrived))
        else:
            new_online = aggregate.fedavg(
                [p.tree for p in arrived],
                torch.as_tensor(w, dtype=torch.float32))
        final = dataclasses.replace(
            outcome,
            aggregated=tuple(p.client_id for p in arrived),
            staleness=tuple(stale),
            weights=tuple(float(x) for x in w),
            wall_clock_s=self._clock - t0)
        return new_online, final


def make_policy(name: str, **kw):
    """Policy registry. kwargs: deadline => deadline_s / overcommit /
    quantile; buffered-async => buffer / alpha."""
    if name == "synchronous":
        if kw:
            raise ValueError(f"synchronous policy takes no options: {kw}")
        return SynchronousPolicy()
    if name == "deadline":
        return DeadlinePolicy(**kw)
    if name == "buffered-async":
        return BufferedAsyncPolicy(**kw)
    raise ValueError(f"unknown round policy '{name}'; one of {POLICIES}")


# ---------------------------------------------------------------------------
# simulation orchestrator (the driver's single point of contact)
# ---------------------------------------------------------------------------
class Simulation:
    """Binds a fleet to a round policy and owns the host-side randomness
    (availability draws) and the per-round outcome log."""

    def __init__(self, fleet: Fleet, policy, *, seed: int = 0, obs=None):
        self.fleet = fleet
        self.policy = policy
        # availability stream is independent of the training draws: the
        # simulator never consumes the main loop's random numbers
        self._avail_rng = np.random.default_rng([seed, 0x5EED])
        self.records: List[RoundOutcome] = []
        self._prepared = False
        # observability: policy decisions become instant events; each
        # trained client's simulated round becomes a span on its own
        # virtual track, laid out on the cumulative simulated clock —
        # a fleet round reads like a real profile in Perfetto
        self.obs = obs if obs is not None else NOOP_OBS
        self._vclock = 0.0

    @property
    def overcommit(self) -> float:
        return self.policy.overcommit

    def prepare(self, model_cfg, *, num_stages: int, counts: Sequence[int],
                batch: int, tokens: int, local_epochs: int):
        """Called once per run with the workload's pricing inputs."""
        if len(counts) != len(self.fleet):
            raise ValueError(
                f"fleet has {len(self.fleet)} devices but the run has "
                f"{len(counts)} clients — build the fleet with "
                f"make_fleet(profile, num_clients, seed)")
        self.model_cfg = model_cfg
        self.num_stages = num_stages
        self.counts = list(counts)
        self.batch = batch
        self.tokens = tokens
        self.steps = [local_epochs * (n // batch) for n in counts]
        self._prepared = True

    def begin_stage(self):
        self.policy.begin_stage()

    def round_costs(self, plan, cohort, *, down_bytes: int,
                    up_bytes: int) -> Dict[int, ClientRoundCost]:
        step_f = plan_step_flops(self.model_cfg, plan, batch=self.batch,
                                 tokens=self.tokens,
                                 num_stages=self.num_stages)
        step_b = plan_step_bytes(self.model_cfg, plan,
                                 num_stages=self.num_stages)
        return {c: price_client_round(
            self.fleet[c], steps=self.steps[c], step_flops=step_f,
            step_bytes=step_b, down_bytes=down_bytes, up_bytes=up_bytes)
            for c in cohort}

    def begin_round(self, plan, cohort, *, down_bytes: int,
                    up_bytes: int) -> RoundOutcome:
        """Price the cohort, draw availability, let the policy schedule.
        Returns the (possibly provisional, for async) round outcome; the
        driver trains ``outcome.train_ids``."""
        assert self._prepared, "call prepare() before begin_round()"
        self._costs = self.round_costs(plan, cohort, down_bytes=down_bytes,
                                       up_bytes=up_bytes)
        draws = self._avail_rng.random(len(cohort))
        available = {c: bool(draws[i] < self.fleet[c].availability)
                     for i, c in enumerate(cohort)}
        outcome = self.policy.resolve(len(self.records), cohort,
                                      self._costs, available)
        self.obs.tracer.instant(
            f"policy.{self.policy.name}", cat="sim",
            round=outcome.round_idx, cohort=list(outcome.cohort),
            train=list(outcome.train_ids), dropped=list(outcome.dropped),
            deadline_s=outcome.deadline_s)
        return outcome

    def _emit_round_spans(self, outcome: RoundOutcome):
        """Per-client simulated-round spans on the virtual timeline (one
        track per client, timestamps in cumulative simulated seconds)."""
        tracer = self.obs.tracer
        for cid in outcome.train_ids:
            cost = self._costs[cid]
            dur = cost.total_s
            if outcome.deadline_s is not None:
                dur = min(dur, outcome.deadline_s)
            tracer.virtual_span(
                f"client {cid} round {outcome.round_idx}",
                f"sim client {cid}", self._vclock, dur,
                client=cid, round=outcome.round_idx,
                download_s=cost.download_s, compute_s=cost.compute_s,
                upload_s=cost.upload_s, energy_j=cost.energy_j)
        self._vclock += outcome.wall_clock_s

    def complete_round(self, outcome: RoundOutcome) -> RoundOutcome:
        """Synchronous/deadline: the provisional outcome is final."""
        self.records.append(outcome)
        self._emit_round_spans(outcome)
        return outcome

    def complete_round_async(self, outcome: RoundOutcome, trees,
                             agg_fn=None) -> Tuple[object, RoundOutcome]:
        """Buffered-async: hand the per-client decoded trees to the
        policy's buffer; returns (aggregated online tree, final outcome).
        ``agg_fn`` (optional) replaces the buffer's FedAvg: the secure-
        aggregation hook."""
        new_online, final = self.policy.complete(outcome, self._costs,
                                                 self.counts, trees,
                                                 agg_fn=agg_fn)
        self.records.append(final)
        self._emit_round_spans(final)
        return new_online, final


def make_sim(fleet, policy="synchronous", *, num_clients: int,
             seed: int = 0, **policy_kw) -> Simulation:
    """Convenience constructor: fleet/policy by name or instance.

    ``make_sim("pareto-stragglers", "deadline", num_clients=32, seed=0,
    overcommit=1.5)``
    """
    if isinstance(fleet, str):
        fleet = make_fleet(fleet, num_clients, seed)
    if isinstance(policy, str):
        policy = make_policy(policy, **policy_kw)
    elif policy_kw:
        raise ValueError("policy_kw only applies when policy is a name")
    return Simulation(fleet, policy, seed=seed)
