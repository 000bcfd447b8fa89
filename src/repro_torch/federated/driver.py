"""End-to-end federated SSL driver (paper Algorithms 1 + 2;
``repro.federated.driver``).

Simulates the FL process on one device: per-round client sampling, local
MoCo v3 training under the stage schedule, FedAvg over the wire transport
and its codec, server-side calibration and communication accounting.
``run_lm_fedssl`` is the LM family's loop (``train_lm`` of
``repro.launch.train``): layer-wise FedSSL on token shards with
next-token SSL and alignment, every client in every round, on either
engine.
``FLHistory`` is the reference's, with the same versioned ``to_dict``, so
two histories compare field by field.

Privacy (``privacy=``, a ``repro_torch.privacy.PrivacyConfig`` or
``PrivacyEngine``; off by default), as in the reference: the transport
clips every upload, the server adds calibrated Gaussian noise to the
aggregate, the accountant composes the rounds into ``FLHistory.epsilon``
(a run halts once it exceeds ``epsilon_budget``), and with ``secure_agg``
FedAvg runs as the pairwise-masked fixed-point sum: over the engines'
decoded per-client trees in a synchronous or deadline round, and over each
buffer flush (the simulator's ``agg_fn``) under the buffered-async
policy. The noise and the mask seeds come from the draws object's privacy
stream, so the cohorts and batches are a run's without privacy; clip =
inf with z = 0 trains bit-identically to ``privacy=None``.

Fleet simulation (``sim=``, ``repro_torch.federated.simulation``; off by
default): the reference's round clock and round policies. The simulator
prices the round's cohort (overcommitted for the deadline policy), draws
availability and picks who trains; the engines train those clients, and
the buffered-async policy gets each client's decoded tree
(``collect=True``) and aggregates its arrivals staleness-weighted.
``FLHistory`` then carries the simulated wall clock, device-seconds,
energy, drops and participants of every round. With the synchronous
policy over a uniform fleet training is bit-identical to ``sim=None``.

Observability (``obs=``, ``repro_torch.obs``; ``NOOP_OBS`` by default) as
in the reference: the spans ``run > round > {stage_transition, download,
local_train, calibrate}`` (and the port's own inside them, as
``repro_torch.obs.trace`` draws the tree: ``calibrate.step`` and the
steps' phases) with the round's bytes, loss and rate on its
``round`` span, the counters ``fl.rounds``, ``comm.*_bytes`` and
``wire.*_bytes``, the histograms ``round.loss`` and ``round.host_seconds``
and the gauge ``wire.compression_ratio`` (and with a simulator the
``sim.*`` metrics), the live memory watermark (``mem.*``,
``repro_torch.obs.resources``) on every round span when anything
records, the health monitor's ``health.*``
instants (with ``halt_on_fatal``, the run stops after the round that
raised a fatal alert) and the profiler around the rounds. The reference's
``jit.recompiles`` and ``jit.cache_entries`` count XLA programs, which the
port does not have; its health monitor is fed ``recompiles=0``. Tracing
reads each client's loss inside its span, as the reference does; with
everything off nothing is added on the card. With
``obs.measure_resources`` the first local step of every stage runs under
a FLOP counter and its count goes on the stage-opening round span
(``res.*``, recorded under a ``resources.measure`` span after the round's
training; the reference lowers the step before it and records there).
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from repro_torch.convert import subtree, to_tensor
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as ssl_mod
from repro_torch.data.partition import stack_shards
from repro_torch.federated import aggregate, comm, server
from repro_torch.federated.client import lm_step_leaves, lm_train_step
from repro_torch.federated.draws import TorchDraws
from repro_torch.federated.engine import ENGINES, make_engine
from repro_torch.federated.transport import Transport
from repro_torch.launch.steps import ALIGN_WEIGHT, make_fl_round_program
from repro_torch.models import lm as lm_mod
from repro_torch.obs import NOOP_OBS, format_round_line
from repro_torch.obs import resources as obs_resources
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import learning_rate, scaled_base_lr
from repro_torch.privacy import make_privacy

# the reference's wire engines; the port has one wire path for both
TRANSPORT_KERNELS = ("xla", "pallas")

HISTORY_VERSION = 2
_COMPAT_VERSIONS = (1, 2)


@dataclass
class FLHistory:
    loss: List[float] = field(default_factory=list)
    round_stage: List[int] = field(default_factory=list)
    # analytic per-client byte counts (leaf shapes x round plan, comm.py)
    download_bytes: List[int] = field(default_factory=list)
    upload_bytes: List[int] = field(default_factory=list)
    # measured per-client wire bytes
    wire_download_bytes: List[int] = field(default_factory=list)
    wire_upload_bytes: List[int] = field(default_factory=list)
    # fleet-simulator accounting (populated only when a Simulation is
    # passed to run_fedssl; empty lists otherwise)
    round_wall_clock: List[float] = field(default_factory=list)
    device_seconds: List[float] = field(default_factory=list)
    energy_joules: List[float] = field(default_factory=list)
    dropped_clients: List[int] = field(default_factory=list)
    participants: List[tuple] = field(default_factory=list)
    # privacy accounting (populated only when privacy is on)
    epsilon: List[float] = field(default_factory=list)
    clip_fraction: List[float] = field(default_factory=list)
    secure_agg_overhead_bytes: List[int] = field(default_factory=list)

    @property
    def total_comm(self) -> int:
        return sum(self.download_bytes) + sum(self.upload_bytes)

    @property
    def total_wire(self) -> int:
        return sum(self.wire_download_bytes) + sum(self.wire_upload_bytes)

    @property
    def compression_ratio(self) -> float:
        """Analytic over wire bytes; NaN before anything was sent."""
        if self.total_wire == 0:
            return float("nan")
        return self.total_comm / self.total_wire

    @property
    def total_wall_clock(self) -> float:
        return sum(self.round_wall_clock)

    @property
    def total_device_seconds(self) -> float:
        return sum(self.device_seconds)

    @property
    def total_energy(self) -> float:
        return sum(self.energy_joules)

    @property
    def total_dropped(self) -> int:
        return sum(self.dropped_clients)

    def wall_clock_to_loss(self, target: float):
        """Cumulative simulated seconds until the round-mean loss first
        reaches ``target``; None if it never does (or no simulation ran)."""
        t = 0.0
        for wall, loss in zip(self.round_wall_clock, self.loss):
            t += wall
            if loss <= target:
                return t
        return None

    def to_dict(self) -> Dict[str, Any]:
        fields: Dict[str, list] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            fields[f.name] = ([list(t) for t in v]
                              if f.name == "participants" else list(v))
        return {"version": HISTORY_VERSION, "fields": fields}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FLHistory":
        if d.get("version") not in _COMPAT_VERSIONS:
            raise ValueError(f"unsupported FLHistory version "
                             f"{d.get('version')!r} (have {_COMPAT_VERSIONS})")
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for name, vals in d.get("fields", {}).items():
            if name not in known:
                raise ValueError(f"unknown FLHistory field '{name}'")
            kw[name] = ([tuple(v) for v in vals]
                        if name == "participants" else list(vals))
        return cls(**kw)


def resolve_device(device) -> torch.device:
    """The run's device; asking for the card without one raises rather
    than carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA GPU by default and "
                           "none is available; pass device='cpu' (or "
                           "--device cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{device}'")
    return device


def run_fedssl(model_cfg, ssl_cfg, fl, train_cfg, *, images, client_indices,
               aux_images=None, draws=None, encoder=None,
               image_size: int = 32, log=None, device="cuda",
               engine: str = "sequential", codec: str = "fp32",
               transport_kernels: str = "xla", sim=None, obs=None,
               privacy=None):
    """Run the FL process; returns (final state, FLHistory).

    images: (n, H, W, 3) training pool; client_indices: one index array
    per client; aux_images: D_g for server calibration; draws: the source
    of every random draw (default ``TorchDraws(fl.seed, device)``). Tensors
    are moved to ``device``, which defaults to the card. engine: the round
    engine (``engine.ENGINES``: ``sequential``, or ``vmap``, which trains
    the round's participants together, one batched step at a time;
    it needs every shard to hold a batch). codec: the wire
    compression (``transport.CODECS``: fp32, fp16, bf16, int8,
    topk[:fraction]); transport_kernels: the reference's wire-engine name
    (``xla`` or ``pallas``), accepted so that its calls carry over: both
    select the port's one wire path, the kernels on the card and their
    plain versions on the CPU. obs: an ``repro_torch.obs.Observability``
    (spans, metrics, health, profiler); the default records nothing, and
    tracing never changes what is trained. privacy: a
    ``repro_torch.privacy.PrivacyConfig`` (or ``PrivacyEngine``): DP
    clipping and noise, RDP accounting into ``FLHistory.epsilon`` and
    secure aggregation, as the module says.
    """
    if transport_kernels not in TRANSPORT_KERNELS:
        raise ValueError(f"unknown transport kernels '{transport_kernels}'; "
                         f"one of {TRANSPORT_KERNELS}")
    device = resolve_device(device)
    draws = draws if draws is not None else TorchDraws(fl.seed, device)
    if encoder is None:
        encoder = ssl_mod.make_vit_encoder(model_cfg, image_size)
    images = to_tensor(images, device)
    client_indices = [to_tensor(ix, device, torch.int64)
                      for ix in client_indices]
    if aux_images is not None:
        aux_images = to_tensor(aux_images, device)
    state = draws.init_state(encoder, ssl_cfg)
    opt = make_optimizer(train_cfg)
    plans = sched.build_schedule(fl, encoder.num_stages)
    base_lr = scaled_base_lr(train_cfg.base_lr, train_cfg.batch_size)
    hist = FLHistory()
    obs = obs if obs is not None else NOOP_OBS
    tracer, met = obs.tracer, obs.metrics
    prv = make_privacy(privacy)
    secure = prv is not None and prv.cfg.secure_agg
    wire = Transport(codec, include_heads=fl.include_heads,
                     kernels=transport_kernels, obs=obs, privacy=prv)
    eng = make_engine(engine, encoder=encoder, ssl_cfg=ssl_cfg, opt=opt,
                      fl=fl, images=images, client_indices=client_indices,
                      transport=wire, draws=draws,
                      batch_size=train_cfg.batch_size, obs=obs)

    if sim is not None:
        sim.obs = obs
        # ViT patch grid prices the per-step FLOPs (4x4 patches)
        sim.prepare(model_cfg, num_stages=encoder.num_stages,
                    counts=eng.counts,
                    batch=train_cfg.batch_size,
                    tokens=(image_size // 4) ** 2,
                    local_epochs=fl.local_epochs)

    # stage-relative step counters for the cyclic LR strategy
    stage_start: Dict[int, int] = {}
    for p in plans:
        stage_start.setdefault(p.stage, p.round_idx)
    stage_lengths = {s: sum(1 for p in plans if p.stage == s)
                     for s in stage_start}

    obs.start_profiler()
    try:
        with tracer.span("run", cat="fl", mode="fedssl",
                         schedule=fl.schedule, engine=engine,
                         codec=wire.codec.name, kernels=transport_kernels,
                         rounds=fl.rounds, clients=fl.num_clients,
                         sim=sim.policy.name if sim else None):
            for plan in plans:
                host_t0 = time.perf_counter()
                round_span = tracer.span("round", cat="fl",
                                         round=plan.round_idx,
                                         stage=plan.stage)
                with round_span:
                    probe = None
                    if plan.new_stage:
                        tracer.instant("stage_transition", cat="fl",
                                       stage=plan.stage)
                        if sim is not None:
                            sim.begin_stage()
                        state = server.begin_stage(
                            state, plan.stage,
                            weight_transfer=fl.weight_transfer)
                        if obs.measure_resources:
                            probe = obs_resources.StepProbe()
                    lr = learning_rate(
                        plan.round_idx, fl.rounds, base_lr,
                        train_cfg.lr_schedule,
                        stage_step=plan.round_idx - stage_start[plan.stage],
                        stage_total=stage_lengths[plan.stage],
                        warmup_steps=train_cfg.warmup_steps)
                    # with the default overcommit (1.0) this draws the
                    # cohort it always drew
                    cohort = server.sample_clients(
                        draws, fl.num_clients, fl.clients_per_round,
                        overcommit=sim.overcommit if sim is not None
                        else 1.0)
                    # clients (and the alignment loss's global model) see
                    # the wire-decoded broadcast, not the server's tree
                    with tracer.span("download", cat="fl"):
                        dstate, down = server.broadcast_download(state, plan,
                                                                 wire)
                    global_enc = (subtree(dstate["online"], "enc")
                                  if plan.align else None)
                    outcome = None
                    participants = cohort
                    up_spec = wire.plan_specs(state["online"],
                                              plan)["upload"]
                    if sim is not None:
                        outcome = sim.begin_round(
                            plan, cohort, down_bytes=down["wire_bytes"],
                            up_bytes=wire.wire_bytes(up_spec))
                        participants = list(outcome.train_ids)
                    batch_plans = [draws.batch_plan(
                        eng.counts[i], fl.local_epochs,
                        train_cfg.batch_size) for i in participants]
                    train_span = tracer.span("local_train", cat="fl",
                                             participants=len(participants))
                    if sim is not None and sim.policy.needs_client_trees:
                        # buffered-async: the engine returns each client's
                        # decoded tree; the policy buffers them and
                        # aggregates arrivals staleness-weighted, possibly
                        # rounds after they trained. Secure aggregation
                        # masks each flush's arrival set (agg_fn)
                        with train_span:
                            if participants:
                                trees, losses, up = eng.run_round(
                                    dstate, plan, participants, batch_plans,
                                    lr, global_enc,
                                    server_online=state["online"],
                                    collect=True, probe=probe)
                            else:  # every sampled client busy or offline
                                trees, losses = [], []
                                up = wire.stats(up_spec)
                        new_online, outcome = sim.complete_round_async(
                            outcome, trees,
                            agg_fn=prv.make_secure_agg_fn(
                                up_spec, state["online"],
                                draws.mask_seed(plan.round_idx))
                            if secure else None)
                    elif secure:
                        # synchronous or deadline: the decoded per-client
                        # trees through the masked fixed-point sum in
                        # place of the engine's float FedAvg
                        with train_span:
                            trees, losses, up = eng.run_round(
                                dstate, plan, participants, batch_plans, lr,
                                global_enc, server_online=state["online"],
                                collect=True, probe=probe)
                        w = aggregate.client_weights(
                            [eng.counts[i] for i in participants])
                        new_online = prv.secure_fedavg(
                            trees, w.tolist(), participants, spec=up_spec,
                            base=state["online"],
                            seed=draws.mask_seed(plan.round_idx))
                        del trees
                        if sim is not None:
                            outcome = sim.complete_round(outcome)
                    else:
                        with train_span:
                            new_online, losses, up = eng.run_round(
                                dstate, plan, participants, batch_plans, lr,
                                global_enc, server_online=state["online"],
                                probe=probe)
                        if sim is not None:
                            outcome = sim.complete_round(outcome)
                    if probe is not None and probe.flops is not None:
                        with tracer.span("resources.measure", cat="obs",
                                         stage=plan.stage):
                            round_span.set(
                                **obs_resources.stage_cost_attrs(probe))
                    if prv is not None and prv.noise_enabled:
                        new_online = prv.add_noise(
                            new_online, up_spec, draws, plan.round_idx,
                            prv.sigma(_max_weight(outcome, participants,
                                                  eng.counts)))
                    state = {**state, "online": new_online}
                    if plan.server_calibrate and aux_images is not None:
                        state = server.server_calibrate(
                            state, aux_images, draws, opt, encoder=encoder,
                            ssl_cfg=ssl_cfg, sub_layers=plan.sub_layers,
                            epochs=fl.server_epochs,
                            batch_size=train_cfg.batch_size, lr=lr,
                            tracer=tracer)
                    cb = comm.round_comm_bytes(
                        state["online"], plan,
                        include_heads=fl.include_heads)
                    if losses:
                        hist.loss.append(sum(losses) / len(losses))
                    else:  # async round with no launches: carry the loss
                        hist.loss.append(hist.loss[-1] if hist.loss
                                         else float("nan"))
                    hist.round_stage.append(plan.stage)
                    hist.download_bytes.append(cb["download"])
                    hist.upload_bytes.append(cb["upload"])
                    hist.wire_download_bytes.append(down["wire_bytes"])
                    hist.wire_upload_bytes.append(up["wire_bytes"])
                    sim_log = ""
                    dropped = 0
                    if outcome is not None:
                        dropped = len(outcome.dropped)
                        hist.round_wall_clock.append(outcome.wall_clock_s)
                        hist.device_seconds.append(outcome.device_seconds)
                        hist.energy_joules.append(outcome.energy_j)
                        hist.dropped_clients.append(dropped)
                        hist.participants.append(tuple(participants))
                        sim_log = (f" sim {outcome.wall_clock_s:.1f}s "
                                   f"dropped {dropped}")
                    eps = None
                    if prv is not None:
                        # the sampled cohort, not the survivors: dropped
                        # clients were still contacted
                        eps = _account_round(prv, hist, len(cohort)
                                             / max(1, fl.num_clients),
                                             up, up_spec, wire)
                        if prv.dp:
                            sim_log += f" eps {eps:.3g}"
                    round_span.set(
                        loss=hist.loss[-1], lr=lr,
                        download_bytes=cb["download"],
                        upload_bytes=cb["upload"],
                        wire_download_bytes=down["wire_bytes"],
                        wire_upload_bytes=up["wire_bytes"],
                        participants=len(participants), dropped=dropped)
                    if obs.enabled:
                        # live watermark (mem.* attrs are excluded from
                        # Tracer.structure(): environment, not structure)
                        round_span.set(
                            **obs_resources.memory_span_attrs(device))
                    if prv is not None:
                        _privacy_span_attrs(round_span, hist)
                if obs.enabled:
                    _round_metrics(met, cb, down, up, hist.loss[-1],
                                   host_t0)
                    if outcome is not None:
                        met.histogram("sim.round_wall_clock_s").observe(
                            outcome.wall_clock_s)
                        met.counter("sim.energy_j").inc(outcome.energy_j)
                        met.counter("sim.dropped_clients").inc(dropped)
                    if prv is not None:
                        met.gauge("privacy.epsilon").set(eps)
                        met.histogram("privacy.clip_fraction").observe(
                            hist.clip_fraction[-1])
                        met.counter("privacy.secure_agg_overhead_bytes").inc(
                            hist.secure_agg_overhead_bytes[-1])
                if log:
                    log(format_round_line(
                        plan.round_idx, fl.rounds, plan.stage, hist.loss[-1],
                        lr=lr, down_mb=cb["download"] / 1e6,
                        up_mb=cb["upload"] / 1e6,
                        wire_mb=(down["wire_bytes"] + up["wire_bytes"])
                        / 1e6, extra=sim_log))
                if _observe_health(obs, plan, fl.rounds, hist.loss[-1], cb,
                                   down, up, len(participants), log,
                                   value=True, dropped=dropped):
                    break
                if _budget_exhausted(prv, eps, plan, fl.rounds, log):
                    tracer.instant("privacy.budget_exhausted", cat="fl",
                                   round=plan.round_idx, epsilon=eps,
                                   budget=prv.cfg.epsilon_budget)
                    break
        if obs.enabled:
            met.gauge("wire.compression_ratio").set(hist.compression_ratio)
    finally:
        obs.stop_profiler()
    return state, hist


def _max_weight(outcome, participants, counts) -> float:
    """The largest FedAvg weight of the round's aggregate: the async
    policy's staleness weights, else the sample-count weights of the
    clients aggregated (fp32, as ``aggregate.client_weights`` gives)."""
    if outcome is not None and outcome.weights:
        return max(outcome.weights)
    ids = list(outcome.aggregated) if outcome is not None else participants
    return float(aggregate.client_weights([counts[i] for i in ids]).max())


def _account_round(prv, hist, q: float, up, spec, wire) -> float:
    """Account one round at sampling fraction ``q`` and append the
    round's ``epsilon``, ``clip_fraction`` and secure-aggregation overhead
    to ``hist``; returns epsilon."""
    prv.accountant.observe_round(q)
    eps = float(prv.accountant.epsilon(prv.cfg.delta))
    hist.epsilon.append(eps)
    hist.clip_fraction.append(float(up.get("clip_fraction", 0.0)))
    hist.secure_agg_overhead_bytes.append(
        prv.secure_overhead_bytes(spec, wire.wire_bytes(spec)))
    return eps


def _privacy_span_attrs(round_span, hist) -> None:
    round_span.set(epsilon=hist.epsilon[-1],
                   clip_fraction=hist.clip_fraction[-1],
                   secure_agg_overhead_bytes=hist
                   .secure_agg_overhead_bytes[-1])


def _budget_exhausted(prv, eps, plan, rounds: int, log) -> bool:
    """True (and logged) once epsilon exceeds the run's budget."""
    if prv is None or prv.cfg.epsilon_budget <= 0.0 \
            or eps <= prv.cfg.epsilon_budget:
        return False
    if log:
        log(f"privacy budget exhausted: eps {eps:.4g} > "
            f"{prv.cfg.epsilon_budget:.4g} after round "
            f"{plan.round_idx + 1}/{rounds}; halting")
    return True


def _round_metrics(met, cb, down, up, loss: float, host_t0: float) -> None:
    """The reference's per-round counters and histograms."""
    met.counter("fl.rounds").inc()
    met.counter("comm.download_bytes").inc(cb["download"])
    met.counter("comm.upload_bytes").inc(cb["upload"])
    met.counter("wire.download_bytes").inc(down["wire_bytes"])
    met.counter("wire.upload_bytes").inc(up["wire_bytes"])
    met.histogram("round.host_seconds").observe(time.perf_counter()
                                                - host_t0)
    met.histogram("round.loss").observe(loss)


def _observe_health(obs, plan, rounds: int, loss: float, cb, down, up,
                    participants: int, log, *, value: bool,
                    dropped: int = 0) -> bool:
    """Feed the round to the health monitor, record its alerts as
    ``health.*`` instants (``value``: with the alert's value, as the
    reference's vit driver records it and its LM loop does not); True when
    the run must halt."""
    if obs.health is None:
        return False
    tracer = obs.tracer
    ratio = ((cb["download"] + cb["upload"])
             / max(1, down["wire_bytes"] + up["wire_bytes"]))
    for alert in obs.health.observe_round(
            plan.round_idx, loss=loss, compression_ratio=ratio,
            dropped=dropped, participants=participants, recompiles=0,
            new_stage=plan.new_stage):
        attrs = {"level": alert.level, "round": plan.round_idx}
        if value:
            attrs["value"] = (float(alert.value)
                              if math.isfinite(alert.value) else None)
        attrs["message"] = alert.message
        tracer.instant("health." + alert.kind, cat="health", **attrs)
        if log:
            log(f"health[{alert.level}] round {plan.round_idx}: "
                f"{alert.message}")
    if not obs.health.should_halt:
        return False
    tracer.instant("health.halt", cat="health", round=plan.round_idx)
    if log:
        log(f"health: fatal alert; halting after round "
            f"{plan.round_idx + 1}/{rounds}")
    return True


def _lm_batch_plan(shards, B: int, local_epochs: int):
    """The sequential LM loop's batches as the vmap engine's gather
    indices: (C, T, B) shard-local indices of each local step and the (C,
    T) mask of the steps a client really takes (its first ``max(1, n_i //
    B) * local_epochs``); the reference's ``train_lm`` replays them the
    same way."""
    nbs = [max(1, len(ix) // B) * local_epochs for ix in shards]
    T = max(nbs)
    batch_idx = torch.zeros((len(shards), T, B), dtype=torch.int64)
    valid = torch.zeros((len(shards), T), dtype=torch.bool)
    for ci, ix in enumerate(shards):
        for b in range(nbs[ci]):
            start = (b * B) % max(1, len(ix) - B)
            batch_idx[ci, b] = torch.arange(start, start + B)
            valid[ci, b] = True
    return batch_idx, valid


def run_lm_fedssl(cfg, fl, train_cfg, *, tokens, labels, shards, params,
                  device="cuda", codec: str = "fp32",
                  transport_kernels: str = "xla", log=None, obs=None,
                  privacy=None, draws=None, engine: str = "sequential"):
    """The LM family's layer-wise FedSSL loop; returns (final params,
    FLHistory).

    tokens, labels: (n, S) token pool; shards: one index array per client;
    params: the initial flat ``{path: tensor}`` dict (``lm.init_lm``).
    Every client trains in every round from the wire-decoded broadcast, one
    masked step of ``train_cfg``'s optimizer on ``lm_ssl_loss`` per batch
    of its shard (with the alignment where the plan aligns), at the
    round's cosine rate; FedAvg consumes the decoded uploads. Tensors are
    moved to ``device``, which defaults to the card. A client's round loss
    is its last step's. engine: ``sequential`` (one client after another)
    or ``vmap`` (``launch.steps.make_fl_round_program``: every client's
    step batched through ``torch.func.vmap``, on the same batches; it
    needs every shard to hold a batch). obs: as in ``run_fedssl``, with
    the spans of the reference's LM loop (``run > round > local_train``
    and the transport's).
    privacy: as in ``run_fedssl``, with every client in every round (q =
    1), as the reference's ``train_lm`` accounts it; draws: the source of
    the privacy draws (default ``TorchDraws(fl.seed, device)``; the loop
    draws nothing else). On the sequential engine each local step is a
    ``local_step`` span (its ``t``) holding ``lm_train_step``'s
    ``step.forward``, ``step.backward`` and ``step.update``.

    The zamba2 topology (Zamba2's published layout, one leaf a row) trains
    on the sequential engine: a client differentiates and keeps optimizer
    state for the stage's own leaves only (``client.lm_step_leaves``), and
    the masks, the wire and the accounting select leaves by the stages
    ``lm.leaf_stages`` gives them. On the card it turns on the caching
    allocator's expandable segments for the process.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine '{engine}'; one of {ENGINES}")
    stages = lm_mod.leaf_stages(cfg)
    if stages and engine != "sequential":
        raise ValueError(f"the {lm_mod.topology(cfg)} topology trains on "
                         f"the sequential engine, not '{engine}'")
    device = resolve_device(device)
    if stages and device.type == "cuda":
        # a published-width model's whole-model payloads (8.4 GiB at
        # Zamba2-7B's stage 3) alternate with a step's activations; without
        # expandable segments the cached blocks fragment until a payload
        # finds no room. The setting is the process's, as
        # PYTORCH_CUDA_ALLOC_CONF's would be, and stays after the run.
        torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    tokens = to_tensor(tokens, device, torch.int64)
    labels = to_tensor(labels, device, torch.int64)
    shards = [to_tensor(ix, device, torch.int64) for ix in shards]
    B = train_cfg.batch_size
    if engine == "vmap":
        if min(len(ix) for ix in shards) < B:
            raise ValueError(
                f"vmap engine needs every shard >= batch size: smallest "
                f"shard {min(len(ix) for ix in shards)} < batch {B}")
        pool = {k: stack_shards(v, [ix.cpu().numpy() for ix in shards])[0]
                for k, v in (("tokens", tokens), ("labels", labels))}
        batch_idx, valid = (t.to(device) for t in _lm_batch_plan(
            shards, B, fl.local_epochs))
    params = {k: to_tensor(v, device) for k, v in params.items()}
    opt = make_optimizer(train_cfg)
    plans = sched.build_schedule(fl, lm_mod.num_stages(cfg))
    base_lr = scaled_base_lr(train_cfg.base_lr, train_cfg.batch_size)
    w = aggregate.client_weights([len(ix) for ix in shards])
    clients = list(range(len(shards)))
    obs = obs if obs is not None else NOOP_OBS
    tracer = obs.tracer
    prv = make_privacy(privacy)
    secure = prv is not None and prv.cfg.secure_agg
    draws = draws if draws is not None else TorchDraws(fl.seed, device)
    wire = Transport(codec, kernels=transport_kernels, obs=obs, privacy=prv,
                     stages=stages)
    hist = FLHistory()

    def sequential_clients(plan, dparams, lr):
        """Every client's local steps, one client after another, from the
        decoded broadcast; returns (their trees, their last losses)."""
        outs, losses = [], []
        keys = lm_step_leaves(dparams, cfg, plan.sub_layers,
                              plan.active_from)
        for ix in shards:
            p_i, o_i = dparams, opt.init({k: dparams[k] for k in keys})
            nb = max(1, len(ix) // B)
            for b in range(nb * fl.local_epochs):
                # the reference's batch_start rule
                sel = ix[(b * B) % max(1, len(ix) - B):][:B]
                with tracer.span("local_step", cat="step", t=b):
                    p_i, o_i, m = lm_train_step(
                        p_i, o_i,
                        {"tokens": tokens[sel], "labels": labels[sel]},
                        lr, cfg=cfg, opt=opt, sub_layers=plan.sub_layers,
                        active_from=plan.active_from,
                        global_params=dparams if plan.align else None,
                        align_weight=ALIGN_WEIGHT if plan.align else 0.0,
                        tracer=tracer)
            outs.append(p_i)
            losses.append(float(m["loss"]))
            del o_i
        return outs, losses

    obs.start_profiler()
    try:
        with tracer.span("run", cat="fl", mode="lm-fedssl",
                         schedule=fl.schedule, engine=engine,
                         codec=wire.codec.name, kernels=transport_kernels,
                         rounds=fl.rounds, clients=len(clients)):
            for plan in plans:
                round_span = tracer.span("round", cat="fl",
                                         round=plan.round_idx,
                                         stage=plan.stage)
                host_t0 = time.perf_counter()
                with round_span:
                    if plan.new_stage and fl.weight_transfer:
                        params = lm_mod.transfer_model(cfg, params,
                                                       plan.stage)
                    lr = learning_rate(plan.round_idx, fl.rounds, base_lr,
                                       train_cfg.lr_schedule)
                    # clients, and the alignment's global model, see the
                    # decoded broadcast; no step writes into it
                    dparams, down = wire.broadcast(params, plan)
                    spec = wire.plan_specs(params, plan)["upload"]
                    with tracer.span("local_train", cat="fl", engine=engine,
                                     clients=len(clients)):
                        if engine == "vmap":
                            round_fn, _ = make_fl_round_program(
                                cfg, train_cfg, sub_layers=plan.sub_layers,
                                active_from=plan.active_from,
                                align=plan.align, transport=wire, plan=plan,
                                fedavg=not secure)
                            result, lvec, up = round_fn(
                                {"params": dparams, "server": params,
                                 "global_params": dparams if plan.align
                                 else None},
                                pool, batch_idx, valid, w, lr)
                            losses = lvec.tolist()
                        else:
                            outs, losses = sequential_clients(plan, dparams,
                                                              lr)
                    if engine == "sequential":
                        if secure:
                            result, up = wire.decode_uploads(
                                params, outs, clients, plan,
                                ref_online=dparams)
                        else:
                            result, up = wire.aggregate_uploads(
                                params, outs, clients, plan, w,
                                ref_online=dparams)
                        del outs  # not needed past the upload
                    if secure:
                        # the decoded trees, FedAvg'd as a masked sum
                        params = prv.secure_fedavg(
                            result, w.tolist(), clients, spec=spec,
                            base=params,
                            seed=draws.mask_seed(plan.round_idx))
                    else:
                        params = result
                    del result
                    eps = None
                    if prv is not None:
                        if prv.noise_enabled:
                            params = prv.add_noise(
                                params, spec, draws, plan.round_idx,
                                prv.sigma(float(w.max())))
                        # every client in every round: q = 1
                        eps = _account_round(prv, hist, 1.0, up, spec, wire)
                    cb = comm.round_comm_bytes(params, plan, stages=stages)
                    hist.loss.append(sum(losses) / len(losses))
                    hist.round_stage.append(plan.stage)
                    hist.download_bytes.append(cb["download"])
                    hist.upload_bytes.append(cb["upload"])
                    hist.wire_download_bytes.append(down["wire_bytes"])
                    hist.wire_upload_bytes.append(up["wire_bytes"])
                    round_span.set(loss=hist.loss[-1], lr=lr,
                                   download_bytes=cb["download"],
                                   upload_bytes=cb["upload"],
                                   wire_download_bytes=down["wire_bytes"],
                                   wire_upload_bytes=up["wire_bytes"])
                    if prv is not None:
                        _privacy_span_attrs(round_span, hist)
                if obs.enabled:
                    _round_metrics(obs.metrics, cb, down, up, hist.loss[-1],
                                   host_t0)
                if log:
                    log(format_round_line(
                        plan.round_idx, fl.rounds, plan.stage, hist.loss[-1],
                        lr=lr, down_mb=cb["download"] / 1e6,
                        up_mb=cb["upload"] / 1e6,
                        wire_mb=(down["wire_bytes"] + up["wire_bytes"])
                        / 1e6,
                        extra=f" eps {eps:.3g}" if prv is not None
                        and prv.dp else ""))
                if _observe_health(obs, plan, fl.rounds, hist.loss[-1], cb,
                                   down, up, len(clients), log, value=False):
                    break
                # the reference's LM loop logs the halt and records no
                # instant
                if _budget_exhausted(prv, eps, plan, fl.rounds, log):
                    break
    finally:
        obs.stop_profiler()
    return params, hist
