"""End-to-end federated SSL driver (paper Algorithms 1 + 2;
``repro.federated.driver``).

Simulates the FL process on one device: per-round client sampling, local
MoCo v3 training under the stage schedule, FedAvg over the wire transport
and its codec, server-side calibration and communication accounting.
``run_lm_fedssl`` is the LM family's loop (``train_lm`` of
``repro.launch.train``): layer-wise FedSSL on token shards with
next-token SSL and alignment, every client in every round.
``FLHistory`` is the reference's, with the same versioned ``to_dict``, so
two histories compare field by field; the fleet-simulation and privacy
fields stay empty until those features are ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from repro_torch.convert import subtree, to_tensor
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as ssl_mod
from repro_torch.federated import aggregate, comm, server
from repro_torch.federated.client import lm_train_step
from repro_torch.federated.draws import TorchDraws
from repro_torch.federated.engine import make_engine
from repro_torch.federated.transport import Transport
from repro_torch.models import lm as lm_mod
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import learning_rate, scaled_base_lr

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
    # fleet-simulator accounting (not ported yet: always empty)
    round_wall_clock: List[float] = field(default_factory=list)
    device_seconds: List[float] = field(default_factory=list)
    energy_joules: List[float] = field(default_factory=list)
    dropped_clients: List[int] = field(default_factory=list)
    participants: List[tuple] = field(default_factory=list)
    # privacy accounting (not ported yet: always empty)
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


def format_round_line(round_idx: int, rounds: int, stage: int, loss: float,
                      *, lr: float, down_mb: float, up_mb: float,
                      wire_mb: float) -> str:
    """The per-round progress line (``repro.obs.format_round_line``)."""
    return (f"round {round_idx + 1}/{rounds} stage {stage} loss {loss:.4f} "
            f"lr {lr:.2e} down {down_mb:.2f}MB up {up_mb:.2f}MB "
            f"wire {wire_mb:.2f}MB")


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
               transport_kernels: str = "xla"):
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
    plain versions on the CPU.
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
    wire = Transport(codec, include_heads=fl.include_heads)
    eng = make_engine(engine, encoder=encoder, ssl_cfg=ssl_cfg, opt=opt,
                      fl=fl, images=images, client_indices=client_indices,
                      transport=wire, draws=draws,
                      batch_size=train_cfg.batch_size)

    # stage-relative step counters for the cyclic LR strategy
    stage_start: Dict[int, int] = {}
    for p in plans:
        stage_start.setdefault(p.stage, p.round_idx)
    stage_lengths = {s: sum(1 for p in plans if p.stage == s)
                     for s in stage_start}

    for plan in plans:
        if plan.new_stage:
            state = server.begin_stage(state, plan.stage,
                                       weight_transfer=fl.weight_transfer)
        lr = learning_rate(plan.round_idx, fl.rounds, base_lr,
                           train_cfg.lr_schedule,
                           stage_step=plan.round_idx - stage_start[plan.stage],
                           stage_total=stage_lengths[plan.stage],
                           warmup_steps=train_cfg.warmup_steps)
        participants = server.sample_clients(draws, fl.num_clients,
                                             fl.clients_per_round)
        # clients (and the alignment loss's global model) see the
        # wire-decoded broadcast, not the server's tree
        dstate, down = server.broadcast_download(state, plan, wire)
        global_enc = (subtree(dstate["online"], "enc")
                      if plan.align else None)
        batch_plans = [draws.batch_plan(eng.counts[i], fl.local_epochs,
                                        train_cfg.batch_size)
                       for i in participants]
        new_online, losses, up = eng.run_round(
            dstate, plan, participants, batch_plans, lr, global_enc,
            server_online=state["online"])
        state = {**state, "online": new_online}
        if plan.server_calibrate and aux_images is not None:
            state = server.server_calibrate(
                state, aux_images, draws, opt, encoder=encoder,
                ssl_cfg=ssl_cfg, sub_layers=plan.sub_layers,
                epochs=fl.server_epochs, batch_size=train_cfg.batch_size,
                lr=lr)
        cb = comm.round_comm_bytes(state["online"], plan,
                                   include_heads=fl.include_heads)
        hist.loss.append(sum(losses) / len(losses))
        hist.round_stage.append(plan.stage)
        hist.download_bytes.append(cb["download"])
        hist.upload_bytes.append(cb["upload"])
        hist.wire_download_bytes.append(down["wire_bytes"])
        hist.wire_upload_bytes.append(up["wire_bytes"])
        if log:
            log(format_round_line(
                plan.round_idx, fl.rounds, plan.stage, hist.loss[-1], lr=lr,
                down_mb=cb["download"] / 1e6, up_mb=cb["upload"] / 1e6,
                wire_mb=(down["wire_bytes"] + up["wire_bytes"]) / 1e6))
    return state, hist


# the alignment weight of the LM family's loss (the reference's train_lm)
LM_ALIGN_WEIGHT = 0.01


def run_lm_fedssl(cfg, fl, train_cfg, *, tokens, labels, shards, params,
                  device="cuda", codec: str = "fp32", log=None):
    """The LM family's layer-wise FedSSL loop; returns (final params,
    FLHistory).

    tokens, labels: (n, S) token pool; shards: one index array per client;
    params: the initial flat ``{path: tensor}`` dict (``lm.init_lm``).
    Every client trains in every round from the wire-decoded broadcast, one
    masked AdamW step of ``lm_ssl_loss`` per batch of its shard (with the
    alignment where the plan aligns), at the round's cosine rate; FedAvg
    consumes the decoded uploads. Tensors are moved to
    ``device``, which defaults to the card. A client's round loss is its
    last step's."""
    device = resolve_device(device)
    tokens = to_tensor(tokens, device, torch.int64)
    labels = to_tensor(labels, device, torch.int64)
    shards = [to_tensor(ix, device, torch.int64) for ix in shards]
    params = {k: to_tensor(v, device) for k, v in params.items()}
    opt = make_optimizer(train_cfg)
    plans = sched.build_schedule(fl, lm_mod.num_stages(cfg))
    base_lr = scaled_base_lr(train_cfg.base_lr, train_cfg.batch_size)
    B = train_cfg.batch_size
    w = aggregate.client_weights([len(ix) for ix in shards])
    clients = list(range(len(shards)))
    wire = Transport(codec)
    hist = FLHistory()
    for plan in plans:
        if plan.new_stage and fl.weight_transfer:
            params = sched.transfer_model(params, plan.stage)
        lr = learning_rate(plan.round_idx, fl.rounds, base_lr,
                           train_cfg.lr_schedule)
        # clients, and the alignment's global model, see the decoded
        # broadcast; no step writes into it
        dparams, down = wire.broadcast(params, plan)
        outs, losses = [], []
        for ix in shards:
            p_i, o_i = dparams, opt.init(dparams)
            nb = max(1, len(ix) // B)
            for b in range(nb * fl.local_epochs):
                # the reference's batch_start rule
                sel = ix[(b * B) % max(1, len(ix) - B):][:B]
                p_i, o_i, m = lm_train_step(
                    p_i, o_i, {"tokens": tokens[sel], "labels": labels[sel]},
                    lr, cfg=cfg, opt=opt, sub_layers=plan.sub_layers,
                    active_from=plan.active_from,
                    global_params=dparams if plan.align else None,
                    align_weight=LM_ALIGN_WEIGHT if plan.align else 0.0)
            outs.append(p_i)
            losses.append(float(m["loss"]))
        params, up = wire.aggregate_uploads(params, outs, clients, plan, w,
                                            ref_online=dparams)
        del outs        # the trained trees are not needed past FedAvg
        cb = comm.round_comm_bytes(params, plan)
        hist.loss.append(sum(losses) / len(losses))
        hist.round_stage.append(plan.stage)
        hist.download_bytes.append(cb["download"])
        hist.upload_bytes.append(cb["upload"])
        hist.wire_download_bytes.append(down["wire_bytes"])
        hist.wire_upload_bytes.append(up["wire_bytes"])
        if log:
            log(format_round_line(
                plan.round_idx, fl.rounds, plan.stage, hist.loss[-1], lr=lr,
                down_mb=cb["download"] / 1e6, up_mb=cb["upload"] / 1e6,
                wire_mb=(down["wire_bytes"] + up["wire_bytes"]) / 1e6))
    return params, hist
