"""Measured resources of the port's local steps (``repro.obs.resources``).

The analytic roofline (``repro_torch.roofline.client_costs``) *predicts*
the paper's memory / GFLOPs / comm reductions from the ViT config; this
module *measures* them from the steps the engines run:

  FLOPs    ``torch.utils.flop_counter.FlopCounterMode`` held around one
           local step per distinct plan signature. The step runs eagerly,
           so every layer is counted (the reference unrolls its XLA scans
           for the count; the port has nothing to unroll). The ops that
           leave PyTorch for a hand-written kernel are counted by formula
           (``repro_torch.kernels.ops``), so a step counts the same FLOPs
           on the card and on the CPU.
  memory   on the card, ``torch.cuda.reset_peak_memory_stats()``, the
           step, ``torch.cuda.max_memory_allocated()``: the peak of what
           the allocator holds during the step, the state and optimizer
           moments it starts from included, above what the device held
           before they were made. The CPU has no allocator statistics:
           there peak memory is not measured.
  live     ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` on
           the card (allocator counters read on the host, no device
           synchronisation), RSS from ``/proc/self`` on the CPU, cheap
           enough for the driver to put on every round span (``mem.*``
           attributes, which ``Tracer.structure()`` ignores).

Normalisation as in the reference: the sequential engine's unit is one
local step of one client over one batch (per-sample FLOPs = flops /
batch); the vmap engine's unit is one batched step of ``clients`` clients
(per-sample = flops / (clients * batch)). Schedule totals multiply
per-sample costs by ``local_epochs`` and sum over the round plans, the
accounting of ``client_costs.schedule_costs``, so measured and analytic
columns compare directly; gated layers (FLL+DD) count densely in both.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

# measured-vs-analytic agreement bounds, per plan signature (the
# reference's): the counter sees products the analytic model folds into its
# 2:1 backward ratio (the attention backward recomputes the probabilities,
# the InfoNCE gradients recompute the logits), so measured FLOPs sit a few
# percent above analytic; the allocator's peak holds the step's inputs,
# outputs and transients together.
FLOPS_RTOL = 0.30          # |measured/analytic - 1| <= 0.30
MEMORY_FACTOR = 3.0        # analytic/3 <= measured peak <= 3*analytic


# ---------------------------------------------------------------------------
# live memory watermarks
# ---------------------------------------------------------------------------
def _peak_rss_bytes() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def device_memory_snapshot(device=None) -> dict:
    """Live memory watermark of ``device`` (default: the current card if
    there is one, else the CPU).

    On the card, the caching allocator's allocated bytes and their peak
    (``source`` "device"); on the CPU, where tensors live on the host heap,
    the process RSS and its high-water mark ``VmHWM`` (``source``
    "rss")."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        from repro_torch.roofline.analysis import memory_dict
        stats = memory_dict(device)
        return {"source": "device", "bytes_in_use": stats["bytes_in_use"],
                "peak_bytes": stats["peak_bytes"]}
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        return {"source": "rss", "bytes_in_use": rss,
                "peak_bytes": _peak_rss_bytes() or rss}
    except (OSError, ValueError, IndexError):
        return {"source": "none", "bytes_in_use": 0, "peak_bytes": 0}


def memory_span_attrs(device=None) -> dict:
    """``device_memory_snapshot`` as ``mem.``-prefixed span attributes.
    ``Tracer.structure()`` drops the ``mem.`` keys, so traced runs compare
    across machines."""
    snap = device_memory_snapshot(device)
    return {"mem.source": snap["source"],
            "mem.bytes_in_use": snap["bytes_in_use"],
            "mem.peak_bytes": snap["peak_bytes"]}


# ---------------------------------------------------------------------------
# measurement configurations
# ---------------------------------------------------------------------------
def measurement_config(arch: str = "vit-tiny", *, num_layers: int = 4,
                       batch_size: int = 8):
    """The reference's reduced measurement shape: ``num_layers`` blocks at
    shrunk width (what the CPU tests measure). Resource *ratios* between
    schedules are structural, so they survive the shrink, and the analytic
    columns are evaluated on the same config."""
    from repro_torch.configs.base import (SSLConfig, TrainConfig, load_arch,
                                          reduced)
    cfg = reduced(load_arch(arch), num_layers=num_layers,
                  num_heads=2, num_kv_heads=2)
    return cfg, SSLConfig(), TrainConfig(batch_size=batch_size)


def full_width_config(arch: str = "vit-tiny"):
    """The card's measurement shape: ``arch`` at its published width (for
    ViT-Tiny 12 blocks, d 192, 3 heads of 64, bf16 compute) with the
    ``SSLConfig()`` heads, at batch 256 (``chip_smoke.py``'s main path)."""
    from repro_torch.configs.base import SSLConfig, TrainConfig, load_arch
    return load_arch(arch), SSLConfig(), TrainConfig(batch_size=256)


def _plan_sig(plan):
    return (plan.sub_layers, plan.active_from, plan.align,
            plan.depth_dropout)


# ---------------------------------------------------------------------------
# counting a step the run takes anyway
# ---------------------------------------------------------------------------
class StepProbe:
    """Counts the FLOPs of the code run inside it. The engines hold it
    around a stage's first local step (``run_round(..., probe=...)``) and
    record the samples that step trained on."""

    def __init__(self):
        self.flops: Optional[int] = None
        self.by_op: dict = {}
        self.samples = 0
        self._mode = None

    def __enter__(self):
        self._mode = FlopCounterMode(display=False)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        from repro_torch.roofline.analysis import flop_dict
        mode, self._mode = self._mode, None
        mode.__exit__(*exc)
        counts = flop_dict(mode)
        self.flops = counts.pop("flops")
        self.by_op = counts
        return False


def stage_cost_attrs(probe: StepProbe) -> dict:
    """The counted step as ``res.``-prefixed span attributes, for the
    round span that opens a stage. The reference also records XLA's
    ``bytes accessed``, which an eager step has no counterpart of."""
    flops = float(probe.flops)
    return {"res.flops": flops,
            "res.flops_per_sample": flops / max(1, probe.samples)}


# ---------------------------------------------------------------------------
# the eager engines' memory model
# ---------------------------------------------------------------------------
def _state_bytes(tree) -> int:
    """Bytes of the tensors of a nested dict (other leaves count 0)."""
    if isinstance(tree, dict):
        return sum(_state_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def program_memory_analytic(cfg, ssl, train, plan, engine_name: str, *,
                            clients: int = 1) -> dict:
    """Analytic peak of the bytes one local step of the port's eager
    engines holds, the prediction the measured peak is checked against
    (``MEMORY_FACTOR``). What the step holds:

      held        the SSL state (online + target) and the optimizer state it
                  starts from, the batch and its two views; on the vmap
                  engine one global state (the clients' trees are expanded
                  views of it) and per-client moments, batch and views.
      activations what the backward keeps, per sample and view (two views
                  are in flight): the stem and final norm, each trained
                  block (its two fp32 norm inputs on the residual stream,
                  and at the compute dtype the qkv input, q, k and v, the
                  attention output, the MLP input, its hidden
                  pre-activation and activation; the attention kernel
                  keeps no probabilities), and the heads. The frozen
                  prefix, the target branch and the alignment's global
                  encoder run under ``no_grad``: one block's working set
                  (with the plain attention backward's fp32 probabilities)
                  is transient.
      update      after the backward: the gradients of the online tree,
                  and the new online tree, moments and target written
                  while the old ones are held.

    Both engines take the gradient with one ``torch.autograd.grad``, which
    frees each node's intermediates as it goes (the vmap engine's over the
    clients' summed losses, ``client.stacked_loss_and_grads``), so the
    backward adds no term of its own.

    peak = held + max(activations + transient, update), per client on the
    vmap engine. The reference's model instead keeps XLA's full resident
    state (arguments + outputs) and a schedule-flat program."""
    from repro_torch.federated import comm
    from repro_torch.optim import make_optimizer
    from repro_torch.roofline import client_costs as cc

    state = cc.build_ssl_param_tree(cfg, ssl)
    online_b = comm.tree_bytes(state["online"])
    target_b = comm.tree_bytes(state.get("target", {}))    # none for simclr
    state_b = online_b + target_b
    # the optimizer's state as its init makes it on the meta device (AdamW
    # 2x the online tree in fp32, Adafactor's factored moments, SGDM's v)
    opt_b = _state_bytes(make_optimizer(train).init(state["online"]))
    c = cc.vit_costs(cfg, ssl)
    cbytes = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                         ).element_size()
    t, d, H = c.tokens, c.d, c.heads
    trained = plan.sub_layers - plan.active_from
    block_b = t * d * 2 * 4 + (t * d * 6 + 2 * t * c.d_ff) * cbytes
    bs = train.batch_size
    batch_b = bs * 32 * 32 * 3 * 4
    acts = 2 * bs * (c.a_stem * 4 + trained * block_b + c.a_heads * 4)
    vmap = engine_name == "vmap"
    transient = bs * (block_b + 3 * H * t * t * 4)
    update = 2 * online_b + opt_b + target_b
    C = clients if vmap else 1
    held = (state_b + C * opt_b if vmap else state_b + opt_b) \
        + C * 3 * batch_b
    peak = held + C * max(acts + transient, update)
    return {"held_bytes": float(held), "activation_bytes": float(C * acts),
            "update_bytes": float(C * update), "peak_bytes": float(peak)}


# ---------------------------------------------------------------------------
# one measured step, and a schedule's
# ---------------------------------------------------------------------------
def measure_step(plan, engine_name: str, *, cfg, ssl, train,
                 clients: int = 1, device="cuda", seed: int = 0,
                 count: bool = True) -> dict:
    """One local step of ``plan`` on ``engine_name``'s step function, from
    a fresh state made by its own generator: FLOPs counted (unless
    ``count`` is False: the same step uncounted, to show that counting
    changes nothing), and on the card the step's peak memory: the
    allocator's peak during the step, above what the device held before
    the step's state, moments and batch were made. Returns
    {"flops", "samples", "flops_per_sample", "by_op", "peak_bytes" (None
    on the CPU), "loss"}."""
    from repro_torch.convert import subtree
    from repro_torch.core import schedule as sched
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data import augment
    from repro_torch.federated import client as client_mod
    from repro_torch.optim import make_optimizer

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        # the step's peak counts from what the device held before the step's
        # state was made: what else the process holds is not the step's
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
    gen = torch.Generator(device).manual_seed(seed)
    enc = ssl_mod.make_vit_encoder(cfg)
    state = ssl_mod.ssl_init(enc, ssl, gen, device)
    opt = make_optimizer(train)
    bs, L = train.batch_size, enc.num_stages
    C = clients if engine_name == "vmap" else 1
    images = torch.rand(C, bs, 32, 32, 3, generator=gen, device=device)
    views = [augment.two_views(images[c],
                               augment.draw_params(gen, bs, 32, 32),
                               augment.draw_params(gen, bs, 32, 32))
             for c in range(C)]
    gates = None
    if plan.depth_dropout > 0.0:
        gates = torch.stack([sched.depth_dropout_gates(
            torch.rand(L, generator=gen, device=device), plan.active_from,
            plan.depth_dropout) for _ in range(C)])
    kw = dict(encoder=enc, ssl_cfg=ssl, opt=opt, sub_layers=plan.sub_layers,
              active_from=plan.active_from,
              global_enc=subtree(state["online"], "enc") if plan.align
              else None,
              align_weight=ssl.align_weight if plan.align else 0.0)
    if engine_name == "vmap":
        # the clients' trees are expanded views of one state, as in the
        # vmap engine
        cstate = {br: {k: v.expand(C, *v.shape) for k, v in tree.items()}
                  for br, tree in state.items()}
        opt_state = client_mod.stacked_opt_init(opt, cstate["online"])
        x1 = torch.stack([v[0] for v in views])
        x2 = torch.stack([v[1] for v in views])

        def step():
            return client_mod.stacked_train_step(
                cstate, opt_state, x1, x2, 1e-4, layer_gates=gates, **kw)[2]
    elif engine_name == "sequential":
        opt_state = opt.init(state["online"])
        x1, x2 = views[0]

        def step():
            return client_mod.train_step(
                state, opt_state, x1, x2, 1e-4,
                layer_gates=None if gates is None else gates[0],
                **kw)[2]["loss"]
    else:
        raise ValueError(f"unknown engine '{engine_name}'")
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    probe = StepProbe()
    with probe if count else contextlib.nullcontext():
        loss = step()
    peak = None
    if cuda:
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device)) - base
    samples = C * bs
    return {"flops": probe.flops, "samples": samples,
            "flops_per_sample": probe.flops / samples if count else None,
            "by_op": probe.by_op,
            "peak_bytes": peak,
            "loss": [float(x) for x in torch.as_tensor(loss).reshape(-1)]}


def measure_schedule(schedule: str, engine_name: str, *, cfg=None, ssl=None,
                     train=None, rounds: int = 20, local_epochs: int = 3,
                     depth_dropout: float = 0.5, clients: int = 1,
                     device="cuda", seed: int = 0, log=None) -> dict:
    """Measure one schedule on one engine: one counted local step per
    *distinct* plan signature (``measure_step``), its peak memory on the
    card. Default config: ``full_width_config()``. Returns measured and
    analytic columns side by side; totals use the ``schedule_costs``
    accounting (per-sample x ``local_epochs``, summed over round plans;
    dense)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.convert import subtree
    from repro_torch.core import schedule as sched
    from repro_torch.federated import comm
    from repro_torch.roofline import client_costs as cc

    if cfg is None or ssl is None or train is None:
        fcfg, fssl, ftrain = full_width_config()
        cfg, ssl, train = cfg or fcfg, ssl or fssl, train or ftrain
    fl = FLConfig(rounds=rounds, schedule=schedule, num_clients=2,
                  local_epochs=local_epochs, depth_dropout=depth_dropout)
    plans = sched.build_schedule(fl, cfg.num_layers)
    costs = cc.vit_costs(cfg, ssl)
    params_bytes = comm.tree_bytes(
        subtree(cc.build_ssl_param_tree(cfg, ssl)["online"], "enc"))
    bs = train.batch_size

    sigs = {}
    for p in plans:
        sigs.setdefault(_plan_sig(p), p)
    stages = []
    for sig, p in sigs.items():
        if log:
            log(f"[resources] step {schedule}/{engine_name} "
                f"sub={p.sub_layers} act={p.active_from}")
        m = measure_step(p, engine_name, cfg=cfg, ssl=ssl, train=train,
                         clients=clients, device=device, seed=seed)
        stages.append({
            "sub_layers": p.sub_layers, "active_from": p.active_from,
            "align": bool(p.align), "depth_dropout": float(p.depth_dropout),
            "rounds": sum(1 for q in plans if _plan_sig(q) == sig),
            "flops_per_sample": m["flops_per_sample"],
            "analytic_flops_per_sample":
                float(cc.flops_per_sample_round(costs, p)),
            "analytic_memory_bytes":
                float(cc.memory_bytes(costs, p, bs, params_bytes)),
            "peak_memory": (None if m["peak_bytes"] is None
                            else float(m["peak_bytes"])),
            "program_peak_analytic": program_memory_analytic(
                cfg, ssl, train, p, engine_name,
                clients=clients)["peak_bytes"],
        })

    flops_total = sum(s["flops_per_sample"] * s["rounds"] * local_epochs
                      for s in stages)
    analytic_total = sum(
        s["analytic_flops_per_sample"] * s["rounds"] * local_epochs
        for s in stages)
    peaks = [s["peak_memory"] for s in stages]
    return {
        "schedule": schedule, "engine": engine_name,
        "num_layers": cfg.num_layers, "batch_size": bs,
        "rounds": rounds, "local_epochs": local_epochs,
        "clients": clients, "device": str(torch.device(device)),
        "stages": stages,
        "flops_total": flops_total,
        "analytic_flops_total": analytic_total,
        "analytic_peak_memory": max(s["analytic_memory_bytes"]
                                    for s in stages),
        "program_peak_analytic": max(s["program_peak_analytic"]
                                     for s in stages),
        "peak_memory": None if None in peaks else max(peaks),
    }
