"""Step functions of the LM family (``repro.launch.steps``), per (arch,
mode).

Modes
  train      end-to-end local SSL train step (the paper's FedMoCo
             baseline): next-token loss, gradients, optimizer update.
  train_lw   the LW-FedSSL local step at the *final* stage: full-depth
             forward, only the last stage trained, with the representation
             alignment against the broadcast global model.
  prefill    the full-prompt forward, the last position's logits
             (``make_prefill_step``).
  decode     one token a sequence against the decode caches
             (``make_decode_step``).

Sharded steps (``make_sharded_train_step``, ``make_sharded_prefill_step``,
``make_sharded_decode_step``) are the same steps on DTensors: parameters,
optimizer state, batch and caches laid out on a ``DeviceMesh`` by
``sharding.rules`` (``launch.inputs`` builds them). DTensor propagates the
layouts op by op and inserts the collectives; the kernels run on each
device's shards through their sharding rules (``kernels.ops``); the
tensors the model makes (RoPE tables, masks, positions) count as
replicated (``implicit_replication``); ``sharding.aten.AlignedLayouts``
keeps DTensor's strides in step with the local shards. Each gradient is
laid out as its parameter and each microbatch slice as its batch before
use, so the update keeps the rules' layouts. The loss and the update are
the unsharded step's: on a one-device mesh the same ops run on the same
tensors.

``make_train_step`` is one client's step under autograd; gradient
accumulation (``train_cfg.microbatch``) runs the microbatch slices one
after another, so one microbatch's activations are live at a time, and
``train_cfg.remat`` recomputes each trained block in the backward.
``make_fl_round_program`` is a whole LM FL round: the LM vmap engine's
batched local steps (``federated.engine.lm_stacked_clients``: the losses'
forward under ``torch.func.vmap`` and one ``torch.autograd.grad`` of their
sum), then FedAvg, through the wire transport when one is given. The
reference compiles that round into one XLA program; here a Python loop
over local steps drives the batched step.

Both take the decoder-only LMs and the encoder-decoder (``is_encdec``: a
config with cross attention and decoder layers). The encoder-decoder's
loss is ``encdec_loss``, plus the Eq. 3 alignment between the local and
the global model's mean-pooled encoder memory when aligning; its batches
and shards carry the ``frontend`` frames. Its stages are its encoder
blocks, as in the reference, and the stage plan's row range selects rows
of ``dec_blocks`` too (a stacked leaf), although every decoder block runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.ssl import ALIGN_WEIGHT, is_encdec, lm_loss, lm_stages
from repro_torch.federated import aggregate
from repro_torch.federated.engine import lm_stacked_clients, upload
from repro_torch.federated.masks import stage_update_mask
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.optim import make_optimizer
from repro_torch.sharding.aten import AlignedLayouts


def cfg_for_shape(cfg, shape_name: str):
    """long_500k: the quadratic-attention archs switch to a sliding window
    of 8192. SSM/hybrid run natively; DeepSeek's MLA keeps the full-context
    latent cache."""
    if shape_name == "long_500k" and cfg.window == 0 and cfg.mla is None \
            and cfg.family in ("dense", "vlm", "audio", "moe"):
        return dataclasses.replace(cfg, window=8192)
    return cfg


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` laid out as ``ref`` when both are DTensors (a gradient as its
    parameter, a microbatch slice as its batch); ``t`` itself otherwise."""
    if isinstance(t, DTensor) and isinstance(ref, DTensor) and \
            tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def make_train_step(cfg, train_cfg, *, mode: str = "train",
                    lr: float = 1e-4):
    """Returns (step, opt); ``step(params, opt_state, batch[,
    global_params]) -> (params, opt_state, metrics)``. With
    ``train_cfg.microbatch`` = m > 1 the batch is cut into m slices along
    its first axis; their fp32 gradients are summed and divided by m, and
    the loss metric is the slices' mean."""
    opt = make_optimizer(train_cfg)
    S = lm_stages(cfg)
    lw = mode == "train_lw"
    sub_layers, active_from = S, (S - 1 if lw else 0)
    align_weight = ALIGN_WEIGHT if lw else 0.0
    micro = train_cfg.microbatch

    def loss_and_grads(params, batch, global_params):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, metrics = lm_loss(
            cfg, p, batch, sub_layers=sub_layers, active_from=active_from,
            global_params=global_params, align_weight=align_weight,
            remat=train_cfg.remat)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        # leaves the loss does not reach (a frozen embedding) get zeros
        return loss.detach(), metrics, {
            k: torch.zeros_like(v) if g is None else _like(g, v)
            for (k, v), g in zip(params.items(), grads)}

    def step(params, opt_state, batch, global_params=None):
        if micro and micro > 1:
            n = next(iter(batch.values())).shape[0] // micro
            grads = {k: torch.zeros_like(v, dtype=torch.float32)
                     for k, v in params.items()}
            losses = []
            for i in range(micro):
                loss, _, g = loss_and_grads(
                    params, {k: _like(v[i * n:(i + 1) * n], v)
                             for k, v in batch.items()}, global_params)
                grads = {k: a + g[k].to(a.dtype) for k, a in grads.items()}
                losses.append(loss)
            grads = {k: g / micro for k, g in grads.items()}
            metrics = {"loss": sum(losses) / micro}
        else:
            loss, m, grads = loss_and_grads(params, batch, global_params)
            metrics = {**{k: v.detach() for k, v in m.items()},
                       "loss": loss}
        mask = (stage_update_mask(params, sub_layers, active_from)
                if lw else None)
        new_params, new_opt = opt.update(grads, opt_state, params, lr, mask)
        return new_params, new_opt, metrics

    return step, opt


def _like_tree(tree, ref):
    if isinstance(tree, dict):
        return {k: _like_tree(v, ref[k]) for k, v in tree.items()}
    return _like(tree, ref)


def _on_mesh(mesh, tree) -> None:
    for t in tree.values():
        if isinstance(t, DTensor) and t.device_mesh != mesh:
            raise ValueError("a sharded step's DTensors must lie on its "
                             "mesh")


def _full(v):
    return v.full_tensor() if isinstance(v, DTensor) else v


@contextlib.contextmanager
def _on_dtensors():
    with implicit_replication(), AlignedLayouts():
        yield


def make_sharded_train_step(cfg, train_cfg, mesh, mode: str = "train",
                            lr: float = 1e-4):
    """``make_train_step`` on DTensors laid out on ``mesh`` (the module
    docstring). Returns (step, opt); ``step(params, opt_state, batch[,
    global_params]) -> (params, opt_state, metrics)``, the parameters and
    state in their layouts, the metrics replicated plain tensors."""
    step, opt = make_train_step(cfg, train_cfg, mode=mode, lr=lr)

    def sharded(params, opt_state, batch, global_params=None):
        _on_mesh(mesh, params)
        with _on_dtensors():
            new_p, new_o, metrics = step(params, opt_state, batch,
                                         global_params)
            metrics = {k: _full(v) for k, v in metrics.items()}
            # the update keeps the inputs' layouts (DTensor may lay out an
            # elementwise result as it likes)
            new_p, new_o = _like_tree(new_p, params), \
                _like_tree(new_o, opt_state)
        return new_p, new_o, metrics

    return sharded, opt


def make_sharded_prefill_step(cfg, mesh):
    """``make_prefill_step`` on DTensors laid out on ``mesh``; the logits
    come back replicated."""
    step = make_prefill_step(cfg)

    def sharded(params, *inputs):
        _on_mesh(mesh, params)
        with _on_dtensors():
            return _full(step(params, *inputs))

    return sharded


def make_sharded_decode_step(cfg, mesh):
    """``make_decode_step`` on DTensors laid out on ``mesh``: the caches
    are written in place in their layouts; the logits come back
    replicated."""
    step = make_decode_step(cfg)

    def sharded(params, caches, *inputs):
        _on_mesh(mesh, params)
        with _on_dtensors():
            logits, caches = step(params, caches, *inputs)
            return _full(logits), caches

    return sharded


def make_prefill_step(cfg):
    """``step(params, batch)`` -> the last position's logits, for a batch
    {"tokens", optional "frontend"}; the encoder-decoder's ``step(params,
    frames, tokens)``."""
    if is_encdec(cfg):
        def step(params, frames, tokens):
            return encdec_mod.prefill(params, frames, tokens, cfg)[0]
        return step

    def step(params, batch):
        return lm_mod.prefill(params, batch["tokens"], cfg,
                              batch.get("frontend"))[0]
    return step


def make_decode_step(cfg):
    """``step(params, caches, token, pos)`` -> (logits, caches); the
    encoder-decoder's ``step(params, caches, token, pos, memory)``. ``pos``
    is a Python int; the caches are written in place."""
    if is_encdec(cfg):
        def step(params, caches, token, pos, memory):
            return encdec_mod.decode_step(params, caches, token, pos, memory,
                                          cfg)
        return step

    def step(params, caches, token, pos):
        return lm_mod.decode_step(params, caches, token, pos, cfg)
    return step


def make_fl_round_program(cfg, train_cfg, *, mode: str = "train",
                          sub_layers: Optional[int] = None,
                          active_from: Optional[int] = None,
                          align: Optional[bool] = None, transport=None,
                          plan=None, fedavg: bool = True):
    """One LM FL round for C clients at once: the LM vmap engine's
    ``federated.engine.lm_stacked_clients``. Stage defaults follow ``mode``
    (end-to-end for ``train``, the final stage with alignment for
    ``train_lw``); a stage schedule passes its plan's ``sub_layers``,
    ``active_from`` and ``align``.

    Returns ``(round_fn, opt)``; ``round_fn(broadcast, shards, batch_idx,
    valid, weights, lr)``: ``broadcast`` holds ``params`` (and
    ``global_params`` when aligning), every ``shards`` leaf is ``(C,
    n_max, ...)``, ``batch_idx`` (C, T, B) holds shard-local indices of
    each local step's batch and ``valid`` (C, T) marks the steps that
    count, a client's first ones: a step with ``valid`` False runs but its
    update is discarded. Returns (FedAvg of the clients' trees with
    ``weights``, or with ``fedavg=False`` the list of their trees; the (C,)
    losses of each client's last valid step).

    With ``transport`` and the round's ``plan``, the clients' trees go
    through the wire (``federated.engine.upload``, client ids 0..C-1) onto
    ``broadcast["server"]``, and ``round_fn`` returns the upload stats as a
    third value."""
    opt = make_optimizer(train_cfg)
    S = lm_stages(cfg)
    lw = mode == "train_lw"
    sub_layers = S if sub_layers is None else sub_layers
    active_from = (S - 1 if lw else 0) if active_from is None \
        else active_from
    align = lw if align is None else align

    def round_fn(broadcast, shards, batch_idx, valid, weights, lr):
        outs, losses = lm_stacked_clients(
            broadcast["params"], shards, batch_idx, valid.sum(1).tolist(),
            lr, opt=opt, cfg=cfg, sub_layers=sub_layers,
            active_from=active_from,
            global_params=broadcast.get("global_params") if align else None,
            align_weight=ALIGN_WEIGHT if align else 0.0,
            remat=train_cfg.remat)
        if transport is None:
            return (aggregate.fedavg(outs, weights) if fedavg else outs), \
                losses
        tree, stats = upload(transport, broadcast["server"], outs,
                             list(range(len(outs))), plan,
                             broadcast["params"], weights if fedavg else None)
        return tree, losses, stats

    return round_fn, opt
