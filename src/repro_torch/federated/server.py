"""Server-side mechanisms (``repro.federated.server``): calibration (paper
Algorithm 1 line 7), stage transitions with weight transfer, the download
broadcast and client sampling."""
from __future__ import annotations

import math

import torch

from repro_torch.core import schedule as sched
from repro_torch.data.augment import two_views
from repro_torch.federated.client import train_step
from repro_torch.federated.graphed import GraphedStep
from repro_torch.federated.masks import stage_update_mask
from repro_torch.obs.trace import NOOP_TRACER


def server_calibrate(state, aux_images: torch.Tensor, draws, opt, *,
                     encoder, ssl_cfg, sub_layers: int, epochs: int,
                     batch_size: int, lr: float, tracer=NOOP_TRACER):
    """Train the aggregated sub-model end to end (``active_from=0``) on D_g,
    with a fresh optimizer state, as the clients have. ``tracer`` records
    the whole as a ``calibrate`` span (its ``sub_layers``) and each step
    as a ``calibrate.step`` (its ``t`` and ``mode``) holding ``step.views``
    and, where the step runs ``train_step`` in Python, its spans.

    On a CUDA device the first step runs eagerly (``mode="eager"``), the
    second is captured as a CUDA graph (``"capture"``, ``_CalibrationGraph``)
    and every step after the first is a replay of it (the later steps'
    ``mode`` is ``"replay"``; the ``calibrate`` span counts them in
    ``replays``). The graph is made for this calibration and released
    before it returns. Elsewhere every step runs eagerly."""
    opt_state = opt.init(state["online"])
    n, H, W, _ = aux_images.shape
    step_kw = dict(encoder=encoder, ssl_cfg=ssl_cfg, opt=opt,
                   sub_layers=sub_layers, active_from=0, tracer=tracer)
    graphs, graph = GraphedStep.available(aux_images.device), None
    with tracer.span("calibrate", cat="fl", sub_layers=sub_layers) as span:
        try:
            for t, (idx, handle) in enumerate(draws.batch_plan(
                    n, epochs, min(batch_size, n), calibration=True)):
                mode = ("eager" if t == 0 or not graphs
                        else "capture" if graph is None else "replay")
                with tracer.span("calibrate.step", cat="step", t=t,
                                 mode=mode):
                    with tracer.span("step.views", cat="step"):
                        batch = aux_images[idx]
                        x1, x2 = two_views(batch, *draws.views(
                            handle, batch.shape[0], H, W))
                    if mode == "eager":
                        state, opt_state, _ = train_step(
                            state, opt_state, x1, x2, lr, **step_kw)
                        continue
                    if graph is None:
                        graph = _CalibrationGraph(state, opt_state, x1, x2,
                                                  lr, **step_kw)
                    graph.step(x1, x2, opt.scalars(t + 1, lr))
            if graph is not None:
                span.set(replays=graph.graphed.replays)
                state = graph.state
        finally:
            if graph is not None:
                graph.graphed.close()
    return state


class _CalibrationGraph:
    """``train_step`` as a ``GraphedStep`` over static buffers, all held
    here: the state and the optimizer state (the eager first step's
    outputs, which the functional update made new, so they are this
    calibration's own), the two views, the update mask and the
    optimizer's per-step scalars as 0-dim fp32 tensors. The captured step
    ends by copying its new state and optimizer state into the static
    ones (the Python step count there stays at the eager step's; the
    scalars carry the count). ``step`` fills the views and the scalars
    with device-side copies and replays; a replay gives the eager step's
    bits."""

    def __init__(self, state, opt_state, x1, x2, lr, *, opt, sub_layers,
                 active_from, **step_kw):
        self.state, self.opt_state = state, opt_state
        self.x1, self.x2 = torch.empty_like(x1), torch.empty_like(x2)
        self.scalars = {k: torch.zeros((), dtype=torch.float32,
                                       device=x1.device)
                        for k in opt.scalars(1, lr)}
        # built once (it copies host values, which a capture cannot) and
        # kept: every replay reads it
        self.mask = stage_update_mask(state["online"], sub_layers,
                                      active_from)

        def step():
            new, new_opt, _ = train_step(
                self.state, self.opt_state, self.x1, self.x2, lr, opt=opt,
                sub_layers=sub_layers, active_from=active_from,
                mask=self.mask, scalars=self.scalars, **step_kw)
            _copy_into(self.state, new)
            _copy_into(self.opt_state, new_opt)

        self.graphed = GraphedStep(step, x1.device)

    def step(self, x1, x2, scalars) -> None:
        self.x1.copy_(x1)
        self.x2.copy_(x2)
        for k, v in scalars.items():
            self.scalars[k].fill_(v)
        self.graphed.replay()


def _copy_into(dst: dict, src: dict) -> None:
    """Copy each tensor of the nested dict ``src`` into the tensor at the
    same keys of ``dst``; other entries (a step count) are left alone."""
    for k, d in dst.items():
        if isinstance(d, torch.Tensor):
            d.copy_(src[k])
        elif isinstance(d, dict):
            _copy_into(d, src[k])


def broadcast_download(state, plan, transport):
    """Server -> clients (paper Fig. 1 step i): push the plan's download
    payload over the wire; returns (the state clients train from, stats)."""
    view, stats = transport.broadcast(state["online"], plan)
    return {**state, "online": view}, stats


def begin_stage(state, stage: int, *, weight_transfer: bool):
    """Stage-transition housekeeping: L_{s-1} -> L_s weight transfer in the
    online encoder and, where the method has one, the target encoder."""
    if not weight_transfer or stage < 2:
        return state
    return {branch: sched.transfer_model(tree, stage, "enc/")
            for branch, tree in state.items()}


def sample_clients(draws, num_clients: int, clients_per_round: int, *,
                   overcommit: float = 1.0):
    """The round's cohort (everyone when ``clients_per_round`` is 0).
    ``overcommit > 1`` (the deadline policy's straggler insurance) inflates
    the sample by that factor, clamped to the population; ``overcommit=1``
    draws what it always drew."""
    n = clients_per_round or num_clients
    return draws.cohort(num_clients,
                        min(num_clients, math.ceil(n * overcommit)))
