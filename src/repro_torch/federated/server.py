"""Server-side mechanisms (``repro.federated.server``): calibration (paper
Algorithm 1 line 7), stage transitions with weight transfer, the download
broadcast and client sampling."""
from __future__ import annotations

import math

import torch

from repro_torch.core import schedule as sched
from repro_torch.data.augment import two_views
from repro_torch.federated.client import train_step
from repro_torch.obs.trace import NOOP_TRACER


def server_calibrate(state, aux_images: torch.Tensor, draws, opt, *,
                     encoder, ssl_cfg, sub_layers: int, epochs: int,
                     batch_size: int, lr: float, tracer=NOOP_TRACER):
    """Train the aggregated sub-model end to end (``active_from=0``) on D_g,
    with a fresh optimizer state, as the clients have. ``tracer`` records
    each step as a ``calibrate.step`` (its ``t``) holding ``step.views``
    and ``train_step``'s spans."""
    opt_state = opt.init(state["online"])
    n, H, W, _ = aux_images.shape
    for t, (idx, handle) in enumerate(draws.batch_plan(
            n, epochs, min(batch_size, n), calibration=True)):
        with tracer.span("calibrate.step", cat="step", t=t):
            with tracer.span("step.views", cat="step"):
                batch = aux_images[idx]
                x1, x2 = two_views(batch, *draws.views(handle, batch.shape[0],
                                                       H, W))
            state, opt_state, _ = train_step(
                state, opt_state, x1, x2, lr, encoder=encoder,
                ssl_cfg=ssl_cfg, opt=opt, sub_layers=sub_layers,
                active_from=0, tracer=tracer)
    return state


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
