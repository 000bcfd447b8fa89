"""The round engines (``repro.federated.engine``): they run the "train the
round's participants, then aggregate" middle of a communication round; the
driver owns the schedule, the learning rate, calibration and the byte
accounting around them.

  sequential  a Python loop over the participants, each running
              ``client.local_train`` step by step.
  vmap        the vectorised engine: the participants' online, target and
              optimizer trees are stacked on a leading client axis and each
              local step is one ``client.stacked_train_step`` call for all
              of them (their forwards under ``torch.func.vmap``, one
              ``torch.autograd.grad`` of the summed losses). The
              reference compiles the round into one XLA program
              (``build_round_program``); here a Python loop over local
              steps drives the batched step.

Both engines take the driver's batch plans and ask the draws object for
each step's view and depth-dropout draws in the same order, so they consume
the same numbers. Ragged shards are padded to the longest participant's
step count; a padded step runs but its update is discarded. Uploads go
through ``transport.aggregate_uploads`` in both, so every codec and its
error-feedback residuals work the same on either engine.

``collect=True`` (the buffered-async round policy's form, and every
secure-aggregation round's) returns each participant's decoded upload tree
in place of the FedAvg, on both engines. With privacy on, the transport
clips each upload, so both engines clip alike.
``probe=`` (a ``repro_torch.obs.resources.StepProbe``, resource
measurement) is held around the round's first local step: the first
participant's on the sequential engine, the first batched step on the
vmap engine.

Observability (``obs=``, off by default), the reference's spans: the
sequential engine's ``client.train`` (client, loss) per participant and
``aggregate`` (engine, clients); the vmap engine's ``engine.dispatch``
(engine, participants) around the whole round. The reference's vmap round
is one XLA program with the wire inside it; here the transport's
``wire.upload`` spans run inside ``engine.dispatch``. The port's own
spans inside a round: each local step as a ``local_step`` (its ``t``)
holding ``step.views``, ``step.forward``, ``step.backward`` and
``step.update``, under ``client.train`` on the sequential engine and
``engine.dispatch`` on the vmap engine; the vmap engine's
``engine.inputs`` (every draw of the round, stacked); the transport's
``fedavg``.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from repro_torch.core import schedule as sched
from repro_torch.data.augment import two_views
from repro_torch.data.partition import stack_shards
from repro_torch.federated import aggregate, client as client_mod
from repro_torch.obs import NOOP_OBS, is_tracing

ENGINES = ("sequential", "vmap")


class SequentialEngine:
    name = "sequential"

    def __init__(self, *, encoder, ssl_cfg, opt, fl, images: torch.Tensor,
                 client_indices: Sequence[torch.Tensor], transport, draws,
                 obs=None):
        self.encoder, self.ssl_cfg, self.opt = encoder, ssl_cfg, opt
        self.fl, self.images = fl, images
        self.client_indices = list(client_indices)
        self.counts = [len(ix) for ix in self.client_indices]
        self.transport, self.draws = transport, draws
        self.obs = obs if obs is not None else NOOP_OBS

    def run_round(self, state, plan, participants, batch_plans, lr: float,
                  global_enc, server_online, collect: bool = False,
                  probe=None):
        """Train ``participants`` from the broadcast ``state`` along their
        ``batch_plans``; returns (aggregated online tree, or with
        ``collect`` the list of decoded per-client trees; per-client last
        losses; upload stats). The participants' indices are the client
        ids of the transport's error-feedback residuals, and the broadcast
        tree is the reference its delta codecs subtract."""
        tracer = self.obs.tracer
        outs, losses = [], []
        for n, (i, bplan) in enumerate(zip(participants, batch_plans)):
            with tracer.span("client.train", cat="engine",
                             client=int(i)) as sp:
                online_i, m = client_mod.local_train(
                    state, self.images[self.client_indices[i]], bplan,
                    self.draws, self.opt, encoder=self.encoder,
                    ssl_cfg=self.ssl_cfg, lr=lr, sub_layers=plan.sub_layers,
                    active_from=plan.active_from, align=plan.align,
                    depth_dropout=plan.depth_dropout, global_enc=global_enc,
                    probe=probe if n == 0 else None, tracer=tracer)
                outs.append(online_i)
                losses.append(m["loss"])
                if is_tracing(tracer):
                    # the reference reads every client's loss here; an
                    # untraced round reads them once, after the last client
                    sp.set(loss=float(losses[-1]))
        if collect:
            trees, stats = self.transport.decode_uploads(
                server_online, outs, list(participants), plan,
                ref_online=state["online"])
            return trees, [float(x) for x in losses], stats
        w = aggregate.client_weights([self.counts[i] for i in participants])
        with tracer.span("aggregate", cat="engine", engine=self.name,
                         clients=len(participants)):
            new_online, stats = self.transport.aggregate_uploads(
                server_online, outs, list(participants), plan, w,
                ref_online=state["online"])
        return new_online, [float(x) for x in losses], stats


def keep_rows(keep: torch.Tensor, new, old):
    """``new`` where ``keep[c]`` holds, else ``old``, leaf by leaf over
    (nested) dicts of client-stacked tensors."""
    if isinstance(new, dict):
        return {k: keep_rows(keep, v, old[k]) for k, v in new.items()}
    return torch.where(keep.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                       old)


class VmapEngine:
    name = "vmap"

    def __init__(self, *, encoder, ssl_cfg, opt, fl, images: torch.Tensor,
                 client_indices: Sequence[torch.Tensor], transport, draws,
                 batch_size: int, obs=None):
        self.encoder, self.ssl_cfg, self.opt = encoder, ssl_cfg, opt
        self.images = images
        self.counts = [len(ix) for ix in client_indices]
        self.transport, self.draws = transport, draws
        self.obs = obs if obs is not None else NOOP_OBS
        if min(self.counts) < batch_size:
            # the sequential engine cannot train such a client either (it
            # would run no local step); fail here rather than average an
            # untrained client in
            raise ValueError(
                f"vmap engine needs every shard >= batch size: smallest "
                f"shard {min(self.counts)} < batch {batch_size}")
        # (N, n_max) pool indices of each client's shard, padded
        self.shard_idx, _ = stack_shards(
            torch.arange(images.shape[0], device=images.device),
            [ix.cpu().numpy() for ix in client_indices])

    def _round_inputs(self, plan, participants, batch_plans):
        """Every draw of the round, asked for client by client and step by
        step as the sequential engine asks, then stacked per step: pool
        indices (T, C*B), the two views' draw dicts of (T, C*B) tensors and
        the gates (T, C, L) or None. A padded step repeats the client's
        first step, whose update is then discarded."""
        _, H, W, _ = self.images.shape
        L = self.encoder.num_stages
        idx, draws1, draws2, gates = [], [], [], []
        for i, bplan in zip(participants, batch_plans):
            ci, c1, c2, cg = [], [], [], []
            for local, handle in bplan:
                ci.append(self.shard_idx[i][local.to(self.images.device)])
                p1, p2 = self.draws.views(handle, len(local), H, W)
                c1.append(p1)
                c2.append(p2)
                if plan.depth_dropout > 0.0:
                    cg.append(sched.depth_dropout_gates(
                        self.draws.gate_uniforms(handle, L),
                        plan.active_from, plan.depth_dropout))
            idx.append(ci)
            draws1.append(c1)
            draws2.append(c2)
            gates.append(cg)
        T = max(len(b) for b in batch_plans)
        pick = [[t if t < len(b) else 0 for t in range(T)]
                for b in batch_plans]

        def per_step(rows):
            # rows[c][t]: (B, ...) -> (T, C, B, ...)
            return torch.stack([torch.stack([r[t] for t in ts])
                                for r, ts in zip(rows, pick)], 1)

        def view_draws(rows):
            return {f: per_step([[p[f] for p in r] for r in rows])
                    .flatten(1, 2) for f in rows[0][0]}

        return (per_step(idx).flatten(1, 2), view_draws(draws1),
                view_draws(draws2),
                per_step(gates) if plan.depth_dropout > 0.0 else None, T)

    def run_round(self, state, plan, participants, batch_plans, lr: float,
                  global_enc, server_online, collect: bool = False,
                  probe=None):
        """As ``SequentialEngine.run_round``: each local step is one batched
        step of all participants."""
        with self.obs.tracer.span("engine.dispatch", cat="engine",
                                  engine=self.name,
                                  participants=len(participants)):
            result, losses, stats = self._round(
                state, plan, participants, batch_plans, lr, global_enc,
                server_online, collect, probe)
        return result, [float(x) for x in losses.tolist()], stats

    def _round(self, state, plan, participants, batch_plans, lr: float,
               global_enc, server_online, collect, probe):
        C = len(participants)
        steps = [len(b) for b in batch_plans]
        tracer = self.obs.tracer
        with tracer.span("engine.inputs", cat="engine"):
            pool_idx, v1, v2, gates, T = self._round_inputs(
                plan, participants, batch_plans)
        g = state["online"]
        cstate = {"online": {k: v.expand(C, *v.shape) for k, v in g.items()}}
        if "target" in state:
            # the target restarts from the downloaded model each round
            cstate["target"] = {k: g[k].expand(C, *g[k].shape)
                                for k in state["target"]}
        opt_state = client_mod.stacked_opt_init(self.opt, cstate["online"])
        align_w = self.ssl_cfg.align_weight if plan.align else 0.0
        losses = None
        for t in range(T):
            with tracer.span("local_step", cat="step", t=t):
                with tracer.span("step.views", cat="step"):
                    x1, x2 = two_views(self.images[pool_idx[t]],
                                       {f: v[t] for f, v in v1.items()},
                                       {f: v[t] for f, v in v2.items()})
                with (probe if probe is not None and t == 0
                      else contextlib.nullcontext()):
                    new_state, new_opt, loss = client_mod.stacked_train_step(
                        cstate, opt_state, x1.unflatten(0, (C, -1)),
                        x2.unflatten(0, (C, -1)), lr, encoder=self.encoder,
                        ssl_cfg=self.ssl_cfg, opt=self.opt,
                        sub_layers=plan.sub_layers,
                        active_from=plan.active_from,
                        layer_gates=None if gates is None else gates[t],
                        global_enc=global_enc, align_weight=align_w,
                        tracer=tracer)
            if probe is not None and t == 0:
                probe.samples = x1.shape[0]
            if all(t < s for s in steps):
                cstate, opt_state, losses = new_state, new_opt, loss
                continue
            keep = torch.tensor([t < s for s in steps], device=loss.device)
            cstate = keep_rows(keep, new_state, cstate)
            new_leaf, shared = client_mod.shared_opt_state(new_opt)
            opt_state = {**keep_rows(keep, new_leaf, opt_state), **shared}
            losses = torch.where(keep, loss, losses)
        outs = [{k: v[c] for k, v in cstate["online"].items()}
                for c in range(C)]
        if collect:
            trees, stats = self.transport.decode_uploads(
                server_online, outs, list(participants), plan,
                ref_online=state["online"])
            return trees, losses, stats
        w = aggregate.client_weights([self.counts[i] for i in participants])
        new_online, stats = self.transport.aggregate_uploads(
            server_online, outs, list(participants), plan, w,
            ref_online=state["online"])
        return new_online, losses, stats


def make_engine(name: str, *, batch_size: int, **kw):
    """The round engine ``name`` (one of ``ENGINES``); ``kw`` are the
    engines' shared constructor arguments."""
    if name == "sequential":
        return SequentialEngine(**kw)
    if name == "vmap":
        return VmapEngine(batch_size=batch_size, **kw)
    raise ValueError(f"unknown engine '{name}'; one of {ENGINES}")
