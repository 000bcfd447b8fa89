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

The LM family's engines, ``LMSequentialEngine`` and ``LMVmapEngine``
(``lm_stacked_clients``), train every client each round on the
reference's batches (``lm_batch_plan``); both vmap engines pad through
``padded_steps``.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from repro_torch.core import schedule as sched
from repro_torch.core.ssl import ALIGN_WEIGHT
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
        w = None if collect else aggregate.client_weights(
            [self.counts[i] for i in participants])
        with (contextlib.nullcontext() if collect else tracer.span(
                "aggregate", cat="engine", engine=self.name,
                clients=len(participants))):
            result, stats = upload(self.transport, server_online, outs,
                                   list(participants), plan,
                                   state["online"], w)
        return result, [float(x) for x in losses], stats


def keep_rows(keep: torch.Tensor, new, old):
    """``new`` where ``keep[c]`` holds, else ``old``, leaf by leaf over
    (nested) dicts of client-stacked tensors."""
    if isinstance(new, dict):
        return {k: keep_rows(keep, v, old[k]) for k, v in new.items()}
    return torch.where(keep.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                       old)


def padded_steps(step, state, opt_state, steps: Sequence[int]):
    """``max(steps)`` batched local steps ``step(t, state, opt_state) ->
    (state, opt_state, losses (C,))`` from client-stacked states, of which
    client c takes ``steps[c]``: past them its rows and its loss keep their
    values (the shared step count goes on). ``steps`` is on the host, so a
    step every client takes adds no tensor op. Returns (state, losses)."""
    losses = None
    for t in range(max(steps)):
        new_state, new_opt, loss = step(t, state, opt_state)
        if all(t < s for s in steps):
            state, opt_state, losses = new_state, new_opt, loss
            continue
        keep = torch.tensor([t < s for s in steps], device=loss.device)
        state = keep_rows(keep, new_state, state)
        new_leaf, shared = client_mod.shared_opt_state(new_opt)
        opt_state = {**keep_rows(keep, new_leaf, opt_state), **shared}
        losses = torch.where(keep, loss, torch.zeros_like(loss)
                             if losses is None else losses)
    return state, losses


def upload(transport, server, outs, clients, plan, ref, weights=None):
    """``outs`` through the wire onto the server's tree: their FedAvg with
    ``weights``, else each decoded upload. Returns (result, stats)."""
    if weights is None:
        return transport.decode_uploads(server, outs, clients, plan,
                                        ref_online=ref)
    return transport.aggregate_uploads(server, outs, clients, plan, weights,
                                       ref_online=ref)


def _check_shards(counts, batch_size: int) -> None:
    if min(counts) < batch_size:
        # a batched step takes a whole batch of every client (the ViT's
        # sequential engine would run no step for a smaller shard): fail
        # here rather than average an untrained client in
        raise ValueError(
            f"vmap engine needs every shard >= batch size: smallest "
            f"shard {min(counts)} < batch {batch_size}")


class VmapEngine(SequentialEngine):
    name = "vmap"

    def __init__(self, *, batch_size: int, **kw):
        super().__init__(**kw)
        _check_shards(self.counts, batch_size)
        # (N, n_max) pool indices of each client's shard, padded
        self.shard_idx, _ = stack_shards(
            torch.arange(self.images.shape[0], device=self.images.device),
            [ix.cpu().numpy() for ix in self.client_indices])

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
                per_step(gates) if plan.depth_dropout > 0.0 else None)

    def run_round(self, state, plan, participants, batch_plans, lr: float,
                  global_enc, server_online, collect: bool = False,
                  probe=None):
        """As ``SequentialEngine.run_round``: each local step is one batched
        step of all participants."""
        C = len(participants)
        tracer = self.obs.tracer
        with tracer.span("engine.dispatch", cat="engine", engine=self.name,
                         participants=C):
            with tracer.span("engine.inputs", cat="engine"):
                pool_idx, v1, v2, gates = self._round_inputs(
                    plan, participants, batch_plans)
            g = state["online"]
            cstate = {"online": {k: v.expand(C, *v.shape)
                                 for k, v in g.items()}}
            if "target" in state:
                # the target restarts from the downloaded model each round
                cstate["target"] = {k: g[k].expand(C, *g[k].shape)
                                    for k in state["target"]}
            align_w = self.ssl_cfg.align_weight if plan.align else 0.0

            def step(t, cstate, opt_state):
                with tracer.span("local_step", cat="step", t=t):
                    with tracer.span("step.views", cat="step"):
                        x1, x2 = two_views(self.images[pool_idx[t]],
                                           {f: v[t] for f, v in v1.items()},
                                           {f: v[t] for f, v in v2.items()})
                    with (probe if probe is not None and t == 0
                          else contextlib.nullcontext()):
                        out = client_mod.stacked_train_step(
                            cstate, opt_state, x1.unflatten(0, (C, -1)),
                            x2.unflatten(0, (C, -1)), lr,
                            encoder=self.encoder, ssl_cfg=self.ssl_cfg,
                            opt=self.opt, sub_layers=plan.sub_layers,
                            active_from=plan.active_from,
                            layer_gates=None if gates is None else gates[t],
                            global_enc=global_enc, align_weight=align_w,
                            tracer=tracer)
                if probe is not None and t == 0:
                    probe.samples = x1.shape[0]
                return out

            # unnamed: a name here would hold the first moments all round
            cstate, losses = padded_steps(
                step, cstate,
                client_mod.stacked_opt_init(self.opt, cstate["online"]),
                [len(b) for b in batch_plans])
            outs = [{k: v[c] for k, v in cstate["online"].items()}
                    for c in range(C)]
            result, stats = upload(
                self.transport, server_online, outs, list(participants),
                plan, state["online"], None if collect else
                aggregate.client_weights([self.counts[i]
                                          for i in participants]))
        return result, [float(x) for x in losses.tolist()], stats


def make_engine(name: str, *, batch_size: int, **kw):
    """The round engine ``name`` (one of ``ENGINES``); ``kw`` are the
    engines' shared constructor arguments."""
    if name == "sequential":
        return SequentialEngine(**kw)
    if name == "vmap":
        return VmapEngine(batch_size=batch_size, **kw)
    raise ValueError(f"unknown engine '{name}'; one of {ENGINES}")


# ---------------------------------------------------------------------------
# the LM family's engines
# ---------------------------------------------------------------------------
def lm_batch_plan(counts: Sequence[int], B: int, local_epochs: int):
    """The reference's batch-start rule (``train_lm``): the shard-local
    starts of a client's ``max(1, n // B) * local_epochs`` batches, a short
    one when its n samples are fewer than B."""
    return [[(b * B) % max(1, n - B)
             for b in range(max(1, n // B) * local_epochs)] for n in counts]


def lm_batch_indices(starts, B: int) -> torch.Tensor:
    """(C, T, B) shard-local indices of ``lm_batch_plan``'s batches; a
    client's steps past its own repeat its first batch."""
    T = max(map(len, starts))
    first = torch.tensor([s + [0] * (T - len(s)) for s in starts])
    return first[..., None] + torch.arange(B)


def lm_stacked_clients(params, pool, batch_idx, steps: Sequence[int], lr,
                       *, opt, **step_kw):
    """Every client's ``steps[c]`` local steps from the broadcast ``params``,
    batched (``client.lm_stacked_train_step`` with ``step_kw``) on ``pool``'s
    (C, n_max, ...) shards at ``batch_idx`` (C, T, B). Returns (the clients'
    trees, the (C,) losses of their last steps)."""
    C = len(steps)
    rows = torch.arange(C, device=batch_idx.device)[:, None]
    stacked = {k: v.expand(C, *v.shape) for k, v in params.items()}

    def step(t, p, o):
        batch = {k: v[rows, batch_idx[:, t]] for k, v in pool.items()}
        return client_mod.lm_stacked_train_step(p, o, batch, lr, opt=opt,
                                                **step_kw)

    stacked, losses = padded_steps(
        step, stacked, client_mod.stacked_opt_init(opt, stacked), steps)
    return [{k: v[c] for k, v in stacked.items()} for c in range(C)], losses


class LMSequentialEngine:
    """Each client's ``step`` (``client.lm_train_step``'s signature) over its
    batches in turn, each a ``local_step`` span (its ``t``). ``run_round``
    trains every client from the decoded ``broadcast`` under the round's
    ``local_train`` span (``_train``); returns (their FedAvg onto
    ``server`` through the wire, or with ``collect`` their decoded trees;
    their last losses; the upload stats)."""
    name = "sequential"

    def __init__(self, *, cfg, opt, tokens, labels, shards, batch_size: int,
                 local_epochs: int, transport, obs=None,
                 step=client_mod.lm_train_step):
        self.cfg, self.opt, self.step, self.B = cfg, opt, step, batch_size
        self.tokens, self.labels, self.shards = tokens, labels, list(shards)
        self.counts = [len(ix) for ix in self.shards]
        self.weights = aggregate.client_weights(self.counts)
        self.starts = lm_batch_plan(self.counts, batch_size, local_epochs)
        self.transport = transport
        self.obs = obs if obs is not None else NOOP_OBS

    def run_round(self, plan, broadcast, server, lr: float,
                  collect: bool = False):
        with self.obs.tracer.span("local_train", cat="fl", engine=self.name,
                                  clients=len(self.counts)):
            outs, losses = self._train(plan, broadcast, lr)
        result, stats = upload(self.transport, server, outs,
                               list(range(len(outs))), plan, broadcast,
                               None if collect else self.weights)
        return result, losses, stats

    def _train(self, plan, broadcast, lr: float):
        tracer, align = self.obs.tracer, plan.align
        outs, losses = [], []
        keys = client_mod.lm_step_leaves(broadcast, self.cfg, plan.sub_layers,
                                         plan.active_from)
        for ix, starts in zip(self.shards, self.starts):
            p_i = broadcast
            o_i = self.opt.init({k: broadcast[k] for k in keys})
            for t, start in enumerate(starts):
                sel = ix[start:start + self.B]
                with tracer.span("local_step", cat="step", t=t):
                    p_i, o_i, m = self.step(
                        p_i, o_i, {"tokens": self.tokens[sel],
                                   "labels": self.labels[sel]},
                        lr, cfg=self.cfg, opt=self.opt,
                        sub_layers=plan.sub_layers,
                        active_from=plan.active_from,
                        global_params=broadcast if align else None,
                        align_weight=ALIGN_WEIGHT if align else 0.0,
                        tracer=tracer)
            outs.append(p_i)
            losses.append(float(m["loss"]))
            del o_i
        return outs, losses


class LMVmapEngine(LMSequentialEngine):
    """The clients' steps batched (``lm_stacked_clients``)."""
    name = "vmap"

    def __init__(self, *, remat: bool = False, **kw):
        super().__init__(**kw)
        _check_shards(self.counts, self.B)
        self.remat = remat
        shards = [ix.cpu().numpy() for ix in self.shards]
        self.pool = {"tokens": stack_shards(self.tokens, shards)[0],
                     "labels": stack_shards(self.labels, shards)[0]}
        self.batch_idx = lm_batch_indices(self.starts, self.B).to(
            self.tokens.device)

    def _train(self, plan, broadcast, lr: float):
        outs, losses = lm_stacked_clients(
            broadcast, self.pool, self.batch_idx,
            [len(s) for s in self.starts], lr, opt=self.opt, cfg=self.cfg,
            sub_layers=plan.sub_layers, active_from=plan.active_from,
            global_params=broadcast if plan.align else None,
            align_weight=ALIGN_WEIGHT if plan.align else 0.0,
            remat=self.remat)
        return outs, losses.tolist()
