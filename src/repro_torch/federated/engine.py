"""The sequential round engine (``repro.federated.engine.SequentialEngine``):
a Python loop over the round's participants, each running its local
training, then FedAvg over the decoded uploads. The vectorised engine comes
with a later slice."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.federated import aggregate, client as client_mod


class SequentialEngine:
    name = "sequential"

    def __init__(self, *, encoder, ssl_cfg, opt, fl, images: torch.Tensor,
                 client_indices: Sequence[torch.Tensor], transport, draws):
        self.encoder, self.ssl_cfg, self.opt = encoder, ssl_cfg, opt
        self.fl, self.images = fl, images
        self.client_indices = list(client_indices)
        self.counts = [len(ix) for ix in self.client_indices]
        self.transport, self.draws = transport, draws

    def run_round(self, state, plan, participants, batch_plans, lr: float,
                  global_enc, server_online):
        """Train ``participants`` from the broadcast ``state`` along their
        ``batch_plans``; returns (aggregated online tree, per-client last
        losses, upload stats). The participants' indices are the client
        ids of the transport's error-feedback residuals, and the broadcast
        tree is the reference its delta codecs subtract."""
        outs, losses = [], []
        for i, bplan in zip(participants, batch_plans):
            online_i, m = client_mod.local_train(
                state, self.images[self.client_indices[i]], bplan,
                self.draws, self.opt, encoder=self.encoder,
                ssl_cfg=self.ssl_cfg, lr=lr, sub_layers=plan.sub_layers,
                active_from=plan.active_from, align=plan.align,
                depth_dropout=plan.depth_dropout, global_enc=global_enc)
            outs.append(online_i)
            losses.append(m["loss"])
        w = aggregate.client_weights([self.counts[i] for i in participants])
        new_online, stats = self.transport.aggregate_uploads(
            server_online, outs, list(participants), plan, w,
            ref_online=state["online"])
        return new_online, [float(x) for x in losses], stats
