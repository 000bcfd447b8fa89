"""Self-supervised learning engines: MoCo v3 (the paper's default), SimCLR
and BYOL, with representation alignment (``repro.core.ssl``; Algorithm 2
of the paper), and the LM family's SSL loss (``lm_ssl_loss``: next-token
prediction plus the same alignment).

State layout, flat dicts keyed by the reference's key paths:

    {"online": {"enc/...", "pred/...", "proj/..."},
     "target": {"enc/...", "proj/..."}}

SimCLR has neither the prediction head nor the target branch
(``{"online": {"enc/...", "proj/..."}}``); BYOL has both, as MoCo v3 does.
The target branch and the alignment loss's global encoder run under
``torch.no_grad()``: the reference never differentiates them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.convert import prefixed, subtree
from repro_torch.core import heads, losses
from repro_torch.federated.leaves import tree_sorted
from repro_torch.models import lm as lm_mod
from repro_torch.models import vit as vit_mod
from repro_torch.obs.trace import NOOP_TRACER

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Encoder:
    init: Callable[..., Tree]     # (generator, device) -> flat params
    apply: Callable[..., torch.Tensor]  # (params, x, sub_layers,
    #                                      active_from, layer_gates) -> (B, d)
    d_repr: int
    num_stages: int


def make_vit_encoder(cfg, image_size: int = 32,
                     patch_size: int = 4) -> Encoder:
    model = vit_mod.ViT(cfg, image_size, patch_size)    # meta: shapes only

    def init(generator=None, device="cpu") -> Tree:
        return vit_mod.init_vit(cfg, generator, device, image_size,
                                patch_size)

    def apply(params, x, sub_layers=None, active_from=0, layer_gates=None):
        return model.apply(params, x, sub_layers=sub_layers,
                           active_from=active_from, layer_gates=layer_gates)

    return Encoder(init, apply, cfg.d_model, cfg.num_layers)


METHODS = ("moco_v3", "simclr", "byol")
# the methods with a prediction head and a momentum target branch
TARGET_METHODS = ("moco_v3", "byol")


def ssl_init(encoder: Encoder, ssl_cfg, generator=None, device="cpu"):
    """A fresh state; the target branch (moco_v3, byol) starts as a copy of
    the online encoder and projection head."""
    if ssl_cfg.method not in METHODS:
        raise ValueError(ssl_cfg.method)
    enc = encoder.init(generator, device)
    proj = heads.init_head(heads.proj_dims(encoder.d_repr,
                                           ssl_cfg.proj_hidden,
                                           ssl_cfg.proj_dim),
                           generator, device)
    online = {**prefixed("enc", enc), **prefixed("proj", proj)}
    if ssl_cfg.method not in TARGET_METHODS:
        return {"online": tree_sorted(online)}
    pred = heads.init_head(heads.pred_dims(ssl_cfg.proj_dim,
                                           ssl_cfg.pred_hidden,
                                           ssl_cfg.proj_dim),
                           generator, device)
    online = tree_sorted({**online, **prefixed("pred", pred)})
    target = tree_sorted({k: v.clone() for k, v in online.items()
                          if not k.startswith("pred/")})
    return {"online": online, "target": target}


def momentum_update(state, mu: float):
    """target <- mu * target + (1 - mu) * online (Algorithm 2, line 15);
    a state with no target branch (simclr) is returned as it is."""
    if "target" not in state:
        return state
    o = state["online"]
    target = {k: mu * t + (1.0 - mu) * o[k].to(t.dtype)
              for k, t in state["target"].items()}
    return {**state, "target": target}


def _branch(enc, proj, pred, x, encoder: Encoder, sub_layers, active_from,
            layer_gates=None):
    z = encoder.apply(enc, x, sub_layers, active_from, layer_gates)
    p = heads.head_apply(proj, z)
    if pred is not None:
        p = heads.head_apply(pred, p)
    return z, p


def ssl_loss(state, x1, x2, encoder: Encoder, ssl_cfg, *,
             sub_layers: Optional[int] = None, active_from: int = 0,
             layer_gates=None, global_enc: Optional[Tree] = None,
             align_weight: float = 0.0):
    """Local SSL loss for a pair of views (Algorithm 2, lines 6-13).
    Returns (loss, metrics). ``global_enc`` (the broadcast global encoder)
    is needed only when ``align_weight > 0`` (alignment, Eq. 3)."""
    method = ssl_cfg.method
    if method not in METHODS:
        raise ValueError(method)
    tau = ssl_cfg.temperature
    o = state["online"]
    enc, proj = subtree(o, "enc"), subtree(o, "proj")
    pred = subtree(o, "pred") if method in TARGET_METHODS else None
    z1, q1 = _branch(enc, proj, pred, x1, encoder, sub_layers, active_from,
                     layer_gates)
    z2, q2 = _branch(enc, proj, pred, x2, encoder, sub_layers, active_from,
                     layer_gates)
    if method == "simclr":
        loss = losses.simclr_nt_xent(q1, q2, tau)
    else:
        t = state["target"]
        t_enc, t_proj = subtree(t, "enc"), subtree(t, "proj")
        frozen = sub_layers or encoder.num_stages
        with torch.no_grad():
            _, k1 = _branch(t_enc, t_proj, None, x1, encoder, sub_layers,
                            frozen)
            _, k2 = _branch(t_enc, t_proj, None, x2, encoder, sub_layers,
                            frozen)
        if method == "moco_v3":
            loss = losses.moco_contrastive(q1, k2, q2, k1, tau)
        else:
            loss = losses.byol_regression(q1, k2) + \
                losses.byol_regression(q2, k1)
    metrics = {"con": loss}
    if align_weight > 0.0:
        if global_enc is None:
            raise ValueError("alignment needs the global encoder")
        with torch.no_grad():
            zg1 = encoder.apply(global_enc, x1, sub_layers, 0)
            zg2 = encoder.apply(global_enc, x2, sub_layers, 0)
        la = losses.align_loss(z1, zg2, z2, zg1, tau)
        loss = loss + align_weight * la
        metrics["align"] = la
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# LM-family SSL: next-token prediction + representation alignment
# ---------------------------------------------------------------------------
def lm_ssl_loss(params: Tree, batch, cfg, *, sub_layers=None,
                active_from: int = 0, global_params: Optional[Tree] = None,
                align_weight: float = 0.0, tau: float = 0.2,
                remat: bool = False, tracer=NOOP_TRACER):
    """Next-token cross-entropy over the stage-s sub-model, plus the
    paper's Eq. 3 alignment between the local and the global model's
    mean-pooled hidden states when ``align_weight > 0``. A batch may carry
    ``frontend`` (B, P, d) embeddings (the VLM stub), put ahead of the
    tokens; the first P hidden positions are dropped before the
    cross-entropy and kept in the pooled states. The global model's forward
    runs under ``torch.no_grad()`` (the reference stops its gradient); the
    alignment is ``losses.info_nce``. ``remat`` recomputes each trained
    block in the backward; ``tracer`` goes to both forwards. Returns
    (loss, metrics)."""
    frontend = batch.get("frontend")
    x = lm_mod.embed(params, batch["tokens"], cfg, frontend)
    hidden, aux = lm_mod.forward_hidden(params, x, cfg,
                                        sub_layers=sub_layers,
                                        active_from=active_from, remat=remat,
                                        tracer=tracer)
    P = 0 if frontend is None else frontend.shape[1]
    xent = lm_mod.xent_loss(params, hidden[:, P:] if P else hidden,
                            batch["labels"], cfg, batch.get("mask"))
    loss = xent + aux
    metrics = {"xent": xent, "aux": aux}
    if align_weight > 0.0 and global_params is not None:
        z_local = torch.mean(hidden.to(torch.float32), dim=1)
        with torch.no_grad():
            xg = lm_mod.embed(global_params, batch["tokens"], cfg, frontend)
            hg, _ = lm_mod.forward_hidden(global_params, xg, cfg,
                                          sub_layers=sub_layers,
                                          active_from=0, tracer=tracer)
            z_global = torch.mean(hg.to(torch.float32), dim=1)
        la = losses.info_nce(z_local, z_global, tau)
        loss = loss + align_weight * la
        metrics["align"] = la
    metrics["loss"] = loss
    return loss, metrics
