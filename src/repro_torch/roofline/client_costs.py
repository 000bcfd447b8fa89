"""Analytical per-client resource model (the paper's accounting, Appendix
A.1; ``repro.roofline.client_costs``).

FLOPs: forward FLOPs per single input sample (fvcore-style dense counts);
backward = 2x forward of the *trainable* portion (2:1 ratio).
Memory: parameters + optimizer moments of the trainable portion +
activation footprint of layers that participate in backward (+ a single
transient layer buffer for the frozen forward prefix).
Communication: byte counts of the parameter tree sliced by the round plan
(``repro_torch.federated.comm``).

All quantities come from the ViT config and the MoCo v3 head widths, so
the paper's Table 1/3 ratios are structural predictions; the port's
measured counterparts are ``repro_torch.obs.resources`` and ``python -m
repro_torch.launch.trace --paper-table``. The arithmetic is the
reference's; the parameter tree is built on the ``meta`` device (shapes
only, nothing allocated) in place of ``jax.eval_shape``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import FLConfig, SSLConfig, load_arch
from repro_torch.convert import subtree
from repro_torch.core import schedule as sched
from repro_torch.federated import comm

BYTES_F32 = 4

# paper Table 3 cost columns (memory, flops, comm) vs FedMoCo
PAPER_MULT = {"e2e": (1.00, 1.00, 1.00), "layerwise": (0.25, 0.35, 0.08),
              "lw_fedssl": (0.30, 0.48, 0.31),
              "progressive": (1.00, 0.57, 0.54),
              "fll_dd": (0.62, 0.36, 0.08)}
SCHEDULE_NAMES = {"e2e": "FedMoCo", "layerwise": "FedMoCo-LW",
                  "lw_fedssl": "LW-FedSSL", "progressive": "Prog-FedSSL",
                  "fll_dd": "FLL+DD"}


# ---------------------------------------------------------------------------
# per-component forward FLOPs / activation floats (ViT + MoCo v3 heads)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class VitCosts:
    tokens: int
    d: int
    d_ff: int
    heads: int
    layers: int
    proj_hidden: int
    proj_dim: int
    pred_hidden: int

    @property
    def f_stem(self):
        return 2 * self.tokens * 48 * self.d            # patch proj (4x4x3)

    @property
    def f_block(self):
        t, d = self.tokens, self.d
        attn = 2 * t * d * (3 * d) + 2 * t * t * d * 2 + 2 * t * d * d
        mlp = 2 * t * d * self.d_ff * 2
        return attn + mlp

    @property
    def f_proj(self):
        return 2 * (self.d * self.proj_hidden
                    + self.proj_hidden * self.proj_hidden
                    + self.proj_hidden * self.proj_dim)

    @property
    def f_pred(self):
        return 2 * (self.proj_dim * self.pred_hidden
                    + self.pred_hidden * self.proj_dim)

    @property
    def a_block(self):
        """Activation floats per sample per block (residuals, qkv, attn
        matrices, mlp hidden) — what backward must keep."""
        t, d = self.tokens, self.d
        return t * d * (3 + 1 + 2 + 2) + 2 * self.heads * t * t \
            + 2 * t * self.d_ff

    @property
    def a_stem(self):
        return 2 * self.tokens * self.d

    @property
    def a_heads(self):
        return 2 * (self.proj_hidden * 2 + self.proj_dim) \
            + (self.pred_hidden + self.proj_dim)


def vit_costs(cfg=None, ssl=None) -> VitCosts:
    cfg = cfg or load_arch("vit-tiny")
    ssl = ssl or SSLConfig()
    return VitCosts(tokens=65, d=cfg.d_model, d_ff=cfg.d_ff,
                    heads=cfg.num_heads, layers=cfg.num_layers,
                    proj_hidden=ssl.proj_hidden, proj_dim=ssl.proj_dim,
                    pred_hidden=ssl.pred_hidden)


# ---------------------------------------------------------------------------
# per-round client costs by schedule
# ---------------------------------------------------------------------------
def flops_per_sample_round(c: VitCosts, plan) -> float:
    """MoCo v3 local step FLOPs for one sample in one round (2 views)."""
    s, act = plan.sub_layers, plan.active_from
    fwd_frozen = c.f_stem + act * c.f_block
    fwd_active = (s - act) * c.f_block + c.f_proj + c.f_pred
    online = 2 * (fwd_frozen + fwd_active)              # 2 views
    target = 2 * (c.f_stem + s * c.f_block + c.f_proj)  # EMA branch, fwd only
    bwd = 2 * 2 * fwd_active                            # 2:1 ratio, 2 views
    total = online + target + bwd
    if plan.align:
        total += 2 * (c.f_stem + s * c.f_block)         # global model fwd
    return total


def memory_bytes(c: VitCosts, plan, batch: int,
                 params_bytes_total: int) -> float:
    """Peak local-training memory (paper Fig. 5a / Fig. 6b)."""
    s, act = plan.sub_layers, plan.active_from
    frac_params = (c.f_stem / c.f_block + s) / (c.f_stem / c.f_block
                                                + c.layers)
    p_bytes = params_bytes_total * frac_params
    p_bytes *= 2                                        # online + target
    opt_bytes = 2 * params_bytes_total * (s - act) / c.layers  # AdamW moments
    acts = (c.a_stem + (s - act) * c.a_block + c.a_heads) * batch * BYTES_F32
    acts += c.a_block * batch * BYTES_F32 * (1 if act > 0 else 0)  # transient
    if plan.align:
        acts += c.a_stem * batch * BYTES_F32            # global rep buffers
    return p_bytes + opt_bytes + acts


def build_ssl_param_tree(cfg=None, ssl=None):
    """The SSL state ``{"online": {...}, "target": {...}}`` of flat
    ``{path: tensor}`` trees on the ``meta`` device: shapes and dtypes
    only, for byte accounting."""
    from repro_torch.core import ssl as ssl_mod
    cfg = cfg or load_arch("vit-tiny")
    ssl = ssl or SSLConfig()
    return ssl_mod.ssl_init(ssl_mod.make_vit_encoder(cfg), ssl, None, "meta")


def schedule_costs(schedule: str, *, rounds: int = 180, batch: int = 1024,
                   local_epochs: int = 3, cfg=None, ssl=None,
                   depth_dropout: float = 0.5,
                   stage_allocation: str = "uniform"):
    """Returns dict with total flops/sample, peak memory, comm bytes and
    the per-round series — everything Table 1/3 + Fig. 5 need."""
    cfg = cfg or load_arch("vit-tiny")
    c = vit_costs(cfg, ssl)
    fl = FLConfig(rounds=rounds, schedule=schedule,
                  depth_dropout=depth_dropout,
                  stage_allocation=stage_allocation)
    plans = sched.build_schedule(fl, cfg.num_layers)
    state = build_ssl_param_tree(cfg, ssl)
    enc_tree = subtree(state["online"], "enc")
    params_bytes_total = comm.tree_bytes(enc_tree)

    flops, mem, down, up = [], [], [], []
    for p in plans:
        f = flops_per_sample_round(c, p) * local_epochs
        if p.depth_dropout > 0:
            # frozen-prefix forward cost drops proportionally
            saved = p.depth_dropout * p.active_from * c.f_block
            f -= (2 + 2) * saved * local_epochs
        flops.append(f)
        mem.append(memory_bytes(c, p, batch, params_bytes_total))
        cb = comm.round_comm_bytes(enc_tree, p, include_heads=False)
        down.append(cb["download"])
        up.append(cb["upload"])
    return {
        "schedule": schedule,
        "flops_total": float(np.sum(flops)),
        "peak_memory": float(np.max(mem)),
        "download_total": int(np.sum(down)),
        "upload_total": int(np.sum(up)),
        "comm_total": int(np.sum(down) + np.sum(up)),
        "series": {"flops": flops, "memory": mem, "download": down,
                   "upload": up,
                   "stage": [p.stage for p in plans]},
    }
