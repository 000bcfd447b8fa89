"""Plain PyTorch pieces shared by the references: the precision of the
products, RMSNorm, RoPE, attention, InfoNCE, the masked AdamW, the
learning rate, FedAvg and the stage transfer.

Each follows the port's semantics (``repro_torch``: ``layers/norms.py``,
``layers/rope.py``, ``kernels/ref.py``, ``core/losses.py``,
``optim/optimizers.py``, ``optim/schedules.py``, ``federated/masks.py``,
``core/schedule.py``) written out again; nothing here imports the program.
Everything runs in float32 except the products that the configuration
computes in its compute dtype, which go through ``Numerics.mm``.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]

FP8_MAX = 448.0     # largest finite float8_e4m3fn


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest value, and back to x's dtype
    (fp8 training's rounding of a product's operands); the gradient passes
    through the rounding as it is."""
    with torch.no_grad():
        amax = x.abs().amax().float().clamp(min=1e-12)
        s = FP8_MAX / amax
        q = ((x.float() * s).to(torch.float8_e4m3fn).float() / s).to(x.dtype)
    return x + (q - x).detach()


class Numerics:
    """The products of a configuration's compute dtype. ``control``
    rounds both operands of each such product to fp8 first: the precision
    below bf16 that the control of ``correct`` computes in."""

    def __init__(self, compute_dtype: str, control: bool = False):
        self.cdt = getattr(torch, compute_dtype)
        self.control = control

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.to(self.cdt), b.to(self.cdt)
        if self.control:
            a, b = _fp8(a), _fp8(b)
        return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding over positions 0..S-1; x (B, S, H, hd),
    fp32 math, output in x's dtype."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def attention(q, k, v, causal: bool) -> torch.Tensor:
    """q, k, v (B, S, H, hd) with equal head counts -> (B, S, H, hd) in q's
    dtype; fp32 logits, softmax and p.v."""
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    logits = (qf @ kf.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        S = q.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return (p @ vf).transpose(1, 2).to(q.dtype)


def self_attention(p: Tree, x: torch.Tensor, cfg, num: Numerics,
                   causal: bool) -> torch.Tensor:
    B, S, _ = x.shape
    H, hd = cfg["num_heads"], cfg["head_dim"] or cfg["d_model"] // \
        cfg["num_heads"]
    if cfg["num_kv_heads"] != H:
        raise ValueError("the references take equal q and kv head counts")
    q = num.mm(x, p["wq"]).reshape(B, S, H, hd)
    k = num.mm(x, p["wk"]).reshape(B, S, H, hd)
    v = num.mm(x, p["wv"]).reshape(B, S, H, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    out = attention(q, k, v, causal)
    return num.mm(out.reshape(B, S, H * hd), p["wo"]).to(x.dtype)


def mlp(p: Tree, x: torch.Tensor, act: str, num: Numerics) -> torch.Tensor:
    up = num.mm(x, p["w_up"])
    if act == "swiglu":
        h = F.silu(num.mm(x, p["w_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return num.mm(h, p["w_down"]).to(x.dtype)


def info_nce(q: torch.Tensor, k: torch.Tensor, tau: float) -> torch.Tensor:
    """Mean over rows of logsumexp_j(q_i.k_j / tau) - q_i.k_i / tau over
    L2-normalised rows, fp32 (in-batch negatives)."""
    def unit(t):
        t = t.to(torch.float32)
        return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1,
                                                        keepdim=True),
                               min=1e-12)
    logits = unit(q) @ unit(k).transpose(-1, -2) / tau
    return torch.mean(torch.logsumexp(logits, dim=-1)
                      - torch.diagonal(logits, dim1=-2, dim2=-1))


def learning_rate(step: int, total: int, base_lr: float) -> float:
    """One cosine decay over the whole run, in float32."""
    f32 = np.float32
    t = np.clip(f32(step) / max(f32(1.0), f32(total)), f32(0.0), f32(1.0))
    return float(f32(base_lr) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t)))


STACKS = ("blocks",)
EMBEDS = ("embed", "patch", "pos", "cls", "lm_head")


def leaf_kind(path: str) -> str:
    keys = path.split("/")
    if any(k in STACKS for k in keys):
        return "stacked"
    if any(k in EMBEDS for k in keys):
        return "embed"
    return "other"


def update_mask(params: Tree, sub: int, active_from: int, lead: int = 0
                ) -> Tree:
    """1 where the stage trains, 0 where it is frozen: the stacked rows
    [active_from, sub), the embeddings only when the prefix trains, all
    the rest. ``lead`` leading (client) dims come before the stage dim."""
    out = {}
    for k, t in params.items():
        kind = leaf_kind(k)
        if kind == "stacked":
            n = t.shape[lead]
            i = torch.arange(n, device=t.device)
            m = ((i >= active_from) & (i < sub)).to(torch.float32)
            out[k] = m.reshape((n,) + (1,) * (t.dim() - lead - 1))
        else:
            on = kind != "embed" or active_from == 0
            out[k] = torch.tensor(1.0 if on else 0.0, device=t.device)
    return out


class AdamW:
    """AdamW with decoupled weight decay inside the update and a per-leaf
    mask over the whole update; bias corrections and the rate in fp32."""

    def __init__(self, b1, b2, eps, weight_decay):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params: Tree) -> dict:
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": 0}

    def update(self, grads: Tree, state: dict, params: Tree, lr: float,
               mask: Tree):
        c = state["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(c))
        bc2 = float(f32(1) - f32(self.b2) ** f32(c))
        lr = float(f32(lr))
        mu, nu, new = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m = self.b1 * state["mu"][k] + (1 - self.b1) * g
            v = self.b2 * state["nu"][k] + (1 - self.b2) * torch.square(g)
            u = -lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                       + self.wd * p)
            mu[k], nu[k] = m, v
            new[k] = p + u * mask[k]
        return new, {"mu": mu, "nu": nu, "count": c}


def fedavg(trees, weights) -> Tree:
    """Weighted mean of the clients' trees in fp32; ``weights`` sum to
    one. Leaves no client changed come out as they went in."""
    out = {}
    for k in trees[0]:
        s = torch.stack([t[k] for t in trees])
        w = torch.tensor(weights, dtype=torch.float32, device=s.device)
        out[k] = torch.sum(s * w.reshape((-1,) + (1,) * (s.dim() - 1)),
                           dim=0)
    return out


def client_weights(counts):
    w = np.asarray(counts, np.float32)
    return (w / w.sum(dtype=np.float32)).tolist()


def transfer(tree: Tree, stage: int, prefix: str = "") -> Tree:
    """Weight transfer at a stage's start: row ``stage - 2`` of every
    block stack copied into row ``stage - 1``."""
    if stage < 2:
        return tree
    out = {}
    for k, t in tree.items():
        if k.startswith(prefix + "blocks/"):
            t = t.clone()
            t[stage - 1] = t[stage - 2]
        out[k] = t
    return out


class Plan(NamedTuple):
    """What a round does under a schedule (the port's ``RoundPlan``
    fields that the references read)."""
    stage: int
    sub_layers: int
    active_from: int
    new_stage: bool
    align: bool
    server_calibrate: bool


def round_plan(schedule: str, stage: int, j: int, num_stages: int) -> Plan:
    """Round ``j`` of ``stage``: LW-FedSSL trains stage s's block with the
    s - 1 below it frozen, aligns with the global model and calibrates on
    the server; e2e trains everything, every round."""
    if schedule == "lw_fedssl":
        return Plan(stage, stage, stage - 1, j == 0, True, True)
    if schedule == "e2e":
        return Plan(num_stages, num_stages, 0, False, False, False)
    raise ValueError(f"the references run lw_fedssl and e2e, not "
                     f"'{schedule}'")
