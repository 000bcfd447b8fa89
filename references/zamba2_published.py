"""Zamba2 at its published layout, in plain PyTorch and float32: the
forward pass, the next-token loss with LW-FedSSL's Eq. 3 alignment, and
autograd's gradients. It imports no kernel and nothing of the JAX package
or of its port; the tests hold both the port (``repro_torch``'s ``zamba2``
topology) and ``transformers``' ``Zamba2ForCausalLM`` to it.

The model (arXiv:2411.15242; ``transformers/models/zamba2``), x the
residual stream and e the token embedding, not scaled:

  layer l not in hybrid_layer_ids:  x <- x + Mamba2_l(RMSNorm_l(x))
  layer l, the i-th hybrid layer, shared block b = i mod num_mem_blocks:
      T = W_i MLP_{b,i}(RMSNorm_ff(Attn_b(RMSNorm_in([x, e]))))
      x <- x + Mamba2_l(RMSNorm_l(x + T))

with no residual inside the shared block. Attn_b: q, k, v from the 2 d
wide joined input, ``num_heads`` heads of ``head_dim``, causal, RoPE over
the whole head (split halves), q.k scaled by (head_dim / 2)^-0.5, o back
to d. MLP_{b,i}: [g, u] = h W_gu + (h A_i) B_i, then
down(gelu(g) u) with the exact GELU; A_i, B_i (rank ``adapter_rank``) and
W_i (d x d) belong to use i. Mamba2: in-projection to [z, x, B (G N), C (G
N), dt], a causal depthwise convolution of [x, B, C] and SiLU, dt =
softplus(dt + dt_bias), the SSD recurrence h_t = exp(dt_t A) h_{t-1} +
dt_t x_t B_t^T, y_t = C_t h_t + D x_t per head (head h reads group h //
(H / G)), the gated RMSNorm of y silu(z) over each group's d_inner / G
channels, and the out-projection. The logits are the final-normed stream
times the tied embedding.

Departures from upstream, each kept deliberately:
- dt is not clamped below at ``time_step_min`` (upstream's plain path
  clamps softplus(dt) at 0.001; at the port's initial dt_bias of -2,
  softplus is 0.127, and the tests set upstream's floor to 0).
- The initial values are the port's (``mamba2.CONSTANT_INIT``: D 1, A_log
  0, dt_bias -2; fan-in normal weights, the LoRA's B included), not
  upstream's; the tests load one set of weights into every model.
- The scan is the exact recurrence, one position at a time; upstream's
  plain path and the port compute the same sums chunk by chunk.
- No padding mask, cache or decoding; the sequence starts from zero state.
- Training is LW-FedSSL's (not upstream's): the layers of the first
  ``sub_stages`` stages of ``stage_layers`` layers are built, those of
  stages below ``active_from`` run without gradient (a shared block's use
  there too, even where another use of the block trains), and the loss is
  the mean next-token cross-entropy plus ``align_weight`` times InfoNCE
  (temperature ``tau``) between the mean-pooled final hidden states and
  those of the global model, which carries no gradient.

``cfg`` is a plain dict: d_model, num_heads, head_dim, d_ff, vocab_size,
num_layers, hybrid_layer_ids, num_mem_blocks, adapter_rank, stage_layers,
norm_eps, rope_theta, and ssm {state_dim, head_dim, expand,
conv_width, n_groups}. Parameters are a flat {path: tensor} dict at the
port's paths (``layout``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]


def exact_products() -> None:
    """float32 products in float32: no TF32 on a CUDA device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dims(cfg):
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    return s, di, di // s["head_dim"], s["n_groups"] * s["state_dim"]


def uses(cfg):
    """The hybrid layers that the config builds, in order."""
    return [l for l in cfg["hybrid_layer_ids"] if l < cfg["num_layers"]]


def layout(cfg) -> Dict[str, tuple]:
    """{path: shape}: the tied embedding, the final norm, each Mamba2 layer
    (``layers/<l>``), each use's LoRA and projection (``hybrid/<i>``) and
    each shared block (``mem_blocks/<b>``)."""
    d, V, f, r = (cfg["d_model"], cfg["vocab_size"], cfg["d_ff"],
                  cfg["adapter_rank"])
    s, di, H, GN = _dims(cfg)
    conv = di + 2 * GN
    w = cfg["num_heads"] * cfg["head_dim"]
    out = {"embed": (V, d), "final_ln/scale": (d,)}
    for l in range(cfg["num_layers"]):
        out.update({f"layers/{l}/{k}": v for k, v in {
            "ln/scale": (d,), "mamba/D": (H,), "mamba/a_log": (H,),
            "mamba/conv_b": (conv,), "mamba/conv_w": (s["conv_width"], conv),
            "mamba/dt_bias": (H,), "mamba/norm/scale": (di,),
            "mamba/w_in": (d, di + conv + H), "mamba/w_out": (di, d)}.items()})
    for i in range(len(uses(cfg))):
        out.update({f"hybrid/{i}/adapter_a": (d, r),
                    f"hybrid/{i}/adapter_b": (r, 2 * f),
                    f"hybrid/{i}/linear": (d, d)})
    for b in range(cfg["num_mem_blocks"]):
        out.update({f"mem_blocks/{b}/{k}": v for k, v in {
            "ln_in/scale": (2 * d,), "attn/wq": (2 * d, w),
            "attn/wk": (2 * d, w), "attn/wv": (2 * d, w), "attn/wo": (w, d),
            "ln_ff/scale": (d,), "mlp/w_gate": (d, f), "mlp/w_up": (d, f),
            "mlp/w_down": (f, d)}.items()})
    return out


def sub(tree: Tree, prefix: str) -> Tree:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tree.items() if k.startswith(prefix + "/")}


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta):
    """x (B, S, H, hd): split-half rotary embedding over positions 0..S-1
    (upstream's rotate_half with cos, sin of cat(freqs, freqs))."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: Tree, h, cfg):
    """Causal multi-head attention over the joined input h (B, S, 2 d)."""
    B, S, _ = h.shape
    H, hd = cfg["num_heads"], cfg["head_dim"]
    q = rope((h @ p["wq"]).reshape(B, S, H, hd), cfg["rope_theta"])
    k = rope((h @ p["wk"]).reshape(B, S, H, hd), cfg["rope_theta"])
    v = (h @ p["wv"]).reshape(B, S, H, hd)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * attn_scale(hd)
    keep = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    prob = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", prob, v).reshape(B, S, H * hd)
    return out @ p["wo"]


def shared_block(p: Tree, use: Tree, x, e, cfg):
    """T = W_i MLP_{b,i}(RMSNorm_ff(Attn_b(RMSNorm_in([x, e]))))."""
    eps, f = cfg["norm_eps"], cfg["d_ff"]
    a = attention(sub(p, "attn"), rmsnorm(torch.cat([x, e], dim=-1),
                                          p["ln_in/scale"], eps), cfg)
    h = rmsnorm(a, p["ln_ff/scale"], eps)
    gu = torch.cat([h @ p["mlp/w_gate"], h @ p["mlp/w_up"]], dim=-1) \
        + (h @ use["adapter_a"]) @ use["adapter_b"]
    g, u = gu[..., :f], gu[..., f:]
    return ((F.gelu(g) * u) @ p["mlp/w_down"]) @ use["linear"]


def ssd(x, dt, A, Bm, Cm):
    """The selective scan, position by position from a zero state. x (B,
    S, H, P); dt (B, S, H); A (H,); Bm, Cm (B, S, G, N). Returns y (B, S,
    H, P) without the D term."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[-2:]
    Bh = Bm.repeat_interleave(H // G, dim=2)             # (B, S, H, N)
    Ch = Cm.repeat_interleave(H // G, dim=2)
    h = x.new_zeros((Bsz, H, P, N))
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t] * A)[..., None, None] * h \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1)


def mamba2(p: Tree, u, cfg):
    """The Mamba2 mixer on its normed input u (B, S, d)."""
    s, di, H, GN = _dims(cfg)
    Bsz, S, _ = u.shape
    G, N, K = s["n_groups"], s["state_dim"], s["conv_width"]
    z, xbc, dt = torch.split(u @ p["w_in"], [di, di + 2 * GN, H], dim=-1)
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[:, k:k + S] * p["conv_w"][k] for k in range(K))
    xr, Bm, Cm = torch.split(F.silu(conv + p["conv_b"]), [di, GN, GN], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    xh = xr.reshape(Bsz, S, H, s["head_dim"])
    y = ssd(xh, dt, -torch.exp(p["a_log"]), Bm.reshape(Bsz, S, G, N),
            Cm.reshape(Bsz, S, G, N))
    y = (y + xh * p["D"][:, None]).reshape(Bsz, S, di) * F.silu(z)
    y = rmsnorm(y.reshape(Bsz, S, G, di // G),
                p["norm/scale"].reshape(G, di // G), cfg["norm_eps"])
    return y.reshape(Bsz, S, di) @ p["w_out"]


def hidden(params: Tree, tokens, cfg, *, sub_stages: Optional[int] = None,
           active_from: int = 0):
    """(B, S) tokens -> the final-normed stream (B, S, d) over the layers
    of the first ``sub_stages`` stages (all by default); those of stages
    below ``active_from`` under ``torch.no_grad()``."""
    per, eps = cfg["stage_layers"], cfg["norm_eps"]
    n = cfg["num_layers"] if sub_stages is None else \
        min(cfg["num_layers"], sub_stages * per)
    use_of = {l: i for i, l in enumerate(uses(cfg))}
    x = e = params["embed"][tokens]
    for l in range(n):
        frozen = l // per < active_from
        with torch.no_grad() if frozen else contextlib.nullcontext():
            p = sub(params, f"layers/{l}")
            t = 0.0
            if l in use_of:
                i = use_of[l]
                t = shared_block(
                    sub(params, f"mem_blocks/{i % cfg['num_mem_blocks']}"),
                    sub(params, f"hybrid/{i}"), x, e, cfg)
            x = x + mamba2(sub(p, "mamba"), rmsnorm(x + t, p["ln/scale"], eps),
                           cfg)
    return rmsnorm(x, params["final_ln/scale"], eps)


def logits(params: Tree, h):
    return h @ params["embed"].T


def info_nce(q, k, tau: float):
    """Mean over rows of logsumexp_j(q_i . k_j / tau) - q_i . k_i / tau over
    L2-normalised rows (in-batch negatives)."""
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                         min=1e-12)
    kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True),
                         min=1e-12)
    lg = qn @ kn.T / tau
    return torch.mean(torch.logsumexp(lg, dim=-1) - torch.diagonal(lg))


def lm_loss(params: Tree, tokens, labels, cfg, *,
            sub_stages: Optional[int] = None, active_from: int = 0,
            global_params: Optional[Tree] = None, align_weight: float = 0.01,
            tau: float = 0.2):
    """Mean next-token cross-entropy of the sub-model, plus, with
    ``global_params``, ``align_weight`` x InfoNCE between the mean-pooled
    final states of this model and of the global one (Eq. 3)."""
    exact_products()
    h = hidden(params, tokens, cfg, sub_stages=sub_stages,
               active_from=active_from)
    lg = logits(params, h)
    loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))
    if global_params is None:
        return loss
    with torch.no_grad():
        hg = hidden(global_params, tokens, cfg, sub_stages=sub_stages)
    return loss + align_weight * info_nce(h.mean(1), hg.mean(1), tau)


def stage_leaves(cfg, params: Tree, sub_stages: int,
                 active_from: int) -> list:
    """The leaves LW-FedSSL trains at a stage built to ``sub_stages`` with
    the stages below ``active_from`` frozen: the final norm, the embedding
    when nothing is frozen, the Mamba2 layers of the trained stages, and
    the uses and shared blocks that those stages' hybrid layers hold."""
    per = cfg["stage_layers"]

    def trained(l):
        return active_from <= l // per < sub_stages
    use_layers = uses(cfg)
    out = ["final_ln/scale"] + (["embed"] if active_from == 0 else [])
    for k in params:
        kind, _, rest = k.partition("/")
        if kind == "layers":
            ok = trained(int(rest.split("/")[0]))
        elif kind == "hybrid":
            ok = trained(use_layers[int(rest.split("/")[0])])
        elif kind == "mem_blocks":
            b = int(rest.split("/")[0])
            ok = any(trained(l) for i, l in enumerate(use_layers)
                     if i % cfg["num_mem_blocks"] == b)
        else:
            continue
        if ok:
            out.append(k)
    return out


def loss_and_grads(params: Tree, keys: Iterable[str], tokens, labels, cfg,
                   **kw):
    """(the loss, {leaf: its gradient}) for the leaves ``keys``."""
    keys = list(keys)
    p = dict(params)
    p.update({k: params[k].detach().requires_grad_() for k in keys})
    loss = lm_loss(p, tokens, labels, cfg, **kw)
    gs = torch.autograd.grad(loss, [p[k] for k in keys], allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p[k]) if g is None else g
                           for k, g in zip(keys, gs)}


def adamw(params: Tree, grads: Tree, state: dict, lr: float, *, b1=0.9,
          b2=0.999, eps=1e-8, weight_decay=1e-5):
    """One AdamW step of the leaves in ``grads`` (decoupled decay inside
    the update; bias corrections in float32). ``state``: {"mu", "nu",
    "count"}, empty to start."""
    c = state.get("count", 0) + 1
    f32 = torch.float32
    bc1 = float(1 - torch.tensor(b1, dtype=f32) ** c)
    bc2 = float(1 - torch.tensor(b2, dtype=f32) ** c)
    mu, nu, new = {}, {}, dict(params)
    for k, g in grads.items():
        m = b1 * state.get("mu", {}).get(k, torch.zeros_like(g)) + (1 - b1) * g
        v = b2 * state.get("nu", {}).get(k, torch.zeros_like(g)) \
            + (1 - b2) * g * g
        new[k] = params[k] - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                                   + weight_decay * params[k])
        mu[k], nu[k] = m, v
    return new, {"mu": mu, "nu": nu, "count": c}


def fl_round(params: Tree, shards, tokens, labels, cfg, *, stage: int,
             lr: float, batch: int, weight_transfer: bool = True,
             new_stage: bool = False, **opt):
    """One LW-FedSSL round at ``stage`` (1-based): weight transfer at a new
    stage's start (the Mamba2 layers of stage - 1 into those of stage),
    then each client's AdamW steps over its shard from the server's model,
    aligned with it, and FedAvg weighted by shard size. Returns (the new
    model, the clients' last losses)."""
    per = cfg["stage_layers"]
    if new_stage and weight_transfer and stage > 1:
        params = dict(params)
        for l in range((stage - 1) * per, min(stage * per, cfg["num_layers"])):
            for k in list(params):
                if k.startswith(f"layers/{l - per}/"):
                    params[f"layers/{l}/" + k[len(f"layers/{l - per}/"):]] = \
                        params[k].clone()
    keys = stage_leaves(cfg, params, stage, stage - 1)
    outs, losses = [], []
    for ix in shards:
        q, st = params, {}
        for b in range(max(1, len(ix) // batch)):
            sel = ix[(b * batch) % max(1, len(ix) - batch):][:batch]
            loss, g = loss_and_grads(q, keys, tokens[sel], labels[sel], cfg,
                                     sub_stages=stage, active_from=stage - 1,
                                     global_params=params)
            q, st = adamw(q, g, st, lr, **opt)
        outs.append(q)
        losses.append(float(loss))
    w = torch.tensor([len(ix) for ix in shards], dtype=torch.float32)
    w = w / w.sum()
    new = dict(params)
    for k in keys:
        new[k] = sum(wi * o[k] for wi, o in zip(w, outs))
    return new, losses


def from_hf(state: Dict[str, torch.Tensor], cfg) -> Tree:
    """The weights of a ``transformers`` ``Zamba2ForCausalLM`` state dict at
    this module's paths (its linear weights transposed to (in, out), the
    convolution's to (K, C), the gate-up product split into gate and up)."""
    f = cfg["d_ff"]
    sd = {k.removeprefix("model."): v.detach().to(torch.float32)
          for k, v in state.items()}
    out = {"embed": sd["embed_tokens.weight"],
           "final_ln/scale": sd["final_layernorm.weight"]}
    use_of = {l: i for i, l in enumerate(uses(cfg))}
    for l in range(cfg["num_layers"]):
        hy = l in use_of
        m = f"layers.{l}.mamba_decoder." if hy else f"layers.{l}."
        p = f"layers/{l}/"
        out.update({
            p + "ln/scale": sd[m + "input_layernorm.weight"],
            p + "mamba/w_in": sd[m + "mamba.in_proj.weight"].T,
            p + "mamba/w_out": sd[m + "mamba.out_proj.weight"].T,
            p + "mamba/conv_w": sd[m + "mamba.conv1d.weight"][:, 0].T,
            p + "mamba/conv_b": sd[m + "mamba.conv1d.bias"],
            p + "mamba/dt_bias": sd[m + "mamba.dt_bias"],
            p + "mamba/a_log": sd[m + "mamba.A_log"],
            p + "mamba/D": sd[m + "mamba.D"],
            p + "mamba/norm/scale": sd[m + "mamba.norm.weight"]})
        if not hy:
            continue
        i = use_of[l]
        s = f"layers.{l}.shared_transformer."
        ad = f"{s}feed_forward.gate_up_proj_adapter_list.{i}."
        out.update({
            f"hybrid/{i}/linear": sd[f"layers.{l}.linear.weight"].T,
            f"hybrid/{i}/adapter_a": sd[ad + "0.weight"].T,
            f"hybrid/{i}/adapter_b": sd[ad + "1.weight"].T})
        b = f"mem_blocks/{i % cfg['num_mem_blocks']}/"
        gu = sd[s + "feed_forward.gate_up_proj.weight"].T
        out.update({
            b + "ln_in/scale": sd[s + "input_layernorm.weight"],
            b + "ln_ff/scale": sd[s + "pre_ff_layernorm.weight"],
            b + "attn/wq": sd[s + "self_attn.q_proj.weight"].T,
            b + "attn/wk": sd[s + "self_attn.k_proj.weight"].T,
            b + "attn/wv": sd[s + "self_attn.v_proj.weight"].T,
            b + "attn/wo": sd[s + "self_attn.o_proj.weight"].T,
            b + "mlp/w_gate": gu[:, :f], b + "mlp/w_up": gu[:, f:],
            b + "mlp/w_down": sd[s + "feed_forward.down_proj.weight"].T})
    return {k: out[k].contiguous() for k in layout(cfg)}


def attn_scale(head_dim: int) -> float:
    """Upstream's q.k scale, (head_dim / 2)^-0.5."""
    return 1.0 / math.sqrt(head_dim / 2)
