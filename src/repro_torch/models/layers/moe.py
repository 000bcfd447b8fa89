"""Mixture-of-Experts FFN (``repro.models.layers.moe``) and its dispatch
(``repro.models.blocks._moe_ffn``, here ``moe_ffn``).

A router scores each token against the E routed experts; a token goes to
its top-k experts with the renormalised router weights; each expert takes
at most ``cap`` tokens of each batch row (per-sample capacity, the
highest-weighted first; the rest are dropped) and computes a SwiGLU over
them; the weighted expert outputs are added back at their tokens, and the
shared experts (one SwiGLU of width ``num_shared_experts * d_ff_expert``)
add to every token. A single token a row (S == 1, decode) runs every
expert densely and combines them with the same weights. The load-balance
loss is ``E * sum_e(frac_e * mean_p_e) * router_aux_loss`` (GShard /
Switch), with frac_e the share of top-k slots routed to e.

Parity with the JAX package:
- ties: both selections (the top-k experts of a token, the top-``cap``
  tokens of an expert) take the lowest index among equal values, as
  ``jax.lax.top_k`` does: a stable descending sort, then a slice
  (``torch.topk`` promises no order among ties, and with top-1 routing
  every routed token's weight is exactly 1.0);
- order: the dispatch is one gather per expert and the combine one scatter
  of distinct rows per expert, summed over the experts in order, so no
  row is added to by atomics in any order: the forward and the backward
  repeat to the bit on the card;
- ``torch.func``: everything is out of place and vmap-able (the one-hot is
  a comparison with an arange), so the LM vmap engine runs it.
The per-expert products are batched ``torch.einsum``s, as the reference's
are plain jnp products outside any Pallas kernel.

Expert parallelism: ``moe_ffn_local`` is the reference's one shard of an
expert layer (``repro/models/layers/moe.py:52``, called by no code of the
JAX package): the shard holds ``e_local`` experts from ``e_first`` on and
the weights' expert dim is that slice; it routes all T tokens of its data
shard over the full router, takes each local expert's top-``cap`` tokens
(``capacity``) and returns its partial output, which the caller sums over
the expert shards, with the load-balance loss over the full router output
(the same on every shard) and the count of routed slots it dropped. Its
combine is a scatter of distinct rows per expert, summed in order, as in
``moe_ffn``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# router weights start at a tenth of the fan-in scale (``moe_init``)
INIT_SCALE = {"router": 0.1}


def moe_shapes(cfg) -> Dict[str, tuple]:
    """Per-layer leaf shapes: the router (d, E), the routed experts' SwiGLU
    weights (E, d, f) and (E, f, d), and the shared experts' (d, s f) and
    (s f, d) under ``shared/`` when there are any."""
    m, d = cfg.moe, cfg.d_model
    f = m.d_ff_expert or cfg.d_ff
    E = m.num_experts
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
              "w_down": (E, f, d)}
    if m.num_shared_experts:
        sf = m.num_shared_experts * f
        shapes.update({"shared/w_gate": (d, sf), "shared/w_up": (d, sf),
                       "shared/w_down": (sf, d)})
    return shapes


def capacity(num_tokens: int, cfg) -> int:
    """Tokens an expert takes of a shard of ``num_tokens`` in the
    reference's expert-parallel path (at least 4)."""
    m = cfg.moe
    c = int(num_tokens * m.experts_per_token * m.capacity_factor
            / m.num_experts)
    return max(4, min(num_tokens, c))


def shared_expert_ffn(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The shared experts' SwiGLU over every token; output in x's dtype."""
    cdt = getattr(torch, cfg.compute_dtype)
    xc = x.to(cdt)
    h = F.silu(xc @ p["shared/w_gate"].to(cdt)) * \
        (xc @ p["shared/w_up"].to(cdt))
    return (h @ p["shared/w_down"].to(cdt)).to(x.dtype)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries along the last dim,
    descending, the lowest index first among equal values."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)) \
        .to(torch.float32)


def _dispatch(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, S, d), idx (B, E, C) -> (B, E, C, d), row idx[b, e, c] of x[b].
    One gather per expert: each gather's backward adds into distinct rows,
    and the experts' gradients meet in autograd's fixed order."""
    d = x.shape[-1]
    return torch.stack([x.gather(1, idx[:, e, :, None].expand(-1, -1, d))
                        for e in range(idx.shape[1])], dim=1)


def _combine(y: torch.Tensor, idx: torch.Tensor, S: int) -> torch.Tensor:
    """y (B, E, C, d), idx (B, E, C) -> (B, S, d): each expert's rows put
    at their tokens (distinct within an expert, so a plain scatter), then
    summed over the experts in order."""
    B, E, _, d = y.shape
    rows = y.new_zeros((B, E, S, d)).scatter(
        2, idx[..., None].expand(-1, -1, -1, d), y)
    out = rows[:, 0]
    for e in range(1, E):
        out = out + rows[:, e]
    return out


def moe_ffn(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """p: one layer's MoE leaves (``moe_shapes``); x: (B, S, d). Returns
    (out in x's dtype, the weighted load-balance loss, fp32 0-d)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.experts_per_token
    cdt = getattr(torch, cfg.compute_dtype)
    xc = x.to(cdt)
    logits = (xc @ p["router"].to(cdt)).to(torch.float32)       # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, k)                                # (B, S, k)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    hot = _one_hot(topi, E)                                     # (B,S,k,E)
    frac = torch.mean(hot, dim=(0, 1, 2))
    aux = E * torch.sum(frac * torch.mean(probs, dim=(0, 1)))
    w_se = torch.sum(hot * topv[..., None], dim=2)              # (B, S, E)
    wg, wu, wd = (p[n].to(cdt) for n in ("w_gate", "w_up", "w_down"))
    if S == 1:
        # decode: every expert densely, combined with the token's weights
        h = F.silu(torch.einsum("bsd,edf->bsef", xc, wg)) * \
            torch.einsum("bsd,edf->bsef", xc, wu)
        y = torch.einsum("bsef,efd->bsed", h, wd)
        out = torch.einsum("bsed,bse->bsd", y, w_se.to(cdt))
    else:
        # per-sample (GShard group = batch row) capacity dispatch
        cap = max(1, min(S, int(S * k * m.capacity_factor / E)))
        selv, seli = top_k(w_se.transpose(1, 2), cap)           # (B, E, C)
        xin = _dispatch(xc, seli)                               # (B,E,C,d)
        h = F.silu(torch.einsum("becd,edf->becf", xin, wg)) * \
            torch.einsum("becd,edf->becf", xin, wu)
        y = torch.einsum("becf,efd->becd", h, wd)
        out = _combine(y * selv[..., None].to(cdt), seli, S)
    if m.num_shared_experts:
        out = out + shared_expert_ffn(p, x, cfg).to(cdt)
    return out.to(x.dtype), aux * m.router_aux_loss


def moe_ffn_local(p, x: torch.Tensor, cfg, e_first: int, e_local: int,
                  cap: int):
    """One expert shard's share of an MoE layer. p: the router (d, E) and
    the shard's expert weights (e_local, d, f) and (e_local, f, d); x: (T,
    d) the shard's tokens (replicated over the expert shards by the
    caller). Returns (partial_out (T, d) in x's dtype, {"aux": the
    load-balance loss over the full router output, unweighted, fp32 0-d;
    "dropped": the routed (token, local expert) slots past the capacity,
    int 0-d}); the caller sums partial_out (and dropped) over the shards.
    """
    m = cfg.moe
    T, d = x.shape
    E, k = m.num_experts, m.experts_per_token
    cdt = getattr(torch, cfg.compute_dtype)
    xc = x.to(cdt)
    logits = (xc @ p["router"].to(cdt)).to(torch.float32)       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, k)                                # (T, k)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    # each token's weight for each local expert: (E_local, T)
    rel = topi - e_first
    ok = (rel >= 0) & (rel < e_local)
    hot = _one_hot(torch.clamp(rel, 0, e_local - 1), e_local)   # (T,k,El)
    w_e = torch.zeros((e_local, T), dtype=torch.float32, device=x.device)
    for j in range(k):
        w_e = w_e + (hot[:, j] * torch.where(ok[:, j], topv[:, j],
                                             0.0)[:, None]).T
    selv, seli = top_k(w_e, cap)                                # (El, C)
    xin = xc[seli.reshape(-1)].reshape(e_local, cap, d)
    wg, wu, wd = (p[n].to(cdt) for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, wg)) * \
        torch.einsum("ecd,edf->ecf", xin, wu)
    y = torch.einsum("ecf,efd->ecd", h, wd) * selv[..., None].to(cdt)
    out = _combine(y[None], seli[None], T)[0]
    frac = torch.mean(_one_hot(topi, E), dim=(0, 1))
    aux = E * torch.sum(frac * torch.mean(probs, dim=0))
    dropped = torch.sum(w_e > 0) - torch.sum(selv > 0)
    return out.to(x.dtype), {"aux": aux, "dropped": dropped}
