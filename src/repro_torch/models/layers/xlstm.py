"""xLSTM blocks (Beck et al., arXiv:2405.04517), the training path
(``repro.models.layers.xlstm``): the mLSTM and the sLSTM.

mLSTM: a matrix memory C of (P, P) per head with an exponential input gate
and a forget gate. ``mlstm_apply`` runs the whole sequence in one of the
reference's two forms: the quadratic, decay-masked form when S is below
``MLSTM_CHUNK`` or not a multiple of it, else the chunkwise form
(``_mlstm_chunked_core``), which carries the (C, n, m) state from chunk to
chunk so that only one chunk's (Q, Q) tensors are live. The inner norm is
the RMSNorm kernel at width d_inner, in the compute dtype.

sLSTM: a scalar memory with block-diagonal recurrent weights and
exponential gating, run step by step over the sequence in fp32 (the
reference's ``lax.scan``; here an eager loop of out-of-place ops, with no
host sync, so ``torch.func.grad`` and ``vmap`` run it too). Its output
norm is a LayerNorm.

Both cores are jnp code in the reference, outside any Pallas kernel, so
they are plain PyTorch here. The -1e30 masks (``NEG_INF``) and the
``max(|den|, exp(-m))`` normaliser are the reference's, so that the
gradients through ``exp(dmat - m)`` match.

Serving: ``mlstm_decode`` and ``slstm_decode`` are the O(1) single-token
steps on the states of ``mlstm_init_state`` (C, n zero, the stabiliser m
at -1e30) and ``slstm_init_state`` (c, h, m zero, the normaliser n at
one). The full-sequence layers hand their final state on when asked
(``return_state``, the reference's prefill hand-off) and take an entering
``state``, with the reference's semantics: the chunkwise mLSTM carries
``state`` through its chunks and returns the carried state; the quadratic
mLSTM ignores ``state`` and builds its final state by replaying the
recurrence from zero (C and n weighted by exp(F_S - F_j + i_j), the
stabiliser m their largest log weight); the sLSTM starts its loop from
``state`` and returns the loop's last state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.norms import layernorm, rmsnorm

NEG_INF = -1e30
MLSTM_CHUNK = 256

# the reference's constant initial values per block kind (leaf paths inside
# the kind's subtree); every other leaf is a fan-in truncated normal
MLSTM_CONSTANT_INIT = {"b_i": 0.0, "b_f": 3.0,        # mostly remember
                       "norm/scale": 1.0}
SLSTM_CONSTANT_INIT = {"b": 0.0, "norm/scale": 1.0, "norm/bias": 0.0}
# the sLSTM's recurrent weights (H, P, 4P): fan-in P (their dim 1), scale 0.5
SLSTM_RECURRENT = "r"


def d_inner(cfg) -> int:
    return int(cfg.xlstm.proj_factor * cfg.d_model)


def mlstm_shapes(cfg):
    """Per-layer leaf shapes of the ``mlstm`` subtree."""
    d, di, H = cfg.d_model, d_inner(cfg), cfg.num_heads
    return {
        "b_f": (H,),
        "b_i": (H,),
        "norm/scale": (di,),
        "w_down": (di, d),
        "w_f": (di, H),                 # forget gate
        "w_i": (di, H),                 # input gate (exponential)
        "w_k": (di, di),
        "w_q": (di, di),
        "w_up": (d, 2 * di),            # [x_inner, z gate]
        "w_v": (di, di),
    }


def slstm_shapes(cfg):
    """Per-layer leaf shapes of the ``slstm`` subtree."""
    d, H = cfg.d_model, cfg.num_heads
    P = d // H
    return {
        "b": (4 * d,),
        "norm/bias": (d,),
        "norm/scale": (d,),
        "r": (H, P, 4 * P),             # block-diagonal recurrence
        "w": (d, 4 * d),                # i, f, z, o pre-activations
        "w_down": (d, d),
    }


def _mlstm_gates(p, xf: torch.Tensor):
    logi = (xf @ p["w_i"].to(torch.float32)) + p["b_i"]
    logf = (xf @ p["w_f"].to(torch.float32)) + p["b_f"]
    return logi, F.logsigmoid(logf)                   # log f in (-inf, 0)


def mlstm_init_state(cfg, batch: int, device=None):
    di, H = d_inner(cfg), cfg.num_heads
    P = di // H
    f32 = torch.float32
    return {"C": torch.zeros((batch, H, P, P), dtype=f32, device=device),
            "n": torch.zeros((batch, H, P), dtype=f32, device=device),
            "m": torch.full((batch, H), NEG_INF, dtype=f32, device=device)}


def _key_divisor(P: int, cdt) -> float:
    """``jnp.sqrt(P).astype(cdt)``: sqrt(P) in fp32, rounded to the compute
    dtype (at P = 384 in bf16, 19.625 for 19.596), as a Python float."""
    return float(torch.sqrt(torch.tensor(float(P))).to(cdt))


def mlstm_apply(p, x: torch.Tensor, cfg, *, return_state: bool = False,
                state=None):
    """p: the ``mlstm`` subtree of one layer; x: (B, S, d) -> (B, S, d),
    or with ``return_state`` (out, the final (C, n, m) state). The gates
    are fp32; q, k and v are in the compute dtype. ``state`` enters the
    chunkwise form only (the quadratic form ignores it, as the
    reference's does)."""
    di, H = d_inner(cfg), cfg.num_heads
    P = di // H
    B, S, _ = x.shape
    cdt = getattr(torch, cfg.compute_dtype)
    f32 = torch.float32
    up = x.to(cdt) @ p["w_up"].to(cdt)
    xi, z = up.chunk(2, dim=-1)
    xf = xi.to(f32)
    q = (xi @ p["w_q"].to(cdt)).reshape(B, S, H, P)
    k = (xi @ p["w_k"].to(cdt)).reshape(B, S, H, P) / _key_divisor(P, cdt)
    v = (xi @ p["w_v"].to(cdt)).reshape(B, S, H, P)
    logi, logf = _mlstm_gates(p, xf)                  # (B, S, H)
    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    if S >= MLSTM_CHUNK and S % MLSTM_CHUNK == 0:
        y, st = _mlstm_chunked_core(q.to(f32), k.to(f32), v.to(f32), logi,
                                    logf, state, MLSTM_CHUNK)
    else:
        y = _mlstm_quadratic(q.to(f32), k.to(f32), v.to(f32), logi, logf)
        st = _mlstm_replayed_state(k.to(f32), v.to(f32), logi, logf) \
            if return_state else None
    y = y.reshape(B, S, di).to(cdt)
    y = rmsnorm(y, p["norm/scale"], cfg.norm_eps) * F.silu(z)
    out = (y @ p["w_down"].to(cdt)).to(x.dtype)
    return (out, st) if return_state else out


def _mlstm_replayed_state(k, v, logi, logf):
    """The quadratic form's final state, replayed from zero as the
    reference builds it: C = sum_j w_j v_j k_j^T and n = sum_j w_j k_j with
    w_j = exp(F_S - F_j + i_j), and m = max_j(F_S - F_j + i_j) (a crude
    stabiliser: C and n are not scaled by exp(-m))."""
    Fc = torch.cumsum(logf, dim=1)
    lw = Fc[:, -1:, :] - Fc + logi                   # (B, S, H)
    w = torch.exp(lw)
    return {"C": torch.einsum("bjh,bjhp,bjhq->bhpq", w, v, k),
            "n": torch.einsum("bjh,bjhp->bhp", w, k),
            "m": torch.amax(lw, dim=1)}


def _mlstm_quadratic(q, k, v, logi, logf):
    """The parallel (quadratic, decay-masked) form. q, k, v: (B, S, H, P)
    fp32; logi, logf: (B, S, H). D_ij = exp(F_i - F_j + i_j) for j <= i,
    stabilised per row."""
    S = q.shape[1]
    Fc = torch.cumsum(logf, dim=1)
    dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + logi[:, None, :, :]
    idx = torch.arange(S, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    dmat = torch.where(causal[None, :, :, None], dmat, NEG_INF)
    m = torch.amax(dmat, dim=2, keepdim=True)        # (B, S, 1, H)
    D = torch.exp(dmat - m)                           # (B, S, S, H)
    W = torch.einsum("bihp,bjhp->bijh", q, k) * D
    norm = torch.maximum(torch.abs(torch.sum(W, dim=2)),
                         torch.exp(-m[:, :, 0]))
    return torch.einsum("bijh,bjhp->bihp", W, v) / norm[..., None]


def _mlstm_chunked_core(q, k, v, logi, logf, state, chunk: int):
    """The chunkwise-parallel stabilised mLSTM. q, k, v: (B, S, H, P) fp32;
    logi, logf: (B, S, H); one chunk after another, carrying the (C, n, m)
    matrix-memory state. Returns (y (B, S, H, P), the final state)."""
    S = q.shape[1]
    assert S % chunk == 0, (S, chunk)
    idx = torch.arange(chunk, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    C, n, m = state["C"], state["n"], state["m"]
    ys = []
    for c0 in range(0, S, chunk):
        qc, kc, vc, ic, fc = (t[:, c0:c0 + chunk]
                              for t in (q, k, v, logi, logf))
        Fc = torch.cumsum(fc, dim=1)                  # inclusive (B, Q, H)
        # intra-chunk log weights: D_ij = F_i - F_j + i_j (j <= i)
        dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + ic[:, None, :, :]
        dmat = torch.where(causal, dmat, NEG_INF)
        # the incoming state's log scale per row: F_i + m_in
        inter = Fc + m[:, None, :]
        m_i = torch.maximum(torch.amax(dmat, dim=2), inter)
        D = torch.exp(dmat - m_i[:, :, None, :])
        w_in = torch.exp(inter - m_i)
        W = torch.einsum("bihp,bjhp->bijh", qc, kc) * D
        qw = qc * w_in[..., None]
        num = torch.einsum("bijh,bjhp->bihp", W, vc) + \
            torch.einsum("bihp,bhpq->bihq", qw, C)
        den = torch.einsum("bijh,bjhp->bih", W, kc) + \
            torch.einsum("bihp,bhp->bih", qw, n)
        norm = torch.maximum(torch.abs(den), torch.exp(-m_i))
        ys.append(num / norm[..., None])
        # the state at the chunk's end
        decay_to_end = Fc[:, -1:, :] - Fc + ic
        m_out = torch.maximum(Fc[:, -1, :] + m,
                              torch.amax(decay_to_end, dim=1))
        w_st = torch.exp(decay_to_end - m_out[:, None, :])
        carry_w = torch.exp(Fc[:, -1, :] + m - m_out)
        C = C * carry_w[..., None, None] + \
            torch.einsum("bjh,bjhp,bjhq->bhpq", w_st, vc, kc)
        n = n * carry_w[..., None] + torch.einsum("bjh,bjhp->bhp", w_st, kc)
        m = m_out
    return torch.cat(ys, dim=1), {"C": C, "n": n, "m": m}


def slstm_init_state(cfg, batch: int, device=None):
    d, f32 = cfg.d_model, torch.float32
    return {"c": torch.zeros((batch, d), dtype=f32, device=device),
            "n": torch.ones((batch, d), dtype=f32, device=device),
            "h": torch.zeros((batch, d), dtype=f32, device=device),
            "m": torch.zeros((batch, d), dtype=f32, device=device)}


def _recurrent_matrix(r: torch.Tensor) -> torch.Tensor:
    """The (d, 4d) block-diagonal matrix of the per-head (P, 4P) blocks of
    ``r`` (H, P, 4P): ``h @ it`` is the reference's ``einsum("bhp,hpq->
    bhq", h, r)`` reshaped to (B, 4d), as one product a step (the zeros
    off the blocks add nothing)."""
    H, P, P4 = r.shape
    eye = torch.eye(H, dtype=r.dtype, device=r.device)
    return (r[:, :, None, :] * eye[:, None, :, None]).reshape(H * P, H * P4)


def _slstm_cell(R: torch.Tensor, b: torch.Tensor, xt: torch.Tensor, st):
    """One step. R: the fp32 recurrent matrix (``_recurrent_matrix``); xt:
    (B, 4d) pre-activations from the input; st: the state dict."""
    pre = xt + st["h"] @ R + b
    zi, zf, zz, zo = pre.chunk(4, dim=-1)
    logf_m = F.logsigmoid(zf) + st["m"]
    m_new = torch.maximum(logf_m, zi)
    i = torch.exp(zi - m_new)
    f = torch.exp(logf_m - m_new)
    c = f * st["c"] + i * torch.tanh(zz)
    n = f * st["n"] + i
    h = torch.sigmoid(zo) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_apply(p, x: torch.Tensor, cfg, *, return_state: bool = False,
                state=None):
    """p: the ``slstm`` subtree of one layer; x: (B, S, d) -> (B, S, d),
    one recurrence step a position from ``state`` (the initial state when
    None); with ``return_state``, (out, the last step's (c, n, h, m))."""
    B, S, _ = x.shape
    cdt = getattr(torch, cfg.compute_dtype)
    xs = (x.to(cdt) @ p["w"].to(cdt)).to(torch.float32)
    R = _recurrent_matrix(p[SLSTM_RECURRENT].to(torch.float32))
    st = slstm_init_state(cfg, B, x.device) if state is None else state
    hs = []
    for t in range(S):
        st = _slstm_cell(R, p["b"], xs[:, t], st)
        hs.append(st["h"])
    y = torch.stack(hs, dim=1).to(cdt)                # (B, S, d)
    y = layernorm(y, p["norm/scale"], p["norm/bias"], cfg.norm_eps)
    out = (y @ p["w_down"].to(cdt)).to(x.dtype)
    return (out, st) if return_state else out



def mlstm_decode(p, x: torch.Tensor, state, cfg):
    """The O(1) recurrent step. p: the ``mlstm`` subtree of one layer; x:
    (B, 1, d). Returns (y (B, 1, d), the new (C, n, m) state)."""
    di, H = d_inner(cfg), cfg.num_heads
    P = di // H
    B = x.shape[0]
    cdt = getattr(torch, cfg.compute_dtype)
    f32 = torch.float32
    up = x[:, 0].to(cdt) @ p["w_up"].to(cdt)
    xi, z = up.chunk(2, dim=-1)
    q = (xi @ p["w_q"].to(cdt)).reshape(B, H, P).to(f32)
    k = ((xi @ p["w_k"].to(cdt)).reshape(B, H, P)
         / _key_divisor(P, cdt)).to(f32)
    v = (xi @ p["w_v"].to(cdt)).reshape(B, H, P).to(f32)
    logi, logf = _mlstm_gates(p, xi.to(f32))                  # (B, H)
    m_new = torch.maximum(logf + state["m"], logi)
    a = torch.exp(logf + state["m"] - m_new)
    b = torch.exp(logi - m_new)
    C = state["C"] * a[..., None, None] + b[..., None, None] * \
        torch.einsum("bhp,bhq->bhpq", v, k)
    n = state["n"] * a[..., None] + b[..., None] * k
    num = torch.einsum("bhpq,bhq->bhp", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", n, q)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, di).to(cdt)
    y = rmsnorm(y, p["norm/scale"], cfg.norm_eps) * F.silu(z)
    out = (y @ p["w_down"].to(cdt)).to(x.dtype)
    return out[:, None], {"C": C, "m": m_new, "n": n}


def slstm_decode(p, x: torch.Tensor, state, cfg):
    """One recurrence step. p: the ``slstm`` subtree of one layer; x: (B,
    1, d). Returns (y (B, 1, d), the new (c, h, m, n) state)."""
    cdt = getattr(torch, cfg.compute_dtype)
    xt = (x[:, 0].to(cdt) @ p["w"].to(cdt)).to(torch.float32)
    st = _slstm_cell(_recurrent_matrix(p[SLSTM_RECURRENT].to(torch.float32)),
                     p["b"], xt, state)
    y = layernorm(st["h"].to(cdt)[:, None], p["norm/scale"], p["norm/bias"],
                  cfg.norm_eps)
    return (y @ p["w_down"].to(cdt)).to(x.dtype), st
