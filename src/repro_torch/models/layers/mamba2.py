"""Mamba2 (state-space duality) block, the training path
(``repro.models.layers.mamba2``).

``mamba2_apply`` runs the full sequence: in-projection, depthwise causal
convolution, the chunked SSD scan, the gated RMSNorm and the
out-projection. The scan goes through ``kernels.ops.ssd_scan`` (the CUDA
kernel on the card, ``ref.ssd_scan_ref`` on the CPU); the JAX layer calls
its own ``ssd_chunked`` there, which the kernel is checked against. The
gated norm is the RMSNorm kernel at width ``d_inner``.

``ssd_chunked`` is the layer's plain scan (dt and A separately, an
optional incoming state, the final state).

The prefill hand-off (the reference's ``mamba2_apply(..., h0, conv0,
return_state=True)``): the scan starts from ``h0`` and the layer returns
(out, (the final SSM state, the last K - 1 convolution inputs)), the
state ``mamba2_decode`` steps on. As in the reference, ``conv0`` is
accepted and not read: the convolution always pads the sequence's start
with zeros, so a prompt prefilled in two parts differs from one pass in
the second part's first K - 1 convolution outputs, and, through the scan,
by a decaying amount in every later output and the final state.

Serving: ``init_state`` is the recurrent state, the SSM's ``h`` (B, H, P,
N) and the convolution's last K - 1 inputs ``conv`` (B, K - 1, C), both
fp32 and zero; ``mamba2_decode`` is the O(1) single-token update (no scan
kernel), its gated norm the RMSNorm kernel as in ``mamba2_apply``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.layers.norms import rmsnorm


def d_inner(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def n_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm.head_dim


def mamba2_shapes(cfg):
    """Per-layer leaf shapes, keyed by their path inside the block's
    ``mamba`` subtree."""
    s = cfg.ssm
    d, di, H = cfg.d_model, d_inner(cfg), n_heads(cfg)
    conv_ch = di + 2 * s.state_dim
    return {
        "D": (H,),
        "a_log": (H,),                      # A = -exp(a_log)
        "conv_b": (conv_ch,),
        "conv_w": (s.conv_width, conv_ch),
        "dt_bias": (H,),
        "norm/scale": (di,),
        # in_proj -> [z (di), x (di), B (N), C (N), dt (H)]
        "w_in": (d, 2 * di + 2 * s.state_dim + H),
        "w_out": (di, d),
    }


# the reference's constant initial values; every other leaf is a fan-in
# truncated normal (``blocks.block_init_``)
CONSTANT_INIT = {"D": 1.0, "a_log": 0.0, "conv_b": 0.0,
                 "dt_bias": -2.0,                     # softplus ~ 0.12
                 "norm/scale": 1.0}


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (K, C). Summed tap by tap
    in the reference's order."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + S] * w[k]
    return out + b


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked selective-state-space scan (plain PyTorch).

    xh: (B, S, H, P); dt: (B, S, H) positive step sizes; A: (H,) negative
    decay rates; Bm, Cm: (B, S, N) (a single group). Returns y (B, S, H, P)
    and the final state (B, H, P, N)."""
    return ref.ssd_explicit(xh, dt, dt * A, Bm, Cm, chunk, h0)


def scan_inputs(p, x: torch.Tensor, cfg):
    """The block up to its scan: (z, the convolution's inputs (B, S, C),
    xh (B, S, H, P), dt (B, S, H), A (H,), Bm, Cm (B, S, N)), fp32."""
    s = cfg.ssm
    B, S, _ = x.shape
    di, H, N = d_inner(cfg), n_heads(cfg), s.state_dim
    cdt = getattr(torch, cfg.compute_dtype)
    proj = (x.to(cdt) @ p["w_in"].to(cdt)).to(torch.float32)
    z, xr, Bm, Cm, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"].to(torch.float32),
                                   p["conv_b"].to(torch.float32)))
    xr, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    return z, conv_in, xr.reshape(B, S, H, s.head_dim), dt, A, Bm, Cm


def mamba2_apply(p, x: torch.Tensor, cfg, h0=None, conv0=None, *,
                 return_state: bool = False):
    """Full-sequence Mamba2 block. p: the block's ``mamba`` leaves; x:
    (B, S, d); h0: the SSM state entering the first position (B, H, P, N)
    fp32, zero when None; conv0: ignored, as in the reference (see the
    module docstring). Returns out (B, S, d), or with ``return_state``
    (out, (h_final (B, H, P, N), the last K - 1 convolution inputs (B,
    K - 1, C)))."""
    s = cfg.ssm
    B, S, _ = x.shape
    cdt = getattr(torch, cfg.compute_dtype)
    z, conv_in, xh, dt, A, Bm, Cm = scan_inputs(p, x, cfg)
    y, h_final = ops.ssd_scan(xh, dt, dt * A, Bm, Cm,
                              chunk=min(s.chunk_size, S), h0=h0,
                              return_state=True)
    y = y + xh * p["D"][None, None, :, None]
    y = rmsnorm(y.reshape(B, S, d_inner(cfg)) * F.silu(z), p["norm/scale"],
                cfg.norm_eps)
    out = (y.to(cdt) @ p["w_out"].to(cdt)).to(x.dtype)
    if return_state:
        return out, (h_final, conv_in[:, -(s.conv_width - 1):, :])
    return out


def init_state(cfg, batch: int, device=None) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    conv_ch = d_inner(cfg) + 2 * s.state_dim
    f32 = torch.float32
    return {"conv": torch.zeros((batch, s.conv_width - 1, conv_ch),
                                dtype=f32, device=device),
            "h": torch.zeros((batch, n_heads(cfg), s.head_dim, s.state_dim),
                             dtype=f32, device=device)}


def mamba2_decode(p, x: torch.Tensor, state,
                  cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent update. p: the block's ``mamba`` leaves; x:
    (B, 1, d). Returns (y (B, 1, d), the new state)."""
    s = cfg.ssm
    B = x.shape[0]
    di, H, N = d_inner(cfg), n_heads(cfg), s.state_dim
    cdt = getattr(torch, cfg.compute_dtype)
    proj = (x[:, 0].to(cdt) @ p["w_in"].to(cdt)).to(torch.float32)
    z, xr, Bm, Cm, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)                  # (B, C)
    window = torch.cat([state["conv"], conv_in[:, None]], dim=1)  # (B,K,C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window,
                                   p["conv_w"].to(torch.float32))
                      + p["conv_b"].to(torch.float32))
    xr, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                         # (B, H)
    A = -torch.exp(p["a_log"])
    xh = xr.reshape(B, H, s.head_dim)
    decay = torch.exp(dt * A)                                  # (B, H)
    h = state["h"] * decay[:, :, None, None] + \
        (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cm) + xh * p["D"][None, :, None]
    y = rmsnorm(y.reshape(B, di) * F.silu(z), p["norm/scale"], cfg.norm_eps)
    out = (y.to(cdt) @ p["w_out"].to(cdt)).to(x.dtype)
    return out[:, None], {"conv": window[:, 1:], "h": h}
