"""Plain PyTorch versions of the port's kernels (ported from
``src/repro/kernels/ref.py``).

The CPU path runs these, the tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. The
backward functions are the closed-form gradients the autograd Functions in
``ops.py`` use on every device.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


# -- wire pack / unpack -------------------------------------------------------
def wire_pack_ref(srcs: Sequence[torch.Tensor],
                  layout: Sequence[Tuple[int, int, int]],
                  total: int) -> torch.Tensor:
    """Slot-table gather: layout rows are (src_off, dst_off, size)."""
    out = torch.zeros(total, dtype=torch.float32, device=srcs[0].device)
    for src, (src_off, dst_off, size) in zip(srcs, layout):
        out[dst_off:dst_off + size] = \
            src.reshape(-1)[src_off:src_off + size].to(torch.float32)
    return out


def wire_unpack_ref(flat: torch.Tensor, bases: Sequence[torch.Tensor],
                    layout: Sequence[Tuple[int, int, int]]
                    ) -> List[torch.Tensor]:
    """Slot-table scatter into copies: each slot range of ``flat``
    overwrites the matching range of a copy of its base leaf (read
    raveled; the copy keeps the base's shape)."""
    outs = []
    for base, (src_off, dst_off, size) in zip(bases, layout):
        out = base.clone(memory_format=torch.contiguous_format)
        out.view(-1)[src_off:src_off + size] = \
            flat[dst_off:dst_off + size].to(base.dtype)
        outs.append(out)
    return outs


# -- wire codecs: int8 ---------------------------------------------------------
def int8_quant_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, C) fp32 -> (q int8 (R, C), per-column scale fp32 (C,)): the
    exact ``Int8Codec`` math, true division and round-half-to-even. Both
    divisors are tensors: on the card PyTorch divides by a Python scalar
    as a multiply by its reciprocal, which can differ in the last bit."""
    amax = torch.amax(torch.abs(x), dim=0)
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequant_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_encode_ref(flat: torch.Tensor, segs, nscales: int):
    """Segment-table int8 over the flat payload; ``segs`` rows are
    ``(offset, size, channels, scale_offset)``. Returns (q int8 of
    ``flat``'s length, scales fp32 (nscales,))."""
    q = torch.empty(flat.shape[0], dtype=torch.int8, device=flat.device)
    scales = torch.empty(nscales, dtype=torch.float32, device=flat.device)
    for off, size, ch, soff in segs:
        qs, s = int8_quant_ref(flat[off:off + size].reshape(-1, ch))
        q[off:off + size] = qs.reshape(-1)
        scales[soff:soff + ch] = s
    return q, scales


def int8_decode_ref(q: torch.Tensor, scales: torch.Tensor, segs,
                    total: int) -> torch.Tensor:
    out = torch.empty(total, dtype=torch.float32, device=q.device)
    for off, size, ch, soff in segs:
        out[off:off + size] = int8_dequant_ref(
            q[off:off + size].reshape(-1, ch),
            scales[soff:soff + ch]).reshape(-1)
    return out


# -- wire codecs: top-k with error feedback -------------------------------------
def compensate_ref(flat: torch.Tensor, ref: torch.Tensor,
                   res: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c, |c|) with c = flat - ref + res, in that order; ``res`` None is
    a residual of zeros (the mirror path)."""
    c = (flat - ref) + (torch.zeros_like(flat) if res is None else res)
    return c, torch.abs(c)


def topk_threshold(absc: torch.Tensor, k: int):
    """The k-th largest magnitude (0-d) and ``needed``, the number of
    ``== thresh`` entries that top-k keeps (0-d int64). The value comes
    from ``torch.topk``; its indices are not used, since it promises no
    order among ties."""
    thresh = torch.topk(absc, k, sorted=False).values.min()
    needed = k - torch.count_nonzero(absc > thresh)
    return thresh, needed


def topk_ef_update_ref(comp: torch.Tensor, thresh: torch.Tensor,
                       needed: torch.Tensor):
    """Select every ``|c| > thresh`` and the ``needed`` lowest-index
    ``|c| == thresh`` entries (``lax.top_k``'s tie order). Returns
    (new residual: ``comp`` with the selected entries zeroed, idx int32 of
    the selected entries in position order, their values)."""
    a = torch.abs(comp)
    eq = a == thresh
    rank = torch.cumsum(eq.to(torch.int64), 0)          # 1-based tie rank
    sel = (a > thresh) | (eq & (rank <= needed))
    new_res = torch.where(sel, torch.zeros_like(comp), comp)
    idx = torch.nonzero(sel).reshape(-1)
    return new_res, idx.to(torch.int32), comp[idx]


def topk_ef_update_tiled(comp: torch.Tensor, thresh: torch.Tensor,
                         needed: torch.Tensor, tile: int):
    """``topk_ef_update_ref`` as the CUDA kernel's chained scan computes
    it: per-tile counts of ``> thresh`` and ``== thresh``, their exclusive
    prefixes, and each tile's first output slot ``gt_prefix + min(needed,
    tie_prefix)``; inside a tile, the ties of local rank below ``needed -
    tie_prefix`` are kept, and an entry's slot adds the tile's earlier
    ``>`` entries and kept ties. Returns what ``topk_ef_update_ref``
    returns."""
    n = comp.shape[0]
    ntiles = -(-n // tile)
    a = torch.abs(comp)
    pad = ntiles * tile - n
    gt = torch.nn.functional.pad(a > thresh, (0, pad)).reshape(ntiles, tile)
    eq = torch.nn.functional.pad(a == thresh, (0, pad)).reshape(ntiles, tile)
    gt_n, eq_n = gt.sum(1), eq.sum(1)
    gt_pre = torch.cumsum(gt_n, 0) - gt_n
    eq_pre = torch.cumsum(eq_n, 0) - eq_n
    budget = torch.clamp(needed - eq_pre, min=0)[:, None]
    out0 = (gt_pre + torch.minimum(needed, eq_pre))[:, None]
    gt_before = torch.cumsum(gt.to(torch.int64), 1) - gt.to(torch.int64)
    eq_before = torch.cumsum(eq.to(torch.int64), 1) - eq.to(torch.int64)
    sel = gt | (eq & (eq_before < budget))
    pos = out0 + gt_before + torch.minimum(eq_before, budget)
    sel, pos = sel.reshape(-1)[:n], pos.reshape(-1)[:n]
    new_res = torch.where(sel, torch.zeros_like(comp), comp)
    count = int(sel.sum())
    idx = torch.empty(count, dtype=torch.int64, device=comp.device)
    idx[pos[sel]] = torch.arange(n, device=comp.device)[sel]
    return new_res, idx.to(torch.int32), comp[idx]


def topk_ef_ref(flat: torch.Tensor, ref: torch.Tensor,
                res: Optional[torch.Tensor], k: int):
    """The whole top-k upload: compensated delta, exact top-k set,
    error-feedback residual and the decoded dense payload. Returns
    (idx, val, new_res, dec)."""
    comp, absc = compensate_ref(flat, ref, res)
    new_res, idx, val = topk_ef_update_ref(comp, *topk_threshold(absc, k))
    return idx, val, new_res, topk_decode_ref(idx, val, comp.shape[0])


def topk_decode_ref(idx: torch.Tensor, val: torch.Tensor,
                    total: int) -> torch.Tensor:
    out = torch.zeros(total, dtype=torch.float32, device=val.device)
    out[idx.long()] = val
    return out


# -- RMSNorm -----------------------------------------------------------------
def _scale_like(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (d,) scale as it is; a grouped (G, d) scale, one row per index of
    x's leading axis, shaped to broadcast against x."""
    if scale.dim() == 1:
        return scale
    return scale.reshape(scale.shape[0], *([1] * (x.dim() - 2)),
                         scale.shape[-1])


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,), or (G, d) with x: (G, ..., d)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * _scale_like(scale, x).to(torch.float32)).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-5):
    """Gradients of ``rmsnorm_ref`` wrt (x, scale), recomputed from x:
    gx = r (gy - x_hat mean(gy x_hat)), gscale = sum(g x_hat) with
    r = rsqrt(mean(x^2) + eps), x_hat = x r, gy = g scale (summed per
    group for a grouped scale)."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(0) \
        if scale.dim() == 1 else \
        (gf * xhat).reshape(scale.shape[0], -1, x.shape[-1]).sum(1)
    gy = gf * _scale_like(scale, x).to(torch.float32)
    gx = r * (gy - xhat * torch.mean(gy * xhat, dim=-1, keepdim=True))
    return gx.to(x.dtype), gscale.to(scale.dtype)


# -- InfoNCE -------------------------------------------------------------------
def info_nce_rows_ref(q: torch.Tensor, k: torch.Tensor, tau: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row InfoNCE with in-batch negatives over L2-normalised rows.
    q, k: (..., B, d), a leading axis per client (each client's rows see
    only its own negatives). Returns (loss, lse), both (..., B) fp32:
    lse_i = logsumexp_j(q_i k_j / tau), loss_i = lse_i - q_i k_i / tau."""
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) / tau
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.diagonal(logits, dim1=-2, dim2=-1)
    return lse - gold, lse


def info_nce_partial_logits(q: torch.Tensor, k: torch.Tensor,
                            d_slice: int = 256) -> torch.Tensor:
    """q.k^T per ``d_slice``-wide slice of d, as the CUDA logits kernel
    spreads it over its blocks: (..., ceil(d / d_slice), B, B) fp32."""
    d = q.shape[-1]
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    return torch.stack([
        torch.matmul(qf[..., lo:lo + d_slice],
                     kf[..., lo:lo + d_slice].transpose(-1, -2))
        for lo in range(0, d, d_slice)], dim=-3)


def info_nce_logits_from_partials(part: torch.Tensor,
                                  tau: float) -> torch.Tensor:
    """s = (sum of the slices in slice order) / tau, as each consumer
    kernel forms a logit from the scratch."""
    s = part[..., 0, :, :]
    for i in range(1, part.shape[-3]):
        s = s + part[..., i, :, :]
    return s / tau


def info_nce_rows_split(q: torch.Tensor, k: torch.Tensor, tau: float,
                        d_slice: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA forward's split and combine in plain PyTorch: partial
    logits per d slice, summed in a fixed order, then each row's max, sum
    of exp and gold logit. Returns (loss, lse) as ``info_nce_rows_ref``."""
    s = info_nce_logits_from_partials(
        info_nce_partial_logits(q, k, d_slice), tau)
    m = s.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(s - m).sum(-1, keepdim=True)))[..., 0]
    return lse - torch.diagonal(s, dim1=-2, dim2=-1), lse


def info_nce_grad_split(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor, tau: float, wrt_k: bool,
                        d_slice: int = 256) -> torch.Tensor:
    """The CUDA gradient's split: the weights p_ab (dq) or g_b p_ba (dk)
    formed once from the partial logits, then multiplied into the other
    side's rows. Returns what ``info_nce_rows_bwd_ref`` returns."""
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    s = info_nce_logits_from_partials(
        info_nce_partial_logits(q, k, d_slice), tau)
    p = torch.exp(s - lse[..., None])
    if wrt_k:
        w = (p * g[..., None]).transpose(-1, -2)
        return (torch.matmul(w, qf) - g[..., None] * qf) / tau
    return (g / tau)[..., None] * (torch.matmul(p, kf) - kf)


def info_nce_rows_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                          lse: torch.Tensor, g: torch.Tensor, tau: float,
                          wrt_k: bool) -> torch.Tensor:
    """Gradient of ``sum(g * loss)`` wrt q (``wrt_k`` False) or k (True),
    with the probabilities p_ij = exp(q_i k_j / tau - lse_i) recomputed:
    dq_i = (g_i / tau) (sum_j p_ij k_j - k_i),
    dk_j = (1 / tau) (sum_i g_i p_ij q_i - g_j q_j)."""
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) / tau
    p = torch.exp(logits - lse[..., None])
    if wrt_k:
        pg = p * g[..., None]
        return (torch.matmul(pg.transpose(-1, -2), qf)
                - g[..., None] * qf) / tau
    return (g / tau)[..., None] * (torch.matmul(p, kf) - kf)


# -- attention ---------------------------------------------------------------
def _visible(S: int, T: int, causal: bool, window: int,
             kv_len: Optional[int], device) -> torch.Tensor:
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos < (T if kv_len is None else kv_len)
    if causal:
        m = m & (kpos <= qpos)
    if window:
        m = m & (kpos > qpos - window)
    return m


def _attn_probs(q, k, causal, window, kv_len, scale):
    """fp32 (B, Hq, S, T) probabilities and visibility; q: (B,Hq,S,hd),
    k: (B,Hq,T,hd) already repeated to Hq heads. Masked entries get
    p = 0 exactly, so a row that sees no key has all-zero probabilities
    (and a zero output), as in the CUDA kernel."""
    S, T = q.shape[2], k.shape[2]
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    vis = _visible(S, T, causal, window, kv_len, q.device)
    logits = torch.where(vis, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * vis
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.clamp(l, min=1e-30)


def _repeat_heads(x: torch.Tensor, hq: int) -> torch.Tensor:
    rep = hq // x.shape[1]
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: int = 0,
             kv_len: Optional[int] = None,
             scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,S,hd); k: (B,Hkv,T,hd); v: (B,Hkv,T,dv) -> (B,Hq,S,dv) in
    q's dtype. fp32 logits, softmax and p.v, as the flash kernel computes
    them; ``scale`` defaults to 1/sqrt(hd)."""
    Hq, hd = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qf = q.to(torch.float32)
    kf = _repeat_heads(k.to(torch.float32), Hq)
    vf = _repeat_heads(v.to(torch.float32), Hq)
    p = _attn_probs(qf, kf, causal, window, kv_len, scale)
    return torch.matmul(p, vf).to(q.dtype)


def sdpa_bwd_ref(q, k, v, g, *, causal: bool = True, window: int = 0,
                 kv_len: Optional[int] = None, scale: Optional[float] = None):
    """Gradients of ``sdpa_ref`` wrt (q, k, v), recomputed from the inputs
    in fp32 (BHSD layout; GQA gradients summed over each kv head's group;
    v and g may be narrower than q and k, as in MLA):
    dV = P^T dO, dS = P (dO V^T - rowsum(dO O)), dQ = s dS K,
    dK = s dS^T Q."""
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qf = q.to(torch.float32)
    kf = _repeat_heads(k.to(torch.float32), Hq)
    vf = _repeat_heads(v.to(torch.float32), Hq)
    gf = g.to(torch.float32)
    p = _attn_probs(qf, kf, causal, window, kv_len, scale)
    o = torch.matmul(p, vf)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (gf * o).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    if Hkv != Hq:
        T = k.shape[2]
        dk = dk.reshape(B, Hkv, Hq // Hkv, T, hd).sum(2)
        dv = dv.reshape(B, Hkv, Hq // Hkv, T, v.shape[-1]).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- Mamba2 SSD scan -------------------------------------------------------------
def ssd_explicit(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan with an explicit log-decay ``a = dt * A``, in
    fp32 (``src/repro/kernels/ref.py::_ssd_explicit``). Per chunk, with
    ``cum = cumsum(a)``:
      intra-chunk  y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
      inter-chunk  y_i += exp(cum_i) C_i . h^T
      state        h <- exp(cum_last) h + sum_j exp(cum_last - cum_j)
                        dt_j x_j B_j^T
    xh: (B, S, H, P); dt, a: (B, S, H); Bm, Cm: (B, S, N), or (B, S, G, N)
    with head h reading group h // (H / G) (``ssd_grouped``); h0: (B, H, P,
    N) or None (zeros). Returns (y (B, S, H, P) fp32, final state fp32).
    The decay is masked before its exp, so neither value nor gradient sees
    the j > i half (whose exponent is positive and may overflow)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd scan: chunk {chunk} does not divide S={S}")
    if Bm.dim() == 4:
        return ssd_grouped(xh, dt, a, Bm, Cm, chunk, h0)
    nc = S // chunk
    f32 = torch.float32
    # chunk-major, heads before positions: (nc, B, H, Q, ...)
    x = xh.to(f32).reshape(Bsz, nc, chunk, H, P).permute(1, 0, 3, 2, 4)
    dts = dt.to(f32).reshape(Bsz, nc, chunk, H).permute(1, 0, 3, 2)
    cums = torch.cumsum(a.to(f32).reshape(Bsz, nc, chunk, H)
                        .permute(1, 0, 3, 2), dim=-1)
    Bc = Bm.to(f32).reshape(Bsz, nc, chunk, N).transpose(0, 1)
    Cc = Cm.to(f32).reshape(Bsz, nc, chunk, N).transpose(0, 1)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
         if h0 is None else h0.to(f32))
    i = torch.arange(chunk, device=xh.device)
    causal = i[:, None] >= i[None, :]
    ys = []
    for c in range(nc):
        cum, dtc = cums[c], dts[c]                        # (B, H, Q)
        seg = cum[..., :, None] - cum[..., None, :]       # (B, H, Q, Q)
        L = torch.exp(seg.masked_fill(~causal, float("-inf")))
        CB = Cc[c] @ Bc[c].transpose(-1, -2)              # (B, Q, Q)
        M = CB[:, None] * L * dtc[..., None, :]
        y = M @ x[c]                                      # (B, H, Q, P)
        y_off = (Cc[c][:, None] @ h.transpose(-1, -2)) \
            * torch.exp(cum)[..., None]
        w = torch.exp(cum[..., -1:] - cum) * dtc          # (B, H, Q)
        st = (x[c] * w[..., None]).transpose(-1, -2) @ Bc[c][:, None]
        h = h * torch.exp(cum[..., -1])[..., None, None] + st
        ys.append((y + y_off).transpose(1, 2))            # (B, Q, H, P)
    return torch.cat(ys, dim=1), h


def ssd_grouped(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_explicit`` with G groups of B and C: Bm, Cm (B, S, G, N), the
    H heads in G runs of H / G, each run reading its group's B and C (the
    Mamba2 layout, ``ngroups``). C.B^T is formed once per group and
    chunk, as the kernel forms it."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[-2:]
    if H % G:
        raise ValueError(f"ssd scan: {G} groups do not divide {H} heads")
    rep, nc, f32 = H // G, S // chunk, torch.float32
    x = xh.to(f32).reshape(Bsz, nc, chunk, H, P).permute(1, 0, 3, 2, 4)
    dts = dt.to(f32).reshape(Bsz, nc, chunk, H).permute(1, 0, 3, 2)
    cums = torch.cumsum(a.to(f32).reshape(Bsz, nc, chunk, H)
                        .permute(1, 0, 3, 2), dim=-1)
    # (nc, B, G, Q, N)
    Bc = Bm.to(f32).reshape(Bsz, nc, chunk, G, N).permute(1, 0, 3, 2, 4)
    Cc = Cm.to(f32).reshape(Bsz, nc, chunk, G, N).permute(1, 0, 3, 2, 4)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
         if h0 is None else h0.to(f32))
    i = torch.arange(chunk, device=xh.device)
    causal = i[:, None] >= i[None, :]
    ys = []
    for c in range(nc):
        cum, dtc = cums[c], dts[c]                        # (B, H, Q)
        seg = cum[..., :, None] - cum[..., None, :]       # (B, H, Q, Q)
        L = torch.exp(seg.masked_fill(~causal, float("-inf")))
        CB = Cc[c] @ Bc[c].transpose(-1, -2)              # (B, G, Q, Q)
        M = CB.repeat_interleave(rep, dim=1) * L * dtc[..., None, :]
        y = M @ x[c]                                      # (B, H, Q, P)
        Ch = Cc[c].repeat_interleave(rep, dim=1)          # (B, H, Q, N)
        y_off = (Ch @ h.transpose(-1, -2)) * torch.exp(cum)[..., None]
        w = torch.exp(cum[..., -1:] - cum) * dtc          # (B, H, Q)
        st = (x[c] * w[..., None]).transpose(-1, -2) \
            @ Bc[c].repeat_interleave(rep, dim=1)
        h = h * torch.exp(cum[..., -1])[..., None, None] + st
        ys.append((y + y_off).transpose(1, 2))            # (B, Q, H, P)
    return torch.cat(ys, dim=1), h


def ssd_scan_ref(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                 h0: Optional[torch.Tensor] = None,
                 return_state: bool = False):
    """The plain version of the SSD scan kernel
    (``src/repro/kernels/ref.py::ssd_scan_ref``): y in xh's dtype, the
    state starting at ``h0`` (zero when None); with ``return_state``, (y,
    the final state fp32)."""
    y, h = ssd_explicit(xh, dt, a, Bm, Cm, chunk, h0)
    return (y.to(xh.dtype), h) if return_state else y.to(xh.dtype)


# -- the SSD scan as the CUDA kernels decompose it ----------------------------------
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to the nearest TF32 value (10 stored mantissa bits,
    ties away from zero), as ``cvt.rna.tf32.f32`` and then clearing the 13
    low bits do on the card. Finite inputs."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 truncated to TF32 (the 13 low bits cleared), as the tensor
    cores read an fp32 bit pattern given as a TF32 operand."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels' 3xTF32 split computes it: a = a_hi + a_lo and
    b = b_hi + b_lo, hi rounded to TF32 and the remainder truncated to
    TF32 by the tensor cores, and a_lo b_hi + a_hi b_lo + a_hi b_hi summed
    in fp32 (a product of two TF32 values is exact in fp32, so only the
    sums, the truncation and the dropped a_lo b_lo err)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) \
        + torch.matmul(a_hi, b_hi)


def ssd_chunk_cb(Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 mm=torch.matmul) -> torch.Tensor:
    """C_c . B_c^T per (batch, chunk), shared by the heads: (B, nc, Q, Q);
    only the causal half (j <= i) is used."""
    Bsz, S, N = Bm.shape
    Bc = Bm.to(torch.float32).reshape(Bsz, S // chunk, chunk, N)
    Cc = Cm.to(torch.float32).reshape(Bsz, S // chunk, chunk, N)
    return mm(Cc, Bc.transpose(-1, -2))


def ssd_chunk_cumsum(a: torch.Tensor, chunk: int) -> torch.Tensor:
    """cumsum(a) within each chunk: (B, H, nc, Q)."""
    Bsz, S, H = a.shape
    return torch.cumsum(a.to(torch.float32).reshape(Bsz, S // chunk, chunk, H)
                        .permute(0, 3, 1, 2), dim=-1)


def ssd_chunk_state(xh: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    Bm: torch.Tensor, chunk: int,
                    mm=torch.matmul) -> torch.Tensor:
    """Each chunk's own state sum_j exp(cum_last - cum_j) dt_j x_j B_j^T:
    (B, H, nc, P, N)."""
    Bsz, S, H, P = xh.shape
    nc, N = S // chunk, Bm.shape[-1]
    x = xh.to(torch.float32).reshape(Bsz, nc, chunk, H, P) \
        .permute(0, 3, 1, 2, 4)                               # (B, H, nc, Q, P)
    dts = dt.to(torch.float32).reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2)
    w = torch.exp(cum[..., -1:] - cum) * dts                  # (B, H, nc, Q)
    Bc = Bm.to(torch.float32).reshape(Bsz, 1, nc, chunk, N)
    return mm((x * w[..., None]).transpose(-1, -2), Bc)


def ssd_state_pass(st: torch.Tensor, cum: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """The state entering each chunk: h_0 = ``h0`` (zero when None),
    h_{c+1} = exp(cum_last(c)) h_c + st_c. (B, H, nc, P, N); with
    ``return_state``, also the state after the last chunk (B, H, P, N)."""
    h = torch.zeros_like(st[:, :, 0]) if h0 is None else h0.to(st.dtype)
    out = []
    for c in range(st.shape[2]):
        out.append(h)
        h = h * torch.exp(cum[:, :, c, -1])[..., None, None] + st[:, :, c]
    return (torch.stack(out, dim=2), h) if return_state \
        else torch.stack(out, dim=2)


def ssd_chunk_scan(xh: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                   Cm: torch.Tensor, cb: torch.Tensor, h_in: torch.Tensor,
                   chunk: int, mm=torch.matmul) -> torch.Tensor:
    """Each chunk's output, exp(cum_i) C_i . h_c^T + (CB o L o dt) . x, the
    decay masked before its exp: (B, S, H, P)."""
    Bsz, S, H, P = xh.shape
    nc, N = S // chunk, Cm.shape[-1]
    x = xh.to(torch.float32).reshape(Bsz, nc, chunk, H, P) \
        .permute(0, 3, 1, 2, 4)
    dts = dt.to(torch.float32).reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2)
    i = torch.arange(chunk, device=xh.device)
    causal = i[:, None] >= i[None, :]
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal,
                                                              float("-inf"))
    M = cb[:, None] * torch.exp(seg) * dts[..., None, :]     # (B, H, nc, Q, Q)
    Cc = Cm.to(torch.float32).reshape(Bsz, 1, nc, chunk, N)
    y = mm(Cc, h_in.transpose(-1, -2)) * torch.exp(cum)[..., None] \
        + mm(M, x)
    return y.permute(0, 2, 3, 1, 4).reshape(Bsz, S, H, P)


def ssd_decomposed(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                   mm=torch.matmul, h0: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """The SSD scan (state starting at ``h0``, zero when None) as the CUDA
    kernels compute it: C.B^T once per (batch, chunk), every chunk's state
    in parallel, a pass that forms the state entering each chunk (and the
    final state), then every chunk's output in parallel.
    ``mm=matmul_3xtf32`` does the products as the card's tensor cores do.
    fp32 (B, S, H, P); with ``return_state``, (y, the final state)."""
    if xh.shape[1] % chunk:
        raise ValueError(f"ssd scan: chunk {chunk} does not divide "
                         f"S={xh.shape[1]}")
    cum = ssd_chunk_cumsum(a, chunk)
    st = ssd_chunk_state(xh, dt, cum, Bm, chunk, mm)
    h_in, h = ssd_state_pass(st, cum, h0, return_state=True)
    y = ssd_chunk_scan(xh, dt, cum, Cm, ssd_chunk_cb(Bm, Cm, chunk, mm),
                       h_in, chunk, mm)
    return (y, h) if return_state else y
