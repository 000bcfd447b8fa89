"""Public wrappers around the port's kernels.

Each wrapper looks at the device of the tensors it is given: CPU tensors go
to the plain version in ``ref.py``; CUDA tensors go to the hand-written
kernel, which either launches or raises (there is no fallback). Every
kernel launch adds one to ``LAUNCHES[name]``, so a run can show that its
main path went through the kernels; ``GraphLaunches`` keeps the count for
kernels replayed in a CUDA graph.

``rmsnorm``, ``flash_attention``, ``info_nce_rows`` and ``ssd_scan`` are
``torch.autograd.Function``s whose forward is the kernel (or the plain
version on the CPU). The backward of the first two is the closed-form
gradient in plain PyTorch (``ref.*_bwd_ref``), recomputed from the saved
inputs, the same code on every device; InfoNCE's backward is a kernel too
(``InfoNCEGradFn``); the SSD scan's is the vector-Jacobian product of its
plain version, recomputed from the saved inputs (the JAX package has no
backward kernel for it either). Every Function has the ``setup_context``
form and a ``vmap`` rule, so the vectorised engines can run them under
``torch.func.vmap``: the rule moves the vmapped (client) axis to
the front and hands it to the kernel in one launch, folded into the rows
(RMSNorm, with a per-client scale), into the batch (attention, the SSD
scan), or as the kernel's own client axis (InfoNCE, whose negatives must
stay per client). The engines differentiate outside the ``vmap`` (one
``torch.autograd.grad`` of the clients' summed losses), so the backward
that runs is the node each rule's ``.apply`` records on the folded
tensors: it returns every client's gradient at once, and a per-client
operand's gradient stays per client (RMSNorm's (G, d) scale, InfoNCE's
client axis). ``torch.func.grad`` under ``vmap`` works too.

``wire_cast_encode`` / ``wire_cast_decode`` and ``wire_topk_decode`` are
plain PyTorch on every device: in the reference they are not Pallas
kernels either.

FLOP counting. ``torch.utils.flop_counter.FlopCounterMode`` counts aten ops
at the dispatcher. On the card the forwards of attention, InfoNCE (and its
gradients) and the SSD scan leave PyTorch for a hand-written kernel, which
the counter cannot see; on the CPU they run the plain versions, whose
products it does see. So while a dispatch mode is active each of them goes
through a ``torch.library.custom_op`` with a registered FLOP formula
(``attention_flops``, ``info_nce_flops``, ``ssd_scan_flops``): the counter
counts the op once, by its formula, on either device, and the op's body
runs with the mode switched off, so the counter never descends into the
kernel's plain version. Without a dispatch mode the bodies are called
directly: the dispatcher adds host time to every call of a host-bound
step (``chip_smoke.py`` phase 2f times both routes) and changes nothing
else. RMSNorm is a custom op too, with no formula (the counter counts no
elementwise work).

Sharded steps. A ``DTensor`` operand also sends a kernel through its
custom op, where ``register_sharding`` gives DTensor the op's sharding
rule: attention over the batch and the heads (q and kv heads split
together, replicated where the kv head count does not divide), RMSNorm
over rows, the SSD scan over the batch and the heads, InfoNCE replicated
(each row's positive is the row of k with its own index, so neither
operand's rows can be split). DTensor redistributes the operands to one of those layouts
and calls the op on each device's local tensors, so the kernels run
unchanged on a shard. ``register_fake`` gives each op its output shapes
on ``meta`` (the dry run); outside those fakes ``_device_kind`` refuses
``meta``, so no ``meta`` tensor reaches a kernel or a plain version. An
op with no rule raises in DTensor's propagation: there is no fallback.
The backwards of RMSNorm, attention and the SSD scan run their plain
versions on each device's local tensors, in the layout the forward's rule
chose (a partial sum where a gradient adds over a split: RMSNorm's scale
over rows, the scan's Bm and Cm over heads); InfoNCE's gradient kernels are
ops with a rule of their own.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import infonce as nce
from repro_torch.kernels import mamba2_scan as ms
from repro_torch.kernels import pack, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import wire_codecs as wc

KERNELS = ("gather_pack", "scatter_unpack", "rmsnorm_rows", "flash_attention",
           "int8_quant_matrix", "int8_dequant_matrix", "compensate",
           "topk_ef_update", "info_nce_rows", "info_nce_rows_dq",
           "info_nce_rows_dk", "ssd_scan")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


class GraphLaunches:
    """Keeps ``LAUNCHES`` a count of the kernels that ran where they run
    inside a CUDA graph. The counters count on the host, at each call: a
    capture calls every kernel of the graph and runs none, and a replay
    runs them all and calls none. ``capture()`` wraps the capture, records
    the launches it counted (``delta``) and takes them back out;
    ``replayed()`` adds them once for each replay."""

    def __init__(self):
        self.delta: Dict[str, int] = {}

    @contextlib.contextmanager
    def capture(self):
        before = dict(LAUNCHES)
        try:
            yield self
        finally:
            self.delta = {k: LAUNCHES[k] - before[k] for k in KERNELS
                          if LAUNCHES[k] != before[k]}
            for k, n in self.delta.items():
                LAUNCHES[k] -= n

    def replayed(self) -> None:
        for k, n in self.delta.items():
            LAUNCHES[k] += n


def _device_kind(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device type '{kind}'")
    return kind


def _via_op(*tensors) -> bool:
    """True while a dispatch mode (``FlopCounterMode``) is active, or when
    a tensor is a ``DTensor``: the kernels then go through their custom
    ops, which carry a FLOP formula, a fake implementation and a sharding
    rule."""
    return torch._C._len_torch_dispatch_stack() > 0 or \
        any(isinstance(t, DTensor) for t in tensors)


def _divides_heads(mesh, *counts: int) -> bool:
    """Whether sharding head counts over any set of mesh dims splits every
    count evenly, wherever a dim's shard count does not exceed the
    smallest count (DTensor drops those strategies itself). q heads and kv
    heads split together keep each q head's kv head only then."""
    sizes = [s for s in mesh.shape if s > 1]
    for pick in range(1, 1 << len(sizes)):
        n = 1
        for i, s in enumerate(sizes):
            if pick >> i & 1:
                n *= s
        if n <= min(counts) and any(c % n for c in counts):
            return False
    return True


def _layout(out):
    """(mesh, placements) of a forward's DTensor result, else None: the
    layout its sharding rule chose, which the backward reuses."""
    t = out[0] if isinstance(out, tuple) else out
    if isinstance(t, DTensor):
        return t.device_mesh, tuple(t.placements)
    return None


def _local(t, mesh, placements):
    """The local shard of ``t`` laid out as ``placements`` (``t`` a DTensor,
    or None)."""
    if t is None:
        return None
    return t.redistribute(mesh, placements).to_local()


def _dtensor(local, mesh, placements, like):
    """``local`` as the shard of a DTensor of ``like``'s global shape, its
    global strides in ``local``'s memory order."""
    from repro_torch.sharding.aten import global_stride
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=like.shape,
                              stride=global_stride(local, like.shape))


def _per_dim(placements, rule):
    """Placements derived mesh dim by mesh dim: ``rule`` maps the
    result's placement on a dim to an operand's."""
    return tuple(rule(p) for p in placements)


def attention_flops(q_shape, k_shape, causal: bool, v_shape=None) -> int:
    """The two products of attention over BSHD shapes, q.k^T over the q/k
    head dim and p.v over the v head dim (k's when ``v_shape`` is None):
    2 B Hq S T (hd + dv), halved where causal."""
    B, S, Hq, hd = q_shape
    dv = hd if v_shape is None else v_shape[-1]
    flops = 2 * B * Hq * S * k_shape[1] * (hd + dv)
    return flops // 2 if causal else flops


def info_nce_flops(q_shape, k_shape, products: int = 1) -> int:
    """``products`` (C, Bq, d) x (C, Bk, d)^T products: 2 C Bq Bk d each
    (the forward has one; each gradient recomputes the logits and makes
    one more)."""
    C, Bq, d = q_shape
    return products * 2 * C * Bq * k_shape[1] * d


def ssd_scan_flops(xh_shape, bm_shape, chunk: int) -> int:
    """The scan's forward as the roofline counts it
    (``roofline.analysis.chunk_loop_correction``): per sequence 2 S Q N G
    (C.B, once per group; G = 1 for a (B, S, N) Bm) + 2 S Q H P (mask.x) +
    4 S N H P (state in and out)."""
    B, S, H, P = xh_shape
    N = bm_shape[-1]
    G = bm_shape[2] if len(bm_shape) == 4 else 1
    return B * (2 * S * chunk * N * G + 2 * S * chunk * H * P
                + 4 * S * N * H * P)


# -- wire pack / unpack -------------------------------------------------------
def wire_pack(srcs: Sequence[torch.Tensor],
              layout: Sequence[Tuple[int, int, int]],
              total: int) -> torch.Tensor:
    """Slot-table gather of raveled fp32 leaves into a (total,) buffer."""
    if _device_kind(*srcs) == "cpu":
        return ref.wire_pack_ref(srcs, layout, total)
    out = pack.gather_pack(srcs, layout, total)
    LAUNCHES["gather_pack"] += 1
    return out


def wire_unpack(flat: torch.Tensor, bases: Sequence[torch.Tensor],
                layout: Sequence[Tuple[int, int, int]]
                ) -> List[torch.Tensor]:
    """Slot-table scatter of ``flat`` over copies of the raveled bases."""
    if _device_kind(flat, *bases) == "cpu":
        return ref.wire_unpack_ref(flat, bases, layout)
    outs = pack.scatter_unpack(flat, bases, layout)
    LAUNCHES["scatter_unpack"] += 1
    return outs


# -- wire codecs ----------------------------------------------------------------
def wire_cast_encode(flat: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp16 / bf16 cast-on-the-wire (round to nearest even); a plain cast,
    as in the reference, where it is not a Pallas kernel either."""
    return flat.to(dtype)


def wire_cast_decode(wire: torch.Tensor) -> torch.Tensor:
    return wire.to(torch.float32)


def wire_int8_encode(flat: torch.Tensor, segs, nscales: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment int8 of the flat payload; ``segs`` rows are ``(offset,
    size, channels, scale_offset)``. Returns (q int8 of ``flat``'s length,
    scales fp32 (nscales,)). One kernel call for the whole table."""
    if _device_kind(flat) == "cpu":
        return ref.int8_encode_ref(flat, segs, nscales)
    out = wc.int8_quant(flat, segs, nscales)
    LAUNCHES["int8_quant_matrix"] += 1
    return out


def wire_int8_decode(q: torch.Tensor, scales: torch.Tensor, segs,
                     total: int) -> torch.Tensor:
    if _device_kind(q, scales) == "cpu":
        return ref.int8_decode_ref(q, scales, segs, total)
    out = wc.int8_dequant(q, scales, segs, total)
    LAUNCHES["int8_dequant_matrix"] += 1
    return out


def compensate(flat: torch.Tensor, ref_flat: torch.Tensor,
               res: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c, |c|), c = flat - ref_flat + res (``res`` None: zeros)."""
    tensors = (flat, ref_flat) if res is None else (flat, ref_flat, res)
    if _device_kind(*tensors) == "cpu":
        return ref.compensate_ref(flat, ref_flat, res)
    out = wc.compensate(flat, ref_flat, res)
    LAUNCHES["compensate"] += 1
    return out


def topk_ef_update(comp: torch.Tensor, thresh: torch.Tensor,
                   needed: torch.Tensor, k: int):
    """(new residual, idx int32 (k,), val (k,)) of the k entries top-k
    selects at ``thresh`` with ``needed`` ties, idx in position order."""
    if _device_kind(comp, thresh, needed) == "cpu":
        return ref.topk_ef_update_ref(comp, thresh, needed)
    out = wc.topk_ef_update(comp, thresh.reshape(1).to(torch.float32),
                            needed.reshape(1).to(torch.int64), k)
    LAUNCHES["topk_ef_update"] += 1
    return out


def wire_topk_encode_ef(flat: torch.Tensor, ref_flat: torch.Tensor,
                        res: Optional[torch.Tensor], k: int):
    """Top-k delta sparsification with error feedback: compensated delta
    ``flat - ref_flat (+ res)``, the exact ``lax.top_k`` set (ties at the
    threshold broken lowest index first), residual = the unselected mass.
    ``res`` None: the mirror path, no carried residual. Returns (idx int32
    (k,), val fp32 (k,), new residual (n,)); idx is in position order, the
    reference's is in magnitude order: the set is the same.

    The threshold value comes from ``torch.topk`` (the reference takes it
    from ``lax.top_k`` in XLA, not from a Pallas kernel); the selected set
    comes from the threshold and the tie rank, never from its indices."""
    comp, absc = compensate(flat, ref_flat, res)
    thresh, needed = ref.topk_threshold(absc, k)
    new_res, idx, val = topk_ef_update(comp, thresh, needed, k)
    return idx, val, new_res


def wire_topk_decode(idx: torch.Tensor, val: torch.Tensor,
                     total: int) -> torch.Tensor:
    """Dense (total,) payload with ``val`` at ``idx``: a plain scatter."""
    return ref.topk_decode_ref(idx, val, total)


def _front(x: torch.Tensor, bdim: Optional[int], size: int) -> torch.Tensor:
    """A vmapped operand with its vmapped axis first; an operand that is
    not vmapped (``bdim`` None) is broadcast along a new first axis."""
    if bdim is None:
        return x.expand(size, *x.shape)
    return x.movedim(bdim, 0)


# -- RMSNorm -------------------------------------------------------------------
def _rmsnorm_impl(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    if _device_kind(x, scale) == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    d = x.shape[-1]
    y = rn.rmsnorm_rows(x.reshape(-1, d).contiguous(),
                        scale.to(torch.float32).contiguous(), eps)
    LAUNCHES["rmsnorm_rows"] += 1
    return y.reshape(x.shape)


@torch.library.custom_op("repro_torch::rmsnorm_fwd", mutates_args=())
def _rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    return _rmsnorm_impl(x, scale, eps)


@_rmsnorm_op.register_fake
def _rmsnorm_fake(x, scale, eps):
    return torch.empty_like(x)


@register_sharding(torch.ops.repro_torch.rmsnorm_fwd.default)
def _rmsnorm_sharding(x, scale, eps):
    """Over rows: any dim of x but the normalised last one, the (d,)
    scale replicated (the (G, d) scale is ``vmap``'s, never a DTensor)."""
    return [([Replicate()], [Replicate(), Replicate(), None])] + [
        ([Shard(dim)], [Shard(dim), Replicate(), None])
        for dim in range(x.ndim - 1)]


def _rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    if _via_op(x, scale):
        return _rmsnorm_op(x, scale, eps)
    return _rmsnorm_impl(x, scale, eps)


class RMSNormFn(torch.autograd.Function):
    """y = x * rsqrt(mean(x^2) + eps) * scale over the last dim. scale is
    (d,), or (G, d) with one row per index of x's leading axis (the form
    the ``vmap`` rule hands on for a per-client scale)."""

    @staticmethod
    def forward(x, scale, eps):
        return _rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, eps = inputs
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.layout = _layout(output)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        if ctx.layout is None:
            return (*ref.rmsnorm_bwd_ref(x, scale, g, ctx.eps), None)
        # sharded: the plain backward on each device's rows, in the layout
        # the forward's rule chose; the scale's gradient is a partial sum
        # over the mesh dims that split the rows
        mesh, pl = ctx.layout
        whole = (Replicate(),) * len(pl)
        gx, gs = ref.rmsnorm_bwd_ref(_local(x, mesh, pl),
                                     _local(scale, mesh, whole),
                                     _local(g, mesh, pl), ctx.eps)
        gs_pl = _per_dim(pl, lambda p: Partial() if isinstance(p, Shard)
                         else Replicate())
        return (_dtensor(gx, mesh, pl, x), _dtensor(gs, mesh, gs_pl, scale),
                None)

    @staticmethod
    def vmap(info, in_dims, x, scale, eps):
        if scale.dim() - (in_dims[1] is not None) != 1:
            raise ValueError("rmsnorm under vmap takes a (d,) scale")
        x = _front(x, in_dims[0], info.batch_size)
        if in_dims[1] is not None:
            scale = scale.movedim(in_dims[1], 0)
        return RMSNormFn.apply(x, scale, eps), 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,). fp32 math, output in x's dtype."""
    return RMSNormFn.apply(x, scale, eps)


# -- attention -----------------------------------------------------------------
def _attention_impl(q, k, v, causal, window, kv_len, scale):
    if _device_kind(q, k, v) == "cpu":
        out = ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, window=window,
                           kv_len=kv_len, scale=scale)
        return out.transpose(1, 2)
    out = fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                  kv_len=kv_len, scale=scale)
    LAUNCHES["flash_attention"] += 1
    return out


@torch.library.custom_op("repro_torch::attention_fwd", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int, kv_len: Optional[int],
                  scale: Optional[float]) -> torch.Tensor:
    return _attention_impl(q, k, v, causal, window, kv_len, scale)


@register_flop_formula(torch.ops.repro_torch.attention_fwd)
def _attention_op_flops(q, k, v, causal, *args, **kwargs) -> int:
    return attention_flops(q, k, causal, v)


@_attention_op.register_fake
def _attention_fake(q, k, v, causal, window, kv_len, scale):
    return q.new_empty(q.shape[:-1] + v.shape[-1:])


@register_sharding(torch.ops.repro_torch.attention_fwd.default)
def _attention_sharding(q, k, v, causal, window, kv_len, scale):
    """Over the batch, and over the heads where the q and kv head counts
    split alike (BSHD: dim 2); otherwise replicated."""
    rest = [None] * 4
    out = [([Replicate()], [Replicate()] * 3 + rest),
           ([Shard(0)], [Shard(0)] * 3 + rest)]
    if _divides_heads(q.mesh, q.shape[2], k.shape[2]):
        out.append(([Shard(2)], [Shard(2)] * 3 + rest))
    return out


def _attention_fwd(q, k, v, causal, window, kv_len, scale):
    if _via_op(q, k, v):
        return _attention_op(q, k, v, causal, window, kv_len, scale)
    return _attention_impl(q, k, v, causal, window, kv_len, scale)


class FlashAttentionFn(torch.autograd.Function):
    """Attention over BSHD tensors with GQA and causal / window / kv_len
    masks; the backward recomputes the probabilities in fp32."""

    @staticmethod
    def forward(q, k, v, causal, window, kv_len, scale):
        return _attention_fwd(q, k, v, causal, window, kv_len, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, *cfg = inputs
        ctx.save_for_backward(q, k, v)
        ctx.cfg = tuple(cfg)
        ctx.layout = _layout(output)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, kv_len, scale = ctx.cfg
        tensors = (q, k, v, g)
        if ctx.layout is not None:
            # sharded: the plain backward on each device's batch rows and
            # heads, in the layout the forward's rule chose (q, k, v and
            # the gradients alike)
            mesh, pl = ctx.layout
            tensors = [_local(t, mesh, pl) for t in tensors]
        dq, dk, dv = ref.sdpa_bwd_ref(
            *(t.transpose(1, 2) for t in tensors), causal=causal,
            window=window, kv_len=kv_len, scale=scale)
        grads = [d.transpose(1, 2) for d in (dq, dk, dv)]
        if ctx.layout is not None:
            grads = [_dtensor(d, mesh, pl, t)
                     for d, t in zip(grads, (q, k, v))]
        return (*grads, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, kv_len, scale):
        n = info.batch_size
        q, k, v = (_front(t, d, n).flatten(0, 1)
                   for t, d in zip((q, k, v), in_dims))
        out = FlashAttentionFn.apply(q, k, v, causal, window, kv_len, scale)
        return out.unflatten(0, (n, -1)), 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,Hq,hd); k: (B,T,Hkv,hd); v: (B,T,Hkv,dv) -> (B,S,Hq,dv)
    (BSHD layout, as the JAX package's ``ops.flash_attention``; dv differs
    from hd in MLA). ``scale`` defaults to 1/sqrt(hd)."""
    return FlashAttentionFn.apply(q, k, v, causal, window, kv_len, scale)


# -- InfoNCE -------------------------------------------------------------------
def _info_nce_impl(q, k, tau):
    if _device_kind(q, k) == "cpu":
        return ref.info_nce_rows_ref(q, k, tau)
    out = nce.info_nce_fwd(q.contiguous(), k.contiguous(), tau)
    LAUNCHES["info_nce_rows"] += 1
    return out


def _info_nce_bwd_impl(q, k, lse, g, tau, wrt_k):
    if _device_kind(q, k, lse, g) == "cpu":
        return ref.info_nce_rows_bwd_ref(q, k, lse, g, tau, wrt_k)
    out = nce.info_nce_bwd(q.contiguous(), k.contiguous(), lse.contiguous(),
                           g.to(torch.float32).contiguous(), tau, wrt_k)
    LAUNCHES["info_nce_rows_dk" if wrt_k else "info_nce_rows_dq"] += 1
    return out


@torch.library.custom_op("repro_torch::info_nce_fwd", mutates_args=())
def _info_nce_op(q: torch.Tensor, k: torch.Tensor,
                 tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _info_nce_impl(q, k, tau)


@register_flop_formula(torch.ops.repro_torch.info_nce_fwd)
def _info_nce_op_flops(q, k, *args, **kwargs) -> int:
    return info_nce_flops(q, k)


@_info_nce_op.register_fake
def _info_nce_fake(q, k, tau):
    return (q.new_empty(q.shape[:-1], dtype=torch.float32),
            q.new_empty(q.shape[:-1], dtype=torch.float32))


@register_sharding(torch.ops.repro_torch.info_nce_fwd.default)
def _info_nce_sharding(q, k, tau):
    """Replicated. Not over q's rows: row i's positive is k's row i, which
    a shard of q rows beside the whole k would pair with the wrong row.
    The model's losses give one client (a client axis of 1), so a split
    of the client axis has nothing to split."""
    return [([Replicate(), Replicate()], [Replicate(), Replicate(), None])]


@torch.library.custom_op("repro_torch::info_nce_bwd", mutates_args=())
def _info_nce_bwd_op(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                     g: torch.Tensor, tau: float,
                     wrt_k: bool) -> torch.Tensor:
    return _info_nce_bwd_impl(q, k, lse, g, tau, wrt_k)


@register_flop_formula(torch.ops.repro_torch.info_nce_bwd)
def _info_nce_bwd_op_flops(q, k, *args, **kwargs) -> int:
    return info_nce_flops(q, k, products=2)


@_info_nce_bwd_op.register_fake
def _info_nce_bwd_fake(q, k, lse, g, tau, wrt_k):
    return torch.empty_like(k if wrt_k else q, dtype=torch.float32)


@register_sharding(torch.ops.repro_torch.info_nce_bwd.default)
def _info_nce_bwd_sharding(q, k, lse, g, tau, wrt_k):
    return [([Replicate()], [Replicate()] * 4 + [None, None])]


def _info_nce_fwd(q, k, tau):
    if _via_op(q, k):
        return _info_nce_op(q, k, tau)
    return _info_nce_impl(q, k, tau)


def _info_nce_bwd(q, k, lse, g, tau, wrt_k):
    if _via_op(q, k, lse, g):
        return _info_nce_bwd_op(q, k, lse, g, tau, wrt_k)
    return _info_nce_bwd_impl(q, k, lse, g, tau, wrt_k)


def _fold_clients(info, in_dims, *tensors):
    """Operands of a vmapped InfoNCE Function with the vmapped axis folded
    into their own client axis: (n, C, ...) -> (n * C, ...)."""
    return [_front(t, d, info.batch_size).flatten(0, 1)
            for t, d in zip(tensors, in_dims)]


class InfoNCEFn(torch.autograd.Function):
    """Per-row InfoNCE of (C, B, d) L2-normalised q, k with in-batch
    negatives per client: returns (loss, lse), both (C, B); lse is saved
    for the backward and is not differentiable."""

    @staticmethod
    def forward(q, k, tau):
        return _info_nce_fwd(q, k, tau)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, tau = inputs
        _, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, lse)
        ctx.tau = tau

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, lse = ctx.saved_tensors
        dq = dk = None
        if ctx.needs_input_grad[0]:
            dq = InfoNCEGradFn.apply(q, k, lse, g, ctx.tau, False)
        if ctx.needs_input_grad[1]:
            dk = InfoNCEGradFn.apply(q, k, lse, g, ctx.tau, True)
        return dq, dk, None

    @staticmethod
    def vmap(info, in_dims, q, k, tau):
        n = info.batch_size
        loss, lse = InfoNCEFn.apply(*_fold_clients(info, in_dims[:2], q, k),
                                    tau)
        return (loss.unflatten(0, (n, -1)), lse.unflatten(0, (n, -1))), (0, 0)


class InfoNCEGradFn(torch.autograd.Function):
    """The InfoNCE gradient kernels (dq, or dk with ``wrt_k``) as a Function
    of their own, so that the backward also runs under ``vmap``; it is not
    differentiable again."""

    @staticmethod
    def forward(q, k, lse, g, tau, wrt_k):
        return _info_nce_bwd(q, k, lse, g, tau, wrt_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, _g):
        raise RuntimeError("the InfoNCE gradient is not differentiable")

    @staticmethod
    def vmap(info, in_dims, q, k, lse, g, tau, wrt_k):
        out = InfoNCEGradFn.apply(
            *_fold_clients(info, in_dims[:4], q, k, lse, g), tau, wrt_k)
        return out.unflatten(0, (info.batch_size, -1)), 0


def info_nce_rows(q: torch.Tensor, k: torch.Tensor,
                  tau: float) -> torch.Tensor:
    """Per-row InfoNCE losses ``logsumexp_j(q_i k_j / tau) - q_i k_i /
    tau`` of L2-normalised fp32 rows, differentiable in q and k. q, k:
    (B, d) -> (B,), or (C, B, d) -> (C, B) with negatives per client."""
    if q.dim() == 2:
        return InfoNCEFn.apply(q[None], k[None], float(tau))[0][0]
    return InfoNCEFn.apply(q, k, float(tau))[0]


# -- Mamba2 SSD scan -------------------------------------------------------------
def _ssd_impl(xh, dt, a, Bm, Cm, h0, chunk):
    tensors = (xh, dt, a, Bm, Cm) + (() if h0 is None else (h0,))
    if _device_kind(*tensors) == "cpu":
        y, h = ref.ssd_explicit(xh, dt, a, Bm, Cm, chunk, h0)
        return y.to(xh.dtype), h
    out = ms.ssd_scan_bshpn(xh, dt, a, Bm, Cm, chunk=chunk, h0=h0)
    LAUNCHES["ssd_scan"] += 1
    return out


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=())
def _ssd_op(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor],
            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _ssd_impl(xh, dt, a, Bm, Cm, h0, chunk)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
def _ssd_op_flops(xh, dt, a, Bm, Cm, *args, **kwargs) -> int:
    chunk = kwargs["chunk"] if "chunk" in kwargs else args[1]
    return ssd_scan_flops(xh, Bm, chunk)


@_ssd_op.register_fake
def _ssd_fake(xh, dt, a, Bm, Cm, h0, chunk):
    B, _, H, P = xh.shape
    return (torch.empty_like(xh),
            xh.new_empty((B, H, P, Bm.shape[-1]), dtype=torch.float32))


@register_sharding(torch.ops.repro_torch.ssd_scan_fwd.default)
def _ssd_sharding(xh, dt, a, Bm, Cm, h0, chunk):
    """Over the batch, and over the heads (xh, dt, a and y on dim 2, the
    states on dim 1; Bm and Cm, shared by the heads, replicated) where B and
    C form one group: a head shard of a grouped scan would map its heads to
    the wrong groups."""
    def h(p):
        return None if h0 is None else p
    R = Replicate()
    rules = [([R, R], [R] * 5 + [h(R), None]),
             ([Shard(0), Shard(0)], [Shard(0)] * 5 + [h(Shard(0)), None])]
    if Bm.ndim == 3:
        rules.append(([Shard(2), Shard(1)],
                      [Shard(2)] * 3 + [R, R, h(Shard(1)), None]))
    return rules


def _ssd_fwd(xh, dt, a, Bm, Cm, h0, chunk):
    if _via_op(xh, dt, a, Bm, Cm, h0):
        return _ssd_op(xh, dt, a, Bm, Cm, h0, chunk)
    return _ssd_impl(xh, dt, a, Bm, Cm, h0, chunk)


class SSDScanFn(torch.autograd.Function):
    """The chunked SSD scan from the state ``h0`` (zero when None).
    Returns (y, the final state). The backward recomputes the plain
    version from the saved inputs and returns its vector-Jacobian product
    for xh, dt, a, Bm, Cm and h0."""

    @staticmethod
    def forward(xh, dt, a, Bm, Cm, h0, chunk):
        return _ssd_fwd(xh, dt, a, Bm, Cm, h0, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, h0, chunk = inputs
        ctx.save_for_backward(*tensors, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.layout = _layout(output)

    @staticmethod
    def backward(ctx, gy, gh=None):
        *tensors, h0 = ctx.saved_tensors
        if ctx.layout is None:
            grads = SSDScanFn._plain_backward(tensors, h0, gy, gh,
                                              ctx.chunk)
        else:
            # sharded: the plain backward on each device's batch rows and
            # heads, in the layout the forward's rule chose; Bm and Cm,
            # shared by the heads, get partial sums over a head split
            mesh, pl = ctx.layout
            bc = _per_dim(pl, lambda p: Shard(0) if p == Shard(0)
                          else Replicate())
            st = _per_dim(pl, lambda p: Shard(1) if p == Shard(2) else p)
            lay = (pl, pl, pl, bc, bc)
            local = [_local(t, mesh, p) for t, p in zip(tensors, lay)]
            grads = SSDScanFn._plain_backward(
                local, _local(h0, mesh, st), _local(gy, mesh, pl),
                _local(gh, mesh, st), ctx.chunk)
            dbc = _per_dim(pl, lambda p: Shard(0) if p == Shard(0) else
                           Partial() if p == Shard(2) else Replicate())
            lay = (pl, pl, pl, dbc, dbc, st)
            grads = [_dtensor(d, mesh, p, t) for d, p, t in
                     zip(grads, lay, (*tensors, h0))]
        if h0 is None:
            return (*grads[:5], None, None)
        return (*grads, None)

    @staticmethod
    def _plain_backward(tensors, h0, gy, gh, chunk):
        """The vector-Jacobian product of the plain scan: xh, dt, a, Bm,
        Cm's gradients (and h0's, with an h0); a missing cotangent (of y or
        of the final state) counts as zeros."""
        if gy is None:
            gy = torch.zeros_like(tensors[0])
        ins = tensors if h0 is None else (*tensors, h0)

        def plain(*t):
            y, h = ref.ssd_explicit(*t[:5], chunk,
                                    None if h0 is None else t[5])
            return y.to(tensors[0].dtype), h

        (_, hT), vjp = torch.func.vjp(plain, *ins)
        return vjp((gy, torch.zeros_like(hT) if gh is None else gh))

    @staticmethod
    def vmap(info, in_dims, xh, dt, a, Bm, Cm, h0, chunk):
        n = info.batch_size
        ins = [_front(t, d, n).flatten(0, 1) for t, d in
               zip((xh, dt, a, Bm, Cm), in_dims)]
        if h0 is not None:
            h0 = _front(h0, in_dims[5], n).flatten(0, 1)
        y, h = SSDScanFn.apply(*ins, h0, chunk)
        return (y.unflatten(0, (n, -1)), h.unflatten(0, (n, -1))), (0, 0)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """Chunked SSD scan (``src/repro/kernels/ops.py::ssd_scan``): xh (B, S,
    H, P); dt, a = dt * A (B, S, H); Bm, Cm (B, S, N), or (B, S, G, N) for
    G groups (head h reads group h // (H / G)) -> y (B, S, H, P) in
    xh's dtype, fp32 math (the CUDA kernel takes float32 only, which is
    what ``mamba2_apply`` passes). ``h0`` (B, H, P, N) fp32 is the state
    entering the first position (zero when None); ``return_state`` also
    returns the state after the last, fp32 (B, H, P, N). ``chunk`` must
    divide S (the caller takes ``min(chunk_size, S)``, as the JAX wrapper
    does)."""
    if xh.shape[1] % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} does not divide "
                         f"S={xh.shape[1]}")
    y, h = SSDScanFn.apply(xh, dt, a, Bm, Cm, h0, int(chunk))
    return (y, h) if return_state else y
