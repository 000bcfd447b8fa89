"""Hopper RoPE: q and k rotated in one bf16 (or fp16, fp32) pass.

Replaces no TPU kernel: the reference's RoPE is jnp code
(``src/repro/models/layers/rope.py:12``), and so was the port's until its
plain version, a dozen fp32 ATen kernels a tensor, became the largest share
of the ViT's forward on the card. The kernel is ``csrc/rope.cu``; its
header gives the bound (bytes: one read of x, one write of y in x's dtype)
and the design (16-byte loads of 8 elements of each half, grid-stride over
q's rows and then k's, the products and sums rounded one by one, so the
output is the plain version's to the bit). ``inverse`` negates the sin
table in registers: the rotation's backward.

CUDA tensors only; ``repro_torch.kernels.ops.rope`` / ``rope_qk`` count
launches, send CPU tensors to ``ref.rope_ref``, make x contiguous and add
the backward.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _declare(lib) -> None:
    lib.rope_launch.argtypes = [_c, _c, _ll, ctypes.c_int,
                                _c, _c, _ll, ctypes.c_int,
                                _c, _c, _ll, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, _c]
    lib.rope_launch.restype = ctypes.c_int
    lib.rope_error_string.argtypes = [ctypes.c_int]
    lib.rope_error_string.restype = ctypes.c_char_p


def _refuse(what: str):
    raise ValueError(f"rope_rotate: {what}")


def rope_rotate(xs: Sequence[torch.Tensor], cos: torch.Tensor,
                sin: torch.Tensor, inverse: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """xs: one or two (q, k) contiguous (..., S, H, hd) CUDA tensors of one
    dtype (float32, bfloat16 or float16) and head dim (even), their head
    counts free; cos, sin: contiguous float32 (..., S, hd / 2) whose
    leading shape ends each x's leading shape (..., S) (a (S, hd / 2) table
    serves every batch row). Returns the rotated tensors in x's dtype, one
    launch for all; ``inverse`` rotates by the negated angle."""
    if len(xs) not in (1, 2):
        _refuse(f"takes one or two tensors, got {len(xs)}")
    x0 = xs[0]
    for x in xs:
        if x.device.type != "cuda" or x.dim() < 3 or not x.is_contiguous() \
                or x.dtype not in _DTYPES or x.dtype != x0.dtype \
                or x.device != x0.device or x.shape[-1] != x0.shape[-1] \
                or x.shape[-1] % 2:
            _refuse(f"takes contiguous (..., S, H, hd) float32 / bfloat16 "
                    f"/ float16 CUDA tensors of one dtype and an even head "
                    f"dim, got {[(t.dtype, tuple(t.shape), str(t.device)) for t in xs]}")
    half = x0.shape[-1] // 2
    lead = cos.shape[:-1]
    for t in (cos, sin):
        if t.dtype != torch.float32 or t.device != x0.device \
                or not t.is_contiguous() or t.shape != cos.shape \
                or t.dim() < 2 or t.shape[-1] != half:
            _refuse(f"cos and sin must be contiguous float32 (..., S, "
                    f"{half}) tensors on {x0.device}, got "
                    f"{[(u.dtype, tuple(u.shape), str(u.device)) for u in (cos, sin)]}")
    for x in xs:
        xl = x.shape[:-2]
        if len(lead) > len(xl) or xl[len(xl) - len(lead):] != lead:
            _refuse(f"the table's positions {tuple(lead)} do not end x's "
                    f"{tuple(xl)}")
    lib = build.load("rope", _declare)
    outs = tuple(torch.empty_like(x) for x in xs)
    q, qo = xs[0], outs[0]
    k, ko = (xs[1], outs[1]) if len(xs) == 2 else (q, qo)
    k_rows = k.numel() // (2 * half) if len(xs) == 2 else 0
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    build.check(lib.rope_launch(
        q.data_ptr(), qo.data_ptr(), q.numel() // (2 * half), q.shape[-2],
        k.data_ptr(), ko.data_ptr(), k_rows, k.shape[-2],
        cos.data_ptr(), sin.data_ptr(), max(1, cos.numel() // half), half,
        _DTYPES[x0.dtype], int(bool(inverse)), stream),
        lib.rope_error_string, "rope_rotate")
    return outs
