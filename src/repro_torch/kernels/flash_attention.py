"""Hopper flash attention forward (GQA; causal, sliding-window and kv_len
masks).

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_bhsd``
(``pallas_call`` at :106) and the padding wrapper
``src/repro/kernels/ops.py:54``. The kernels are in
``csrc/flash_attention.cu``, whose header gives the bound on the H100 and
the design: bfloat16 inputs go to a tensor-core kernel (``mma.sync`` bf16
with fp32 accumulators, 16 q rows a warp, ``cp.async`` 16-byte loads, p
rounded to bf16 for p.v), float32 inputs to a CUDA-core kernel that keeps
everything in fp32. Unlike the TPU wrapper nothing is padded: ragged
sequence ends are masked in the kernel and the head dims are used as they
are: the (q/k, v) pairs of ``HEAD_DIMS``, where MLA's v head is narrower
than its q/k head (deepseek-v2: 192 / 128; its ``reduced()``: 48 / 32).

CUDA tensors only; ``repro_torch.kernels.ops.flash_attention`` counts
launches, sends CPU tensors to ``ref.sdpa_ref`` and adds the backward.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_c = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the (q/k head dim, v head dim) pairs both kernels are built for
HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128), (48, 32))


def _declare(lib) -> None:
    i = ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        _c, _c, _c, _c, i, i, i, i, i, i, i, i,
        ctypes.POINTER(ctypes.c_longlong), i, i, i, ctypes.c_float, _c]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.attention_error_string.argtypes = [ctypes.c_int]
    lib.attention_error_string.restype = ctypes.c_char_p


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int = 0,
                         kv_len: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, Hq, hd); k: (B, T, Hkv, hd); v: (B, T, Hkv, dv), all on
    CUDA in one dtype (float32 or bfloat16) with a contiguous head dim,
    (hd, dv) one of ``HEAD_DIMS``. Other strides are free at float32; at
    bfloat16 each base address and each batch, sequence and head stride
    must be a multiple of 16 bytes (the kernel copies 16 bytes at a time),
    else this raises. Returns a contiguous (B, S, Hq, dv) tensor of q's
    dtype. ``kv_len`` masks keys at positions >= kv_len; ``scale``
    defaults to 1/sqrt(hd)."""
    B, S, Hq, hd = q.shape
    Bk, T, Hkv, hdk = k.shape
    dv = v.shape[-1]
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention_bshd takes CUDA tensors on one "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_bshd: q, k, v must share a "
                         f"float32/bfloat16 dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if (hd, dv) not in HEAD_DIMS or hdk != hd or Bk != B \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention_bshd: (q/k, v) head dims must be "
                         f"one of {HEAD_DIMS} and shapes must agree, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_bshd: Hq={Hq} is not a multiple "
                         f"of Hkv={Hkv}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_bshd: head dim must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for n, st in zip(
                t.shape[:3], t.stride()[:3]) if n > 1)
            for t in (q, k, v)):
        raise ValueError(
            "flash_attention_bshd: bfloat16 q, k, v need 16-byte aligned "
            "bases and batch, sequence and head strides that are multiples "
            f"of 8 elements, got strides {q.stride()}, {k.stride()}, "
            f"{v.stride()}")
    o = torch.empty((B, S, Hq, dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, o)
          for st in (t.stride(0), t.stride(1), t.stride(2))))
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    kv_len = T if kv_len is None else int(kv_len)
    lib = build.load("flash_attention", _declare)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], hd, dv, B, Hq, Hkv, S, T, strides, int(causal),
        int(window), kv_len, scale, stream),
        lib.attention_error_string, "flash_attention")
    return o
