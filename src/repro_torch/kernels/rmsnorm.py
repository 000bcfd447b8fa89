"""Hopper row-wise RMSNorm that reads each row once.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm_rows`` (``pallas_call`` at
:33). The kernel is ``csrc/rmsnorm.cu``; its header gives the bound on the
H100 (bytes: one read of x, one write of y) and the design (a warp, or 128
or 256 threads for wide rows, holds the row in registers from 16-byte
loads between the sum of squares and the write). fp32 math; the output
keeps x's dtype (float32 or bfloat16), one kernel for both. A grouped
(G, d) scale normalises each of G equal runs of rows with its own row (one
client each, under ``vmap``).

CUDA tensors only; ``repro_torch.kernels.ops.rmsnorm`` counts launches,
sends CPU tensors to ``ref.rmsnorm_ref`` and adds the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_c = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib) -> None:
    lib.rmsnorm_rows_launch.argtypes = [_c, _c, _c, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_float,
                                        ctypes.c_int, ctypes.c_longlong, _c]
    lib.rmsnorm_rows_launch.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """x: (R, d) contiguous float32/bfloat16 on CUDA; scale: (d,) float32,
    or (G, d) with G dividing R (rows [g R/G, (g+1) R/G) use scale[g]).
    Returns (R, d) in x's dtype."""
    if x.device.type != "cuda" or x.dim() != 2 or not x.is_contiguous() \
            or x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm_rows takes a contiguous (R, d) "
                         f"float32/bfloat16 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    R, d = x.shape
    groups = scale.shape[0] if scale.dim() == 2 else 1
    if scale.shape[-1:] != (d,) or scale.dim() > 2 or R % groups \
            or scale.dtype != torch.float32 or scale.device != x.device \
            or not scale.is_contiguous():
        raise ValueError(f"rmsnorm_rows: scale must be a contiguous ({d},) "
                         f"or (G, {d}) float32 tensor on {x.device} with G "
                         f"dividing {R}, got {tuple(scale.shape)}")
    lib = build.load("rmsnorm", _declare)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.rmsnorm_rows_launch(x.data_ptr(), scale.data_ptr(),
                                        y.data_ptr(), R, d, float(eps),
                                        _DTYPES[x.dtype],
                                        max(1, R // groups), stream),
                lib.rmsnorm_error_string, "rmsnorm_rows")
    return y
