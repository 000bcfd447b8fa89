"""Hopper row-wise RMSNorm, one warp per row.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm_rows`` (``pallas_call`` at
:33). The kernel is ``csrc/rmsnorm.cu``; its header gives the bound on the
H100 (bytes: one read of x, one write of y) and the design (warp per row,
shuffle reduction, no shared memory). fp32 math; the output keeps x's
dtype (float32 or bfloat16).

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
                                        ctypes.c_int, _c]
    lib.rmsnorm_rows_launch.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """x: (R, d) contiguous float32/bfloat16 on CUDA; scale: (d,) float32.
    Returns (R, d) in x's dtype."""
    if x.device.type != "cuda" or x.dim() != 2 or not x.is_contiguous() \
            or x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm_rows takes a contiguous (R, d) "
                         f"float32/bfloat16 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    R, d = x.shape
    if scale.shape != (d,) or scale.dtype != torch.float32 \
            or scale.device != x.device or not scale.is_contiguous():
        raise ValueError(f"rmsnorm_rows: scale must be a contiguous ({d},) "
                         f"float32 tensor on {x.device}")
    lib = build.load("rmsnorm", _declare)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.rmsnorm_rows_launch(x.data_ptr(), scale.data_ptr(),
                                        y.data_ptr(), R, d, float(eps),
                                        _DTYPES[x.dtype], stream),
                lib.rmsnorm_error_string, "rmsnorm_rows")
    return y
