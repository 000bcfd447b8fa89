"""Hopper InfoNCE with in-batch negatives per client: forward and the two
gradients.

Replaces ``src/repro/kernels/infonce.py::info_nce_rows`` (``pallas_call``
at :72), which has no backward. The kernels are ``csrc/infonce.cu``; its
header gives the bound on the H100 (operations) and the design: a logits
kernel spread over (32 x 32 tile, 256-wide slice of d, client) blocks,
the slice split across the block's warps, writes partial q.k^T to an
L2-resident scratch; a second kernel sums the slices in a fixed order and
takes the rows' max, sum and gold logit (forward) or forms the weights
once per tile and multiplies them into the other side's rows (dq, dk).
No atomics, so the results are bitwise deterministic and do not depend on
C. ``ref.info_nce_rows_split`` is the same split in plain PyTorch. q and
k carry a leading client axis C: each client's rows see only that
client's negatives.

CUDA tensors only; ``repro_torch.kernels.ops.info_nce_rows`` counts
launches (one per call, for the call's two kernels), sends CPU tensors to
``ref.info_nce_rows_ref`` / ``ref.info_nce_rows_bwd_ref`` and wires the
backward.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_c = ctypes.c_void_p
# the gradient kernels' grid has one y index per 64-wide d chunk, and a
# grid's y extent is at most 65535; nothing else in the kernels caps d
MAX_D = 65535 * 64
D_SLICE = 256       # d columns one logits block sums (csrc DSL)


def _declare(lib) -> None:
    i = ctypes.c_int
    lib.info_nce_fwd_launch.argtypes = [_c, _c, _c, _c, _c, i, i, i,
                                        ctypes.c_float, _c]
    lib.info_nce_fwd_launch.restype = ctypes.c_int
    lib.info_nce_bwd_launch.argtypes = [_c, _c, _c, _c, _c, _c, i, i, i,
                                        ctypes.c_float, i, _c]
    lib.info_nce_bwd_launch.restype = ctypes.c_int
    lib.infonce_error_string.argtypes = [ctypes.c_int]
    lib.infonce_error_string.restype = ctypes.c_char_p


def _check_rows(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"info_nce: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_qk(q: torch.Tensor, k: torch.Tensor):
    if q.device.type != "cuda" or q.dim() != 3:
        raise ValueError(f"info_nce: q must be a (C, B, d) CUDA tensor, got "
                         f"{tuple(q.shape)} on {q.device}")
    C, n, d = q.shape
    if C < 1 or n < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"info_nce: needs C >= 1, B >= 1 and 1 <= d <= "
                         f"{MAX_D}, got {tuple(q.shape)}")
    _check_rows("q", q, (C, n, d), q.device)
    _check_rows("k", k, (C, n, d), q.device)
    return C, n, d


def _partials(q: torch.Tensor) -> torch.Tensor:
    """The logits kernel's scratch: partial q.k^T per 256-wide d slice,
    (C, ceil(d / 256), n, n) float32."""
    C, n, d = q.shape
    return torch.empty((C, -(-d // D_SLICE), n, n), dtype=torch.float32,
                       device=q.device)


def info_nce_fwd(q: torch.Tensor, k: torch.Tensor, tau: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (C, B, d) contiguous float32 CUDA tensors, L2-normalised rows.
    Returns (per-row loss, per-row log-sum-exp), both (C, B) float32."""
    C, n, d = _check_qk(q, k)
    loss = torch.empty((C, n), dtype=torch.float32, device=q.device)
    lse = torch.empty_like(loss)
    part = _partials(q)
    lib = build.load("infonce", _declare)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(lib.info_nce_fwd_launch(q.data_ptr(), k.data_ptr(),
                                        loss.data_ptr(), lse.data_ptr(),
                                        part.data_ptr(), C, n, d,
                                        float(tau), stream),
                lib.infonce_error_string, "info_nce_fwd")
    return loss, lse


def info_nce_bwd(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                 g: torch.Tensor, tau: float, wrt_k: bool) -> torch.Tensor:
    """The gradient of ``sum(g * loss)`` with respect to q (``wrt_k``
    False) or k (True), given the forward's ``lse``; (C, B, d) float32."""
    C, n, d = _check_qk(q, k)
    _check_rows("lse", lse, (C, n), q.device)
    _check_rows("g", g, (C, n), q.device)
    out = torch.empty_like(q)
    part = _partials(q)
    lib = build.load("infonce", _declare)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(lib.info_nce_bwd_launch(q.data_ptr(), k.data_ptr(),
                                        lse.data_ptr(), g.data_ptr(),
                                        out.data_ptr(),
                                        part.data_ptr(), C, n, d,
                                        float(tau), int(wrt_k), stream),
                lib.infonce_error_string,
                "info_nce_dk" if wrt_k else "info_nce_dq")
    return out
