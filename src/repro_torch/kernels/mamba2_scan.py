"""Hopper chunked SSD scan (Mamba2).

Replaces ``src/repro/kernels/mamba2_scan.py::ssd_scan_bshpn``
(``pallas_call`` at :80) and its wrapper ``src/repro/kernels/ops.py:77``.
The kernels are ``csrc/ssd_scan.cu``; its header gives the bound on the
H100 (operations) and the design: the SSD decomposition in four kernels,
each parallel over the chunks (C.B^T once per batch row and chunk, the
chunk states, a pass that forms the state entering each chunk, and the
chunk outputs), every product on the tensor cores as 3xTF32 split TF32
``mma.sync`` at fp32 accuracy. ``ref.ssd_decomposed`` is the same
decomposition in plain PyTorch. dt and a are read as they are, without the
TPU wrapper's lane padding.

The state entering the first chunk is an optional ``h0`` (zero without
one), and the state after the last chunk is returned beside y: the
prefill hand-off, which the TPU kernel lacks (it starts every (batch,
head) from zero and returns y alone).

Bm and Cm are (B, S, N), the one group of the JAX package's layer, or (B,
S, G, N): G groups, head h reading group h // (H / G) (Zamba2-7B's two).
The first form runs exactly as before groups were added.

CUDA tensors only; ``repro_torch.kernels.ops.ssd_scan`` counts launches
(one per call, for the four kernels), sends CPU tensors to
``ref.ssd_explicit`` and adds the backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_c = ctypes.c_void_p
MAX_PN = 64         # largest head dim P and state dim N
MAX_CHUNK = 1024
TILE = 64           # chunk positions per kernel tile


def _declare(lib) -> None:
    i = ctypes.c_int
    lib.ssd_scan_launch.argtypes = [_c, _c, _c, _c, _c, _c, _c, _c, _c, _c,
                                    _c, i, i, i, i, i, i, i,
                                    ctypes.POINTER(ctypes.c_longlong), _c]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_error_string.restype = ctypes.c_char_p


def ssd_scan_bshpn(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh: (B, S, H, P); dt, a = dt * A: (B, S, H); Bm, Cm: (B, S, N) or
    (B, S, G, N) with G dividing H; h0 (B, H, P, N) or None (zero); all
    float32 on one CUDA device, the last dim of xh, Bm and Cm contiguous
    (other strides are free). Returns (y, a contiguous (B, S, H, P) float32
    tensor; the final state, (B, H, P, N) float32). ``chunk`` must divide
    S."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    G = Bm.shape[2] if Bm.dim() == 4 else 1
    bc_shape = (B, S, N) if Bm.dim() == 3 else (B, S, G, N)
    tensors = (xh, dt, a, Bm, Cm) + (() if h0 is None else (h0,))
    if xh.device.type != "cuda" or any(t.device != xh.device
                                       for t in tensors):
        raise ValueError("ssd_scan_bshpn takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"ssd_scan_bshpn: xh, dt, a, Bm, Cm and h0 must "
                         f"be float32, got {[t.dtype for t in tensors]}")
    if h0 is not None and tuple(h0.shape) != (B, H, P, N):
        raise ValueError(f"ssd_scan_bshpn: h0 {tuple(h0.shape)} is not "
                         f"(B, H, P, N) = {(B, H, P, N)}")
    if tuple(dt.shape) != (B, S, H) or tuple(a.shape) != (B, S, H) \
            or tuple(Bm.shape) != bc_shape or tuple(Cm.shape) != bc_shape \
            or H % G:
        raise ValueError(f"ssd_scan_bshpn: shapes disagree: xh "
                         f"{tuple(xh.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}")
    if not (1 <= P <= MAX_PN and 1 <= N <= MAX_PN):
        raise ValueError(f"ssd_scan_bshpn: head dim P={P} and state dim "
                         f"N={N} must be in [1, {MAX_PN}]")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_scan_bshpn: chunk {chunk} must divide S={S} "
                         f"and be at most {MAX_CHUNK}")
    if any(t.stride(-1) != 1 for t in (xh, Bm, Cm)):
        raise ValueError("ssd_scan_bshpn: the last dim of xh, Bm and Cm "
                         "must be contiguous")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=xh.device)
    if S == 0:
        return y, (torch.zeros((B, H, P, N), dtype=torch.float32,
                               device=xh.device) if h0 is None
                   else h0.clone())
    hT = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    h0 = None if h0 is None else h0.contiguous()
    # scratch: C.B^T per group and chunk (rows padded to 64), the chunk
    # states (64 x 64 blocks), then the states entering each chunk, and
    # cumsum(a)
    nc, qp = S // chunk, -(-chunk // TILE) * TILE
    cb = torch.empty((B, G, nc, qp, qp), dtype=torch.float32,
                     device=xh.device)
    st = torch.empty((B, H, nc, MAX_PN, MAX_PN), dtype=torch.float32,
                     device=xh.device)
    cum = torch.empty((B, H, S), dtype=torch.float32, device=xh.device)
    # (batch, seq, group) of Bm and Cm; one group has no group stride
    bc_strides = [t.stride()[:3] if t.dim() == 4 else t.stride()[:2] + (0,)
                  for t in (Bm, Cm)]
    strides = (ctypes.c_longlong * 15)(
        *xh.stride()[:3], *dt.stride(), *a.stride(), *bc_strides[0],
        *bc_strides[1])
    lib = build.load("ssd_scan", _declare)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    build.check(lib.ssd_scan_launch(
        xh.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), cb.data_ptr(), st.data_ptr(), cum.data_ptr(), B, S,
        H, P, N, G, int(chunk), strides, stream),
        lib.ssd_error_string, "ssd_scan")
    return y, hT
