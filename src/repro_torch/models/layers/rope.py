"""Rotary position embeddings, split-half form (``repro.models.layers.rope``:
the first and second halves of the head dim are the two rotated
components, not interleaved pairs). The rotation goes through the RoPE
kernel (``kernels.ops.rope`` / ``rope_qk``: the CUDA kernel on the card,
``ref.rope_ref`` on the CPU); the cos / sin table comes from
``ref.rope_table``, the same torch expressions on either device.

The table of positions 0..S-1 (every full-sequence attention's) is kept
once built (``seq_table``): under the vmap engines its seven small ops
cost about 0.3 ms of host time a call on an H100's host, and the clients'
forward is host-bound once RoPE is one kernel. A table made while a CUDA
graph is captured (its kernels have not run yet), in inference mode (it
could not be saved for a backward) or under a dispatch mode (which may
hand back tensors of its own) is used once and not kept.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import rope_freqs, rope_table

__all__ = ["rope_freqs", "rope_table", "seq_table", "apply_rope",
           "apply_rope_qk"]

_SEQ_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _keepable(t: torch.Tensor) -> bool:
    return not (torch.is_inference_mode_enabled()
                or torch._C._len_torch_dispatch_stack() > 0
                or (t.is_cuda and torch.cuda.is_current_stream_capturing()))


def seq_table(S: int, head_dim: int, theta: float,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rope_table`` of positions 0..S-1 on ``device``, kept per (S,
    head_dim, theta, device): the same bits as a fresh one."""
    key = (S, head_dim, float(theta), torch.device(device))
    table = _SEQ_TABLES.get(key)
    if table is None:
        table = rope_table(torch.arange(S, device=device), head_dim, theta)
        if _keepable(table[0]):
            _SEQ_TABLES[key] = table
    return table


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S). fp32 math, output in
    x's dtype."""
    return ops.rope(x, *rope_table(positions, x.shape[-1], theta))


def apply_rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                  theta: float = 10000.0):
    """``apply_rope`` of q and of k (their head counts free, one head dim)
    from one table, in one kernel launch on the card."""
    return ops.rope_qk(q, k, *rope_table(positions, q.shape[-1], theta))
