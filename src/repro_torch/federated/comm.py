"""Communication-cost accounting (paper Figs. 5c/5d, Tables 1-3;
``repro.federated.comm``).

Bytes come from the parameter tensors: a stage range selects rows of every
stacked block leaf; embedding-side and head parameters are added according
to the flags. ``plan_payloads`` is the membership rule the wire transport
shares, so with the fp32 codec its measured bytes equal these exactly.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.federated.leaves import classify_leaf


def tree_bytes(tree: Dict[str, torch.Tensor]) -> int:
    """Bytes of every leaf of a flat tree (``meta`` tensors included)."""
    return int(sum(t.numel() * t.element_size() for t in tree.values()))


def _leaf_bytes(path, a: torch.Tensor, stage_range, include_embed,
                include_heads) -> int:
    kind = classify_leaf(path)
    full = a.numel() * a.element_size()
    if kind == "stacked":
        lo, hi = max(0, stage_range[0]), min(a.shape[0], stage_range[1])
        return max(0, hi - lo) * (full // a.shape[0])
    if kind == "embed":
        return full if include_embed else 0
    if kind == "head":
        return full if include_heads else 0
    # extra leaves (final norm) travel whenever any stage moves
    return full


def partial_bytes(params: Dict[str, torch.Tensor], stage_range, *,
                  include_embed=True, include_heads=True) -> int:
    return sum(_leaf_bytes(p, a, stage_range, include_embed, include_heads)
               for p, a in params.items())


def plan_payloads(plan) -> dict:
    """Per-direction payload membership of a ``RoundPlan``: ``download`` /
    ``upload`` -> ``(stage_range, include_embed)``. The download carries
    the embedding side only when its range starts at the input; the upload
    only when the client trained it (``active_from == 0``)."""
    return {
        "download": (plan.download_stages, plan.download_stages[0] == 0),
        "upload": (plan.upload_stages, plan.active_from == 0),
    }


def round_comm_bytes(params, plan, *, include_heads=True) -> dict:
    """Bytes for one client in one round under ``plan``."""
    return {d: partial_bytes(params, rng, include_embed=emb,
                             include_heads=include_heads)
            for d, (rng, emb) in plan_payloads(plan).items()}
