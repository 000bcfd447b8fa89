"""FedAvg aggregation (paper Fig. 1, step iv; ``repro.federated.aggregate``).

Clients only change the active stage's blocks and the heads (frozen blocks
get masked zero updates), so averaging the whole tree equals exchanging
only the active layer: frozen entries are equal across clients.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def fedavg(client_trees: List[Dict[str, torch.Tensor]],
           weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weighted mean of flat dicts, in fp32; ``weights`` (N,) sums to 1."""
    out = {}
    for k, leaf in client_trees[0].items():
        stacked = torch.stack([t[k].to(torch.float32) for t in client_trees])
        w = weights.to(stacked.device).reshape((-1,) + (1,) * leaf.dim())
        out[k] = torch.sum(stacked * w, dim=0).to(leaf.dtype)
    return out


def client_weights(sample_counts: Sequence[int]) -> torch.Tensor:
    w = torch.tensor(list(sample_counts), dtype=torch.float32)
    return w / torch.sum(w)
