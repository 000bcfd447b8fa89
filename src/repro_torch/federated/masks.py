"""Per-stage optimizer update masks (``repro.federated.masks``).

The forward pass gives frozen layers no gradient, but decoupled weight
decay would still shrink frozen weights; these masks zero the whole update
outside the active range. Stacked block leaves get per-stage row masks;
embedding-side leaves are active only when the prefix is unfrozen
(``active_from == 0``); heads and the final norm are always active. A
leaf that ``stages`` maps to its stages (``lm.leaf_stages``: one leaf a
row of the zamba2 topology) is active when one of them lies in
[active_from, sub_layers).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.federated.leaves import classify_leaf

Stages = Optional[Dict[str, frozenset]]
Piece = Optional[Tuple[str, int, int]]


def stage_piece(path: str, a: torch.Tensor, lo: int, hi: int,
                stages: Stages = None) -> Piece:
    """The piece of leaf ``path`` (tensor ``a``) that the stage range
    [lo, hi) owns, as (kind, first row, one past the last row); it is
    empty where the second is not below the first. ``stacked``: the
    leaf's rows in the range. ``staged``, a leaf that ``stages`` maps to
    its stages (0-based): the whole leaf where one of them lies in the
    range. None for a leaf outside the stages (embedding side, heads,
    extras), which each caller's own flags decide."""
    if stages and path in stages:
        rows = a.shape[0] if a.dim() else 1
        return "staged", 0, rows if any(lo <= s < hi
                                        for s in stages[path]) else 0
    if classify_leaf(path) != "stacked":
        return None
    return "stacked", max(0, lo), min(a.shape[0], hi)


def _trained(path: str, piece: Piece, active_from: int) -> bool:
    """Whether the update touches the leaf at all."""
    if piece is None:
        return classify_leaf(path) != "embed" or active_from == 0
    return piece[1] < piece[2]


def stage_update_mask(params: Dict[str, torch.Tensor], sub_layers: int,
                      active_from: int, stages: Stages = None
                      ) -> Dict[str, torch.Tensor]:
    """Mask dict matching ``params``: 1.0 = update, 0.0 = frozen; each mask
    broadcasts against its leaf."""
    out = {}
    for path, a in params.items():
        piece = stage_piece(path, a, active_from, sub_layers, stages)
        if piece is not None and piece[0] == "stacked":
            n = a.shape[0]
            idx = torch.arange(n, device=a.device)
            m = ((idx >= piece[1]) & (idx < piece[2])).to(torch.float32)
            out[path] = m.reshape((n,) + (1,) * (a.dim() - 1))
        else:
            on = _trained(path, piece, active_from)
            out[path] = torch.tensor(1.0 if on else 0.0, device=a.device)
    return out


def trained_leaves(params: Dict[str, torch.Tensor], sub_layers: int,
                   active_from: int, stages: Stages = None) -> List[str]:
    """The paths whose ``stage_update_mask`` is not zero everywhere, read
    on the host (no mask is built)."""
    return [path for path, a in params.items()
            if _trained(path, stage_piece(path, a, active_from, sub_layers,
                                          stages), active_from)]
