"""Per-stage optimizer update masks (``repro.federated.masks``).

The forward pass gives frozen layers no gradient, but decoupled weight
decay would still shrink frozen weights; these masks zero the whole update
outside the active range. Stacked block leaves get per-stage row masks;
embedding-side leaves are active only when the prefix is unfrozen
(``active_from == 0``); heads and the final norm are always active.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.federated.leaves import classify_leaf


def stage_update_mask(params: Dict[str, torch.Tensor], sub_layers: int,
                      active_from: int) -> Dict[str, torch.Tensor]:
    """Mask dict matching ``params``: 1.0 = update, 0.0 = frozen; each mask
    broadcasts against its leaf."""
    out = {}
    for path, a in params.items():
        kind = classify_leaf(path)
        if kind == "stacked":
            n = a.shape[0]
            idx = torch.arange(n, device=a.device)
            m = ((idx >= active_from) & (idx < sub_layers)).to(torch.float32)
            out[path] = m.reshape((n,) + (1,) * (a.dim() - 1))
        elif kind == "embed":
            out[path] = torch.tensor(1.0 if active_from == 0 else 0.0,
                                     device=a.device)
        else:
            out[path] = torch.tensor(1.0, device=a.device)
    return out
