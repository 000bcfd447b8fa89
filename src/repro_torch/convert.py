"""Parameters between the JAX package and the port, through numpy.

The JAX package keeps a parameter tree as nested dicts and lists of arrays
(``{"enc": {"blocks": {"attn": {"wq": (L, d, d)}}}, "proj": {"layers":
[{"w": ..., "bn": {...}}, ...]}}``). The port keeps the same leaves in a
flat ``{path: tensor}`` dict whose keys are the JAX key paths joined with
``/``, in ``jax.tree_util`` leaf order (dict keys sorted, lists in order):
the order the wire payload offsets follow.

``from_numpy_tree`` and ``to_numpy_tree`` are exact inverses (numpy arrays
in, numpy arrays out; values are copied bit for bit).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.federated.leaves import tree_sorted


def _walk(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _walk(sub, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = tree


def flatten_tree(tree) -> Dict[str, Any]:
    """Nested dicts/lists -> flat ``{path: leaf}`` in tree order."""
    out: Dict[str, Any] = {}
    _walk(tree, "", out)
    return out


def unflatten_tree(flat: Dict[str, Any]):
    """Inverse of ``flatten_tree``: integer path entries become lists."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def subtree(flat: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The leaves under ``prefix/``, with the prefix stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def prefixed(prefix: str, flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``subtree``: every key under ``prefix/``."""
    return {f"{prefix}/{k}": v for k, v in flat.items()}


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """A tensor or array-like (copied, so read-only numpy arrays are fine)
    on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, copy=True))
    return x.to(device=device, dtype=dtype)


def from_numpy_tree(tree, device="cpu") -> Dict[str, torch.Tensor]:
    """JAX-layout tree of numpy arrays -> flat dict of torch tensors."""
    return {k: to_tensor(v, device) for k, v in flatten_tree(tree).items()}


def to_numpy_tree(flat: Dict[str, torch.Tensor]):
    """Flat dict of torch tensors -> JAX-layout tree of numpy arrays."""
    return unflatten_tree({k: v.detach().cpu().numpy()
                           for k, v in tree_sorted(flat).items()})


def state_from_numpy(state, device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX SSL state ``{"online": tree, "target": tree}`` -> the port's
    ``{"online": flat, "target": flat}``."""
    return {branch: from_numpy_tree(tree, device)
            for branch, tree in state.items()}


def state_to_numpy(state) -> Dict[str, Any]:
    return {branch: to_numpy_tree(flat) for branch, flat in state.items()}
