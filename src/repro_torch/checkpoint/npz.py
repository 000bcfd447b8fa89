"""Tree <-> ``.npz`` checkpointing (``repro.checkpoint.npz``): the port's
trees (flat ``{path: tensor}`` dicts, and the SSL state's dict of them)
under the reference's keys, its key paths joined with ``/``, so each
package loads the other's checkpoints.

Values are written as numpy arrays of the leaves' dtypes. A bfloat16 leaf
is refused: numpy has no bfloat16, and the reference's own file for one
(an ml_dtypes array, stored as raw ``|V2``) does not load back.
"""
from __future__ import annotations

import io
import pathlib

import numpy as np
import torch

from repro_torch.convert import flatten_tree


def _rebuild(like, prefix: str, load):
    """``like``'s structure with every leaf replaced by ``load(key,
    leaf)``, keys as ``convert.flatten_tree`` joins them."""
    if isinstance(like, dict):
        return {k: _rebuild(v, f"{prefix}{k}/", load)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, f"{prefix}{i}/", load)
                          for i, v in enumerate(like))
    return load(prefix[:-1], like)


def save_pytree(path, tree) -> None:
    path = pathlib.Path(path)
    flat = {}
    for key, leaf in flatten_tree(tree).items():
        if leaf.dtype == torch.bfloat16:
            raise ValueError(f"checkpoint leaf '{key}' is bfloat16, which "
                             f"numpy cannot hold; cast it to float32 first")
        flat[key] = leaf.detach().cpu().numpy()
    path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    path.write_bytes(buf.getvalue())


def load_pytree(path, like):
    """Restore into the structure of ``like``: each leaf of ``like``'s
    shape, cast to its dtype and placed on its device."""
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        flat = dict(data)

    def load(key, leaf):
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf '{key}' has shape "
                             f"{arr.shape}, expected {tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(device=leaf.device,
                                        dtype=leaf.dtype)

    return _rebuild(like, "", load)
