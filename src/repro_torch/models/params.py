"""``ParamTree``: an ``nn.Module`` whose parameters sit at JAX key paths.

A parameter at path ``"blocks/attn/wq"`` is registered as ``wq`` on the
submodule ``blocks.attn``, so ``named_parameters()`` yields the JAX key
paths joined with ``.`` and a ``state_dict`` maps one-to-one onto the JAX
tree. Models subclass it and read their weights through ``self.p(path)``,
which also sees the tensors ``torch.func.functional_call`` substitutes; the
port runs every model that way, on flat ``{path: tensor}`` dicts.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.federated.leaves import tree_sorted


class ParamTree(nn.Module):
    def __init__(self, shapes: Dict[str, tuple], dtype=torch.float32,
                 device="meta"):
        super().__init__()
        for path, shape in shapes.items():
            *mods, leaf = path.split("/")
            node = self
            for m in mods:
                if m not in node._modules:
                    node.add_module(m, nn.Module())
                node = node._modules[m]
            node.register_parameter(leaf, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))

    def p(self, path: str) -> torch.Tensor:
        node = self
        for name in path.split("/"):
            node = getattr(node, name)
        return node

    def flat_params(self) -> Dict[str, torch.Tensor]:
        """This module's own parameters as a flat ``{path: tensor}`` dict in
        ``jax.tree_util`` order."""
        return tree_sorted({n.replace(".", "/"): t
                            for n, t in self.named_parameters()})

    def apply(self, params: Dict[str, torch.Tensor], *args, **kwargs):
        """Run ``forward`` with ``params`` (a flat ``{path: tensor}`` dict)
        in place of the module's own parameters."""
        return functional_call(
            self, {k.replace("/", "."): v for k, v in params.items()},
            args, kwargs)
