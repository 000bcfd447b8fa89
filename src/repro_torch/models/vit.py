"""Vision Transformer backbone (ViT-Tiny), the paper's encoder F
(``repro.models.vit``).

32x32x3 inputs, patch size 4, learned positional embeddings (65 rows: CLS
plus 64 patches), CLS token, ``num_layers`` ``enc`` blocks whose weights are
stacked on a leading layer axis (one parameter per leaf, shape (L, ...)),
final RMSNorm. The layer-wise stage interface (``sub_layers``,
``active_from``, ``layer_gates``) is the JAX package's: blocks below
``active_from`` run under ``torch.no_grad()`` where the reference applies
``stop_gradient`` (so neither they nor the embedding get gradients), and
RoPE is applied inside attention on top of the learned ``pos`` embedding,
over positions 0..64 including CLS.
"""
from __future__ import annotations

import torch

from repro_torch.models import blocks as B
from repro_torch.models.layers.init import dense_init_, embed_init_
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.params import ParamTree


def num_patches(image_size: int, patch_size: int) -> int:
    return (image_size // patch_size) ** 2


def vit_shapes(cfg, image_size: int = 32, patch_size: int = 4):
    n = num_patches(image_size, patch_size)
    shapes = {f"blocks/{k}": (cfg.num_layers,) + s
              for k, s in B.block_shapes(cfg).items()}
    shapes.update({
        "cls": (1, 1, cfg.d_model),
        "final_ln/scale": (cfg.d_model,),
        "patch": (patch_size * patch_size * 3, cfg.d_model),
        "pos": (n + 1, cfg.d_model),
    })
    return shapes


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """images: (B, H, W, 3) -> (B, n_patches, P*P*3)."""
    Bsz, H, W, C = images.shape
    ph, pw = H // patch_size, W // patch_size
    x = images.reshape(Bsz, ph, patch_size, pw, patch_size, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(Bsz, ph * pw, patch_size * patch_size * C)


class ViT(ParamTree):
    """Parameters at the JAX paths (``patch``, ``pos``, ``cls``,
    ``blocks/attn/wq`` ...); ``forward`` returns the CLS representation."""

    def __init__(self, cfg, image_size: int = 32, patch_size: int = 4,
                 device="meta"):
        super().__init__(vit_shapes(cfg, image_size, patch_size),
                         getattr(torch, cfg.param_dtype), device)
        self.cfg = cfg
        self.patch_size = patch_size
        self.block_keys = tuple(B.block_shapes(cfg))

    def reset_parameters(self, generator=None) -> None:
        blocks = {k: t for k, t in self.flat_params().items()
                  if k.startswith("blocks/")}
        B.stacked_init_({k[7:]: t for k, t in blocks.items()}, generator)
        with torch.no_grad():
            dense_init_(self.p("patch"), self.p("patch").shape[0], generator)
            embed_init_(self.p("pos"), generator)
            embed_init_(self.p("cls"), generator)
            self.p("final_ln/scale").fill_(1.0)

    def forward(self, images: torch.Tensor, sub_layers=None,
                active_from: int = 0, layer_gates=None) -> torch.Tensor:
        """images: (B, H, W, 3) -> (B, d_model). ``layer_gates``: optional
        (num_layers,) gates multiplying each block's residual delta (depth
        dropout for FLL+DD; 1 keeps, 0 skips)."""
        cfg = self.cfg
        x = patchify(images, self.patch_size).to(getattr(torch,
                                                         cfg.param_dtype))
        x = x @ self.p("patch")
        Bsz = x.shape[0]
        cls = self.p("cls").expand(Bsz, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1) + self.p("pos")[None]

        sub = cfg.num_layers if sub_layers is None else sub_layers
        act = max(0, min(active_from, sub))
        gates = (torch.ones(cfg.num_layers, dtype=torch.float32,
                            device=x.device)
                 if layer_gates is None else layer_gates)
        stack = {k: self.p("blocks/" + k) for k in self.block_keys}
        if act > 0:
            with torch.no_grad():
                for i in range(act):
                    x = self._gated(stack, i, x, gates)
        for i in range(act, sub):
            x = self._gated(stack, i, x, gates)
        x = rmsnorm(x, self.p("final_ln/scale"), cfg.norm_eps)
        return x[:, 0]

    def _gated(self, stack, i: int, x: torch.Tensor, gates) -> torch.Tensor:
        x2, _ = B.block_apply({k: t[i] for k, t in stack.items()}, x,
                              self.cfg)
        return x + gates[i].to(x.dtype) * (x2 - x)


def init_vit(cfg, generator=None, device="cpu", image_size: int = 32,
             patch_size: int = 4):
    """Freshly initialised ViT parameters as a flat ``{path: tensor}``."""
    model = ViT(cfg, image_size, patch_size, device=device)
    model.reset_parameters(generator)
    return {k: t.detach() for k, t in model.flat_params().items()}

