"""SSL view augmentations, plain PyTorch: a frozen copy of the port's
``repro_torch/data/augment.py`` (the MoCo v3 recipe: random resized crop,
colour jitter, grayscale, horizontal flip, Gaussian blur, solarization).

``draw_params`` makes a batch's random numbers, one (B,) tensor per field
of ``FIELDS``, from a ``torch.Generator``; ``augment`` is the deterministic
transform of a batch given them. The benchmark hands the same numbers to
the program (through its draws object) and to the reference.
"""
from __future__ import annotations

from typing import Dict

import torch

# field -> (low, high) of a uniform draw; ``y0``/``x0`` are integers drawn
# in [0, H) and [0, W)
FIELDS = {
    "area": (0.2, 1.0),          # random_resized_crop scale
    "y0": None, "x0": None,      # crop corner, before the modulo
    "bright": (-0.4, 0.4), "contrast": (-0.4, 0.4), "sat": (-0.4, 0.4),
    "hue": (-0.1, 0.1),
    "gray": (0.0, 1.0),          # grayscale with p = 0.2
    "flip": (0.0, 1.0),          # horizontal flip with p = 0.5
    "sigma": (0.1, 2.0), "blur": (0.0, 1.0),   # blur with p = 0.5
    "solar": (0.0, 1.0),         # solarize with p = 0.2
}

Params = Dict[str, torch.Tensor]


def draw_params(generator: torch.Generator, batch: int, height: int,
                width: int) -> Params:
    dev = generator.device
    out = {}
    for name, rng in FIELDS.items():
        if rng is None:
            hi = height if name == "y0" else width
            out[name] = torch.randint(0, hi, (batch,), generator=generator,
                                      device=dev, dtype=torch.int32)
        else:
            lo, hi = rng
            out[name] = lo + (hi - lo) * torch.rand(
                batch, generator=generator, device=dev)
    return out


def _col(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, 1, 1, 1)


def random_resized_crop(img: torch.Tensor, p: Params) -> torch.Tensor:
    """Crop of area ``area`` (side sqrt(area)) at a drawn corner, resized
    back bilinearly by sampling a coordinate grid."""
    B, H, W, _ = img.shape
    dev = img.device
    side = torch.sqrt(p["area"].to(torch.float32))
    ch = torch.clamp((side * H).to(torch.int32), min=1)
    cw = torch.clamp((side * W).to(torch.int32), min=1)
    y0 = p["y0"].to(torch.int32) % torch.clamp(H - ch + 1, min=1)
    x0 = p["x0"].to(torch.int32) % torch.clamp(W - cw + 1, min=1)
    ar_h = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5) / H
    ar_w = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5) / W
    ys = y0[:, None] + ar_h[None] * ch[:, None] - 0.5          # (B, H)
    xs = x0[:, None] + ar_w[None] * cw[:, None] - 0.5          # (B, W)
    y_lo = torch.clamp(torch.floor(ys).to(torch.int64), 0, H - 1)
    x_lo = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 1)
    y_hi = torch.clamp(y_lo + 1, 0, H - 1)
    x_hi = torch.clamp(x_lo + 1, 0, W - 1)
    wy = (ys - y_lo)[:, :, None, None]
    wx = (xs - x_lo)[:, None, :, None]
    b = torch.arange(B, device=dev)[:, None, None]

    def g(yy, xx):
        return img[b, yy[:, :, None], xx[:, None, :]]

    return (g(y_lo, x_lo) * (1 - wy) * (1 - wx)
            + g(y_lo, x_hi) * (1 - wy) * wx
            + g(y_hi, x_lo) * wy * (1 - wx)
            + g(y_hi, x_hi) * wy * wx)


def color_jitter(img: torch.Tensor, p: Params) -> torch.Tensor:
    img = img * _col(1.0 + p["bright"])
    mean = torch.mean(img, dim=(1, 2), keepdim=True)
    img = (img - mean) * _col(1.0 + p["contrast"]) + mean
    gray = torch.mean(img, dim=-1, keepdim=True)
    img = gray + (img - gray) * _col(1.0 + p["sat"])
    # cheap hue-ish channel roll mix
    h = _col(torch.abs(p["hue"]))
    img = img * (1 - h) + torch.roll(img, 1, dims=-1) * h
    return torch.clamp(img, 0.0, 1.0)


def random_grayscale(img: torch.Tensor, p: Params,
                     prob: float = 0.2) -> torch.Tensor:
    gray = torch.mean(img, dim=-1, keepdim=True).expand_as(img)
    return torch.where(_col(p["gray"] < prob), gray, img)


def random_hflip(img: torch.Tensor, p: Params,
                 prob: float = 0.5) -> torch.Tensor:
    return torch.where(_col(p["flip"] < prob), img.flip(2), img)


def gaussian_blur(img: torch.Tensor, p: Params, prob: float = 0.5,
                  ksize: int = 5) -> torch.Tensor:
    """Separable blur with edge padding, kernel width ``ksize``."""
    B, H, W, _ = img.shape
    dev = img.device
    r = ksize // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    w = torch.exp(-0.5 * (xs[None] / p["sigma"][:, None]) ** 2)  # (B, k)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    rows = torch.clamp(torch.arange(-r, H + r, device=dev), 0, H - 1)
    v = img[:, rows]
    v = sum(v[:, i:i + H] * _col(w[:, i]) for i in range(ksize))
    cols = torch.clamp(torch.arange(-r, W + r, device=dev), 0, W - 1)
    hz = v[:, :, cols]
    hz = sum(hz[:, :, i:i + W] * _col(w[:, i]) for i in range(ksize))
    return torch.where(_col(p["blur"] < prob), hz, img)


def solarize(img: torch.Tensor, p: Params, prob: float = 0.2,
             threshold: float = 0.5) -> torch.Tensor:
    sol = torch.where(img >= threshold, 1.0 - img, img)
    return torch.where(_col(p["solar"] < prob), sol, img)


def augment(images: torch.Tensor, p: Params) -> torch.Tensor:
    """One augmented view of ``images`` (B, H, W, 3) under draws ``p``."""
    img = random_resized_crop(images, p)
    img = color_jitter(img, p)
    img = random_grayscale(img, p)
    img = random_hflip(img, p)
    img = gaussian_blur(img, p)
    return solarize(img, p)


def two_views(images: torch.Tensor, p1: Params, p2: Params):
    """The two views of Algorithm 2 line 6."""
    return augment(images, p1), augment(images, p2)
