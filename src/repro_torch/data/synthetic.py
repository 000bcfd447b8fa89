"""Synthetic data (``repro.data.synthetic``): images standing in for
STL-10 / CIFAR, and token sequences for the LM family.

Each image class is a procedural texture (frequency, orientation and
colour signature) under a random phase, plus Gaussian noise. Tokens follow
Zipf marginals with first-order Markov mixing. The formulas are the
reference's; the draws come from a ``torch.Generator``, so the data are not
the reference's data for the same seed.
"""
from __future__ import annotations

import math

import torch


def synthetic_images(generator: torch.Generator, n: int,
                     num_classes: int = 10, size: int = 32):
    """Returns (images (n, size, size, 3) float32 in [0, 1], labels (n,)
    int64), both on the generator's device."""
    dev = generator.device
    labels = torch.randint(0, num_classes, (n,), generator=generator,
                           device=dev)
    cls = torch.arange(num_classes, dtype=torch.float32, device=dev)
    freqs = 1.0 + cls % 5
    orient = cls * (math.pi / num_classes)
    # fixed class colours: one generator of their own, as the reference
    # draws them from a fixed key
    colors = 0.2 + 0.8 * torch.rand(
        (num_classes, 3), generator=torch.Generator(dev).manual_seed(7),
        device=dev)
    ax = torch.arange(size, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    phases = torch.rand(n, generator=generator, device=dev) * (2 * math.pi)
    noise = torch.randn((n, size, size, 3), generator=generator, device=dev)
    f = freqs[labels][:, None, None]
    th = orient[labels][:, None, None]
    wave = torch.sin(2 * math.pi * f / size
                     * (xx * torch.cos(th) + yy * torch.sin(th))
                     + phases[:, None, None])
    img = (0.5 + 0.35 * wave)[..., None] * colors[labels][:, None, None, :]
    return torch.clamp(img + 0.08 * noise, 0.0, 1.0), labels


def synthetic_tokens(generator: torch.Generator, n_seqs: int, seq_len: int,
                     vocab_size: int):
    """Zipf marginals (p(rank r) ~ r^-1.1) with first-order Markov mixing:
    each next token is the previous one plus a Zipf draw, mod the vocab.
    Returns (tokens, labels), both (n_seqs, seq_len) int64 on the
    generator's device; labels are the next tokens, wrapping to the first
    at the end."""
    dev = generator.device
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float32)
    probs = torch.softmax(-1.1 * torch.log(ranks), dim=0)
    # inverse-CDF draws against a CDF summed on the host: torch.multinomial
    # on the card builds its CDF with a parallel scan whose float sums
    # associate differently from call to call, so its draws do not repeat
    cdf = torch.cumsum(probs.double(), dim=0).to(dev)
    u = torch.rand(n_seqs * seq_len, generator=generator, device=dev,
                   dtype=torch.float64) * cdf[-1]
    draws = torch.searchsorted(cdf, u).clamp_(max=vocab_size - 1) \
        .reshape(n_seqs, seq_len)
    toks = torch.cumsum(draws, dim=1) % vocab_size
    return toks, torch.roll(toks, -1, dims=1)
