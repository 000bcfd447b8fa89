"""The benchmark's inputs, made from the seed on the device.

Copies of the port's generators (``repro_torch/data/synthetic.py`` and
``repro_torch/data/partition.py``), so that the inputs are the
benchmark's own and a change to the program's generators cannot change
them: procedural texture images, Zipf + Markov token sequences and the IID
client partition.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def synthetic_images(generator: torch.Generator, n: int,
                     num_classes: int = 10, size: int = 32):
    """(images (n, size, size, 3) float32 in [0, 1], labels (n,) int64) on
    the generator's device: each class a sine texture (frequency,
    orientation, colour) under a random phase, plus Gaussian noise."""
    dev = generator.device
    labels = torch.randint(0, num_classes, (n,), generator=generator,
                           device=dev)
    cls = torch.arange(num_classes, dtype=torch.float32, device=dev)
    freqs = 1.0 + cls % 5
    orient = cls * (math.pi / num_classes)
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
    """(tokens, labels), both (n_seqs, seq_len) int64 on the generator's
    device: Zipf marginals (p(rank r) ~ r^-1.1) with first-order Markov
    mixing, each token the previous one plus a Zipf draw mod the vocab;
    labels are the next tokens, wrapping at the end. The draws invert a
    CDF summed on the host in float64, so they repeat on the card."""
    dev = generator.device
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float32)
    probs = torch.softmax(-1.1 * torch.log(ranks), dim=0)
    cdf = torch.cumsum(probs.double(), dim=0).to(dev)
    u = torch.rand(n_seqs * seq_len, generator=generator, device=dev,
                   dtype=torch.float64) * cdf[-1]
    draws = torch.searchsorted(cdf, u).clamp_(max=vocab_size - 1) \
        .reshape(n_seqs, seq_len)
    toks = torch.cumsum(draws, dim=1) % vocab_size
    return toks, torch.roll(toks, -1, dims=1)


def iid_partition(n_samples: int, n_clients: int, seed: int):
    """``n_clients`` sorted index arrays of a seeded permutation of
    ``range(n_samples)``, as equal as ``np.array_split`` makes them."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]
