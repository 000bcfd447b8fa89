"""Seeds and initial weights: the benchmark's own, made on the device.

Every leaf of a parameter tree is drawn from one ``torch.rand`` call over
all the tree's numbers, on the run's device, and each leaf is a view of
that buffer transformed in place by a rule on its name. The same seed,
layout and device give the same bits, so the plain reference regenerates
the program's starting point instead of taking it from the program.

Rules (by the leaf's last path entries): norm and BatchNorm scales and the
Mamba2 skip ``D`` are one; biases zero; the Mamba2 decay ``a_log`` is
log U(1, 16) and ``dt_bias`` the inverse softplus of a log-uniform step in
[1e-3, 0.1] (the Mamba2 paper's initialisation); the embeddings, the ViT's
positional table and CLS token normal with std 0.02; every other leaf a
normal truncated at two standard deviations over the square root of its
fan-in, the size of its second-to-last dim.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

Layout = Dict[str, Tuple[tuple, torch.dtype]]

EMBED_LEAVES = ("embed", "pos", "cls")


def derive_seed(*words) -> int:
    """A 63-bit generator seed hashed from ints and strings: equal words,
    equal seed."""
    h = hashlib.blake2b(digest_size=8)
    for w in words:
        h.update(repr(w).encode() + b"\x00")
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


def generator(device, *words) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(
        derive_seed(*words))


def _rule(path: str) -> str:
    name = path.split("/")[-1]
    if name == "scale" or name == "D":
        return "one"
    if name in ("bias", "conv_b"):
        return "zero"
    if name in ("a_log", "dt_bias"):
        return name
    if name in EMBED_LEAVES:
        return "embed"
    return "dense"


def init_tree(layout: Layout, seed: int, device, tag: str = "init"
              ) -> Dict[str, torch.Tensor]:
    """The tree of ``layout`` ({path: (shape, dtype)}, float32 leaves)
    drawn from ``seed``: one uniform draw, then each leaf's rule in place
    on its view."""
    sizes = [math.prod(s) for s, _ in layout.values()]
    u = torch.rand(sum(sizes), generator=generator(device, seed, tag),
                   device=device, dtype=torch.float32)
    out, at = {}, 0
    for (path, (shape, dtype)), n in zip(layout.items(), sizes):
        if dtype != torch.float32:
            raise ValueError(f"{path}: the benchmark draws float32 leaves, "
                             f"not {dtype}")
        t = u[at:at + n].view(shape)
        at += n
        rule = _rule(path)
        if rule == "one":
            t.fill_(1.0)
        elif rule == "zero":
            t.zero_()
        elif rule == "a_log":
            t.mul_(15.0).add_(1.0).log_()
        elif rule == "dt_bias":
            # dt = exp(U(log 1e-3, log 0.1)); softplus^-1(dt) = dt + log(-expm1(-dt))
            lo, hi = math.log(1e-3), math.log(0.1)
            t.mul_(hi - lo).add_(lo).exp_()
            t.add_(torch.log(-torch.expm1(-t)))
        else:
            # a normal from the uniform by the inverse CDF, truncated at 2
            # standard deviations: u in (Phi(-2), Phi(2))
            p = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
            t.mul_(1.0 - 2.0 * p).add_(p)
            t.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0))
            if rule == "embed":
                t.mul_(0.02)
            else:
                fan_in = shape[-2] if len(shape) >= 2 else 1
                t.mul_(1.0 / math.sqrt(fan_in))
        out[path] = t
    return out
