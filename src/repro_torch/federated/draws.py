"""Every random draw of the FL driver, behind one object.

The reference walks a threefry key chain (``driver.py:203, 276, 312,
380``; ``client.local_train``; the step's split; ``two_views``;
``server_calibrate``), which PyTorch cannot reproduce. The driver and the
engine therefore ask a draws object for each thing they need, in the
order the reference consumes its keys:

  init_state      the initial SSL state (``ssl_init``)
  cohort          the round's sampled clients
  batch_plan      one client's (or the server calibration's) shuffled
                  batches: ``[(indices, handle), ...]``, one per step
  views           the augmentation draws of a step's two views
  gate_uniforms   the depth-dropout draws of a step
  privacy_noise   a round's standard normal server noise (DP)
  mask_seed       a round's secure-aggregation mask seed

``TorchDraws`` is the default: one ``torch.Generator`` on the run's device,
seeded from the run's seed, for everything but privacy. The privacy draws
come from a stream of their own, a generator seeded anew each round from
(run seed, ``PRIVACY_STREAM``, round), so a DP run's cohorts, batches and
views are those of a run without DP (the reference's privacy stream is a
``fold_in`` of the run key, which consumes nothing). A test can supply
another object with the same methods that replays the reference's keys,
so that both packages consume the same numbers.
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

import torch

from repro_torch.core import ssl as ssl_mod
from repro_torch.data import augment


# tag of the dedicated privacy stream (the reference's fold_in constant,
# ``repro.privacy.dp.PRIVACY_STREAM``)
PRIVACY_STREAM = 0x5EC7E7
_NOISE, _MASK = 0, 1


def derive_seed(*words: int) -> int:
    """A 64-bit generator seed hashed from integers (each below 2^127 in
    magnitude): equal words, equal seed; any other words, another."""
    return int.from_bytes(hashlib.blake2b(
        b"".join(int(w).to_bytes(16, "little", signed=True) for w in words),
        digest_size=8).digest(), "little")


class TorchDraws:
    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def init_state(self, encoder, ssl_cfg):
        return ssl_mod.ssl_init(encoder, ssl_cfg, self.generator,
                                self.device)

    def cohort(self, num_clients: int, n: int) -> List[int]:
        if n >= num_clients:
            return list(range(num_clients))
        perm = torch.randperm(num_clients, generator=self.generator,
                              device=self.device)
        return [int(i) for i in perm[:n]]

    def batch_plan(self, n: int, epochs: int, batch_size: int,
                   calibration: bool = False) -> List[Tuple]:
        """``epochs`` shuffles of ``range(n)`` cut into ``n // batch_size``
        batches each; the handle is unused (draws are sequential)."""
        plan = []
        for _ in range(epochs):
            perm = torch.randperm(n, generator=self.generator,
                                  device=self.device)
            for b in range(n // batch_size):
                plan.append((perm[b * batch_size:(b + 1) * batch_size],
                             None))
        return plan

    def views(self, handle, batch: int, height: int, width: int):
        return (augment.draw_params(self.generator, batch, height, width),
                augment.draw_params(self.generator, batch, height, width))

    def gate_uniforms(self, handle, num_stages: int) -> torch.Tensor:
        return torch.rand(num_stages, generator=self.generator,
                          device=self.device)

    def privacy_noise(self, round_idx: int, n: int) -> torch.Tensor:
        """The round's (n,) standard normal fp32 noise, on the device."""
        g = torch.Generator(self.device).manual_seed(derive_seed(
            self.seed, PRIVACY_STREAM, round_idx, _NOISE))
        return torch.randn(n, generator=g, device=self.device)

    def mask_seed(self, round_idx: int) -> Tuple[int, int]:
        """The round's secure-aggregation seed: two 32-bit words."""
        digest = derive_seed(self.seed, PRIVACY_STREAM, round_idx, _MASK)
        return (digest & 0xFFFFFFFF, digest >> 32)
