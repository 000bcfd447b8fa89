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

``TorchDraws`` is the default: one ``torch.Generator`` on the run's device,
seeded from the run's seed. A test can supply another object with the same
methods that replays the reference's keys, so that both packages consume
the same numbers.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core import ssl as ssl_mod
from repro_torch.data import augment


class TorchDraws:
    def __init__(self, seed: int, device):
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
