"""Every random draw of an FL run, made by the benchmark from the seed.

``BenchDraws`` has the methods the port's drivers ask a draws object for
(``repro_torch/federated/draws.py``: ``init_state``, ``cohort``,
``batch_plan``, ``views``). Its numbers do not depend on the order in which
the program asks for them: each comes from a generator seeded from (seed,
round, whose plan, step), so the plain reference, which calls the same
functions below, gets the same numbers without a record of the program's
calls. A round starts with its ``cohort`` call; within it the k-th client
plan belongs to the k-th participant, and the calibration plan is the
server's.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from portbench.lib.init import generator
from portbench.reference.augment import draw_params


def cohort(seed: int, device, round_idx: int, num_clients: int,
           n: int) -> List[int]:
    if n >= num_clients:
        return list(range(num_clients))
    perm = torch.randperm(num_clients, device=device,
                          generator=generator(device, seed, "cohort",
                                              round_idx))
    return [int(i) for i in perm[:n]]


def batch_plan(seed: int, device, round_idx: int, who, n: int, epochs: int,
               batch_size: int) -> List[Tuple[torch.Tensor, tuple]]:
    """``epochs`` shuffles of ``range(n)``, each cut into ``n //
    batch_size`` batches; a batch's handle is (round, who, step)."""
    plan = []
    for e in range(epochs):
        perm = torch.randperm(n, device=device, generator=generator(
            device, seed, "batches", round_idx, who, e))
        for b in range(n // batch_size):
            plan.append((perm[b * batch_size:(b + 1) * batch_size],
                         (round_idx, who, len(plan))))
    return plan


def views(seed: int, device, handle: tuple, batch: int, height: int,
          width: int):
    """The augmentation draws of a step's two views."""
    g = generator(device, seed, "views", *handle)
    return (draw_params(g, batch, height, width),
            draw_params(g, batch, height, width))


class BenchDraws:
    """The draws object handed to ``run_fedssl``: the initial state made
    by the benchmark, cohorts, batch plans and views from the seed. The
    cells draw nothing else (no depth dropout, no privacy)."""

    def __init__(self, seed: int, device, state):
        self.seed, self.device = int(seed), torch.device(device)
        self.state = state
        self.round = -1
        self._plans = 0

    def init_state(self, encoder, ssl_cfg):
        state, self.state = self.state, None
        return state

    def cohort(self, num_clients: int, n: int) -> List[int]:
        self.round += 1
        self._plans = 0
        return cohort(self.seed, self.device, self.round, num_clients, n)

    def batch_plan(self, n: int, epochs: int, batch_size: int,
                   calibration: bool = False):
        who = "server" if calibration else self._plans
        self._plans += not calibration
        return batch_plan(self.seed, self.device, self.round, who, n, epochs,
                          batch_size)

    def views(self, handle, batch: int, height: int, width: int):
        return views(self.seed, self.device, handle, batch, height, width)

    def gate_uniforms(self, handle, num_stages: int):
        raise NotImplementedError("no benchmark cell draws depth dropout")

    def privacy_noise(self, round_idx: int, n: int):
        raise NotImplementedError("no benchmark cell is private")

    def mask_seed(self, round_idx: int):
        raise NotImplementedError("no benchmark cell is private")
