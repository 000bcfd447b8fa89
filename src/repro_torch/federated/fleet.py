"""Heterogeneous device-fleet model for the FL simulator (a copy of
``repro.federated.fleet``, which is numpy only: the same seed draws the
same fleet in both packages).

A ``Fleet`` assigns every client a ``DeviceProfile`` — sustained compute
throughput, memory bandwidth, up/down link bandwidth, per-round
availability and energy coefficients — drawn from a *named, seeded*
profile distribution. Draws use numpy's PCG64 generator seeded from
``(seed, profile id)``, so a fleet is a pure function of
``(profile, num_clients, seed)``: identical across runs, engines and
platforms, and different seeds give different fleets.

Profiles (``make_fleet``):

  uniform             every client is exactly the reference edge device
                      (availability 1.0). The simulator's "no heterogeneity"
                      baseline — under the synchronous policy this is
                      provably identical to running without a simulator.
  mobile-mix          a hi/mid/lo device-tier mixture (20/50/30%) with
                      log-normal per-device jitter and tiered link
                      bandwidth/availability — the "fleet of phones"
                      picture in Alawadi et al.
  pareto-stragglers   compute slowdowns drawn from a Pareto tail: most
                      clients are near-reference, a heavy tail is many
                      times slower. The classic straggler regime that
                      deadline/async policies exist for.

The reference-device constants are first-order edge numbers (a mobile
NPU/GPU class device on a fast WAN link); they set the *scale* of
simulated seconds and joules, while scheduling decisions only depend on
the ratios between clients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

# reference edge device (a mid-range phone SoC on WiFi/LTE)
REF_FLOPS = 200e9        # sustained FLOP/s
REF_MEM_BW = 20e9        # bytes/s
REF_DOWN_BW = 12.5e6     # bytes/s  (~100 Mbit/s down)
REF_UP_BW = 5e6          # bytes/s  (~40 Mbit/s up)
REF_J_PER_FLOP = 1e-11   # 10 pJ/FLOP compute energy proxy
REF_J_PER_BYTE = 1e-7    # 100 nJ/byte radio energy proxy

PROFILES = ("uniform", "mobile-mix", "pareto-stragglers")


@dataclass(frozen=True)
class DeviceProfile:
    """One client's simulated hardware."""
    flops: float           # sustained compute throughput, FLOP/s
    mem_bw: float          # memory bandwidth, bytes/s
    down_bw: float         # downlink, bytes/s
    up_bw: float           # uplink, bytes/s
    availability: float    # P(client is reachable for a round it's sampled)
    j_per_flop: float      # energy proxy, joules per FLOP
    j_per_byte: float      # energy proxy, joules per wire byte


REFERENCE_DEVICE = DeviceProfile(
    flops=REF_FLOPS, mem_bw=REF_MEM_BW, down_bw=REF_DOWN_BW,
    up_bw=REF_UP_BW, availability=1.0, j_per_flop=REF_J_PER_FLOP,
    j_per_byte=REF_J_PER_BYTE)


@dataclass(frozen=True)
class Fleet:
    profile: str
    seed: int
    devices: Tuple[DeviceProfile, ...]

    def __len__(self):
        return len(self.devices)

    def __getitem__(self, i) -> DeviceProfile:
        return self.devices[i]

    @property
    def homogeneous(self) -> bool:
        return all(d == self.devices[0] for d in self.devices)

    def draw_signature(self) -> Tuple:
        """Hashable fingerprint of every drawn number — what the
        determinism property tests compare across runs and engines."""
        return tuple((d.flops, d.mem_bw, d.down_bw, d.up_bw,
                      d.availability) for d in self.devices)


def _rng(profile: str, num_clients: int, seed: int) -> np.random.Generator:
    # seed sequence keyed on every argument: same args => same fleet,
    # different seed/profile/size => statistically independent draws
    return np.random.default_rng(
        [seed, num_clients, PROFILES.index(profile)])


def _uniform(num_clients: int, rng) -> Tuple[DeviceProfile, ...]:
    return (REFERENCE_DEVICE,) * num_clients


def _mobile_mix(num_clients: int, rng) -> Tuple[DeviceProfile, ...]:
    # (speed multiplier, link multiplier, availability) per tier
    tiers = np.asarray([[2.0, 2.0, 0.95],    # hi: flagship on WiFi
                        [1.0, 1.0, 0.90],    # mid: the reference device
                        [0.35, 0.5, 0.75]])  # lo: old phone, flaky uplink
    pick = rng.choice(3, size=num_clients, p=[0.2, 0.5, 0.3])
    jitter = rng.lognormal(mean=0.0, sigma=0.2, size=num_clients)
    devs = []
    for i in range(num_clients):
        speed, link, avail = tiers[pick[i]]
        s = float(speed * jitter[i])
        devs.append(DeviceProfile(
            flops=REF_FLOPS * s, mem_bw=REF_MEM_BW * s,
            down_bw=REF_DOWN_BW * float(link),
            up_bw=REF_UP_BW * float(link),
            availability=float(avail),
            # slower silicon is also less efficient per op
            j_per_flop=REF_J_PER_FLOP / min(1.0, s) ** 0.5,
            j_per_byte=REF_J_PER_BYTE))
    return tuple(devs)


def _pareto_stragglers(num_clients: int, rng) -> Tuple[DeviceProfile, ...]:
    # slowdown = 1 + Pareto(a=1.5): mode at reference speed, heavy tail of
    # clients that are many times slower (infinite-variance regime)
    slowdown = 1.0 + rng.pareto(1.5, size=num_clients)
    devs = []
    for i in range(num_clients):
        s = float(slowdown[i])
        devs.append(DeviceProfile(
            flops=REF_FLOPS / s, mem_bw=REF_MEM_BW / s,
            down_bw=REF_DOWN_BW, up_bw=REF_UP_BW,
            availability=0.9,
            j_per_flop=REF_J_PER_FLOP * s ** 0.5,
            j_per_byte=REF_J_PER_BYTE))
    return tuple(devs)


_MAKERS = {"uniform": _uniform, "mobile-mix": _mobile_mix,
           "pareto-stragglers": _pareto_stragglers}


def make_fleet(profile: str, num_clients: int, seed: int = 0) -> Fleet:
    """Draw a fleet of ``num_clients`` devices from a named profile.

    Pure in all arguments — same (profile, num_clients, seed) always
    yields the identical fleet.
    """
    if profile not in _MAKERS:
        raise ValueError(f"unknown fleet profile '{profile}'; "
                         f"one of {PROFILES}")
    rng = _rng(profile, num_clients, seed)
    return Fleet(profile, seed, _MAKERS[profile](num_clients, rng))
