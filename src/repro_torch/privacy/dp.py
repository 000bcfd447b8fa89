"""Client-level DP-FedAvg and the privacy engine the FL stack threads
(``repro.privacy.dp``), on the run's device.

DP-FedAvg (McMahan et al. 2018) at client granularity, over the
transport's flat stage payloads:

  clip    each client's update Δ = payload(trained) - payload(downloaded)
          is global-norm clipped to C before the wire codec, as
          θ_ref + min(1, C/‖Δ‖)·Δ, so delta codecs (topk) sparsify the
          clipped delta and cast/quantize codecs ship the clipped model.
          The transport owns this step (``Transport.decode_uploads``), and
          both round engines upload through it, so they clip alike. One
          ``clip`` serves the card and the CPU (the reference has a jitted
          ``clip_jax`` and a numpy ``clip_host``).
  noise   one server-side Gaussian draw per round on the aggregated
          payload: σ = z · C · max_i w_i, the FedAvg mean's client-level
          sensitivity times z, so the accountant sees exactly ``z`` for
          any weighting.
  account ``repro_torch.privacy.accountant`` composes rounds in RDP space
          with subsampling amplification q = |cohort| / num_clients.

Exactness: with clip = ∞ the scale is exactly 1.0 and the payload passes
through bit-identically (a ``where`` on scale < 1, never ``ref + 1.0·Δ``,
which would re-round); with z = 0 the noise step is skipped statically,
so DP plumbing alone never changes a bit of training.

Secure aggregation (``cfg.secure_agg``) swaps FedAvg for the pairwise-
masked fixed-point sum of ``repro_torch.privacy.secure_agg``; the engines'
``collect=True`` per-client trees feed it.

Randomness: the noise and the mask seeds come from the draws object's
privacy stream (``TorchDraws.privacy_noise`` / ``mask_seed``), seeded from
(run seed, ``PRIVACY_STREAM``, round), apart from the generator that
draws cohorts, batches and views, so a DP run trains on the draws of a
run without DP, as the reference's ``fold_in`` stream does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.federated.draws import PRIVACY_STREAM  # noqa: F401
from repro_torch.federated.transport import (WIRE_DTYPE, pack_stage_payload,
                                             unpack_stage_payload)
from repro_torch.privacy.accountant import RDPAccountant
from repro_torch.privacy.secure_agg import SecureAggregator, check_round

_NORM_FLOOR = 1e-12      # guards C/‖Δ‖ when the update is exactly zero


@dataclass(frozen=True)
class PrivacyConfig:
    """Knobs for the privacy subsystem (all off by default).

    clip              L2 clip C on each client's stage-payload update;
                      0 disables DP entirely, ``inf`` runs the clipping
                      machinery as an exact pass-through (parity mode).
    noise_multiplier  z; server noise σ = z·C·max_w. Requires finite
                      clip > 0.
    delta             δ of the reported (ε, δ) guarantee.
    epsilon_budget    hard stop: training halts once cumulative ε
                      exceeds this (0 = unlimited).
    secure_agg        pairwise-mask fixed-point aggregation.
    fraction_bits / mask_range   fixed-point format (secure_agg.py).
    """
    clip: float = 0.0
    noise_multiplier: float = 0.0
    delta: float = 1e-5
    epsilon_budget: float = 0.0
    secure_agg: bool = False
    fraction_bits: int = 40
    mask_range: float = 256.0


class PrivacyEngine:
    """One per FL run: the accountant, the clip the transport applies, the
    server noise and the secure aggregator."""

    def __init__(self, cfg: PrivacyConfig):
        if cfg.clip < 0.0:
            raise ValueError(f"--dp-clip must be >= 0: {cfg.clip}")
        if cfg.noise_multiplier < 0.0:
            raise ValueError(f"--dp-noise-multiplier must be >= 0: "
                             f"{cfg.noise_multiplier}")
        if cfg.noise_multiplier > 0.0 and not (
                cfg.clip > 0.0 and math.isfinite(cfg.clip)):
            raise ValueError(
                "noise calibration needs a finite --dp-clip > 0: "
                f"sigma = z*C*max_w is unbounded with clip={cfg.clip}")
        if not (0.0 < cfg.delta < 1.0):
            raise ValueError(f"--dp-delta must be in (0, 1): {cfg.delta}")
        self.cfg = cfg
        self.accountant = RDPAccountant(cfg.noise_multiplier)
        self.masker = SecureAggregator(cfg.fraction_bits, cfg.mask_range)

    # -- mode flags ---------------------------------------------------------
    @property
    def dp(self) -> bool:
        """Clipping (and therefore DP bookkeeping) is active."""
        return self.cfg.clip > 0.0

    @property
    def noise_enabled(self) -> bool:
        return self.cfg.noise_multiplier > 0.0

    # -- clipping -------------------------------------------------------------
    def clip(self, flat: torch.Tensor, ref_flat: torch.Tensor):
        """Clip of the payload update, in fp32 on the payload's device:
        returns (clipped payload, scale as a 0-d tensor). Where nothing is
        clipped (scale 1.0, always at clip = ∞) the ``where`` hands back
        ``flat``'s own values. Nothing is read to the host."""
        delta = flat - ref_flat
        nrm = torch.sqrt(torch.sum(delta * delta))
        clip = torch.tensor(self.cfg.clip, dtype=torch.float32,
                            device=flat.device)
        scale = torch.clamp(clip / torch.clamp(nrm, min=_NORM_FLOOR),
                            max=1.0)
        return torch.where(scale < 1.0, ref_flat + scale * delta,
                           flat), scale

    # -- server noise -------------------------------------------------------
    def sigma(self, max_weight: float) -> float:
        """Gaussian σ on the aggregated payload for this round's maximum
        FedAvg weight (the mean's per-client sensitivity is C·max_w)."""
        if not self.noise_enabled:
            return 0.0
        return self.cfg.noise_multiplier * self.cfg.clip * float(max_weight)

    def add_noise(self, tree, spec, draws, round_idx: int, sigma: float):
        """Add N(0, σ²) over the payload slice of ``tree`` (leaves outside
        the payload never left the server). The standard normal draw is
        the draws object's for the round, scaled by σ in fp32 and added,
        as the reference does. σ = 0 returns ``tree`` and draws nothing."""
        if sigma == 0.0:
            return tree
        flat = pack_stage_payload(tree, spec)
        noise = draws.privacy_noise(round_idx, spec.total).to(flat.device)
        sig = torch.tensor(sigma, dtype=WIRE_DTYPE, device=flat.device)
        return unpack_stage_payload(tree, flat + sig * noise, spec)

    # -- secure aggregation -------------------------------------------------
    def secure_fedavg(self, trees, weights, client_ids, *, spec, base,
                      seed: Sequence[int], mask: bool = True):
        """Masked fixed-point FedAvg over decoded per-client trees: pack
        each onto the payload, add its masked message into the int64 sum,
        and unpack the dequantized aggregate onto ``base`` (the server's
        own copy of the leaves outside the payload). The clients are
        packed one at a time."""
        ids, weights = check_round(len(trees), weights, client_ids)
        device = next(iter(base.values())).device
        acc = torch.zeros(spec.total, dtype=torch.int64, device=device)
        for tree, w, cid in zip(trees, weights, ids):
            self.masker.accumulate(acc, pack_stage_payload(tree, spec), w,
                                   cid, ids, seed, mask=mask)
        return unpack_stage_payload(base, self.masker.dequantize(acc), spec)

    def make_secure_agg_fn(self, spec, base, seed):
        """Aggregation closure for the buffered-async policy: masks are
        derived over each flush's arrival set (survivor-set re-masking)."""
        def agg_fn(trees, weights, client_ids):
            return self.secure_fedavg(trees, weights, client_ids, spec=spec,
                                      base=base, seed=seed)
        return agg_fn

    def secure_overhead_bytes(self, spec, codec_wire_bytes: int) -> int:
        """Per-client wire overhead of masking this payload: the 8-byte
        masked residue replaces the codec's wire format."""
        if not self.cfg.secure_agg:
            return 0
        return max(0, self.masker.masked_bytes(spec.total)
                   - int(codec_wire_bytes))


def make_privacy(privacy) -> Optional[PrivacyEngine]:
    """None / PrivacyConfig / PrivacyEngine -> engine or None (disabled).

    A config with every mechanism off maps to None so the driver's path
    stays unchanged; noise without clipping is rejected here rather than
    silently un-calibrated.
    """
    if privacy is None:
        return None
    if isinstance(privacy, PrivacyEngine):
        return privacy
    if not isinstance(privacy, PrivacyConfig):
        raise TypeError(f"privacy must be a PrivacyConfig or "
                        f"PrivacyEngine: {type(privacy).__name__}")
    if privacy.clip == 0.0 and not privacy.secure_agg:
        if privacy.noise_multiplier > 0.0:
            raise ValueError("noise calibration needs a finite "
                             "--dp-clip > 0 (sigma = z*C*max_w)")
        return None
    return PrivacyEngine(privacy)
