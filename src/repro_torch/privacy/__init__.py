"""Privacy subsystem of the port (``repro.privacy``): client-level
DP-FedAvg, RDP accounting and pairwise-mask secure aggregation over the
wire transport's flat stage payloads, on the run's device.

  dp          PrivacyConfig / PrivacyEngine: update clipping (in the
              transport, so both round engines clip alike), calibrated
              server noise, secure-FedAvg entry points.
  accountant  Rényi-DP composition with subsampling amplification and the
              (ε, δ) conversion (``FLHistory.epsilon``); a copy of the
              reference's.
  secure_agg  fixed-point pairwise masking in int64 that cancels
              bit-exactly in the FedAvg sum.
"""
from repro_torch.privacy.accountant import (DEFAULT_ORDERS, RDPAccountant,
                                            compute_epsilon,
                                            rdp_sampled_gaussian,
                                            rdp_to_epsilon)
from repro_torch.privacy.dp import (PRIVACY_STREAM, PrivacyConfig,
                                    PrivacyEngine, make_privacy)
from repro_torch.privacy.secure_agg import MASK_ITEMSIZE, SecureAggregator

__all__ = [
    "DEFAULT_ORDERS", "MASK_ITEMSIZE", "PRIVACY_STREAM", "PrivacyConfig",
    "PrivacyEngine", "RDPAccountant", "SecureAggregator", "compute_epsilon",
    "make_privacy", "rdp_sampled_gaussian", "rdp_to_epsilon",
]
