"""Per-chip hardware constants of the port's card (the reference's
``repro.launch.mesh`` holds TPU v5e constants and its meshes; the port's
mesh functions come with the sharding slice).

NVIDIA H100 SXM, from NVIDIA's H100 data sheet (dense rates, no
sparsity, at the 700 W power limit); ``repro_torch.roofline`` prices
with them, and ``chip_smoke.py`` bounds its kernels with them.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
PEAK_FLOPS_TF32 = 495e12          # FLOP/s, TF32 tensor cores
PEAK_FLOPS_FP32 = 67e12           # FLOP/s, fp32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
NVLINK_BW = 450e9                 # bytes/s per direction
