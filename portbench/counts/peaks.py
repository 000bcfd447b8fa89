"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the full 700 W power limit). Every share of a peak or of a
roofline in the benchmark is stated against these."""

BF16_FLOPS = 989e12      # tensor cores, bf16 / fp16
TF32_FLOPS = 495e12      # tensor cores, TF32
FP32_FLOPS = 67e12       # CUDA cores, float32
HBM_BYTES = 3.35e12      # device memory bandwidth, bytes/s

# the SSD scan's products run as 3xTF32 (three TF32 products a product,
# for float32 accuracy): a third of the TF32 rate
SSD_FLOPS = TF32_FLOPS / 3


def least_seconds(flops: float, nbytes: float, peak: float) -> float:
    """The least time work of ``flops`` operations moving ``nbytes`` can
    take: the larger of its compute time at ``peak`` and its memory time."""
    return max(flops / peak, nbytes / HBM_BYTES)
