"""The Mamba2 SSD scan's forward against its roofline in the traced
stretch: the least time of the scans the stretch's rounds need (FLOPs over
495/3 TFLOP/s, the 3xTF32 rate of its float32-accurate products, or bytes
over 3.35 TB/s) over the device time of the port's ``ssd_*`` kernels, the
calls checked against its ``ssd_scan`` launch counter."""
from portbench.metrics._kernel_share import kernel_share


def read(ctx):
    return kernel_share(ctx, "ssd_scan", "ssd_scan", "ssd_")
