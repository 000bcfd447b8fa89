"""Attention's forward against its roofline in the traced stretch.

The least time of the attention work that the stretch's rounds need (each
call's larger of FLOPs over 989 TFLOP/s and bytes over 3.35 TB/s, from the
call's shapes by ``portbench.counts``) over the device time of the kernels
that computed it (the port's ``flash_fwd*``). The calls the counts expect
have to be the calls the port made (its ``flash_attention`` launch
counter); where the counts expect calls and the trace holds no such
kernel, the run fails and names it."""
from portbench.metrics._kernel_share import kernel_share


def read(ctx):
    return kernel_share(ctx, "attention", "flash_attention", "flash_fwd")
