"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's whole rounds after the traced stretch (``portbench.counts``: every forward pass and twice
the forward of the trained part, no recomputation) over the window's time
times 989 TFLOP/s."""
from portbench.counts.peaks import BF16_FLOPS


def read(ctx):
    flops = ctx.work["model_flops"] * ctx.rounds
    return 100.0 * flops / (ctx.window_s * BF16_FLOPS)
