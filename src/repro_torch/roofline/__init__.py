"""Roofline and analytic per-client cost models of the port
(``repro.roofline``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    flop_dict, memory_dict, model_flops, roofline_report)
