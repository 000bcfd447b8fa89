"""What the readers of the program's step and calibration spans share.

A share of the window's untraced rounds reads as ``local_train_pct``
does: the named spans' time inside ``ctx.t0``-``ctx.t1`` over
``ctx.window_s``. A reader is silent only where there is nothing to read:
a program that does not record the span at all (one whose step functions
take no ``tracer``). Where the cell's traffic runs the phase and the
program records it, the spans have to be there, else the run fails,
naming the span: a renamed span never drops a metric unseen."""
from __future__ import annotations

import inspect
import sys

from portbench.reference.common import round_plan


def traffic(ctx) -> dict:
    """The cell's traffic mix: ``ctx.traffic`` where the context carries
    it, else that of the cell in the harness's ``run_cell``, which calls
    the readers."""
    mix = getattr(ctx, "traffic", None)
    f = sys._getframe(1)
    while mix is None and f is not None:
        if f.f_code.co_name == "run_cell" and "cell" in f.f_locals:
            mix = f.f_locals["cell"].traffic
        f = f.f_back
    if mix is None:
        raise RuntimeError("no traffic to read: the reader runs outside "
                           "the harness's run_cell")
    return mix


def calibrates(mix: dict) -> bool:
    """Whether the traffic's rounds run the server's calibration."""
    stage = mix.get("stage", 1)
    return (mix.get("server_epochs", 0) > 0
            and mix.get("aux_fraction", 0) > 0
            and round_plan(mix["schedule"], stage, 1, stage).server_calibrate)


def records_steps() -> bool:
    """Whether the program records its steps' phases (``step.*``,
    ``local_step``, ``engine.inputs``): its step function takes a
    tracer."""
    from repro_torch.federated import client
    return "tracer" in inspect.signature(client.train_step).parameters


def inside(spans, names, t0: float, t1: float):
    """(start, end) of the spans named in ``names`` that overlap
    ``t0``-``t1``, clipped to it."""
    return [(max(a, t0), min(b, t1)) for n, a, b in spans
            if n in names and b > t0 and a < t1]


def window_share(ctx, names, required=()) -> float:
    """The spans named in ``names``' share of the window's untraced
    rounds, in %; each name of ``required`` has to have a span there."""
    for name in required:
        if not inside(ctx.spans, (name,), ctx.t0, ctx.t1):
            raise RuntimeError(
                f"the traffic runs the phase of the program's '{name}' "
                f"spans and the window's untraced rounds hold none")
    busy = sum(b - a for a, b in inside(ctx.spans, names, ctx.t0, ctx.t1))
    return 100.0 * busy / ctx.window_s
