"""Share of the window's untraced rounds that the program spends making
its steps' inputs: the vmap engine's ``engine.inputs`` spans (every draw
of a round, stacked) and the ``step.views`` spans (each step's batch and
its two augmented views on the device; on the sequential engine with
their draws). Silent for a program that does not record its steps'
phases."""
from portbench.metrics._spans import records_steps, traffic, window_share


def read(ctx):
    if not records_steps():
        return None
    names = ("engine.inputs", "step.views")
    vmap = traffic(ctx).get("engine") == "vmap"
    return window_share(ctx, names, names if vmap else ("step.views",))
