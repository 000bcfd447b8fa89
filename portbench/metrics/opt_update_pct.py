"""Share of the window's untraced rounds that the program spends in its
``step.update`` spans: the masked optimizer update and the target EMA of
every local step and calibration step, as the host runs them (on the
vmap engine one ``vmap`` of the update over the clients a step). Silent
for a program that does not record its steps' phases."""
from portbench.metrics._spans import records_steps, window_share


def read(ctx):
    if not records_steps():
        return None
    return window_share(ctx, ("step.update",), ("step.update",))
