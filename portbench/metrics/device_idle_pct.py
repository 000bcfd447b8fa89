"""Share of the traced stretch in which no kernel, copy or set ran on the
device: one minus the union of the device's activity over the stretch's
length."""


def read(ctx):
    st = ctx.stretch
    return 100.0 * (1.0 - st.busy_seconds() / st.seconds)
