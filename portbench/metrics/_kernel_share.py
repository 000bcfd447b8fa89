"""A kernel's roofline share over the traced stretch, shared by the
``*_roofline_pct`` readers.

Silent only where there is nothing to read: a run with no device trace
(the harness's CPU tests) or traffic whose counts expect no call of the
kernel. Where the counts expect calls, the port's launch counter and the
kernels in the trace have to show them, else the run fails, naming the
counter or the kernel: a renamed kernel or work moved out of the
reader's sight never drops the metric unseen."""


def kernel_share(ctx, work: str, counter: str, kernel: str):
    """``work``: the kernel's entry in the counts; ``counter``: its key in
    the port's ``LAUNCHES``; ``kernel``: the text that the names of its
    device kernels hold."""
    k = ctx.work["kernels"].get(work)
    if not ctx.cuda or k is None or k["calls"] == 0:
        return None
    st = ctx.stretch
    expected = k["calls"] * st.rounds
    launched = st.launches.get(counter, 0)
    if launched != expected:
        raise RuntimeError(
            f"{work}: the port's launch counter '{counter}' reads "
            f"{launched} calls in the stretch's {st.rounds} rounds, the "
            f"counts expect {expected}")
    seconds, n = st.kernel_seconds(lambda name: kernel in name)
    if n == 0:
        raise RuntimeError(
            f"{work}: the counts expect {expected} calls and the device "
            f"trace holds no kernel named '*{kernel}*'")
    return 100.0 * k["least_s"] * st.rounds / seconds
