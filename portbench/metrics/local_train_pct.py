"""Share of the window's untraced rounds that the program's driver spends
in its ``local_train`` spans (the clients' local steps: the engine), from
the tracer of the traced run. The spans end after a read of a loss, which
waits for the device, so a span holds its steps' device work."""


def read(ctx):
    busy = sum(max(0.0, min(b, ctx.t1) - max(a, ctx.t0))
               for name, a, b in ctx.spans if name == "local_train")
    if busy == 0.0:
        return None
    return 100.0 * busy / ctx.window_s
