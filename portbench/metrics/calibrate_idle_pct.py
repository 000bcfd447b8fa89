"""Share of the traced stretch in which the device is idle while the
server calibrates: the stretch's idle time (the complement of the union
of the device's activity) that falls inside the program's ``calibrate``
spans, mapped onto the profiler's clock with the stretch's
``clock_offset_ns``, over the stretch's length. It is part of
``device_idle_pct``, and reads its way where the stretch holds no device
activity. A traffic without calibration reads 0; one with it fails the
run where the stretch holds no ``calibrate`` span."""
from portbench.metrics._spans import calibrates, inside, traffic


def read(ctx):
    st = ctx.stretch
    t0, t1 = st.t0, st.t1
    off = st.clock_offset_ns
    spans = [(name, a * 1e9 + off, b * 1e9 + off)
             for name, a, b in ctx.spans]
    cal = inside(spans, ("calibrate",), t0, t1)
    if not cal and calibrates(traffic(ctx)):
        raise RuntimeError("the traffic calibrates and the traced stretch "
                           "holds no 'calibrate' span of the program")
    busy = st.busy()
    idle = 0.0
    for a, b in cal:
        idle += (b - a) - sum(max(0.0, min(b, y) - max(a, x))
                              for x, y in busy if y > a and x < b)
    return 100.0 * idle / (t1 - t0)
