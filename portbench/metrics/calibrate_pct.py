"""Share of the window's untraced rounds that the server spends in its
``calibrate`` spans (the calibration steps on the server's auxiliary
images after FedAvg), from the tracer of the traced run, read as
``local_train_pct`` reads its spans. A traffic without calibration reads
0; one with it fails the run where the spans are missing."""
from portbench.metrics._spans import calibrates, traffic, window_share


def read(ctx):
    required = ("calibrate",) if calibrates(traffic(ctx)) else ()
    return window_share(ctx, ("calibrate",), required)
