"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. It
makes the cell's inputs and initial model from the seed, runs the
program's FL driver with the warm-up round as set-up and a window of whole
rounds after it, checks the program's first rounds against the plain
reference in ``portbench/reference/`` and prints one JSON line last on
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics from a run with the program's tracer on and the
profiler over a stretch of the window (``--trace 1``). The numbers that
decide ``correct`` are printed with their limits on standard error too.
Without the cards the cell asks for it fails and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# whole top-level module names that the process may not hold once the
# window has closed: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def provenance(chips: int):
    import torch
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"unread ({e})"
    print(f"provenance: torch {torch.__version__} ({torch.get_num_threads()}"
          f" threads), CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), the cell uses {chips}; "
          f"nvidia-smi name, power limit: {limit}", flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.lib import cells
    cell = cells.load(ROOT, args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 3
    provenance(cell.chips)
    from repro_torch.kernels import build
    build.build_all()
    result = run_cell(cell, args.seed, args.seconds, args.trace,
                      torch.device("cuda", 0))
    if isinstance(result, str):
        print(f"portbench: {result}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 5
    for k, c in result["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"({c['where']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: int, device, *,
             t0: float = T0, keep=None):
    """One run of ``cell`` on ``device`` from ``t0``: the result's dict,
    or the reason there is none. A dict ``keep`` gets what was compared
    (``compared``: the program's and the reference's readings)."""
    import torch
    from portbench.lib import cells
    from portbench.lib.fl import compare, verdict
    from portbench.lib.window import RoundClock, StopWindow
    from portbench.reference.common import Numerics
    from repro_torch.kernels import ops

    run = cells.driver(cell).Run(cell, seed, device)
    trace_rounds = int(cell.traffic["trace_rounds"])
    spans_clock = []
    obs = None
    if trace:
        from repro_torch.obs import make_obs

        def clock():
            t = time.perf_counter()
            if not spans_clock:
                spans_clock.append(t)
            return t
        obs = make_obs(trace=True, clock=clock)
    traced = {}

    def on_round(n, frame):
        # the stretch holds whole rounds and none of the captures' work
        if trace and n > 1 and "done" not in traced:
            st = traced["stretch"]
            st.rounds += 1
            if st.rounds == trace_rounds or rc.w1 is not None:
                st.stop()
                st.last = n
                traced["done"] = st
        run.capture(n, frame)
        if trace and n == 1:
            from portbench.lib.profile import Stretch
            traced["stretch"] = Stretch(ops.LAUNCHES)
            traced["stretch"].first = n

    rc = RoundClock(t0, seconds, on_round, device)
    try:
        run.program(rc.log, obs)
    except StopWindow:
        pass
    else:
        return "the program's plan ran out before the window closed"
    if rc.rounds < 1:
        return "no whole round in the window"
    e2e = {"setup_s": rc.setup_s,
           run.rate_metric: run.work_per_round * rc.rounds / rc.window_s,
           "peak_mem_gib": rc.window_peak / 2 ** 30}
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                return f"no end-to-end metric '{m['name']}' in this cell"
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    spans = []
    if obs is not None:
        spans = [(e["name"], spans_clock[0] + e["ts"] / 1e6,
                  spans_clock[0] + (e["ts"] + e["dur"]) / 1e6)
                 for e in obs.tracer.events if e.get("ph") == "X"]
    obs = None
    gc.collect()
    if rc.cuda:
        torch.cuda.empty_cache()

    # correct: the program's followed rounds against the plain reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref, grads = run.follow(Numerics(cell.config["model"]["compute_dtype"]))
    if keep is not None:
        keep["compared"] = (run.captured, ref, grads)
    check, correct = verdict(compare(run.captured, ref, grads),
                             cell.checks["limits"])

    dev = {"platform": "gpu" if rc.cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if rc.cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(rc.setup_peak, rc.window_peak)}
    result = {"correct": correct, "attempted": rc.rounds,
              "failed": rc.failed}
    breakdown = None
    if trace:
        st = traced.get("done")
        if st is None:
            return "the traced stretch did not close"
        ctx = Context(rc, run, st, spans)
        for m in cell.per_layer:
            try:
                value = cells.reader(ROOT, m["name"])(ctx)
            except RuntimeError as e:
                return f"{m['name']}: {e}"
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = st.busy_seconds()
        dev["window_s"] = st.seconds
        breakdown = {"device_ops": st.top_device_ops(),
                     "idle_gaps": st.idle_gaps(spans)}
    result.update(metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    print("round seconds:", [b - a for a, b in zip(rc.ends, rc.ends[1:])],
          flush=True)
    result["check"] = check
    return result


class Context:
    """What a per-layer metric's reader reads: the traced ``stretch``
    (``lib.profile``: the device trace of its rounds), the rest of the
    window after it (``rounds`` whole rounds in ``window_s`` seconds,
    from ``t0`` to ``t1`` on ``time.perf_counter``; the stretch itself
    where the window holds nothing after it), the program's spans (name,
    start, end on ``time.perf_counter``) and the per-round ``work`` of the
    traffic (``portbench.counts``); ``cuda``: whether the run has a device
    trace at all. The profiler slows the rounds it traces, so the
    host-timed shares leave them out. A reader that raises
    ``RuntimeError`` fails the run, naming the metric."""

    def __init__(self, clock, run, stretch, spans):
        self.cuda = clock.cuda
        a = stretch.last if stretch.last < len(clock.ends) else stretch.first
        b = len(clock.ends)
        self.rounds = b - a
        self.window_s = clock.ends[b - 1] - clock.ends[a - 1]
        self.t0, self.t1 = clock.stamps[a - 1], clock.stamps[b - 1]
        self.stretch, self.spans = stretch, spans
        self.work = run.round_work()


if __name__ == "__main__":
    # one host thread for the CPU math libraries, set before torch loads:
    # the program does no CPU tensor work in the window, and idle pool
    # threads only compete with its Python thread on a shared host (the
    # ViT cell's rounds are host-paced)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.exit(main())
