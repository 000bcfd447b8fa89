"""The readings that the limits of ``correct`` are set from, at a cell's
own size, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--out FILE]

For each of ``--seeds``: one run of the program with a window of one
round, its followed rounds against the reference (the lower readings).
For each of ``--control-seeds``: the reference put in the program's place,
computed with fp8 operands in its bf16 products (the control), and with
each planted fault (``half``: each loss over half the batch; ``noavg``:
client 0's model in place of FedAvg, the exchange left out; ``upload``:
client 0's update doubled; ``answer``: the aggregate's update of its first
leaf doubled), against the reference (the upper readings). A model left
unchanged reads 1 on every leaf gap by their definition and is not run.
Each reading is one JSON line on standard output (and in ``--out``).

Where the cell's file already holds limits, each reading also carries the
verdict that ``run.py`` gives it with them (``correct`` and the numbers
beside their limits): the program's runs have to come out correct, and
the control and every fault, the unchanged model included, not correct.
The exit code is 6 where one does not.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FAULTS = ("half", "noavg", "upload", "answer")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from portbench.lib import cells
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    build.build_all()
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    wrong = readings(cells.load(ROOT, args.workload),
                     torch.device("cuda", 0),
                     [int(s) for s in args.seeds.split(",") if s],
                     [int(s) for s in args.control_seeds.split(",") if s],
                     emit)
    if wrong:
        print(f"calibrate: the limits misjudge {', '.join(wrong)}",
              file=sys.stderr)
        return 6
    return 0


def readings(cell, device, seeds, control_seeds, emit) -> list:
    """Emit the readings of ``cell`` on ``device``; returns the readings
    whose verdict under the cell's limits is not what it has to be."""
    import torch
    from portbench.lib import cells
    from portbench.lib.fl import compare, detail, verdict
    from portbench.reference.common import Numerics
    from portbench.run import run_cell

    limits = cell.checks.get("limits")
    cuda = device.type == "cuda"
    wrong = []

    def record(kind, seed, nums, extra):
        rec = {"kind": kind, "seed": seed,
               **{k: v for k, (v, _) in nums.items()}, **extra,
               "where": {k: w for k, (_, w) in nums.items()}}
        if limits is not None:
            check, correct = verdict(nums, limits)
            rec.update(correct=correct, check=check)
            if correct != (kind == "program"):
                wrong.append(f"{kind} seed {seed}")
        emit(rec)

    keep = {}
    for seed in seeds:
        t = time.perf_counter()
        res = run_cell(cell, seed, 0.0, 0, device, t0=t, keep=keep)
        if isinstance(res, str):
            emit({"kind": "program", "seed": seed, "error": res})
            wrong.append(f"program seed {seed}")
            continue
        record("program", seed, compare(*keep["compared"]),
               {**detail(*keep["compared"]),
                "seconds": time.perf_counter() - t})
        if cuda:
            torch.cuda.empty_cache()
    dtype = cell.config["model"]["compute_dtype"]
    for seed in control_seeds:
        run = cells.driver(cell).Run(cell, seed, device)
        torch.backends.cuda.matmul.allow_tf32 = False
        t = time.perf_counter()
        ref, grads = run.follow(Numerics(dtype))
        ref_s = time.perf_counter() - t
        for kind, num, fault in [("control", Numerics(dtype, True), None)] \
                + [(f, Numerics(dtype), f) for f in FAULTS]:
            try:
                other, _ = run.follow(num, fault)
            except Exception as e:     # a crash is a failed control
                emit({"kind": kind, "seed": seed, "error": repr(e)})
                continue
            record(kind, seed, compare(other, ref, grads),
                   {**detail(other, ref, grads), "reference_s": ref_s})
            del other
            if cuda:
                torch.cuda.empty_cache()
        # a model left unchanged: its change is nought, every leaf gap 1
        record("unchanged", seed, {k: (1.0, "every leaf") for k in
                                   ("grad_gap", "grad_median_gap",
                                    "change_gap")}, {})
        del run, ref
        if cuda:
            torch.cuda.empty_cache()
    return wrong


if __name__ == "__main__":
    sys.exit(main())
