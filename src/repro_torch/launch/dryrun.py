"""Multi-pod dry run on ``meta``: every (arch x shape x mesh) combination's
sharded step, once, with no weights and no card.

The reference lowers and compiles each step on a 512-device host
platform; a successful compile proves that every sharding, collective and
memory layout resolves, and the compiled artifact gives the roofline. The
port has no compiler: it runs the sharded step (``launch.steps``, inputs
from ``launch.inputs``) eagerly on ``meta`` DTensors over a fake process
group of 256 or 512 ranks on one host, under ``roofline.StepRecorder``,
which counts one device's FLOPs, bytes, collectives and live memory
(``roofline.analysis``). A run that ends proves that DTensor found a
layout for every op (a kernel op with no sharding rule raises) and gives
the ``RooflineResult`` row; the terms are priced with the H100 constants
and each collective with the link of its mesh axis (``launch.mesh``).

What a fake process group cannot show: no collective moves data, so
nothing checks that the ranks agree, and nothing is timed; the rows are
reckoned from shapes. The collectives are those of the port's own
partitioning (DTensor's propagation of the rules' layouts, plus the
port's reshards), not those XLA's partitioner gives the reference: each
row's second line files them by source (``sharding.aten``), the rules'
layouts apart from the replicated view operands, the gathered embedding
table and InfoNCE's replicated rows. Every layer runs at full depth: an eager ``meta``
run counts each one (the reference's ``--rolled`` and ``--extrapolate``
exist for XLA's compile time and do nothing here). This is the one entry
point of the port that never touches the card: it takes no ``--device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun        # every pair
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \
      --shape train_4k --multi-pod --mode train_lw
"""
from __future__ import annotations

import argparse
import json
import logging
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.roofline.analysis import (StepRecorder, analyze_step,
                                           roofline_report, sources_report)

TABLE_ARCHS = [a for a in ARCH_IDS if a != "vit-tiny"]


def init_fake_group(world_size: int) -> None:
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0); an existing group of that size is kept."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    # DTensor warns on each two-step redistribution and on the CPU
    # group's all-to-all fallback; the recorder counts both
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def run_step(step, args, mesh):
    """``step(*args)`` under a ``StepRecorder``; returns (recorder,
    output)."""
    rec = StepRecorder(mesh)
    with rec:
        out = step(*args)
    return rec, out


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mode: str = None, out_rows: list = None, verbose: bool = True,
            cfg_override=None, mesh=None, shape_override=None):
    """One combination's row (``RooflineResult.to_dict()`` plus
    ``run_s``). ``mesh`` defaults to the production mesh over a fake group
    of its size; ``shape_override`` is ``input_specs``'."""
    if mesh is None:
        init_fake_group(MeshShape.production(multi_pod=multi_pod).size)
        mesh = make_production_mesh(multi_pod=multi_pod)
    shape_cfg = shape_override or INPUT_SHAPES[shape_name]
    mode = mode or shape_cfg.kind
    t0 = time.time()
    step, args, cfg, _ = input_specs(arch, shape_name, mesh, mode=mode,
                                     cfg_override=cfg_override,
                                     shape_override=shape_override)
    rec, out = run_step(step, args, mesh)
    res = analyze_step(rec, arch=arch, shape=shape_name, mode=mode,
                       mesh=mesh, cfg=cfg, shape_cfg=shape_cfg, args=args,
                       out=out)
    row = res.to_dict()
    row["run_s"] = time.time() - t0
    if verbose:
        print(roofline_report(res), f" [run {row['run_s']:.0f}s]",
              flush=True)
        print(sources_report(res), flush=True)
    if out_rows is not None:
        out_rows.append(row)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mode", default=None,
                    help="train|train_lw|prefill|decode (default: by shape)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--keep-going", action="store_true")
    ap.add_argument("--rolled", action="store_true",
                    help="the reference's fast compile; nothing to do here")
    ap.add_argument("--extrapolate", action="store_true",
                    help="the reference's depth extrapolation; nothing to "
                         "do here")
    args = ap.parse_args(argv)
    for flag in ("rolled", "extrapolate"):
        if getattr(args, flag):
            print(f"--{flag}: an eager meta run already counts every layer "
                  f"at full depth; running in full", flush=True)

    torch.set_grad_enabled(True)
    archs = [args.arch] if args.arch else TABLE_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    rows, failures = [], []
    for arch in archs:
        for shape in shapes:
            try:
                run_one(arch, shape, multi_pod=args.multi_pod,
                        mode=args.mode, out_rows=rows)
            except Exception as e:                      # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                print(f"FAIL {arch} {shape}: {e}", flush=True)
                if not args.keep_going:
                    traceback.print_exc()
                    raise
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
        print(f"wrote {len(rows)} rows -> {out}")
    if failures:
        print(f"{len(failures)} failures:", *failures, sep="\n  ")
        raise SystemExit(1)
    print(f"DRY-RUN OK: {len(rows)} combinations run on meta")


if __name__ == "__main__":
    main()
