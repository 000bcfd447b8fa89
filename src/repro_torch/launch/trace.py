"""Trace analysis CLI of the port — paper tables as views over telemetry
(``repro.launch.trace``).

Reads the JSONL traces the observability layer writes (``--trace`` on
``repro_torch.launch.train``, ``run_fedssl(obs=...)``; the reference's
traces have the same format) and regenerates, from the spans alone:

  round-time breakdown   wall-clock per phase (download / local_train /
                         calibrate, engine and transport child spans)
                         aggregated across rounds, per trace, with each
                         name's self time (its spans less their child
                         spans) and process CPU time (``cpu_us``).
  comm table             per-schedule analytic + measured wire bytes
                         summed over the ``round`` spans, with ratios
                         against the e2e trace when one is among the
                         inputs — the paper's Table 1/3 communication
                         columns (0.08 / 0.31 / 0.54 vs FedMoCo).

``--emit-comm`` writes a paper-scale comm trace without training: it walks
the full 180-round schedule over the ViT-Tiny + MoCo tree built on the
``meta`` device (shapes only), routes every round's payload specs through
the ``Transport`` byte accounting, and records the ``round`` spans the
driver would. ``--paper-table`` measures memory and GFLOPs of one local
step per plan signature (``repro_torch.obs.resources``) on both engines x
the five schedules, on the card by default at full ViT-Tiny width
(``--reduced`` takes the reference's reduced measurement config, the
CPU's), beside the analytic roofline and the paper's multipliers:

  python -m repro_torch.launch.trace --paper-table
  python -m repro_torch.launch.trace --paper-table --device cpu --reduced
  python -m repro_torch.launch.trace --emit-comm --out-dir results/
  python -m repro_torch.launch.trace results/comm_trace_*.jsonl
"""
from __future__ import annotations

import argparse
import pathlib
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.obs import read_jsonl, write_jsonl
from repro_torch.obs.trace import Tracer

COMM_ATTRS = ("download_bytes", "upload_bytes", "wire_download_bytes",
              "wire_upload_bytes")


# ---------------------------------------------------------------------------
# analysis: traces -> tables
# ---------------------------------------------------------------------------
def run_args(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Attributes of the trace's ``run`` span (schedule, engine, codec)."""
    for e in events:
        if e["name"] == "run":
            return dict(e["args"])
    return {}


def round_spans(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [e for e in events
            if e["name"] == "round" and e["ph"] == "X"]


def comm_totals(events: Sequence[Dict[str, Any]]) -> Dict[str, int]:
    """Sum the per-round byte attributes over the trace's round spans."""
    totals = {a: 0 for a in COMM_ATTRS}
    for e in round_spans(events):
        for a in COMM_ATTRS:
            totals[a] += int(e["args"].get(a, 0))
    totals["comm_bytes"] = (totals["download_bytes"]
                            + totals["upload_bytes"])
    totals["wire_bytes"] = (totals["wire_download_bytes"]
                            + totals["wire_upload_bytes"])
    totals["rounds"] = len(round_spans(events))
    return totals


def comm_table(traces: Sequence[Tuple[Dict, List[Dict]]]
               ) -> List[Dict[str, Any]]:
    """One row per trace: schedule, byte totals, and — when an ``e2e``
    trace is among the inputs — the download/upload/total ratios against
    it (the paper's comm multiplier columns)."""
    rows = []
    for header, events in traces:
        info = run_args(events)
        row = {"schedule": info.get("schedule",
                                    header.get("schedule", "?")),
               "codec": info.get("codec", "?")}
        row.update(comm_totals(events))
        rows.append(row)
    base = next((r for r in rows if r["schedule"] == "e2e"), None)
    for r in rows:
        if base is not None and base["comm_bytes"] > 0:
            r["download_ratio"] = r["download_bytes"] / max(
                1, base["download_bytes"])
            r["upload_ratio"] = r["upload_bytes"] / max(
                1, base["upload_bytes"])
            r["comm_ratio"] = r["comm_bytes"] / base["comm_bytes"]
    return rows


def round_breakdown(events: Sequence[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, float]]:
    """Aggregate span durations by name: {name: {count, total_s, mean_s,
    self_s, cpu_s}} for every completed wall-clock span (virtual sim
    tracks excluded). ``self_s`` is ``total_s`` less the durations of the
    spans' child spans; ``cpu_s`` the summed process CPU time of the
    spans (their ``cpu_us``), None where no span of the name has one (a
    trace of the reference's)."""
    spans = [e for e in events if e["ph"] == "X" and e["cat"] != "sim"]
    child_us: Dict[int, float] = {}
    for e in spans:
        if e["parent"] is not None:
            child_us[e["parent"]] = child_us.get(e["parent"], 0.0) + e["dur"]
    out: Dict[str, Dict[str, float]] = {}
    for e in spans:
        d = out.setdefault(e["name"], {"count": 0, "total_s": 0.0,
                                       "self_s": 0.0, "cpu_s": None})
        d["count"] += 1
        d["total_s"] += e["dur"] / 1e6
        d["self_s"] += (e["dur"] - child_us.get(e["seq"], 0.0)) / 1e6
        if "cpu_us" in e["args"]:
            d["cpu_s"] = (d["cpu_s"] or 0.0) + e["args"]["cpu_us"] / 1e6
    for d in out.values():
        d["mean_s"] = d["total_s"] / d["count"]
    return out


def print_breakdown(path, events):
    info = run_args(events)
    label = " ".join(f"{k}={info[k]}" for k in
                     ("schedule", "engine", "codec") if k in info)
    print(f"\n-- {path}: {label}")
    br = round_breakdown(events)
    order = sorted(br, key=lambda n: -br[n]["total_s"])
    print(f"   {'span':24s} {'count':>6s} {'total':>10s} {'mean':>10s}"
          f" {'self':>10s} {'cpu':>10s}")
    for name in order:
        d = br[name]
        cpu = "-" if d["cpu_s"] is None else f"{d['cpu_s']:.3f}s"
        print(f"   {name:24s} {d['count']:6d} {d['total_s']:9.3f}s "
              f"{d['mean_s'] * 1e3:8.2f}ms {d['self_s']:9.3f}s {cpu:>10s}")


def print_comm_table(rows):
    print("\n== comm totals (from round spans) ==")
    hdr = (f"{'schedule':12s} {'rounds':>6s} {'down(MB)':>10s} "
           f"{'up(MB)':>10s} {'wire(MB)':>10s}")
    has_ratio = any("comm_ratio" in r for r in rows)
    if has_ratio:
        hdr += f" {'down x':>8s} {'up x':>8s} {'comm x':>8s}"
    print(hdr)
    for r in rows:
        line = (f"{r['schedule']:12s} {r['rounds']:6d} "
                f"{r['download_bytes'] / 1e6:10.1f} "
                f"{r['upload_bytes'] / 1e6:10.1f} "
                f"{r['wire_bytes'] / 1e6:10.1f}")
        if "comm_ratio" in r:
            line += (f" {r['download_ratio']:8.2f} {r['upload_ratio']:8.2f}"
                     f" {r['comm_ratio']:8.2f}")
        print(line)
    if has_ratio:
        print("(ratios vs the e2e trace — paper Table 3 comm column: "
              "layerwise 0.08, lw_fedssl 0.31, progressive 0.54)")


# ---------------------------------------------------------------------------
# paper table: measured vs analytic vs published resource reductions
# ---------------------------------------------------------------------------
def _full_online(arch: str):
    from repro_torch.configs.base import SSLConfig, load_arch
    from repro_torch.roofline.client_costs import build_ssl_param_tree
    cfg = load_arch(arch)
    return cfg, build_ssl_param_tree(cfg, SSLConfig())["online"]


def fullscale_comm(schedule: str, *, arch: str = "vit-tiny",
                   rounds: int = 180, include_heads: bool = False) -> int:
    """Total comm bytes of ``schedule`` at paper scale — the same walk over
    the ``meta`` tree as ``emit_comm_trace`` without writing a trace.
    Ratios against e2e reproduce the paper's comm multipliers (0.08 / 0.31
    / 0.54)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import schedule as sched
    from repro_torch.federated import comm

    cfg, online = _full_online(arch)
    fl = FLConfig(rounds=rounds, schedule=schedule,
                  include_heads=include_heads)
    total = 0
    for plan in sched.build_schedule(fl, cfg.num_layers):
        cb = comm.round_comm_bytes(online, plan,
                                   include_heads=include_heads)
        total += cb["download"] + cb["upload"]
    return total


def paper_table(*, engines=("sequential", "vmap"), arch: str = "vit-tiny",
                comm_rounds: int = 180, measure_rounds: int = 20,
                cfg=None, ssl=None, train=None, device="cuda",
                log=None) -> dict:
    """Build the measured-resources paper table document.

    Three sources per schedule: *measured* FLOPs and peak memory of one
    local step per plan signature (``repro_torch.obs.resources
    .measure_schedule``; memory only on the card), at ``cfg/ssl/train``
    (default: full-width ViT-Tiny, ``SSLConfig()``, batch 256); *analytic*
    predictions on the same config (and, for the reduction multipliers, at
    full scale via ``client_costs.schedule_costs``); the paper's published
    Table 3 multipliers. Comm is counted at full scale over the ``meta``
    tree, the one column where measurement and paper have the same scale,
    which is why its multipliers must match the paper's."""
    from repro_torch.core import schedule as sched
    from repro_torch.obs import resources as res_mod
    from repro_torch.roofline import client_costs as cc

    comm_bytes = {s: fullscale_comm(s, arch=arch, rounds=comm_rounds)
                  for s in sched.SCHEDULES}
    analytic_full = {s: cc.schedule_costs(s, rounds=comm_rounds)
                     for s in sched.SCHEDULES}
    rows = []
    for engine in engines:
        for s in sched.SCHEDULES:
            m = res_mod.measure_schedule(
                s, engine, cfg=cfg, ssl=ssl, train=train,
                rounds=measure_rounds, device=device, log=log)
            m["comm_bytes"] = comm_bytes[s]
            m["comm_ratio"] = comm_bytes[s] / comm_bytes["e2e"]
            m["analytic_flops_ratio"] = (
                analytic_full[s]["flops_total"]
                / analytic_full["e2e"]["flops_total"])
            m["analytic_memory_ratio"] = (
                analytic_full[s]["peak_memory"]
                / analytic_full["e2e"]["peak_memory"])
            rows.append(m)
        base = next(r for r in rows
                    if r["engine"] == engine and r["schedule"] == "e2e")
        for r in rows:
            if r["engine"] != engine:
                continue
            r["flops_ratio"] = r["flops_total"] / base["flops_total"]
            r["memory_ratio"] = (
                r["peak_memory"] / base["peak_memory"]
                if r["peak_memory"] and base["peak_memory"] else None)
            r["program_memory_ratio"] = (r["program_peak_analytic"]
                                         / base["program_peak_analytic"])
    meas = rows[0]
    return {
        "version": 1,
        "arch": arch, "comm_rounds": comm_rounds,
        "device": meas["device"],
        "measurement": {"num_layers": meas["num_layers"],
                        "batch_size": meas["batch_size"],
                        "rounds": meas["rounds"],
                        "local_epochs": meas["local_epochs"]},
        "tolerances": {"flops_rtol": res_mod.FLOPS_RTOL,
                       "memory_factor": res_mod.MEMORY_FACTOR},
        "paper_mult": {s: list(cc.PAPER_MULT[s]) for s in sched.SCHEDULES},
        "rows": rows,
    }


def print_paper_table(doc: dict):
    from repro_torch.roofline.client_costs import PAPER_MULT, SCHEDULE_NAMES

    m = doc["measurement"]
    print(f"\n== measured resources vs analytic vs paper (FlopCounterMode "
          f"FLOPs, allocator peak memory; {doc['device']}) ==")
    print(f"measurement config: {m['num_layers']} layers, batch "
          f"{m['batch_size']}, {m['rounds']} rounds x "
          f"{m['local_epochs']} local epochs ({doc['arch']}); comm at full "
          f"{doc['arch']} scale, {doc['comm_rounds']} rounds")
    hdr = (f"{'engine':10s} {'schedule':12s} {'GFLOPs':>9s} {'vs-an':>6s} "
           f"{'peak MiB':>9s} {'vs-an':>6s} "
           f"{'flops x':>8s} {'mem x':>6s} {'an. x':>6s} {'comm x':>7s} "
           f"{'paper (m/f/c)':>16s}")
    print(hdr)
    for r in doc["rows"]:
        pm = PAPER_MULT[r["schedule"]]
        fl_vs = r["flops_total"] / r["analytic_flops_total"]
        if r["peak_memory"]:
            mem = f"{r['peak_memory'] / 2**20:9.1f}"
            mem_vs = f"{r['peak_memory'] / r['program_peak_analytic']:6.2f}"
            mem_x = (f"{r['memory_ratio']:6.2f}"
                     if r.get("memory_ratio") else "     -")
        else:
            mem, mem_vs, mem_x = "        -", "     -", "     -"
        print(f"{r['engine']:10s} {r['schedule']:12s} "
              f"{r['flops_total'] / 1e9:9.2f} {fl_vs:6.2f} "
              f"{mem} {mem_vs} "
              f"{r['flops_ratio']:8.2f} {mem_x} "
              f"{r['program_memory_ratio']:6.2f} {r['comm_ratio']:7.2f} "
              f"{pm[0]:.2f}/{pm[1]:.2f}/{pm[2]:.2f}")
    print("(vs-an: measured / analytic at the measurement config — "
          f"flops within {doc['tolerances']['flops_rtol']:.0%}, peak "
          f"within {doc['tolerances']['memory_factor']:.3g}x of the eager "
          "engines' memory model; x-columns: reduction vs this engine's "
          "e2e row (an. x: the memory model's); comm x is full-scale and "
          "matches the paper column exactly; the paper's idealized client "
          "footprint multipliers: "
          + ", ".join(f"{SCHEDULE_NAMES[s]} {PAPER_MULT[s][0]:.2f}"
                      for s in PAPER_MULT) + ")")


# ---------------------------------------------------------------------------
# emit: paper-scale comm traces without training
# ---------------------------------------------------------------------------
def emit_comm_trace(schedule: str, out, *, arch: str = "vit-tiny",
                    rounds: int = 180, codec: str = "fp32",
                    include_heads: bool = False) -> pathlib.Path:
    """Walk ``schedule`` over the ``meta`` model tree and write a trace
    whose ``round`` spans carry the byte attributes a traced run records —
    the driver's own accounting (``comm.round_comm_bytes`` + ``Transport``
    wire sizes), only the training in between skipped.
    ``include_heads=False`` matches the paper's encoder-only comm columns.

    For delta codecs (topk) the recorded wire bytes are the steady-state
    sparse sizes; the dense re-sync round at stage transitions is a
    live-run behavior this dry walk does not model."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import schedule as sched
    from repro_torch.federated import comm
    from repro_torch.federated.transport import Transport

    cfg, online = _full_online(arch)
    wire = Transport(codec, include_heads=include_heads)
    fl = FLConfig(rounds=rounds, schedule=schedule,
                  include_heads=include_heads)
    plans = sched.build_schedule(fl, cfg.num_layers)
    tracer = Tracer()
    with tracer.span("run", cat="fl", mode="comm-dryrun",
                     schedule=schedule, arch=arch, codec=wire.codec.name,
                     rounds=rounds, include_heads=include_heads):
        for plan in plans:
            cb = comm.round_comm_bytes(online, plan,
                                       include_heads=include_heads)
            specs = wire.plan_specs(online, plan)
            with tracer.span("round", cat="fl", round=plan.round_idx,
                             stage=plan.stage,
                             download_bytes=cb["download"],
                             upload_bytes=cb["upload"],
                             wire_download_bytes=wire.wire_bytes(
                                 specs["download"]),
                             wire_upload_bytes=wire.wire_bytes(
                                 specs["upload"])):
                pass
    return write_jsonl(tracer, out, source="comm-dryrun")


def main(argv=None):
    from repro_torch.core import schedule as sched

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.trace",
        description="Analyze JSONL traces (round-time breakdown + comm "
                    "table), emit paper-scale comm traces without training "
                    "(--emit-comm), or measure the paper table "
                    "(--paper-table).")
    ap.add_argument("traces", nargs="*",
                    help="JSONL trace files to analyze")
    ap.add_argument("--emit-comm", action="store_true",
                    help="emit comm-dryrun traces instead of analyzing")
    ap.add_argument("--paper-table", action="store_true",
                    help="measure FLOPs (FlopCounterMode) and, on the card, "
                         "peak memory of one local step per plan signature "
                         "(both engines x all five schedules) and print "
                         "them next to the analytic roofline and the "
                         "paper's published multipliers; comm is the "
                         "full-scale transport walk")
    ap.add_argument("--device", default="cuda",
                    help="--paper-table: cuda (default; raises without a "
                         "GPU) or cpu (no peak memory)")
    ap.add_argument("--reduced", action="store_true",
                    help="--paper-table: the reference's reduced "
                         "measurement config (4 layers, batch 8) in place "
                         "of full-width ViT-Tiny at batch 256")
    ap.add_argument("--engines", default="sequential,vmap",
                    help="--paper-table: comma-separated round engines "
                         "to measure")
    ap.add_argument("--measure-rounds", type=int, default=20,
                    help="--paper-table: rounds in the measurement "
                         "schedule (flops totals scale with it; ratios "
                         "do not)")
    ap.add_argument("--json", default="",
                    help="--paper-table: also write the table document "
                         "to this JSON path")
    ap.add_argument("--schedule", default=None, choices=sched.SCHEDULES,
                    help="emit only this schedule (default: all five)")
    ap.add_argument("--arch", default="vit-tiny")
    ap.add_argument("--rounds", type=int, default=180)
    ap.add_argument("--codec", default="fp32")
    ap.add_argument("--include-heads", action="store_true",
                    help="count the SSL heads in the payload (paper "
                         "tables are encoder-only)")
    ap.add_argument("--out-dir", default="results",
                    help="--emit-comm output directory "
                         "(comm_trace_<schedule>.jsonl)")
    args = ap.parse_args(argv)

    if args.paper_table:
        from repro_torch.federated.driver import resolve_device
        from repro_torch.obs import resources as res_mod
        device = resolve_device(args.device)
        cfg, ssl, train = (res_mod.measurement_config(args.arch)
                           if args.reduced
                           else res_mod.full_width_config(args.arch))
        doc = paper_table(
            engines=tuple(e for e in args.engines.split(",") if e),
            arch=args.arch, comm_rounds=args.rounds,
            measure_rounds=args.measure_rounds, cfg=cfg, ssl=ssl,
            train=train, device=device, log=print)
        print_paper_table(doc)
        if args.json:
            import json
            with open(args.json, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"wrote {args.json}")
        if not args.traces and not args.emit_comm:
            return doc

    if args.emit_comm:
        schedules = ((args.schedule,) if args.schedule
                     else sched.SCHEDULES)
        for s in schedules:
            out = pathlib.Path(args.out_dir) / f"comm_trace_{s}.jsonl"
            emit_comm_trace(s, out, arch=args.arch, rounds=args.rounds,
                            codec=args.codec,
                            include_heads=args.include_heads)
            print(f"wrote {out}")
        if not args.traces:
            args.traces = [str(pathlib.Path(args.out_dir)
                               / f"comm_trace_{s}.jsonl")
                           for s in schedules]

    if not args.traces:
        ap.error("nothing to do: pass trace files and/or --emit-comm")
    loaded = [(p, read_jsonl(p)) for p in args.traces]
    for p, (header, events) in loaded:
        print_breakdown(p, events)
    print_comm_table(comm_table([t for _, t in loaded]))


if __name__ == "__main__":
    main()
