"""The port's resource observatory and paper table against the JAX
package's (``repro.obs.resources``, ``repro.roofline``,
``repro.launch.trace``).

- Analytic parity, exact: ``client_costs.schedule_costs`` of every
  schedule, ``PAPER_MULT``, the full-scale comm walk, ``emit_comm_trace``'s
  round attributes, ``model_flops`` and ``chunk_loop_correction``.
- The trace CLI: the port's printers give the reference's output on the
  same traces, and each CLI reads the other's.
- FLOPs: at the reduced ``measurement_config()`` every plan signature's
  counted FLOPs is within ``FLOPS_RTOL`` of the analytic count on both
  engines; the port's count against the reference's XLA ``cost_analysis``
  count of the same signature; the kernel-backed ops counted by their
  formulas, never through their plain versions.
- Memory: the CPU snapshot (RSS), ``mem.*`` ignored by ``structure()``;
  peak memory is measured on the card only (``tests/test_torch_cuda.py``).
- ``measure_resources``: losses and state bit-identical to an unmeasured
  run on both engines, ``res.*`` on each stage's first round span and
  ``mem.*`` on every round span, through the driver and the launcher.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.core import schedule as jsched
from repro.launch import trace as jtrace
from repro.obs import resources as jres
from repro.roofline import analysis as janalysis
from repro.roofline import client_costs as jcc
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.core import schedule as tsched
from repro_torch.data.partition import iid_partition
from repro_torch.federated import comm as tcomm
from repro_torch.federated.driver import run_fedssl
from repro_torch.kernels import ops
from repro_torch.launch import trace as ttrace
from repro_torch.launch import train
from repro_torch.obs import resources as tres
from repro_torch.obs.trace import Tracer
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import client_costs as tcc

torch.set_num_threads(2)

SCHEDULES = jsched.SCHEDULES


# ---------------------------------------------------------------------------
# analytic parity (exact)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_costs_match_reference(schedule):
    got, want = tcc.schedule_costs(schedule), jcc.schedule_costs(schedule)
    assert got == want


def test_paper_mult_and_param_tree_match_reference():
    assert tcc.PAPER_MULT == jcc.PAPER_MULT
    assert tcc.SCHEDULE_NAMES == jcc.SCHEDULE_NAMES
    tree = tcc.build_ssl_param_tree()
    jtree = jcc.build_ssl_param_tree()
    from repro.federated import comm as jcomm
    for branch in ("online", "target"):
        assert all(t.device.type == "meta" for t in tree[branch].values())
        assert tcomm.tree_bytes(tree[branch]) == jcomm.tree_bytes(
            jtree[branch])
    assert dataclasses.asdict(tcc.vit_costs()) == dataclasses.asdict(
        jcc.vit_costs())


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fullscale_comm_matches_reference(schedule):
    got = ttrace.fullscale_comm(schedule)
    assert got == jtrace.fullscale_comm(schedule)
    assert got == tcc.schedule_costs(schedule)["comm_total"]
    # the reference's acceptance: the paper's comm column within abs 0.005
    ratio = got / ttrace.fullscale_comm("e2e")
    assert abs(ratio - tcc.PAPER_MULT[schedule][2]) <= 0.005


@pytest.mark.parametrize("codec", ["fp32", "int8", "topk:0.1"])
def test_emit_comm_trace_matches_reference(codec, tmp_path):
    keys = ("round", "stage", "download_bytes", "upload_bytes",
            "wire_download_bytes", "wire_upload_bytes")
    for schedule in ("lw_fedssl", "progressive"):
        rows = []
        for mod, sub in ((ttrace, "port"), (jtrace, "ref")):
            path = mod.emit_comm_trace(schedule,
                                       tmp_path / sub / f"{schedule}.jsonl",
                                       rounds=24, codec=codec)
            _, events = tobs.read_jsonl(path)
            rows.append([{k: e["args"][k] for k in keys}
                         for e in ttrace.round_spans(events)])
        assert rows[0] == rows[1] and len(rows[0]) == 24


ROOFLINE_CASES = [(arch, mode) for arch in ("vit-tiny", "zamba2-2.7b")
                  for mode in ("train", "train_lw", "prefill", "decode")]


@pytest.mark.parametrize("arch,mode", ROOFLINE_CASES)
def test_model_flops_and_chunk_correction_match_reference(arch, mode):
    tshape = tbase.INPUT_SHAPES["train_4k"]
    jshape = jbase.INPUT_SHAPES["train_4k"]
    tcfg, jcfg = tbase.load_arch(arch), jbase.load_arch(arch)
    assert tanalysis.model_flops(tcfg, tshape, mode) == \
        janalysis.model_flops(jcfg, jshape, mode)
    for n in (1, 4):
        assert tanalysis.chunk_loop_correction(tcfg, tshape, mode, n) == \
            janalysis.chunk_loop_correction(jcfg, jshape, mode, n)


def test_roofline_result_prices_with_h100_constants():
    from repro_torch.launch import mesh
    r = tanalysis.RooflineResult(
        "vit-tiny", "s", "train", "1", 1, flops_dev=989e12,
        bytes_dev=3.35e12 / 2, coll_bytes_dev=0.0, coll_detail={},
        mem_per_device={"peak_bytes": 2**30}, model_flops_total=494.5e12)
    assert r.compute_s == 1.0 and r.memory_s == 0.5
    assert r.dominant == "compute" and r.useful_ratio == 0.5
    assert mesh.PEAK_FLOPS_BF16 == 989e12 and mesh.HBM_BW == 3.35e12
    assert "compute" in tanalysis.roofline_report(r)
    assert json.dumps(r.to_dict())


# ---------------------------------------------------------------------------
# trace CLI: the reference's output on the same traces
# ---------------------------------------------------------------------------
def _span(name, cat, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": 0, "dur": dur,
            "pid": 0, "tid": 0, "seq": 0, "parent": None, "depth": 0,
            "args": args}


def test_breakdown_and_comm_table_print_the_reference_output(capsys):
    events = [_span("run", "fl", 4_000_000, schedule="lw_fedssl",
                    engine="sequential", codec="fp32"),
              _span("round", "fl", 2_000_000, round=0),
              _span("round", "fl", 2_000_000, round=1),
              _span("local_train", "fl", 1_500_000),
              _span("local_train", "fl", 1_500_000),
              _span("client", "sim", 9_000_000)]

    def trace(schedule, down, up):
        return {"schedule": schedule}, [
            _span("run", "fl", 1, schedule=schedule, codec="fp32"),
            _span("round", "fl", 1, download_bytes=down, upload_bytes=up,
                  wire_download_bytes=down, wire_upload_bytes=up)]

    traces = [trace("e2e", 10_000_000, 10_000_000),
              trace("layerwise", 1_000_000, 1_000_000)]
    outs = []
    want = jtrace.round_breakdown(events)
    for mod in (ttrace, jtrace):
        mod.print_breakdown("run.jsonl", events)
        got = mod.round_breakdown(events)
        # the port adds each name's self and CPU time to the reference's
        assert {n: {k: d[k] for k in want[n]} for n, d in got.items()} \
            == want
        rows = mod.comm_table(traces)
        assert rows == jtrace.comm_table(traces)
        mod.print_comm_table(rows)
        outs.append(capsys.readouterr().out)
    port, ref = (o.splitlines() for o in outs)
    assert len(port) == len(ref)
    assert all(p.startswith(r) for p, r in zip(port, ref))
    assert "local_train                   2     3.000s  1500.00ms" in outs[0]
    # no span here has children or a CPU time
    assert "1500.00ms     3.000s          -" in outs[0]


def test_breakdown_adds_self_and_cpu_time(capsys):
    """Self time is a span's duration less its child spans' (a virtual
    track's spans are no children); CPU time sums the spans' ``cpu_us``."""
    def span(seq, parent, name, dur, cat="step", **args):
        return {**_span(name, cat, dur, **args), "seq": seq,
                "parent": parent}
    events = [span(0, None, "local_step", 1_000_000, cpu_us=900_000.0),
              span(1, 0, "step.forward", 300_000, cpu_us=250_000.0),
              span(2, 0, "step.update", 500_000, cpu_us=480_000.0),
              span(3, 0, "client", 9_000_000, cat="sim"),
              span(4, None, "local_step", 2_000_000, cpu_us=100_000.0),
              span(5, 4, "step.update", 1_500_000, cpu_us=90_000.0),
              {"ph": "i", "name": "mark", "cat": "fl", "ts": 0, "dur": 0.0,
               "pid": 0, "tid": 0, "seq": 6, "parent": 4, "depth": 1,
               "args": {}}]
    br = ttrace.round_breakdown(events)
    assert br["local_step"]["count"] == 2
    assert br["local_step"]["self_s"] == pytest.approx(0.2 + 0.5)
    assert br["local_step"]["cpu_s"] == pytest.approx(1.0)
    assert br["step.update"]["self_s"] == pytest.approx(2.0)
    assert br["step.update"]["cpu_s"] == pytest.approx(0.57)
    assert "client" not in br and "mark" not in br
    ttrace.print_breakdown("run.jsonl", events)
    out = capsys.readouterr().out
    assert "self" in out and "cpu" in out
    assert ("local_step                    2     3.000s  1500.00ms     "
            "0.700s     1.000s") in out


def test_both_clis_read_each_others_traces(tmp_path, capsys):
    ttrace.main(["--emit-comm", "--out-dir", str(tmp_path / "port"),
                 "--codec", "int8", "--rounds", "24"])
    jtrace.main(["--emit-comm", "--out-dir", str(tmp_path / "ref"),
                 "--codec", "int8", "--rounds", "24"])
    capsys.readouterr()
    names = [f"comm_trace_{s}.jsonl" for s in SCHEDULES]
    outs = []
    for main, sub in ((ttrace.main, "ref"), (jtrace.main, "port")):
        main([str(tmp_path / sub / n) for n in names])
        out = capsys.readouterr().out
        # the breakdown's timings are host time; the comm table is bytes
        outs.append(out[out.index("== comm totals"):])
    assert outs[0] == outs[1]
    assert "0.08" in outs[0] and "0.31" in outs[0] and "0.54" in outs[0]


def test_paper_table_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "paper.json"
    doc = ttrace.main(["--paper-table", "--device", "cpu", "--reduced",
                       "--engines", "sequential", "--measure-rounds", "4",
                       "--json", str(out)])
    text = capsys.readouterr().out
    assert "measured resources vs analytic vs paper" in text
    assert json.loads(out.read_text())["rows"] == json.loads(
        json.dumps(doc["rows"]))
    assert [r["schedule"] for r in doc["rows"]] == list(SCHEDULES)
    for r in doc["rows"]:
        assert r["comm_bytes"] == tcc.schedule_costs(r["schedule"])[
            "comm_total"]
        assert r["peak_memory"] is None       # not measured on the CPU
        assert abs(r["flops_total"] / r["analytic_flops_total"] - 1) \
            <= tres.FLOPS_RTOL



def test_paper_table_cli_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrace.main(["--paper-table"])


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------
MEASURE_CASES = [(s, "sequential", 1) for s in SCHEDULES] + \
    [("e2e", "vmap", 2), ("lw_fedssl", "vmap", 2), ("fll_dd", "vmap", 2)]


@pytest.mark.parametrize("schedule,engine,clients", MEASURE_CASES)
def test_counted_flops_within_rtol_of_analytic(schedule, engine, clients):
    """The reference's test_flops_crosscheck_analytic_vs_xla, with the
    counter in place of XLA's cost analysis: every signature within
    ``FLOPS_RTOL`` (0.30), and (as XLA's) never below the analytic count,
    which folds the recomputed products of the backward away."""
    cfg, ssl, train_cfg = tres.measurement_config()
    m = tres.measure_schedule(schedule, engine, cfg=cfg, ssl=ssl,
                              train=train_cfg, rounds=4, clients=clients,
                              device="cpu")
    assert len(m["stages"]) == (1 if schedule == "e2e" else 4)
    for st in m["stages"]:
        ratio = st["flops_per_sample"] / st["analytic_flops_per_sample"]
        assert 1.0 <= ratio <= 1.0 + tres.FLOPS_RTOL, st
        assert st["peak_memory"] is None
    assert abs(m["flops_total"] / m["analytic_flops_total"] - 1.0) \
        <= tres.FLOPS_RTOL


def test_counted_flops_against_reference_xla_count():
    """The same signatures at the reference test's config (2 layers, batch
    4): XLA's ``cost_analysis`` also counts elementwise work (norms,
    softmax, the optimizer), which the counter does not, so the port's
    count sits below XLA's; found 0.890 and 0.914 of it on LW-FedSSL's two
    stages. Held to [0.85, 1.0]."""
    jc, js, jt = jres.measurement_config(num_layers=2, batch_size=4)
    tc, ts, tt = tres.measurement_config(num_layers=2, batch_size=4)
    want = jres.measure_schedule("lw_fedssl", "sequential", cfg=jc, ssl=js,
                                 train=jt, rounds=4, compile_memory=False)
    got = tres.measure_schedule("lw_fedssl", "sequential", cfg=tc, ssl=ts,
                                train=tt, rounds=4, device="cpu")
    assert len(got["stages"]) == len(want["stages"]) == 2
    for g, w in zip(got["stages"], want["stages"]):
        assert g["analytic_flops_per_sample"] == w["analytic_flops_per_sample"]
        assert g["analytic_memory_bytes"] == w["analytic_memory_bytes"]
        assert 0.85 <= g["flops_per_sample"] / w["flops_per_sample"] <= 1.0


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_flop_counts()["Global"]


@pytest.mark.parametrize("causal", [False, True])
def test_attention_is_counted_by_its_formula(causal):
    """One count, by formula, on the CPU: the plain version's products
    (which the counter would see) are not counted."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 65, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 65, 2, 16, generator=g)
    v = torch.randn(2, 65, 2, 16, generator=g)
    fwd = _count(lambda: ops.flash_attention(q, k, v, causal=causal))
    want = 4 * 2 * 4 * 65 * 65 * 16 // (2 if causal else 1)
    assert ops.attention_flops(q.shape, k.shape, causal) == want
    assert fwd == {torch.ops.repro_torch.attention_fwd: want}
    out = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=causal))
    # the backward is plain PyTorch on every device, counted by its ops
    both = _count(lambda: ops.flash_attention(q, k, v, causal=causal)
                  .sum().backward())
    assert both[torch.ops.repro_torch.attention_fwd] == want
    assert set(both) == {torch.ops.repro_torch.attention_fwd,
                         torch.ops.aten.bmm}


def test_info_nce_is_counted_by_its_formula():
    g = torch.Generator().manual_seed(0)
    q = torch.nn.functional.normalize(torch.randn(3, 8, 32, generator=g),
                                      dim=-1).requires_grad_()
    k = torch.nn.functional.normalize(torch.randn(3, 8, 32, generator=g),
                                      dim=-1).requires_grad_()
    got = _count(lambda: ops.info_nce_rows(q, k, 0.2).sum().backward())
    one = 2 * 3 * 8 * 8 * 32
    assert ops.info_nce_flops(q.shape, k.shape) == one
    assert got == {torch.ops.repro_torch.info_nce_fwd: one,
                   torch.ops.repro_torch.info_nce_bwd: 2 * 2 * one}


def test_ssd_scan_is_counted_by_its_formula():
    g = torch.Generator().manual_seed(0)
    B, S, H, P, N, Q = 1, 32, 2, 8, 4, 16
    xh = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g)
    a = -torch.rand(B, S, H, generator=g)
    Bm, Cm = (torch.randn(B, S, N, generator=g) for _ in range(2))
    got = _count(lambda: ops.ssd_scan(xh, dt, a, Bm, Cm, chunk=Q))
    want = B * (2 * S * Q * N + 2 * S * Q * H * P + 4 * S * N * H * P)
    assert got == {torch.ops.repro_torch.ssd_scan_fwd: want}


def test_counting_under_vmap_folds_the_client_axis():
    """The vmap rules hand the kernel-backed ops the client axis folded in:
    one count of the folded call."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 2, 65, 4, 16, generator=g)
    got = _count(lambda: torch.func.vmap(
        lambda t: ops.flash_attention(t, t, t, causal=False))(q))
    assert got == {torch.ops.repro_torch.attention_fwd:
                   ops.attention_flops((6, 65, 4, 16), (6, 65, 4, 16),
                                       False)}


def test_no_dispatch_mode_calls_the_bodies_directly(monkeypatch):
    """Without a counter the ops do not go through the dispatcher."""
    calls = []
    monkeypatch.setattr(ops, "_attention_op",
                        lambda *a: calls.append(a) or None)
    q = torch.randn(1, 4, 1, 8)
    ops.flash_attention(q, q, q)
    assert calls == []
    with FlopCounterMode(display=False):
        ops.flash_attention(q, q, q)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------
def test_device_memory_snapshot_cpu():
    snap = tres.device_memory_snapshot("cpu")
    assert snap["source"] == "rss" and snap["bytes_in_use"] > 0
    assert snap["peak_bytes"] >= snap["bytes_in_use"]
    assert set(tres.memory_span_attrs("cpu")) == {
        "mem.source", "mem.bytes_in_use", "mem.peak_bytes"}


def test_structure_ignores_mem_attrs():
    tracers = []
    for peak in (111, 222):
        t = Tracer()
        with t.span("round", cat="fl", round=0) as sp:
            sp.set(loss=1.0)
            sp.set(**{"mem.source": "rss", "mem.bytes_in_use": peak,
                      "mem.peak_bytes": peak})
        tracers.append(t)
    assert tracers[0].structure() == tracers[1].structure()
    assert tracers[0].events[0]["args"]["mem.peak_bytes"] == 111


def test_memory_model_follows_the_plan():
    """The eager engines' model: at full width and batch 256 the
    activations dominate, so one trained block holds far less than
    twelve. Neither engine's backward keeps a term of its own (both take
    one ``torch.autograd.grad``): the vmap engine's peak is the shared
    held bytes plus C times the sequential engine's per-client term."""
    cfg, ssl, train_cfg = tres.full_width_config()
    plans = {p.stage: p for p in tsched.build_schedule(
        tbase.FLConfig(rounds=12, schedule="layerwise"), 12)}
    e2e = tsched.build_schedule(tbase.FLConfig(rounds=12, schedule="e2e"),
                                12)[0]
    one = tres.program_memory_analytic(cfg, ssl, train_cfg, plans[1],
                                       "sequential")
    full = tres.program_memory_analytic(cfg, ssl, train_cfg, e2e,
                                        "sequential")
    assert one["peak_bytes"] < 0.5 * full["peak_bytes"]
    assert one["activation_bytes"] * 5 < full["activation_bytes"]
    per_client = full["peak_bytes"] - full["held_bytes"]
    for C in (1, 2, 4):
        v = tres.program_memory_analytic(cfg, ssl, train_cfg, e2e, "vmap",
                                         clients=C)
        # no backward term: the model holds what it held before one
        assert set(v) == set(full) == {"held_bytes", "activation_bytes",
                                       "update_bytes", "peak_bytes"}
        assert v["activation_bytes"] == C * full["activation_bytes"]
        assert v["update_bytes"] == C * full["update_bytes"]
        assert v["peak_bytes"] == v["held_bytes"] + C * per_client
    v1 = tres.program_memory_analytic(cfg, ssl, train_cfg, e2e, "vmap")
    assert v1["peak_bytes"] == full["peak_bytes"]


# ---------------------------------------------------------------------------
# measure_resources through the driver and the launcher
# ---------------------------------------------------------------------------
CFG = tbase.ModelConfig("t-vit", "dense", 2, 32, 2, 2, 64, 0, causal=False,
                        compute_dtype="float32", act="gelu")
SSLC = tbase.SSLConfig(proj_hidden=32, pred_hidden=32, proj_dim=16)


def _run(engine, obs):
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(96, 32, 32, 3, generator=gen)
    fl = tbase.FLConfig(num_clients=3, rounds=3, local_epochs=1,
                        schedule="lw_fedssl", server_epochs=1)
    return run_fedssl(CFG, SSLC, fl, tbase.TrainConfig(batch_size=16),
                      images=images, client_indices=iid_partition(96, 3),
                      aux_images=images[:16], device="cpu", engine=engine,
                      obs=obs)


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_measure_resources_is_bit_identical(engine):
    s0, h0 = _run(engine, None)
    obs = tobs.make_obs(trace=True, measure_resources=True)
    s1, h1 = _run(engine, obs)
    assert h1.loss == h0.loss and h1.to_dict() == h0.to_dict()
    f0 = convert.flatten_tree(convert.state_to_numpy(s0))
    f1 = convert.flatten_tree(convert.state_to_numpy(s1))
    for k in f0:
        assert np.array_equal(f0[k], f1[k]), k
    rounds = sorted((e for e in obs.tracer.events if e["name"] == "round"),
                    key=lambda e: e["seq"])
    plans = tsched.build_schedule(tbase.FLConfig(rounds=3,
                                                 schedule="lw_fedssl"), 2)
    costs = tcc.vit_costs(CFG, SSLC)
    for e, p in zip(rounds, plans):
        assert ("res.flops" in e["args"]) == p.new_stage
        assert e["args"]["mem.source"] == "rss"
        if p.new_stage:
            per = e["args"]["res.flops_per_sample"]
            want = e["args"]["res.flops"] / (16 * (3 if engine == "vmap"
                                                   else 1))
            assert per == want
            assert abs(per / tcc.flops_per_sample_round(costs, p) - 1) \
                <= tres.FLOPS_RTOL
    measures = [e for e in obs.tracer.events
                if e["name"] == "resources.measure"]
    assert [e["args"]["stage"] for e in measures] == [1, 2]
    # without tracing, nothing records and nothing is counted onto spans
    assert tobs.make_obs(measure_resources=True).tracer.events == []


def test_cli_measure_resources(tmp_path, capsys):
    train.main(["--device", "cpu", "--rounds", "2", "--clients", "2",
                "--batch", "16", "--samples", "64", "--layers", "2",
                "--d-model", "32", "--measure-resources", "--trace",
                "--obs-dir", str(tmp_path)])
    capsys.readouterr()
    _, events = tobs.read_jsonl(tmp_path / "run_trace.jsonl")
    rounds = ttrace.round_spans(events)
    assert "res.flops" in rounds[0]["args"]
    assert all("mem.peak_bytes" in e["args"] for e in rounds)
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--mode", "lm", "--arch",
                    "zamba2-2.7b", "--measure-resources"])
