"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``).

- The copied modules: the same tracer events, metrics and health signals
  give the same exports and alerts in both packages.
- Tracing never changes training: absent, ``NOOP_OBS`` and fully on give
  byte-identical trained state on both engines and two wires.
- The span structure of a traced run equals the reference's on the tiny
  configuration of ``tests/test_obs.py``, with the reference's draws
  replayed (``_torch_replay.JaxReplayDraws``): names, nesting, order and
  every integer and string attribute; float attributes (losses, rates)
  within the loss tolerance of ``tests/test_torch_fl.py``. What the port
  has no counterpart of is left out by name: the ``programs`` attribute of
  ``engine.dispatch`` and the ``jit.*`` metrics (XLA programs), the
  reference's ``mem.*`` round attributes (its resources module, not
  ported), and on the vmap engine the transport's ``wire.upload`` spans,
  which the reference's vmap round runs inside one XLA program.
- The launcher: every artifact on the CPU, read by the reference's trace
  analyser; the profiler trace; halting on a fatal alert.
"""
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import schemas
from repro import obs as jobs
from repro.configs import base as jbase
from repro.core import ssl as jssl
from repro.data import iid_partition, synthetic_images
from repro.data.synthetic import synthetic_tokens
from repro.federated.driver import run_fedssl as jax_run_fedssl
from repro.launch import trace as trace_cli
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.obs import health as jhealth
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.federated import client as client_mod
from repro_torch.federated.driver import run_fedssl, run_lm_fedssl
from repro_torch.launch import train
from repro_torch.obs import health as thealth

from _torch_replay import JaxReplayDraws

torch.set_num_threads(2)

# tests/test_obs.py's configuration
MODEL = ("t-vit", "dense", 2, 32, 2, 2, 64, 0)
MODEL_KW = dict(causal=False, compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=32, pred_hidden=32, proj_dim=16)
TRAIN = dict(batch_size=16, base_lr=1.5e-4)
SAMPLES, CLIENTS, ROUNDS = 96, 3, 2
# tests/test_torch_fl.py's loss tolerance: the same math on the same draws,
# summed in another order
LOSS_RTOL = 1e-4
# no counterpart in the port (module docstring)
SKIP_ATTRS = {"engine.dispatch": {"programs"}}
VMAP_PORT_ONLY = {"wire.upload", "wire.upload.client"}


def _configs(mod, schedule="lw_fedssl", rounds=ROUNDS):
    fl = mod.FLConfig(num_clients=CLIENTS, rounds=rounds, local_epochs=1,
                      schedule=schedule, server_epochs=1)
    return (mod.ModelConfig(*MODEL, **MODEL_KW), mod.SSLConfig(**SSL), fl,
            mod.TrainConfig(**TRAIN))


def _data(seed=0):
    key = jax.random.PRNGKey(seed)
    imgs, _ = synthetic_images(key, SAMPLES, 10, 32)
    return key, np.asarray(imgs), iid_partition(SAMPLES, CLIENTS)


def _port_run(engine="sequential", codec="fp32", obs=None, rounds=ROUNDS):
    key, imgs, idx = _data()
    jenc = jssl.make_vit_encoder(_configs(jbase)[0])
    return run_fedssl(*_configs(tbase, rounds=rounds), images=imgs,
                      client_indices=idx, aux_images=imgs[:16],
                      draws=JaxReplayDraws(key, jenc), device="cpu",
                      engine=engine, codec=codec, obs=obs)


def _jax_run(engine="sequential", obs=None):
    key, imgs, idx = _data()
    return jax_run_fedssl(*_configs(jbase), images=imgs,
                          client_indices=[jnp.asarray(i) for i in idx],
                          aux_images=imgs[:16], key=key, engine=engine,
                          obs=obs)


# ---------------------------------------------------------------------------
# the copied modules
# ---------------------------------------------------------------------------
class _Clock:
    """A deterministic clock: each reading is 1.25 ms after the last."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.25e-3
        return self.t


def _script(pkg):
    """The same events, metrics and alerts through one package's obs."""
    obs = pkg.make_obs(trace=True, metrics=True, health=True,
                       clock=_Clock(), run="r1", seed=3)
    t, met = obs.tracer, obs.metrics
    with t.span("run", cat="fl", mode="fedssl", sim=None):
        for r in range(3):
            with t.span("round", cat="fl", round=r, stage=r + 1) as sp:
                t.instant("stage_transition", cat="fl", stage=r + 1)
                with t.span("wire.upload.client", cat="transport",
                            client="c7", codec="int8"):
                    pass
                t.virtual_span("client.round", "client 2", 0.5 * r, 0.25,
                               client=2, dropped=r == 1)
                sp.set(loss=1.5 / (r + 1), wire_upload_bytes=1000 * r)
            met.counter("fl.rounds").inc()
            met.counter("wire.upload_bytes").inc(1000 * r)
            met.gauge("wire.compression_ratio").set(3.75 + r)
            met.histogram("round.loss").observe(1.5 / (r + 1))
            obs.health.observe_round(r, loss=[2.0, float("nan"), 1.0][r],
                                     compression_ratio=4.0 - 2 * r,
                                     new_stage=r == 0)
    met.histogram("never.observed")
    return obs


def test_copied_exports_match_reference(tmp_path):
    port, ref = _script(tobs), _script(jobs)
    assert port.tracer.events == ref.tracer.events
    assert port.tracer.structure() == ref.tracer.structure()
    assert tobs.chrome_trace_doc(port.tracer, x=1) == \
        jobs.chrome_trace_doc(ref.tracer, x=1)
    assert tobs.metrics_csv_text(port.metrics) == \
        jobs.metrics_csv_text(ref.metrics)
    assert port.health.report() == ref.health.report()
    for name, obs in (("port", port), ("ref", ref)):
        obs.export(trace_jsonl=tmp_path / name / "t.jsonl",
                   chrome_trace=tmp_path / name / "t.chrome.json",
                   metrics_csv=tmp_path / name / "m.csv",
                   health_json=tmp_path / name / "h.json", run="x")
    for f in ("t.jsonl", "t.chrome.json", "m.csv", "h.json"):
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "ref" / f).read_text(), f
    # each package reads the other's JSONL
    assert tobs.read_jsonl(tmp_path / "ref" / "t.jsonl") == \
        jobs.read_jsonl(tmp_path / "port" / "t.jsonl")
    doc = json.loads((tmp_path / "port" / "t.chrome.json").read_text())
    assert schemas.validate_chrome_trace(doc) == []
    assert schemas.validate_metrics_csv(
        (tmp_path / "port" / "m.csv").read_text()) == []
    assert schemas.validate_health_report(
        json.loads((tmp_path / "port" / "h.json").read_text())) == []


def test_round_line_and_console_match_reference():
    import io
    for args, kw in (((0, 12, 1, 5.1234), dict(lr=1.5e-4, down_mb=0.5,
                                               up_mb=0.25, wire_mb=0.75)),
                     ((2, 4, 2, 1.0), {}),
                     ((3, 4, 2, float("nan")), dict(wire_mb=2.0,
                                                    extra=" eps 1"))):
        assert tobs.format_round_line(*args, **kw) == \
            jobs.format_round_line(*args, **kw)
    bufs = []
    for pkg in (tobs, jobs):
        buf = io.StringIO()
        with pkg.ConsoleRenderer(live=True, stream=buf) as r:
            r("round 1 long line")
            r("round 2")
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]


HEALTH_CASES = {
    # a stable stage, then a spike
    "spike": dict(loss=[5.0, 5.1, 4.9, 5.0, 5.05, 4.95, 5.0, 9.0],
                  ratio=[4.0] * 8),
    # a non-finite loss is fatal; halting is armed
    "nonfinite": dict(loss=[3.0, 2.9, float("inf"), 2.8],
                      ratio=[4.0] * 4, halt=True),
    # compression drift inside a stage, reset by a new stage
    "drift": dict(loss=[1.0] * 6, ratio=[4.0, 4.1, 6.0, 2.0, 2.0, 2.0],
                  new_stage=[0, 3]),
    # straggler drops and recompiles (the port's drivers pass 0 recompiles)
    "drops": dict(loss=[1.0] * 8, ratio=[None] * 8,
                  dropped=[3, 2, 3, 2, 3, 2, 3, 2], recompiles=[0, 0, 2, 0,
                                                                0, 0, 1, 0]),
}


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_health_monitor_matches_reference(case):
    c = HEALTH_CASES[case]
    mons = [m.HealthMonitor(halt_on_fatal=c.get("halt", False))
            for m in (thealth, jhealth)]
    n = len(c["loss"])
    for r in range(n):
        kw = dict(loss=c["loss"][r], compression_ratio=c["ratio"][r],
                  dropped=c.get("dropped", [0] * n)[r], participants=4,
                  recompiles=c.get("recompiles", [0] * n)[r],
                  new_stage=r in c.get("new_stage", [0]))
        got, want = (m.observe_round(r, **kw) for m in mons)
        assert [a.to_dict() for a in got] == [a.to_dict() for a in want]
        assert mons[0].should_halt == mons[1].should_halt
    assert mons[0].report() == mons[1].report()
    assert mons[0].alerts, "the case raises no alert"


def test_make_obs_and_noop_surfaces():
    assert not tobs.NOOP_OBS.enabled and not tobs.make_obs().enabled
    for kw in (dict(trace=True), dict(metrics=True), dict(health=True),
               dict(halt_on_unhealthy=True), dict(profile_dir="p")):
        assert tobs.make_obs(**kw).enabled, kw
    assert tobs.make_obs(halt_on_unhealthy=True).health.halt_on_fatal
    assert tobs.NOOP_OBS.tracer.events == []
    assert tobs.NOOP_OBS.export(trace_jsonl="never.jsonl") == {}
    assert tobs.NOOP_OBS.stop_profiler() is None
    with pytest.raises(NotImplementedError, match="not ported"):
        tobs.make_obs(measure_resources=True)


# ---------------------------------------------------------------------------
# tracing never changes training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["fp32", "int8"])
@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_observability_is_bit_identical(engine, codec, tmp_path):
    runs = [_port_run(engine, codec, obs=o) for o in (
        None, tobs.NOOP_OBS,
        tobs.make_obs(trace=True, metrics=True, health=True,
                      profile_dir=str(tmp_path)))]
    (s0, h0), *rest = runs
    flat0 = convert.flatten_tree(convert.state_to_numpy(s0))
    for s, h in rest:
        assert h.loss == h0.loss
        assert h.to_dict() == h0.to_dict()
        flat = convert.flatten_tree(convert.state_to_numpy(s))
        assert list(flat) == list(flat0)
        for k in flat0:
            assert np.array_equal(flat[k], flat0[k]), k
    assert (tmp_path / tobs.core.PROFILE_TRACE).exists()


# ---------------------------------------------------------------------------
# span structure and metrics against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["sequential", "vmap"])
def traced_pair(request):
    engine = request.param
    jo = jobs.make_obs(trace=True, metrics=True, health=True)
    _, jhist = _jax_run(engine, obs=jo)
    to = tobs.make_obs(trace=True, metrics=True, health=True)
    _, hist = _port_run(engine, obs=to)
    return engine, jo, jhist, to, hist


def _normalise(events, drop=()):
    """(name, ph, cat, depth, parent's name, args) in open order, without
    the spans named in ``drop`` (leaves and their children only, so the
    depths of the rest hold) and without the attributes the port has no
    counterpart of."""
    by_seq = {e["seq"]: e for e in events}
    out = []
    for e in sorted(events, key=lambda e: e["seq"]):
        if e["name"] in drop:
            continue
        skip = SKIP_ATTRS.get(e["name"], set())
        args = {k: v for k, v in e["args"].items()
                if k not in skip and not k.startswith("mem.")}
        parent = by_seq[e["parent"]]["name"] if e["parent"] is not None \
            else None
        out.append((e["name"], e["ph"], e["cat"], e["depth"], parent, args))
    return out


def test_span_structure_matches_reference(traced_pair):
    engine, jo, _, to, _ = traced_pair
    drop = VMAP_PORT_ONLY if engine == "vmap" else ()
    got = _normalise(to.tracer.events, drop)
    want = _normalise(jo.tracer.events)
    assert [g[:5] for g in got] == [w[:5] for w in want]
    for g, w in zip(got, want):
        assert g[5].keys() == w[5].keys(), (g[0], g[5], w[5])
        for k, v in w[5].items():
            if isinstance(v, float) and not isinstance(g[5][k], bool):
                np.testing.assert_allclose(g[5][k], v, rtol=LOSS_RTOL,
                                           err_msg=f"{g[0]}.{k}")
            else:
                assert g[5][k] == v and type(g[5][k]) is type(v), \
                    (g[0], k, g[5][k], v)
    names = {g[0] for g in got}
    assert {"run", "round", "download", "local_train", "calibrate",
            "wire.download", "stage_transition"} <= names
    assert ({"client.train", "aggregate", "wire.upload"} if
            engine == "sequential" else {"engine.dispatch"}) <= names
    if engine == "vmap":
        # the port's vmap round runs the transport's upload path
        wires = [e for e in to.tracer.events if e["name"] == "wire.upload"]
        assert len(wires) == ROUNDS


def test_metrics_agree_with_history_and_reference(traced_pair):
    _, jo, jhist, to, hist = traced_pair
    got, want = to.metrics.to_dict(), jo.metrics.to_dict()
    c = got["counters"]
    assert c["fl.rounds"] == len(hist.loss) == ROUNDS
    assert c["comm.download_bytes"] == sum(hist.download_bytes)
    assert c["comm.upload_bytes"] == sum(hist.upload_bytes)
    assert c["wire.download_bytes"] == sum(hist.wire_download_bytes)
    assert c["wire.upload_bytes"] == sum(hist.wire_upload_bytes)
    assert c == {k: v for k, v in want["counters"].items()
                 if not k.startswith("jit.")}
    assert {k for k in got["gauges"]} == \
        {k for k in want["gauges"] if not k.startswith("jit.")}
    np.testing.assert_allclose(got["gauges"]["wire.compression_ratio"],
                               hist.compression_ratio, rtol=0)
    assert got["gauges"]["wire.compression_ratio"] == \
        want["gauges"]["wire.compression_ratio"]
    assert got["histograms"].keys() == want["histograms"].keys()
    loss = got["histograms"]["round.loss"]
    assert loss["count"] == ROUNDS
    assert loss["sum"] == pytest.approx(sum(hist.loss), rel=1e-12)
    np.testing.assert_allclose(loss["sum"],
                               want["histograms"]["round.loss"]["sum"],
                               rtol=LOSS_RTOL)
    assert got["histograms"]["round.host_seconds"]["count"] == ROUNDS
    # round spans carry the history's bytes, and no alert fired
    rounds = [e for e in to.tracer.events if e["name"] == "round"]
    for r, e in enumerate(sorted(rounds, key=lambda e: e["seq"])):
        assert e["args"]["wire_upload_bytes"] == hist.wire_upload_bytes[r]
        assert e["args"]["download_bytes"] == hist.download_bytes[r]
    assert to.health.alerts == [] and jo.health.alerts == []
    assert to.health.rounds_observed == ROUNDS


# ---------------------------------------------------------------------------
# the LM loop
# ---------------------------------------------------------------------------
LM_ARCH, LM_ROUNDS, LM_CLIENTS, LM_BATCH, LM_SAMPLES, LM_SEQ = \
    "zamba2-2.7b", 2, 2, 4, 8, 32


def test_lm_trace_matches_reference_span_names(tmp_path):
    """The reference's ``train_lm`` traced through its own CLI (with the
    arch smoke override the port's launcher applies) and the port's
    ``run_lm_fedssl`` on the same tokens and parameters: the same span
    names in the same order, the same integer attributes."""
    over = train.LM_ARCHS[LM_ARCH]
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "reduced",
               lambda cfg, **kw: jbase.reduced(cfg, **{**over, **kw}))
    mp.setattr(sys, "argv", [
        "train", "--mode", "lm", "--arch", LM_ARCH, "--rounds",
        str(LM_ROUNDS), "--clients", str(LM_CLIENTS), "--batch",
        str(LM_BATCH), "--samples", str(LM_SAMPLES), "--seq-len",
        str(LM_SEQ), "--trace", "--metrics", "--obs-dir",
        str(tmp_path / "ref")])
    try:
        jtrain.main()
    finally:
        mp.undo()
    _, want = jobs.read_jsonl(tmp_path / "ref" / "run_trace.jsonl")
    cfg = jbase.reduced(jbase.load_arch(LM_ARCH), **over)
    kd, ki, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    toks, labs = synthetic_tokens(kd, LM_SAMPLES, LM_SEQ, cfg.vocab_size)
    init = convert.from_numpy_tree(jax.device_get(jlm.init_lm(ki, cfg)))
    fl = tbase.FLConfig(num_clients=LM_CLIENTS, rounds=LM_ROUNDS,
                        local_epochs=1, schedule="lw_fedssl")
    obs = tobs.make_obs(trace=True, metrics=True, health=True)
    _, hist = run_lm_fedssl(
        tbase.reduced(tbase.load_arch(LM_ARCH), **over), fl,
        tbase.TrainConfig(batch_size=LM_BATCH, base_lr=3e-4),
        tokens=np.asarray(toks), labels=np.asarray(labs),
        shards=iid_partition(LM_SAMPLES, LM_CLIENTS, seed=0), params=init,
        device="cpu", obs=obs)
    got = _normalise(obs.tracer.events)
    want = _normalise(want)
    assert [g[:5] for g in got] == [w[:5] for w in want]
    for g, w in zip(got, want):
        assert g[5].keys() == w[5].keys(), (g[0], g[5], w[5])
        for k, v in w[5].items():
            if isinstance(v, (int, str)) or v is None:
                assert g[5][k] == v, (g[0], k)
    rounds = [g for g in got if g[0] == "round"]
    np.testing.assert_allclose([r[5]["loss"] for r in rounds], hist.loss,
                               rtol=0)
    assert obs.metrics.to_dict()["counters"]["wire.upload_bytes"] == \
        sum(hist.wire_upload_bytes)
    assert obs.health.rounds_observed == LM_ROUNDS


# ---------------------------------------------------------------------------
# the launcher, --device cpu
# ---------------------------------------------------------------------------
CLI = ["--mode", "vit", "--device", "cpu", "--clients", "2", "--batch", "8",
       "--samples", "64", "--layers", "2", "--d-model", "32"]


def test_cli_writes_every_artifact(tmp_path, capsys):
    out = tmp_path / "obs"
    train.main(CLI + ["--rounds", "2", "--codec", "int8", "--trace",
                      "--metrics", "--health", "--obs-dir", str(out)])
    printed = capsys.readouterr().out
    for f in ("run_trace.jsonl", "run_trace.chrome.json", "run_metrics.csv",
              "run_history.json", "health.json"):
        assert (out / f).exists() and f"-> {out / f}" in printed, f
    header, events = jobs.read_jsonl(out / "run_trace.jsonl")
    assert header["mode"] == "vit" and header["codec"] == "int8"
    assert schemas.validate_chrome_trace(
        json.loads((out / "run_trace.chrome.json").read_text())) == []
    assert schemas.validate_metrics_csv(
        (out / "run_metrics.csv").read_text()) == []
    health = json.loads((out / "health.json").read_text())
    assert schemas.validate_health_report(health) == []
    assert health["rounds_observed"] == 2 and not health["fatal"]
    hist = json.loads((out / "run_history.json").read_text())
    # the reference's analyser reads the port's trace
    totals = trace_cli.comm_totals(events)
    assert totals["wire_upload_bytes"] == \
        sum(hist["fields"]["wire_upload_bytes"])
    assert totals["download_bytes"] == sum(hist["fields"]["download_bytes"])
    trace_cli.main([str(out / "run_trace.jsonl")])
    assert "local_train" in capsys.readouterr().out


def test_cli_profile_dir_writes_a_torch_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    train.main(CLI + ["--rounds", "1", "--layers", "1",
                      "--profile-dir", str(prof),
                      "--obs-dir", str(tmp_path / "obs")])
    doc = json.loads((prof / tobs.core.PROFILE_TRACE).read_text())
    assert doc["traceEvents"] and any(
        e.get("cat") == "cpu_op" for e in doc["traceEvents"])
    assert "round 1/1" in capsys.readouterr().out


def test_cli_halts_on_a_fatal_alert(tmp_path, monkeypatch, capsys):
    """From the third client update on (round 2 of 4) every loss is NaN:
    the monitor raises a fatal alert and the run stops after round 2."""
    calls = []
    real = client_mod.local_train

    def nan_after_round_1(*a, **k):
        online, m = real(*a, **k)
        calls.append(1)
        return online, ({**m, "loss": torch.tensor(math.nan)}
                        if len(calls) > 2 else m)

    monkeypatch.setattr(client_mod, "local_train", nan_after_round_1)
    out = tmp_path / "obs"
    train.main(CLI + ["--rounds", "4", "--halt-on-unhealthy", "--trace",
                      "--obs-dir", str(out)])
    printed = capsys.readouterr().out
    assert "halting after round 2/4" in printed
    assert "round 3/4" not in printed
    _, events = jobs.read_jsonl(out / "run_trace.jsonl")
    names = [e["name"] for e in events]
    assert names.count("round") == 2
    assert "health.loss_nonfinite" in names and "health.halt" in names
    health = json.loads((out / "health.json").read_text())
    assert health["halted"] and health["counts"]["loss_nonfinite"] == 1
