"""The port's fleet simulator (``repro_torch.federated.{fleet,simulation}``)
against the JAX package's.

- Host-side parity, exact: the fleet copy draws what
  ``repro.federated.fleet`` draws; pricing, staleness weights and every
  policy's decisions equal the reference's on the same costs.
- Client sampling with overcommit: ``overcommit=1`` draws what it always
  drew; the replayed draws sample the reference's overcommitted cohort.
- The engines' ``collect=True``: FedAvg over the collected trees is the
  engine's own aggregate.
- Driver parity on the reference test's configuration
  (``tests/test_simulation.py``: a 2-block fp32 ViT, 4 clients, 3 a round,
  4 rounds), the reference's draws replayed
  (``_torch_replay.JaxReplayDraws``): ``sim.records`` and the simulator's
  history fields equal, losses within ``tests/test_torch_fl.py``'s
  tolerance, for every policy x {mobile-mix, pareto-stragglers}. The
  reference's failing case (``test_policy_matrix[pareto-stragglers-
  buffered-async]``) is compared record for record, and held to the
  invariants its records meet, not to the one they break.
- Synchronous over a uniform fleet is bit-identical to no simulator on
  both engines; the launcher's fleet flags.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.federated import driver as jdriver
from repro.federated import fleet as jfleet
from repro.federated import server as jserver
from repro.federated import simulation as jsim
from repro.core import ssl as jssl
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import schedule as tsched
from repro_torch.federated import fleet as tfleet
from repro_torch.federated import server as tserver
from repro_torch.federated import simulation as tsim
from repro_torch.federated.draws import TorchDraws
from repro_torch.federated.driver import run_fedssl
from repro_torch.launch import train

from _torch_replay import JaxReplayDraws

torch.set_num_threads(2)

# tests/test_simulation.py's configuration
MODEL = ("t-vit", "dense", 2, 32, 2, 2, 64, 0)
MODEL_KW = dict(causal=False, compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=32, pred_hidden=32, proj_dim=16)
N_CLIENTS, ROUNDS, CPR = 4, 4, 3
IMAGES = np.random.default_rng(0).normal(size=(64, 32, 32, 3)).astype(
    np.float32)
INDICES = [np.arange(i * 16, (i + 1) * 16) for i in range(N_CLIENTS)]
# tests/test_torch_fl.py's loss tolerance: the same math on the same draws,
# summed in another order
LOSS_RTOL = 1e-4
SIM_FIELDS = ("round_wall_clock", "device_seconds", "energy_joules",
              "dropped_clients", "participants")


def _configs(mod):
    fl = mod.FLConfig(num_clients=N_CLIENTS, rounds=ROUNDS, local_epochs=1,
                      clients_per_round=CPR, schedule="lw_fedssl")
    return (mod.ModelConfig(*MODEL, **MODEL_KW), mod.SSLConfig(**SSL), fl,
            mod.TrainConfig(batch_size=8))


def _record(rec):
    return dataclasses.asdict(rec)


# ---------------------------------------------------------------------------
# host-side parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("profile", tfleet.PROFILES)
@pytest.mark.parametrize("seed,n", [(0, 4), (3, 32), (17, 7)])
def test_fleet_copy_draws_what_the_reference_draws(profile, seed, n):
    got = tfleet.make_fleet(profile, n, seed)
    want = jfleet.make_fleet(profile, n, seed)
    assert got.draw_signature() == want.draw_signature()
    assert [dataclasses.astuple(d) for d in got.devices] == \
        [dataclasses.astuple(d) for d in want.devices]
    assert got.homogeneous == want.homogeneous


def test_pricing_and_staleness_weights_match_reference():
    for tcfg, jcfg in ((_configs(tbase)[0], _configs(jbase)[0]),
                       (tbase.load_arch("vit-tiny"),
                        jbase.load_arch("vit-tiny"))):
        layers = tcfg.num_layers
        for sched_name in ("lw_fedssl", "e2e", "progressive"):
            fl = tbase.FLConfig(rounds=2 * layers, schedule=sched_name)
            for p in tsched.build_schedule(fl, layers):
                kw = dict(batch=8, tokens=64, num_stages=layers)
                assert tsim.plan_step_flops(tcfg, p, **kw) == \
                    jsim.plan_step_flops(jcfg, p, **kw)
                assert tsim.plan_step_bytes(tcfg, p, num_stages=layers) == \
                    jsim.plan_step_bytes(jcfg, p, num_stages=layers)
    for profile in tfleet.PROFILES:
        for dt, dj in zip(tfleet.make_fleet(profile, 6, 1).devices,
                          jfleet.make_fleet(profile, 6, 1).devices):
            kw = dict(steps=3, step_flops=2.5e9, step_bytes=1e6,
                      down_bytes=10**6, up_bytes=3 * 10**5)
            assert dataclasses.astuple(tsim.price_client_round(dt, **kw)) \
                == dataclasses.astuple(jsim.price_client_round(dj, **kw))
    for counts, stale, alpha in (([16, 16, 16], [0, 1, 5], 0.5),
                                 ([8, 24], [0, 0], 1.3), ([3], [2], 0.0)):
        np.testing.assert_array_equal(
            tsim.staleness_weights(counts, stale, alpha),
            jsim.staleness_weights(counts, stale, alpha))


def _costs(mod, times, energy=1.0):
    return {c: mod.ClientRoundCost(0.1, t, 0.2, energy * (1 + c))
            for c, t in times.items()}


POLICY_CASES = [("synchronous", {}), ("deadline", {"deadline_s": 3.0,
                                                   "overcommit": 2.0}),
                ("deadline", {"quantile": 0.5}),
                ("buffered-async", {"buffer": 2})]


@pytest.mark.parametrize("policy,kw", POLICY_CASES)
def test_policy_decisions_match_reference(policy, kw):
    """The same costs and availability through both packages' policies,
    four rounds with a stage transition before the last: equal outcomes;
    the buffered flush's FedAvg within 1e-6 (torch against jnp)."""
    times = {0: 1.0, 1: 9.0, 2: 2.0, 3: 4.0, 4: 3.5}
    tp, jp = tsim.make_policy(policy, **kw), jsim.make_policy(policy, **kw)
    avail = {c: c != 3 for c in times}
    for r in range(4):
        if r == 3:
            tp.begin_stage()
            jp.begin_stage()
        cohort = [(r + i) % 5 for i in range(4)]
        tc, jc = _costs(tsim, times), _costs(jsim, times)
        to, jo = tp.resolve(r, cohort, tc, avail), jp.resolve(r, cohort, jc,
                                                             avail)
        assert _record(to) == _record(jo)
        if policy != "buffered-async":
            continue
        trees = [{"w": float(c + 1) * np.ones(3, np.float32)}
                 for c in to.train_ids]
        tagg, tfin = tp.complete(to, tc, [16, 8, 16, 32, 16],
                                 [{"w": torch.from_numpy(t["w"])}
                                  for t in trees])
        jagg, jfin = jp.complete(jo, jc, [16, 8, 16, 32, 16],
                                 [{"w": jnp.asarray(t["w"])} for t in trees])
        assert _record(tfin) == _record(jfin)
        np.testing.assert_allclose(tagg["w"].numpy(), np.asarray(jagg["w"]),
                                   rtol=1e-6)


def test_sample_clients_overcommit():
    draws = TorchDraws(0, "cpu")
    plain = TorchDraws(0, "cpu")
    for _ in range(3):
        assert tserver.sample_clients(draws, 10, 4, overcommit=1.0) == \
            tserver.sample_clients(plain, 10, 4)
    for oc in (1.5, 2.0, 4.0):
        got = tserver.sample_clients(TorchDraws(1, "cpu"), 10, 4,
                                     overcommit=oc)
        assert len(got) == min(10, math.ceil(4 * oc))
        assert len(set(got)) == len(got)
    assert tserver.sample_clients(TorchDraws(1, "cpu"), 5, 4,
                                  overcommit=2.0) == list(range(5))
    # the replayed draws sample the reference's overcommitted cohort
    jenc = jssl.make_vit_encoder(_configs(jbase)[0])
    key = jax.random.PRNGKey(42)
    for oc in (1.0, 1.5, 3.0):
        replay = JaxReplayDraws(key, jenc)
        got = tserver.sample_clients(replay, 10, 3, overcommit=oc)
        _, ks = jax.random.split(key)
        assert got == jserver.sample_clients(ks, 10, 3, overcommit=oc)


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_collect_returns_the_trees_fedavg_aggregates(engine):
    """``collect=True`` returns each participant's decoded upload; FedAvg
    over them is bit-identical to the engine's own aggregate."""
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.federated import aggregate
    from repro_torch.federated.engine import make_engine
    from repro_torch.federated.transport import Transport
    from repro_torch.optim import make_optimizer
    cfg, sslc, fl, tc = _configs(tbase)
    enc = ssl_mod.make_vit_encoder(cfg)
    images = torch.from_numpy(IMAGES)
    plan = tsched.build_schedule(fl, enc.num_stages)[0]
    outs = []
    for collect in (False, True):
        draws = TorchDraws(0, "cpu")
        state = draws.init_state(enc, sslc)
        eng = make_engine(engine, encoder=enc, ssl_cfg=sslc,
                          opt=make_optimizer(tc), fl=fl, images=images,
                          client_indices=[torch.from_numpy(i)
                                          for i in INDICES],
                          transport=Transport("int8"), draws=draws,
                          batch_size=tc.batch_size)
        parts = [0, 2, 3]
        plans = [draws.batch_plan(16, 1, 8) for _ in parts]
        genc = (convert.subtree(state["online"], "enc") if plan.align
                else None)
        outs.append(eng.run_round(state, plan, parts, plans, 1e-3, genc,
                                  server_online=state["online"],
                                  collect=collect))
    (agg, l0, s0), (trees, l1, s1) = outs
    assert l0 == l1 and s0 == s1 and len(trees) == 3
    fedavg = aggregate.fedavg(trees, aggregate.client_weights([16] * 3))
    for k in agg:
        assert torch.equal(agg[k], fedavg[k]), k


# ---------------------------------------------------------------------------
# driver parity on replayed draws
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_run(policy, profile):
    sim = jsim.make_sim(jfleet.make_fleet(profile, N_CLIENTS, seed=0),
                        policy, num_clients=N_CLIENTS, seed=0)
    _, hist = jdriver.run_fedssl(
        *_configs(jbase), images=jnp.asarray(IMAGES),
        client_indices=[jnp.asarray(i) for i in INDICES],
        key=jax.random.PRNGKey(0), sim=sim)
    return hist, sim


def _port_run(policy, profile, engine="sequential", replay=True):
    sim = None
    if policy is not None:
        sim = tsim.make_sim(tfleet.make_fleet(profile, N_CLIENTS, seed=0),
                            policy, num_clients=N_CLIENTS, seed=0)
    draws = (JaxReplayDraws(jax.random.PRNGKey(0),
                            jssl.make_vit_encoder(_configs(jbase)[0]))
             if replay else None)
    state, hist = run_fedssl(*_configs(tbase), images=IMAGES,
                             client_indices=INDICES, draws=draws,
                             device="cpu", engine=engine, sim=sim)
    return state, hist, sim


MATRIX = [(p, f) for p in tsim.POLICIES
          for f in ("mobile-mix", "pareto-stragglers")]


@pytest.mark.parametrize("policy,profile", MATRIX)
def test_records_match_reference(policy, profile):
    jhist, jsim_ = _jax_run(policy, profile)
    _, hist, sim = _port_run(policy, profile)
    assert [_record(r) for r in sim.records] == \
        [_record(r) for r in jsim_.records]
    for name in SIM_FIELDS:
        assert getattr(hist, name) == getattr(jhist, name), name
    for name in ("download_bytes", "upload_bytes", "wire_download_bytes",
                 "wire_upload_bytes", "round_stage"):
        assert getattr(hist, name) == getattr(jhist, name), name
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    assert hist.total_wall_clock == jhist.total_wall_clock
    assert hist.total_dropped == jhist.total_dropped


def test_reference_failing_case_invariants():
    """``tests/test_simulation.py::test_policy_matrix[pareto-stragglers-
    buffered-async]`` fails on the reference: a client whose stale update
    the stage transition discarded is reported dropped and, relaunched, is
    aggregated in the same round. The port's records are the reference's
    (``test_records_match_reference``), so the port's run meets every
    other invariant of that test and breaks that one the same way."""
    _, hist, sim = _port_run("buffered-async", "pareto-stragglers")
    rounds = len(hist.loss)
    assert all(np.isfinite(hist.loss))
    assert (len(hist.round_wall_clock) == len(hist.device_seconds)
            == len(hist.energy_joules) == len(hist.dropped_clients)
            == len(hist.participants) == rounds)
    assert hist.total_wall_clock > 0 and hist.total_energy > 0
    assert hist.total_device_seconds >= hist.total_wall_clock * 0.999
    overlaps = []
    for rec in sim.records:
        assert set(rec.train_ids) <= set(rec.cohort)
        if rec.weights:
            assert np.isclose(sum(rec.weights), 1.0)
        assert len(rec.cohort) <= N_CLIENTS
        overlaps.append(sorted(set(rec.dropped) & set(rec.aggregated)))
    _, jsim_ = _jax_run("buffered-async", "pareto-stragglers")
    assert overlaps == [sorted(set(r.dropped) & set(r.aggregated))
                        for r in jsim_.records]


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_sync_uniform_is_bit_identical_to_no_simulator(engine):
    s0, h0, _ = _port_run(None, None, engine, replay=False)
    s1, h1, sim = _port_run("synchronous", "uniform", engine, replay=False)
    assert h1.loss == h0.loss
    f0 = convert.flatten_tree(convert.state_to_numpy(s0))
    f1 = convert.flatten_tree(convert.state_to_numpy(s1))
    for k in f0:
        assert np.array_equal(f0[k], f1[k]), k
    assert h0.round_wall_clock == [] and h1.total_dropped == 0
    assert len(h1.round_wall_clock) == len(h1.loss) == len(sim.records)
    assert h1.total_device_seconds >= h1.total_wall_clock > 0
    assert h1.wall_clock_to_loss(min(h1.loss)) <= h1.total_wall_clock
    assert h1.wall_clock_to_loss(-1e9) is None


def test_simulated_rounds_agree_across_engines():
    _, hs, ss = _port_run("deadline", "mobile-mix", "sequential",
                          replay=False)
    _, hv, sv = _port_run("deadline", "mobile-mix", "vmap", replay=False)
    assert ss.records == sv.records
    assert hs.participants == hv.participants
    np.testing.assert_allclose(hs.loss, hv.loss, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the launcher's fleet flags
# ---------------------------------------------------------------------------
ARGS = ["--device", "cpu", "--rounds", "2", "--clients", "4", "--batch",
        "8", "--samples", "64", "--layers", "2", "--d-model", "32"]


@pytest.mark.parametrize("policy,extra", [
    ("deadline", ["--overcommit", "2.0", "--deadline-s", "0.5"]),
    ("buffered-async", ["--async-buffer", "1", "--staleness-alpha", "1.0"])])
def test_cli_fleet_flags(policy, extra, capsys):
    train.main(ARGS + ["--fleet", "pareto-stragglers", "--round-policy",
                       policy, "--clients-per-round", "2"] + extra)
    out = capsys.readouterr().out
    assert f"simulated fleet 'pareto-stragglers' / policy '{policy}'" in out
    assert " sim " in out and "dropped client-rounds" in out


def test_cli_fleet_refusals(capsys):
    with pytest.raises(SystemExit, match="--round-policy needs --fleet"):
        train.main(ARGS + ["--round-policy", "deadline"])
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--mode", "lm", "--arch",
                    "zamba2-2.7b", "--fleet", "uniform"])
    assert e.value.code == 2 and "use --mode vit" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        train.main(ARGS + ["--fleet", "datacenter"])
    assert e.value.code == 2
