"""Privacy parity: ``repro_torch.privacy`` and the drivers' DP and secure
aggregation against ``repro.privacy`` and the reference's drivers, on the
same seeded inputs, on the CPU.

Tolerances:
- accountant: equal (the same code on the same floats);
- clip: clipped payloads within atol 1e-6 of ``clip_jax`` and
  ``clip_host``, scales within rel 1e-6 (the norm is summed in another
  order); the clips are set far from the updates' norms, since only a tie
  within an ulp of the norm could flip ``scale < 1``; pass-through is
  bit-identical;
- secure aggregation: masked = unmasked = the reference's unmasked
  fixed-point sum, to the bit; in the drivers, the fixed-point sum within
  n·2^-40 of the exact (float64) FedAvg of the same decoded uploads;
- DP driver runs on replayed draws: losses within rtol 1e-4, parameters
  within rtol 1e-4 and atol 2e-5 (``tests/test_torch_fl.py``), epsilon
  and clip fraction equal.
"""
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import ssl as jssl
from repro.data import iid_partition
from repro.data.synthetic import synthetic_tokens
from repro.federated.driver import run_fedssl as jax_run_fedssl
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro import privacy as jprivacy
from repro_torch import convert, privacy as tprivacy
from repro_torch.configs import base as tbase
from repro_torch.core import schedule as tsched
from repro_torch.federated import aggregate, simulation
from repro_torch.federated.draws import TorchDraws
from repro_torch.federated.driver import run_fedssl, run_lm_fedssl
from repro_torch.federated.transport import Transport, pack_stage_payload
from repro_torch.launch.train import LM_ARCHS
from repro_torch.obs import make_obs
from repro_torch.privacy import (PrivacyConfig, PrivacyEngine,
                                 SecureAggregator, make_privacy)
from repro_torch.privacy import secure_agg as tsecure

from _torch_replay import JaxReplayDraws
from test_transport import family_tree

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 2e-5


# ---------------------------------------------------------------------------
# accountant: the reference's numbers, equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q,sigma", [(1.0, 1.0), (0.1, 1.1), (0.01, 0.7),
                                     (0.5, 4.0), (0.0, 1.0), (0.3, 0.0)])
def test_rdp_and_epsilon_equal_reference(q, sigma):
    assert tprivacy.DEFAULT_ORDERS == jprivacy.DEFAULT_ORDERS
    for a in (2, 3, 17, 63, 512):
        assert (tprivacy.rdp_sampled_gaussian(q, sigma, a)
                == jprivacy.rdp_sampled_gaussian(q, sigma, a))
    rdp = [tprivacy.rdp_sampled_gaussian(q, sigma, a)
           for a in tprivacy.DEFAULT_ORDERS]
    for delta in (1e-5, 1e-3):
        assert (tprivacy.rdp_to_epsilon(rdp, tprivacy.DEFAULT_ORDERS, delta)
                == jprivacy.rdp_to_epsilon(rdp, jprivacy.DEFAULT_ORDERS,
                                           delta))
        for steps in (1, 7, 100):
            assert (tprivacy.compute_epsilon(q, sigma, steps, delta)
                    == jprivacy.compute_epsilon(q, sigma, steps, delta))


def test_epsilon_pinned_references_and_ledger():
    """The reference's pinned values (``tests/test_privacy.py``), and an
    accountant fed a varying q equal to the reference's round by round."""
    assert tprivacy.compute_epsilon(1.0, 1.0, 1, 1e-5) == pytest.approx(
        5.302585093, abs=1e-3)
    assert tprivacy.compute_epsilon(1.0, 1.0, 100, 1e-5) == pytest.approx(
        111.512925465, abs=1e-3)
    mine, theirs = tprivacy.RDPAccountant(1.1), jprivacy.RDPAccountant(1.1)
    assert mine.epsilon(1e-5) == theirs.epsilon(1e-5) == 0.0
    for q in (0.25, 0.5, 0.25, 1.0, 0.75):
        mine.observe_round(q)
        theirs.observe_round(q)
        assert mine.epsilon(1e-5) == theirs.epsilon(1e-5)
    assert mine.rounds == theirs.rounds
    zero = tprivacy.RDPAccountant(0.0)
    zero.observe_round(1.0)
    assert zero.epsilon(1e-5) == math.inf


@pytest.mark.parametrize("call", [
    lambda m: m.rdp_sampled_gaussian(0.5, 1.0, 1),
    lambda m: m.rdp_sampled_gaussian(0.5, 1.0, 2.5),
    lambda m: m.rdp_sampled_gaussian(1.5, 1.0, 2),
    lambda m: m.rdp_to_epsilon([1.0], [2], 0.0),
    lambda m: m.RDPAccountant(-0.1)])
def test_accountant_validation_matches_reference(call):
    with pytest.raises(ValueError) as want:
        call(jprivacy)
    with pytest.raises(ValueError) as got:
        call(tprivacy)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# clip: one torch function against clip_jax and clip_host
# ---------------------------------------------------------------------------
def _update(seed, n=4096, size=1e-2):
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=n).astype(np.float32)
    return ref + (size * rng.normal(size=n)).astype(np.float32), ref


@pytest.mark.parametrize("seed,frac", [(0, 0.5), (1, 0.1), (2, 0.9)])
def test_clip_matches_reference(seed, frac):
    flat, ref = _update(seed)
    norm = float(np.linalg.norm(flat.astype(np.float64) - ref))
    clip = frac * norm          # well away from the norm: no tie to flip
    jeng = jprivacy.make_privacy(jprivacy.PrivacyConfig(clip=clip))
    out, scale = make_privacy(PrivacyConfig(clip=clip)).clip(
        torch.from_numpy(flat), torch.from_numpy(ref))
    out_j, sc_j = jeng.clip_jax(jnp.asarray(flat), jnp.asarray(ref))
    out_h, sc_h = jeng.clip_host(flat, ref)
    for want, sc in ((np.asarray(out_j), float(sc_j)), (out_h, float(sc_h))):
        np.testing.assert_allclose(out.numpy(), want, atol=1e-6, rtol=0)
        assert float(scale) == pytest.approx(sc, rel=1e-6)
    assert float(scale) < 1.0
    assert float(np.linalg.norm(out.numpy().astype(np.float64) - ref)) \
        == pytest.approx(clip, rel=1e-5)


@pytest.mark.parametrize("clip", [float("inf"), 1e9])
def test_clip_pass_through_is_bit_identical(clip):
    """Nothing clipped: the ``where`` hands back ``flat``'s own bits, as
    ``clip_jax`` does (never ``ref + 1.0·Δ``), and the scale is 1. The
    reference spans six decades, so ``ref + (flat - ref)`` re-rounds about
    half of the elements."""
    rng = np.random.default_rng(3)
    ref = (rng.normal(size=4096)
           * rng.choice([1e-3, 1.0, 1e3], 4096)).astype(np.float32)
    flat = rng.normal(size=4096).astype(np.float32)
    assert np.mean(ref + (flat - ref) != flat) > 0.3
    out, scale = make_privacy(PrivacyConfig(clip=clip)).clip(
        torch.from_numpy(flat), torch.from_numpy(ref))
    assert torch.equal(out, torch.from_numpy(flat)) and float(scale) == 1.0
    jout, _ = jprivacy.make_privacy(
        jprivacy.PrivacyConfig(clip=clip)).clip_jax(jnp.asarray(flat),
                                                    jnp.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


# ---------------------------------------------------------------------------
# secure aggregation: bit-exact, and the reference's sum
# ---------------------------------------------------------------------------
def _flats(tree, spec, n=3):
    base = pack_stage_payload(tree, spec)
    return [base * (1.0 + 0.1 * i) for i in range(n)]


def _assert_secure_sums(flats, w, ids, seed, chunk=tsecure.MASK_CHUNK):
    agg = SecureAggregator(chunk=chunk)
    masked = agg.aggregate(flats, w, ids, seed, mask=True)
    plain = agg.aggregate(flats, w, ids, seed, mask=False)
    want = jprivacy.SecureAggregator().aggregate(
        [f.numpy() for f in flats], np.asarray(w, np.float32)
        if isinstance(w, torch.Tensor) else w, ids, seed, mask=False)
    assert masked.dtype == torch.float32
    assert torch.equal(masked, plain)
    np.testing.assert_array_equal(masked.numpy(), want)
    return masked


@pytest.mark.parametrize("family", ["vit", "zamba"])
@pytest.mark.parametrize("seed", [0, 3])
def test_masks_cancel_bit_exact_and_equal_reference(family, seed):
    tree, S = family_tree(family, seed)
    flat = convert.from_numpy_tree(jax.device_get(tree))
    spec = Transport("fp32").spec(flat, (0, S), include_embed=True)
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(3))      # float64, as the async policy's
    ids = [int(i) for i in rng.permutation(10)[:3]]
    masked = _assert_secure_sums(_flats(flat, spec), w, ids, (seed, 7))
    exact = sum(f.double() * wi for f, wi in zip(_flats(flat, spec), w))
    assert float((masked.double() - exact).abs().max()) <= 1e-6


@pytest.mark.parametrize("schedule", tsched.SCHEDULES)
@pytest.mark.parametrize("family", ["vit", "zamba"])
def test_masks_cancel_for_every_schedule_spec(schedule, family):
    """Every round's upload spec of every schedule (stage range, embed
    and heads differ), with the fp32 FedAvg weights the drivers use."""
    tree, S = family_tree(family, 0)
    flat = convert.from_numpy_tree(jax.device_get(tree))
    fl = tbase.FLConfig(num_clients=3, rounds=max(4, S), local_epochs=1,
                        schedule=schedule)
    wire = Transport("fp32")
    w = aggregate.client_weights([5, 7, 9])
    for plan in tsched.build_schedule(fl, S):
        spec = wire.plan_specs(flat, plan)["upload"]
        _assert_secure_sums(_flats(flat, spec), w.tolist(), [0, 1, 2],
                            (42, plan.round_idx))


def test_pair_mask_shared_distinct_and_full_range():
    agg = SecureAggregator(chunk=1000)
    seed = (1, 2, 3)
    a = agg.pair_mask(seed, 2, 5, 4096)
    assert a.dtype == torch.int64 and a.shape == (4096,)
    assert torch.equal(a, agg.pair_mask(seed, 5, 2, 4096))   # both ends
    assert not torch.equal(a, agg.pair_mask(seed, 2, 6, 4096))  # per pair
    assert not torch.equal(a, agg.pair_mask((9, 2, 3), 2, 5, 4096))
    assert not torch.equal(a[:1000], a[1000:2000])  # per chunk
    with pytest.raises(ValueError):
        agg.pair_mask(seed, 3, 3, 8)
    big = agg.pair_mask(seed, 0, 1, 100_000)
    # uniform over all 2^64 patterns: the top bit is set in about half
    assert 0.49 < float((big < 0).double().mean()) < 0.51
    assert int(big.max()) > 2 ** 62 and int(big.min()) < -2 ** 62


def test_int64_add_wraps_mod_2_64():
    x = torch.tensor([2 ** 63 - 1, -2 ** 63, 2 ** 62], dtype=torch.int64)
    y = torch.tensor([1, -1, 2 ** 62], dtype=torch.int64)
    assert (x + y).tolist() == [-2 ** 63, 2 ** 63 - 1, -2 ** 63]
    assert ((x + y) - y).tolist() == x.tolist()


def test_quantize_clamps_and_equals_reference():
    mine = SecureAggregator(fraction_bits=10, value_range=2.0)
    theirs = jprivacy.SecureAggregator(fraction_bits=10, value_range=2.0)
    x = np.asarray([-5.0, 0.25, 5.0, 1.0009765625, -0.00048828125],
                   np.float32)   # ties at half a step round to even
    for w in (1.0, 0.5, 0.3333333432674408):
        q = mine.quantize(torch.from_numpy(x), w)
        np.testing.assert_array_equal(
            q.numpy(), theirs.quantize(x, w).view(np.int64))
    out = mine.dequantize(mine.quantize(torch.from_numpy(x), 1.0))
    np.testing.assert_allclose(out.numpy()[:3], [-2.0, 0.25, 2.0],
                               atol=1e-3)


def test_chunked_aggregate_equals_unchunked():
    """Masks per chunk of 1000 against one chunk over the whole payload:
    the same sum, and each client's masked message sums to it."""
    tree, S = family_tree("vit", 1)
    flat = convert.from_numpy_tree(jax.device_get(tree))
    spec = Transport("fp32").spec(flat, (0, S), include_embed=True)
    flats, ids, seed = _flats(flat, spec, 4), [3, 0, 7, 2], (5, 6)
    w = aggregate.client_weights([3, 4, 5, 6]).tolist()
    whole = _assert_secure_sums(flats, w, ids, seed, chunk=spec.total)
    chunked = _assert_secure_sums(flats, w, ids, seed, chunk=1000)
    assert torch.equal(whole, chunked)
    agg = SecureAggregator(chunk=1000)
    msgs = [agg.mask_payload(agg.quantize(f, wi), c, ids, seed)
            for f, wi, c in zip(flats, w, ids)]
    assert not torch.equal(msgs[0], agg.quantize(flats[0], w[0]))
    assert torch.equal(agg.dequantize(sum(msgs)), chunked)


def test_secure_agg_validation():
    agg = SecureAggregator()
    x = [torch.ones(4)] * 2
    with pytest.raises(ValueError, match="duplicate"):
        agg.aggregate(x, [0.5, 0.5], [1, 1], (0,))
    with pytest.raises(ValueError, match="mismatch"):
        agg.aggregate(x, [1.0], [0, 1], (0,))
    with pytest.raises(ValueError, match="nothing"):
        agg.aggregate([], [], [], (0,))
    with pytest.raises(ValueError):
        SecureAggregator(fraction_bits=60)
    with pytest.raises(ValueError):
        SecureAggregator(value_range=0.0)
    assert agg.masked_bytes(100) == 100 * tprivacy.MASK_ITEMSIZE == 800


# ---------------------------------------------------------------------------
# configuration, sigma and the per-round streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(noise_multiplier=1.0), dict(clip=-1.0), dict(clip=float("inf"),
                                                     noise_multiplier=1.0),
    dict(clip=1.0, noise_multiplier=-1.0), dict(clip=1.0, delta=0.0),
    dict(clip=1.0, delta=1.5), dict(secure_agg=True, delta=1.0)])
def test_make_privacy_rejects_with_reference_messages(kw):
    with pytest.raises(ValueError) as want:
        jprivacy.make_privacy(jprivacy.PrivacyConfig(**kw))
    with pytest.raises(ValueError) as got:
        make_privacy(PrivacyConfig(**kw))
    assert str(got.value) == str(want.value)


def test_make_privacy_gating_and_sigma():
    assert make_privacy(None) is None
    assert make_privacy(PrivacyConfig()) is None
    eng = make_privacy(PrivacyConfig(clip=1.0))
    assert eng.dp and not eng.noise_enabled and make_privacy(eng) is eng
    assert make_privacy(PrivacyConfig(secure_agg=True)).dp is False
    with pytest.raises(TypeError):
        make_privacy({"clip": 1.0})
    for clip, z, w in ((2.0, 1.5, 0.25), (1.0, 1.1, 1 / 3)):
        mine = make_privacy(PrivacyConfig(clip=clip, noise_multiplier=z))
        theirs = jprivacy.make_privacy(jprivacy.PrivacyConfig(
            clip=clip, noise_multiplier=z))
        assert mine.sigma(w) == theirs.sigma(w) == z * clip * w
    assert make_privacy(PrivacyConfig(clip=2.0)).sigma(0.25) == 0.0


def test_privacy_streams_deterministic_and_apart():
    """The same seed and round give the same noise and mask seed; other
    rounds others; and drawing them leaves the main generator alone."""
    a, b = TorchDraws(7, "cpu"), TorchDraws(7, "cpu")
    state = a.generator.get_state()
    n0 = a.privacy_noise(0, 1000)
    assert n0.dtype == torch.float32 and n0.shape == (1000,)
    assert torch.equal(n0, b.privacy_noise(0, 1000))
    assert not torch.equal(n0, a.privacy_noise(1, 1000))
    assert not torch.equal(n0, TorchDraws(8, "cpu").privacy_noise(0, 1000))
    assert a.mask_seed(3) == b.mask_seed(3) != a.mask_seed(4)
    assert torch.equal(a.generator.get_state(), state)
    assert abs(float(a.privacy_noise(2, 200_000).std()) - 1.0) < 0.01


# ---------------------------------------------------------------------------
# run_fedssl: a tiny ViT, 3 clients
# ---------------------------------------------------------------------------
MODEL = dict(arch_id="t-vit", family="dense", num_layers=2, d_model=32,
             num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=0,
             causal=False, compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=32, pred_hidden=32, proj_dim=16)
N_CLIENTS = 3
IMAGES = np.random.default_rng(0).normal(size=(96, 32, 32, 3)).astype(
    np.float32)
INDICES = [np.arange(i * 32, (i + 1) * 32) for i in range(N_CLIENTS)]
# the clients' update norms on this config are 2.2e-3 to 2.3e-3 in the
# first round (1.7e-3, then 5.6e-4 after it without DP): C = 2e-3 clips
# the first round, and not every later one
DP_CLIP, DP_Z = 2e-3, 1.1


def _cfgs(mod, schedule="e2e", rounds=2, cpr=0):
    return (mod.ModelConfig(**MODEL), mod.SSLConfig(**SSL),
            mod.FLConfig(num_clients=N_CLIENTS, rounds=rounds,
                         local_epochs=1, schedule=schedule,
                         clients_per_round=cpr),
            mod.TrainConfig(batch_size=16, base_lr=1.5e-4))


def _port(privacy=None, engine="sequential", draws=None, sim=None,
          obs=None, schedule="e2e", rounds=2, cpr=0):
    return run_fedssl(*_cfgs(tbase, schedule, rounds, cpr), images=IMAGES,
                      client_indices=INDICES, aux_images=IMAGES[:16],
                      draws=draws, device="cpu", engine=engine,
                      privacy=privacy, sim=sim, obs=obs)


def _replay(schedule="e2e"):
    return JaxReplayDraws(jax.random.PRNGKey(0), jssl.make_vit_encoder(
        _cfgs(jbase, schedule)[0]))


def _flat_state(state):
    return {f"{b}/{k}": v for b, flat in state.items()
            for k, v in flat.items()}


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_dp_off_is_bit_identical(engine):
    """clip = inf and clip = 1e9 with z = 0 run the clip in every upload,
    the accountant and the streams, and change no bit."""
    s0, h0 = _port(engine=engine)
    assert h0.epsilon == [] and h0.clip_fraction == []
    for clip in (float("inf"), 1e9):
        s1, h1 = _port(PrivacyConfig(clip=clip), engine)
        assert h1.loss == h0.loss
        a, b = _flat_state(s0), _flat_state(s1)
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert h1.epsilon == [math.inf, math.inf]
        assert h1.clip_fraction == [0.0, 0.0]
        assert h1.secure_agg_overhead_bytes == [0, 0]


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_dp_run_matches_reference(engine):
    """Finite clip and noise, the reference's noise replayed: the port's
    run against the reference's."""
    cfg = dict(clip=DP_CLIP, noise_multiplier=DP_Z)
    jstate, jhist = jax_run_fedssl(
        *_cfgs(jbase), images=IMAGES, client_indices=INDICES,
        aux_images=IMAGES[:16], key=jax.random.PRNGKey(0), engine=engine,
        privacy=jprivacy.PrivacyConfig(**cfg))
    state, hist = _port(PrivacyConfig(**cfg), engine, _replay())
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    assert hist.epsilon == jhist.epsilon
    assert hist.clip_fraction == jhist.clip_fraction
    assert hist.clip_fraction[0] == 1.0 and min(hist.clip_fraction) < 1.0
    assert hist.to_dict()["fields"] == {
        **jhist.to_dict()["fields"], "loss": hist.loss}
    want = convert.flatten_tree(jax.device_get(jstate))
    got = convert.flatten_tree(convert.state_to_numpy(state))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


class _SecureSpy:
    """Wraps ``PrivacyEngine.secure_fedavg``: holds every aggregate's
    fixed-point sum against the exact (float64) FedAvg of the same decoded
    uploads, and its fp32 output against that sum's rounding."""

    def __init__(self, monkeypatch):
        self.rounds, self.worst = 0, 0.0
        orig = PrivacyEngine.secure_fedavg
        spy = self

        def secure_fedavg(eng, trees, weights, client_ids, *, spec, base,
                          seed, mask=True):
            sums = []
            deq = eng.masker.dequantize
            eng.masker.dequantize = lambda acc: sums.append(acc) or deq(acc)
            try:
                out = orig(eng, trees, weights, client_ids, spec=spec,
                           base=base, seed=seed, mask=mask)
            finally:
                del eng.masker.dequantize
            exact = sum(pack_stage_payload(t, spec).double() * float(w)
                        for t, w in zip(trees, weights))
            fixed = sums[0].double() / 2.0 ** 40
            spy.worst = max(spy.worst, float((fixed - exact).abs().max())
                            / len(trees))
            assert torch.equal(pack_stage_payload(out, spec),
                               fixed.float())
            spy.rounds += 1
            return out

        monkeypatch.setattr(PrivacyEngine, "secure_fedavg", secure_fedavg)


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
@pytest.mark.parametrize("policy", [None, "deadline", "buffered-async"])
def test_secure_agg_matches_exact_fedavg(engine, policy, monkeypatch):
    spy = _SecureSpy(monkeypatch)
    sim = (simulation.make_sim("pareto-stragglers", policy,
                               num_clients=N_CLIENTS, seed=0)
           if policy else None)
    state, hist = _port(PrivacyConfig(secure_agg=True), engine, sim=sim,
                        rounds=3)
    assert spy.rounds >= 2 and spy.worst <= 2.0 ** -40
    assert len(hist.loss) == 3 and all(np.isfinite(hist.loss))
    assert hist.epsilon == [math.inf] * 3 and hist.clip_fraction == [0.0] * 3
    payload = hist.secure_agg_overhead_bytes
    assert len(payload) == 3 and all(b > 0 for b in payload)
    if policy is not None:
        assert len(hist.round_wall_clock) == 3


def test_secure_agg_run_tracks_float_fedavg_run():
    s0, h0 = _port()
    s1, h1 = _port(PrivacyConfig(secure_agg=True))
    a, b = _flat_state(s0), _flat_state(s1)
    assert max(float((a[k] - b[k]).abs().max()) for k in a) < 1e-5
    np.testing.assert_allclose(h0.loss, h1.loss, atol=1e-4, rtol=0)


def test_epsilon_budget_halts_at_reference_round():
    cfg = dict(clip=1e-3, noise_multiplier=1.1, epsilon_budget=1.0)
    _, jhist = jax_run_fedssl(
        *_cfgs(jbase, rounds=5), images=IMAGES, client_indices=INDICES,
        aux_images=IMAGES[:16], key=jax.random.PRNGKey(0),
        privacy=jprivacy.PrivacyConfig(**cfg))
    obs = make_obs(trace=True)
    _, hist = _port(PrivacyConfig(**cfg), obs=obs, rounds=5)
    assert len(hist.loss) == len(jhist.loss) < 5
    assert hist.epsilon == jhist.epsilon and hist.epsilon[-1] > 1.0
    (ev,) = [e for e in obs.tracer.events
             if e["name"] == "privacy.budget_exhausted"]
    assert ev["args"]["epsilon"] == hist.epsilon[-1]
    assert ev["args"]["round"] == len(hist.loss) - 1


class _RecordingDraws(TorchDraws):
    def __init__(self):
        super().__init__(0, "cpu")
        self.seen = []

    def cohort(self, num_clients, n):
        self.seen.append(("cohort", super().cohort(num_clients, n)))
        return self.seen[-1][1]

    def batch_plan(self, n, epochs, batch_size, calibration=False):
        plan = super().batch_plan(n, epochs, batch_size, calibration)
        self.seen.append(("plan", [ix.tolist() for ix, _ in plan]))
        return plan


def test_dp_run_draws_the_cohorts_and_batches_of_a_run_without_dp():
    base, dp = _RecordingDraws(), _RecordingDraws()
    _port(draws=base, rounds=3, cpr=2)
    _, hist = _port(PrivacyConfig(clip=1.0, noise_multiplier=0.8,
                                  secure_agg=True), draws=dp, rounds=3,
                    cpr=2)
    assert dp.seen == base.seen and len(base.seen) > 3
    # q is the sampled cohort over the population: 2 / 3 a round
    want = tprivacy.RDPAccountant(0.8)
    for eps in hist.epsilon:
        want.observe_round(2 / 3)
        assert eps == want.epsilon(1e-5)


def test_traced_dp_rounds_carry_privacy_attrs_and_metrics():
    obs = make_obs(trace=True, metrics=True)
    _, hist = _port(PrivacyConfig(clip=DP_CLIP, noise_multiplier=DP_Z,
                                  secure_agg=True), obs=obs)
    rounds = [e for e in obs.tracer.events if e["name"] == "round"]
    assert len(rounds) == 2
    for e, eps, cf, ov in zip(rounds, hist.epsilon, hist.clip_fraction,
                              hist.secure_agg_overhead_bytes):
        assert e["args"]["epsilon"] == eps
        assert e["args"]["clip_fraction"] == cf
        assert e["args"]["secure_agg_overhead_bytes"] == ov
    met = obs.metrics.to_dict()
    assert met["gauges"]["privacy.epsilon"] == hist.epsilon[-1]
    assert met["histograms"]["privacy.clip_fraction"]["count"] == 2
    assert met["histograms"]["privacy.clip_fraction"]["sum"] == sum(
        hist.clip_fraction)
    assert met["counters"]["privacy.secure_agg_overhead_bytes"] == sum(
        hist.secure_agg_overhead_bytes)


# ---------------------------------------------------------------------------
# run_lm_fedssl against the reference's train_lm (tests/test_torch_fl_lm.py)
# ---------------------------------------------------------------------------
ARCH, SEED = "zamba2-2.7b", 0
LM_ROUNDS, LM_CLIENTS, LM_BATCH, LM_SAMPLES, LM_SEQ = 2, 2, 4, 16, 64
LM_CLIP, LM_Z = 1e-3, 1.1


@pytest.mark.parametrize("secure", [False, True])
def test_run_lm_fedssl_dp_matches_reference(secure, monkeypatch):
    over = LM_ARCHS[ARCH]
    monkeypatch.setattr(jtrain, "reduced",
                        lambda cfg, **kw: jbase.reduced(cfg,
                                                        **{**over, **kw}))
    got = {}
    monkeypatch.setattr(
        jtrain, "train_lm",
        lambda args, f=jtrain.train_lm: got.setdefault("out", f(args)))
    flags = ["--dp-clip", str(LM_CLIP), "--dp-noise-multiplier", str(LM_Z)]
    monkeypatch.setattr(sys, "argv", [
        "train", "--mode", "lm", "--arch", ARCH, "--rounds", str(LM_ROUNDS),
        "--clients", str(LM_CLIENTS), "--batch", str(LM_BATCH),
        "--samples", str(LM_SAMPLES), "--seq-len", str(LM_SEQ), "--seed",
        str(SEED), *flags, *(["--secure-agg"] if secure else [])])
    jtrain.main()
    jparams, jloss = got["out"]

    cfg = jbase.reduced(jbase.load_arch(ARCH), **over)
    kd, ki, _ = jax.random.split(jax.random.PRNGKey(SEED), 3)
    toks, labs = synthetic_tokens(kd, LM_SAMPLES, LM_SEQ, cfg.vocab_size)
    init = convert.from_numpy_tree(jax.device_get(jlm.init_lm(ki, cfg)))
    fl = tbase.FLConfig(num_clients=LM_CLIENTS, rounds=LM_ROUNDS,
                        local_epochs=1, schedule="lw_fedssl")
    params, hist = run_lm_fedssl(
        tbase.reduced(tbase.load_arch(ARCH), **over), fl,
        tbase.TrainConfig(batch_size=LM_BATCH, base_lr=3e-4),
        tokens=np.asarray(toks), labels=np.asarray(labs),
        shards=iid_partition(LM_SAMPLES, LM_CLIENTS, seed=SEED),
        params=init, device="cpu",
        privacy=PrivacyConfig(clip=LM_CLIP, noise_multiplier=LM_Z,
                              secure_agg=secure),
        draws=JaxReplayDraws(jax.random.PRNGKey(SEED), None))
    np.testing.assert_allclose(hist.loss, jloss, rtol=LOSS_RTOL)
    assert hist.epsilon == [tprivacy.compute_epsilon(1.0, LM_Z, r + 1, 1e-5)
                            for r in range(LM_ROUNDS)]
    assert hist.clip_fraction == [1.0] * LM_ROUNDS
    assert all(b > 0 for b in hist.secure_agg_overhead_bytes) == secure
    want = convert.flatten_tree(jax.device_get(jparams))
    assert list(params) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(params[k].numpy(), v, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
