"""The port's vectorised engine (``--engine vmap``): against the port's
sequential engine, and against the JAX package's ``VmapEngine`` on the
reference's replayed draws.

A 2-block fp32 ViT with narrow heads, 2 rounds, batch 16. The ragged cases
use a Dirichlet partition (shards of different sizes, so clients run
different numbers of local steps and the vmap engine pads) and sample 2 of
3 clients a round. The LM family's vmap engine runs through
``run_lm_fedssl`` on ragged token shards."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import ssl as jssl
from repro.data import partition as jpartition
from repro.federated.driver import run_fedssl as jax_run_fedssl
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data import partition
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.federated import engine as engine_mod
from repro_torch.federated.driver import run_fedssl, run_lm_fedssl
from repro_torch.launch import steps
from repro_torch.models import lm as lm_mod
from repro_torch.optim.schedules import learning_rate, scaled_base_lr

from _torch_replay import JaxReplayDraws

torch.set_num_threads(2)

MODEL = dict(arch_id="t-vit", family="dense", num_layers=2, d_model=32,
             num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=0,
             causal=False, compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=32, pred_hidden=32, proj_dim=16)
BATCH, ROUNDS, CLIENTS, SAMPLES = 16, 2, 3, 96

# vmap against sequential in the port: the bar tests/test_engine.py sets
# for the reference's two engines (the same math, batched).
ENGINE_ATOL = 1e-4
# against the reference: slice 1's tolerances (tests/test_torch_fl.py):
# the same math summed in another order through AdamW, and the one leaf
# whose true gradient is exactly zero held to the run's rate budget.
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 2e-5
# the LM engines: the launcher tests' bar (tests/test_torch_lm_dense.py)
LM_RTOL = 2e-6
NOISE_LEAF = "online/proj/layers/2/bn/bias"


def _configs(mod, schedule, clients_per_round=0):
    fl = mod.FLConfig(num_clients=CLIENTS, rounds=ROUNDS, local_epochs=1,
                      schedule=schedule, server_epochs=1,
                      clients_per_round=clients_per_round,
                      depth_dropout=0.5 if schedule == "fll_dd" else 0.0)
    return (mod.ModelConfig(**MODEL), mod.SSLConfig(**SSL), fl,
            mod.TrainConfig(batch_size=BATCH, base_lr=1.5e-4))


def _data(ragged):
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(SAMPLES, 32, 32, 3)).astype(np.float32)
    if ragged:
        labels = rng.integers(0, 10, SAMPLES)
        idx = partition.dirichlet_partition(labels, CLIENTS, 0.5, seed=1,
                                            min_per_client=BATCH)
    else:
        idx = partition.iid_partition(SAMPLES, CLIENTS)
    return imgs, idx


def _close(a, b, atol, rtol=0.0, noise_atol=None):
    assert list(a) == list(b)
    for k in a:
        tol = noise_atol if k == NOISE_LEAF and noise_atol else atol
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("schedule,ragged,codec", [
    ("lw_fedssl", False, "fp32"),
    ("e2e", True, "fp32"),
    ("lw_fedssl", True, "int8"),
    ("fll_dd", True, "topk:0.2"),
])
def test_vmap_matches_sequential(schedule, ragged, codec):
    imgs, idx = _data(ragged)
    assert ragged == (len({len(i) // BATCH for i in idx}) > 1)
    runs = {}
    for engine in ("sequential", "vmap"):
        runs[engine] = run_fedssl(
            *_configs(tbase, schedule, 2 if ragged else 0), images=imgs,
            client_indices=idx, aux_images=imgs[:BATCH], device="cpu",
            engine=engine, codec=codec)
    (s_seq, h_seq), (s_v, h_v) = runs["sequential"], runs["vmap"]
    np.testing.assert_allclose(h_v.loss, h_seq.loss, atol=ENGINE_ATOL)
    for name in ("download_bytes", "upload_bytes", "wire_download_bytes",
                 "wire_upload_bytes", "round_stage"):
        assert getattr(h_v, name) == getattr(h_seq, name), name
    _close(convert.flatten_tree(convert.state_to_numpy(s_v)),
           convert.flatten_tree(convert.state_to_numpy(s_seq)), ENGINE_ATOL)


@pytest.mark.parametrize("schedule,ragged", [("lw_fedssl", False),
                                             ("e2e", True)])
def test_vmap_matches_reference_vmap_engine(schedule, ragged):
    imgs, idx = _data(ragged)
    cpr = 2 if ragged else 0
    key = jax.random.PRNGKey(0)
    jstate, jhist = jax_run_fedssl(
        *_configs(jbase, schedule, cpr), images=imgs,
        client_indices=[np.asarray(i) for i in idx], aux_images=imgs[:BATCH],
        key=key, engine="vmap")
    jenc = jssl.make_vit_encoder(_configs(jbase, schedule)[0])
    state, hist = run_fedssl(
        *_configs(tbase, schedule, cpr), images=imgs, client_indices=idx,
        aux_images=imgs[:BATCH], draws=JaxReplayDraws(key, jenc),
        device="cpu", engine="vmap")
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    assert hist.wire_upload_bytes == jhist.wire_upload_bytes
    rate = scaled_base_lr(1.5e-4, BATCH)
    steps = max(len(i) // BATCH for i in idx) + 1   # local + calibration
    noise_atol = 2 * steps * sum(learning_rate(r, ROUNDS, rate)
                                 for r in range(ROUNDS))
    _close(convert.flatten_tree(convert.state_to_numpy(state)),
           convert.flatten_tree(jax.device_get(jstate)), PARAM_ATOL,
           PARAM_RTOL, noise_atol)


def test_stack_shards_matches_reference():
    idx = [np.arange(0, 5), np.arange(5, 7), np.arange(7, 16)]
    data = np.arange(32, dtype=np.float32).reshape(16, 2)
    want, wlen = jpartition.stack_shards(data, idx)
    got, glen = partition.stack_shards(torch.from_numpy(data), idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen, wlen)


def test_vmap_engine_refuses_a_shard_smaller_than_the_batch():
    imgs, _ = _data(False)
    idx = [np.arange(0, 40), np.arange(40, 50), np.arange(50, 96)]
    with pytest.raises(ValueError, match="every shard >= batch size"):
        run_fedssl(*_configs(tbase, "e2e"), images=imgs, client_indices=idx,
                   device="cpu", engine="vmap")


def test_lm_vmap_engine_is_built_once_and_not_by_the_launcher(monkeypatch):
    """``run_lm_fedssl(engine="vmap")`` builds its engine once a run and
    never the launcher's round program; on ragged shards (2 and 1 local
    steps) its losses and parameters are the sequential engine's."""
    def refuse(*a, **k):
        raise AssertionError("the driver built the launcher's round program")

    monkeypatch.setattr(steps, "make_fl_round_program", refuse)
    built = []
    init = engine_mod.LMVmapEngine.__init__

    def counted(self, **kw):
        built.append(kw["batch_size"])
        init(self, **kw)

    monkeypatch.setattr(engine_mod.LMVmapEngine, "__init__", counted)
    cfg = tbase.reduced(tbase.load_arch("internlm2-1.8b"))
    toks, labs = synthetic_tokens(torch.Generator().manual_seed(1), 14, 32,
                                  cfg.vocab_size)
    params = lm_mod.init_lm(cfg, torch.Generator().manual_seed(0))
    fl = tbase.FLConfig(num_clients=2, rounds=2, local_epochs=1,
                        schedule="lw_fedssl")
    runs = {e: run_lm_fedssl(
        cfg, fl, tbase.TrainConfig(batch_size=4, base_lr=3e-4), tokens=toks,
        labels=labs, shards=[np.arange(0, 8), np.arange(8, 14)],
        params=params, device="cpu", engine=e)
        for e in ("vmap", "sequential")}
    assert built == [4]
    (p_v, h_v), (p_s, h_s) = runs["vmap"], runs["sequential"]
    assert h_v.round_stage == h_s.round_stage == [1, 2]
    np.testing.assert_allclose(h_v.loss, h_s.loss, rtol=LM_RTOL)
    for k, v in p_s.items():
        np.testing.assert_allclose(p_v[k].numpy(), v.numpy(), rtol=0,
                                   atol=LM_RTOL, err_msg=k)
