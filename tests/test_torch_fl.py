"""Whole-slice parity: the port's FL driver against the JAX package's.

Both packages run ``run_fedssl`` on the same images, clients and initial
parameters; the port replays the reference's random draws
(``_torch_replay.JaxReplayDraws``). The configuration is the one of
``tests/test_integration_fl.py``: a 4-block fp32 ViT, 2 clients, every
client in every round, 4 rounds.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import ssl as jssl
from repro.data import iid_partition, synthetic_images
from repro.federated import comm as jcomm
from repro.federated import transport as jtransport
from repro.federated.driver import run_fedssl as jax_run_fedssl
from repro.core import schedule as jsched
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.federated.driver import run_fedssl
from repro_torch.optim.schedules import learning_rate, scaled_base_lr

from _torch_replay import JaxReplayDraws

torch.set_num_threads(2)

MODEL = dict(arch_id="t-vit", family="dense", num_layers=4, d_model=48,
             num_heads=4, num_kv_heads=4, d_ff=96, vocab_size=0,
             causal=False, compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=96, pred_hidden=96, proj_dim=24)
TRAIN = dict(batch_size=32, base_lr=1.5e-4)
ROUNDS, CLIENTS, SAMPLES = 4, 2, 128

# Losses and parameters: the same math on the same draws, summed in another
# order (PyTorch's CPU matmuls against XLA's), through 4 rounds of AdamW.
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 2e-5
# One leaf has a true gradient of exactly zero: the projection head's last
# BatchNorm shift, which the prediction head's own BatchNorm subtracts
# again. Its gradient is float32 rounding noise, which AdamW's normalised
# step turns into updates of up to the rate in either direction, so it is
# held to twice the sum of the run's step rates (2 local steps and 1
# calibration step a round) instead.
NOISE_LEAF = "online/proj/layers/2/bn/bias"


def _configs(mod, schedule):
    fl = mod.FLConfig(num_clients=CLIENTS, rounds=ROUNDS, local_epochs=1,
                      schedule=schedule, server_epochs=1,
                      depth_dropout=0.5 if schedule == "fll_dd" else 0.0)
    return (mod.ModelConfig(**MODEL), mod.SSLConfig(**SSL), fl,
            mod.TrainConfig(**TRAIN))


def _data():
    key = jax.random.PRNGKey(0)
    imgs, _ = synthetic_images(key, SAMPLES, 10, 32)
    return key, np.asarray(imgs), iid_partition(SAMPLES, CLIENTS)


def _port_run(schedule, key, imgs, idx):
    cfg, sslc, fl, tc = _configs(tbase, schedule)
    jenc = jssl.make_vit_encoder(_configs(jbase, schedule)[0])
    return run_fedssl(cfg, sslc, fl, tc, images=imgs, client_indices=idx,
                      aux_images=imgs[:32],
                      draws=JaxReplayDraws(key, jenc), device="cpu")


@pytest.mark.parametrize("schedule", ["lw_fedssl", "e2e"])
def test_run_fedssl_matches_reference(schedule):
    key, imgs, idx = _data()
    jstate, jhist = jax_run_fedssl(
        *_configs(jbase, schedule), images=imgs,
        client_indices=[np.asarray(i) for i in idx], aux_images=imgs[:32],
        key=key)
    state, hist = _port_run(schedule, key, imgs, idx)
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    for name in ("download_bytes", "upload_bytes", "wire_download_bytes",
                 "wire_upload_bytes", "round_stage"):
        assert getattr(hist, name) == getattr(jhist, name), name
    assert hist.to_dict()["fields"].keys() == jhist.to_dict()["fields"].keys()
    want = convert.flatten_tree(jax.device_get(jstate))
    got = convert.flatten_tree(convert.state_to_numpy(state))
    assert list(got) == list(want)
    tc = TRAIN
    rate = scaled_base_lr(tc["base_lr"], tc["batch_size"])
    noise_atol = 2 * 3 * sum(learning_rate(r, ROUNDS, rate)
                             for r in range(ROUNDS))
    for k in want:
        atol = noise_atol if k == NOISE_LEAF else PARAM_ATOL
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("schedule", ["layerwise", "progressive", "fll_dd"])
def test_other_schedules_run_with_reference_bytes(schedule):
    """The port runs the schedule; its analytic and wire byte lists are the
    reference's (``comm.round_comm_bytes`` and the transport's payload
    specs over the reference's own initial parameters)."""
    key, imgs, idx = _data()
    state, hist = _port_run(schedule, key, imgs, idx)
    assert np.all(np.isfinite(hist.loss)) and len(hist.loss) == ROUNDS
    jcfg, jsslc, jfl, _ = _configs(jbase, schedule)
    jenc = jssl.make_vit_encoder(jcfg)
    online = jssl.ssl_init(jax.random.split(key)[0], jenc, jsslc)["online"]
    wire = jtransport.Transport("fp32")
    down, up, wdown, wup = [], [], [], []
    for plan in jsched.build_schedule(jfl, jenc.num_stages):
        cb = jcomm.round_comm_bytes(online, plan)
        specs = wire.plan_specs(online, plan)
        down.append(cb["download"])
        up.append(cb["upload"])
        wdown.append(wire.wire_bytes(specs["download"]))
        wup.append(wire.wire_bytes(specs["upload"]))
    assert hist.download_bytes == down and hist.upload_bytes == up
    assert hist.wire_download_bytes == wdown and hist.wire_upload_bytes == wup
