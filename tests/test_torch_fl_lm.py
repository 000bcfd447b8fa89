"""Whole-slice parity of ``--mode lm``: the reference's ``train_lm`` against
the port's ``run_lm_fedssl`` on the same tokens, shards and initial
parameters.

The reference's ``train_lm`` builds its model with ``reduced()`` alone,
which leaves zamba2 with no stage (``num_layers=2 // attn_every=6``), so the
test patches ``repro.launch.train.reduced`` to apply the arch smoke test's
``num_layers=4, attn_every=2`` as the port's launcher does. The reference's
tokens and parameters are rebuilt from its key chain (``split(PRNGKey(seed),
3)``) and converted into the port; its wire bytes are read off its
transport. LW-FedSSL, 2 clients of 8 sequences of 64 tokens, batch 4 (2
local steps a round), 4 rounds: 2 stages of 2 rounds, alignment on, fp32.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import iid_partition
from repro.data.synthetic import synthetic_tokens
from repro.federated import transport as jtransport
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.federated.driver import run_lm_fedssl
from repro_torch.launch.train import LM_ARCHS

torch.set_num_threads(2)

ARCH, SEED = "zamba2-2.7b", 0
ROUNDS, CLIENTS, BATCH, SAMPLES, SEQ = 4, 2, 4, 16, 64
# the same math on the same data summed in another order, through 4 rounds
# of 2 AdamW steps a client. Losses: measured 1.5e-7 relative. Parameters:
# training moves every leaf by at most 2.4e-5 in these rounds (the rate is
# 4.7e-6 and falls), the stage-2 weight transfer by up to 2; the two
# packages' parameters differ by at most 3.5e-7, and the tolerance is under
# a tenth of what training moved
LOSS_RTOL = 2e-6
PARAM_ATOL = 2e-6


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    over = LM_ARCHS[ARCH]
    mp.setattr(jtrain, "reduced",
               lambda cfg, **kw: jbase.reduced(cfg, **{**over, **kw}))
    wire = {"down": [], "up": []}
    broadcast = jtransport.Transport.broadcast
    aggregate = jtransport.Transport.aggregate_uploads

    def rec_broadcast(self, *a, **k):
        out = broadcast(self, *a, **k)
        wire["down"].append(out[1]["wire_bytes"])
        return out

    def rec_aggregate(self, *a, **k):
        out = aggregate(self, *a, **k)
        wire["up"].append(out[1]["wire_bytes"])
        return out

    mp.setattr(jtransport.Transport, "broadcast", rec_broadcast)
    mp.setattr(jtransport.Transport, "aggregate_uploads", rec_aggregate)
    got = {}
    mp.setattr(jtrain, "train_lm",
               lambda args, f=jtrain.train_lm: got.setdefault("out", f(args)))
    mp.setattr(sys, "argv", [
        "train", "--mode", "lm", "--arch", ARCH, "--rounds", str(ROUNDS),
        "--clients", str(CLIENTS), "--batch", str(BATCH), "--samples",
        str(SAMPLES), "--seq-len", str(SEQ), "--seed", str(SEED)])
    try:
        jtrain.main()
    finally:
        mp.undo()
    jparams, jhist = got["out"]

    # the reference's data and initial parameters, from its key chain
    cfg = jbase.reduced(jbase.load_arch(ARCH), **over)
    kd, ki, _ = jax.random.split(jax.random.PRNGKey(SEED), 3)
    toks, labs = synthetic_tokens(kd, SAMPLES, SEQ, cfg.vocab_size)
    init = convert.from_numpy_tree(jax.device_get(jlm.init_lm(ki, cfg)))
    tcfg = tbase.reduced(tbase.load_arch(ARCH), **over)
    fl = tbase.FLConfig(num_clients=CLIENTS, rounds=ROUNDS, local_epochs=1,
                        schedule="lw_fedssl")
    tc = tbase.TrainConfig(batch_size=BATCH, base_lr=3e-4)
    params, hist = run_lm_fedssl(
        tcfg, fl, tc, tokens=np.asarray(toks), labels=np.asarray(labs),
        shards=iid_partition(SAMPLES, CLIENTS, seed=SEED), params=init,
        device="cpu")
    return (convert.flatten_tree(jax.device_get(jparams)), jhist, wire,
            params, hist)


def test_losses_match_reference(runs):
    _, jhist, _, _, hist = runs
    assert len(hist.loss) == len(jhist) == ROUNDS
    assert hist.round_stage == [1, 1, 2, 2]
    np.testing.assert_allclose(hist.loss, jhist, rtol=LOSS_RTOL)


def test_params_match_reference(runs):
    jparams, _, _, params, _ = runs
    assert list(params) == list(jparams)
    for k, want in jparams.items():
        np.testing.assert_allclose(params[k].numpy(), want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_wire_bytes_match_reference_exactly(runs):
    _, _, wire, _, hist = runs
    assert hist.wire_download_bytes == wire["down"]
    assert hist.wire_upload_bytes == wire["up"]
    assert hist.wire_download_bytes == hist.download_bytes
    assert hist.wire_upload_bytes == hist.upload_bytes
