"""Whole-slice parity on a compressed wire: the port's FL driver against the
JAX package's under the int8 and top-k codecs.

As ``tests/test_torch_fl.py``: both packages run ``run_fedssl`` on the same
images, clients and initial parameters, and the port replays the
reference's random draws. LW-FedSSL on a 2-block fp32 ViT, 2 clients, 4
rounds split (1, 3) over the two stages, so that stage 2 runs a download
under a new layout (top-k: a dense re-sync), two delta downloads against
the server's mirror and two uploads that carry each client's
error-feedback residual.
"""
import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.core import ssl as jssl
from repro.data import iid_partition, synthetic_images
from repro.federated.driver import run_fedssl as jax_run_fedssl
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.federated.driver import run_fedssl
from repro_torch.optim.schedules import learning_rate, scaled_base_lr

from _torch_replay import JaxReplayDraws

MODEL = dict(arch_id="t-vit", family="dense", num_layers=2, d_model=48,
             num_heads=4, num_kv_heads=4, d_ff=96, vocab_size=0,
             causal=False, compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=96, pred_hidden=96, proj_dim=24)
TRAIN = dict(batch_size=32, base_lr=1.5e-4)
ROUNDS, CLIENTS, SAMPLES = 4, 2, 128
STEPS_PER_ROUND = 3            # 2 local steps and 1 calibration step

# Before any codec, the two runs differ by float rounding only (fp32 on
# both sides, summed in another order: tests/test_torch_fl.py holds them to
# rtol 1e-4). A codec turns such a difference into a discrete one where a
# value sits at a decision boundary:
# - int8: an entry within rounding of a quantization boundary decodes one
#   quantum apart. A quantum is a channel's amax / 127, at most the leaf's
#   largest |value| / 127. Each round can flip an entry on its download and
#   on its upload, so a leaf is held to 2 * ROUNDS quanta.
# - top-k: a near-tie at the threshold selects another entry. The two
#   entries' deltas are both at the threshold, and error feedback carries
#   the unsent one into the next round (delayed, not lost), so a flip moves
#   an entry by at most one round's update: STEPS_PER_ROUND AdamW steps,
#   each at most the rate. A leaf is held to twice the run's rate budget,
#   the bound tests/test_torch_fl.py uses for its noise leaf.
# The losses get rtol 1e-3: one flipped quantum or selection moves a
# client's loss by far less. The leaf whose true gradient is exactly zero
# (see tests/test_torch_fl.py) gets the rate budget on top, as there.
LOSS_RTOL = 1e-3
PARAM_RTOL, PARAM_ATOL = 1e-4, 2e-5
NOISE_LEAF = "online/proj/layers/2/bn/bias"


def _configs(mod):
    fl = mod.FLConfig(num_clients=CLIENTS, rounds=ROUNDS, local_epochs=1,
                      schedule="lw_fedssl", server_epochs=1,
                      rounds_per_stage=(1, 3))
    return (mod.ModelConfig(**MODEL), mod.SSLConfig(**SSL), fl,
            mod.TrainConfig(**TRAIN))


@pytest.mark.parametrize("codec", ["int8", "topk:0.2"])
def test_run_fedssl_codec_matches_reference(codec):
    key = jax.random.PRNGKey(0)
    imgs, _ = synthetic_images(key, SAMPLES, 10, 32)
    imgs = np.asarray(imgs)
    idx = iid_partition(SAMPLES, CLIENTS)
    jstate, jhist = jax_run_fedssl(
        *_configs(jbase), images=imgs,
        client_indices=[np.asarray(i) for i in idx], aux_images=imgs[:32],
        key=key, codec=codec, transport_kernels="pallas")
    jenc = jssl.make_vit_encoder(_configs(jbase)[0])
    state, hist = run_fedssl(
        *_configs(tbase), images=imgs, client_indices=idx,
        aux_images=imgs[:32], draws=JaxReplayDraws(key, jenc), device="cpu",
        codec=codec, transport_kernels="pallas")
    # wire bytes are exact: the codec's byte count, and the payload's in
    # top-k's dense re-sync rounds
    for name in ("download_bytes", "upload_bytes", "wire_download_bytes",
                 "wire_upload_bytes", "round_stage"):
        assert getattr(hist, name) == getattr(jhist, name), name
    assert hist.compression_ratio == jhist.compression_ratio > 1.0
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=LOSS_RTOL)
    want = convert.flatten_tree(jax.device_get(jstate))
    got = convert.flatten_tree(convert.state_to_numpy(state))
    assert list(got) == list(want)
    rate = scaled_base_lr(TRAIN["base_lr"], TRAIN["batch_size"])
    budget = 2 * STEPS_PER_ROUND * sum(learning_rate(r, ROUNDS, rate)
                                       for r in range(ROUNDS))
    for k in want:
        if codec == "int8":
            atol = PARAM_ATOL + 2 * ROUNDS * np.abs(want[k]).max() / 127
        else:
            atol = PARAM_ATOL + budget
        if k == NOISE_LEAF:
            atol += budget
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=atol, err_msg=k)
