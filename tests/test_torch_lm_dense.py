"""The dense LM (the ``uniform`` topology of ``dense`` blocks) against the
JAX package: the forward and the SSL loss for each dense config at
``reduced()`` (with a sliding-window case and internvl2-1b's frontend
stub), ``launch.steps.make_train_step`` with microbatches and remat,
``make_fl_round_program``, and the launcher's ``--mode lm`` with its
default arch on both engines. Parameters are the reference's
``init_lm`` converted through numpy; inputs are numpy draws."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import ssl as jssl
from repro.data.partition import stack_shards as jstack_shards
from repro.data.synthetic import synthetic_tokens
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import ssl as tssl
from repro_torch.federated import aggregate
from repro_torch.launch import steps, train
from repro_torch.models import lm

torch.set_num_threads(2)

DENSE = ("internlm2-1.8b", "internlm2-20b", "starcoder2-15b",
         "mistral-large-123b", "internvl2-1b")
# fp32 on both sides through 2 blocks: the same math summed in another
# order (PyTorch's CPU matmuls and attention against XLA's); relative to
# the largest value of each compared tensor
RTOL = 5e-5
GRAD_RTOL = 2e-4


def _configs(arch, **over):
    return (dataclasses.replace(jbase.reduced(jbase.load_arch(arch)), **over),
            dataclasses.replace(tbase.reduced(tbase.load_arch(arch)), **over))


def _close(got, want, rtol=RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (msg, err, scale)


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    if cfg.frontend_embed_len:
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend_embed_len, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,over", [(a, {}) for a in DENSE]
                         + [("internlm2-1.8b", {"window": 16})])
def test_dense_forward_and_loss_match_reference(arch, over):
    """The full forward, then the SSL loss at stage 2 of 2 with the
    alignment (block 0 frozen) and its gradients, for ``reduced()`` of
    ``arch`` (internvl2-1b: 16 frontend positions ahead of the tokens;
    ``window=16`` over 32 tokens: the sliding window masks)."""
    jcfg, tcfg = _configs(arch, **over)
    assert lm.topology(tcfg) == "uniform" and lm.num_stages(tcfg) == 2
    jparams = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    params = convert.from_numpy_tree(jparams)
    assert list(lm.lm_shapes(tcfg)) == list(params)
    assert all(tuple(params[k].shape) == s
               for k, s in lm.lm_shapes(tcfg).items())
    batch = _batch(tcfg)
    fe = batch.get("frontend")
    jx = jlm.embed(jparams, batch["tokens"], jcfg, fe)
    jh, _ = jlm.forward_hidden(jparams, jx, jcfg)
    h, _ = lm.forward_hidden(params, lm.embed(
        params, torch.from_numpy(batch["tokens"]).long(), tcfg,
        None if fe is None else torch.from_numpy(fe)), tcfg)
    _close(h, jh, msg="hidden")

    glob = jax.tree.map(lambda a: a * 1.01, jparams)
    kw = dict(sub_layers=2, active_from=1, align_weight=0.01)

    def jloss(p):
        return jssl.lm_ssl_loss(p, batch, jcfg, global_params=glob, **kw)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, m = tssl.lm_ssl_loss(p, _torch_batch(batch), tcfg,
                               global_params=convert.from_numpy_tree(
                                   jax.device_get(glob)), **kw)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()),
                                            allow_unused=True)))
    for name in ("loss", "xent", "align"):
        _close(m[name], jm[name], msg=name)
    for k, want in convert.flatten_tree(jax.device_get(jg)).items():
        if not np.abs(want).any():       # the embedding and block 0
            assert grads[k] is None or not grads[k].any(), k
        else:
            _close(grads[k], want, GRAD_RTOL, k)


def test_train_step_microbatch_remat_matches_reference():
    """``make_train_step`` in ``train_lw`` mode (final stage, alignment,
    freeze mask) with Adafactor, 2 microbatches and remat, two steps,
    against the reference's; and remat changes nothing in the port."""
    jcfg, tcfg = _configs("internlm2-1.8b")
    kw = dict(optimizer="adafactor", microbatch=2, remat=True, batch_size=4)
    jstep, jopt = jsteps.make_train_step(jcfg, jbase.TrainConfig(**kw),
                                         mode="train_lw", lr=1e-3)
    jparams = jax.device_get(jlm.init_lm(jax.random.PRNGKey(1), jcfg))
    glob = jax.tree.map(lambda a: a * 1.01, jparams)
    batches = [_batch(tcfg, B=4, seed=s) for s in (1, 2)]
    jp, jo = jparams, jopt.init(jparams)
    for b in batches:
        jp, jo, jm = jstep(jp, jo, b, glob)
    runs = {}
    for remat in (True, False):
        step, opt = steps.make_train_step(
            tcfg, tbase.TrainConfig(**{**kw, "remat": remat}),
            mode="train_lw", lr=1e-3)
        p = convert.from_numpy_tree(jparams)
        o = opt.init(p)
        for b in batches:
            p, o, m = step(p, o, _torch_batch(b),
                           convert.from_numpy_tree(jax.device_get(glob)))
        runs[remat] = (p, m)
    p, m = runs[True]
    _close(m["loss"], jm["loss"], msg="loss")
    want = convert.flatten_tree(jax.device_get(jp))
    assert list(p) == list(want)
    for k in want:
        _close(p[k], want[k], msg=k)
        torch.testing.assert_close(p[k], runs[False][0][k], rtol=1e-6,
                                   atol=1e-7)


# the reference's tests/test_engine.py::test_lm_multi_client_round_program
ROUND_CFG = dict(arch_id="t", family="dense", num_layers=2, d_model=32,
                 num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=50,
                 compute_dtype="float32")
# 2 AdamW steps a client at rate 1e-3 from the same parameters
ROUND_ATOL = 1e-5


@pytest.mark.parametrize("fedavg", [True, False])
def test_fl_round_program_matches_reference(fedavg):
    """Two clients, two local steps, the second client's second step
    padded (``valid`` False): the FedAvg of the clients' trees (or the
    trees) and the last valid losses equal the reference's round
    program's."""
    jcfg, tcfg = jbase.ModelConfig(**ROUND_CFG), tbase.ModelConfig(**ROUND_CFG)
    tc = dict(batch_size=8, base_lr=1e-3)
    key = jax.random.PRNGKey(0)
    toks, labs = synthetic_tokens(key, 32, 16, jcfg.vocab_size)
    jparams = jlm.init_lm(key, jcfg)
    shards = [np.arange(0, 16), np.arange(16, 32)]
    jstacked, _ = jstack_shards({"tokens": toks, "labels": labs},
                                [jnp.asarray(s) for s in shards])
    C, T, B = 2, 2, 8
    batch_idx = np.stack([[np.arange(0, B), np.arange(B, 2 * B)]] * C)
    valid = np.array([[True, True], [True, False]])
    w = np.array([0.6, 0.4], np.float32)
    jprog, _ = jsteps.make_fl_round_program(jcfg, jbase.TrainConfig(**tc),
                                            fedavg=fedavg)
    jout, jloss = jprog({"params": jparams}, jstacked, jnp.asarray(batch_idx),
                        jnp.zeros((C, T, 2), jnp.uint32), jnp.asarray(valid),
                        jnp.asarray(w), jnp.float32(1e-3))
    prog, _ = steps.make_fl_round_program(tcfg, tbase.TrainConfig(**tc),
                                          fedavg=fedavg)
    out, loss = prog({"params": convert.from_numpy_tree(
        jax.device_get(jparams))},
        {k: torch.from_numpy(np.asarray(v)).long()
         for k, v in jstacked.items()},
        torch.from_numpy(batch_idx), torch.from_numpy(valid),
        torch.from_numpy(w), 1e-3)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    if fedavg:
        jout, out = [jout], [out]
    else:
        jout = [jax.tree.map(lambda a, c=c: a[c], jout) for c in range(C)]
    for jt, t in zip(jout, out):
        want = convert.flatten_tree(jax.device_get(jt))
        assert list(t) == list(want)
        for k in want:
            np.testing.assert_allclose(t[k].numpy(), want[k],
                                       atol=ROUND_ATOL, err_msg=k)
    if fedavg:
        # the same as each client alone through make_train_step, averaged
        step, opt = steps.make_train_step(tcfg, tbase.TrainConfig(**tc),
                                          lr=1e-3)
        outs = []
        for ci in range(C):
            p = convert.from_numpy_tree(jax.device_get(jparams))
            o = opt.init(p)
            for t in range(T if valid[ci, 1] else 1):
                sel = shards[ci][t * B:(t + 1) * B]
                p, o, _ = step(p, o, {
                    "tokens": torch.from_numpy(np.asarray(toks)[sel]).long(),
                    "labels": torch.from_numpy(np.asarray(labs)[sel]).long()})
            outs.append(p)
        want = aggregate.fedavg(outs, torch.from_numpy(w))
        for k in want:
            torch.testing.assert_close(out[0][k], want[k], rtol=0,
                                       atol=ROUND_ATOL)


# --mode lm without --arch: internlm2-1.8b at reduced(), LW-FedSSL over its
# 2 stages, 2 clients of 8 sequences of 32 tokens, batch 4 (2 local steps a
# round), 4 rounds, fp32
LM_ARGS = ["--mode", "lm", "--rounds", "4", "--clients", "2", "--batch", "4",
           "--samples", "16", "--seq-len", "32", "--seed", "0"]
# the reference's zamba2 launcher tolerances (tests/test_torch_fl_lm.py):
# the same math summed in another order through 4 rounds of AdamW; the
# vmap engine batches the same steps
LOSS_RTOL = 2e-6
PARAM_ATOL = 2e-6


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_launcher_default_arch_matches_reference(engine, monkeypatch):
    """``python -m repro_torch.launch.train --mode lm --device cpu`` with
    the default arch against the reference's launcher: the port's tokens
    and initial parameters are replaced by the reference's (its key chain
    ``split(PRNGKey(seed), 3)``); losses, final parameters and wire
    bytes."""
    got = {}
    monkeypatch.setattr(jtrain, "train_lm", lambda args, f=jtrain.train_lm:
                        got.setdefault("ref", f(args)))
    monkeypatch.setattr(sys, "argv", ["train", *LM_ARGS, "--engine", engine])
    jtrain.main()
    jparams, jhist = got["ref"]
    jcfg = jbase.reduced(jbase.load_arch("internlm2-1.8b"))
    kd, ki, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    toks, labs = synthetic_tokens(kd, 16, 32, jcfg.vocab_size)
    init = convert.from_numpy_tree(jax.device_get(jlm.init_lm(ki, jcfg)))
    monkeypatch.setattr(train, "synthetic_tokens", lambda *a: (
        torch.from_numpy(np.asarray(toks)).long(),
        torch.from_numpy(np.asarray(labs)).long()))
    monkeypatch.setattr(lm, "init_lm", lambda *a: dict(init))
    params, hist = train.main([*LM_ARGS, "--engine", engine,
                               "--device", "cpu"])
    assert hist.round_stage == [1, 1, 2, 2]
    np.testing.assert_allclose(hist.loss, jhist, rtol=LOSS_RTOL)
    assert hist.wire_download_bytes == hist.download_bytes
    want = convert.flatten_tree(jax.device_get(jparams))
    assert list(params) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(params[k].numpy(), v, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
