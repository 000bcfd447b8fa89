"""The port's serving path (``lm.init_caches`` / ``decode_step`` /
``prefill``, ``encdec.init_dec_caches`` / ``decode_step`` / ``prefill``,
``launch.steps``' prefill and decode steps) against the JAX package, on
the configs of the reference's ``tests/test_decode_parity.py``: dense GQA,
a sliding window of 8 (a ring buffer that evicts), MLA + MoE, a uniform
Mamba2 stack, the xLSTM, zamba2's hybrid and llama4's interleaved MoE, all
fp32 and tiny; then the encoder-decoder at ``reduced(seamless-m4t-medium)``.
Parameters are the reference's initial ones converted through numpy;
tokens are numpy draws. Each case steps both packages' decoders side by
side and compares the logits at every step and the caches at the end
(the reference's converted with ``convert``), then holds the port's
decode against the port's own full-sequence forward, at the reference
test's tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_decode_parity import CASES

from repro.configs import base as jbase
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import steps
from repro_torch.models import encdec, lm

torch.set_num_threads(2)

JCASES = {**CASES,
          # the reference's test_moe_interleaved_parity: llama4's 1:1
          # interleave, top-1, a capacity factor that admits every token
          "moe_il": jbase.ModelConfig(
              "t", "moe", 4, 64, 4, 2, 128, 97, compute_dtype="float32",
              moe=jbase.MoEConfig(4, 1, 1, 128, capacity_factor=8.0,
                                  moe_every=2))}
# (batch, tokens) stepped: the reference test's
SIZES = {name: (2, 8) if name == "moe_il" else (2, 16) for name in JCASES}
# the two packages step the same math in fp32, summed in another order
# (PyTorch's CPU matmuls and einsums against XLA's); relative to the
# largest value of each compared tensor
STEP_RTOL = 1e-5
# decode against the full-sequence forward: the reference test's absolute
# tolerances (its MoE decode runs every expert densely, the forward the
# capacity dispatch; equal only without dropping, which the configs'
# capacity factors ensure)
FORWARD_ATOL = {"mla": 2e-2}
FORWARD_ATOL_DEFAULT = 2e-3


def port_config(jcfg):
    """The port's copy of a reference ``ModelConfig`` (the same fields)."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(tbase, type(v).__name__)(**vars(v))
        return v
    return tbase.ModelConfig(**{f.name: conv(getattr(jcfg, f.name))
                                for f in dataclasses.fields(jcfg)})


def _close(got, want, rtol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (msg, err, scale)


def _caches_close(tcaches, jcaches, rtol=STEP_RTOL):
    want = convert.flatten_tree(jax.device_get(jcaches))
    assert list(tcaches) == list(want)
    for k, w in want.items():
        t = tcaches[k]
        assert t.dtype == convert.to_tensor(w, "cpu").dtype, k
        if k.rsplit("/", 1)[-1] == "pos":
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
        elif np.all(np.isfinite(w)) and np.abs(w).max() < 1e29:
            _close(t, w, rtol, msg=k)
        else:                       # the mLSTM stabiliser before any step
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _forward_logits(params, tokens, cfg):
    with torch.no_grad():
        hidden, _ = lm.forward_hidden(params, lm.embed(params, tokens, cfg),
                                      cfg)
        return hidden @ lm._head_matrix(params, cfg)


def _step_both(jcfg, tcfg, jparams, tparams, toks, seq_len):
    """Both decoders over ``toks`` (B, S), the logits compared every step;
    returns (the port's logits (B, S, V), its caches, the reference's)."""
    B, S = toks.shape
    jcaches = jlm.init_caches(jcfg, B, seq_len, dtype=jnp.float32)
    tcaches = lm.init_caches(tcfg, B, seq_len, dtype=torch.float32)
    _caches_close(tcaches, jcaches)
    jstep = jax.jit(lambda p, c, t, i: jlm.decode_step(p, c, t, i, jcfg))
    tstep = steps.make_decode_step(tcfg)
    tt = torch.from_numpy(toks).long()
    outs = []
    for t in range(S):
        jl, jcaches = jstep(jparams, jcaches, toks[:, t:t + 1], jnp.int32(t))
        tl, tcaches = tstep(tparams, tcaches, tt[:, t:t + 1], t)
        _close(tl, jax.device_get(jl), STEP_RTOL, msg=f"step {t}")
        outs.append(tl[:, 0])
    return torch.stack(outs, dim=1), tcaches, jcaches


@pytest.mark.parametrize("name", list(JCASES))
def test_decode_matches_reference_and_forward(name):
    jcfg = JCASES[name]
    tcfg = port_config(jcfg)
    jparams = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    tparams = convert.from_numpy_tree(jparams)
    B, S = SIZES[name]
    toks = _tokens(B, S, jcfg.vocab_size)
    dec, tcaches, jcaches = _step_both(jcfg, tcfg, jparams, tparams, toks, S)
    _caches_close(tcaches, jcaches)
    full = _forward_logits(tparams, torch.from_numpy(toks).long(), tcfg)
    err = float((dec - full).abs().max())
    assert err < FORWARD_ATOL.get(name, FORWARD_ATOL_DEFAULT), (name, err)


def test_window_ring_buffer_evicts_and_matches_reference():
    """The window case past its window: the cache holds the window's 8
    slots, not the 24 positions, and every step's logits still match the
    reference's and the windowed forward's."""
    jcfg = CASES["window"]
    tcfg = port_config(jcfg)
    B, S = 1, 24
    jparams = jax.device_get(jlm.init_lm(jax.random.PRNGKey(1), jcfg))
    tparams = convert.from_numpy_tree(jparams)
    toks = _tokens(B, S, jcfg.vocab_size, seed=1)
    caches = lm.init_caches(tcfg, B, S, dtype=torch.float32)
    assert caches["k"].shape == (tcfg.num_layers, B, tcfg.window,
                                 tcfg.num_kv_heads, tcfg.resolved_head_dim)
    dec, tcaches, _ = _step_both(jcfg, tcfg, jparams, tparams, toks, S)
    # the ring holds the last window's positions, slot pos % W
    want_pos = np.arange(S - tcfg.window, S)
    np.testing.assert_array_equal(
        np.sort(tcaches["pos"].numpy(), axis=-1),
        np.broadcast_to(want_pos, (tcfg.num_layers, tcfg.window)))
    full = _forward_logits(tparams, torch.from_numpy(toks).long(), tcfg)
    assert float((dec - full).abs().max()) < FORWARD_ATOL_DEFAULT


@pytest.mark.parametrize("name", ["dense", "zamba", "mla"])
def test_prefill_matches_reference(name):
    jcfg = JCASES[name]
    tcfg = port_config(jcfg)
    jparams = jax.device_get(jlm.init_lm(jax.random.PRNGKey(2), jcfg))
    tparams = convert.from_numpy_tree(jparams)
    toks = _tokens(2, 16, jcfg.vocab_size, seed=2)
    jl, jh = jlm.prefill(jparams, toks, jcfg)
    tl, th = lm.prefill(tparams, torch.from_numpy(toks).long(), tcfg)
    _close(th, jax.device_get(jh), 5e-5, msg="hidden")
    _close(tl, jax.device_get(jl), 5e-5, msg="logits")
    step = steps.make_prefill_step(tcfg)
    assert torch.equal(step(tparams, {"tokens": torch.from_numpy(toks)
                                      .long()}), tl)


ENC_ARCH = "seamless-m4t-medium"
JENC = jbase.reduced(jbase.load_arch(ENC_ARCH))
TENC = tbase.reduced(tbase.load_arch(ENC_ARCH))


@pytest.fixture(scope="module")
def enc_params():
    jparams = jax.device_get(jencdec.init_encdec(jax.random.PRNGKey(0),
                                                 JENC))
    return jparams, convert.from_numpy_tree(jparams)


def test_encdec_decode_matches_reference_and_decode_train(enc_params):
    """The decoder stepped against the encoder memory: the logits of both
    packages every step, the caches at the end, and the port's decode
    against its own ``decode_train`` over the same tokens."""
    jparams, tparams = enc_params
    B, S = 2, 12
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((B, JENC.frontend_embed_len,
                                  JENC.d_model)).astype(np.float32)
    toks = _tokens(B, S, JENC.vocab_size, seed=3)
    jmem = jencdec.encode(jparams, frames, JENC)
    with torch.no_grad():
        tmem = encdec.encode(tparams, torch.from_numpy(frames), TENC)
    _close(tmem, jax.device_get(jmem), 5e-5, msg="memory")
    jcaches = jencdec.init_dec_caches(JENC, B, S, dtype=jnp.float32)
    tcaches = encdec.init_dec_caches(TENC, B, S, dtype=torch.float32)
    _caches_close(tcaches, jcaches)
    jstep = jax.jit(jsteps.make_decode_step(JENC))
    tstep = steps.make_decode_step(TENC)
    tt = torch.from_numpy(toks).long()
    outs = []
    for t in range(S):
        jl, jcaches = jstep(jparams, jcaches, toks[:, t:t + 1], jnp.int32(t),
                            jmem)
        tl, tcaches = tstep(tparams, tcaches, tt[:, t:t + 1], t, tmem)
        _close(tl, jax.device_get(jl), STEP_RTOL, msg=f"step {t}")
        outs.append(tl[:, 0])
    _caches_close(tcaches, jcaches)
    with torch.no_grad():
        full = encdec.decode_train(tparams, tt, tmem, TENC) @ \
            tparams["lm_head"]
    assert float((torch.stack(outs, 1) - full).abs().max()) < \
        FORWARD_ATOL_DEFAULT


def test_encdec_prefill_matches_reference(enc_params):
    jparams, tparams = enc_params
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, JENC.frontend_embed_len,
                                  JENC.d_model)).astype(np.float32)
    toks = _tokens(2, 8, JENC.vocab_size, seed=4)
    jl = jsteps.make_prefill_step(JENC)(jparams, frames, toks)
    tl, tmem = encdec.prefill(tparams, torch.from_numpy(frames),
                              torch.from_numpy(toks).long(), TENC)
    _close(tl, jax.device_get(jl), 5e-5, msg="logits")
    assert tmem.shape == frames.shape
    step = steps.make_prefill_step(TENC)
    assert torch.equal(step(tparams, torch.from_numpy(frames),
                            torch.from_numpy(toks).long()), tl)


def test_decode_needs_no_grad_and_writes_caches_in_place():
    """``decode_step`` builds no autograd graph even from parameters that
    require gradients, and the caches it returns are the ones it was
    given, written in place."""
    tcfg = port_config(CASES["zamba"])
    g = torch.Generator().manual_seed(0)
    params = {k: v.requires_grad_() for k, v in
              lm.init_lm(tcfg, g).items()}
    caches = lm.init_caches(tcfg, 2, 4)
    before = {k: v.clone() for k, v in caches.items()}
    ptrs = {k: v.data_ptr() for k, v in caches.items()}
    token = torch.zeros((2, 1), dtype=torch.long)
    logits, out = lm.decode_step(params, caches, token, 0, tcfg)
    assert out is caches and not logits.requires_grad
    assert {k: v.data_ptr() for k, v in out.items()} == ptrs
    assert not torch.equal(out["attn/pos"], before["attn/pos"])
    assert not torch.equal(out["mamba/h"], before["mamba/h"])
