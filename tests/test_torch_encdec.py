"""The port's encoder-decoder (``models/encdec.py``, the ``cross`` block kind
and cross attention, ``launch.steps``' encoder-decoder branch) against the
JAX package, at ``reduced(seamless-m4t-medium)``: 2 encoder + 2 decoder
layers, d 256, 4 q heads over 2 kv heads of 64, SwiGLU d_ff 512, 16 frame
embeddings from the frontend stub, fp32 compute. Parameters are the
reference's ``init_encdec`` converted through numpy; inputs are numpy
draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import base as jbase
from repro.core import schedule as jsched
from repro.data.partition import stack_shards as jstack_shards
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro.models.layers import attention as jattn
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as tssl
from repro_torch.launch import steps
from repro_torch.models import encdec
from repro_torch.models.layers import attention

torch.set_num_threads(2)

ARCH = "seamless-m4t-medium"
JCFG = jbase.reduced(jbase.load_arch(ARCH))
TCFG = tbase.reduced(tbase.load_arch(ARCH))
# fp32 on both sides through 2 encoder and 2 decoder blocks: the same math
# summed in another order (PyTorch's CPU matmuls and attention against
# XLA's); relative to the largest value of each compared tensor
RTOL = 5e-5
GRAD_RTOL = 2e-4


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jencdec.init_encdec(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def tparams(jparams):
    return convert.from_numpy_tree(jparams)


def _close(got, want, rtol=RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (msg, err, scale)


# AdamW divides each element's gradient by its own running root mean square,
# so an element whose (microbatch-summed) gradient lies within the fp32
# noise of 0 (about 2e-6 of its leaf's largest gradient, measured) takes
# another fraction of the rate in each package: at this size up to 7
# elements of a leaf move more than 1e-5 apart, the largest 1.3e-4 (0.13 of
# the rate 1e-3). The optimizer's results are held leaf by leaf: the
# relative L2 difference of the updates (measured at most 4.9e-4) to 2e-3,
# and every element to one rate
UPDATE_RTOL = 2e-3


def _updates_close(got, want, init, lr, msg=""):
    du = got.detach().numpy() - init
    dw = np.asarray(want) - init
    assert float(np.abs(du - dw).max()) <= lr, msg
    assert np.linalg.norm(du - dw) <= UPDATE_RTOL * np.linalg.norm(dw), msg


def _batch(B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)
    return {"frontend": rng.standard_normal(
        (B, JCFG.frontend_embed_len, JCFG.d_model)).astype(np.float32),
        "tokens": tok, "labels": np.roll(tok, -1, axis=1)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _glob(jparams, seed=9):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        jparams)


def test_config_copy_matches_reference():
    full_t, full_j = tbase.load_arch(ARCH), jbase.load_arch(ARCH)
    for f in ("num_layers", "dec_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "family", "act",
              "cross_attention", "frontend_embed_len", "tie_embeddings",
              "param_dtype", "compute_dtype", "norm_eps"):
        assert getattr(full_t, f) == getattr(full_j, f), f
    assert ARCH in tbase.ARCH_IDS
    assert tssl.is_encdec(TCFG) and jsteps.is_encdec(JCFG)
    assert tssl.lm_stages(TCFG) == 2 and tssl.lm_stages(full_t) == 12


def test_init_encdec_shapes_and_converted_parameters(jparams, tparams):
    """The reference's tree converts to the port's flat dict in
    ``jax.tree_util`` order and back bit for bit; the port's own
    ``init_encdec`` has the same leaves, shapes and dtypes, and the
    reference's spread."""
    flat_ref = [p for p, _ in
                jax.tree_util.tree_flatten_with_path(jparams)[0]]
    keys = ["/".join(str(getattr(k, "key", k)) for k in p) for p in flat_ref]
    assert list(tparams) == keys
    assert list(encdec.encdec_shapes(TCFG)) == keys
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_numpy_tree(
            tparams)), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    mine = encdec.init_encdec(TCFG, torch.Generator().manual_seed(0))
    assert list(mine) == keys
    for k, v in tparams.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
        if k.endswith("scale"):
            assert bool((mine[k] == 1).all()) and bool((v == 1).all()), k
    for k in ("dec_blocks/xattn/wk", "dec_blocks/mlp/w_gate",
              "enc_blocks/attn/wq", "embed", "lm_head"):
        assert abs(float(mine[k].std()) / float(tparams[k].std()) - 1) \
            < 0.05, k


def test_fl_state_checkpoints_cross_load_with_reference(jparams, tparams,
                                                        tmp_path):
    """The tree through ``checkpoint.save_fl_state`` / ``load_fl_state``:
    written by the port and read by the reference, and the other way, bit
    for bit, with the round and meta."""
    tckpt.save_fl_state(tmp_path / "port", tparams, 5, {"arch": ARCH})
    jgot, jrnd, jmeta = jckpt.load_fl_state(
        tmp_path / "port", jax.tree.map(jnp.zeros_like, jparams))
    assert jrnd == 5 and jmeta["arch"] == ARCH
    assert jax.tree_util.tree_structure(jgot) == \
        jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(jgot),
                    jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_fl_state(tmp_path / "ref", jparams, 3)
    got, rnd, _ = tckpt.load_fl_state(
        tmp_path / "ref", {k: torch.zeros_like(v) for k, v in tparams.items()})
    assert rnd == 3 and list(got) == list(tparams)
    for k, v in tparams.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_cross_attn_apply_matches_reference(jparams, tparams):
    """24 queries over 16 keys, 4 q heads over 2 kv heads, non-causal, no
    RoPE: value and the gradients w.r.t. the queries' stream, the memory
    and the four weights."""
    jp = jax.tree.map(lambda a: a[1], jparams["dec_blocks"]["xattn"])
    tp = {k: v[1] for k, v in convert.subtree(tparams,
                                              "dec_blocks/xattn").items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, JCFG.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 16, JCFG.d_model)).astype(np.float32)
    want, pull = jax.vjp(lambda p, x, m: jattn.cross_attn_apply(p, x, m,
                                                                JCFG),
                         jp, jnp.asarray(x), jnp.asarray(mem))
    g = rng.standard_normal(want.shape).astype(np.float32)
    jgp, jgx, jgm = pull(jnp.asarray(g))
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt, mt = (torch.from_numpy(a).requires_grad_() for a in (x, mem))
    got = attention.cross_attn_apply(p, xt, mt, TCFG)
    _close(got, want, msg="value")
    grads = torch.autograd.grad((got * torch.from_numpy(g)).sum(),
                                [xt, mt, *p.values()])
    _close(grads[0], jgx, GRAD_RTOL, msg="dx")
    _close(grads[1], jgm, GRAD_RTOL, msg="dmemory")
    for k, gk in zip(p, grads[2:]):
        _close(gk, jgp[k], GRAD_RTOL, msg=k)


@pytest.mark.parametrize("sub_layers,active_from", [(None, 0), (1, 0),
                                                     (2, 1)])
def test_encode_decode_and_loss_match_reference(jparams, tparams,
                                                sub_layers, active_from):
    """``encode`` with a frozen prefix (no gradient reaches it), then
    ``decode_train`` through every decoder block and ``encdec_loss``: the
    memory, the hidden states, the loss and every leaf's gradient."""
    batch = _batch(seed=2)
    tb = _torch_batch(batch)
    kw = dict(sub_layers=sub_layers, active_from=active_from)
    jmem = jencdec.encode(jparams, batch["frontend"], JCFG, **kw)
    mem = encdec.encode(tparams, tb["frontend"], TCFG, **kw)
    _close(mem, jmem, msg="memory")
    _close(encdec.decode_train(tparams, tb["tokens"], mem, TCFG),
           jencdec.decode_train(jparams, batch["tokens"], jmem, JCFG),
           msg="hidden")
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jencdec.encdec_loss(p, batch, JCFG, **kw),
        has_aux=True)(jparams)
    p = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    loss, m = encdec.encdec_loss(p, tb, TCFG, **kw)
    _close(loss, jl, 1e-5)
    assert set(m) == set(jm) and float(m["aux"]) == 0.0
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    jflat = convert.flatten_tree(jax.device_get(jg))
    for (k, v), g in zip(p.items(), grads):
        g = torch.zeros_like(v) if g is None else g
        if k.startswith("enc_blocks/") and active_from:
            assert not g[:active_from].any(), k
        _close(g, jflat[k], GRAD_RTOL, msg=k)


def test_train_step_microbatch_remat_matches_reference(jparams):
    """``make_train_step`` in ``train_lw`` mode (the last encoder block
    trained, the alignment on the mean-pooled encoder memory) with 2
    microbatches and remat, two steps, against the reference's; and remat
    changes the port's result only by the recomputed gradients' rounding
    (held as the two packages are)."""
    kw = dict(microbatch=2, remat=True, batch_size=4)
    jstep, jopt = jsteps.make_train_step(JCFG, jbase.TrainConfig(**kw),
                                         mode="train_lw", lr=1e-3)
    glob = _glob(jparams)
    batches = [_batch(B=4, seed=s) for s in (3, 4)]
    jp, jo = jparams, jopt.init(jparams)
    for b in batches:
        jp, jo, jm = jstep(jp, jo, b, glob)
    runs = {}
    for remat in (True, False):
        step, opt = steps.make_train_step(
            TCFG, tbase.TrainConfig(**{**kw, "remat": remat}),
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
    init = convert.flatten_tree(jparams)
    assert list(p) == list(want)
    for k in want:
        _updates_close(p[k], want[k], init[k], 1e-3, k)
        _updates_close(runs[False][0][k], p[k].numpy(), init[k], 1e-3, k)


@pytest.mark.parametrize("sub_layers,active_from,align", [(1, 0, False),
                                                          (2, 1, True)])
def test_fl_round_program_matches_reference(jparams, sub_layers,
                                            active_from, align):
    """Two clients, two local steps (the second client's second padded),
    at LW-FedSSL's stage 1 and stage 2 (with the alignment): each client's
    tree (``fedavg=False``) and the last losses equal the reference's round
    program's. The stage's row range selects rows of ``dec_blocks`` as of
    any stacked leaf, although every decoder block runs and gets a
    gradient: the decoder rows outside the stage keep the broadcast's
    values, to the bit, in both packages."""
    tc = dict(batch_size=2, base_lr=1e-3)
    pools = [_batch(B=8, seed=s) for s in (5, 6)]
    pool = {k: np.concatenate([b[k] for b in pools]) for k in pools[0]}
    shards = [np.arange(0, 8), np.arange(8, 16)]
    jstacked, _ = jstack_shards({k: jnp.asarray(v) for k, v in pool.items()},
                                [jnp.asarray(s) for s in shards])
    C, T, B = 2, 2, 2
    batch_idx = np.stack([[np.arange(0, B), np.arange(B, 2 * B)]] * C)
    valid = np.array([[True, True], [True, False]])
    w = np.array([0.6, 0.4], np.float32)
    glob = _glob(jparams, seed=10)
    kw = dict(sub_layers=sub_layers, active_from=active_from, align=align,
              fedavg=False)
    jprog, _ = jsteps.make_fl_round_program(JCFG, jbase.TrainConfig(**tc),
                                            **kw)
    jout, jloss = jprog({"params": jparams, "global_params": glob},
                        jstacked, jnp.asarray(batch_idx),
                        jnp.zeros((C, T, 2), jnp.uint32), jnp.asarray(valid),
                        jnp.asarray(w), jnp.float32(1e-3))
    prog, _ = steps.make_fl_round_program(TCFG, tbase.TrainConfig(**tc),
                                          **kw)
    outs, loss = prog(
        {"params": convert.from_numpy_tree(jparams),
         "global_params": convert.from_numpy_tree(jax.device_get(glob))},
        _torch_batch({k: np.asarray(v) for k, v in jstacked.items()}),
        torch.from_numpy(batch_idx), torch.from_numpy(valid),
        torch.from_numpy(w), 1e-3)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    jflat = convert.flatten_tree(jax.device_get(jout))
    init = convert.flatten_tree(jparams)
    for c, out in enumerate(outs):
        assert list(out) == list(jflat)
        for k, v in jflat.items():
            _updates_close(out[k], v[c], init[k], 1e-3, k)
            if not k.startswith("dec_blocks/"):
                continue
            for row in range(v.shape[1]):
                kept = not active_from <= row < sub_layers
                assert np.array_equal(out[k][row].numpy(),
                                      init[k][row]) == kept, (k, row)
                assert np.array_equal(v[c, row], init[k][row]) == kept


def test_transfer_model_moves_encoder_rows_only(jparams, tparams):
    """``transfer_model`` copies the encoder's row s-2 into s-1 at stage s,
    as the reference does, and leaves ``dec_blocks`` alone."""
    for stage in (1, 2):
        want = convert.flatten_tree(jax.device_get(jsched.transfer_model(
            jax.tree.map(jnp.asarray, jparams), JCFG, stage)))
        got = sched.transfer_model(tparams, stage)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    got = sched.transfer_model(tparams, 2)
    for k, v in got.items():
        if k.startswith("enc_blocks/"):
            torch.testing.assert_close(v[1], tparams[k][0], rtol=0, atol=0)
        else:
            assert v is tparams[k], k
