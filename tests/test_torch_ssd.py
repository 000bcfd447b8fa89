"""The port's Mamba2 SSD scan against the JAX package.

The plain version (``kernels.ref.ssd_scan_ref``: the CPU path, and what
``chip_smoke.py`` holds the CUDA kernel against) is compared with the
Pallas kernel in interpret mode, the reference's oracle and the Mamba2
layer's own ``ssd_chunked`` (final state and an incoming state included);
``ops.SSDScanFn``'s gradients with ``jax.grad`` of ``ssd_chunked``, and its
``vmap`` rule with a loop over clients. Inputs are numpy draws from a seed,
fp32, drawn as the reference's ``tests/test_kernels.py`` draws them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import mamba2 as jmamba
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import mamba2

torch.set_num_threads(2)

# fp32 on both sides: the same sums in another order (the intra-chunk
# products over up to 128 terms, the cumulative log-decay inside exp),
# relative to the largest output
RTOL = 2e-5


def _inputs(rng, B, S, H, P, N):
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H)) * 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


# the shapes of the reference's tests/test_kernels.py::test_ssd_scan, plus
# a chunk that is the whole sequence
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 256, 4, 64, 64, 128),
    (1, 128, 2, 32, 16, 64),
    (1, 512, 8, 64, 64, 128),
    (1, 96, 3, 16, 8, 96),
])
def test_plain_scan_matches_pallas_kernel(B, S, H, P, N, chunk):
    xh, dt, A, Bm, Cm = _inputs(np.random.default_rng(S + H), B, S, H, P, N)
    a = dt * A
    want = jops.ssd_scan(xh, dt, a, Bm, Cm, chunk=chunk, interpret=True)
    oracle = jref.ssd_scan_ref(xh, dt, a, Bm, Cm, chunk=chunk)
    got = ref.ssd_scan_ref(*_t(xh, dt, a, Bm, Cm), chunk=chunk)
    _close(got, want)
    _close(got, oracle)
    # the wrapper's CPU path is the plain version
    torch.testing.assert_close(ops.ssd_scan(*_t(xh, dt, a, Bm, Cm),
                                            chunk=chunk), got, rtol=0,
                               atol=0)


@pytest.mark.parametrize("with_h0", [False, True])
def test_layer_scan_matches_reference_with_state(with_h0):
    rng = np.random.default_rng(5)
    B, S, H, P, N = 2, 256, 4, 32, 16
    xh, dt, A, Bm, Cm = _inputs(rng, B, S, H, P, N)
    h0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_h0 else None)
    want_y, want_h = jmamba.ssd_chunked(xh, dt, A, Bm, Cm, 64, h0)
    got_y, got_h = mamba2.ssd_chunked(
        *_t(xh, dt, A, Bm, Cm), 64, None if h0 is None else _t(h0)[0])
    _close(got_y, want_y)
    _close(got_h, want_h)
    # the kernel's contract: the layer's scan with no incoming state
    if not with_h0:
        _close(ops.ssd_scan(*_t(xh, dt, dt * A, Bm, Cm), chunk=64), want_y)


def test_scan_gradients_match_jax_grad():
    """``SSDScanFn`` (a = dt * A formed outside it, as ``mamba2_apply``
    does) against ``jax.grad`` of the layer's ``ssd_chunked``, with
    respect to xh, dt, A, Bm and Cm, under a random cotangent."""
    rng = np.random.default_rng(11)
    B, S, H, P, N, chunk = 2, 128, 3, 16, 8, 32
    xh, dt, A, Bm, Cm = _inputs(rng, B, S, H, P, N)
    g = rng.standard_normal((B, S, H, P)).astype(np.float32)

    def jloss(xh, dt, A, Bm, Cm):
        return jnp.sum(jmamba.ssd_chunked(xh, dt, A, Bm, Cm, chunk)[0] * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(xh, dt, A, Bm, Cm)
    args = [t.requires_grad_() for t in _t(xh, dt, A, Bm, Cm)]
    y = ops.ssd_scan(args[0], args[1], args[1] * args[2], args[3], args[4],
                     chunk=chunk)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), args)
    for gg, ww in zip(got, want):
        _close(gg, ww, rtol=5e-5)


def test_vmap_rule_matches_client_loop():
    """``torch.func.vmap`` over ``grad_and_value`` of the scan (its ``vmap``
    rule folds the client axis into the batch, one call) equals a loop over
    the clients; Bm is shared by the clients (not vmapped)."""
    rng = np.random.default_rng(2)
    C, B, S, H, P, N, chunk = 3, 2, 64, 2, 8, 4, 16
    xh, dt, A, Bm, Cm = _inputs(rng, C * B, S, H, P, N)
    a = dt * A
    args = [torch.from_numpy(v.reshape(C, B, *v.shape[1:]))
            for v in (xh, dt, a)] + [torch.from_numpy(Bm[:B])] + \
        [torch.from_numpy(Cm.reshape(C, B, S, N))]
    in_dims = (0, 0, 0, None, 0)

    def loss(*t):
        return (ops.ssd_scan(*t, chunk=chunk) ** 2).sum()

    step = torch.func.grad_and_value(loss, argnums=(0, 1, 2, 3, 4))
    grads, values = torch.func.vmap(step, in_dims=in_dims)(*args)
    for c in range(C):
        one = [t[c] if d is not None else t for t, d in zip(args, in_dims)]
        want_g, want_v = step(*one)
        torch.testing.assert_close(values[c], want_v, rtol=1e-6, atol=1e-6)
        for got, want in zip(grads, want_g):
            torch.testing.assert_close(got[c], want, rtol=1e-6, atol=1e-6)


def test_scan_rejects_a_chunk_that_does_not_divide_s():
    xh, dt, A, Bm, Cm = _inputs(np.random.default_rng(0), 1, 48, 2, 4, 4)
    with pytest.raises(ValueError, match="does not divide"):
        ops.ssd_scan(*_t(xh, dt, dt * A, Bm, Cm), chunk=32)


# the decomposition the CUDA kernels carry out (C.B^T per chunk, chunk
# states, the states entering each chunk, chunk outputs), with fp32
# products and with the products emulating the card's 3xTF32 split; nc >= 3
# and P, N < 64 among the shapes
@pytest.mark.parametrize("mm", ["fp32", "3xtf32"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 256, 4, 64, 64, 64),
    (1, 384, 3, 32, 16, 128),
    (1, 200, 2, 20, 7, 40),
    (1, 256, 2, 64, 64, 256),
])
def test_decomposed_scan_matches_pallas_kernel(B, S, H, P, N, chunk, mm):
    xh, dt, A, Bm, Cm = _inputs(np.random.default_rng(S + P), B, S, H, P, N)
    a = dt * A
    want = jops.ssd_scan(xh, dt, a, Bm, Cm, chunk=chunk, interpret=True)
    got = ref.ssd_decomposed(*_t(xh, dt, a, Bm, Cm), chunk=chunk,
                             mm=torch.matmul if mm == "fp32"
                             else ref.matmul_3xtf32)
    _close(got, want)
    _close(got, ref.ssd_scan_ref(*_t(xh, dt, a, Bm, Cm), chunk=chunk))


def test_decomposed_states_match_the_layer_scan():
    """The states entering each chunk, carried one chunk further, are the
    final state of the reference layer's ``ssd_chunked``."""
    rng = np.random.default_rng(9)
    B, S, H, P, N, chunk = 2, 192, 3, 16, 8, 64
    xh, dt, A, Bm, Cm = _inputs(rng, B, S, H, P, N)
    _, want_h = jmamba.ssd_chunked(xh, dt, A, Bm, Cm, chunk, None)
    txh, tdt, tA, tBm = _t(xh, dt, A, Bm)
    cum = ref.ssd_chunk_cumsum(tdt * tA, chunk)
    st = ref.ssd_chunk_state(txh, tdt, cum, tBm, chunk)
    h_in = ref.ssd_state_pass(st, cum)
    assert h_in.shape == (B, H, S // chunk, P, N)
    assert float(h_in[:, :, 0].abs().max()) == 0.0
    last = h_in[:, :, -1] * torch.exp(cum[:, :, -1, -1])[..., None, None] \
        + st[:, :, -1]
    _close(last, want_h)


@pytest.mark.parametrize("what", ["C.B^T", "M.x"])
def test_3xtf32_split_product_keeps_fp32_accuracy(what):
    """The 3xTF32 split at the LM scan's widths (N = 64, chunk Q = 256, P =
    64) stays within 1e-5 of the largest float64 value, as a plain fp32
    product does; one TF32 product (the hi parts alone) does not."""
    rng = np.random.default_rng(4)
    Q, N, P = 256, 64, 64
    if what == "C.B^T":
        a = rng.standard_normal((Q, N)).astype(np.float32)
        b = rng.standard_normal((N, Q)).astype(np.float32)
    else:   # the masked, decayed intra-chunk matrix times x
        cb = rng.standard_normal((Q, Q)) * np.sqrt(N)
        cum = np.cumsum(-np.log1p(np.exp(rng.standard_normal(Q))) * 0.1)
        decay = np.exp(np.minimum(cum[:, None] - cum[None, :], 0.0))
        a = np.tril(cb * decay).astype(np.float32)
        b = rng.standard_normal((Q, P)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = float(np.abs(exact).max())
    split = ref.matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b))
    fp32 = torch.from_numpy(a) @ torch.from_numpy(b)
    one = ref.tf32_round(torch.from_numpy(a)) @ \
        ref.tf32_round(torch.from_numpy(b))
    assert float(np.abs(split.double().numpy() - exact).max()) \
        <= 1e-5 * scale
    assert float(np.abs(fp32.double().numpy() - exact).max()) <= 1e-5 * scale
    assert float(np.abs(one.double().numpy() - exact).max()) > 1e-5 * scale


def test_tf32_round_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -11, 3.0, 0.0])
    want = [1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10), 1.0 + 2 ** -9, 3.0, 0.0]
    assert ref.tf32_round(x).tolist() == want


# ---------------------------------------------------------------------------
# the prefill hand-off: an entering state and the final state
# ---------------------------------------------------------------------------
def test_scan_with_state_matches_reference_and_its_gradients():
    """``ops.ssd_scan(h0=..., return_state=True)`` against the layer's
    ``ssd_chunked`` with an incoming state: y and the final state, then
    the gradients of <y, gy> + <h, gh> w.r.t. xh, dt, A, Bm, Cm and h0
    against ``jax.grad``."""
    rng = np.random.default_rng(21)
    B, S, H, P, N, chunk = 2, 128, 3, 16, 8, 32
    xh, dt, A, Bm, Cm = _inputs(rng, B, S, H, P, N)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def jloss(xh, dt, A, Bm, Cm, h0):
        y, h = jmamba.ssd_chunked(xh, dt, A, Bm, Cm, chunk, h0)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    want_y, want_h = jmamba.ssd_chunked(xh, dt, A, Bm, Cm, chunk, h0)
    want = jax.grad(jloss, argnums=tuple(range(6)))(xh, dt, A, Bm, Cm, h0)
    args = [t.requires_grad_() for t in _t(xh, dt, A, Bm, Cm, h0)]
    y, h = ops.ssd_scan(args[0], args[1], args[1] * args[2], args[3],
                        args[4], chunk=chunk, h0=args[5], return_state=True)
    _close(y.detach(), want_y)
    _close(h.detach(), want_h)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                              + (h * torch.from_numpy(gh)).sum(), args)
    for gg, ww in zip(got, want):
        _close(gg, ww, rtol=5e-5)


@pytest.mark.parametrize("mm", ["fp32", "3xtf32"])
def test_decomposed_scan_with_state_matches_reference(mm):
    """The kernels' decomposition (``ref.ssd_decomposed``) from an
    ``h0``: y and the final state against the layer's scan."""
    rng = np.random.default_rng(23)
    B, S, H, P, N, chunk = 2, 192, 3, 16, 8, 64
    xh, dt, A, Bm, Cm = _inputs(rng, B, S, H, P, N)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    want_y, want_h = jmamba.ssd_chunked(xh, dt, A, Bm, Cm, chunk, h0)
    txh, tdt, tA, tBm, tCm, th0 = _t(xh, dt, A, Bm, Cm, h0)
    y, h = ref.ssd_decomposed(
        txh, tdt, tdt * tA, tBm, tCm, chunk=chunk, h0=th0,
        return_state=True,
        mm=ref.matmul_3xtf32 if mm == "3xtf32" else torch.matmul)
    _close(y, want_y)
    _close(h, want_h)


def test_vmap_rule_with_state_matches_client_loop():
    """The ``vmap`` rule with an ``h0`` per client and both outputs."""
    rng = np.random.default_rng(4)
    C, B, S, H, P, N, chunk = 2, 2, 32, 2, 8, 4, 16
    xh, dt, A, Bm, Cm = _inputs(rng, C * B, S, H, P, N)
    h0 = rng.standard_normal((C, B, H, P, N)).astype(np.float32)
    args = [torch.from_numpy(v.reshape(C, B, *v.shape[1:]))
            for v in (xh, dt, dt * A, Bm, Cm)] + [torch.from_numpy(h0)]

    def run(*t):
        return ops.ssd_scan(*t[:5], chunk=chunk, h0=t[5], return_state=True)

    ys, hs = torch.func.vmap(run)(*args)
    for c in range(C):
        y, h = run(*(t[c] for t in args))
        torch.testing.assert_close(ys[c], y, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(hs[c], h, rtol=1e-6, atol=1e-6)


def _mamba_layer(seed=0):
    """One Mamba2 block of zamba2 at the arch smoke test's reduction: the
    reference's initialiser, converted through numpy."""
    from repro.configs import base as jbase
    from repro_torch import convert
    from repro_torch.configs import base as tbase
    jcfg = jbase.reduced(jbase.load_arch("zamba2-2.7b"), num_layers=4,
                         attn_every=2)
    tcfg = tbase.reduced(tbase.load_arch("zamba2-2.7b"), num_layers=4,
                         attn_every=2)
    jp = jax.device_get(jmamba.mamba2_init(jax.random.PRNGKey(seed), jcfg,
                                           jnp.float32))
    return jp, convert.from_numpy_tree(jp), jcfg, tcfg


def test_mamba2_apply_state_hand_off_matches_reference():
    """``mamba2_apply(..., h0, conv0, return_state=True)`` against the
    reference's: a 128-token prompt as two 64-token parts, the first
    part's (h_final, conv) handed to the second as ``h0`` / ``conv0``;
    the outputs and both states of both parts."""
    jp, tp, jcfg, tcfg = _mamba_layer()
    x = np.random.default_rng(8).standard_normal(
        (2, 128, jcfg.d_model)).astype(np.float32)
    jy1, (jh1, jc1) = jmamba.mamba2_apply(jp, jnp.asarray(x[:, :64]), jcfg,
                                          return_state=True)
    jy2, (jh2, jc2) = jmamba.mamba2_apply(jp, jnp.asarray(x[:, 64:]), jcfg,
                                          jh1, jc1, return_state=True)
    ty1, (th1, tc1) = mamba2.mamba2_apply(tp, torch.from_numpy(x[:, :64]),
                                          tcfg, return_state=True)
    ty2, (th2, tc2) = mamba2.mamba2_apply(tp, torch.from_numpy(x[:, 64:]),
                                          tcfg, th1, tc1, return_state=True)
    for got, want in ((ty1, jy1), (th1, jh1), (tc1, jc1), (ty2, jy2),
                      (th2, jh2), (tc2, jc2)):
        _close(got.detach(), want, rtol=5e-5)


def test_reference_ignores_conv0_and_the_port_matches():
    """The reference's fault, kept: ``conv0`` is never read (the causal
    convolution pads the sequence's start with zeros), so the second part
    of a two-part prefill is the same with or without it, and it differs
    from one pass over the whole prompt in its first K - 1 positions (and,
    through the scan, by a decaying amount after them). The port gives the
    same numbers as the reference both ways."""
    jp, tp, jcfg, tcfg = _mamba_layer(1)
    K = jcfg.ssm.conv_width
    x = np.random.default_rng(9).standard_normal(
        (2, 128, jcfg.d_model)).astype(np.float32)
    _, (jh1, jc1) = jmamba.mamba2_apply(jp, jnp.asarray(x[:, :64]), jcfg,
                                        return_state=True)
    with_conv = jmamba.mamba2_apply(jp, jnp.asarray(x[:, 64:]), jcfg, jh1,
                                    jc1)
    no_conv = jmamba.mamba2_apply(jp, jnp.asarray(x[:, 64:]), jcfg, jh1,
                                  None)
    assert np.array_equal(np.asarray(with_conv), np.asarray(no_conv))
    whole = np.asarray(jmamba.mamba2_apply(jp, jnp.asarray(x), jcfg))[:, 64:]
    head = np.abs(np.asarray(with_conv)[:, :K - 1] - whole[:, :K - 1]).max()
    assert head > 1e-3 * np.abs(whole).max(), head
    _, (th1, tc1) = mamba2.mamba2_apply(tp, torch.from_numpy(x[:, :64]),
                                        tcfg, return_state=True)
    got = mamba2.mamba2_apply(tp, torch.from_numpy(x[:, 64:]), tcfg, th1,
                              tc1)
    _close(got.detach(), with_conv, rtol=5e-5)
    twhole = mamba2.mamba2_apply(tp, torch.from_numpy(x), tcfg)[:, 64:]
    _close(twhole.detach(), whole, rtol=5e-5)
