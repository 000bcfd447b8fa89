"""The port's InfoNCE (``kernels.ops.info_nce_rows`` and the loss that uses
it) against the JAX package.

The plain versions (``kernels.ref.info_nce_rows_ref`` /
``info_nce_rows_bwd_ref``: the CPU path, and what ``chip_smoke.py`` holds
the CUDA kernels against) are compared with the Pallas kernel in interpret
mode and with ``jax.grad`` / ``jax.vjp`` of the reference's formulas;
``InfoNCEFn`` and ``losses.info_nce`` with the eager formula the port's
loss used before. Inputs are numpy draws from a seed, fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.kernels import infonce as jnce
from repro.kernels import ref as jref
from repro_torch.core import losses
from repro_torch.kernels import ops, ref

# fp32 throughout: the same sums in another order
TOL = 1e-5


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("tau", [0.1, 0.2])
@pytest.mark.parametrize("d", [64, 192, 256])
@pytest.mark.parametrize("B", [128, 256])
def test_plain_rows_match_pallas_kernel(B, d, tau):
    rng = np.random.default_rng(B + d)
    q, k = _unit(rng, (B, d)), _unit(rng, (B, d))
    want = jnce.info_nce_rows(jnp.asarray(q), jnp.asarray(k), tau,
                              interpret=True)
    got, lse = ref.info_nce_rows_ref(_t(q), _t(k), tau)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    logits = (q.astype(np.float64) @ k.T.astype(np.float64)) / tau
    np.testing.assert_allclose(
        lse.numpy(), np.log(np.exp(logits).sum(-1)), rtol=TOL)


def test_ragged_rows_with_client_axis_match_reference_oracle():
    """B = 96 (no 128-row tile), d = 200, three clients: each client's
    rows against that client's negatives only."""
    rng = np.random.default_rng(7)
    q, k = _unit(rng, (3, 96, 200)), _unit(rng, (3, 96, 200))
    got, _ = ref.info_nce_rows_ref(_t(q), _t(k), 0.2)
    for c in range(3):
        want = jref.info_nce_rows_ref(jnp.asarray(q[c]), jnp.asarray(k[c]),
                                      0.2)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("wrt_k", [False, True])
def test_plain_backward_matches_jax_vjp(wrt_k):
    """dq / dk of sum(g * rows) against ``jax.vjp`` of the reference's
    per-row oracle, with per-row upstream gradients g."""
    rng = np.random.default_rng(11)
    q, k = _unit(rng, (2, 256, 192)), _unit(rng, (2, 256, 192))
    g = rng.standard_normal((2, 256)).astype(np.float32)
    _, lse = ref.info_nce_rows_ref(_t(q), _t(k), 0.2)
    got = ref.info_nce_rows_bwd_ref(_t(q), _t(k), lse, _t(g), 0.2, wrt_k)
    for c in range(2):
        _, vjp = jax.vjp(lambda a, b: jref.info_nce_rows_ref(a, b, 0.2),
                         jnp.asarray(q[c]), jnp.asarray(k[c]))
        want = vjp(jnp.asarray(g[c]))[int(wrt_k)]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                   atol=TOL * scale)


@pytest.mark.parametrize("tau", [0.1, 0.2])
def test_loss_gradients_match_jax_grad(tau):
    """The port's ``losses.info_nce`` (normalisation in PyTorch, then the
    kernel's Function) against ``jax.grad`` of the reference's
    ``losses.info_nce`` without stop-gradient, on unnormalised inputs."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((256, 256)).astype(np.float32)
    k = rng.standard_normal((256, 256)).astype(np.float32)
    want_loss, want = jax.value_and_grad(jlosses.info_nce, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(k), tau)
    tq, tk = _t(q).requires_grad_(), _t(k).requires_grad_()
    loss = losses.info_nce(tq, tk, tau)
    got = torch.autograd.grad(loss, (tq, tk))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=TOL * float(np.abs(b).max()))


def _eager_rows(q, k, tau):
    """The eager formula ``losses.info_nce`` used before the kernel."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / tau
    return torch.logsumexp(logits, -1) - torch.diagonal(logits, 0, -2, -1)


@pytest.mark.parametrize("shape", [(64, 32), (3, 40, 24)])
def test_info_nce_fn_matches_eager_formula(shape):
    rng = np.random.default_rng(5)
    q, k = _t(_unit(rng, shape)), _t(_unit(rng, shape))
    g = _t(rng.standard_normal(shape[:-1]).astype(np.float32))
    got_q, got_k = q.clone().requires_grad_(), k.clone().requires_grad_()
    got = ops.info_nce_rows(got_q, got_k, 0.2)
    want_q, want_k = q.clone().requires_grad_(), k.clone().requires_grad_()
    want = _eager_rows(want_q, want_k, 0.2)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        torch.autograd.grad(got, (got_q, got_k), g),
        torch.autograd.grad(want, (want_q, want_k), g), rtol=TOL, atol=TOL)


def test_detached_negatives_skip_the_dk_gradient(monkeypatch):
    """The main path detaches every negative, so its backward computes dq
    only: the dk gradient is not asked for."""
    asked = []
    bwd = ref.info_nce_rows_bwd_ref
    monkeypatch.setattr(ref, "info_nce_rows_bwd_ref",
                        lambda *a: asked.append(a[-1]) or bwd(*a))
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((32, 16)).astype(np.float32)).requires_grad_()
    k = _t(rng.standard_normal((32, 16)).astype(np.float32))
    losses.moco_contrastive(q, k, q, k, 0.2).backward()
    assert asked == [False, False] and q.grad is not None


# the CUDA kernels' split and combine (partial q.k^T per 256-wide d slice,
# summed in slice order, then the rows' max, sum and gold logit), against
# the Pallas kernel; (4, 2560) is the LM path's alignment term, one tile
@pytest.mark.parametrize("B,d,block", [(4, 2560, 4), (256, 256, 128),
                                       (128, 600, 128), (8, 7, 8)])
def test_split_rows_match_pallas_kernel(B, d, block):
    rng = np.random.default_rng(B + d)
    q, k = _unit(rng, (B, d)), _unit(rng, (B, d))
    want = jnce.info_nce_rows(jnp.asarray(q), jnp.asarray(k), 0.2, br=block,
                              bc=block, interpret=True)
    got, lse = ref.info_nce_rows_split(_t(q), _t(k), 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    _, want_lse = ref.info_nce_rows_ref(_t(q), _t(k), 0.2)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=TOL)


@pytest.mark.parametrize("wrt_k", [False, True])
@pytest.mark.parametrize("C,B,d", [(1, 4, 2560), (2, 96, 300)])
def test_split_gradients_match_jax_vjp(C, B, d, wrt_k):
    """dq / dk with the weights formed once from the partial logits,
    against ``jax.vjp`` of the reference's per-row oracle."""
    rng = np.random.default_rng(C * B + d)
    q, k = _unit(rng, (C, B, d)), _unit(rng, (C, B, d))
    g = rng.standard_normal((C, B)).astype(np.float32)
    _, lse = ref.info_nce_rows_split(_t(q), _t(k), 0.2)
    got = ref.info_nce_grad_split(_t(q), _t(k), lse, _t(g), 0.2, wrt_k)
    for c in range(C):
        _, vjp = jax.vjp(lambda a, b: jref.info_nce_rows_ref(a, b, 0.2),
                         jnp.asarray(q[c]), jnp.asarray(k[c]))
        want = vjp(jnp.asarray(g[c]))[int(wrt_k)]
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                   atol=TOL * float(np.abs(want).max()))

