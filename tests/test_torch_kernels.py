"""The port's kernels on the CPU (their plain PyTorch versions, which the
wrappers run for CPU tensors) against the JAX package's Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them; and the backward of
the port's autograd Functions against autograd through the plain versions
and against ``jax.grad`` of the reference's ``kernels/ref.py``."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import pack as jpk
from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jrn
from repro_torch.kernels import ops, ref

# the module, not the function of the same name that repro.kernels exports
jfa = importlib.import_module("repro.kernels.flash_attention")

torch.set_num_threads(2)


@pytest.fixture
def one_intra_op_thread():
    """PyTorch on one intra-op thread for the test. Now and then the first
    multi-threaded fp32 ``torch.exp`` of a fresh process (the attention
    plain version's softmax numerator here) returns one thread's share off
    by up to 1.1e-4 against float64, while every later call is exact to
    3e-8: five times these tests' 2e-5 tolerance. It shows with PyTorch's
    CPU build alone (no JAX, no code of this repo) and is not understood;
    on one thread it has not been seen."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _layout():
    """Ragged leaves and slots: partial ranges, whole leaves, one element."""
    shapes = [(4, 33), (129,), (7, 5), (3, 4096), (1,)]
    leaves = [_np(s, i).reshape(-1) for i, s in enumerate(shapes)]
    layout, off = [], 0
    for src_off, size in [(33, 66), (0, 129), (0, 35), (4096, 8192), (0, 1)]:
        layout.append((src_off, off, size))
        off += size
    return leaves, tuple(layout), off


def test_wire_pack_bit_identical_to_pallas():
    leaves, layout, total = _layout()
    want = np.asarray(jpk.gather_pack([jnp.asarray(x) for x in leaves],
                                      layout, total, interpret=True))
    got = ops.wire_pack([torch.from_numpy(x) for x in leaves], layout, total)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wire_unpack_bit_identical_to_pallas():
    leaves, layout, total = _layout()
    flat = _np((total,), 9)
    want = jpk.scatter_unpack(jnp.asarray(flat),
                              [jnp.asarray(x) for x in leaves], layout,
                              interpret=True)
    bases = [torch.from_numpy(x) for x in leaves]
    got = ops.wire_unpack(torch.from_numpy(flat), bases, layout)
    for g, w, b, x in zip(got, want, bases, leaves):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(b.numpy(), x)    # bases untouched


@pytest.mark.parametrize("R,d,dtype", [(256, 192, jnp.float32),
                                       (130, 96, jnp.float32),
                                       (256, 192, jnp.bfloat16)])
def test_rmsnorm_matches_pallas(R, d, dtype):
    x = jnp.asarray(_np((R, d), 0)).astype(dtype)
    s = jnp.asarray(1.0 + 0.1 * _np((d,), 1))
    want = jrn.rmsnorm_rows(x, s, interpret=True)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        tx = tx.to(torch.bfloat16)
    got = ops.rmsnorm(tx, torch.from_numpy(np.array(s)))
    assert got.dtype == tx.dtype
    # fp32: summation order only; bf16: one bf16 rounding of the output
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)


def _tol(dtype):
    return 2e-2 if dtype == jnp.bfloat16 else 2e-5


def _bshd(shape, seed, dtype):
    x = jnp.asarray(_np(shape, seed)).astype(dtype)
    t = torch.from_numpy(np.array(x.astype(jnp.float32)))
    return x, (t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t)


# the grid of tests/test_kernels.py::test_flash_attention, plus the ViT's
@pytest.mark.usefixtures("one_intra_op_thread")
@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window,dtype", [
    (2, 128, 128, 4, 2, 64, True, 0, jnp.float32),
    (1, 256, 256, 4, 4, 128, True, 0, jnp.float32),
    (2, 128, 128, 8, 1, 64, False, 0, jnp.float32),
    (1, 200, 200, 4, 2, 48, True, 0, jnp.float32),
    (1, 384, 384, 2, 2, 96, True, 64, jnp.float32),
    (1, 256, 256, 4, 2, 64, True, 0, jnp.bfloat16),
    (1, 128, 128, 4, 4, 64, False, 0, jnp.bfloat16),
    (2, 65, 65, 3, 3, 64, False, 0, jnp.bfloat16),
])
def test_flash_attention_matches_pallas(B, S, T, Hq, Hkv, hd, causal, window,
                                        dtype):
    jq, q = _bshd((B, S, Hq, hd), 1, dtype)
    jk, k = _bshd((B, T, Hkv, hd), 2, dtype)
    jv, v = _bshd((B, T, Hkv, hd), 3, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=_tol(dtype), rtol=0)


@pytest.mark.usefixtures("one_intra_op_thread")
@pytest.mark.parametrize("causal,window,kv_len", [(False, 0, 200),
                                                  (True, 0, 160),
                                                  (True, 96, 230)])
def test_flash_attention_kv_len_matches_pallas(causal, window, kv_len):
    """The ``kv_len`` mask, through the BHSD kernel itself (every q row
    sees at least one key in these cases)."""
    B, S, Hq, Hkv, hd = 1, 256, 4, 2, 64
    jq, q = _bshd((B, S, Hq, hd), 4, jnp.float32)
    jk, k = _bshd((B, S, Hkv, hd), 5, jnp.float32)
    jv, v = _bshd((B, S, Hkv, hd), 6, jnp.float32)
    tr = (0, 2, 1, 3)
    want = jfa.flash_attention_bhsd(
        jq.transpose(tr), jk.transpose(tr), jv.transpose(tr), causal=causal,
        window=window, kv_len=kv_len, interpret=True).transpose(tr)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_rmsnorm_backward():
    x = torch.from_numpy(_np((70, 48), 7)).requires_grad_()
    s = torch.from_numpy(1.0 + 0.1 * _np((48,), 8)).requires_grad_()
    g = torch.from_numpy(_np((70, 48), 9))
    got = torch.autograd.grad(ops.rmsnorm(x, s), (x, s), g)
    via_plain = torch.autograd.grad(ref.rmsnorm_ref(x, s), (x, s), g)
    jx, js, jg = (jnp.asarray(t.detach().numpy()) for t in (x, s, g))
    via_jax = jax.grad(lambda a, b: jnp.sum(jref.rmsnorm_ref(a, b) * jg),
                       argnums=(0, 1))(jx, js)
    for a, b, c in zip(got, via_plain, via_jax):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5,
                                   rtol=1e-5)


def test_rmsnorm_grouped_scale_matches_per_group():
    """A (G, d) scale (the form RMSNormFn's vmap rule hands on) normalises
    x[g] with scale[g]; values and gradients equal a loop over g."""
    x = torch.from_numpy(_np((3, 10, 7, 48), 10)).requires_grad_()
    s = torch.from_numpy(1.0 + 0.1 * _np((3, 48), 11)).requires_grad_()
    g = torch.from_numpy(_np((3, 10, 7, 48), 12))
    got = ops.RMSNormFn.apply(x, s, 1e-5)
    gx, gs = torch.autograd.grad(got, (x, s), g)
    for i in range(3):
        xi, si = x[i].detach().requires_grad_(), s[i].detach().requires_grad_()
        want = ops.rmsnorm(xi, si)
        wx, ws = torch.autograd.grad(want, (xi, si), g[i])
        torch.testing.assert_close(got[i], want, rtol=0, atol=1e-6)
        torch.testing.assert_close(gx[i], wx, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gs[i], ws, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_flash_attention_backward(causal, window):
    B, S, Hq, Hkv, hd = 2, 33, 4, 2, 16
    q, k, v = (torch.from_numpy(_np((B, S, h, hd), i)).requires_grad_()
               for i, h in enumerate((Hq, Hkv, Hkv)))
    g = torch.from_numpy(_np((B, S, Hq, hd), 5))
    got = torch.autograd.grad(
        ops.flash_attention(q, k, v, causal=causal, window=window),
        (q, k, v), g)
    tr = (0, 2, 1, 3)
    via_plain = torch.autograd.grad(
        ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     causal=causal, window=window).transpose(1, 2),
        (q, k, v), g)
    jq, jk, jv, jg = (jnp.asarray(t.detach().numpy()) for t in (q, k, v, g))

    def jloss(a, b, c):
        o = jref.sdpa_ref(a.transpose(tr), b.transpose(tr), c.transpose(tr),
                          causal=causal, window=window).transpose(tr)
        return jnp.sum(o * jg)

    via_jax = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    for a, b, c in zip(got, via_plain, via_jax):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5,
                                   rtol=1e-5)


def test_wrappers_count_only_kernel_launches():
    """On the CPU the wrappers run the plain versions: no launch counted."""
    ops.reset_launch_counts()
    leaves, layout, total = _layout()
    ops.wire_pack([torch.from_numpy(x) for x in leaves], layout, total)
    ops.rmsnorm(torch.ones(4, 8), torch.ones(8))
    ops.info_nce_rows(torch.ones(4, 8), torch.ones(4, 8), 0.2)
    ops.ssd_scan(torch.ones(1, 8, 2, 4), torch.ones(1, 8, 2),
                 -torch.ones(1, 8, 2), torch.ones(1, 8, 3),
                 torch.ones(1, 8, 3), chunk=4)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("replays", [0, 1, 3])
def test_graph_launches_count_replays_not_the_capture(replays):
    """``GraphLaunches``: the calls a capture counts (bumped here as a
    kernel wrapper bumps them: the CPU launches nothing) are taken back
    out; each replay adds them once; kernels the capture did not call are
    left alone; a capture that raises takes its calls out too."""
    ops.reset_launch_counts()
    ops.LAUNCHES["rmsnorm_rows"] = 5
    start = ops.launch_counts()
    calls = {"flash_attention": 48, "rmsnorm_rows": 100, "info_nce_rows": 2}
    graph = ops.GraphLaunches()
    with graph.capture():
        for k, n in calls.items():
            ops.LAUNCHES[k] += n
    assert ops.launch_counts() == start and graph.delta == calls
    for _ in range(replays):
        graph.replayed()
    assert ops.launch_counts() == {k: start[k] + replays * calls.get(k, 0)
                                   for k in ops.KERNELS}
    with pytest.raises(ValueError), ops.GraphLaunches().capture():
        ops.LAUNCHES["ssd_scan"] += 4
        raise ValueError("capture failed")
    assert ops.LAUNCHES["ssd_scan"] == 0
    ops.reset_launch_counts()


def _loss_rmsnorm(x, s):
    return (ops.rmsnorm(x, s) ** 2).sum()


def _loss_attention(q, k, v):
    return (ops.flash_attention(q, k, v, causal=False) ** 2).sum()


def _loss_info_nce(q, k):
    return ops.info_nce_rows(q, k, 0.2).mean()


# Function -> (per-client loss, per-client input shapes, vmapped inputs)
VMAP_CASES = {
    "rmsnorm": (_loss_rmsnorm, [(5, 7, 16), (16,)], (0, 0)),
    "rmsnorm_shared_scale": (_loss_rmsnorm, [(5, 7, 16), (16,)], (0, None)),
    "flash_attention": (_loss_attention,
                        [(2, 9, 4, 8), (2, 9, 2, 8), (2, 9, 2, 8)],
                        (0, 0, 0)),
    "info_nce": (_loss_info_nce, [(24, 16), (24, 16)], (0, 0)),
    "info_nce_shared_k": (_loss_info_nce, [(24, 16), (24, 16)], (0, None)),
}


@pytest.mark.parametrize("case", list(VMAP_CASES))
def test_vmap_rule_matches_client_loop(case):
    """``torch.func.vmap`` over ``grad_and_value`` of each Function (its
    ``vmap`` rule hands the client axis to one kernel call) equals a loop
    over the clients, values and gradients with respect to every input."""
    fn, shapes, in_dims = VMAP_CASES[case]
    C = 3
    args = [torch.from_numpy(_np((C,) + s if d is not None else s, i))
            for i, (s, d) in enumerate(zip(shapes, in_dims))]
    argnums = tuple(range(len(args)))
    step = torch.func.grad_and_value(fn, argnums=argnums)
    grads, values = torch.func.vmap(step, in_dims=in_dims)(*args)
    for c in range(C):
        one = [a[c] if d is not None else a for a, d in zip(args, in_dims)]
        want_g, want_v = step(*one)
        torch.testing.assert_close(values[c], want_v, rtol=1e-6, atol=1e-6)
        for got, want in zip(grads, want_g):
            torch.testing.assert_close(got[c], want, rtol=1e-6, atol=1e-6)


def test_sdpa_plain_fully_masked_row_is_zero():
    """A q row that sees no key (kv_len 6 and a window of 4 leave rows 9
    and later nothing) is all zeros in the port's plain version, and so in
    its CUDA kernels (``tests/test_torch_cuda.py``). The reference's TPU
    kernel differs there: its logits are -1e30 everywhere, so its
    ``exp(logits - m)`` is 1 for every visited key and the row comes out as
    a mean of the visited values (``ROADMAP.md``, faults found in the
    port)."""
    B, S, Hq, Hkv, hd = 1, 16, 2, 1, 8
    q, k, v = (torch.from_numpy(_np((B, S, h, hd), i))
               for i, h in enumerate((Hq, Hkv, Hkv)))
    got = ops.flash_attention(q, k, v, causal=True, window=4, kv_len=6)
    want = ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=4,
                        kv_len=6).transpose(1, 2)
    assert torch.equal(got, want)
    assert torch.equal(got[:, 9:], torch.zeros_like(got[:, 9:]))
    assert bool((got[:, :9].abs().sum(-1) > 0).all())


def test_library_name_follows_headers(tmp_path, monkeypatch):
    """A library is named by a hash of its source and of every header in
    ``csrc/``, so changing a shared header rebuilds the libraries that
    include it; other files there do not count."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    first = build.library_path("k")
    assert first.parent == tmp_path / "_build"
    (csrc / "notes.txt").write_text("not a header\n")
    assert build.library_path("k") == first
    (csrc / "common.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert build.library_path("k") not in (first, second)
