"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit (``nvcc``) and
skips without one. Run them on the card with

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which the GPU machine
need not have). TF32 is off, so fp32 products are full fp32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev).to(dtype)


def test_pack_unpack_bit_exact(dev):
    # ragged sizes and offsets: vector and scalar paths, partial slots
    shapes = [(4, 33), (129,), (7, 5), (3, 4096), (1,)]
    leaves = [_rand(s, torch.float32, dev, i).reshape(-1)
              for i, s in enumerate(shapes)]
    layout, off = [], 0
    for leaf, (src_off, size) in zip(leaves, [(33, 66), (0, 129), (0, 35),
                                              (4096, 8192), (0, 1)]):
        layout.append((src_off, off, size))
        off += size
    before = ops.launch_counts()
    flat = ops.wire_pack(leaves, layout, off)
    want = ref.wire_pack_ref([l.cpu() for l in leaves], layout, off)
    assert torch.equal(flat.cpu(), want)
    new = _rand((off,), torch.float32, dev, 9)
    outs = ops.wire_unpack(new, leaves, layout)
    wants = ref.wire_unpack_ref(new.cpu(), [l.cpu() for l in leaves], layout)
    for o, w in zip(outs, wants):
        assert torch.equal(o.cpu(), w)
    after = ops.launch_counts()
    assert after["gather_pack"] == before["gather_pack"] + 1
    assert after["scatter_unpack"] == before["scatter_unpack"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(16640, 192), (37, 96), (5, 1024)])
def test_rmsnorm_kernel(dev, dtype, rows, d):
    x = _rand((rows, d), dtype, dev)
    s = 1.0 + 0.1 * _rand((d,), torch.float32, dev, 1)
    got = ops.rmsnorm(x, s)
    want = ref.rmsnorm_ref(x, s)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window,kv_len,dtype", [
    (256, 65, 65, 3, 3, 64, False, 0, None, torch.bfloat16),   # ViT-Tiny
    (2, 200, 200, 4, 2, 128, True, 64, None, torch.float32),
    (2, 130, 130, 8, 1, 64, True, 0, 100, torch.float32),
    (1, 65, 65, 3, 3, 64, False, 0, None, torch.float32),
])
def test_flash_attention_kernel(dev, B, S, T, Hq, Hkv, hd, causal, window,
                                kv_len, dtype):
    q = _rand((B, S, Hq, hd), dtype, dev, 0)
    k = _rand((B, T, Hkv, hd), dtype, dev, 1)
    v = _rand((B, T, Hkv, hd), dtype, dev, 2)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              kv_len=kv_len)
    want = ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        kv_len=kv_len).transpose(1, 2)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert (got.float() - want.float()).abs().max().item() < tol


def test_autograd_functions_on_card(dev):
    x = _rand((130, 192), torch.float32, dev).requires_grad_()
    s = (1.0 + 0.1 * _rand((192,), torch.float32, dev, 1)).requires_grad_()
    g = _rand((130, 192), torch.float32, dev, 2)
    gx, gs = torch.autograd.grad(ops.rmsnorm(x, s), (x, s), g)
    rx, rs = torch.autograd.grad(ref.rmsnorm_ref(x, s), (x, s), g)
    assert torch.allclose(gx, rx, atol=1e-5) and \
        torch.allclose(gs, rs, atol=1e-4)
    q = _rand((2, 65, 4, 64), torch.float32, dev, 3).requires_grad_()
    k = _rand((2, 65, 2, 64), torch.float32, dev, 4).requires_grad_()
    v = _rand((2, 65, 2, 64), torch.float32, dev, 5).requires_grad_()
    go = _rand((2, 65, 4, 64), torch.float32, dev, 6)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=True),
                              (q, k, v), go)
    want = torch.autograd.grad(
        ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), causal=True).transpose(1, 2),
        (q, k, v), go)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-4)


def test_wrappers_raise_instead_of_falling_back(dev):
    """On CUDA tensors a wrapper launches its kernel or raises: no silent
    plain-PyTorch fallback for inputs the kernel does not take."""
    q = torch.zeros((1, 8, 2, 48), device=dev)          # head dim 48
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.zeros((4, 8), dtype=torch.float16, device=dev),
                    torch.ones(8, device=dev))
    with pytest.raises(ValueError):
        ops.wire_pack([torch.zeros(4, dtype=torch.float64, device=dev)],
                      [(0, 0, 4)], 4)
