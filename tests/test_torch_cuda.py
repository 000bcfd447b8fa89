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
# (4096, 1536): the xLSTM's mLSTM inner norm (4 x 1024 tokens, bf16);
# (4096, 768): its residual stream; (2048, 1024) and (1024, 1024):
# seamless-m4t's decoder and encoder blocks
@pytest.mark.parametrize("rows,d", [(16640, 192), (37, 96), (5, 1024),
                                    (4096, 1536), (4096, 768), (2048, 1024),
                                    (1024, 1024)])
def test_rmsnorm_kernel(dev, dtype, rows, d):
    x = _rand((rows, d), dtype, dev)
    s = 1.0 + 0.1 * _rand((d,), torch.float32, dev, 1)
    got = ops.rmsnorm(x, s)
    want = ref.rmsnorm_ref(x, s)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [33, 192, 2560, 4100, 5120])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_kernel_widths(dev, dtype, d, offset):
    """Every width the row groups take (a warp, 128 or 256 threads a row),
    16-byte vectors where rows are aligned and scalars where not (d = 33,
    or a view one element into its buffer), with a grouped scale: rows
    [g R/G, (g+1) R/G) use scale[g]."""
    R, G = 60, 3
    x = _rand((R * d + offset,), dtype, dev)[offset:].view(R, d)
    s = 1.0 + 0.1 * _rand((G, d), torch.float32, dev, 1)
    got = ops.rmsnorm(x.view(G, R // G, d), s)
    want = ref.rmsnorm_ref(x.view(G, R // G, d), s)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window,kv_len,dtype", [
    (256, 65, 65, 3, 3, 64, False, 0, None, torch.bfloat16),   # ViT-Tiny
    (2, 200, 200, 4, 2, 128, True, 64, None, torch.float32),
    (2, 130, 130, 8, 1, 64, True, 0, 100, torch.float32),
    (1, 65, 65, 3, 3, 64, False, 0, None, torch.float32),
    (4, 1024, 1024, 32, 32, 80, True, 0, None, torch.bfloat16),  # zamba2
    (4, 1024, 1024, 32, 32, 80, True, 0, None, torch.float32),
    (2, 130, 130, 4, 2, 80, True, 48, 100, torch.float32),
    # seamless-m4t-medium: cross attention (1024 decoder queries over 512
    # encoder frames), the encoder's self-attention and the decoder's
    # causal self-attention, 16 heads of 64
    (2, 1024, 512, 16, 16, 64, False, 0, None, torch.bfloat16),
    (2, 512, 512, 16, 16, 64, False, 0, None, torch.bfloat16),
    (2, 1024, 1024, 16, 16, 64, True, 0, None, torch.bfloat16),
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


# bf16 at every head dim and at sequence lengths around the tile edges
# (16-row warps, 64-key tiles, one block for S <= 128), with the masks
BF16_CASES = [
    (3, 1, 1, 2, 2, 64, False, 0, None),
    (2, 17, 17, 4, 2, 80, True, 0, None),
    (2, 65, 65, 3, 3, 128, False, 0, None),
    (2, 65, 65, 4, 1, 80, True, 16, None),
    (2, 129, 129, 4, 2, 64, True, 0, 100),
    (2, 129, 129, 2, 2, 128, False, 0, 70),
    (1, 1000, 1000, 4, 2, 80, True, 0, None),
    (1, 1000, 1000, 2, 1, 64, True, 200, None),
    (1, 1000, 1000, 2, 2, 128, False, 0, 777),
    (2, 17, 130, 2, 2, 64, False, 0, None),
    (1, 129, 1000, 2, 1, 128, False, 100, 900),
    # the dense LM's attention (internlm2-1.8b: 16 q heads over 8 kv heads
    # of 128, causal, 4 x 1024 tokens)
    (4, 1024, 1024, 16, 8, 128, True, 0, None),
    # llama4-maverick's: 40 q heads over 8 kv heads of 128
    (2, 1024, 1024, 40, 8, 128, True, 0, None),
]


def _attention_case(dev, B, S, T, Hq, Hkv, hd, causal, window, kv_len,
                    dtype, seed=0):
    q = _rand((B, S, Hq, hd), dtype, dev, seed)
    k = _rand((B, T, Hkv, hd), dtype, dev, seed + 1)
    v = _rand((B, T, Hkv, hd), dtype, dev, seed + 2)
    want = ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        kv_len=kv_len).transpose(1, 2)
    return q, k, v, want


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window,kv_len", BF16_CASES)
def test_flash_attention_bf16_shapes(dev, B, S, T, Hq, Hkv, hd, causal,
                                     window, kv_len):
    q, k, v, want = _attention_case(dev, B, S, T, Hq, Hkv, hd, causal,
                                    window, kv_len, torch.bfloat16)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              kv_len=kv_len)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() < 2e-2


def test_flash_attention_bf16_strided_views(dev):
    """BSHD views with other strides: q, k, v sliced out of one fused
    projection (sequence stride 3 Hq hd), and the transpose of a BHSD
    tensor; all strides are multiples of 16 bytes, so the kernel reads
    them in place."""
    B, S, H, hd = 2, 65, 3, 64
    qkv = _rand((B, S, 3 * H, hd), torch.bfloat16, dev, 3)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
    bhsd = _rand((B, H, S, hd), torch.bfloat16, dev, 4).transpose(1, 2)
    for a, b, c in ((q, k, v), (bhsd, k, v)):
        got = ops.flash_attention(a, b, c, causal=True)
        want = ref.sdpa_ref(a.transpose(1, 2), b.transpose(1, 2),
                            c.transpose(1, 2), causal=True).transpose(1, 2)
        assert (got.float() - want.float()).abs().max().item() < 2e-2


def test_flash_attention_bf16_refuses_unaligned_layout(dev):
    """A bf16 layout the kernel's 16-byte copies cannot read (a sequence
    stride of 65 elements, a base 2 bytes into its buffer) raises; it is
    not routed to another kernel."""
    buf = _rand((2, 8, 2, 65), torch.bfloat16, dev)
    q = buf[..., 1:]                              # head dim 64, offset 1
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    q = _rand((2 * 8 * 2 * 64 + 1,), torch.bfloat16, dev)[1:] \
        .view(2, 8, 2, 64)                        # only the base is off
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fully_masked_rows_are_zero(dev, dtype):
    """Rows that see no key (kv_len 6 and a window of 4 leave rows 9 and
    later nothing) come out as zeros from both kernels, as from the plain
    version; the other rows match it."""
    q, k, v, want = _attention_case(dev, 2, 130, 130, 4, 2, 64, True, 4, 6,
                                    dtype)
    got = ops.flash_attention(q, k, v, causal=True, window=4, kv_len=6)
    assert torch.equal(got[:, 9:], torch.zeros_like(got[:, 9:]))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert (got.float() - want.float()).abs().max().item() < tol


# MLA: q/k heads wider than v heads, deepseek-v2's published (192, 128) and
# its reduced() (48, 32); (B, S, T, Hq, Hkv, q/k head dim, v head dim,
# causal, window, kv_len, dtype)
MLA_CASES = [
    (2, 1024, 1024, 128, 128, 192, 128, True, 0, None, torch.bfloat16),
    (2, 1024, 1024, 128, 128, 192, 128, True, 0, None, torch.float32),
    (2, 130, 130, 4, 4, 192, 128, False, 0, None, torch.bfloat16),
    (1, 1000, 1000, 2, 1, 192, 128, True, 200, 900, torch.float32),
    (4, 64, 64, 4, 4, 48, 32, True, 0, None, torch.float32),
    (2, 129, 129, 4, 2, 48, 32, True, 16, 100, torch.bfloat16),
    (3, 17, 40, 2, 2, 48, 32, False, 0, None, torch.float32),
]


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,dv,causal,window,kv_len,dtype",
                         MLA_CASES)
def test_flash_attention_mla_head_dims(dev, B, S, T, Hq, Hkv, hd, dv,
                                       causal, window, kv_len, dtype):
    """Both kernels with v heads narrower than q/k heads: a (B, S, Hq, dv)
    output within the tolerance of ``ref.sdpa_ref`` at scale 1/sqrt(hd),
    through the kernel (one launch), not the plain version."""
    q = _rand((B, S, Hq, hd), dtype, dev, 0)
    k = _rand((B, T, Hkv, hd), dtype, dev, 1)
    v = _rand((B, T, Hkv, dv), dtype, dev, 2)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              kv_len=kv_len)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == (B, S, Hq, dv) and got.dtype == dtype
    want = ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        kv_len=kv_len).transpose(1, 2)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert (got.float() - want.float()).abs().max().item() < tol


# decode: one query over a KV cache of T slots of which the first kv_len
# are filled, non-causal (the serving path's call); (B, T, Hq, Hkv, hd,
# kv_len): the dense LM's (16/8 of 128) and zamba2's (32/32 of 80) shared
# block, GQA 4:1 and 8:1, a single filled slot and a ragged last tile
DECODE_CASES = [
    (4, 128, 16, 8, 128, 77),
    (4, 128, 16, 8, 128, 128),
    (2, 200, 32, 32, 80, 133),
    (3, 64, 8, 2, 128, 1),
    (1, 130, 8, 1, 80, 129),
    (2, 1000, 4, 1, 64, 555),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hq,Hkv,hd,kv_len", DECODE_CASES)
def test_flash_attention_decode_kv_len(dev, B, T, Hq, Hkv, hd, kv_len,
                                       dtype):
    """S = 1 with ``kv_len`` below T: the keys at and past ``kv_len`` (the
    cache's empty slots, here filled with large values) take no part."""
    q, k, v, want = _attention_case(dev, B, 1, T, Hq, Hkv, hd, False, 0,
                                    kv_len, dtype)
    k[:, kv_len:] = 30.0
    v[:, kv_len:] = 1e4
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    assert ops.launch_counts()["flash_attention"] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() < tol


def test_decode_step_on_card_matches_cpu(dev):
    """The serving path's decode (a sliding-window GQA LM whose ring buffer
    evicts, fp32) on the card against the CPU's plain versions, step by
    step: one attention and two RMSNorm launches a block, one final
    RMSNorm, every step."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import lm
    cfg = ModelConfig("t", "dense", 2, 256, 4, 2, 512, 97, head_dim=128,
                      window=8, compute_dtype="float32")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 97, (2, 20)))
    caches = {d: lm.init_caches(cfg, 2, 20, device=d) for d in ("cpu", dev)}
    cparams = {k: v.to(dev) for k, v in params.items()}
    before = ops.launch_counts()
    for t in range(20):
        want, _ = lm.decode_step(params, caches["cpu"], toks[:, t:t + 1], t,
                                 cfg)
        got, _ = lm.decode_step(cparams, caches[dev],
                                toks[:, t:t + 1].to(dev), t, cfg)
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (t, err)
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 20 * 2
    assert after["rmsnorm_rows"] - before["rmsnorm_rows"] == 20 * 5
    for k, v in caches["cpu"].items():
        assert torch.allclose(caches[dev][k].cpu(), v, atol=1e-5), k


@pytest.mark.parametrize("hd,dv", [(48, 32), (192, 128)])
def test_flash_attention_mla_backward_on_card(dev, hd, dv):
    """``FlashAttentionFn``'s backward (``ref.sdpa_bwd_ref``) with a
    narrower v, GQA included, against autograd through the plain
    version."""
    q = _rand((2, 130, 4, hd), torch.float32, dev, 3).requires_grad_()
    k = _rand((2, 130, 2, hd), torch.float32, dev, 4).requires_grad_()
    v = _rand((2, 130, 2, dv), torch.float32, dev, 5).requires_grad_()
    go = _rand((2, 130, 4, dv), torch.float32, dev, 6)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=True),
                              (q, k, v), go)
    want = torch.autograd.grad(
        ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), causal=True).transpose(1, 2),
        (q, k, v), go)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.allclose(a, b, atol=1e-4)


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
    q = torch.zeros((1, 8, 2, 48), device=dev)          # head dims 48 / 48
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=dev)          # v wider than q
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, torch.zeros((1, 8, 2, 128), device=dev))
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.zeros((4, 8), dtype=torch.float16, device=dev),
                    torch.ones(8, device=dev))
    with pytest.raises(ValueError):
        ops.wire_pack([torch.zeros(4, dtype=torch.float64, device=dev)],
                      [(0, 0, 4)], 4)


# -- wire codecs ----------------------------------------------------------------
# int8 segments (offset, size, channels, scale_offset) from a 192-vector with
# one scale to the 4096-wide head matrix: narrow and wide columns, a width
# that does not divide the block, and slots longer than one chunk
INT8_SHAPES = [(192, 1), (40000, 1), (64, 8), (192, 768), (33, 300),
               (4, 192), (4096, 4096)]


def _int8_segs(shapes):
    segs, off, soff = [], 0, 0
    for rows, ch in shapes:
        segs.append((off, rows * ch, ch, soff))
        off += rows * ch
        soff += ch
    return tuple(segs), off, soff


def _unaligned_view(q):
    """``q`` copied into a view one byte past an aligned base: char4 loads
    of it would be misaligned, so the dequantizer takes its scalar path."""
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    view = buf[1:]
    view.copy_(q)
    assert view.data_ptr() % 4 != 0
    return view


@pytest.mark.parametrize("case", ["aligned", "odd", "view"])
def test_int8_quant_dequant_bit_exact(dev, case):
    # "odd": a 37-element slot first leaves every later offset off the
    # 16-byte grid, so quantizer and dequantizer take their scalar paths
    # throughout; "view": aligned slots, but the dequantizer's q is a view
    # whose base is not 4-byte aligned
    lead = [(37, 1)] if case == "odd" else []
    segs, total, nscales = _int8_segs(lead + INT8_SHAPES)
    before = ops.launch_counts()
    # the second call's smaller values would expose a stale absmax scratch
    for seed, spread in ((0, 3.0), (1, 0.01)):
        flat = spread * _rand((total,), torch.float32, dev, seed)
        q, s = ops.wire_int8_encode(flat, segs, nscales)
        wq, ws = ref.int8_encode_ref(flat, segs, nscales)
        assert torch.equal(q, wq) and torch.equal(s, ws)
        cq, cs = ref.int8_encode_ref(flat.cpu(), segs, nscales)
        assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)
        if case == "view":
            q = _unaligned_view(q)
        dec = ops.wire_int8_decode(q, s, segs, total)
        want = ref.int8_decode_ref(wq, ws, segs, total)
        assert torch.equal(dec, want)
        assert torch.equal(ops.wire_int8_decode(q, s, segs, total), dec)
        assert torch.equal(dec.cpu(), ref.int8_decode_ref(cq, cs, segs,
                                                          total))
    q2, s2 = ops.wire_int8_encode(flat, segs, nscales)       # same bits
    assert torch.equal(q2, wq) and torch.equal(s2, ws)
    after = ops.launch_counts()
    assert after["int8_quant_matrix"] == before["int8_quant_matrix"] + 3
    assert after["int8_dequant_matrix"] == before["int8_dequant_matrix"] + 4


def test_int8_dequant_back_to_back_layouts(dev):
    """Two layouts dequantized in turns, queued without a sync: each call
    reads its own layout's tile table (a stale or shared table would give
    the other layout's columns), and an unaligned view of q its own."""
    cases = []
    for i, shapes in enumerate((INT8_SHAPES, [(37, 1)] + INT8_SHAPES[::-1],
                                [(4096, 4096), (192, 768)])):
        segs, total, nscales = _int8_segs(shapes)
        flat = _rand((total,), torch.float32, dev, 20 + i)
        q, s = ref.int8_encode_ref(flat, segs, nscales)
        cases.append((segs, total, q, s))
    cases.append((cases[0][0], cases[0][1], _unaligned_view(cases[0][2]),
                  cases[0][3]))
    torch.cuda.synchronize()
    outs = [ops.wire_int8_decode(q, s, segs, total)
            for _ in range(2) for segs, total, q, s in cases]
    for out, (segs, total, q, s) in zip(outs, cases * 2):
        assert torch.equal(out, ref.int8_decode_ref(q, s, segs, total))


def test_traced_run_matches_untraced_on_card(dev):
    """A 2-round run on the int8 wire, traced with metrics and health and
    untraced: the same wire bytes and kernel launches; the trace's counters
    equal the history."""
    from repro_torch import obs as tobs
    from repro_torch.configs.base import (FLConfig, SSLConfig, TrainConfig,
                                          load_arch, reduced)
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import synthetic_images
    from repro_torch.federated.driver import run_fedssl
    # head dim 64, one the attention kernels take
    cfg = reduced(load_arch("vit-tiny"), num_layers=2, d_model=128,
                  num_heads=2, num_kv_heads=2, d_ff=256)
    runs = []
    for obs in (None, tobs.make_obs(trace=True, metrics=True, health=True)):
        gen = torch.Generator(dev).manual_seed(0)
        images, _ = synthetic_images(gen, 128, 10, 32)
        before = ops.launch_counts()
        _, hist = run_fedssl(
            cfg, SSLConfig(proj_hidden=64, pred_hidden=64, proj_dim=32),
            FLConfig(num_clients=2, rounds=2, local_epochs=1, seed=0),
            TrainConfig(batch_size=32), images=images,
            client_indices=iid_partition(128, 2, seed=0),
            aux_images=images[:32], device="cuda", codec="int8", obs=obs)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        runs.append((hist, {k: after[k] - before[k] for k in after}, obs))
    (h0, l0, _), (h1, l1, obs) = runs
    assert h1.wire_download_bytes == h0.wire_download_bytes
    assert h1.wire_upload_bytes == h0.wire_upload_bytes
    assert l1 == l0 and l0["int8_dequant_matrix"] > 0
    c = obs.metrics.to_dict()["counters"]
    assert c["fl.rounds"] == 2
    assert c["wire.upload_bytes"] == sum(h1.wire_upload_bytes)
    assert sum(e["name"] == "round" for e in obs.tracer.events) == 2
    assert obs.health.alerts == []


@pytest.mark.parametrize("n,offset", [(21177920, 0), (1001, 1), (7, 0)])
@pytest.mark.parametrize("with_res", [True, False])
def test_compensate_bit_exact(dev, n, offset, with_res):
    # offset 1: views that are not 16-byte aligned take the scalar path
    f, r, e = (_rand((n + offset,), torch.float32, dev, i)[offset:]
               for i in range(3))
    res = e if with_res else None
    c, a = ops.compensate(f, r, res)
    wc, wa = ref.compensate_ref(f, r, res)
    assert torch.equal(c, wc) and torch.equal(a, wa)


# elements a tile of the EF update scans (EF_TILE in csrc/wire_codecs.cu)
EF_TILE = 8192


def _topk_cases(dev):
    rng = np.random.default_rng(4)
    tie = np.tile(np.asarray([5.0, -3.0, 3.0, 1.0, 3.0, -5.0], np.float32),
                  40)
    # a delta that is mostly exact zeros: thresh == 0, and the tie set runs
    # over many of the kernel's tiles
    zeros = np.zeros(300_000, np.float32)
    hot = rng.choice(zeros.size, 5000, replace=False)
    zeros[hot] = rng.standard_normal(5000).astype(np.float32)
    big = rng.standard_normal(21177920).astype(np.float32)
    small = rng.standard_normal(3 * EF_TILE + 1).astype(np.float32)

    def card(x):
        return torch.from_numpy(x).to(dev)

    cases = [(card(tie), 100), (card(zeros), 60_000),
             (card(rng.standard_normal(700).astype(np.float32)), 70),
             (card(big), 2117792),
             (card(small), 1), (card(small), small.size)]     # k == 1, k == n
    # one entry short of five tiles and one over (a tile of one entry)
    for n in (5 * EF_TILE - 1, 5 * EF_TILE + 1):
        cases.append((card(rng.standard_normal(n).astype(np.float32)),
                      n // 7))
    # a view one float past a 16-byte boundary: the kernel's scalar path
    cases.append((card(rng.standard_normal(70_001).astype(np.float32))[1:],
                  7_000))
    return cases


def test_topk_ef_update_bit_exact(dev):
    from repro_torch.kernels import wire_codecs
    assert wire_codecs._lib().ef_tile_elems() == EF_TILE
    for comp, k in _topk_cases(dev):
        absc = comp.abs()
        thresh, needed = ref.topk_threshold(absc, k)
        selected = torch.empty(1, dtype=torch.int64, device=dev)
        res, idx, val = wire_codecs.topk_ef_update(
            comp, thresh.reshape(1), needed.reshape(1), k, selected=selected)
        wres, widx, wval = ref.topk_ef_update_ref(comp, thresh, needed)
        assert int(selected) == k == widx.numel()
        assert torch.equal(idx, widx) and torch.equal(val, wval)
        assert torch.equal(res, wres)
        again = wire_codecs.topk_ef_update(comp, thresh.reshape(1),
                                           needed.reshape(1), k)
        assert all(torch.equal(a, b) for a, b in zip(again, (res, idx, val)))


def test_topk_ef_update_tie_budgets(dev):
    """Ties on both sides of every tile boundary, with thresh and needed
    given directly: no tie kept, some, a boundary's worth, and all."""
    from repro_torch.kernels import wire_codecs
    rng = np.random.default_rng(11)
    n = 4 * EF_TILE + 77
    x = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    ties = np.concatenate([np.arange(b - 20, b + 20)
                           for b in range(EF_TILE, n, EF_TILE)])
    x[ties] = rng.choice([-1.0, 1.0], ties.size)
    free = np.setdiff1d(np.arange(n), ties)
    x[rng.choice(free, 50, replace=False)] = 3.0
    comp = torch.from_numpy(x).to(dev)
    thresh = torch.ones(1, device=dev)
    for keep in (0, 1, 20, 21, 61, ties.size - 1, ties.size):
        needed = torch.full((1,), keep, dtype=torch.int64, device=dev)
        k = 50 + keep
        selected = torch.empty(1, dtype=torch.int64, device=dev)
        got = wire_codecs.topk_ef_update(comp, thresh, needed, k,
                                         selected=selected)
        want = ref.topk_ef_update_ref(comp, thresh[0], needed[0])
        tiled = ref.topk_ef_update_tiled(comp, thresh[0], needed[0],
                                         EF_TILE)
        assert int(selected) == k == want[1].numel()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(torch.equal(t, w) for t, w in zip(tiled, want))


def test_topk_ef_update_back_to_back_calls(dev):
    """Calls queued without a sync, n decreasing, so that each call's
    look-back scratch can reuse the last one's memory: every result is
    still the plain version's."""
    from repro_torch.kernels import wire_codecs
    rng = np.random.default_rng(12)
    runs = []
    for n in (3 * EF_TILE + 5, 2 * EF_TILE + 1, EF_TILE, 7):
        comp = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) \
            .to(dev)
        k = max(1, n // 5)
        thresh, needed = ref.topk_threshold(comp.abs(), k)
        runs.append((comp, thresh, needed, wire_codecs.topk_ef_update(
            comp, thresh.reshape(1), needed.reshape(1), k)))
    for comp, thresh, needed, got in runs:
        want = ref.topk_ef_update_ref(comp, thresh, needed)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_topk_ef_update_refuses_2_31_entries(dev):
    # 8.6 GB that the wrapper must refuse before any launch: int32 indices
    # and the look-back's 31-bit counts
    from repro_torch.kernels import wire_codecs
    comp = torch.empty(2 ** 31, dtype=torch.float32, device=dev)
    try:
        with pytest.raises(ValueError, match="2\\*\\*31"):
            wire_codecs.topk_ef_update(
                comp, torch.zeros(1, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev), 1)
    finally:
        del comp
        torch.cuda.empty_cache()


def test_topk_encode_matches_plain_on_card(dev):
    for comp, k in _topk_cases(dev)[:3]:
        ref_flat = _rand(comp.shape, torch.float32, dev, 5)
        flat = comp + ref_flat
        res = 0.1 * _rand(comp.shape, torch.float32, dev, 6)
        for r in (None, res):
            idx, val, new_res = ops.wire_topk_encode_ef(flat, ref_flat, r, k)
            widx, wval, wres, wdec = ref.topk_ef_ref(flat, ref_flat, r, k)
            assert torch.equal(idx, widx) and torch.equal(val, wval)
            assert torch.equal(new_res, wres)
            assert torch.equal(ops.wire_topk_decode(idx, val, comp.numel()),
                               wdec)


def test_codec_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros(8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        ops.wire_int8_encode(x, ((0, 8, 1, 0),), 1)
    with pytest.raises(ValueError):
        ops.wire_int8_encode(x.float(), ((0, 6, 2, 0),), 2)   # uncovered
    with pytest.raises(ValueError):
        ops.compensate(x.float(), torch.zeros(7, device=dev), None)
    with pytest.raises(ValueError):
        ops.topk_ef_update(x.float(), torch.zeros(()), torch.zeros(
            (), dtype=torch.int64), 2)                        # mixed devices


# -- InfoNCE and the vmap rules ---------------------------------------------------
def _unit(shape, dev, seed):
    return torch.nn.functional.normalize(_rand(shape, torch.float32, dev,
                                               seed), dim=-1)


@pytest.mark.parametrize("C,B,d", [(1, 256, 256), (1, 256, 192),
                                   (4, 256, 256), (2, 96, 200), (1, 1, 7),
                                   (3, 33, 1024), (1, 4, 2560), (1, 4, 5000),
                                   (2, 40, 4100)])
def test_info_nce_kernels(dev, C, B, d):
    """Forward (loss, lse), dq and dk against their plain versions, 1e-5
    relative to the largest value, or absolute where that is below 1 (fp32;
    the same sums in another order). At B = 1 the exact loss and gradients
    are 0 and both versions are left with rounding of the lse."""
    from repro_torch.kernels import infonce
    q, k = _unit((C, B, d), dev, 0), _unit((C, B, d), dev, 1)
    g = _rand((C, B), torch.float32, dev, 2)
    before = ops.launch_counts()
    got = ops.InfoNCEFn.apply(q, k, 0.2)
    want = ref.info_nce_rows_ref(q, k, 0.2)

    def close(a, b):
        scale = max(b.abs().max().item(), 1.0)
        return (a - b).abs().max().item() <= 1e-5 * scale

    assert all(close(a, b) for a, b in zip(got, want))
    for wrt_k in (False, True):
        assert close(infonce.info_nce_bwd(q, k, want[1], g, 0.2, wrt_k),
                     ref.info_nce_rows_bwd_ref(q, k, want[1], g, 0.2, wrt_k))
    assert ops.launch_counts()["info_nce_rows"] == \
        before["info_nce_rows"] + 1


@pytest.mark.parametrize("B,d", [(256, 256), (4, 2560), (33, 1024),
                                 (40, 4100)])
def test_info_nce_kernels_deterministic_and_client_independent(dev, B, d):
    """Two calls give the same bits, and a client's forward, dq and dk
    inside C = 4 are bit-identical to its own at C = 1 (the vmap rule folds
    clients into C)."""
    from repro_torch.kernels import infonce
    q, k = _unit((4, B, d), dev, 5), _unit((4, B, d), dev, 6)
    g = _rand((4, B), torch.float32, dev, 7)
    loss, lse = infonce.info_nce_fwd(q, k, 0.2)
    again = infonce.info_nce_fwd(q, k, 0.2)
    assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])
    one_loss, one_lse = infonce.info_nce_fwd(q[1:2].contiguous(),
                                             k[1:2].contiguous(), 0.2)
    assert torch.equal(one_loss[0], loss[1])
    assert torch.equal(one_lse[0], lse[1])
    for wrt_k in (False, True):
        grad = infonce.info_nce_bwd(q, k, lse, g, 0.2, wrt_k)
        assert torch.equal(grad, infonce.info_nce_bwd(q, k, lse, g, 0.2,
                                                      wrt_k))
        one = infonce.info_nce_bwd(q[1:2].contiguous(), k[1:2].contiguous(),
                                   one_lse, g[1:2].contiguous(), 0.2, wrt_k)
        assert torch.equal(one[0], grad[1])


def test_info_nce_backward_launches_dq_only_for_detached_k(dev):
    q = _unit((256, 256), dev, 3).requires_grad_()
    k = _unit((256, 256), dev, 4)
    before = ops.launch_counts()
    ops.info_nce_rows(q, k, 0.2).mean().backward()
    after = ops.launch_counts()
    assert after["info_nce_rows_dq"] == before["info_nce_rows_dq"] + 1
    assert after["info_nce_rows_dk"] == before["info_nce_rows_dk"]


def test_vmap_rules_on_card(dev):
    """vmap over grad of each Function: one kernel launch for all clients,
    equal to a loop over clients."""
    C = 4
    x = _rand((C, 256, 65, 192), torch.float32, dev, 0)
    s = 1.0 + 0.1 * _rand((C, 192), torch.float32, dev, 1)
    q, k = _unit((C, 256, 256), dev, 2), _unit((C, 256, 256), dev, 3)
    a = [_rand((C, 8, 65, 3, 64), torch.float32, dev, i) for i in (4, 5, 6)]
    cases = [(lambda x, s: (ops.rmsnorm(x, s) ** 2).sum(), (x, s),
              "rmsnorm_rows"),
             (lambda q, k: ops.info_nce_rows(q, k.detach(), 0.2).mean(),
              (q, k), "info_nce_rows"),
             (lambda q, k, v: (ops.flash_attention(q, k, v, causal=False)
                               ** 2).sum(), a, "flash_attention")]
    for fn, args, name in cases:
        step = torch.func.grad_and_value(fn)
        before = ops.launch_counts()[name]
        grads, vals = torch.func.vmap(step)(*args)
        assert ops.launch_counts()[name] == before + 1
        for c in range(C):
            wg, wv = step(*(t[c] for t in args))
            assert torch.allclose(vals[c], wv, rtol=1e-5, atol=1e-5)
            assert torch.allclose(grads[c], wg, rtol=1e-4, atol=1e-5)


def test_info_nce_wrapper_raises_instead_of_falling_back(dev):
    from repro_torch.kernels import infonce
    q = torch.zeros((1, 1, infonce.MAX_D + 1), device=dev)  # d > MAX_D
    with pytest.raises(ValueError):
        ops.info_nce_rows(q, q, 0.2)
    with pytest.raises(ValueError):
        ops.info_nce_rows(q[..., :8].double(), q[..., :8].double(), 0.2)


# -- the Mamba2 SSD scan ------------------------------------------------------------
def _ssd_inputs(B, S, H, P, N, dev, seed=0):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0))
    A = -np.exp(0.5 * rng.standard_normal(H))
    Bm = rng.standard_normal((B, S, N)) / np.sqrt(N)
    Cm = rng.standard_normal((B, S, N)) / np.sqrt(N)
    out = [torch.from_numpy(np.asarray(v, np.float32)).to(dev)
           for v in (xh, dt, dt * A, Bm, Cm)]
    return out


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (4, 1024, 80, 64, 64, 256),     # zamba2's Mamba2 blocks on the LM path
    (1, 384, 3, 32, 16, 128),
    (2, 96, 5, 64, 64, 32),         # chunk shorter than a 64-row tile
    (1, 200, 2, 20, 7, 40),         # ragged P, N and tiles
    (2, 256, 3, 64, 64, 256),       # one chunk
    (1, 1024, 2, 64, 64, 1024),     # one chunk of the largest length
    (1, 768, 4, 64, 64, 256),       # three chunks of the LM path's length
])
def test_ssd_scan_kernel(dev, B, S, H, P, N, chunk):
    """Against the plain version, 1e-4 of the largest output (fp32; sums
    and the cumulative log-decay in another order)."""
    args = _ssd_inputs(B, S, H, P, N, dev)
    before = ops.launch_counts()["ssd_scan"]
    got = ops.ssd_scan(*args, chunk=chunk)
    assert ops.launch_counts()["ssd_scan"] == before + 1
    want = ref.ssd_scan_ref(*args, chunk=chunk)
    assert (got - want).abs().max().item() <= \
        1e-4 * max(want.abs().max().item(), 1.0)


@pytest.mark.parametrize("pad", [0, 1])
def test_ssd_scan_kernel_strided_and_backward(dev, pad):
    """Operands read through their strides (slices of one projection, as
    mamba2_apply passes them), and the Function's backward against
    autograd through the plain version. ``pad`` puts a column before Bm
    and Cm, so their rows are not 16-byte aligned and the kernels take
    4-byte copies."""
    B, S, H, P, N, chunk = 2, 256, 4, 32, 16, 64
    xh, dt, a, Bm, Cm = _ssd_inputs(B, S, H, P, N, dev, seed=1)
    proj = torch.cat([xh.reshape(B, S, H * P),
                      torch.zeros((B, S, pad), device=dev), Bm, Cm], dim=-1)
    x_v = proj[..., :H * P].reshape(B, S, H, P)
    o = H * P + pad
    b_v, c_v = proj[..., o:o + N], proj[..., o + N:]
    got = ops.ssd_scan(x_v, dt, a, b_v, c_v, chunk=chunk)
    want = ref.ssd_scan_ref(xh, dt, a, Bm, Cm, chunk=chunk)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    ins = [t.clone().requires_grad_() for t in (xh, dt, a, Bm, Cm)]
    g = torch.randn((B, S, H, P), device=dev)
    gk = torch.autograd.grad((ops.ssd_scan(*ins, chunk=chunk) * g).sum(), ins)
    gr = torch.autograd.grad((ref.ssd_scan_ref(*ins, chunk=chunk) * g).sum(),
                             ins)
    for x, y in zip(gk, gr):
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()


@pytest.mark.parametrize("B,S,H,P,N,G,chunk", [
    (1, 4096, 112, 64, 64, 2, 256),  # Zamba2-7B's Mamba2 layers
    (2, 96, 6, 20, 7, 3, 32),        # ragged P, N, three groups
])
def test_ssd_scan_grouped_kernel(dev, B, S, H, P, N, G, chunk):
    """G groups of B and C (head h reads group h // (H / G)) against the
    plain grouped scan, 1e-4 of the largest output; Bm and Cm as the
    Mamba2 layer passes them (views of one convolution output); the
    Function's backward against autograd through the plain version at the
    ragged shape; one group given as (B, S, 1, N) gives the (B, S, N)
    form's bits."""
    xh, dt, a, _, _ = _ssd_inputs(B, S, H, P, N, dev, seed=3)
    rng = np.random.default_rng(4)
    conv = torch.from_numpy((rng.standard_normal((B, S, 2 * G * N))
                             / np.sqrt(N)).astype(np.float32)).to(dev)
    Bm, Cm = (t.unflatten(-1, (G, N)) for t in conv.split(G * N, dim=-1))
    before = ops.launch_counts()["ssd_scan"]
    got, h = ops.ssd_scan(xh, dt, a, Bm, Cm, chunk=chunk, return_state=True)
    assert ops.launch_counts()["ssd_scan"] == before + 1
    want, hw = ref.ssd_scan_ref(xh, dt, a, Bm, Cm, chunk=chunk,
                                return_state=True)
    assert (got - want).abs().max().item() <= \
        1e-4 * max(want.abs().max().item(), 1.0)
    assert (h - hw).abs().max().item() <= 1e-4 * max(hw.abs().max().item(),
                                                      1.0)
    if S <= 128:
        ins = [t.clone().requires_grad_() for t in (xh, dt, a, Bm, Cm)]
        g = torch.randn((B, S, H, P), device=dev)
        gk = torch.autograd.grad(
            (ops.ssd_scan(*ins, chunk=chunk) * g).sum(), ins)
        gr = torch.autograd.grad(
            (ref.ssd_scan_ref(*ins, chunk=chunk) * g).sum(), ins)
        for x, y in zip(gk, gr):
            assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()
    one = ops.ssd_scan(xh, dt, a, Bm[:, :, 0], Cm[:, :, 0], chunk=chunk)
    assert torch.equal(ops.ssd_scan(xh, dt, a, Bm[:, :, :1], Cm[:, :, :1],
                                    chunk=chunk), one)


def test_flash_attention_224_causal_4096(dev):
    """Zamba2-7B's shared block: causal (1, 4096, 32, 224) bf16 at its q.k
    scale (224 / 2)^-0.5 against the plain version (2e-2, as every bf16
    case), and the fp32 kernel at heads of 224 (2e-5)."""
    sc = (224 / 2) ** -0.5
    q, k, v = (_rand((1, 4096, 32, 224), torch.bfloat16, dev, s)
               for s in range(3))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, scale=sc)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.sdpa_ref(*(t.float().transpose(1, 2) for t in (q, k, v)),
                        causal=True, scale=sc).transpose(1, 2)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() < 2e-2
    q, k, v = (t[:, :300].float() for t in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=True, scale=sc)
    want = ref.sdpa_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                        causal=True, scale=sc).transpose(1, 2)
    assert (got - want).abs().max().item() < 2e-5


def test_ssd_scan_bitwise_deterministic(dev):
    """No atomics: two calls at the LM path's shape give the same bits."""
    args = _ssd_inputs(4, 1024, 80, 64, 64, dev, seed=2)
    assert torch.equal(ops.ssd_scan(*args, chunk=256),
                       ops.ssd_scan(*args, chunk=256))


def test_ssd_scan_wrapper_raises_instead_of_falling_back(dev):
    args = _ssd_inputs(1, 64, 2, 96, 16, dev)            # P > 64
    with pytest.raises(ValueError):
        ops.ssd_scan(*args, chunk=32)
    args = _ssd_inputs(1, 64, 2, 32, 16, dev)
    for dtype in (torch.float64, torch.bfloat16):         # fp32 only
        with pytest.raises(ValueError):
            ops.ssd_scan(args[0].to(dtype), *args[1:], chunk=32)
    with pytest.raises(ValueError):
        ops.ssd_scan(*args, chunk=48)                     # 48 does not divide


# -- resource measurement ------------------------------------------------------
def _reduced_config():
    """The reduced measurement config with 3 heads of 64: its 2 heads of
    96 are a head dim the attention kernel does not take."""
    import dataclasses
    from repro_torch.obs import resources as res
    cfg, ssl, train = res.measurement_config()
    return dataclasses.replace(cfg, num_heads=3, num_kv_heads=3), ssl, train


def _aligned_plan(num_layers):
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import schedule as sched
    return [p for p in sched.build_schedule(
        FLConfig(rounds=num_layers, schedule="lw_fedssl"), num_layers)
        if p.align and p.active_from > 0][0]


@pytest.mark.parametrize("engine,clients", [("sequential", 1), ("vmap", 2)])
def test_flop_count_is_device_independent(dev, engine, clients):
    """One reduced local step (a frozen block, a trained one, alignment
    on) counts the same FLOPs on the card and on the CPU, op by op: the
    kernel-backed ops are counted by formula on both. Counting changes
    neither the loss nor the kernel launches."""
    from repro_torch.obs import resources as res
    cfg, ssl, train = _reduced_config()
    plan = _aligned_plan(cfg.num_layers)
    kw = dict(cfg=cfg, ssl=ssl, train=train, clients=clients)
    cpu = res.measure_step(plan, engine, device="cpu", **kw)
    before = ops.launch_counts()
    card = res.measure_step(plan, engine, device="cuda", **kw)
    mid = ops.launch_counts()
    bare = res.measure_step(plan, engine, device="cuda", count=False, **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert card["flops"] == cpu["flops"] and card["by_op"] == cpu["by_op"]
    assert "repro_torch.attention_fwd" in card["by_op"]
    assert card["loss"] == bare["loss"]
    counted = {k: mid[k] - before[k] for k in mid}
    uncounted = {k: after[k] - mid[k] for k in mid}
    assert counted == uncounted and counted["flash_attention"] > 0


def test_measure_step_peak_is_the_steps_own(dev):
    """The peak is reset before the step: a larger allocation freed just
    before it does not count; the peak sits within ``MEMORY_FACTOR`` of the
    memory model."""
    from repro_torch.obs import resources as res
    cfg, ssl, train = _reduced_config()
    plan = _aligned_plan(cfg.num_layers)
    spike = torch.empty(4 * 2**30, dtype=torch.uint8, device=dev)
    del spike
    m = res.measure_step(plan, "sequential", cfg=cfg, ssl=ssl, train=train,
                         device="cuda")
    assert 0 < m["peak_bytes"] < 4 * 2**30
    model = res.program_memory_analytic(cfg, ssl, train, plan,
                                        "sequential")["peak_bytes"]
    assert 1 / res.MEMORY_FACTOR <= m["peak_bytes"] / model \
        <= res.MEMORY_FACTOR
    snap = res.device_memory_snapshot(dev)
    assert snap["source"] == "device" and snap["peak_bytes"] >= \
        snap["bytes_in_use"]


# ---------------------------------------------------------------------------
# secure aggregation's int64 arithmetic on the card
# ---------------------------------------------------------------------------
STAGE12_UPLOAD = 21_177_920   # floats in the ViT-Tiny stage-12 upload


def test_int64_add_wraps_on_card(dev):
    x = torch.tensor([2 ** 63 - 1, -2 ** 63, 2 ** 62, -5], dtype=torch.int64,
                     device=dev)
    y = torch.tensor([1, -1, 2 ** 62, 7], dtype=torch.int64, device=dev)
    assert (x + y).tolist() == [-2 ** 63, 2 ** 63 - 1, -2 ** 63, 2]
    assert ((x + y) - y).tolist() == x.tolist()
    acc = x.clone()
    acc += y
    acc -= y
    assert torch.equal(acc, x)


def test_masks_cover_the_full_range_on_card(dev):
    from repro_torch.privacy import SecureAggregator
    m = SecureAggregator().pair_mask((1, 2), 0, 3, 1 << 24, device=dev)
    assert m.device.type == "cuda" and m.dtype == torch.int64
    assert 0.499 < float((m < 0).double().mean()) < 0.501   # top bit
    assert int(m.max()) > 2 ** 62 and int(m.min()) < -2 ** 62
    assert torch.equal(m, SecureAggregator().pair_mask((1, 2), 3, 0,
                                                        1 << 24, device=dev))


def test_secure_sum_bit_identical_on_card_at_stage12_payload(dev):
    """Masked = unmasked on the card, and both equal the CPU's sum of the
    same flats and weights, at the ViT's stage-12 upload."""
    from repro_torch.federated.aggregate import client_weights
    from repro_torch.privacy import SecureAggregator
    agg = SecureAggregator()
    flats = [_rand((STAGE12_UPLOAD,), torch.float32, dev, s)
             for s in range(4)]
    w = client_weights([1024, 1024, 1000, 1048]).tolist()
    ids, seed = [0, 1, 2, 3], (11, 12)
    masked = agg.aggregate(flats, w, ids, seed)
    assert masked.device.type == "cuda"
    assert torch.equal(masked, agg.aggregate(flats, w, ids, seed,
                                             mask=False))
    cpu = agg.aggregate([f.cpu() for f in flats], w, ids, seed, mask=False)
    assert torch.equal(masked.cpu(), cpu)
    exact = sum(f.double() * wi for f, wi in zip(flats, w))
    assert float((masked.double() - exact).abs().max()) < 1e-6


# ---------------------------------------------------------------------------
# the prefill hand-off, expert parallelism, the sharded step (slice 15)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 256, 4, 32, 16, 64),        # four chunks
    (1, 200, 2, 20, 7, 40),         # ragged P, N and tiles
    (2, 256, 3, 64, 64, 256),       # one chunk: h0 enters chunk 0 only
])
def test_ssd_scan_kernel_from_h0(dev, B, S, H, P, N, chunk):
    """A non-zero h0: y and the final state against the plain version
    within 1e-4 of the largest value; then the gradients of every input
    and of h0 (the backward is the plain version's, fed the same h0)."""
    args = [t.clone().requires_grad_() for t in
            _ssd_inputs(B, S, H, P, N, dev, seed=4)]
    h0 = (0.5 * _rand((B, H, P, N), torch.float32, dev, 5)).requires_grad_()
    before = ops.launch_counts()["ssd_scan"]
    y, h = ops.ssd_scan(*args, chunk=chunk, h0=h0, return_state=True)
    assert ops.launch_counts()["ssd_scan"] == before + 1
    wy, wh = ref.ssd_scan_ref(*args, chunk=chunk, h0=h0, return_state=True)
    for got, want in ((y, wy), (h, wh)):
        assert (got - want).abs().max().item() <= \
            1e-4 * max(want.abs().max().item(), 1.0)
    gy = _rand(tuple(y.shape), torch.float32, dev, 6)
    gh = _rand(tuple(h.shape), torch.float32, dev, 7)
    gk = torch.autograd.grad((y * gy).sum() + (h * gh).sum(), args + [h0])
    gr = torch.autograd.grad((wy * gy).sum() + (wh * gh).sum(), args + [h0])
    for x, w in zip(gk, gr):
        assert (x - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def test_ssd_scan_kernel_in_two_parts(dev):
    """A sequence scanned as two parts, the first part's final state
    entering the second, equals one pass (the chunks align)."""
    args = _ssd_inputs(2, 512, 4, 64, 64, dev, seed=8)
    y, h = ops.ssd_scan(*args, chunk=128, return_state=True)
    y1, h1 = ops.ssd_scan(*(t[:, :256] for t in args), chunk=128,
                          return_state=True)
    y2, h2 = ops.ssd_scan(*(t[:, 256:] for t in args), chunk=128, h0=h1,
                          return_state=True)
    assert (torch.cat([y1, y2], 1) - y).abs().max().item() <= \
        1e-4 * y.abs().max().item()
    assert (h2 - h).abs().max().item() <= 1e-4 * h.abs().max().item()


def test_moe_ffn_local_card_against_cpu(dev):
    """deepseek-v2's MoE layer at ``reduced()``, its 4 experts as 2 shards:
    the partial outputs card against CPU within 1e-5 of the largest, aux
    and the drops equal."""
    from repro_torch.configs.base import load_arch, reduced
    from repro_torch.models.layers import moe
    cfg = reduced(load_arch("deepseek-v2-236b"))
    m, d = cfg.moe, cfg.d_model
    f = m.d_ff_expert
    p = {"router": 0.1 * _rand((d, m.num_experts), torch.float32, "cpu", 1),
         "w_gate": _rand((m.num_experts, d, f), torch.float32, "cpu", 2)
         / d ** 0.5,
         "w_up": _rand((m.num_experts, d, f), torch.float32, "cpu", 3)
         / d ** 0.5,
         "w_down": _rand((m.num_experts, f, d), torch.float32, "cpu", 4)
         / f ** 0.5}
    x = _rand((96, d), torch.float32, "cpu", 5)
    cap, half = moe.capacity(96, cfg), m.num_experts // 2
    for e in (0, half):
        shard = {k: v if k == "router" else v[e:e + half]
                 for k, v in p.items()}
        want, wa = moe.moe_ffn_local(shard, x, cfg, e, half, cap)
        got, ga = moe.moe_ffn_local({k: v.to(dev) for k, v in shard.items()},
                                    x.to(dev), cfg, e, half, cap)
        assert (got.cpu() - want).abs().max().item() <= \
            1e-5 * want.abs().max().item()
        assert abs(float(ga["aux"]) - float(wa["aux"])) <= 1e-6
        assert int(ga["dropped"]) == int(wa["dropped"])


def test_one_rank_sharded_step_equals_unsharded_on_card(dev):
    """``make_sharded_train_step`` on a one-rank ``nccl`` mesh: internlm2
    at ``reduced()``, batch 4 x 64; its loss and updated parameters equal
    the unsharded step's to the bit, with the same kernel launches."""
    import socket
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import load_arch, load_train, reduced
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import rules
    cfg, tc = reduced(load_arch("internlm2-1.8b")), load_train(
        "internlm2-1.8b")
    g = torch.Generator(dev).manual_seed(0)
    params = lm.init_lm(cfg, g, dev)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                              device=dev) for k in ("tokens", "labels")}
    step, opt = steps.make_train_step(cfg, tc)
    before = ops.launch_counts()
    want_p, _, want_m = step(params, opt.init(params), batch)
    want_launch = {k: v - before[k] for k, v in ops.launch_counts().items()}
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh("cuda")

        def put(tree, specs):
            return {k: distribute_tensor(v, mesh, rules.to_placements(
                specs[k], mesh)) for k, v in tree.items()}

        p_specs = rules.param_pspecs(params, mesh)
        st = opt.init(params)
        o_specs = rules.opt_state_specs(st, p_specs, tc.optimizer, mesh)
        dst = {k: (put(v, o_specs[k]) if isinstance(v, dict) else v)
               for k, v in st.items()}
        sstep, _ = steps.make_sharded_train_step(cfg, tc, mesh)
        before = ops.launch_counts()
        got_p, _, got_m = sstep(put(params, p_specs), dst,
                                put(batch, rules.batch_specs(batch, mesh)))
        got_launch = {k: v - before[k]
                      for k, v in ops.launch_counts().items()}
    finally:
        dist.destroy_process_group()
    assert torch.equal(got_m["loss"], want_m["loss"])
    for k, v in want_p.items():
        assert torch.equal(got_p[k].to_local(), v), k
    assert got_launch == want_launch


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_device_scalars_give_the_float_updates_bits_on_card(dev, name):
    """On the card a tensor divided by a Python float is a product with
    the float's fp32 reciprocal: an update given its per-step scalars as
    0-dim device tensors (a captured step's) still gives the bits of the
    update that computes them as floats."""
    from repro_torch.optim import optimizers as topt
    opt = {"adamw": topt.make_adamw(weight_decay=0.1),
           "adafactor": topt.make_adafactor(weight_decay=0.1),
           "sgdm": topt.make_sgdm(weight_decay=0.1)}[name]
    shapes = {"big": (256, 512), "vec": (40,), "stack": (3, 200, 130)}
    params = {k: _rand(s, torch.float32, dev, i)
              for i, (k, s) in enumerate(shapes.items())}
    runs = []
    for tensors in (False, True):
        p, st = dict(params), opt.init(params)
        for c in range(1, 5):
            grads = {k: _rand(s, torch.float32, dev, 10 * c + i)
                     for i, (k, s) in enumerate(shapes.items())}
            sc = None if not tensors else {
                k: torch.tensor(v, dtype=torch.float32, device=dev)
                for k, v in opt.scalars(c, 3e-3).items()}
            p, st = opt.update(grads, st, p, 3e-3, scalars=sc)
        runs.append(p)
    for k in shapes:
        assert torch.equal(runs[1][k], runs[0][k]), k


# (SSL method, optimizer): the benchmark's, and a method without a target
# branch and optimizers whose per-step scalars differ
CALIBRATION_CASES = [("moco_v3", "adamw"), ("byol", "adafactor"),
                     ("simclr", "sgdm")]


@pytest.mark.parametrize("method,optimizer", CALIBRATION_CASES)
def test_graphed_calibration_matches_eager_steps(dev, method, optimizer):
    """``server_calibrate`` at ViT-Tiny's widths and depth, batch 256, 4
    steps (one eager, one captured, the rest replayed) against a loop of
    eager ``train_step`` calls on the same draws: the same state to the
    bit; ``LAUNCHES`` up by 4 times one eager step's calls; the spans'
    modes and the replay count; the peak allocated over what was held
    before no more than 1% above the eager loop's."""
    from repro_torch import obs as tobs
    from repro_torch.configs.base import (SSLConfig, TrainConfig,
                                          load_arch)
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data.augment import two_views
    from repro_torch.data.synthetic import synthetic_images
    from repro_torch.federated import server
    from repro_torch.federated.client import train_step
    from repro_torch.federated.draws import TorchDraws
    from repro_torch.optim import make_optimizer

    cfg = load_arch("vit-tiny")
    ssl_cfg = SSLConfig(method=method)
    encoder = ssl_mod.make_vit_encoder(cfg)
    opt = make_optimizer(TrainConfig(batch_size=256, optimizer=optimizer))
    images, _ = synthetic_images(torch.Generator(dev).manual_seed(0), 512,
                                 10, 32)
    state = TorchDraws(0, dev).init_state(encoder, ssl_cfg)
    L, epochs, batch, lr, steps = cfg.num_layers, 2, 256, 3e-4, 4

    def measured(fn):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        return (out, torch.cuda.max_memory_allocated() - held,
                {k: after[k] - before[k] for k in after})

    def eager_loop():
        draws = TorchDraws(1, dev)
        st, opt_state = state, opt.init(state["online"])
        for idx, handle in draws.batch_plan(512, epochs, batch,
                                            calibration=True):
            x1, x2 = two_views(images[idx],
                               *draws.views(handle, batch, 32, 32))
            st, opt_state, _ = train_step(
                st, opt_state, x1, x2, lr, encoder=encoder, ssl_cfg=ssl_cfg,
                opt=opt, sub_layers=L, active_from=0)
        return st

    obs = tobs.make_obs(trace=True)

    def graphed():
        return server.server_calibrate(
            state, images, TorchDraws(1, dev), opt, encoder=encoder,
            ssl_cfg=ssl_cfg, sub_layers=L, epochs=epochs, batch_size=batch,
            lr=lr, tracer=obs.tracer)

    eager_loop()                                 # builds, warms the cache
    want, eager_peak, eager_calls = measured(eager_loop)
    got, graph_peak, graph_calls = measured(graphed)
    assert set(got) == set(want)
    for br in want:
        assert set(got[br]) == set(want[br])
        for k in want[br]:
            assert torch.equal(got[br][k], want[br][k]), (br, k)
    branches = 1 if method == "simclr" else 2     # online (and target)
    assert eager_calls["flash_attention"] == steps * 2 * branches * L
    assert graph_calls == eager_calls
    events = obs.tracer.events
    modes = [e["args"]["mode"] for e in events
             if e["name"] == "calibrate.step"]
    assert modes == ["eager", "capture"] + ["replay"] * (steps - 2)
    (cal,) = [e for e in events if e["name"] == "calibrate"]
    assert cal["args"]["replays"] == steps - 1
    assert graph_peak <= 1.01 * eager_peak, (graph_peak, eager_peak)


def test_graphed_step_capture_error_and_one_open_step(dev):
    """``GraphedStep``: a step that raises during its capture raises its
    own error and leaves the launch counters and the device's pool as
    they were; a second step cannot open while one is open; after close
    the next capture reuses the pool and replays right."""
    from repro_torch.federated.graphed import GraphedStep
    x = torch.arange(8, dtype=torch.float32, device=dev)
    y = torch.zeros_like(x)

    def failing():
        ops.LAUNCHES["rmsnorm_rows"] += 3
        raise ValueError("in the step")

    before = ops.launch_counts()
    with pytest.raises(ValueError, match="in the step"):
        GraphedStep(failing, dev)
    assert ops.launch_counts() == before

    def double():
        y.copy_(x * 2)

    g = GraphedStep(double, dev)
    with pytest.raises(RuntimeError, match="already open"):
        GraphedStep(double, dev)
    for k in range(3):
        x.fill_(k)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, torch.full_like(x, 2 * k))
    assert g.replays == 3
    g.close()
    h = GraphedStep(lambda: y.copy_(x + 1), dev)
    x.fill_(5)
    h.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 6))
    h.close()


# -- RoPE -----------------------------------------------------------------------
def _plain_rope(x, positions, theta=10000.0):
    """The port's RoPE before its kernel, op for op (ATen's fp32 kernels)."""
    inv = ref.rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.to(torch.float32)[..., :, None] * inv
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# (q shape, k's head count, dtype, positions: (S,) or (B, S))
ROPE_CASES = [
    ((4096, 65, 3, 64), 3, torch.bfloat16, "seq"),     # the ViT cell's
    ((1, 4096, 32, 224), 32, torch.bfloat16, "seq"),   # Zamba2-7B's block
    ((4, 1024, 32, 80), 8, torch.float32, "seq"),
    ((4, 1, 16, 128), 8, torch.bfloat16, "batch"),     # decode positions
    ((2, 33, 4, 40), 2, torch.float16, "batch"),       # half 20: scalars
]


@pytest.mark.parametrize("shape,hk,dtype,kind", ROPE_CASES)
def test_rope_kernel_bit_identical(dev, shape, hk, dtype, kind):
    """q and k in one launch, forward and backward (one more launch), and
    q alone: every output and gradient equal to the plain path's."""
    from repro_torch.models.layers import rope
    B, S = shape[:2]
    q = _rand(shape, dtype, dev, 0).requires_grad_()
    k = _rand(shape[:2] + (hk, shape[3]), dtype, dev, 1).requires_grad_()
    pos = (torch.arange(S, device=dev) if kind == "seq" else
           torch.randint(0, 4096, (B, S), device=dev))
    before = ops.launch_counts()["rope"]
    rq, rk = rope.apply_rope_qk(q, k, pos)
    assert ops.launch_counts()["rope"] == before + 1
    pq, pk = _plain_rope(q, pos), _plain_rope(k, pos)
    assert torch.equal(rq, pq) and torch.equal(rk, pk)
    gq, gk = _rand(q.shape, dtype, dev, 2), _rand(k.shape, dtype, dev, 3)
    got = torch.autograd.grad((rq, rk), (q, k), (gq, gk))
    assert ops.launch_counts()["rope"] == before + 2
    want = torch.autograd.grad((pq, pk), (q, k), (gq, gk))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(rope.apply_rope(q.detach(), pos), pq)
    assert ops.launch_counts()["rope"] == before + 3


def test_rope_kernel_mla_slice(dev):
    """deepseek-v2's MLA: the rope part of each q head, a strided slice of
    the projection, and the shared (B, S, 1, 64) key part."""
    from repro_torch.models.layers import rope
    qf = _rand((2, 1024, 128, 192), torch.bfloat16, dev, 0).requires_grad_()
    kr = _rand((2, 1024, 1, 64), torch.bfloat16, dev, 1).requires_grad_()
    part = qf[..., 128:]
    assert not part.is_contiguous()
    pos = torch.arange(1024, device=dev)
    got = [rope.apply_rope(part, pos), rope.apply_rope(kr, pos)]
    want = [_plain_rope(part, pos), _plain_rope(kr, pos)]
    gs = [_rand(t.shape, torch.bfloat16, dev, 2 + i)
          for i, t in enumerate(got)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(torch.autograd.grad(got, (qf, kr), gs),
                    torch.autograd.grad(want, (qf, kr), gs)):
        assert torch.equal(a, b)


def test_rope_kernel_under_vmap(dev):
    """16 clients of the ViT cell's (256, 65, 3, 64) under vmap: one launch
    forward and one backward, the plain path's bits."""
    from repro_torch.models.layers import rope
    C = 16
    q = _rand((C, 256, 65, 3, 64), torch.bfloat16, dev, 0).requires_grad_()
    k = _rand((C, 256, 65, 3, 64), torch.bfloat16, dev, 1).requires_grad_()
    pos = torch.arange(65, device=dev)
    before = ops.launch_counts()["rope"]
    rq, rk = torch.func.vmap(
        lambda a, b: rope.apply_rope_qk(a, b, pos))(q, k)
    assert ops.launch_counts()["rope"] == before + 1
    pq, pk = (torch.func.vmap(lambda a: _plain_rope(a, pos))(t)
              for t in (q, k))
    assert torch.equal(rq, pq) and torch.equal(rk, pk)
    gq, gk = (_rand(q.shape, torch.bfloat16, dev, s) for s in (2, 3))
    got = torch.autograd.grad((rq, rk), (q, k), (gq, gk))
    assert ops.launch_counts()["rope"] == before + 2
    want = torch.autograd.grad((pq, pk), (q, k), (gq, gk))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_rope_kernel_in_a_cuda_graph(dev):
    """Forward and backward captured with ``GraphedStep`` and replayed on
    new inputs: the plain path's bits every replay; ``LAUNCHES`` counts the
    capture's two launches once a replay."""
    from repro_torch.federated.graphed import GraphedStep
    from repro_torch.models.layers import rope
    shape = (256, 65, 3, 64)
    q, k = (_rand(shape, torch.bfloat16, dev, s) for s in (0, 1))
    g = _rand(shape, torch.bfloat16, dev, 2)
    pos = torch.arange(65, device=dev)
    outs = [torch.empty_like(q) for _ in range(4)]

    def step():
        a, b = q.detach().requires_grad_(), k.detach().requires_grad_()
        rq, rk = rope.apply_rope_qk(a, b, pos)
        ga, gb = torch.autograd.grad((rq, rk), (a, b), (g, g))
        for o, t in zip(outs, (rq, rk, ga, gb)):
            o.copy_(t)

    step()                      # eager: builds and loads the kernel
    before = ops.launch_counts()["rope"]
    graph = GraphedStep(step, dev)
    assert ops.launch_counts()["rope"] == before
    try:
        for seed in (3, 4):
            q.copy_(_rand(shape, torch.bfloat16, dev, seed))
            k.copy_(_rand(shape, torch.bfloat16, dev, seed + 10))
            graph.replay()
            torch.cuda.synchronize()
            a, b = q.clone().requires_grad_(), k.clone().requires_grad_()
            pq, pk = _plain_rope(a, pos), _plain_rope(b, pos)
            want = [pq, pk, *torch.autograd.grad((pq, pk), (a, b), (g, g))]
            for o, w in zip(outs, want):
                assert torch.equal(o, w)
    finally:
        graph.close()
    assert ops.launch_counts()["rope"] == before + 2 * 2


def test_rope_seq_table_made_in_a_capture_is_not_kept(dev):
    """A table first made while a step is captured holds nothing until a
    replay, so it is not kept: the replay computes it, and the next eager
    call builds and keeps one of its own."""
    from repro_torch.federated.graphed import GraphedStep
    from repro_torch.models.layers import rope
    want = ref.rope_table(torch.arange(77, device=dev), 64)[0]
    rope._SEQ_TABLES.clear()
    out = torch.zeros_like(want)

    def step():
        out.copy_(rope.seq_table(77, 64, 10000.0, dev)[0])

    graph = GraphedStep(step, dev)
    try:
        assert not rope._SEQ_TABLES
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    finally:
        graph.close()
    assert torch.equal(rope.seq_table(77, 64, 10000.0, dev)[0], want)
    assert len(rope._SEQ_TABLES) == 1


def test_rope_wrapper_raises_instead_of_falling_back(dev):
    """The kernel launches or raises: a layout, dtype or table it does not
    take is refused (``ops`` makes a strided x contiguous first)."""
    from repro_torch.kernels import rope as rp
    x = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16, device=dev)
    c = torch.zeros((8, 32), device=dev)
    for xs, cs in [([x.transpose(1, 2)], (c, c)),          # strided
                   ([x.double()], (c, c)),                 # float64
                   ([x[..., :63].contiguous()], (c, c)),   # odd head dim
                   ([x, x.float()], (c, c)),               # two dtypes
                   ([x], (c.bfloat16(), c.bfloat16())),    # table dtype
                   ([x], (c[:7].contiguous(),) * 2),       # wrong S
                   ([x], (c[:, :16].contiguous(),) * 2),   # wrong width
                   ([x.cpu()], (c, c))]:                   # device
        with pytest.raises(ValueError):
            rp.rope_rotate(xs, *cs)
    with pytest.raises(ValueError):
        ops.rope(x.double(), c, c)
    strided = torch.ones((2, 2, 8, 64), dtype=torch.bfloat16,
                         device=dev).transpose(1, 2)
    assert torch.equal(ops.rope(strided, torch.ones_like(c), c), strided)
