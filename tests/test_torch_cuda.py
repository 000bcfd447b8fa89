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
