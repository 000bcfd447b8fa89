"""RoPE through the port's kernel wrappers on the CPU (``kernels.ops.rope``,
``rope_qk``, ``RopeFn``; ``models.layers.rope``), against the JAX package's
``apply_rope`` and against plain autograd of the arithmetic the port ran
before the kernel (``_plain``, below).

The JAX package's RoPE is jnp code (``src/repro/models/layers/rope.py``),
not a Pallas kernel, so ``ref.rope_ref`` is held to it directly. On the
CPU the wrappers run ``ref.rope_ref``, forward and backward (the rotation
with the sin negated), so every output and gradient here is the plain
arithmetic's to the bit, under ``vmap`` too; the card tests
(``tests/test_torch_cuda.py``) hold the CUDA kernel to the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import rope as trope

# hd 40: half 20, not a multiple of 8, so the card takes its scalar path
HEAD_DIMS = [64, 80, 224, 40]
S = 65          # the ViT's positions: CLS and 64 patches


def _plain(x, positions, theta=10000.0):
    """The port's RoPE before the kernel, op for op."""
    inv = ref.rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.to(torch.float32)[..., :, None] * inv
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _positions(kind, batch, gen):
    if kind == "seq":
        return torch.arange(S)
    return torch.randint(0, S, (batch, S), generator=gen)


def _rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen).to(dtype)


@pytest.mark.parametrize("kind", ["seq", "batch"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_ref_matches_jax(dtype, hd, kind):
    """fp32 within 1e-6: both packages round the same angle products, and
    their cos / sin (and, at hd 224, one frequency's ``pow``) differ by an
    ulp; positions stay below 65, since an angle's error grows with its
    position. bf16 within one bf16 rounding of the largest output (2^-7 of
    it): an fp32 ulp apart can round to neighbouring bf16 values."""
    import jax.numpy as jnp
    from repro.models.layers import rope as jrope

    gen = torch.Generator().manual_seed(hd)
    x = torch.randn(3, S, 4, hd, generator=gen)
    pos = _positions(kind, 3, gen)
    jx = jnp.asarray(x.numpy())
    if dtype == "bfloat16":
        jx, x = jx.astype(jnp.bfloat16), x.to(torch.bfloat16)
    want = np.asarray(jrope.apply_rope(jx, jnp.asarray(pos.numpy()))
                      .astype(jnp.float32))
    got = ref.rope_ref(x, *ref.rope_table(pos, hd)).float().numpy()
    tol = 1e-6 if dtype == "float32" else float(np.abs(want).max()) * 2 ** -7
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("kind", ["seq", "batch"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_matches_plain_autograd(dtype, hd, kind):
    """``apply_rope_qk`` (q and k of other head counts, one table) and
    ``apply_rope``: outputs and gradients equal to plain autograd's."""
    gen = torch.Generator().manual_seed(7 + hd)
    pos = _positions(kind, 2, gen)
    q = _rand((2, S, 4, hd), dtype, gen).requires_grad_()
    k = _rand((2, S, 2, hd), dtype, gen).requires_grad_()
    gq, gk = _rand(q.shape, dtype, gen), _rand(k.shape, dtype, gen)
    rq, rk = trope.apply_rope_qk(q, k, pos)
    pq, pk = _plain(q, pos), _plain(k, pos)
    assert torch.equal(rq, pq) and torch.equal(rk, pk)
    assert torch.equal(trope.apply_rope(q, pos), pq)
    got = torch.autograd.grad((rq, rk), (q, k), (gq, gk))
    want = torch.autograd.grad((pq, pk), (q, k), (gq, gk))
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["seq", "batch"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_rope_under_vmap_matches_plain(hd, kind):
    """A client axis under ``torch.func.vmap`` (the vmap engines): the
    rule folds it into one call; outputs, gradients through the folded
    node (the engines' route) and ``torch.func.grad`` inside the vmap all
    equal the plain arithmetic's."""
    C, dtype = 4, torch.bfloat16
    gen = torch.Generator().manual_seed(11 + hd)
    pos = _positions(kind, 2, gen)
    q = _rand((C, 2, S, 3, hd), dtype, gen).requires_grad_()
    k = _rand((C, 2, S, 3, hd), dtype, gen).requires_grad_()
    rq, rk = torch.func.vmap(
        lambda a, b: trope.apply_rope_qk(a, b, pos))(q, k)
    pq, pk = (torch.func.vmap(lambda a: _plain(a, pos))(t) for t in (q, k))
    assert torch.equal(rq, pq) and torch.equal(rk, pk)
    gq, gk = _rand(q.shape, dtype, gen), _rand(k.shape, dtype, gen)
    got = torch.autograd.grad((rq, rk), (q, k), (gq, gk))
    want = torch.autograd.grad((pq, pk), (q, k), (gq, gk))
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    def loss(fn):
        return lambda a: (fn(a).float() ** 2).sum()

    f_got = torch.func.vmap(torch.func.grad(
        loss(lambda a: trope.apply_rope(a, pos))))(q.detach())
    f_want = torch.func.vmap(torch.func.grad(
        loss(lambda a: _plain(a, pos))))(q.detach())
    assert torch.equal(f_got, f_want)


@pytest.mark.parametrize("kind", ["seq", "batch"])
def test_rope_with_per_client_positions_under_vmap(kind):
    """Positions vmapped beside x (a table per client): the rule lays the
    table out over x's leading dims."""
    C, hd = 3, 64
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(C, 2, S, 4, hd, generator=gen)
    shape = (C, S) if kind == "seq" else (C, 2, S)
    pos = torch.randint(0, 1000, shape, generator=gen)
    got = torch.func.vmap(trope.apply_rope)(x, pos)
    want = torch.func.vmap(_plain)(x, pos)
    assert torch.equal(got, want)


def test_rope_of_a_strided_slice():
    """MLA's ``q_rope``: the rope part of each head, a non-contiguous
    slice of the projected q."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, S, 4, 48 + 16, generator=gen, requires_grad=True)
    part = q[..., 48:]
    assert not part.is_contiguous()
    pos = torch.arange(S)
    got = trope.apply_rope(part, pos)
    want = _plain(part, pos)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=gen)
    assert torch.equal(torch.autograd.grad(got, q, g)[0],
                       torch.autograd.grad(want, q, g)[0])


def test_rope_counts_no_launch_on_the_cpu():
    ops.reset_launch_counts()
    x = torch.ones(2, S, 3, 64, requires_grad=True)
    a, b = trope.apply_rope_qk(x, x, torch.arange(S))
    (a.sum() + b.sum()).backward()
    trope.apply_rope(x, torch.arange(S))
    assert ops.LAUNCHES["rope"] == 0
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("x_ndim,t_ndim,heads,want", [
    # (B, S, H, hd) by (S, hd/2): batch split, table whole; heads
    (4, 2, True, [("R", "R"), (0, "R"), (2, "R")]),
    # (B, S, H, hd) by (B, S, hd/2): the table split with the batch
    (4, 3, True, [("R", "R"), (0, 0), (2, "R")]),
    # a vmap-folded (C, B, S, H, hd) by (B, S, hd/2); no head split
    (5, 3, False, [("R", "R"), (0, "R"), (1, 0)]),
])
def test_rope_sharding_rules(x_ndim, t_ndim, heads, want):
    """Over batch dims (the table's matching dim alike) or heads; S and hd
    never split."""
    from torch.distributed.tensor import Replicate, Shard

    def place(p):
        return Replicate() if p == "R" else Shard(p)

    got = ops._rope_rules(x_ndim, t_ndim, heads)
    assert got == [(place(a), place(b)) for a, b in want]


def test_rope_op_runs_on_meta_through_its_fake():
    """Under a dispatch mode the wrappers take the custom ops, whose fakes
    give the shapes on ``meta`` (the dry run)."""
    from torch.utils.flop_counter import FlopCounterMode

    q = torch.empty(2, S, 4, 64, device="meta")
    k = torch.empty(2, S, 2, 64, device="meta")
    with FlopCounterMode(display=False) as fc:
        rq, rk = trope.apply_rope_qk(q, k, torch.arange(S, device="meta"))
        r1 = trope.apply_rope(q, torch.arange(S, device="meta"))
    assert rq.shape == q.shape and rk.shape == k.shape and \
        r1.shape == q.shape and rq.device.type == "meta"
    assert fc.get_total_flops() == 0


def test_seq_table_is_kept_with_a_fresh_builds_bits():
    """The table of positions 0..S-1 is built once per (S, head dim,
    theta, device) and then handed back as it is, equal to a fresh
    ``rope_table``; under vmap (unbatched positions) it is kept too."""
    trope._SEQ_TABLES.clear()
    cos, sin = trope.seq_table(17, 64, 10000.0, torch.device("cpu"))
    again = trope.seq_table(17, 64, 10000.0, "cpu")
    assert again[0] is cos and again[1] is sin
    fresh = ref.rope_table(torch.arange(17), 64, 10000.0)
    assert torch.equal(cos, fresh[0]) and torch.equal(sin, fresh[1])
    assert trope.seq_table(17, 64, 500000.0, "cpu")[0] is not cos
    trope._SEQ_TABLES.clear()
    torch.func.vmap(lambda x: x + trope.seq_table(9, 8, 1e4, "cpu")[0]
                    .sum())(torch.ones(3))
    assert (9, 8, 1e4, torch.device("cpu")) in trope._SEQ_TABLES


@pytest.mark.parametrize("where", ["inference_mode", "dispatch_mode"])
def test_seq_table_is_not_kept_where_it_could_not_be_reused(where):
    """An inference-mode table cannot be saved for a later backward, and a
    dispatch mode (the FLOP counter, the sharded steps' layouts) may hand
    back tensors of its own: such a table is used once."""
    from torch.utils.flop_counter import FlopCounterMode
    trope._SEQ_TABLES.clear()
    ctx = (torch.inference_mode() if where == "inference_mode"
           else FlopCounterMode(display=False))
    with ctx:
        cos, _ = trope.seq_table(11, 16, 10000.0, "cpu")
    assert not trope._SEQ_TABLES
    assert torch.equal(cos, ref.rope_table(torch.arange(11), 16)[0])
