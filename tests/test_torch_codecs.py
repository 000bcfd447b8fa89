"""The port's wire codecs against the JAX package's, on the CPU: each plain
version (what the port's wrappers run on CPU tensors, and what the CUDA
kernels are held to on the card) against the Pallas kernel it replaces, run
in interpret mode, and against the reference's codec math.

The parity contract (``docs/kernels.md``): casts, dequant and compensate
bit-identical; int8 bit-identical to the eager codec math and within one
quantum of the interpreter, which divides by reciprocal-multiply; top-k
with the exact selected set, decoded payload and residual (the wire's
index order may differ: the port's is position order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import transport as jtransport
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import wire_codecs as jwc
from repro_torch.federated import transport
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

# the port's EF update scans 4096-element tiles (EF_TILE in
# csrc/wire_codecs.cu)
EF_CHUNK = 8192


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _segs(shapes):
    segs, off, soff = [], 0, 0
    for rows, ch in shapes:
        segs.append((off, rows * ch, ch, soff))
        off += rows * ch
        soff += ch
    return tuple(segs), off, soff


# a (64, 8) matrix, a 40-vector with one scale, a (5, 300) matrix, a
# (3, 2) slot that keeps one scale (fewer than 4 rows)
INT8_SHAPES = [(64, 8), (40, 1), (5, 300), (6, 1)]


def test_casts_bit_identical():
    flat = _normal(1000, 0, 300.0)
    for name, jdt in (("fp16", jnp.float16), ("bf16", jnp.bfloat16)):
        codec = transport.make_codec(name)
        wire = codec.encode(torch.from_numpy(flat), None)["q"]
        want = np.asarray(jnp.asarray(flat).astype(jdt))
        np.testing.assert_array_equal(wire.float().numpy(),
                                      want.astype(np.float32))
        np.testing.assert_array_equal(
            codec.decode({"q": wire}, None).numpy(),
            np.asarray(jnp.asarray(want).astype(jnp.float32)))


def test_int8_bit_identical_to_codec_math():
    segs, total, nscales = _segs(INT8_SHAPES)
    flat = _normal(total, 1, 3.0)
    q, scales = ops.wire_int8_encode(torch.from_numpy(flat), segs, nscales)
    wq, ws = [], []
    for off, size, ch, _ in segs:
        a, b = jref.int8_quant_ref(jnp.asarray(flat[off:off + size])
                                   .reshape(-1, ch))
        wq.append(np.asarray(a).reshape(-1))
        ws.append(np.asarray(b))
    np.testing.assert_array_equal(q.numpy(), np.concatenate(wq))
    np.testing.assert_array_equal(scales.numpy(), np.concatenate(ws))
    dec = ops.wire_int8_decode(q, scales, segs, total)
    want = np.concatenate([
        np.asarray(jref.int8_dequant_ref(jnp.asarray(a).reshape(-1, ch),
                                         jnp.asarray(b))).reshape(-1)
        for a, b, (_, _, ch, _) in zip(wq, ws, segs)])
    np.testing.assert_array_equal(dec.numpy(), want)


def test_int8_within_one_quantum_of_pallas_interpret():
    segs, total, nscales = _segs(INT8_SHAPES)
    flat = _normal(total, 2, 3.0)
    q, scales = ops.wire_int8_encode(torch.from_numpy(flat), segs, nscales)
    jq, js = jops.wire_int8_encode(jnp.asarray(flat), segs, nscales,
                                   interpret=True)
    assert np.abs(q.numpy().astype(np.int32)
                  - np.asarray(jq).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(scales.numpy(), np.asarray(js), rtol=1e-6)
    # dequant on the same wire: bit-identical, matrix by matrix
    for off, size, ch, soff in segs:
        qm = q.numpy()[off:off + size].reshape(-1, ch)
        sm = scales.numpy()[soff:soff + ch]
        got = ref.int8_dequant_ref(torch.from_numpy(qm), torch.from_numpy(sm))
        want = jwc.int8_dequant_matrix(jnp.asarray(qm), jnp.asarray(sm),
                                       interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_res", [False, True])
def test_compensate_bit_identical_to_pallas(with_res):
    n = 3001
    flat, base = _normal(n, 3), _normal(n, 4)
    res = _normal(n, 5, 0.1) if with_res else None
    c, a = ops.compensate(torch.from_numpy(flat), torch.from_numpy(base),
                          None if res is None else torch.from_numpy(res))
    jc, ja = jwc.compensate(jnp.asarray(flat), jnp.asarray(base),
                            jnp.zeros(n, jnp.float32) if res is None
                            else jnp.asarray(res), interpret=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def _tie_flat():
    return np.tile(np.asarray([5.0, -3.0, 3.0, 1.0, 3.0, -5.0], np.float32),
                   40)


def _zero_delta(n=5 * EF_CHUNK + 321, hot=700, seed=6):
    """Mostly exact zeros, as an LW-FedSSL download delta is: the k-th
    magnitude is 0 and its ties straddle several of the port's blocks."""
    x = np.zeros(n, np.float32)
    rng = np.random.default_rng(seed)
    x[rng.choice(n, hot, replace=False)] = _normal(hot, seed + 1)
    return x


# (comp, k): random values, the tie case of the reference's
# test_wire_topk_breaks_ties_like_top_k (80 entries of |x| = 5, ties at
# |x| = 3), and a zero threshold with ties over several blocks
TOPK_CASES = {"random": (_normal(700, 8), 70),
              "ties": (_tie_flat(), 100),
              "zero_threshold": (_zero_delta(), 4 * EF_CHUNK + 5)}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_ef_update_bit_identical_to_pallas(case):
    comp, k = TOPK_CASES[case]
    t = torch.from_numpy(comp)
    thresh, needed = ref.topk_threshold(t.abs(), k)
    new_res, idx, val = ops.topk_ef_update(t, thresh, needed, k)
    want = jwc.topk_ef_update(jnp.asarray(comp),
                              jnp.asarray([float(thresh)], jnp.float32),
                              jnp.asarray([int(needed)], jnp.int32),
                              interpret=True)
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(want))
    assert idx.numel() == k and torch.equal(val, t[idx.long()])
    if case == "zero_threshold":
        assert float(thresh) == 0.0 and int(needed) > 3 * EF_CHUNK


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
@pytest.mark.parametrize("tile", [1, 64, 1000, EF_CHUNK])
@pytest.mark.parametrize("keep", ["needed", "none"])
def test_topk_ef_update_tiled_matches_plain_and_pallas(case, tile, keep):
    """The CUDA kernel's chained scan in plain PyTorch: per-tile counts and
    each tile's first slot gt_prefix + min(needed, tie_prefix) give the
    plain version's bits, and the Pallas kernel's residual, at every tile
    size; with ``needed`` as top-k gives it, and with no tie kept."""
    comp, k = TOPK_CASES[case]
    t = torch.from_numpy(comp)
    thresh, needed = ref.topk_threshold(t.abs(), k)
    if keep == "none":
        needed = torch.zeros_like(needed)
    got = ref.topk_ef_update_tiled(t, thresh, needed, tile)
    want = ref.topk_ef_update_ref(t, thresh, needed)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    pallas = jwc.topk_ef_update(jnp.asarray(comp),
                                jnp.asarray([float(thresh)], jnp.float32),
                                jnp.asarray([int(needed)], jnp.int32),
                                interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(pallas))
    assert got[1].numel() == int((t.abs() > thresh).sum()) + int(needed)


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
@pytest.mark.parametrize("with_res", [False, True])
def test_topk_encode_matches_reference(case, with_res):
    comp, k = TOPK_CASES[case]
    n = comp.shape[0]
    base = _normal(n, 9)
    flat = comp + base
    res = _normal(n, 10, 0.01) if with_res else None
    idx, val, new_res = ops.wire_topk_encode_ef(
        torch.from_numpy(flat), torch.from_numpy(base),
        None if res is None else torch.from_numpy(res), k)
    jres = jnp.zeros(n, jnp.float32) if res is None else jnp.asarray(res)
    ridx, _, rres, rdec = jref.topk_ef_ref(jnp.asarray(flat),
                                           jnp.asarray(base), jres, k)
    pidx, pval, pres = jops.wire_topk_encode_ef(
        jnp.asarray(flat), jnp.asarray(base),
        None if res is None else jnp.asarray(res), k, interpret=True)
    got_set = sorted(idx.tolist())
    assert got_set == sorted(np.asarray(ridx).tolist()) \
        == sorted(np.asarray(pidx).tolist())
    assert got_set == idx.tolist()          # position order
    dec = ops.wire_topk_decode(idx, val, n)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(rdec))
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jops.wire_topk_decode(pidx, pval, n,
                                                      interpret=True)))
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(rres))
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(pres))
    # the whole-upload plain version is the same function
    widx, wval, wres, wdec = ref.topk_ef_ref(
        torch.from_numpy(flat), torch.from_numpy(base),
        None if res is None else torch.from_numpy(res), k)
    assert torch.equal(widx, idx) and torch.equal(wres, new_res) \
        and torch.equal(wdec, dec)


@pytest.mark.parametrize("name", ["fp32", "fp16", "bf16", "int8", "topk",
                                  "topk:0.05"])
def test_codec_registry_and_names(name):
    codec = transport.make_codec(name)
    jcodec = jtransport.make_codec(name)
    assert codec.name == jcodec.name
    assert (codec.delta, codec.error_feedback) == \
        (jcodec.delta, jcodec.error_feedback)
    with pytest.raises(ValueError):
        transport.make_codec("int4")
