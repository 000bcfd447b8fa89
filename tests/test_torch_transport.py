"""The port's wire transport against the JAX package's: for every plan of
every schedule, the same payload slots (paths, offsets, sizes), fp32 flat
buffers and unpacked trees bit for bit, and wire bytes equal to the
analytic ``comm.round_comm_bytes``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import schedule as jsched
from repro.core import ssl as jssl
from repro.federated import comm as jcomm
from repro.federated import transport as jtransport
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import schedule as sched
from repro_torch.federated import aggregate, comm
from repro_torch.federated.transport import (Transport, pack_stage_payload,
                                             unpack_stage_payload)

torch.set_num_threads(2)

JCFG = jbase.ModelConfig("t-vit", "dense", 3, 32, 2, 2, 64, 0, causal=False,
                         compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=48, pred_hidden=48, proj_dim=16)


@pytest.fixture(scope="module")
def online():
    enc = jssl.make_vit_encoder(JCFG)
    state = jssl.ssl_init(jax.random.PRNGKey(0), enc, jbase.SSLConfig(**SSL))
    return state["online"]


@pytest.mark.parametrize("schedule", jsched.SCHEDULES)
@pytest.mark.parametrize("include_heads", [True, False])
def test_payloads_match_reference(online, schedule, include_heads):
    kw = dict(rounds=6, schedule=schedule, include_heads=include_heads)
    jplans = jsched.build_schedule(jbase.FLConfig(**kw), 3)
    plans = sched.build_schedule(tbase.FLConfig(**kw), 3)
    jwire = jtransport.Transport("fp32", include_heads=include_heads)
    wire = Transport(include_heads=include_heads)
    tonline = convert.from_numpy_tree(jax.device_get(online))
    rng = np.random.default_rng(1)
    for jplan, plan in zip(jplans, plans):
        jspecs = jwire.plan_specs(online, jplan)
        specs = wire.plan_specs(tonline, plan)
        cb = comm.round_comm_bytes(tonline, plan, include_heads=include_heads)
        assert cb == jcomm.round_comm_bytes(online, jplan,
                                            include_heads=include_heads)
        for d in ("download", "upload"):
            js, s = jspecs[d], specs[d]
            assert [(x.path, x.kind, x.lo, x.hi, x.shape, x.offset, x.size)
                    for x in s.slots] == \
                [(x.path, x.kind, x.lo, x.hi, x.shape, x.offset, x.size)
                 for x in js.slots]
            assert s.layout == jtransport.slot_pack_layout(js)
            assert wire.wire_bytes(s) == jwire.wire_bytes(js) == cb[d]
            flat = pack_stage_payload(tonline, s)
            jflat = np.asarray(jtransport.pack_stage_payload(online, js))
            np.testing.assert_array_equal(flat.numpy(), jflat)
            new = rng.standard_normal(s.total).astype(np.float32)
            got = unpack_stage_payload(tonline, torch.from_numpy(new), s)
            want = convert.flatten_tree(jax.device_get(
                jtransport.unpack_stage_payload(online, new, js)))
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_uploads_leave_the_server_tree_alone_and_average(online):
    """Every client's upload scatters into a copy of the server's tree, so
    one client's payload never reaches the next one's base."""
    plan = sched.build_schedule(tbase.FLConfig(rounds=3,
                                               schedule="lw_fedssl"), 3)[1]
    server = convert.from_numpy_tree(jax.device_get(online))
    before = {k: v.clone() for k, v in server.items()}
    outs = [{k: v + (i + 1) for k, v in server.items()} for i in range(2)]
    w = aggregate.client_weights([30, 10])
    new, stats = Transport().aggregate_uploads(server, outs, [0, 1], plan, w)
    spec = Transport().plan_specs(server, plan)["upload"]
    assert stats["wire_bytes"] == spec.payload_bytes
    for k, v in server.items():
        assert torch.equal(v, before[k])
    moved = {"/".join(s.path) for s in spec.slots}
    for k, v in new.items():
        if k in moved and "blocks" not in k:
            torch.testing.assert_close(v, server[k] + 1.25)
        elif k not in moved:
            torch.testing.assert_close(v, server[k])
    # the uploaded stage row moved, the others kept the server's values
    wq = new["enc/blocks/attn/wq"]
    torch.testing.assert_close(wq[1], server["enc/blocks/attn/wq"][1] + 1.25)
    torch.testing.assert_close(wq[0], server["enc/blocks/attn/wq"][0])


def _np_tree(tree):
    return convert.flatten_tree(jax.device_get(tree))


def _match(got, want, what, atol=0.0):
    """Port tree (flat dict or tensor) against a reference tree or array:
    bit for bit, or within ``atol``."""
    if isinstance(got, torch.Tensor):
        got, want = {"": got}, {"": np.asarray(want)}
    else:
        want = _np_tree(want)
        assert list(got) == list(want), what
    for k in want:
        if atol:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=atol, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{what} {k}")


@pytest.mark.parametrize("codec", ["fp32", "fp16", "bf16", "int8",
                                   "topk:0.2"])
@pytest.mark.parametrize("schedule", ["lw_fedssl", "e2e", "progressive"])
def test_codec_transport_matches_reference(online, codec, schedule):
    """Six rounds over three stages (two rounds a stage), two clients: the
    server's model moves every round and the clients upload the broadcast
    plus noise, all made with numpy and handed to the port's transport and
    to both of the reference's wire engines.

    Bit for bit against the reference's ``pallas`` engine (on the CPU, its
    numpy path, which does the eager codec math). Against its ``xla``
    engine the same, except int8: jit'd XLA fuses the scale division and
    can differ from the eager math by one ulp in a scale (the parity
    contract allows one quantum; decoded trees within 1e-6)."""
    kw = dict(rounds=6, schedule=schedule)
    jplans = jsched.build_schedule(jbase.FLConfig(**kw), 3)
    plans = sched.build_schedule(tbase.FLConfig(**kw), 3)
    engines = {"pallas": (jtransport.Transport(codec, kernels="pallas"),
                          0.0),
               "xla": (jtransport.Transport(codec),
                       1e-6 if codec == "int8" else 0.0)}
    wire = Transport(codec)
    rng = np.random.default_rng(2)
    server = jax.device_get(online)
    ids = ["a", "b"]

    def noisy(tree):
        return jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(
            a.shape).astype(np.float32), tree)

    for r, plan in enumerate(plans):
        jplan = jplans[r]
        server = noisy(server)
        tserver = convert.from_numpy_tree(server)
        specs = wire.plan_specs(tserver, plan)
        view, stats = wire.broadcast(tserver, plan)
        if wire.codec.delta:        # a dense re-sync under a new layout
            resync = plan.new_stage or r == 0
            assert (stats["wire_bytes"] == specs["download"].payload_bytes) \
                == resync
        up = specs["upload"]
        held = [wire._resid.get(c) for c in ids]
        for h, x in zip(held, wire.gather_residuals(ids, up, "cpu")):
            if wire.codec.error_feedback and (h is None or h[0] != up):
                assert not torch.any(x)      # reset at a layout change
        # the clients' trees: the broadcast plus noise, in numpy
        base = convert.to_numpy_tree(view)
        outs = [noisy(base) for _ in ids]
        trees, ustats = wire.decode_uploads(
            tserver, [convert.from_numpy_tree(o) for o in outs], ids, plan,
            ref_online=view)
        for name, (jwire, atol) in engines.items():
            what = f"{codec}/{schedule}/{name} round {r}"
            jspecs = jwire.plan_specs(server, jplan)
            for d in ("download", "upload"):
                assert wire.wire_bytes(specs[d]) == \
                    jwire.wire_bytes(jspecs[d]), what
            jserver = jax.tree.map(jnp.asarray, server)
            jview, jstats = jwire.broadcast(jserver, jplan)
            assert stats == jstats, what
            _match(view, jview, f"{what} view", atol)
            if wire.codec.delta:
                _match(wire._mirror[1], jwire._mirror[1], f"{what} mirror")
            jtrees, justats = jwire.decode_uploads(
                jserver, outs, ids, jplan,
                ref_online=jax.tree.map(jnp.asarray, base))
            assert ustats["wire_bytes"] == justats["wire_bytes"], what
            for i, (t, jt) in enumerate(zip(trees, jtrees)):
                _match(t, jt, f"{what} upload {i}", atol)
            if wire.codec.error_feedback:
                jres = jwire.gather_residuals(ids, jspecs["upload"])
                for i, c in enumerate(ids):
                    assert wire._resid[c][0] == up
                    _match(wire._resid[c][1], jres[i],
                           f"{what} residual {c}")
