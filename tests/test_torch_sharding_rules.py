"""The port's sharding rules against the JAX package's.

For every architecture of the reference's ``ASSIGNED`` list, on its two
production meshes ((16, 16) and (2, 16, 16), the duck meshes of
``conftest.py``), the port's specs equal the reference's ``PartitionSpec``s
entry for entry: parameters (on ``meta``), the optimizer state of AdamW,
SGDM and Adafactor, the decode caches at batch 128 and 1, and the batches.
Exact: a spec is a tuple of axis names. Then the reference's eight checks
of ``tests/test_sharding_rules.py`` on the port alone, and the DTensor
placements and local shapes a spec gives.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs.base import ARCH_IDS, INPUT_SHAPES, load_arch
from repro.launch import inputs as jinputs
from repro.launch.steps import is_encdec
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.optim import make_optimizer as jmake_optimizer
from repro.sharding import rules as jrules
from repro_torch.configs import base as tbase
from repro_torch.launch import inputs as tinputs
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.optim import make_optimizer
from repro_torch.sharding import rules

ASSIGNED = [a for a in ARCH_IDS if a != "vit-tiny"]
OPTIMIZERS = ("adamw", "sgdm", "adafactor")


def _jflat(specs) -> dict:
    """A reference spec tree as {"/"-joined key path: tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _tflat(tree, prefix="") -> dict:
    """A port spec tree (nested dicts of tuples) flattened the same way."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


@pytest.fixture(scope="module")
def shapes():
    """{arch: (the reference's eval_shape params, the port's meta
    params)}, built once."""
    out = {}
    for arch in ASSIGNED:
        cfg = load_arch(arch)
        out[arch] = (jinputs.param_shapes(cfg),
                     tinputs.param_shapes(tbase.load_arch(arch)))
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_and_opt_specs_match_reference(arch, multi_pod, shapes,
                                             mesh16x16, mesh2x16x16):
    mesh = mesh2x16x16 if multi_pod else mesh16x16
    jshapes, tshapes = shapes[arch]
    jspecs = jrules.param_pspecs(jshapes, mesh)
    tspecs = rules.param_pspecs(tshapes, mesh)
    assert _tflat(tspecs) == _jflat(jspecs)
    for name in OPTIMIZERS:
        tcfg = dataclasses.replace(tbase.TrainConfig(), optimizer=name)
        jopt = jmake_optimizer(dataclasses.replace(
            jinputs.load_train(arch), optimizer=name))
        jst = jax.eval_shape(jopt.init, jshapes)
        want = _jflat(jrules.opt_state_specs(jst, jspecs, name, mesh))
        tst = make_optimizer(tcfg).init(tshapes)
        got = _tflat(rules.opt_state_specs(tst, tspecs, name, mesh))
        assert got == want, name


@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_specs_match_reference(arch, multi_pod, batch, mesh16x16,
                                     mesh2x16x16):
    mesh = mesh2x16x16 if multi_pod else mesh16x16
    jcfg, tcfg = load_arch(arch), tbase.load_arch(arch)
    if is_encdec(jcfg):
        jc = jax.eval_shape(lambda: jencdec.init_dec_caches(jcfg, batch,
                                                            32768))
        tc = tencdec.init_dec_caches(tcfg, batch, 32768, device="meta")
    else:
        jc = jax.eval_shape(lambda: jlm.init_caches(jcfg, batch, 32768))
        tc = tlm.init_caches(tcfg, batch, 32768, device="meta")
    want = _jflat(jrules.cache_pspecs(jc, mesh, batch))
    assert rules.cache_pspecs(tc, mesh, batch) == want


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_batch_specs_match_reference(arch, multi_pod, mesh16x16,
                                     mesh2x16x16):
    mesh = mesh2x16x16 if multi_pod else mesh16x16
    for shape in INPUT_SHAPES.values():
        jb = jinputs.batch_shapes(load_arch(arch), shape, for_train=True)
        tb = tinputs.batch_shapes(tbase.load_arch(arch), shape,
                                  for_train=True)
        assert rules.batch_specs(tb, mesh) == \
            _jflat(jrules.batch_specs(jb, mesh))


# ---------------------------------------------------------------------------
# the reference's checks, on the port alone
# ---------------------------------------------------------------------------
def _check_divisible(shapes, specs, mesh):
    for path, leaf in shapes.items():
        for dim, entry in enumerate(specs[path]):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = int(np.prod([mesh.shape[a] for a in axes]))
            assert leaf.shape[dim] % n == 0, (path, leaf.shape, specs[path])


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_divisible(arch, shapes, mesh16x16, mesh2x16x16):
    tshapes = shapes[arch][1]
    for mesh in (mesh16x16, mesh2x16x16):
        _check_divisible(tshapes, rules.param_pspecs(tshapes, mesh), mesh)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b",
                                  "zamba2-2.7b", "xlstm-125m"])
def test_big_weights_actually_sharded(arch, shapes, mesh16x16):
    """The large 2D weights must not silently fall back to replication."""
    tshapes = shapes[arch][1]
    specs = rules.param_pspecs(tshapes, mesh16x16)
    big = [k for k, v in tshapes.items() if v.numel() > 1e6]
    assert big and all(any(e is not None for e in specs[k]) for k in big)


@pytest.mark.parametrize("arch", ["internlm2-20b", "deepseek-v2-236b",
                                  "zamba2-2.7b"])
@pytest.mark.parametrize("batch", [128, 1])
def test_cache_specs_divisible(arch, batch, mesh16x16):
    caches = tlm.init_caches(tbase.load_arch(arch), batch, 32768,
                             device="meta")
    _check_divisible(caches, rules.cache_pspecs(caches, mesh16x16, batch),
                     mesh16x16)


def test_batch1_cache_context_parallel(mesh16x16):
    """global_batch=1 long decode: the seq dim shards over ALL axes."""
    caches = tlm.init_caches(tbase.load_arch("internlm2-20b"), 1, 524288,
                             device="meta")
    # (L, B, W, H, hd): the W entry uses both axes
    assert rules.cache_pspecs(caches, mesh16x16, 1)["k"][2] == \
        ("data", "model")


def test_batch_specs(mesh16x16):
    b = {"tokens": types.SimpleNamespace(shape=(256, 4096)),
         "odd": types.SimpleNamespace(shape=(7, 3))}
    specs = rules.batch_specs(b, mesh16x16)
    assert specs["tokens"][0] == "data"
    assert specs["odd"][0] is None      # 7 not divisible -> replicate


def test_moe_expert_parallel(shapes, mesh16x16):
    # llama4 interleaves MoE blocks: expert stacks live under "moe_blocks"
    wg = rules.param_pspecs(shapes["llama4-maverick-400b-a17b"][1],
                            mesh16x16)["moe_blocks/moe/w_gate"]
    # (G, E, d, ff): experts over model, d over data
    assert wg[1] == "model" and wg[2] == "data"
    # deepseek is all-MoE (uniform): experts under "blocks"
    wg2 = rules.param_pspecs(shapes["deepseek-v2-236b"][1],
                             mesh16x16)["blocks/moe/w_gate"]
    assert wg2[1] == "model" and wg2[2] == "data"


def test_slstm_cache_spec_batch_axis(mesh2x16x16):
    """sLSTM state leaves are (..., B, d); 'n'/'m' must not be mistaken for
    the mLSTM leaves of the same name."""
    caches = tlm.init_caches(tbase.load_arch("xlstm-125m"), 128, 32768,
                             device="meta")
    specs = rules.cache_pspecs(caches, mesh2x16x16, 128)
    _check_divisible(caches, specs, mesh2x16x16)
    c = specs["slstm/c"]          # (G, B, d)
    assert c[1] == ("pod", "data") and c[0] is None


def test_no_duplicate_axis_in_cache_spec(mesh16x16, mesh2x16x16):
    """seq and head dims must not both claim 'model'."""
    cfg = tbase.load_arch("seamless-m4t-medium")
    for mesh, batch in ((mesh16x16, 128), (mesh2x16x16, 128),
                        (mesh16x16, 1)):
        caches = tencdec.init_dec_caches(cfg, batch, 32768, device="meta")
        for spec in rules.cache_pspecs(caches, mesh, batch).values():
            flat = [a for e in spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))]
            assert len(flat) == len(set(flat)), spec


# ---------------------------------------------------------------------------
# DTensor placements and local shapes
# ---------------------------------------------------------------------------
def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 16, 16))
    assert rules.to_placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert rules.to_placements((None, "model", None), mesh) == \
        [Replicate(), Replicate(), Shard(1)]
    assert rules.to_placements((), mesh) == [Replicate()] * 3
    for bad in ((("data", "pod"), None), ("model", "model")):
        with pytest.raises(ValueError):
            rules.to_placements(bad, mesh)
    assert rules.local_shape((64, 48, 5), (("pod", "data"), "model", None),
                             mesh) == (2, 3, 5)
    ms = MeshShape.production(multi_pod=True)
    assert ms.shape == {"pod": 2, "data": 16, "model": 16} and ms.size == 512
    assert MeshShape.of(mesh).sizes == (2, 16, 16)
