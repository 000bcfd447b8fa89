"""The port's sharded step inputs (``launch.inputs``) against the JAX
package's ``jax.eval_shape`` stand-ins.

For each architecture and input shape, on the (16, 16) production mesh
(a fake process group of 256 ranks, one process): the port's ``meta``
parameters, optimizer state, batch and caches have the reference's shapes
and dtypes leaf for leaf (the optimizer's step count aside: a Python int
in the port, an int32 scalar there), every DTensor's placements are its
spec's, and one device's argument bytes equal the sum of the local shard
bytes the reference's specs give. Exact.
"""
import jax
import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro.configs.base import ARCH_IDS, INPUT_SHAPES, load_arch
from repro.launch import inputs as jinputs
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.optim import make_optimizer as jmake_optimizer
from repro.sharding import rules as jrules
from repro_torch.launch import dryrun, inputs
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.roofline.analysis import local_bytes
from repro_torch.sharding import rules

ASSIGNED = [a for a in ARCH_IDS if a != "vit-tiny"]


@pytest.fixture(scope="module")
def mesh():
    dryrun.init_fake_group(256)
    yield make_production_mesh()
    dist.destroy_process_group()


def _jflat(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in flat}


def _tflat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _reference(arch, shape_name, mesh_shape):
    """The reference's abstract inputs of the shape's mode, and its specs
    on the duck mesh, as {path: (ShapeDtypeStruct, spec)}."""
    shape = INPUT_SHAPES[shape_name]
    cfg = jsteps.cfg_for_shape(load_arch(arch), shape_name)
    p = jinputs.param_shapes(cfg)
    p_specs = jrules.param_pspecs(p, mesh_shape)
    out = {"params/" + k: v for k, v in _jpair(p, p_specs).items()}
    if shape.kind == "train":
        tc = jinputs.load_train(arch)
        st = jax.eval_shape(jmake_optimizer(tc).init, p)
        specs = jrules.opt_state_specs(st, p_specs, tc.optimizer, mesh_shape)
        out.update({"opt/" + k: v for k, v in _jpair(st, specs).items()
                    if k != "count"})
        b = jinputs.batch_shapes(cfg, shape, for_train=True)
    elif shape.kind == "prefill":
        b = jinputs.batch_shapes(cfg, shape, for_train=False)
    else:
        B, S = shape.global_batch, shape.seq_len
        init = jencdec.init_dec_caches if jsteps.is_encdec(cfg) \
            else jlm.init_caches
        c = jax.eval_shape(lambda: init(cfg, B, S))
        out.update({"caches/" + k: v for k, v in _jpair(
            c, jrules.cache_pspecs(c, mesh_shape, B)).items()})
        b = {"token": jax.ShapeDtypeStruct((B, 1), np.int32)}
        if jsteps.is_encdec(cfg):
            b["memory"] = jax.ShapeDtypeStruct(
                (B, cfg.frontend_embed_len, cfg.d_model), np.float32)
    out.update({"batch/" + k: v for k, v in _jpair(
        b, jrules.batch_specs(b, mesh_shape)).items()})
    return out


def _jpair(tree, specs):
    vals = _jflat(tree)
    sp = _jflat(specs, is_leaf=lambda x: isinstance(x, jax.sharding
                                                    .PartitionSpec))
    return {k: (v, tuple(sp[k])) for k, v in vals.items()}


def _port(arch, shape_name, mesh):
    step, args, cfg, _ = inputs.input_specs(arch, shape_name, mesh)
    kind = INPUT_SHAPES[shape_name].kind
    if kind == "train":
        out = {**{"params/" + k: v for k, v in _tflat(args[0]).items()},
               **{"opt/" + k: v for k, v in _tflat(args[1]).items()
                  if k != "count"},
               **{"batch/" + k: v for k, v in args[2].items()}}
    elif kind == "prefill":
        batch = args[1] if isinstance(args[1], dict) else \
            {"frontend": args[1], "tokens": args[2]}
        out = {**{"params/" + k: v for k, v in args[0].items()},
               **{"batch/" + k: v for k, v in batch.items()}}
    else:
        out = {**{"params/" + k: v for k, v in args[0].items()},
               **{"caches/" + k: v for k, v in args[1].items()},
               "batch/token": args[2]}
        if len(args) == 5:
            out["batch/memory"] = args[4]
    return out, args


def _local_nbytes(shape, spec, itemsize, mesh_shape):
    return int(np.prod(rules.local_shape(shape, spec, mesh_shape),
                       dtype=np.int64)) * itemsize


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_inputs_match_reference(arch, shape_name, mesh):
    ms = MeshShape.of(mesh)
    want = _reference(arch, shape_name, ms)
    got, args = _port(arch, shape_name, mesh)
    assert sorted(got) == sorted(want)
    nbytes = 0
    for k, (sds, spec) in want.items():
        t = got[k]
        assert isinstance(t, DTensor) and t.device.type == "meta", k
        assert tuple(t.shape) == tuple(sds.shape), k
        assert str(t.dtype).split(".")[-1] == np.dtype(sds.dtype).name, k
        assert tuple(t.placements) == tuple(rules.to_placements(spec,
                                                                mesh)), k
        assert tuple(t.to_local().shape) == rules.local_shape(
            tuple(sds.shape), spec, ms), k
        nbytes += _local_nbytes(tuple(sds.shape), spec,
                                np.dtype(sds.dtype).itemsize, ms)
    assert local_bytes(args) == nbytes
