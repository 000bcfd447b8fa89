"""Sharded ``meta`` stand-ins for every input of a step (no allocation):
the reference's ``repro.launch.inputs``.

``input_specs(arch, shape_name, mesh, mode)`` returns (step, args, cfg,
train_cfg): ``args`` are DTensors on ``mesh`` whose local shards lie on
the ``meta`` device, laid out by ``sharding.rules``, ready for
``step(*args)`` (the sharded steps of ``launch.steps``). Parameters and
optimizer state are shaped by the port's own initialisers and optimizer
on ``meta`` (``param_shapes``, ``opt.init``), so the dry run exercises the
structures the launchers train and serve. Each DTensor is
``DTensor.from_local`` of one device's shard (``rules.local_shape``) with
the global shape and stride given and no check across ranks.

Token batches are int32, as the reference's; the optimizer's step count
is the port's Python int (the reference's is a replicated int32 scalar).
A decode step runs at the last position of its cache (``pos`` = S - 1).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import INPUT_SHAPES, load_arch, load_train
from repro_torch.launch import steps as steps_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.sharding import rules

META = torch.device("meta")
MODES = ("train", "train_lw", "prefill", "decode")


def param_shapes(cfg) -> Dict[str, torch.Tensor]:
    """The model's parameters on ``meta``: shapes and dtypes only."""
    if steps_mod.is_encdec(cfg):
        return encdec_mod.init_encdec(cfg, device=META)
    return lm_mod.init_lm(cfg, device=META)


def batch_shapes(cfg, shape, *, for_train: bool) -> Dict[str, torch.Tensor]:
    """One global step's token / label / frontend batch on ``meta``."""
    B, S = shape.global_batch, shape.seq_len
    fe = cfg.frontend_embed_len

    def t(s, dtype):
        return torch.empty(s, dtype=dtype, device=META)

    if steps_mod.is_encdec(cfg):
        d = {"frontend": t((B, fe, cfg.d_model), torch.float32),
             "tokens": t((B, S), torch.int32)}
        if for_train:
            d["labels"] = t((B, S), torch.int32)
        return d
    tok_len = S - fe if fe else S
    d = {"tokens": t((B, tok_len), torch.int32)}
    if fe:
        d["frontend"] = t((B, fe, cfg.d_model), torch.float32)
    if for_train:
        d["labels"] = t((B, tok_len), torch.int32)
    return d


def shard(t: torch.Tensor, spec, mesh) -> DTensor:
    """A ``meta`` DTensor of ``t``'s global shape and dtype, laid out by
    ``spec`` on ``mesh``."""
    local = torch.empty(rules.local_shape(tuple(t.shape), spec, mesh),
                        dtype=t.dtype, device=META)
    return DTensor.from_local(
        local, mesh, rules.to_placements(spec, mesh), run_check=False,
        shape=t.shape, stride=torch.empty(t.shape, device=META).stride())


def shard_tree(tree, specs, mesh):
    """``shard`` over matching nested dicts of tensors and specs; other
    leaves (the step count) are kept."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return shard(tree, specs, mesh)
    return tree


def sharded_params(cfg, mesh):
    shapes = param_shapes(cfg)
    specs = rules.param_pspecs(shapes, mesh)
    return shard_tree(shapes, specs, mesh), specs


def input_specs(arch_id: str, shape_name: str, mesh, *, mode: str = None,
                cfg_override=None, shape_override=None):
    """Returns (step, args, cfg, train_cfg) for the sharded step of
    ``mode`` (default: the shape's kind) on ``mesh``. ``shape_override``
    (a ``ShapeConfig``) stands in for ``INPUT_SHAPES[shape_name]``: the
    tests' small batches."""
    shape = shape_override or INPUT_SHAPES[shape_name]
    cfg = steps_mod.cfg_for_shape(cfg_override or load_arch(arch_id),
                                  shape_name)
    train_cfg = load_train(arch_id)
    mode = mode or shape.kind
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")

    if mode in ("train", "train_lw"):
        step, opt = steps_mod.make_sharded_train_step(cfg, train_cfg, mesh,
                                                      mode)
        params, p_specs = sharded_params(cfg, mesh)
        opt_shapes = opt.init(param_shapes(cfg))
        opt_specs = rules.opt_state_specs(opt_shapes, p_specs,
                                          train_cfg.optimizer, mesh)
        b = batch_shapes(cfg, shape, for_train=True)
        args = [params, shard_tree(opt_shapes, opt_specs, mesh),
                shard_tree(b, rules.batch_specs(b, mesh), mesh)]
        if mode == "train_lw":
            args.append(params)          # the broadcast global model
        return step, tuple(args), cfg, train_cfg

    params, _ = sharded_params(cfg, mesh)
    if mode == "prefill":
        step = steps_mod.make_sharded_prefill_step(cfg, mesh)
        b = batch_shapes(cfg, shape, for_train=False)
        b = shard_tree(b, rules.batch_specs(b, mesh), mesh)
        if steps_mod.is_encdec(cfg):
            return step, (params, b["frontend"], b["tokens"]), cfg, \
                train_cfg
        return step, (params, b), cfg, train_cfg

    step = steps_mod.make_sharded_decode_step(cfg, mesh)
    B, S = shape.global_batch, shape.seq_len
    cdt = getattr(torch, cfg.compute_dtype)
    init = encdec_mod.init_dec_caches if steps_mod.is_encdec(cfg) \
        else lm_mod.init_caches
    caches = init(cfg, B, S, cdt, device=META)
    caches = shard_tree(caches, rules.cache_pspecs(caches, mesh, B), mesh)
    tok = torch.empty((B, 1), dtype=torch.int32, device=META)
    tok = shard(tok, rules.batch_spec(tok, mesh), mesh)
    if steps_mod.is_encdec(cfg):
        mem = torch.empty((B, cfg.frontend_embed_len, cfg.d_model),
                          dtype=torch.float32, device=META)
        mem = shard(mem, rules.batch_spec(mem, mesh), mesh)
        return step, (params, caches, tok, S - 1, mem), cfg, train_cfg
    return step, (params, caches, tok, S - 1), cfg, train_cfg
