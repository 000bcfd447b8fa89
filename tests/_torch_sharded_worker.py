"""One rank of the port's 4-process sharded-step check (``gloo`` on the
CPU, mesh (2, 2)), spawned by ``tests/test_torch_sharded_step.py``. It
imports no JAX: the reference is the port's own unsharded step."""
import dataclasses
import logging
import time

import torch
import torch.distributed as dist

ARCHS = ("internlm2-1.8b", "deepseek-v2-236b")
B, S = 8, 32
# the checks' learning rate: an update of 1e-4 (the steps' default) or
# 1e-2 would be near the rounding of the parameters it is added to (1.2e-7
# at a norm scale of 1), which would then show as an error of 1e-5 of the
# update
LR = 1e-1


def _inputs(arch):
    from repro_torch.configs.base import load_arch, load_train, reduced
    from repro_torch.models import lm
    cfg = reduced(load_arch(arch))
    g = torch.Generator().manual_seed(0)
    params = lm.init_lm(cfg, g)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    # two microbatches, not deepseek-v2's eight: the same code path, a
    # quarter of the steps
    tc = load_train(arch)
    if tc.microbatch:
        tc = dataclasses.replace(tc, microbatch=2)
    return cfg, tc, params, batch


def _shard(tree, specs, mesh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding import rules
    return {k: distribute_tensor(v, mesh, rules.to_placements(specs[k], mesh))
            for k, v in tree.items()}


def _loss_and_grads(cfg, train_cfg, params, batch):
    from repro_torch.core import ssl
    n = ssl.lm_stages(cfg)
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = ssl.lm_loss(cfg, p, batch, sub_layers=n, active_from=0,
                          global_params=None, align_weight=0.0,
                          remat=train_cfg.remat)
    return loss, torch.autograd.grad(loss, list(p.values()),
                                     allow_unused=True)


def _rel_err(got, want, keep=None):
    """max |got - want| over ``keep`` (all when None), relative to want's
    largest entry."""
    d = (got - want).abs()
    if keep is not None:
        d = d[keep]
    if d.numel() == 0:
        return 0.0
    return float(d.max()) / max(float(want.abs().max()), 1e-30)


def _flat_state(state):
    """An optimizer state as {path: tensor} (the step count left out)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            for n, t in _flat_state(v).items():
                out[f"{k}/{n}"] = t
        elif isinstance(v, torch.Tensor):
            out[k] = v
    return out


def _whole(tree):
    """A (nested) dict of DTensors as whole tensors."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def _step_grads(tc, state, name):
    """The gradient of a one-step-old optimizer state's leaf ``name``, where
    its update is not linear in it (AdamW: mu = (1 - b1) g; Adafactor's
    unfactored v = g^2 + 1e-30); None for a factored Adafactor leaf, whose
    update is linear in g."""
    if tc.optimizer == "adamw":
        return state["mu"][name] / (1 - tc.b1)
    leaf = state["m"][name]
    return torch.sqrt(torch.clamp(leaf["v"] - 1e-30, min=0)) \
        if "v" in leaf else None


def _compare_update(tc, params, new_p, want_p, want_state):
    """(largest relative error of the update new_p - params against the
    unsharded want_p - params, the share of entries left out). Left out:
    entries whose gradient is not zero but below 1e-3 of its leaf's
    largest, where the first step's update is sign(g) (AdamW, Adafactor's
    unfactored leaves) and the gradients' rounding (below 1e-5 of the
    largest) may turn it."""
    err, out, n = 0.0, 0, 0
    for k, p in params.items():
        g = _step_grads(tc, want_state, k)
        keep = None if g is None else \
            (g == 0) | (g.abs() >= 1e-3 * g.abs().max())
        err = max(err, _rel_err(new_p[k] - p, want_p[k] - p, keep))
        n += p.numel()
        out += 0 if keep is None else int((~keep).sum())
    return err, out / n


def _compare_state(got, want):
    got, want = _flat_state(got), _flat_state(want)
    assert set(got) == set(want), set(got) ^ set(want)
    return max(_rel_err(got[k], want[k]) for k in want)


def _nce_on_dtensors(mesh):
    """``losses.info_nce`` and its q gradient on DTensors (q's rows split
    over "data", both split over "model" in features) against the plain
    tensors: largest error relative to the largest entry."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core import losses
    from repro_torch.launch import steps
    g = torch.Generator().manual_seed(5)
    q, k = torch.randn(8, 16, generator=g), torch.randn(8, 16, generator=g)
    dq = distribute_tensor(q, mesh, [Shard(0), Shard(1)]).requires_grad_()
    dk = distribute_tensor(k, mesh, [Replicate(), Shard(1)])
    with steps._on_dtensors():
        loss = losses.info_nce(dq, dk, 0.2)
        (gq,) = torch.autograd.grad(loss, [dq])
        loss, gq = loss.full_tensor(), gq.full_tensor()
    pq = q.clone().requires_grad_()
    want = losses.info_nce(pq, k, 0.2)
    (want_gq,) = torch.autograd.grad(want, [pq])
    return max(_rel_err(loss, want), _rel_err(gq, want_gq))


def worker(rank, world, port, queue):
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import steps
    from repro_torch.roofline.analysis import StepRecorder
    from repro_torch.sharding import rules
    from repro_torch.sharding.aten import AlignedLayouts
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for arch in ARCHS:
        t0 = time.time()
        cfg, tc, params, batch = _inputs(arch)
        p_specs = rules.param_pspecs(params, mesh)
        dp = _shard(params, p_specs, mesh)
        db = _shard(batch, rules.batch_specs(batch, mesh), mesh)
        with implicit_replication(), AlignedLayouts():
            loss, grads = _loss_and_grads(cfg, tc, dp, db)
            loss = float(loss.detach().full_tensor())
            grads = [None if g is None else g.full_tensor() for g in grads]
        # the whole sharded step (forward, backward, the optimizer), with
        # its collectives recorded
        step, opt = steps.make_sharded_train_step(cfg, tc, mesh, lr=LR)
        st = opt.init(params)
        dst = rules.opt_state_specs(st, p_specs, tc.optimizer, mesh)
        dst = {k: (_shard(v, dst[k], mesh) if isinstance(v, dict) else v)
               for k, v in st.items()} if tc.optimizer != "adafactor" else \
            {"m": {k: _shard(v, dst["m"][k], mesh)
                   for k, v in st["m"].items()}, "count": st["count"]}
        rec = StepRecorder(mesh)
        with rec:
            new_p, new_o, metrics = step(dp, dst, db)
        placed = all(isinstance(v, DTensor) and tuple(v.placements) ==
                     tuple(rules.to_placements(p_specs[k], mesh))
                     for k, v in new_p.items())
        new_p, new_o = _whole(new_p), _whole(new_o)
        # the optimizer alone on DTensors: the same gradients (the sharded
        # run's, whole), laid out as the parameters, into the update the
        # sharded step makes
        same_g = {k: torch.zeros_like(v) if g is None else g
                  for (k, v), g in zip(params.items(), grads)}
        with steps._on_dtensors():
            opt_p, opt_o = opt.update(_shard(same_g, p_specs, mesh), dst, dp,
                                      LR)
            opt_p, opt_o = _whole(opt_p), _whole(opt_o)
        nce_err = _nce_on_dtensors(mesh) if arch == ARCHS[0] else 0.0
        if rank == 0:
            want_loss, want_grads = _loss_and_grads(cfg, tc, params, batch)
            gerr = max(_rel_err(g, w) for g, w in zip(grads, want_grads)
                       if w is not None)
            ustep, _ = steps.make_train_step(cfg, tc, lr=LR)
            want_p, want_o, want_m = ustep(params, opt.init(params), batch)
            uerr, left_out = _compare_update(tc, params, new_p, want_p,
                                             want_o)
            o_want_p, o_want_o = opt.update(same_g, opt.init(params),
                                            params, LR)
            out[arch] = {
                "loss": loss, "want_loss": float(want_loss.detach()),
                "step_loss": float(metrics["loss"]),
                "want_step_loss": float(want_m["loss"]), "grad_err": gerr,
                "update_err": uerr, "left_out": left_out,
                "state_err": _compare_state(new_o, want_o),
                "opt_update_err": max(
                    _rel_err(opt_p[k] - v, o_want_p[k] - v)
                    for k, v in params.items()),
                "opt_state_err": _compare_state(opt_o, o_want_o),
                "nce_err": nce_err, "placed": placed,
                "counts": dict(rec.coll_counts), "seconds": time.time() - t0}
    if rank == 0:
        queue.put(out)
    dist.destroy_process_group()
