"""The port's sharded train step (``launch.steps.make_sharded_train_step``
on DTensors laid out by ``sharding.rules``) against its unsharded step.

- Four ``gloo`` processes on the CPU, mesh (2, 2) ("data", "model"):
  internlm2-1.8b (dense GQA, AdamW) and deepseek-v2 (MLA + MoE, Adafactor,
  2 microbatches where its config has 8) at ``reduced()``, batch 8 x 32.
  The sharded loss and gradients against the unsharded ones within 1e-5
  (gradients relative to each leaf's largest entry; the sums run in
  another order across the shards). The whole sharded step: its loss
  within 1e-5; its new optimizer state (AdamW's mu and nu, Adafactor's
  factored vr and vc, whose means run over sharded dims, and its
  unfactored v) within 1e-5 of each leaf's largest entry; its update (new
  minus old parameters) within 1e-5 of each leaf's largest update entry,
  leaving out the entries whose gradient is below 1e-3 of the leaf's
  largest (the first step's update is sign(g) there, for AdamW and
  Adafactor's unfactored leaves, and the gradients' rounding may turn
  it), which must be under 1% of all entries; its parameters back in the
  rules' placements; the collectives the rules imply (weights gathered,
  gradients reduce-scattered, partial sums all-reduced) recorded. The
  optimizer alone on DTensors, given the same gradients as the unsharded
  one: its update and state within 1e-5, every entry. InfoNCE on
  DTensors (q's rows split, both split in features): loss and q
  gradient within 1e-5.
- One rank, mesh (1, 1), in this process (one intra-op thread): the
  sharded step's loss and parameters equal the unsharded step's to the
  bit (the same ops on the same tensors).
The reference is the port's own unsharded step, itself held against the
JAX package by ``test_torch_lm_dense.py`` and ``test_torch_mla.py``.
"""
import socket

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import _torch_sharded_worker as worker
from repro_torch.configs.base import load_arch, load_train, reduced
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.sharding import rules

TOL = 1e-5


@pytest.fixture(scope="module")
def gloo_results():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    mp.spawn(worker.worker, args=(4, port, queue), nprocs=4, join=True)
    return queue.get(timeout=60)


@pytest.mark.parametrize("arch", worker.ARCHS)
def test_four_process_sharded_step_matches_unsharded(gloo_results, arch):
    r = gloo_results[arch]
    assert abs(r["loss"] - r["want_loss"]) <= TOL * abs(r["want_loss"]), r
    assert r["grad_err"] <= TOL, r
    assert abs(r["step_loss"] - r["want_step_loss"]) <= \
        TOL * abs(r["want_step_loss"]), r
    assert r["placed"], r
    assert r["state_err"] <= TOL, r
    assert r["update_err"] <= TOL and r["left_out"] < 0.01, r
    assert r["opt_update_err"] <= TOL and r["opt_state_err"] <= TOL, r
    assert r["nce_err"] <= TOL, r
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert r["counts"][kind] > 0, (kind, r["counts"])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b"])
def test_one_rank_sharded_step_is_the_unsharded_step(arch):
    from torch.distributed.tensor import distribute_tensor
    # one intra-op thread: the CPU's multi-threaded accumulating index
    # (the embedding's backward) sums in no fixed order, so two unsharded
    # steps differ in their last bits too
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dryrun.init_fake_group(1)
    try:
        mesh = make_host_mesh()
        cfg, tc = reduced(load_arch(arch)), load_train(arch)
        g = torch.Generator().manual_seed(1)
        params = lm.init_lm(cfg, g)
        batch = {k: torch.randint(0, cfg.vocab_size, (8, 32), generator=g)
                 for k in ("tokens", "labels")}
        specs = rules.param_pspecs(params, mesh)
        assert all(e is None for s in specs.values() for e in s)

        def put(t, spec):
            return distribute_tensor(t, mesh, rules.to_placements(spec,
                                                                  mesh))

        step, opt = steps.make_sharded_train_step(cfg, tc, mesh)
        st = opt.init(params)
        dst = {k: ({p: (put(v, ()) if not isinstance(v, dict) else
                        {n: put(x, ()) for n, x in v.items()})
                    for p, v in t.items()} if isinstance(t, dict) else t)
               for k, t in st.items()}
        new_p, _, m = step({k: put(v, specs[k]) for k, v in params.items()},
                           dst, {k: put(v, (None, None))
                                 for k, v in batch.items()})
        want_p, _, want_m = steps.make_train_step(cfg, tc)[0](
            params, opt.init(params), batch)
        assert torch.equal(m["loss"], want_m["loss"])
        for k, v in want_p.items():
            assert torch.equal(new_p[k].to_local(), v), k
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)
