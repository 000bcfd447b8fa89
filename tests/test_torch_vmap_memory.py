"""The vmap engines' gradient route: the clients' forwards under
``torch.func.vmap``, then one ``torch.autograd.grad`` of the summed losses
(``federated.client.stacked_loss_and_grads``, and the LM round program of
``launch.steps.make_fl_round_program``).

- Saved bytes: wrapped in ``torch.autograd.graph.saved_tensors_hooks``, one
  stacked step of C = 3 clients saves for its backward C times what one
  sequential step saves (within 10%), on the ViT engine and on the dense
  LM's round program. ``torch.func.grad`` refuses saved-tensor hooks, so a
  step that differentiates under ``torch.func`` fails here.
- Gradients: each client's row of the stacked gradients equals the
  sequential route's gradient of that client's loss (``loss_and_grads``),
  for every stage shape of a schedule and for each SSL method.
- The LM round program with per-block remat equals it without, and both
  equal each client's ``make_train_step`` alone.
- Each kernel-backed Function's ``vmap`` rule under the outer backward: the
  values and the summed loss's gradients equal a loop over the clients
  (a shared operand's gradient is the sum of the clients').
- Held state: both vmap engines free the optimizer state a round began
  from once later steps replace it.

A 2-block fp32 ViT with narrow heads, batch 16 (``test_torch_engine``'s),
and the dense LM of ``test_torch_lm_dense``'s round-program test.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.convert import subtree
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as ssl_mod
from repro_torch.data import augment
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.federated import client as client_mod
from repro_torch.federated import engine as engine_mod
from repro_torch.federated.driver import run_fedssl, run_lm_fedssl
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import lm as lm_mod
from repro_torch.optim import make_optimizer

torch.set_num_threads(2)

MODEL = tbase.ModelConfig(arch_id="t-vit", family="dense", num_layers=2,
                          d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                          vocab_size=0, causal=False,
                          compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=32, pred_hidden=32, proj_dim=16)
LM = tbase.ModelConfig(arch_id="t", family="dense", num_layers=2, d_model=32,
                       num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=50,
                       compute_dtype="float32")
C, BATCH = 3, 16
# one stacked step saves C times one client's bytes: the shared inputs (the
# global encoder of the alignment, an unbatched operand) are saved once
SAVED_RTOL = 0.10
# vmap against sequential: tests/test_torch_engine.py's bar for the two
# engines (the same math, batched)
ENGINE_ATOL = 1e-4
# the LM round program: tests/test_torch_lm_dense.py's
ROUND_ATOL = 1e-5

# (sub_layers, active_from, align, depth-dropout rate): e2e, a layer-wise
# first stage, the last stage with the alignment, FLL+DD's gated stage
PLANS = {"e2e": (2, 0, False, 0.0), "stage1": (1, 0, False, 0.0),
         "stage2_align": (2, 1, True, 0.0), "fll_dd": (2, 1, False, 0.5)}


class SavedBytes:
    """Sums each tensor that autograd saves for the backward (numel x
    element size) while it is held."""

    def __init__(self):
        self.bytes = 0

    def _pack(self, t):
        self.bytes += t.numel() * t.element_size()
        return t

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)


def _vit_clients(method="moco_v3", plan="e2e", shared=False):
    """C clients' states (distinct, or with ``shared`` the one state every
    client starts a round from), views and gates, and the step's keyword
    arguments for ``plan``."""
    ssl = tbase.SSLConfig(method=method, **SSL)
    enc = ssl_mod.make_vit_encoder(MODEL)
    states = [ssl_mod.ssl_init(enc, ssl, torch.Generator().manual_seed(
        0 if shared else c)) for c in range(C)]
    gen = torch.Generator().manual_seed(100)
    images = torch.rand(C, BATCH, 32, 32, 3, generator=gen)
    views = [augment.two_views(images[c],
                               augment.draw_params(gen, BATCH, 32, 32),
                               augment.draw_params(gen, BATCH, 32, 32))
             for c in range(C)]
    sub_layers, active_from, align, rate = PLANS[plan]
    gates = None
    if rate > 0.0:
        gates = torch.stack([sched.depth_dropout_gates(
            torch.rand(enc.num_stages, generator=gen), active_from, rate)
            for _ in range(C)])
    glob = ssl_mod.ssl_init(enc, ssl, torch.Generator().manual_seed(50))
    kw = dict(encoder=enc, ssl_cfg=ssl, sub_layers=sub_layers,
              active_from=active_from,
              global_enc=subtree(glob["online"], "enc") if align else None,
              align_weight=ssl.align_weight if align else 0.0)
    return states, views, gates, kw


def _stack(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


@pytest.mark.parametrize("plan", ["e2e", "stage2_align"])
def test_vit_stacked_step_saves_what_sequential_steps_save(plan):
    states, views, gates, kw = _vit_clients(plan=plan)
    opt = make_optimizer(tbase.TrainConfig(batch_size=BATCH))
    seq = 0
    for c in range(C):
        with SavedBytes() as saved:
            client_mod.train_step(
                states[c], opt.init(states[c]["online"]), *views[c], 1e-3,
                opt=opt, layer_gates=None if gates is None else gates[c],
                **kw)
        seq += saved.bytes
    stacked = {br: _stack([s[br] for s in states]) for br in states[0]}
    with SavedBytes() as saved:
        client_mod.stacked_train_step(
            stacked, client_mod.stacked_opt_init(opt, stacked["online"]),
            torch.stack([v[0] for v in views]),
            torch.stack([v[1] for v in views]), 1e-3, opt=opt,
            layer_gates=gates, **kw)
    assert seq > 0
    assert abs(saved.bytes / seq - 1.0) <= SAVED_RTOL, (saved.bytes, seq)


def _lm_round(mode, remat=False):
    """The dense LM round program at C clients, one local step each, from
    one broadcast; and each client's ``make_train_step`` alone."""
    params = lm_mod.init_lm(LM, torch.Generator().manual_seed(0))
    B, S = 8, 16
    toks, labs = synthetic_tokens(torch.Generator().manual_seed(1), C * B,
                                  S, LM.vocab_size)
    shards = {"tokens": toks.view(C, B, S), "labels": labs.view(C, B, S)}
    tc = tbase.TrainConfig(batch_size=B, base_lr=1e-3, remat=remat)
    prog, _ = steps.make_fl_round_program(LM, tc, mode=mode, fedavg=False)
    step, opt = steps.make_train_step(LM, tc, mode=mode, lr=1e-3)
    glob = [params] if mode == "train_lw" else []

    def program():
        return prog({"params": params, "global_params": params}, shards,
                    torch.arange(B).expand(C, 1, B),
                    torch.ones(C, 1, dtype=torch.bool),
                    torch.full((C,), 1.0 / C), 1e-3)

    def sequential(c):
        return step(params, opt.init(params),
                    {k: v[c] for k, v in shards.items()}, *glob)

    return program, sequential


@pytest.mark.parametrize("mode", ["train", "train_lw"])
def test_lm_round_program_saves_what_sequential_steps_save(mode):
    program, sequential = _lm_round(mode)
    seq = 0
    for c in range(C):
        with SavedBytes() as saved:
            sequential(c)
        seq += saved.bytes
    with SavedBytes() as saved:
        program()
    assert seq > 0
    assert abs(saved.bytes / seq - 1.0) <= SAVED_RTOL, (saved.bytes, seq)


@pytest.mark.parametrize("method,plan,shared", [
    ("moco_v3", "e2e", False),
    ("moco_v3", "e2e", True),
    ("moco_v3", "stage1", False),
    ("moco_v3", "stage2_align", False),
    ("moco_v3", "fll_dd", False),
    ("simclr", "e2e", False),
    ("byol", "stage2_align", False),
])
def test_stacked_grads_match_each_clients(method, plan, shared):
    """Row c of ``stacked_loss_and_grads`` is ``loss_and_grads`` of client
    c alone; ``shared`` starts every client from one expanded state, as the
    engine's first local step of a round does."""
    states, views, gates, kw = _vit_clients(method, plan, shared)
    if shared:
        stacked = {br: {k: v.expand(C, *v.shape) for k, v in t.items()}
                   for br, t in states[0].items()}
    else:
        stacked = {br: _stack([s[br] for s in states]) for br in states[0]}
    losses, grads = client_mod.stacked_loss_and_grads(
        stacked, torch.stack([v[0] for v in views]),
        torch.stack([v[1] for v in views]), layer_gates=gates, **kw)
    assert losses.shape == (C,) and not losses.requires_grad
    assert list(grads) == list(states[0]["online"])
    for c in range(C):
        loss, _, want = client_mod.loss_and_grads(
            states[c], *views[c],
            layer_gates=None if gates is None else gates[c], **kw)
        torch.testing.assert_close(losses[c], loss, rtol=0,
                                   atol=ENGINE_ATOL)
        for k, g in want.items():
            assert grads[k].shape == (C, *g.shape), k
            torch.testing.assert_close(grads[k][c], g, rtol=0,
                                       atol=ENGINE_ATOL, msg=k)


@pytest.mark.parametrize("mode", ["train", "train_lw"])
def test_lm_round_program_with_remat_matches(mode):
    """``_Remat`` (its vmap rule generated, its backward a ``torch.func.vjp``)
    under the round program's outer ``torch.autograd.grad``: with remat
    the clients' trees and losses equal those without, and each client's
    ``make_train_step`` alone."""
    runs = {}
    for remat in (False, True):
        program, sequential = _lm_round(mode, remat)
        runs[remat] = program()
    (outs, losses), (outs_r, losses_r) = runs[False], runs[True]
    torch.testing.assert_close(losses_r, losses, rtol=0, atol=ROUND_ATOL)
    for c in range(C):
        p, _, m = sequential(c)
        torch.testing.assert_close(losses[c], m["loss"], rtol=0,
                                   atol=ROUND_ATOL)
        for k in p:
            torch.testing.assert_close(outs_r[c][k], outs[c][k], rtol=0,
                                       atol=ROUND_ATOL, msg=k)
            torch.testing.assert_close(outs[c][k], p[k], rtol=0,
                                       atol=ROUND_ATOL, msg=k)


def test_no_torch_func_grad_on_the_training_paths():
    """The engines' training paths hold no ``torch.func`` differentiation:
    ``federated.client`` (both families' stacked steps) takes ``vmap`` alone
    from ``torch.func``, ``federated.engine`` and ``launch.steps`` (the
    rounds over them) take nothing, and none calls ``grad``,
    ``grad_and_value`` or ``vjp``."""
    import inspect
    for mod in (client_mod, engine_mod, steps):
        src = inspect.getsource(mod)
        imports = [ln for ln in src.splitlines() if "torch.func" in ln
                   and "import" in ln]
        assert imports == (["from torch.func import vmap"]
                           if mod is client_mod else []), mod.__name__
        for name in ("grad_and_value", "torch.func.grad", "vjp("):
            assert name not in src, (mod.__name__, name)


@pytest.mark.parametrize("family", ["vit", "lm"])
def test_vmap_round_frees_each_steps_optimizer_state(family, monkeypatch):
    """By a round's third batched step no tensor of the optimizer state the
    round began from is alive: the vmap engines keep one step's C clients'
    moments at a time, not the first step's besides (at the ViT cell's 16
    clients those are gigabytes of the peak)."""
    refs, alive, calls = [], [], [0]
    init = client_mod.stacked_opt_init
    name = "stacked_train_step" if family == "vit" else \
        "lm_stacked_train_step"
    real_step = getattr(client_mod, name)

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t] if torch.is_tensor(t) else [])

    def recorded_init(opt, params):
        out = init(opt, params)
        refs[:] = [weakref.ref(t) for t in leaves(out)]
        return out

    def step(*a, **k):
        calls[0] += 1
        if calls[0] == 3:
            gc.collect()
            alive.append(sum(r() is not None for r in refs))
        return real_step(*a, **k)

    monkeypatch.setattr(client_mod, "stacked_opt_init", recorded_init)
    monkeypatch.setattr(client_mod, name, step)
    if family == "vit":
        imgs = np.random.default_rng(0).uniform(
            size=(6 * BATCH, 32, 32, 3)).astype(np.float32)
        run_fedssl(MODEL, tbase.SSLConfig(**SSL),
                   tbase.FLConfig(num_clients=2, rounds=1, local_epochs=3,
                                  schedule="e2e"),
                   tbase.TrainConfig(batch_size=BATCH), images=imgs,
                   client_indices=[np.arange(3 * BATCH),
                                   np.arange(3 * BATCH, 6 * BATCH)],
                   device="cpu", engine="vmap")
    else:
        toks, labs = synthetic_tokens(torch.Generator().manual_seed(1), 24,
                                      16, LM.vocab_size)
        run_lm_fedssl(LM, tbase.FLConfig(num_clients=2, rounds=1,
                                         local_epochs=1, schedule="e2e"),
                      tbase.TrainConfig(batch_size=4), tokens=toks,
                      labels=labs, shards=[np.arange(12), np.arange(12, 24)],
                      params=lm_mod.init_lm(LM, torch.Generator()
                                            .manual_seed(0)),
                      device="cpu", engine="vmap")
    assert refs and alive == [0], (alive, len(refs))


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ssd_args(shapes):
    """xh, dt, a = dt * A, Bm, Cm (and h0) at ``shapes``, with the scan's
    signs: dt > 0, A < 0 (one A per head)."""
    xh, dt, _, Bm, Cm, *h0 = (_np(s, 10 + i) for i, s in enumerate(shapes))
    dt = np.log1p(np.exp(dt))
    a = dt * (-np.exp(_np(dt.shape[-1:], 9)) * 0.1)
    return [xh, dt, a, Bm, Cm, *h0]


def _ssd_loss(xh, dt, a, Bm, Cm, h0=None):
    y, h = ops.ssd_scan(xh, dt, a, Bm, Cm, chunk=8, h0=h0,
                        return_state=True)
    return (y ** 2).sum() + (h ** 2).sum()


SSD = [(2, 16, 2, 4), (2, 16, 2), (2, 16, 2), (2, 16, 4), (2, 16, 4),
       (2, 2, 4, 4)]
# Function -> (per-client loss, per-client operand shapes, vmapped operands)
FUNCTION_CASES = {
    "rmsnorm": (lambda x, s: (ops.rmsnorm(x, s) ** 2).sum(),
                [(5, 7, 16), (16,)], (0, 0)),
    "rmsnorm_shared_scale": (lambda x, s: (ops.rmsnorm(x, s) ** 2).sum(),
                             [(5, 7, 16), (16,)], (0, None)),
    "flash_attention": (
        lambda q, k, v: (ops.flash_attention(q, k, v, causal=False)
                         ** 2).sum(),
        [(2, 9, 4, 8), (2, 9, 2, 8), (2, 9, 2, 8)], (0, 0, 0)),
    "info_nce": (lambda q, k: ops.info_nce_rows(q, k, 0.2).mean(),
                 [(24, 16), (24, 16)], (0, 0)),
    "info_nce_shared_k": (lambda q, k: ops.info_nce_rows(q, k, 0.2).mean(),
                          [(24, 16), (24, 16)], (0, None)),
    "ssd_scan_shared_bm": (_ssd_loss, SSD[:5], (0, 0, 0, None, 0)),
    "ssd_scan_h0": (_ssd_loss, SSD, (0,) * 6),
}


@pytest.mark.parametrize("case", list(FUNCTION_CASES))
def test_function_vmap_rule_under_outer_backward(case):
    fn, shapes, in_dims = FUNCTION_CASES[case]
    full = [(C,) + s if d is not None else s
            for s, d in zip(shapes, in_dims)]
    raw = (_ssd_args(full) if case.startswith("ssd")
           else [_np(s, i) for i, s in enumerate(full)])
    args = [torch.from_numpy(a).requires_grad_() for a in raw]
    values = torch.func.vmap(fn, in_dims=in_dims)(*args)
    grads = torch.autograd.grad(values.sum(), args)
    shared = [torch.zeros_like(a) for a in args]
    for c in range(C):
        one = [(a[c] if d is not None else a).detach().requires_grad_()
               for a, d in zip(args, in_dims)]
        value = fn(*one)
        want = torch.autograd.grad(value, one)
        torch.testing.assert_close(values[c], value.detach(), rtol=1e-6,
                                   atol=1e-6)
        for i, (got, w, d) in enumerate(zip(grads, want, in_dims)):
            if d is None:
                shared[i] += w
            else:
                torch.testing.assert_close(got[c], w, rtol=1e-6, atol=1e-6)
    for got, w, d in zip(grads, shared, in_dims):
        if d is None:
            torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-6)
