#!/usr/bin/env python3
"""Does the PyTorch port's LM path repeat on the card, and if not, which
op makes it differ?

    python3 scripts/torch_lm_repeat_probe.py

Needs one NVIDIA GPU (it builds the port's kernels first). For the LM of
``chip_smoke.py`` phase 2d (zamba2-2.7b at its published widths, 12 Mamba2
blocks) and of phase 2i (internlm2-1.8b at its published widths, 4
blocks):

1. the phase's whole run (``run_lm_fedssl``, 4 rounds of 4 clients) twice
   from one seed: are the round losses bit-identical?
2. two local steps (stage 1, with the alignment) from one state on the
   same batches, twice: the leaves that differ after the second step;
3. the same under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``: the leaves that differ, and the ops that warn that
   they have no deterministic implementation;
4. the same as 2 with the token embedding taken by ``F.embedding`` in
   place of indexing the table (``params["embed"][tokens]``), whose
   backward accumulates into the table in another way;
5. the run's data and initial parameters made twice from one seed, and
   the parallel prefix sum ``torch.multinomial`` builds its CDF with:
   equal bits?
6. one client's round-1 local steps of the phase's run, from its own
   data and initial parameters, twice, the second time after filling the
   caching allocator's free blocks with NaN: the first step whose loss or
   gradient differs, and the leaves that differ there;
7. each kernel of the path at the phase's shapes, called 20 times and
   after the same NaN fill: does any call give other bits?

Prints one line per finding, then the card's name and power limit.
"""
from __future__ import annotations

import pathlib
import sys
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def step_repeat(cfg, params, tokens, steps=2, batch=4, seq=1024):
    """Two ``lm_train_step``s at stage 1 with the alignment, from one
    state on the same batches, twice. Returns (losses of both runs, the
    leaves that differ after the last step, with their largest
    difference)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.federated.client import lm_train_step
    from repro_torch.optim import make_optimizer

    opt = make_optimizer(TrainConfig(batch_size=batch, base_lr=3e-4))
    runs = []
    for _ in range(2):
        p, o, losses = params, opt.init(params), []
        for i in range(steps):
            tok = tokens[i * batch:(i + 1) * batch, :seq]
            p, o, m = lm_train_step(
                p, o, {"tokens": tok, "labels": torch.roll(tok, -1, 1)},
                1e-4, cfg=cfg, opt=opt, sub_layers=1, active_from=0,
                global_params=params, align_weight=0.01)
            losses.append(float(m["loss"]))
        runs.append((losses, p))
    (l1, p1), (l2, p2) = runs
    differ = {k: float((p1[k] - p2[k]).abs().max()) for k in p1
              if not torch.equal(p1[k], p2[k])}
    return (l1, l2), differ


def probe(name, cfg, run):
    import torch
    import torch.nn.functional as F
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.models import lm

    losses = []
    for _ in range(2):
        torch.cuda.empty_cache()
        _, params, hist, *_ = cs.lm_path("cuda", cfg=cfg, **run)
        losses.append(hist.loss)
        del params
    print(f"[{name}] whole run twice from seed 0: losses {losses[0]} and "
          f"{losses[1]}; bit-identical {losses[0] == losses[1]}", flush=True)

    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(0)
    params = lm.init_lm(cfg, gen, "cuda")
    toks, _ = synthetic_tokens(gen, 8, 1024, cfg.vocab_size)
    (l1, l2), differ = step_repeat(cfg, params, toks)
    print(f"[{name}] two steps from one state, twice: losses {l1} and {l2}; "
          f"leaves that differ (largest difference): {differ or 'none'}",
          flush=True)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            (l1, l2), differ = step_repeat(cfg, params, toks)
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).splitlines()[0][:300] for w in caught})
    print(f"[{name}] the same under use_deterministic_algorithms(True, "
          f"warn_only=True): losses {l1} and {l2}; leaves that differ: "
          f"{differ or 'none'}", flush=True)
    for op in ops:
        print(f"[{name}]   warns: {op}", flush=True)

    indexing = lm.embed

    def embed(params, tokens, cfg, frontend=None):
        x = F.embedding(tokens, params["embed"]) * (cfg.d_model ** 0.5)
        if frontend is not None:
            x = torch.cat([frontend.to(x.dtype), x], dim=1)
        return x

    lm.embed = embed
    try:
        (l1, l2), differ = step_repeat(cfg, params, toks)
    finally:
        lm.embed = indexing
    print(f"[{name}] two steps with F.embedding, twice: losses {l1} and "
          f"{l2}; leaves that differ: {differ or 'none'}", flush=True)


def poison(gib=8.0):
    """Fill free device memory with NaN blocks of many sizes and free them
    again: the caching allocator then hands out NaN-filled memory."""
    import torch
    junk, left, size = [], int(gib * 2**30), 2**20
    while left > 0:
        n = min(size, left)
        junk.append(torch.full((n // 4,), float("nan"), device="cuda"))
        left -= n
        size = size * 2 if size < 2**30 else 2**20
    torch.cuda.synchronize()
    del junk


def data_repeats(name, cfg, run):
    import torch
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.models import lm

    n = run["samples"] * run["seq_len"]
    ranks = torch.arange(1, cfg.vocab_size + 1, dtype=torch.float32,
                         device="cuda")
    probs = torch.softmax(-1.1 * torch.log(ranks), dim=0)
    draws = [torch.multinomial(probs, n, replacement=True,
                               generator=torch.Generator("cuda")
                               .manual_seed(0)) for _ in range(20)]
    sums = [torch.cumsum(probs, 0) for _ in range(100)]
    made = []
    for _ in range(2):
        gen = torch.Generator("cuda").manual_seed(0)
        toks, _ = synthetic_tokens(gen, run["samples"], run["seq_len"],
                                   cfg.vocab_size)
        made.append((toks, lm.init_lm(cfg, gen, "cuda")))
    (t1, p1), (t2, p2) = made
    print(f"[{name}] torch.multinomial of the Zipf draws ({n} of "
          f"{cfg.vocab_size}), 20 calls from one seed: "
          f"{len({d.cpu().numpy().tobytes() for d in draws})} distinct "
          f"results; torch.cumsum of its {cfg.vocab_size} fp32 "
          f"probabilities, 100 calls: "
          f"{len({c.cpu().numpy().tobytes() for c in sums})} distinct; "
          f"synthetic_tokens twice equal {torch.equal(t1, t2)}; init_lm "
          f"twice equal {all(torch.equal(p1[k], p2[k]) for k in p1)}",
          flush=True)


def first_divergence(name, cfg, run):
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.ssl import lm_ssl_loss
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.federated.masks import stage_update_mask
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import learning_rate, scaled_base_lr

    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(0)
    toks, labs = synthetic_tokens(gen, run["samples"], run["seq_len"],
                                  cfg.vocab_size)
    params = lm.init_lm(cfg, gen, "cuda")
    ix = torch.as_tensor(iid_partition(run["samples"], run["clients"],
                                       seed=0)[0], device="cuda")
    B = run["batch"]
    tc = TrainConfig(batch_size=B, base_lr=3e-4)
    opt = make_optimizer(tc)
    lr = learning_rate(0, run["rounds"], scaled_base_lr(3e-4, B),
                       tc.lr_schedule)
    runs = []
    for attempt in range(2):
        if attempt:
            poison()
        p, o, rec = params, opt.init(params), []
        for b in range(len(ix) // B):
            sel = ix[(b * B) % max(1, len(ix) - B):][:B]
            q = {k: v.detach().requires_grad_() for k, v in p.items()}
            loss, _ = lm_ssl_loss(
                q, {"tokens": toks[sel], "labels": labs[sel]}, cfg,
                sub_layers=1, active_from=0, global_params=params,
                align_weight=0.01)
            g = torch.autograd.grad(loss, list(q.values()),
                                    allow_unused=True)
            g = {k: torch.zeros_like(v) if x is None else x
                 for (k, v), x in zip(p.items(), g)}
            rec.append((float(loss), {k: x.clone() for k, x in g.items()}))
            p, o = opt.update(g, o, p, lr, stage_update_mask(p, 1, 0))
        runs.append(rec)
        del p, o
    for step, ((l1, g1), (l2, g2)) in enumerate(zip(*runs)):
        differ = {k: float((g1[k] - g2[k]).abs().max()) for k in g1
                  if not torch.equal(g1[k], g2[k])}
        print(f"[{name}] client 0, step {step + 1}: losses {l1} and {l2} "
              f"(after a NaN fill); gradient leaves that differ: "
              f"{differ or 'none'}", flush=True)
        if differ or l1 != l2:
            break


def kernel_repeats(name, cfg):
    """Each kernel of the LM path at its shapes in this phase: 20 calls
    and a call after a NaN fill against the first call, bit for bit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import infonce as nce
    from repro_torch.kernels import ops

    gen = torch.Generator("cuda").manual_seed(4)
    B, S, d = 4, 1024, cfg.d_model
    hd = cfg.resolved_head_dim
    q, k, v = (torch.randn((B, S, h, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (cfg.num_heads,
                                             cfg.num_kv_heads,
                                             cfg.num_kv_heads))
    x = torch.randn((B * S, d), generator=gen, device="cuda")
    sc = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    zq = F.normalize(torch.randn((1, B, d), generator=gen, device="cuda"),
                     dim=-1)
    zk = F.normalize(torch.randn((1, B, d), generator=gen, device="cuda"),
                     dim=-1)
    gg = torch.randn((1, B), generator=gen, device="cuda")
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, k, v, causal=True),
        "rmsnorm_rows": lambda: ops.rmsnorm(x, sc),
        "info_nce_rows": lambda: nce.info_nce_fwd(zq, zk, 0.2),
        "info_nce_rows_dq": lambda: nce.info_nce_bwd(
            zq, zk, nce.info_nce_fwd(zq, zk, 0.2)[1], gg, 0.2, False),
        "gather_pack": lambda: ops.wire_pack([x, sc], [(0, 0, x.numel()),
                                                       (0, x.numel(), d)],
                                             x.numel() + d),
    }
    for kname, fn in calls.items():
        first = fn()
        first = first if isinstance(first, (tuple, list)) else (first,)
        bad = 0
        for i in range(21):
            if i == 20:
                poison()
            out = fn()
            out = out if isinstance(out, (tuple, list)) else (out,)
            bad += not all(torch.equal(a, b) for a, b in zip(first, out))
        print(f"[{name}] {kname}: calls that differ from the first, of 20 "
              f"and one after a NaN fill: {bad}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs.import_port()
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    for name, cfg, run in (
            ("zamba2-2.7b, phase 2d", cs.lm_config(), cs.LM_RUN),
            ("internlm2-1.8b, phase 2i", cs.dense_config(), cs.DENSE_RUN)):
        probe(name, cfg, run)
        data_repeats(name, cfg, run)
        first_divergence(name, cfg, run)
        kernel_repeats(name, cfg)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
