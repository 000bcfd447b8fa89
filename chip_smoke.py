#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build: compile every CUDA kernel of the main path from
   ``src/repro_torch/kernels/csrc`` with nvcc (one process per source, all
   at once) and print the seconds.
2. main path: the paper's experiment at the full width of ViT-Tiny
   (12 blocks, d=192, 3 heads of 64, bf16 compute) with the MoCo v3 heads
   of ``SSLConfig()``: ``run_fedssl`` with the LW-FedSSL schedule, 4
   clients, 12 rounds (one per stage, so every stage transition and weight
   transfer runs), 1 local epoch, batch 256, 4096 synthetic images, then
   ``linear_eval``. Every kernel launch counter is set to 0 just before and
   read just after; each kernel must have launched. Losses must be finite
   and the wire bytes must equal the analytic bytes in every round.
2b. codec paths: the same model, heads, schedule, clients and batch through
   the compressing wire codecs, without linear eval: ``codec="int8"`` for
   12 rounds, and ``codec="topk"`` (fraction 0.1) with rounds per stage
   (1,) * 11 + (3,), so that stage 12 runs a dense re-sync, two delta
   downloads and two carried error-feedback residuals. The counters are set
   to 0 before each path and read after it; the path's codec kernels must
   have launched, and the wire bytes must equal the codec's exact count in
   every round (the payload's in a top-k re-sync round).
2c. vmap path: the main path of phase 2 (fp32 wire, 12 rounds, no linear
   eval) on the vectorised engine (``engine="vmap"``: the four clients'
   local steps batched with ``torch.func.vmap``), with the same checks,
   its seconds per round and peak memory; then a short comparison of the
   two engines from one seed at fp32 compute (full width, depth cut to 2
   blocks, 2 rounds of one local step): the first round's losses, and the
   per-client losses of three batched steps against the sequential step
   from the same states, within 1e-4 (their gradients are printed).
2d. LM path: LW-FedSSL on the zamba2-2.7b LM at its published widths
   (d 2560, 32 heads of 80, SwiGLU d_ff 10240, vocab 32000, Mamba2 state 64,
   head dim 64, expand 2, chunk 256, bf16 compute, fp32 params), depth cut
   from 54 Mamba2 blocks to 12 (2 stage groups of 6, each followed by the
   shared attention block): ``run_lm_fedssl``, 4 clients, 4 rounds (2 a
   stage), batch 4 x 1024 tokens, 64 synthetic sequences (4 local steps a
   client and round), fp32 wire. Counters set to 0 before, read after;
   losses finite, wire bytes equal to the analytic bytes in every round,
   and the ``ssd_scan`` and ``flash_attention`` launches equal to the counts
   the plan implies (12 s scans and 2 s attentions a local step at stage
   s: the online forward, frozen groups included, and the global model's);
   seconds per round and peak memory. Then ``gather_pack`` and
   ``scatter_unpack`` are held bit-identical to their plain versions on
   every download and upload layout of the run's plan over the trained
   tree (up to 747,364,160 floats, 2.99 GB), and timed at the largest.
2e. observability on the card: (a) phase 2b's int8 run again, traced with
   ``make_obs(trace=True, metrics=True, health=True)``: its wire bytes per
   round and its kernel launches equal the untraced run's, its losses
   are bit-identical to the untraced run's (two runs of this path give the
   same bits on the card), the ``fl.rounds``, ``comm.*`` and ``wire.*``
   counters equal the history, one ``round`` span a round carries the
   history's bytes, and no health alert fires; prints the span count and
   the traced and untraced seconds per round. (b) the launcher on the card,
   ``python -m repro_torch.launch.train --mode vit --rounds 2 --clients 2
   --layers 2 --d-model 256 --codec int8 --trace --metrics --health
   --profile-dir D --obs-dir D``: every artifact parses (the JSONL trace,
   the Chrome trace, the metrics CSV, ``health.json``,
   ``run_history.json``), and the ``torch.profiler`` trace names every
   CUDA kernel of that path (``KERNEL_NAMES``: pack and unpack, RMSNorm,
   attention (fp32: the launcher's ``reduced()`` model computes in fp32),
   InfoNCE forward and dq, int8 quantize and dequantize).
   Prints the phase's seconds.
3. reference: one SSL loss at full width on 8 images, fp32 compute, on the
   card (kernels) against the CPU (plain PyTorch versions); then one
   ``lm_ssl_loss`` with alignment on the trained zamba2 model, one stage
   group, 2 x 512 tokens (two SSD chunks, so the carried state runs), fp32
   compute, the same way.
4. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the main path's shapes (plus a causal + sliding-window + GQA
   attention case and the backward of both autograd Functions), with the
   tolerance stated; then the kernel's time beside its plain version's, one
   PyTorch library call's where there is one, and the least time the card
   could take (its bound). Attention's bf16 cases run its tensor-core
   kernel and its fp32 cases the CUDA-core one (the wrapper dispatches by
   dtype). The codec kernels run on the stage-12 upload of
   the trained model (21,177,920 floats in 24 slots; top-k keeps
   k = 2,117,792), bit-identical to their plain versions, plus a top-k case
   whose threshold is 0 with ties over the whole payload; the dequantizer's
   calls must run ``int8_dequant_kernel`` alone (no table copy). The InfoNCE
   forward, dq and dk kernels run at (C, B, d) = (1, 256, 256) (the main
   path's MoCo terms), (1, 256, 192) (its alignment terms), (4, 256, 256)
   (the vmap path's) and a ragged (2, 96, 200), within 1e-5 of the largest
   value; ``torch.matmul`` + ``F.cross_entropy`` is timed beside the
   forward for context (two calls, so not a library time). The forward
   and dq must give the same bits twice, and a client alone the bits it
   gets inside C = 4. The LM path's shapes: the SSD scan at (4, 1024, 80,
   64), N 64, chunk 256 (bit-identical over two calls, and its four
   kernels' times), five other shapes of one to five chunks, and its
   backward; causal attention at (4, 1024, 32, 80) bf16; RMSNorm at
   (4096, 2560) and (4096, 5120); InfoNCE at (1, 4, 2560), with the
   two-call yardstick, and at widths above 4096.

With ``--profile``, a fifth phase traces one local step of the last stage
with ``torch.profiler``, of one client and of four at once (the vmap
engine's step), and one local step of the LM path at stage 2, and prints
where their device time goes; then it splits the LM step by source with
CUDA events (forward, forward and backward, AdamW, the
``SSDScanFn.backward`` calls inside the step, and one such call alone).

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. TF32 is off throughout,
so fp32 products are full fp32. Exits non-zero, printing no result, without
a CUDA GPU or without the repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s, bf16 and TF32
# tensor-core FLOP/s, fp32 (non-tensor) FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12

TPU_SOURCES = {
    "gather_pack": ("src/repro_torch/kernels/csrc/pack.cu",
                    "src/repro/kernels/pack.py:55"),
    "scatter_unpack": ("src/repro_torch/kernels/csrc/pack.cu",
                       "src/repro/kernels/pack.py:88"),
    "rmsnorm_rows": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                     "src/repro/kernels/rmsnorm.py:26"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:90"),
    "int8_quant_matrix": ("src/repro_torch/kernels/csrc/wire_codecs.cu",
                          "src/repro/kernels/wire_codecs.py:75"),
    "int8_dequant_matrix": ("src/repro_torch/kernels/csrc/wire_codecs.cu",
                            "src/repro/kernels/wire_codecs.py:104"),
    "compensate": ("src/repro_torch/kernels/csrc/wire_codecs.cu",
                   "src/repro/kernels/wire_codecs.py:135"),
    "topk_ef_update": ("src/repro_torch/kernels/csrc/wire_codecs.cu",
                       "src/repro/kernels/wire_codecs.py:191"),
    "info_nce_rows": ("src/repro_torch/kernels/csrc/infonce.cu",
                      "src/repro/kernels/infonce.py:65"),
    "info_nce_rows_dq": ("src/repro_torch/kernels/csrc/infonce.cu",
                         "src/repro/kernels/infonce.py:65"),
    "info_nce_rows_dk": ("src/repro_torch/kernels/csrc/infonce.cu",
                         "src/repro/kernels/infonce.py:65"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/mamba2_scan.py:67"),
}
# the kernels each path must launch; a kernel's "launches" in the kernels
# line is its count on the first path that lists it. info_nce_rows_dk is on
# no path: every negative of the loss is detached, so only chip_smoke's
# check launches it.
MAIN_KERNELS = ("gather_pack", "scatter_unpack", "rmsnorm_rows",
                "flash_attention", "info_nce_rows", "info_nce_rows_dq")
PATH_KERNELS = {
    "fp32": MAIN_KERNELS,
    "int8": ("int8_quant_matrix", "int8_dequant_matrix"),
    "topk": ("compensate", "topk_ef_update"),
    "vmap": MAIN_KERNELS,
    "lm": MAIN_KERNELS + ("ssd_scan",),
}
TOPK_ROUNDS_PER_STAGE = (1,) * 11 + (3,)
# phase 2d: zamba2-2.7b at full width, 2 stage groups of 6 Mamba2 blocks
LM_ARCH, LM_GROUPS = "zamba2-2.7b", 2
LM_RUN = dict(clients=4, rounds=4, batch=4, seq_len=1024, samples=64)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def import_port():
    """The port from this checkout's ``src/``, never from elsewhere."""
    if not (SRC / "repro_torch" / "__init__.py").exists():
        raise SmokeFailure(f"no src/repro_torch beside {__file__}: run this "
                           f"script from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import repro_torch
    check(pathlib.Path(repro_torch.__file__).resolve().is_relative_to(SRC),
          f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    return repro_torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------
def main_path(device, *, model_cfg, ssl_cfg, clients=4, rounds=12,
              batch=256, samples=4096, eval_epochs=10, seed=0, codec="fp32",
              rounds_per_stage=(), engine="sequential", obs=None):
    """LW-FedSSL through ``run_fedssl`` (and ``linear_eval`` unless
    ``eval_epochs`` is 0) on ``device``, recorded by ``obs`` if given.
    Returns (state, history, accuracy or None, per-round seconds,
    images)."""
    import torch
    from repro_torch.configs.base import FLConfig, TrainConfig
    from repro_torch.convert import subtree
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import synthetic_images
    from repro_torch.federated.driver import run_fedssl
    from repro_torch.federated.eval import linear_eval

    fl = FLConfig(num_clients=clients, rounds=rounds, local_epochs=1,
                  schedule="lw_fedssl", seed=seed,
                  rounds_per_stage=rounds_per_stage)
    tc = TrainConfig(batch_size=batch)
    gen = torch.Generator(device).manual_seed(seed)
    images, labels = synthetic_images(gen, samples, 10, 32)
    idx = iid_partition(samples, clients, seed=seed)
    aux = images[:int(samples * fl.aux_fraction)]
    stamps = []

    def log(line):
        stamps.append(time.perf_counter())
        print("  " + line, flush=True)

    t0 = time.perf_counter()
    state, hist = run_fedssl(model_cfg, ssl_cfg, fl, tc, images=images,
                             client_indices=idx, aux_images=aux, log=log,
                             device=device, codec=codec, engine=engine,
                             obs=obs)
    secs = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    if not eval_epochs:
        return state, hist, None, secs, images
    half = samples // 2
    acc = linear_eval(ssl_mod.make_vit_encoder(model_cfg),
                      subtree(state["online"], "enc"),
                      images[:half], labels[:half], images[half:],
                      labels[half:], num_classes=10, epochs=eval_epochs,
                      batch_size=batch)
    return state, hist, acc, secs, images


def expected_wire_bytes(online, codec, rounds, rounds_per_stage=()):
    """Per-round (download, upload) wire bytes of one client under
    ``codec``: the codec's exact byte count of each payload, and the
    payload's own bytes in a delta codec's dense re-sync (the first round
    under a download layout). Returns (stages, downloads, uploads)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import schedule as sched
    from repro_torch.federated.transport import Transport

    wire = Transport(codec)
    plans = sched.build_schedule(
        FLConfig(rounds=rounds, schedule="lw_fedssl",
                 rounds_per_stage=rounds_per_stage), 12)
    down, up, prev = [], [], None
    for plan in plans:
        specs = wire.plan_specs(online, plan)
        d = specs["download"]
        down.append(d.payload_bytes if wire.codec.delta and d != prev
                    else wire.wire_bytes(d))
        up.append(wire.wire_bytes(specs["upload"]))
        prev = d
    return [p.stage for p in plans], down, up


def check_history(hist, online, codec="fp32", rounds=12,
                  rounds_per_stage=()):
    stages, down, up = expected_wire_bytes(online, codec, rounds,
                                           rounds_per_stage)
    check(len(hist.loss) == rounds, f"{len(hist.loss)} rounds of {rounds}")
    check(all(math.isfinite(x) for x in hist.loss),
          f"non-finite loss: {hist.loss}")
    check(hist.round_stage == stages, f"stages {hist.round_stage}")
    check(hist.wire_download_bytes == down,
          f"{codec}: wire download bytes {hist.wire_download_bytes}, "
          f"expected {down}")
    check(hist.wire_upload_bytes == up,
          f"{codec}: wire upload bytes {hist.wire_upload_bytes}, "
          f"expected {up}")
    if codec == "fp32":
        check(hist.wire_download_bytes == hist.download_bytes
              and hist.wire_upload_bytes == hist.upload_bytes,
              "fp32 wire bytes differ from the analytic bytes")


def engine_comparison(model_cfg, ssl_cfg, layers=2, steps=3):
    """Both engines from one seed at full width, depth cut to ``layers``
    blocks, fp32 compute, 2 rounds of one local step per client (1024
    images). Returns (sequential losses, vmap losses, largest parameter
    difference, the largest per-step loss difference of a lockstep run,
    and there the largest gradient difference over the largest gradient
    and the largest relative L2 difference of a client's gradient).

    Only the first round's losses can be held to a tight tolerance: from
    the second on, each engine trains from parameters that differ by
    rounding, which AdamW's normalised step turns into updates of up to
    the rate on coordinates whose gradient is near zero. So the lockstep
    part feeds both engines' steps the same state, ``steps`` times in a
    row at stage 2 (alignment on, block 1 frozen): ``stacked_train_step``
    for the four clients against ``train_step`` for each client, on the
    same views, continuing from the batched step's result. The gradients
    there, ``vmap`` of ``grad`` against each client's ``grad``, are
    printed and not checked: a ReLU input that lands within rounding of 0
    takes the other subgradient under another summation order, which
    changes a whole client's gradient by far more than rounding (the CPU
    shows it too, between two thread counts of the same code)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import subtree
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data.augment import draw_params, two_views
    from repro_torch.federated.client import stacked_train_step, train_step
    from repro_torch.optim import make_optimizer

    cfg = dataclasses.replace(model_cfg, num_layers=layers,
                              compute_dtype="float32")
    runs = {}
    for engine in ("sequential", "vmap"):
        state, hist, _, _, images = main_path(
            "cuda", model_cfg=cfg, ssl_cfg=ssl_cfg, rounds=2, samples=1024,
            eval_epochs=0, engine=engine)
        runs[engine] = (state, hist.loss)
    (seq, seq_loss), (vm, vm_loss) = runs["sequential"], runs["vmap"]
    perr = max(float((seq["online"][k] - vm["online"][k]).abs().max())
               for k in seq["online"])

    C, B = 4, 256
    enc = ssl_mod.make_vit_encoder(cfg)
    opt = make_optimizer(TrainConfig(batch_size=B))
    gen = torch.Generator("cuda").manual_seed(7)
    on = {k: v.expand(C, *v.shape) for k, v in vm["online"].items()}
    st = {"online": on, "target": {k: on[k] for k in vm["target"]}}
    opt_state = opt.init(on)
    kw = dict(encoder=enc, ssl_cfg=ssl_cfg, opt=opt, sub_layers=layers,
              active_from=layers - 1,
              global_enc=subtree(vm["online"], "enc"),
              align_weight=ssl_cfg.align_weight)
    def grads(st, x1, x2):
        def loss(online):
            return ssl_mod.ssl_loss(
                {**st, "online": online}, x1, x2, enc, ssl_cfg,
                sub_layers=layers, active_from=layers - 1,
                global_enc=kw["global_enc"],
                align_weight=ssl_cfg.align_weight)[0]
        return torch.func.grad(loss)(st["online"])

    lock = gerr = gl2 = 0.0
    for _ in range(steps):
        x1, x2 = two_views(images[:C * B], draw_params(gen, C * B, 32, 32),
                           draw_params(gen, C * B, 32, 32))
        gv = torch.func.vmap(grads)(st, x1.unflatten(0, (C, B)),
                                    x2.unflatten(0, (C, B)))
        new_st, new_opt, losses = stacked_train_step(
            st, opt_state, x1.unflatten(0, (C, B)), x2.unflatten(0, (C, B)),
            1e-4, **kw)
        for c in range(C):
            one = {b: {k: v[c] for k, v in t.items()} for b, t in st.items()}
            one_opt = {"mu": {k: v[c] for k, v in opt_state["mu"].items()},
                       "nu": {k: v[c] for k, v in opt_state["nu"].items()},
                       "count": opt_state["count"]}
            _, _, m = train_step(one, one_opt, x1[c * B:(c + 1) * B],
                                 x2[c * B:(c + 1) * B], 1e-4, **kw)
            lock = max(lock, abs(float(m["loss"]) - float(losses[c])))
            gs = grads(one, x1[c * B:(c + 1) * B], x2[c * B:(c + 1) * B])
            gerr = max(gerr, max(float((gv[k][c] - g).abs().max())
                                 for k, g in gs.items())
                       / max(float(g.abs().max()) for g in gs.values()))
            gl2 = max(gl2, math.sqrt(
                sum(float(((gv[k][c] - g) ** 2).sum()) for k, g in gs.items())
                / sum(float((g ** 2).sum()) for g in gs.values())))
        st, opt_state = new_st, new_opt
    return seq_loss, vm_loss, perr, lock, gerr, gl2


# ---------------------------------------------------------------------------
# phase 2d: the LM path
# ---------------------------------------------------------------------------
def lm_config(groups=LM_GROUPS, **kw):
    """zamba2-2.7b at its published widths, depth cut to ``groups`` stage
    groups of ``attn_every`` Mamba2 blocks."""
    from repro_torch.configs.base import load_arch
    cfg = load_arch(LM_ARCH)
    return dataclasses.replace(cfg, num_layers=groups * cfg.attn_every, **kw)


def lm_path(device, *, clients, rounds, batch, seq_len, samples, seed=0,
            codec="fp32"):
    """LW-FedSSL through ``run_lm_fedssl`` on ``lm_config()``. Returns
    (cfg, final params, history, per-round seconds, plans, tokens)."""
    import torch
    from repro_torch.configs.base import FLConfig, TrainConfig
    from repro_torch.core import schedule as sched
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.federated.driver import run_lm_fedssl
    from repro_torch.models import lm

    cfg = lm_config()
    fl = FLConfig(num_clients=clients, rounds=rounds, local_epochs=1,
                  schedule="lw_fedssl", seed=seed)
    tc = TrainConfig(batch_size=batch, base_lr=3e-4)
    gen = torch.Generator(device).manual_seed(seed)
    toks, labs = synthetic_tokens(gen, samples, seq_len, cfg.vocab_size)
    shards = iid_partition(samples, clients, seed=seed)
    params = lm.init_lm(cfg, gen, device)
    print(f"  {cfg.arch_id}: {cfg.num_layers} Mamba2 blocks in "
          f"{lm.num_stages(cfg)} stage groups, d {cfg.d_model}, "
          f"{sum(t.numel() for t in params.values())} parameters",
          flush=True)
    stamps = []

    def log(line):
        stamps.append(time.perf_counter())
        print("  " + line, flush=True)

    t0 = time.perf_counter()
    params, hist = run_lm_fedssl(cfg, fl, tc, tokens=toks, labels=labs,
                                 shards=shards, params=params, device=device,
                                 codec=codec, log=log)
    secs = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    steps = [max(1, len(ix) // batch) * fl.local_epochs for ix in shards]
    return (cfg, params, hist, secs,
            sched.build_schedule(fl, lm.num_stages(cfg)), steps, toks)


def lm_expected_launches(cfg, plans, steps):
    """(ssd_scan, flash_attention) launches the LM path's plan implies:
    per local step at stage s, s groups of ``attn_every`` scans and one
    attention each, in the online forward (frozen groups included) and
    again in the global model's when the plan aligns."""
    scans = attns = 0
    for plan in plans:
        passes = 2 if plan.align else 1
        for n in steps:
            scans += n * passes * plan.sub_layers * cfg.attn_every
            attns += n * passes * plan.sub_layers
    return scans, attns


def lm_pack_checks(params, plans):
    """gather_pack and scatter_unpack against their plain versions on the
    LM path's own payloads: every distinct download and upload layout of
    ``plans`` over the trained zamba tree (the (groups, attn_every, ...)
    block stacks, shared_attn, embed, lm_head, final_ln), bit-identical;
    unpack of a random payload into fresh leaves. Times at the largest
    payload. Returns {name: record}."""
    import torch
    from repro_torch.federated.transport import Transport
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(9)
    specs = {}
    for plan in plans:
        for direction, spec in Transport().plan_specs(params, plan).items():
            key = (spec.total, tuple(map(tuple, spec.layout)),
                   tuple(s.path for s in spec.slots))
            names = specs.setdefault(key, ([], spec))[0]
            if f"stage {plan.stage} {direction}" not in names:
                names.append(f"stage {plan.stage} {direction}")
    specs = [(" = ".join(names), spec) for names, spec in specs.values()]
    for what, spec in specs:
        leaves = [params["/".join(s.path)] for s in spec.slots]
        flat = ops.wire_pack(leaves, spec.layout, spec.total)
        err = max_err(flat, ref.wire_pack_ref(leaves, spec.layout,
                                              spec.total))
        print(f"  gather_pack LM {what} ({spec.total} floats in "
              f"{len(spec.slots)} slots): max |kernel - plain| = {err:.3e} "
              f"(tolerance 0)", flush=True)
        check(err == 0.0, f"gather_pack LM {what}: error {err}")
        del flat
        new = torch.randn(spec.total, generator=gen, device=dev)
        err = max_err(ops.wire_unpack(new, leaves, spec.layout),
                      ref.wire_unpack_ref(new, leaves, spec.layout))
        print(f"  scatter_unpack LM {what}: max |kernel - plain| = "
              f"{err:.3e} (tolerance 0)", flush=True)
        check(err == 0.0, f"scatter_unpack LM {what}: error {err}")
        del new
    what, spec = max(specs, key=lambda ws: ws[1].total)
    leaves = [params["/".join(s.path)] for s in spec.slots]
    leaf_bytes = 4 * sum(t.numel() for t in leaves)
    slices = [t.reshape(-1)[a:a + n] for t, (a, _, n) in
              zip(leaves, spec.layout)]
    new = torch.randn(spec.total, generator=gen, device=dev)
    rec = {"gather_pack_lm": dict(
        max_abs_err=0.0,
        ms=time_ms([lambda: ops.wire_pack(leaves, spec.layout, spec.total)]),
        plain_ms=time_ms([lambda: ref.wire_pack_ref(leaves, spec.layout,
                                                    spec.total)]),
        library_ms=time_ms([lambda: torch.cat(slices)]),
        bound_ms=2 * 4 * spec.total / HBM_BPS * 1e3, bound_by="bytes",
        shape=f"LM {what} payload {spec.total} fp32 in {len(leaves)} "
              f"slots"),
        "scatter_unpack_lm": dict(
        max_abs_err=0.0,
        ms=time_ms([lambda: ops.wire_unpack(new, leaves, spec.layout)]),
        plain_ms=time_ms([lambda: ref.wire_unpack_ref(new, leaves,
                                                      spec.layout)]),
        library_ms=None,
        bound_ms=2 * leaf_bytes / HBM_BPS * 1e3, bound_by="bytes",
        shape=f"LM {what} payload {spec.total} fp32 into "
              f"{leaf_bytes // 4} leaf elements")}
    for name, r in rec.items():
        print(f"  LM shapes, {name} [{r['shape']}]: kernel {r['ms']} ms, "
              f"plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']})", flush=True)
    return rec


# ---------------------------------------------------------------------------
# phase 2e: observability on the card
# ---------------------------------------------------------------------------
def traced_codec_run(model_cfg, ssl_cfg, untraced, untraced_launches):
    """Phase 2b's int8 run traced, with metrics and the health monitor,
    held to the untraced run ``untraced`` (its history and per-round
    seconds) and its launch counts. Returns the traced seconds a round."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs import make_obs

    uhist, usecs = untraced
    obs = make_obs(trace=True, metrics=True, health=True, mode="chip_smoke")
    ops.reset_launch_counts()
    _, hist, _, secs, _ = main_path("cuda", model_cfg=model_cfg,
                                    ssl_cfg=ssl_cfg, eval_epochs=0,
                                    codec="int8", obs=obs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(hist.wire_download_bytes == uhist.wire_download_bytes
          and hist.wire_upload_bytes == uhist.wire_upload_bytes,
          f"traced wire bytes {hist.wire_download_bytes} / "
          f"{hist.wire_upload_bytes} differ from the untraced run's")
    check(launches == untraced_launches,
          f"traced launches {launches} differ from the untraced run's "
          f"{untraced_launches}")
    counters = obs.metrics.to_dict()["counters"]
    want = {"fl.rounds": len(hist.loss),
            "comm.download_bytes": sum(hist.download_bytes),
            "comm.upload_bytes": sum(hist.upload_bytes),
            "wire.download_bytes": sum(hist.wire_download_bytes),
            "wire.upload_bytes": sum(hist.wire_upload_bytes)}
    check(counters == want, f"counters {counters}, history {want}")
    rounds = sorted((e for e in obs.tracer.events if e["name"] == "round"),
                    key=lambda e: e["seq"])
    check(len(rounds) == len(hist.loss),
          f"{len(rounds)} round spans for {len(hist.loss)} rounds")
    for r, e in enumerate(rounds):
        for name in ("download_bytes", "upload_bytes", "wire_download_bytes",
                     "wire_upload_bytes"):
            check(e["args"][name] == getattr(hist, name)[r],
                  f"round {r} span {name} {e['args'][name]}, history "
                  f"{getattr(hist, name)[r]}")
    check(obs.health.alerts == [] and obs.health.rounds_observed == 12,
          f"health alerts {obs.health.alerts}")
    diff = max(abs(a - b) for a, b in zip(hist.loss, uhist.loss))
    print(f"  traced int8: {len(obs.tracer.events)} events "
          f"({len(rounds)} round spans); wire bytes and launches equal the "
          f"untraced run's; counters equal the history; no health alert; "
          f"largest loss difference to the untraced run {diff:.3e} "
          f"(bit-identical required)", flush=True)
    print(f"  traced seconds per round {[round(x, 3) for x in secs]} "
          f"(untraced {[round(x, 3) for x in usecs]}); rounds 2-12 "
          f"{sum(secs[1:]):.3f} s traced, {sum(usecs[1:]):.3f} s untraced",
          flush=True)
    check(hist.loss == uhist.loss,
          f"traced losses {hist.loss} differ from the untraced "
          f"{uhist.loss}")
    return secs


# the CUDA kernels the launcher's int8 ViT run must show in its profile;
# its reduced() model computes in fp32 (as the reference's launcher does),
# so its attention is the fp32 kernel
CLI_KERNELS = ("gather_pack_kernel", "scatter_unpack_kernel",
               "rmsnorm_rows_kernel", "flash_fwd_kernel",
               "int8_absmax_kernel", "int8_quant_kernel",
               "int8_dequant_kernel", "info_nce_logits_kernel<0>",
               "info_nce_rows_kernel", "info_nce_logits_kernel<1>",
               "info_nce_grad_kernel<false>")


def obs_cli_run():
    """``repro_torch.launch.train`` with every observability flag on the
    card; checks that each artifact parses and that the profiler's trace
    names the path's kernels. The artifacts go to ``results/`` (ignored by
    git) and are removed after the checks."""
    from repro_torch.obs import read_jsonl
    from repro_torch.obs.core import PROFILE_TRACE

    out = ROOT / "results" / "chip_smoke_obs"
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "vit",
           "--rounds", "2", "--clients", "2", "--layers", "2", "--d-model",
           "256", "--codec", "int8", "--trace", "--metrics", "--health",
           "--profile-dir", str(out), "--obs-dir", str(out)]
    print("  " + " ".join(cmd[1:]), flush=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    check(proc.returncode == 0,
          f"the launcher exited {proc.returncode}: {proc.stderr[-3000:]}")
    for ln in proc.stdout.splitlines():
        if ln.startswith(("round ", "obs: ", "training done")):
            print("  | " + ln, flush=True)
    _, events = read_jsonl(out / "run_trace.jsonl")
    check(sum(e["name"] == "round" for e in events) == 2,
          "the JSONL trace does not hold 2 round spans")
    chrome = json.loads((out / "run_trace.chrome.json").read_text())
    check(len(chrome["traceEvents"]) >= len(events),
          "the Chrome trace lacks events")
    csv = (out / "run_metrics.csv").read_text().splitlines()
    check(csv[0] == "metric,type,field,value" and len(csv) > 1,
          f"metrics CSV {csv[:2]}")
    health = json.loads((out / "health.json").read_text())
    check(health["rounds_observed"] == 2 and not health["fatal"],
          f"health {health}")
    hist = json.loads((out / "run_history.json").read_text())["fields"]
    check(len(hist["loss"]) == 2 and all(math.isfinite(x)
                                         for x in hist["loss"]),
          f"history losses {hist['loss']}")
    prof_path = out / PROFILE_TRACE
    prof = json.loads(prof_path.read_text())
    kernels = {e["name"] for e in prof["traceEvents"]
               if e.get("cat") == "kernel"}
    missing = [k for k in CLI_KERNELS if not any(k in n for n in kernels)]
    print(f"  artifacts parse: {len(events)} trace events, {len(csv) - 1} "
          f"metric rows, health {health['counts']}; torch.profiler trace "
          f"{prof_path.stat().st_size / 2**20:.1f} MiB, "
          f"{len(kernels)} distinct CUDA kernels, the path's "
          f"{len(CLI_KERNELS) - len(missing)} of {len(CLI_KERNELS)} among "
          f"them", flush=True)
    check(not missing, f"the profiler trace lacks {missing}")
    shutil.rmtree(out)


# ---------------------------------------------------------------------------
# phase 3: full-width SSL loss, card against CPU
# ---------------------------------------------------------------------------
def reference_check(model_cfg, ssl_cfg, state, images):
    """ssl_loss with fp32 compute on 8 images: kernels on the card against
    the plain versions on the CPU, on the trained state. Returns the
    relative loss difference and the max CLS difference."""
    import torch
    from repro_torch.convert import subtree
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data.augment import draw_params, two_views

    cfg = dataclasses.replace(model_cfg, compute_dtype="float32")
    enc = ssl_mod.make_vit_encoder(cfg)
    gen = torch.Generator("cpu").manual_seed(1)
    x = images[:8].cpu()
    x1, x2 = two_views(x, draw_params(gen, 8, 32, 32),
                       draw_params(gen, 8, 32, 32))
    out = {}
    for dev in ("cuda", "cpu"):
        st = {b: {k: v.to(dev) for k, v in t.items()}
              for b, t in state.items()}
        with torch.no_grad():
            loss, _ = ssl_mod.ssl_loss(
                st, x1.to(dev), x2.to(dev), enc, ssl_cfg,
                sub_layers=cfg.num_layers, active_from=cfg.num_layers - 1,
                global_enc=subtree(st["online"], "enc"),
                align_weight=ssl_cfg.align_weight)
            z = enc.apply(subtree(st["online"], "enc"), x1.to(dev))
        out[dev] = (float(loss), z.cpu())
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    zerr = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    return rel, zerr


def lm_reference_check(params, tokens, n=2, seq=512):
    """``lm_ssl_loss`` with alignment at full width, stage group 1, on ``n``
    x ``seq`` tokens at fp32 compute: kernels on the card against the plain
    versions on the CPU. The global model is the trained one with every
    leaf nudged by 1e-3 of its spread (noise from a fixed seed), so the
    alignment compares two models; with one sequence its InfoNCE would have
    a single row and be 0 exactly, hence two. Returns {metric: relative
    difference}."""
    import torch
    from repro_torch.core.ssl import lm_ssl_loss

    cfg = lm_config(compute_dtype="float32")
    gen = torch.Generator("cpu").manual_seed(2)
    local = {k: v.cpu() for k, v in params.items()}
    glob = {k: v + 1e-3 * v.std() * torch.randn(v.shape, generator=gen)
            if v.numel() > 1 else v for k, v in local.items()}
    tok = tokens[:n, :seq].cpu()
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    out = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            _, m = lm_ssl_loss(
                {k: v.to(dev) for k, v in local.items()},
                {k: v.to(dev) for k, v in batch.items()}, cfg,
                sub_layers=1, active_from=0,
                global_params={k: v.to(dev) for k, v in glob.items()},
                align_weight=0.01)
        out[dev] = {k: float(v) for k, v in m.items() if k != "aux"}
    print(f"  card {out['cuda']}, CPU {out['cpu']}", flush=True)
    return {k: abs(out["cuda"][k] - v) / max(abs(v), 1e-12)
            for k, v in out["cpu"].items()}


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------
def time_ms(calls, iters=24) -> float:
    """Mean device milliseconds of one call. ``calls`` are closures over
    distinct copies of the inputs, whose bytes together exceed the 50 MB L2
    cache, and the timed loop cycles through them, so each call finds its
    inputs in device memory as the main path mostly does. The device first
    sleeps for about 0.1 s while the host enqueues the timed calls, so the
    events measure back-to-back device work and not the host's launch
    overhead (a host slower than that would show up as a longer time)."""
    import torch
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_split(fn, names, calls=12):
    """Mean device ms a call of each CUDA kernel whose name holds one of
    ``names``, over ``calls`` calls of ``fn`` under torch.profiler (inputs
    as they are: an L2-warm split of the call, for its shape only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        name = next((n for n in names if n in e.key), None)
        if name is not None:
            out[name] = out.get(name, 0.0) + device_us(e) / 1e3 / calls
    return out


def device_us(e) -> float:
    """A profiler event's own device microseconds (the attribute's name
    differs between torch versions)."""
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


def bound(nbytes, flops, peak=FP32_FLOPS):
    """(bound ms, what bounds it) of work moving ``nbytes`` and doing
    ``flops`` at ``peak``."""
    tb, tf = nbytes / HBM_BPS, flops / peak
    return max(tb, tf) * 1e3, "bytes" if tb > tf else "operations"


def copies(nbytes: int) -> int:
    """Input copies to cycle through so that they exceed the L2 cache."""
    return max(1, math.ceil(2 * 50e6 / nbytes))


def max_err(a, b) -> float:
    if isinstance(a, (list, tuple)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def kernel_checks(state):
    """Each kernel's wrapper against its plain version at the main path's
    shapes; returns {name: record} and prints one line per comparison."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import schedule as sched
    from repro_torch.federated.transport import Transport
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    rec = {}

    def line(name, err, tol):
        print(f"  {name}: max |kernel - plain| = {err:.3e} "
              f"(tolerance {tol:g})", flush=True)
        check(err <= tol, f"{name}: error {err} above {tol}")

    # wire pack / unpack: the last stage's payloads of LW-FedSSL
    online = state["online"]
    plans = sched.build_schedule(FLConfig(rounds=12, schedule="lw_fedssl"),
                                 12)
    specs = Transport().plan_specs(online, plans[-1])
    err_p = err_u = 0.0
    for direction in ("download", "upload"):
        spec = specs[direction]
        leaves = [online["/".join(s.path)] for s in spec.slots]
        flat = ops.wire_pack(leaves, spec.layout, spec.total)
        err = max_err(flat, ref.wire_pack_ref(leaves, spec.layout,
                                              spec.total))
        line(f"gather_pack {direction} ({spec.total} floats)", err, 0.0)
        new = torch.randn(spec.total, generator=gen, device=dev)
        outs = ops.wire_unpack(new, leaves, spec.layout)
        err2 = max_err(outs, ref.wire_unpack_ref(new, leaves, spec.layout))
        line(f"scatter_unpack {direction}", err2, 0.0)
        err_p, err_u = max(err_p, err), max(err_u, err2)
    # time the upload (4 a round against one download); its 85 MB in and
    # 85 MB out exceed the L2 cache by themselves
    leaves = [online["/".join(s.path)] for s in spec.slots]
    payload = 4 * spec.total
    leaf_bytes = 4 * sum(t.numel() for t in leaves)
    slices = [t.reshape(-1)[a:a + n] for t, (a, _, n) in
              zip(leaves, spec.layout)]
    rec["gather_pack"] = dict(
        max_abs_err=err_p,
        ms=time_ms([lambda: ops.wire_pack(leaves, spec.layout, spec.total)]),
        plain_ms=time_ms([lambda: ref.wire_pack_ref(leaves, spec.layout,
                                                    spec.total)]),
        library_ms=time_ms([lambda: torch.cat(slices)]),
        bound_ms=2 * payload / HBM_BPS * 1e3, bound_by="bytes",
        shape=f"upload payload {spec.total} fp32 in {len(leaves)} slots")
    rec["scatter_unpack"] = dict(
        max_abs_err=err_u,
        ms=time_ms([lambda: ops.wire_unpack(new, leaves, spec.layout)]),
        plain_ms=time_ms([lambda: ref.wire_unpack_ref(new, leaves,
                                                      spec.layout)]),
        library_ms=None,
        bound_ms=2 * leaf_bytes / HBM_BPS * 1e3, bound_by="bytes",
        shape=f"upload payload {spec.total} fp32 into "
              f"{leaf_bytes // 4} leaf elements")

    # RMSNorm: the fp32 residual stream at batch 256
    R, d = 256 * 65, 192
    x = torch.randn((R, d), generator=gen, device=dev)
    scale = online["enc/blocks/ln1/scale"][0]
    y = ops.rmsnorm(x, scale)
    err = max_err(y, ref.rmsnorm_ref(x, scale))
    line(f"rmsnorm_rows ({R}, {d}) fp32", err, 1e-5)
    nbytes = 4 * (2 * R * d + d)
    xs = [x] + [torch.randn((R, d), generator=gen, device=dev)
                for _ in range(copies(nbytes) - 1)]

    def over(fn):
        return [lambda a=a: fn(a) for a in xs]

    bms, by = bound(nbytes, 4 * R * d)
    rec["rmsnorm_rows"] = dict(
        max_abs_err=err, ms=time_ms(over(lambda a: ops.rmsnorm(a, scale))),
        plain_ms=time_ms(over(lambda a: ref.rmsnorm_ref(a, scale))),
        library_ms=time_ms(over(lambda a: F.rms_norm(a, (d,), scale,
                                                     1e-5))),
        bound_ms=bms, bound_by=by, shape=f"x ({R}, {d}) fp32")

    # attention: the ViT's bf16 q, k, v at batch 256
    B, S, Hh, hd = 256, 65, 3, 64
    nbytes = 2 * 4 * B * S * Hh * hd
    flops = 4 * B * Hh * S * S * hd
    qkvs = [tuple(torch.randn((B, S, Hh, hd), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
            for _ in range(copies(nbytes))]
    q, k, v = qkvs[0]

    def plain(q, k, v):
        return ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False).transpose(1, 2)

    o = ops.flash_attention(q, k, v, causal=False)
    err = max_err(o, plain(q, k, v))
    line(f"flash_attention ({B}, {S}, {Hh}, {hd}) bf16", err, 2e-2)
    bhsd = [tuple(t.transpose(1, 2).contiguous() for t in qkv)
            for qkv in qkvs]
    bms, by = bound(nbytes, flops, BF16_FLOPS)
    rec["flash_attention"] = dict(
        max_abs_err=err,
        ms=time_ms([lambda a=a: ops.flash_attention(*a, causal=False)
                    for a in qkvs]),
        plain_ms=time_ms([lambda a=a: plain(*a) for a in qkvs]),
        library_ms=time_ms([lambda a=a: F.scaled_dot_product_attention(*a)
                            for a in bhsd]),
        bound_ms=bms, bound_by=by,
        shape=f"q, k, v ({B}, {S}, {Hh}, {hd}) bf16, non-causal")

    # the masks the ViT does not use: causal + window + GQA, and kv_len
    for (Bc, Sc, Hq, Hkv, hdc, causal, window, kv_len) in (
            (2, 200, 4, 2, 128, True, 64, None),
            (2, 130, 8, 1, 64, True, 0, 100)):
        qc = torch.randn((Bc, Sc, Hq, hdc), generator=gen, device=dev)
        kc = torch.randn((Bc, Sc, Hkv, hdc), generator=gen, device=dev)
        vc = torch.randn((Bc, Sc, Hkv, hdc), generator=gen, device=dev)
        got = ops.flash_attention(qc, kc, vc, causal=causal, window=window,
                                  kv_len=kv_len)
        want = ref.sdpa_ref(qc.transpose(1, 2), kc.transpose(1, 2),
                            vc.transpose(1, 2), causal=causal, window=window,
                            kv_len=kv_len).transpose(1, 2)
        line(f"flash_attention fp32 causal window={window} kv_len={kv_len} "
             f"Hq={Hq} Hkv={Hkv} hd={hdc}", max_err(got, want), 2e-5)

    # the backward of both autograd Functions against autograd through
    # the plain versions
    xg = torch.randn((130, d), generator=gen, device=dev).requires_grad_()
    sg = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)) \
        .requires_grad_()
    g = torch.randn((130, d), generator=gen, device=dev)
    got = torch.autograd.grad(ops.rmsnorm(xg, sg), (xg, sg), g)
    want = torch.autograd.grad(ref.rmsnorm_ref(xg, sg), (xg, sg), g)
    line("rmsnorm backward", max_err(got, want), 1e-4)
    qg, kg, vg = (torch.randn((2, 65, h, 64), generator=gen, device=dev)
                  .requires_grad_() for h in (4, 2, 2))
    go = torch.randn((2, 65, 4, 64), generator=gen, device=dev)
    got = torch.autograd.grad(
        ops.flash_attention(qg, kg, vg, causal=True), (qg, kg, vg), go)
    want = torch.autograd.grad(
        ref.sdpa_ref(qg.transpose(1, 2), kg.transpose(1, 2),
                     vg.transpose(1, 2), causal=True).transpose(1, 2),
        (qg, kg, vg), go)
    line("flash_attention backward (GQA, causal)", max_err(got, want), 1e-4)
    return rec


def codec_kernel_checks(state, fraction=0.1):
    """The four codec kernels against their plain versions on the stage-12
    upload of ``state`` (the payload FedAvg receives from each client in
    the last LW-FedSSL stage); returns {name: record}. No single PyTorch
    call computes any of the four functions, so ``library_ms`` is None."""
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import schedule as sched
    from repro_torch.federated.transport import (Transport, int8_segs,
                                                 pack_stage_payload)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wire_codecs as wc

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(4)
    online = state["online"]
    plan = sched.build_schedule(FLConfig(rounds=12, schedule="lw_fedssl"),
                                12)[-1]
    spec = Transport().plan_specs(online, plan)["upload"]
    n = spec.total
    k = max(1, min(n, int(round(n * fraction))))
    segs, nscales = int8_segs(spec)
    flat = pack_stage_payload(online, spec)
    print(f"  stage-12 upload: {n} floats in {len(spec.slots)} slots, "
          f"{nscales} int8 scales, top-k k = {k}", flush=True)
    rec = {}

    def line(name, ok, what):
        print(f"  {name}: {what}", flush=True)
        check(ok, f"{name}: {what}")

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def split(name, fn, names):
        ms = kernel_split(fn, names)
        print(f"  {name} by CUDA kernel (profiler, L2-warm): "
              + ", ".join(f"{k} {ms.get(k, 0.0):.4f} ms" for k in names),
              flush=True)

    # int8 quant and dequant: bit-identical (IEEE division and rint on both)
    q, scales = ops.wire_int8_encode(flat, segs, nscales)
    wq, ws = ref.int8_encode_ref(flat, segs, nscales)
    line("int8_quant_matrix", equal((q, scales), (wq, ws)),
         "q and scales bit-identical to the plain version")
    line("int8_quant_matrix", equal(wc.int8_quant(flat, segs, nscales),
                                    (q, scales)),
         "a second call gives the same bits")
    split("int8_quant_matrix", lambda: wc.int8_quant(flat, segs, nscales),
          ("int8_absmax_kernel", "int8_quant_kernel", "Memset", "Memcpy"))
    dec = ops.wire_int8_decode(q, scales, segs, n)
    wdec = ref.int8_decode_ref(q, scales, segs, n)
    line("int8_dequant_matrix", torch.equal(dec, wdec),
         "bit-identical to the plain version")
    line("int8_dequant_matrix",
         torch.equal(wc.int8_dequant(q, scales, segs, n), dec),
         "a second call gives the same bits")
    dsplit = kernel_split(lambda: wc.int8_dequant(q, scales, segs, n),
                          ("int8_dequant_kernel", "Memcpy", "Memset"))
    print(f"  int8_dequant_matrix by CUDA kernel (profiler, L2-warm): "
          f"int8_dequant_kernel {dsplit.get('int8_dequant_kernel', 0.0):.4f}"
          f" ms", flush=True)
    line("int8_dequant_matrix", set(dsplit) == {"int8_dequant_kernel"},
         f"one kernel a call, no copy or memset: {sorted(dsplit)}")
    rec["int8_quant_matrix"] = dict(
        max_abs_err=float((q.int() - wq.int()).abs().max()),
        ms=time_ms([lambda: ops.wire_int8_encode(flat, segs, nscales)]),
        plain_ms=time_ms([lambda: ref.int8_encode_ref(flat, segs,
                                                      nscales)]),
        library_ms=None, bound_ms=(5 * n + 4 * nscales) / HBM_BPS * 1e3,
        bound_by="bytes",
        shape=f"{n} fp32 in {len(segs)} segments, {nscales} scales")
    rec["int8_dequant_matrix"] = dict(
        max_abs_err=max_err(dec, wdec),
        ms=time_ms([lambda: ops.wire_int8_decode(q, scales, segs, n)]),
        plain_ms=time_ms([lambda: ref.int8_decode_ref(q, scales, segs, n)]),
        library_ms=None, bound_ms=(5 * n + 4 * nscales) / HBM_BPS * 1e3,
        bound_by="bytes", shape=f"{n} int8 in {len(segs)} segments")

    # compensate and the EF update: a client's trained payload against the
    # downloaded one, with a carried residual
    trained = flat + 1e-3 * torch.randn(n, generator=gen, device=dev)
    res = 1e-4 * torch.randn(n, generator=gen, device=dev)
    c, a = ops.compensate(trained, flat, res)
    wc_, wa = ref.compensate_ref(trained, flat, res)
    line("compensate", equal((c, a), (wc_, wa)),
         "c and |c| bit-identical to the plain version")
    rec["compensate"] = dict(
        max_abs_err=max(max_err(c, wc_), max_err(a, wa)),
        ms=time_ms([lambda: ops.compensate(trained, flat, res)]),
        plain_ms=time_ms([lambda: ref.compensate_ref(trained, flat, res)]),
        library_ms=None, bound_ms=20 * n / HBM_BPS * 1e3, bound_by="bytes",
        shape=f"flat, ref, res ({n},) fp32")
    topk_ms = time_ms([lambda: ref.topk_threshold(a, k)])
    thresh, needed = ref.topk_threshold(a, k)
    errs = []
    cases = [("upload delta", c, a)]
    # a delta that is 95% exact zeros, as a download against the mirror is
    # mostly: the threshold is 0 and its ties run over the whole payload
    z = torch.where(torch.rand(n, generator=gen, device=dev) < 0.95,
                    torch.zeros_like(c), c)
    cases.append(("zero threshold", z, z.abs()))
    for what, comp, absc in cases:
        th, nd = ref.topk_threshold(absc, k)
        sel = torch.empty(1, dtype=torch.int64, device=dev)
        got = wc.topk_ef_update(comp, th.reshape(1), nd.reshape(1), k,
                                selected=sel)
        want = ref.topk_ef_update_ref(comp, th, nd)
        line(f"topk_ef_update ({what}: thresh {float(th):.3e}, "
             f"{int(nd)} ties kept)",
             int(sel) == k and equal(got, want),
             f"{int(sel)} selected of k = {k}; residual, idx and val "
             f"bit-identical to the plain version")
        line(f"topk_ef_update ({what})",
             equal(wc.topk_ef_update(comp, th.reshape(1), nd.reshape(1), k),
                   got), "a second call gives the same bits")
        errs.append(max(max_err(g, w) for g, w in zip(got, want)))
    split("topk_ef_update", lambda: wc.topk_ef_update(
        c, thresh.reshape(1), needed.reshape(1), k),
        ("ef_update_kernel", "Memset"))
    rec["topk_ef_update"] = dict(
        max_abs_err=max(errs),
        ms=time_ms([lambda: ops.topk_ef_update(c, thresh, needed, k)]),
        plain_ms=time_ms([lambda: ref.topk_ef_update_ref(c, thresh,
                                                         needed)]),
        library_ms=None, bound_ms=(8 * n + 8 * k) / HBM_BPS * 1e3,
        bound_by="bytes",
        shape=f"comp ({n},) fp32, k = {k}; threshold by torch.topk "
              f"{topk_ms:.4f} ms (not part of the kernel)")
    print(f"  torch.topk threshold of {n} magnitudes at k = {k}: "
          f"{topk_ms:.4f} ms", flush=True)
    return rec


def infonce_kernel_checks(tau=0.2):
    """The InfoNCE forward, dq and dk kernels against their plain versions
    (1e-5 of the largest value, fp32) at the main path's shapes and a
    ragged one; times at (C, B, d) = (1, 256, 256), the MoCo terms of a
    sequential step, and (4, 256, 256), the vmap path's. Returns {name:
    record}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import infonce as nce
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(6)

    def unit(shape):
        return F.normalize(torch.randn(shape, generator=gen, device=dev),
                           dim=-1)

    def errors(pairs):
        """(largest absolute error, largest error over the largest plain
        value) of (kernel, plain) pairs."""
        ab = max(float((a - b).abs().max()) for a, b in pairs)
        return ab, ab / max(max(float(b.abs().max()) for _, b in pairs),
                            1e-30)

    errs = {"info_nce_rows": 0.0, "info_nce_rows_dq": 0.0,
            "info_nce_rows_dk": 0.0}     # largest absolute errors
    for C, B, d in ((1, 256, 256), (1, 256, 192), (4, 256, 256),
                    (2, 96, 200)):
        q, k = unit((C, B, d)), unit((C, B, d))
        g = torch.randn((C, B), generator=gen, device=dev) / B
        loss, lse = nce.info_nce_fwd(q, k, tau)
        wloss, wlse = ref.info_nce_rows_ref(q, k, tau)
        e = {"info_nce_rows": errors(((loss, wloss), (lse, wlse)))}
        for name, wrt_k in (("info_nce_rows_dq", False),
                            ("info_nce_rows_dk", True)):
            e[name] = errors(((nce.info_nce_bwd(q, k, wlse, g, tau, wrt_k),
                               ref.info_nce_rows_bwd_ref(q, k, wlse, g, tau,
                                                         wrt_k)),))
        for name, (ab, err) in e.items():
            print(f"  {name} ({C}, {B}, {d}): max |kernel - plain| = "
                  f"{ab:.3e}, over max |plain| = {err:.3e} (tolerance "
                  f"1e-5)", flush=True)
            check(err <= 1e-5, f"{name} ({C}, {B}, {d}): error {err}")
            errs[name] = max(errs[name], ab)
    # bitwise: two calls agree, and client 2 of C = 4 gets the bits it gets
    # alone at C = 1 (the vmap rule folds clients into C)
    for B, d in ((256, 256), (4, 2560)):
        q, k = unit((4, B, d)), unit((4, B, d))
        g = torch.randn((4, B), generator=gen, device=dev) / B
        loss, lse = nce.info_nce_fwd(q, k, tau)
        dq = nce.info_nce_bwd(q, k, lse, g, tau, False)
        again = nce.info_nce_fwd(q, k, tau)
        one_loss, one_lse = nce.info_nce_fwd(q[2:3].contiguous(),
                                             k[2:3].contiguous(), tau)
        one_dq = nce.info_nce_bwd(q[2:3].contiguous(), k[2:3].contiguous(),
                                  one_lse, g[2:3].contiguous(), tau, False)
        same = (torch.equal(loss, again[0]) and torch.equal(lse, again[1])
                and torch.equal(dq, nce.info_nce_bwd(q, k, lse, g, tau,
                                                     False)))
        alone = (torch.equal(one_loss[0], loss[2])
                 and torch.equal(one_lse[0], lse[2])
                 and torch.equal(one_dq[0], dq[2]))
        print(f"  info_nce_rows and dq (4, {B}, {d}): two calls bit-identical "
              f"{same}; client 2 at C = 1 bit-identical to C = 4 {alone}",
              flush=True)
        check(same and alone, f"InfoNCE ({B}, {d}) not deterministic or "
              f"depends on C")
    rec = {}
    for C in (1, 4):
        B = d = 256
        nbytes = 4 * (2 * C * B * d + 2 * C * B)
        sets = [(unit((C, B, d)), unit((C, B, d)),
                 torch.randn((C, B), generator=gen, device=dev) / B)
                for _ in range(copies(nbytes))]
        lses = [ref.info_nce_rows_ref(q, k, tau)[1] for q, k, _ in sets]
        labels = torch.arange(B, device=dev).repeat(C)

        def two_calls(q, k):
            logits = torch.matmul(q, k.transpose(-1, -2)) / tau
            return F.cross_entropy(logits.reshape(C * B, B), labels,
                                   reduction="none")

        fwd = dict(
            ms=time_ms([lambda a=a: nce.info_nce_fwd(a[0], a[1], tau)
                        for a in sets]),
            plain_ms=time_ms([lambda a=a: ref.info_nce_rows_ref(
                a[0], a[1], tau) for a in sets]),
            context_ms=time_ms([lambda a=a: two_calls(a[0], a[1])
                                for a in sets]),
            flops=2 * C * B * B * d, nbytes=nbytes)
        print(f"  info_nce_rows ({C}, {B}, {d}): kernel {fwd['ms']} ms, "
              f"plain {fwd['plain_ms']} ms, matmul + cross_entropy "
              f"{fwd['context_ms']} ms", flush=True)
        if C == 1:
            q0, k0, g0 = sets[0]
            fsplit = kernel_split(lambda: nce.info_nce_fwd(q0, k0, tau),
                                  KERNEL_NAMES["info_nce_rows"])
            dsplit = kernel_split(lambda: nce.info_nce_bwd(
                q0, k0, lses[0], g0, tau, False),
                KERNEL_NAMES["info_nce_rows_dq"])
            print(f"  InfoNCE ({C}, {B}, {d}) by kernel, ms a call "
                  f"(profiler, L2-warm): forward {fsplit}, dq {dsplit}",
                  flush=True)
        recs = {"info_nce_rows": fwd}
        for name, wrt_k in (("info_nce_rows_dq", False),
                            ("info_nce_rows_dk", True)):
            recs[name] = dict(
                ms=time_ms([lambda a=a, z=z: nce.info_nce_bwd(
                    a[0], a[1], z, a[2], tau, wrt_k)
                    for a, z in zip(sets, lses)]),
                plain_ms=time_ms([lambda a=a, z=z: ref.info_nce_rows_bwd_ref(
                    a[0], a[1], z, a[2], tau, wrt_k)
                    for a, z in zip(sets, lses)]),
                flops=4 * C * B * B * d,
                nbytes=4 * (3 * C * B * d + 2 * C * B))
            print(f"  {name} ({C}, {B}, {d}): kernel {recs[name]['ms']} ms, "
                  f"plain {recs[name]['plain_ms']} ms", flush=True)
        for name, r in recs.items():
            r["bound_ms"], r["bound_by"] = bound(r["nbytes"], r["flops"])
            if C == 1:
                rec[name] = dict(
                    r, max_abs_err=errs[name], library_ms=None,
                    shape=f"q, k (1, {B}, {d}) fp32 (a MoCo term)"
                    + (f"; matmul + cross_entropy {r['context_ms']} ms "
                       f"(two calls)" if "context_ms" in r else ""))
            else:
                rec[name]["c4"] = {k: r[k] for k in ("ms", "plain_ms",
                                                     "bound_ms")}
    return rec


def ssd_inputs(B, S, H, P, N, gen, dev="cuda"):
    """SSD scan inputs shaped as a Mamba2 block makes them at
    initialisation: x and B, C after the conv's silu, dt = softplus(z - 2)
    (dt_bias -2), A = -1 (a_log 0)."""
    import torch
    import torch.nn.functional as F

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dt = F.softplus(rn(B, S, H) - 2.0)
    return (F.silu(rn(B, S, H, P)), dt, -dt, F.silu(rn(B, S, N)),
            F.silu(rn(B, S, N)))


def ssd_flops(B, S, H, P, N, chunk):
    """Operations the scan needs: C.B^T over the causal half (Q (Q + 1) / 2
    entries) once per (batch, chunk), since Bm and Cm are shared by the
    heads; per (batch, head, chunk) M.x over the causal half, C.h^T and the
    state update."""
    Q = chunk
    return (B * (S // Q) * Q * (Q + 1) * N
            + B * H * (S // Q) * (Q * (Q + 1) * P + 4 * Q * N * P))


def lm_kernel_checks():
    """The kernels at the LM path's shapes against their plain versions,
    with times and bounds: the SSD scan (and a small case with another
    chunk, and the Function's backward), causal attention at head dim 80,
    RMSNorm at d_model and d_inner, InfoNCE at d_model and above 4096.
    Returns ({name: record of the LM path's shape}, printed lines)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import infonce as nce
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(8)
    rec = {}

    def rel(a, b):
        a = a if isinstance(a, (list, tuple)) else [a]
        b = b if isinstance(b, (list, tuple)) else [b]
        return max_err(a, b) / max(max(float(y.abs().max()) for y in b),
                                   1e-30)

    def line(what, err, tol):
        print(f"  {what}: max |kernel - plain| over max |plain| = "
              f"{err:.3e} (tolerance {tol:g})", flush=True)
        check(err <= tol, f"{what}: error {err} above {tol}")

    # the SSD scan: the path's shape, a smaller chunk, and the backward
    B, S, H, P, N, Q = 4, 1024, 80, 64, 64, 256
    sets = [ssd_inputs(B, S, H, P, N, gen) for _ in range(2)]
    err = rel(ops.ssd_scan(*sets[0], chunk=Q),
              ref.ssd_scan_ref(*sets[0], chunk=Q))
    line(f"ssd_scan ({B}, {S}, {H}, {P}) N {N} chunk {Q} fp32", err, 1e-4)
    for shape in ((1, 384, 3, 32, 16, 128), (2, 96, 5, 64, 64, 32),
                  (2, 256, 3, 64, 64, 256), (1, 1024, 2, 64, 64, 1024),
                  (1, 200, 2, 20, 7, 40)):
        args = ssd_inputs(*shape[:5], gen)
        line(f"ssd_scan {shape[:4]} N {shape[4]} chunk {shape[5]}",
             rel(ops.ssd_scan(*args, chunk=shape[5]),
                 ref.ssd_scan_ref(*args, chunk=shape[5])), 1e-4)
    ins = [t.clone().requires_grad_() for t in ssd_inputs(2, 256, 4, 32, 16,
                                                          gen)]
    g = torch.randn((2, 256, 4, 32), generator=gen, device=dev)
    got = torch.autograd.grad((ops.ssd_scan(*ins, chunk=64) * g).sum(), ins)
    want = torch.autograd.grad((ref.ssd_scan_ref(*ins, chunk=64) * g).sum(),
                               ins)
    line("ssd_scan backward (2, 256, 4, 32) N 16 chunk 64",
         max(rel(a, b) for a, b in zip(got, want)), 1e-4)
    same = torch.equal(ops.ssd_scan(*sets[1], chunk=Q),
                       ops.ssd_scan(*sets[1], chunk=Q))
    print(f"  ssd_scan ({B}, {S}, {H}, {P}): two calls bit-identical {same}",
          flush=True)
    check(same, "ssd_scan is not deterministic")
    split = kernel_split(lambda: ops.ssd_scan(*sets[0], chunk=Q),
                         KERNEL_NAMES["ssd_scan"])
    print(f"  ssd_scan ({B}, {S}, {H}, {P}) by kernel, ms a call (profiler, "
          f"L2-warm): {split}", flush=True)
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * H + 2 * B * S * N)
    # fp32-accurate products at the card's fastest: 3xTF32 on the tensor
    # cores, three TF32 products for each
    bms, by = bound(nbytes, 3 * ssd_flops(B, S, H, P, N, Q), TF32_FLOPS)
    rec["ssd_scan"] = dict(
        max_abs_err=max_err(ops.ssd_scan(*sets[0], chunk=Q),
                            ref.ssd_scan_ref(*sets[0], chunk=Q)),
        ms=time_ms([lambda a=a: ops.ssd_scan(*a, chunk=Q) for a in sets]),
        plain_ms=time_ms([lambda a=a: ref.ssd_scan_ref(*a, chunk=Q)
                          for a in sets]),
        library_ms=None, bound_ms=bms, bound_by=by,
        shape=f"xh ({B}, {S}, {H}, {P}), N {N}, chunk {Q}, fp32 "
              f"(one Mamba2 block of the LM path)")

    # causal attention at head dim 80: the shared block's
    B, S, Hh, hd = 4, 1024, 32, 80
    qkvs = [tuple(torch.randn((B, S, Hh, hd), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3)) for _ in range(2)]

    def plain(q, k, v):
        return ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True).transpose(1, 2)

    o = ops.flash_attention(*qkvs[0], causal=True)
    err = max_err(o, plain(*qkvs[0]))
    print(f"  flash_attention ({B}, {S}, {Hh}, {hd}) bf16 causal: max "
          f"|kernel - plain| = {err:.3e} (tolerance 2e-2)", flush=True)
    check(err <= 2e-2, f"flash_attention hd 80: error {err}")
    q32 = [t.float() for t in qkvs[0]]
    line(f"flash_attention ({B}, {S}, {Hh}, {hd}) fp32 causal",
         rel(ops.flash_attention(*q32, causal=True), plain(*q32)), 1e-5)
    bhsd = [tuple(t.transpose(1, 2).contiguous() for t in qkv)
            for qkv in qkvs]
    bms, by = bound(2 * 4 * B * S * Hh * hd,
                    4 * B * Hh * (S * (S + 1) // 2) * hd, BF16_FLOPS)
    rec["flash_attention"] = dict(
        max_abs_err=err,
        ms=time_ms([lambda a=a: ops.flash_attention(*a, causal=True)
                    for a in qkvs]),
        plain_ms=time_ms([lambda a=a: plain(*a) for a in qkvs]),
        library_ms=time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a, is_causal=True) for a in bhsd]),
        bound_ms=bms, bound_by=by,
        shape=f"q, k, v ({B}, {S}, {Hh}, {hd}) bf16, causal")

    # RMSNorm: the residual stream (d_model) and the gated norm (d_inner)
    for d in (2560, 5120):
        R = 4 * 1024
        xs = [torch.randn((R, d), generator=gen, device=dev)
              for _ in range(copies(8 * R * d))]
        sc = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
        line(f"rmsnorm_rows ({R}, {d}) fp32",
             rel(ops.rmsnorm(xs[0], sc), ref.rmsnorm_ref(xs[0], sc)), 1e-5)
        bms, by = bound(4 * (2 * R * d + d), 4 * R * d)
        rec[f"rmsnorm_rows_{d}"] = dict(
            max_abs_err=max_err(ops.rmsnorm(xs[0], sc),
                                ref.rmsnorm_ref(xs[0], sc)),
            ms=time_ms([lambda a=a: ops.rmsnorm(a, sc) for a in xs]),
            plain_ms=time_ms([lambda a=a: ref.rmsnorm_ref(a, sc)
                              for a in xs]),
            library_ms=time_ms([lambda a=a: F.rms_norm(a, (d,), sc, 1e-5)
                                for a in xs]),
            bound_ms=bms, bound_by=by, shape=f"x ({R}, {d}) fp32")

    # InfoNCE: the alignment term's mean-pooled hidden states, and wider
    tau = 0.2
    for C, Bn, d in ((1, 4, 2560), (1, 4, 5000), (2, 40, 4100)):
        q = F.normalize(torch.randn((C, Bn, d), generator=gen, device=dev),
                        dim=-1)
        k = F.normalize(torch.randn((C, Bn, d), generator=gen, device=dev),
                        dim=-1)
        gg = torch.randn((C, Bn), generator=gen, device=dev) / Bn
        loss, lse = nce.info_nce_fwd(q, k, tau)
        wl, wlse = ref.info_nce_rows_ref(q, k, tau)
        errs = {"info_nce_rows": rel([loss, lse], [wl, wlse])}
        for name, wrt_k in (("info_nce_rows_dq", False),
                            ("info_nce_rows_dk", True)):
            errs[name] = rel(nce.info_nce_bwd(q, k, wlse, gg, tau, wrt_k),
                             ref.info_nce_rows_bwd_ref(q, k, wlse, gg, tau,
                                                       wrt_k))
        for name, e in errs.items():
            line(f"{name} ({C}, {Bn}, {d})", e, 1e-5)
        if d != 2560:
            continue
        nb = 4 * (2 * C * Bn * d + 2 * C * Bn)
        bms, by = bound(nb, 2 * C * Bn * Bn * d)
        labels = torch.arange(Bn, device=dev)
        two = time_ms([lambda: F.cross_entropy(
            torch.matmul(q[0], k[0].transpose(0, 1)) / tau, labels,
            reduction="none")])
        rec["info_nce_rows"] = dict(
            max_abs_err=max_err([loss, lse], [wl, wlse]),
            ms=time_ms([lambda: nce.info_nce_fwd(q, k, tau)]),
            plain_ms=time_ms([lambda: ref.info_nce_rows_ref(q, k, tau)]),
            library_ms=None, bound_ms=bms, bound_by=by, context_ms=two,
            shape=f"q, k ({C}, {Bn}, {d}) fp32 (the alignment term); "
                  f"matmul + cross_entropy {two} ms (two calls)")
        for name, wrt_k in (("info_nce_rows_dq", False),
                            ("info_nce_rows_dk", True)):
            bms, by = bound(4 * (3 * C * Bn * d + 2 * C * Bn),
                            4 * C * Bn * Bn * d)
            rec[name] = dict(
                max_abs_err=max_err(
                    nce.info_nce_bwd(q, k, wlse, gg, tau, wrt_k),
                    ref.info_nce_rows_bwd_ref(q, k, wlse, gg, tau, wrt_k)),
                ms=time_ms([lambda w=wrt_k: nce.info_nce_bwd(
                    q, k, wlse, gg, tau, w)]),
                plain_ms=time_ms([lambda w=wrt_k: ref.info_nce_rows_bwd_ref(
                    q, k, wlse, gg, tau, w)]),
                library_ms=None, bound_ms=bms, bound_by=by,
                shape=f"q, k ({C}, {Bn}, {d}) fp32")
    for name, r in rec.items():
        print(f"  LM shapes, {name} [{r['shape']}]: kernel {r['ms']} ms, "
              f"plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']})", flush=True)
    return rec


# ---------------------------------------------------------------------------
# phase 5 (with --profile): where a local step's device time goes
# ---------------------------------------------------------------------------
KERNEL_NAMES = {"gather_pack": ("gather_pack_kernel",),
                "scatter_unpack": ("scatter_unpack_kernel",),
                "rmsnorm_rows": ("rmsnorm_rows_kernel",),
                "flash_attention": ("flash_fwd_kernel",
                                    "flash_fwd_bf16_kernel"),
                "int8_quant_matrix": ("int8_absmax_kernel",
                                      "int8_quant_kernel"),
                "int8_dequant_matrix": ("int8_dequant_kernel",),
                "compensate": ("compensate_kernel",),
                "topk_ef_update": ("ef_update_kernel",),
                "info_nce_rows": ("info_nce_logits_kernel<0>",
                                  "info_nce_rows_kernel"),
                "info_nce_rows_dq": ("info_nce_logits_kernel<1>",
                                     "info_nce_grad_kernel<false>"),
                "info_nce_rows_dk": ("info_nce_logits_kernel<2>",
                                     "info_nce_grad_kernel<true>"),
                "ssd_scan": ("ssd_chunk_cb_kernel", "ssd_chunk_state_kernel",
                             "ssd_state_pass_kernel",
                             "ssd_chunk_scan_kernel")}


def profile_step(model_cfg, ssl_cfg, state, images, clients=1, steps=3):
    """``steps`` local steps of the last LW-FedSSL stage (block 12 trained
    on top of 11 frozen ones, with alignment) at batch 256, of one client
    (``train_step``, the sequential engine's) or of ``clients`` clients at
    once (``stacked_train_step``, the vmap engine's): their wall time, then
    under torch.profiler their device time by kernel, and the device's
    busy share of the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import subtree
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data.augment import draw_params, two_views
    from repro_torch.federated.client import stacked_train_step, train_step
    from repro_torch.optim import make_optimizer

    enc = ssl_mod.make_vit_encoder(model_cfg)
    opt = make_optimizer(TrainConfig(batch_size=256))
    gen = torch.Generator("cuda").manual_seed(5)
    n = 256 * clients
    batch = images[:n]
    L = model_cfg.num_layers
    genc = subtree(state["online"], "enc")
    kw = dict(encoder=enc, ssl_cfg=ssl_cfg, opt=opt, sub_layers=L,
              active_from=L - 1, global_enc=genc,
              align_weight=ssl_cfg.align_weight)

    def step():
        on = state["online"]
        x1, x2 = two_views(batch, draw_params(gen, n, 32, 32),
                           draw_params(gen, n, 32, 32))
        if clients == 1:
            st = {"online": on, "target": {k: on[k] for k in state["target"]}}
            train_step(st, opt.init(on), x1, x2, 1e-4, **kw)
            return
        on = {k: v.expand(clients, *v.shape) for k, v in on.items()}
        st = {"online": on, "target": {k: on[k] for k in state["target"]}}
        stacked_train_step(st, opt.init(on), x1.unflatten(0, (clients, -1)),
                           x2.unflatten(0, (clients, -1)), 1e-4, **kw)

    profile_device(step, f"one local step of {clients} client(s)", steps)


def profile_lm_step(steps=2, seed=5):
    """``steps`` local steps of the LM path at stage 2 (group 2 trained on
    the frozen group 1, alignment on) on one client's batch of 4 x 1024
    tokens, from fresh parameters: wall time and device time by kernel, as
    ``profile_step``."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.federated.client import lm_train_step
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    cfg = lm_config()
    gen = torch.Generator("cuda").manual_seed(seed)
    params = lm.init_lm(cfg, gen, "cuda")
    toks, labs = synthetic_tokens(gen, 4, 1024, cfg.vocab_size)
    opt = make_optimizer(TrainConfig(batch_size=4, base_lr=3e-4))

    def step():
        lm_train_step(params, opt.init(params),
                      {"tokens": toks, "labels": labs}, 1e-5, cfg=cfg,
                      opt=opt, sub_layers=2, active_from=1,
                      global_params=params, align_weight=0.01)

    profile_device(step, "one LM local step at stage 2 (4 x 1024 tokens)",
                   steps)
    lm_step_split(cfg, params, opt, {"tokens": toks, "labels": labs})


def lm_step_split(cfg, params, opt, batch, reps=3):
    """The LM local step of ``profile_lm_step`` cut by source, each part
    timed alone with CUDA events on the same stage-2 batch (the median of
    ``reps`` after one warm-up): the ``lm_ssl_loss`` forward under no_grad,
    the forward and backward (``autograd.grad``, as ``lm_train_step``), the
    optimizer's init and update, the whole step; then the time of the
    ``SSDScanFn.backward`` calls inside one forward and backward, and one
    such call alone at the LM shape (the plain version's vjp)."""
    import types

    import torch
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.federated.client import lm_train_step
    from repro_torch.federated.masks import stage_update_mask
    from repro_torch.kernels import ops

    kw = dict(sub_layers=2, active_from=1, global_params=params,
              align_weight=0.01)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return sorted(out)[reps // 2]

    def forward():
        with torch.no_grad():
            ssl_mod.lm_ssl_loss(params, batch, cfg, **kw)

    def grads():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = ssl_mod.lm_ssl_loss(p, batch, cfg, **kw)
        gs = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        return {k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(params.items(), gs)}

    g = grads()
    mask = stage_update_mask(params, 2, 1)
    state = opt.init(params)
    before = ops.launch_counts()["ssd_scan"]
    forward()
    scans = ops.launch_counts()["ssd_scan"] - before
    # the scans whose backward the step runs: the trained group's (the
    # frozen prefix and the global model run under no_grad)
    # (``seen`` holds the visited nodes, so that their Python wrappers, and
    # with them their ids, stay unique while the graph is walked)
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    seen, todo, bwd_calls = {}, [ssl_mod.lm_ssl_loss(p, batch, cfg,
                                                     **kw)[0].grad_fn], 0
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        bwd_calls += "SSDScanFn" in type(node).__name__
        todo.extend(f for f, _ in node.next_functions)
    del p, seen, todo
    parts = {
        "forward (no_grad)": timed(forward),
        "forward + backward": timed(grads),
        "optimizer init": timed(lambda: opt.init(params)),
        "optimizer update": timed(lambda: opt.update(g, state, params, 1e-5,
                                                     mask)),
        "whole step": timed(lambda: lm_train_step(
            params, opt.init(params), batch, 1e-5, cfg=cfg, opt=opt, **kw)),
    }
    del g, state
    # the scan's backward inside forward + backward: CUDA events around each
    # call, by wrapping the Function's backward for one more run
    plain_backward, marks = ops.SSDScanFn.backward, []

    def marked_backward(ctx, gy):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain_backward(ctx, gy)
        end.record()
        marks.append((start, end))
        return out

    ops.SSDScanFn.backward = staticmethod(marked_backward)
    try:
        grads()
        torch.cuda.synchronize()
    finally:
        ops.SSDScanFn.backward = staticmethod(plain_backward)
    in_step = sum(s.elapsed_time(e) for s, e in marks)
    parts[f"SSDScanFn.backward in forward + backward ({len(marks)} "
          f"calls)"] = in_step
    gen = torch.Generator("cuda").manual_seed(9)
    ins = ssd_inputs(4, 1024, 80, 64, 64, gen)
    ctx = types.SimpleNamespace(saved_tensors=ins, chunk=256)
    gy = torch.randn((4, 1024, 80, 64), generator=gen, device="cuda")
    bwd = timed(lambda: ops.SSDScanFn.backward(ctx, gy))
    print(f"  LM step split by source (CUDA events, median of {reps}):")
    for name, ms in parts.items():
        print(f"    {name}: {ms:.3f} ms")
    print(f"    SSDScanFn.backward alone: {bwd:.3f} ms a call at (4, 1024, "
          f"80, 64), N 64, chunk 256; a step runs {scans} ssd_scan "
          f"forwards and {bwd_calls} backwards", flush=True)
    check(len(marks) == bwd_calls, f"{len(marks)} SSD backwards ran, the "
          f"graph holds {bwd_calls}")


def profile_device(step, what, steps):
    """Wall time of ``steps`` calls of ``step`` after two warm-up calls,
    then their device time by kernel under torch.profiler, and the device's
    busy share of the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    # the wall time without the profiler, whose host-side recording slows
    # the host by far more than the device
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((device_us(e) / 1e3 / steps, e.count // steps,
                         e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"  {what}: {wall_ms:.2f} ms wall (unprofiled), "
          f"{busy:.2f} ms of device time ({100 * busy / wall_ms:.1f}% "
          f"busy)")
    for name, knames in KERNEL_NAMES.items():
        mine = [r for r in rows if any(kn in r[2] for kn in knames)]
        ms = sum(r[0] for r in mine)
        n = sum(r[1] for r in mine)
        print(f"  {name}: {ms:.3f} ms in {n} launches "
              f"({100 * ms / max(busy, 1e-9):.1f}% of device time)")
    for ms, n, key in rows[:15]:
        print(f"    {ms:8.3f} ms {n:5d}x {key[:90]}")
    check(busy > 0, "the profiler saw no device time")


def run(profile: bool = False) -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this script "
                           "needs an NVIDIA GPU")
    import_port()
    from repro_torch.configs.base import SSLConfig, load_arch
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    print("[1] build", flush=True)
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"  built {', '.join(build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f}s "
          f"(per source: {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())})",
          flush=True)
    for name in build.SOURCES:
        log = build.library_path(name).with_suffix(".log")
        regs = [ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln]
        print(f"  ptxas {name}: {' | '.join(regs)}", flush=True)

    print("[2] main path: LW-FedSSL, full-width ViT-Tiny, 4 clients, "
          "12 rounds, batch 256, 4096 images; then linear eval", flush=True)
    model_cfg, ssl_cfg = load_arch("vit-tiny"), SSLConfig()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, hist, acc, secs, images = main_path("cuda", model_cfg=model_cfg,
                                               ssl_cfg=ssl_cfg)
    torch.cuda.synchronize()
    launches = {"fp32": ops.launch_counts()}
    check_history(hist, state["online"])
    check(0.0 <= acc <= 1.0, f"accuracy {acc}")
    print(f"  seconds per round: {[round(s, 3) for s in secs]}")
    print(f"  wire bytes equal analytic bytes in all {len(hist.loss)} "
          f"rounds: {sum(hist.wire_download_bytes)} down, "
          f"{sum(hist.wire_upload_bytes)} up per client")
    print(f"  linear eval accuracy {acc:.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  kernel launches on the main path: {launches['fp32']}",
          flush=True)

    print("[2b] codec paths: the same run on the int8 wire (12 rounds) and "
          "the top-k wire (fraction 0.1, rounds per stage "
          f"{TOPK_ROUNDS_PER_STAGE}); no linear eval", flush=True)
    untraced = {}
    for codec, kw in (("int8", {}),
                      ("topk", {"rounds": sum(TOPK_ROUNDS_PER_STAGE),
                                "rounds_per_stage": TOPK_ROUNDS_PER_STAGE})):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        cstate, chist, _, csecs, _ = main_path(
            "cuda", model_cfg=model_cfg, ssl_cfg=ssl_cfg, eval_epochs=0,
            codec=codec, **kw)
        torch.cuda.synchronize()
        launches[codec] = ops.launch_counts()
        untraced[codec] = (chist, csecs)
        check_history(chist, cstate["online"], codec, **kw)
        print(f"  {codec}: seconds per round "
              f"{[round(x, 3) for x in csecs]}")
        print(f"  {codec}: wire bytes equal the codec's count in all "
              f"{len(chist.loss)} rounds: {sum(chist.wire_download_bytes)} "
              f"down, {sum(chist.wire_upload_bytes)} up per client; "
              f"compression ratio {chist.compression_ratio:.4f}; losses "
              f"{chist.loss[0]:.4f} -> {chist.loss[-1]:.4f}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"  {codec}: kernel launches {launches[codec]}", flush=True)

    print("[2c] vmap path: phase 2's run on the vectorised engine (12 "
          "rounds, fp32 wire, no linear eval)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    vstate, vhist, _, vsecs, _ = main_path(
        "cuda", model_cfg=model_cfg, ssl_cfg=ssl_cfg, eval_epochs=0,
        engine="vmap")
    torch.cuda.synchronize()
    launches["vmap"] = ops.launch_counts()
    check_history(vhist, vstate["online"])
    print(f"  vmap: seconds per round {[round(x, 3) for x in vsecs]} "
          f"(sequential: {[round(x, 3) for x in secs]})")
    print(f"  vmap: wire bytes equal analytic bytes in all "
          f"{len(vhist.loss)} rounds; losses {vhist.loss[0]:.4f} -> "
          f"{vhist.loss[-1]:.4f} (sequential {hist.loss[0]:.4f} -> "
          f"{hist.loss[-1]:.4f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  vmap: kernel launches {launches['vmap']}", flush=True)
    seq_loss, vm_loss, perr, lock, gerr, gl2 = engine_comparison(model_cfg,
                                                                 ssl_cfg)
    first = abs(seq_loss[0] - vm_loss[0])
    print(f"  engines from one seed, fp32 compute, 2 blocks, 2 rounds of "
          f"one local step: sequential losses {seq_loss}, vmap {vm_loss}; "
          f"round 1 difference {first:.3e} (tolerance 1e-4), round 2 "
          f"{abs(seq_loss[1] - vm_loss[1]):.3e} and parameters "
          f"{perr:.3e} after a round of training (not checked); "
          f"lockstep steps from the same state: largest per-client loss "
          f"difference {lock:.3e} (tolerance 1e-4); gradients: largest "
          f"difference over the largest gradient {gerr:.3e}, relative L2 "
          f"{gl2:.3e} (not checked)", flush=True)
    check(first <= 1e-4 and lock <= 1e-4,
          f"engines disagree: {seq_loss} vs {vm_loss}, lockstep {lock}")

    print(f"[2d] LM path: LW-FedSSL on {LM_ARCH} at full width, "
          f"{LM_GROUPS} stage groups, {LM_RUN['clients']} clients, "
          f"{LM_RUN['rounds']} rounds, batch {LM_RUN['batch']} x "
          f"{LM_RUN['seq_len']} tokens, {LM_RUN['samples']} sequences, fp32 "
          f"wire", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    lcfg, lparams, lhist, lsecs, lplans, lsteps, ltoks = lm_path(
        "cuda", **LM_RUN)
    torch.cuda.synchronize()
    launches["lm"] = ops.launch_counts()
    check(len(lhist.loss) == LM_RUN["rounds"]
          and lhist.round_stage == [p.stage for p in lplans],
          f"LM rounds {lhist.round_stage}")
    check(all(math.isfinite(x) for x in lhist.loss),
          f"non-finite LM loss: {lhist.loss}")
    check(lhist.wire_download_bytes == lhist.download_bytes
          and lhist.wire_upload_bytes == lhist.upload_bytes,
          f"LM wire bytes {lhist.wire_download_bytes} / "
          f"{lhist.wire_upload_bytes} differ from the analytic "
          f"{lhist.download_bytes} / {lhist.upload_bytes}")
    want_scans, want_attn = lm_expected_launches(lcfg, lplans, lsteps)
    print(f"  LM: seconds per round {[round(x, 3) for x in lsecs]}; losses "
          f"{[round(x, 4) for x in lhist.loss]}; wire bytes equal analytic "
          f"bytes in all {len(lhist.loss)} rounds: download "
          f"{lhist.wire_download_bytes}, upload {lhist.wire_upload_bytes} "
          f"per client; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  LM: kernel launches {launches['lm']}; ssd_scan "
          f"{launches['lm']['ssd_scan']} (the plan implies {want_scans}), "
          f"flash_attention {launches['lm']['flash_attention']} (the plan "
          f"implies {want_attn})", flush=True)
    check(launches["lm"]["ssd_scan"] == want_scans,
          f"ssd_scan launched {launches['lm']['ssd_scan']} times, the plan "
          f"implies {want_scans}")
    check(launches["lm"]["flash_attention"] == want_attn,
          f"flash_attention launched {launches['lm']['flash_attention']} "
          f"times, the plan implies {want_attn}")
    check(launches["lm"]["info_nce_rows_dk"] == 0,
          "info_nce_rows_dk launched on the LM path (its k is detached)")
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(launches[path][name] > 0,
                  f"{name} never launched on the {path} path")
    print("  LM payloads: gather_pack and scatter_unpack against their "
          "plain versions on every layout of the plan", flush=True)
    lm_pack_rec = lm_pack_checks(lparams, lplans)

    print("[2e] observability: phase 2b's int8 run traced (spans, metrics, "
          "health), then the launcher with every observability flag",
          flush=True)
    t2e = time.perf_counter()
    torch.cuda.empty_cache()
    traced_codec_run(model_cfg, ssl_cfg, untraced["int8"], launches["int8"])
    obs_cli_run()
    print(f"  phase 2e took {time.perf_counter() - t2e:.1f}s", flush=True)

    print("[3] full-width SSL loss on 8 images, fp32: card kernels against "
          "CPU plain versions", flush=True)
    rel, zerr = reference_check(model_cfg, ssl_cfg, state, images)
    print(f"  loss relative difference {rel:.3e} (tolerance 1e-4); CLS max "
          f"difference {zerr:.3e} (tolerance 1e-3)", flush=True)
    check(rel <= 1e-4 and zerr <= 1e-3, "card and CPU disagree")
    print(f"[3b] {LM_ARCH} lm_ssl_loss with alignment, full width, stage "
          f"group 1, 2 x 512 tokens (two SSD chunks, so the carried state "
          f"runs), fp32: card kernels against CPU plain versions",
          flush=True)
    rels = lm_reference_check(lparams, ltoks)
    print(f"  relative differences {rels} (tolerance 1e-4)", flush=True)
    check(all(v <= 1e-4 for v in rels.values()), "LM: card and CPU disagree")
    del lparams
    torch.cuda.empty_cache()

    print("[4] kernels against their plain versions, and times", flush=True)
    rec = kernel_checks(state)
    rec.update(codec_kernel_checks(state))
    rec.update(infonce_kernel_checks())
    lm_rec = lm_kernel_checks()
    lm_rec.update(lm_pack_rec)
    rec["ssd_scan"] = lm_rec["ssd_scan"]
    at_lm = {"gather_pack": ["gather_pack_lm"],
             "scatter_unpack": ["scatter_unpack_lm"],
             "flash_attention": ["flash_attention"],
             "rmsnorm_rows": ["rmsnorm_rows_2560", "rmsnorm_rows_5120"],
             "info_nce_rows": ["info_nce_rows"],
             "info_nce_rows_dq": ["info_nce_rows_dq"],
             "info_nce_rows_dk": ["info_nce_rows_dk"]}
    kernels = []
    path_of = {}
    for p, names in PATH_KERNELS.items():
        for n in names:
            path_of.setdefault(n, p)
    for name in ops.KERNELS:
        r = rec[name]
        print(f"  {name} [{r['shape']}]: kernel {r['ms']} ms, plain "
              f"{r['plain_ms']} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']} ms ({r['bound_by']})", flush=True)
        source, replaces = TPU_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[path_of[name]][name] if name in path_of
            else 0, "path": path_of.get(name),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"at_c4": r["c4"]} if "c4" in r else {}),
            **({"at_lm": [{k: lm_rec[n][k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")} for n in at_lm[name]]}
               if name in at_lm else {})})
    if profile:
        print("[5] profile of one local step at stage 12: one client "
              "(sequential engine), then four at once (vmap engine); then "
              "one LM local step at stage 2", flush=True)
        profile_step(model_cfg, ssl_cfg, state, images)
        profile_step(model_cfg, ssl_cfg, state, images, clients=4)
        profile_lm_step()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run(profile="--profile" in sys.argv[1:])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
    except Exception:  # any phase's fault fails the run, with its traceback
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
