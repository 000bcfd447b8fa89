"""Federated SSL training launcher of the port (``repro.launch.train``).

Two modes:
  vit   the paper's experiment: a reduced ViT with MoCo v3 federated SSL
        on synthetic images under any of the five schedules, then a linear
        probe.
  lm    LM-family FedSSL: each client runs next-token SSL plus
        representation alignment on synthetic token shards, on the
        reference's ``reduced()`` arch: the dense decoders
        (``--arch internlm2-1.8b``, the default, internlm2-20b,
        starcoder2-15b, mistral-large-123b, internvl2-1b) and deepseek-v2
        (MLA + MoE) with 2 stages, llama4-maverick (one dense and one MoE
        block) with 1, and zamba2-2.7b and xlstm-125m on the reductions of
        the reference's arch smoke test (``num_layers=4, attn_every=2`` and
        ``num_layers=4, slstm_every=2``: ``reduced()`` alone leaves them
        no stage). ``--arch zamba2-7b`` (the port's own: Zamba2's published
        layout, which the JAX package lacks) runs at ``reduced()`` widths
        with 6 layers in 3 stages of 2, hybrid layers 2, 3 and 5 (shared
        blocks A, B, A, as the benchmark's stage-3 cell has them), heads of
        2 d / heads over the joined input, on the sequential engine. seamless-m4t-medium is refused: the reference's
        launcher trains it as a decoder-only dense LM on the sequential
        engine and fails on the vmap engine; the encoder-decoder trains
        through ``launch.steps``.

It runs on the card (``--device cuda``, the default) and raises without
one; ``--device cpu`` runs the plain PyTorch versions of the kernels.
``--engine`` picks the round engine (``sequential``, or ``vmap``: the
round's participants train together, one batched step at a time; both
modes). The SSL method and the optimizer are the reference launcher's
(MoCo v3, AdamW), which has no flag for them; ``run_fedssl`` and
``run_lm_fedssl`` take any of ``SSLConfig.method`` and
``TrainConfig.optimizer``.
``--codec`` picks the wire compression (fp32, fp16, bf16, int8,
topk[:fraction]); ``--transport-kernels xla|pallas`` is accepted so that
the reference's command lines parse, and both select the port's one wire
path. ``--trace``, ``--metrics``, ``--health``, ``--halt-on-unhealthy``
and ``--profile-dir`` record the run as the reference does and write the
artifacts under ``--obs-dir`` (``run_trace.jsonl``,
``run_trace.chrome.json``, ``run_metrics.csv``, ``run_history.json``,
``health.json``; the profiler's ``torch_profile.json`` under
``--profile-dir``); ``--live`` rewrites one progress line in place;
``--measure-resources`` (vit) counts the FLOPs of each stage's first
local step onto its round span (``res.*``). ``--fleet`` and
``--round-policy`` (vit) simulate a heterogeneous device fleet and its
round policy (``--deadline-s``, ``--overcommit``, ``--async-buffer``,
``--staleness-alpha``), and the summary adds the simulated wall clock,
device-seconds, energy and dropped client-rounds. ``--dp-clip``,
``--dp-noise-multiplier``, ``--dp-delta``, ``--dp-epsilon-budget`` and
``--secure-agg`` (both modes) turn on client-level DP-FedAvg and
pairwise-mask secure aggregation (``repro_torch.privacy``), and the
summary adds the reference's ``privacy: eps ...`` line.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit \\
      --schedule lw_fedssl --rounds 12 --clients 4 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit --engine vmap
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit --codec int8
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit \\
      --codec topk:0.1 --transport-kernels pallas
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --device cpu --rounds 4 --batch 8 --samples 64 --seq-len 32 \\
      --engine vmap
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch zamba2-2.7b --device cpu --rounds 4 --batch 8 --samples 64 \\
      --seq-len 64
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch xlstm-125m --device cpu --rounds 4 --batch 4 --samples 16 \\
      --seq-len 32 --engine vmap
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch deepseek-v2-236b --device cpu --rounds 4 --clients 2 \\
      --batch 4 --samples 16 --seq-len 32
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit --trace \\
      --metrics --health --obs-dir results/obs
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit \\
      --fleet pareto-stragglers --round-policy deadline --codec int8
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit \\
      --dp-clip 1.0 --dp-noise-multiplier 1.1 --dp-delta 1e-5 --secure-agg
"""
from __future__ import annotations

import argparse
import pathlib
import time

import torch

from repro_torch.configs.base import (FLConfig, SSLConfig, TrainConfig,
                                      XLSTMConfig, load_arch, reduced)
from repro_torch.convert import subtree
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as ssl_mod
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import synthetic_images, synthetic_tokens
from repro_torch.federated import eval as fl_eval
from repro_torch.federated import fleet as fleet_mod
from repro_torch.federated import simulation as sim_mod
from repro_torch.federated.driver import (TRANSPORT_KERNELS, resolve_device,
                                          run_fedssl, run_lm_fedssl)
from repro_torch.federated.engine import ENGINES
from repro_torch.federated.transport import make_codec
from repro_torch.models import lm as lm_mod
from repro_torch.obs import ConsoleRenderer, make_obs, write_history_json
from repro_torch.privacy import PrivacyConfig, make_privacy


def privacy_from_args(args):
    """PrivacyConfig from --dp-*/--secure-agg; None with everything off."""
    if (args.dp_clip == 0.0 and args.dp_noise_multiplier == 0.0
            and not args.secure_agg):
        return None
    return PrivacyConfig(
        clip=args.dp_clip, noise_multiplier=args.dp_noise_multiplier,
        delta=args.dp_delta, epsilon_budget=args.dp_epsilon_budget,
        secure_agg=args.secure_agg)


def obs_from_args(args, mode):
    """Observability bundle from --trace/--metrics/--profile-dir plus the
    health monitor (--health/--halt-on-unhealthy)."""
    return make_obs(trace=args.trace, metrics=args.metrics,
                    profile_dir=args.profile_dir or None,
                    health=args.health,
                    halt_on_unhealthy=args.halt_on_unhealthy,
                    measure_resources=args.measure_resources,
                    mode=mode, schedule=args.schedule, engine=args.engine,
                    codec=args.codec, seed=args.seed)


def export_obs(obs, args, hist=None):
    """Write the enabled artifacts under --obs-dir and report the paths."""
    if not obs.enabled:
        return {}
    out = pathlib.Path(args.obs_dir)
    written = obs.export(
        trace_jsonl=out / "run_trace.jsonl" if args.trace else None,
        chrome_trace=out / "run_trace.chrome.json" if args.trace else None,
        metrics_csv=out / "run_metrics.csv" if args.metrics else None,
        health_json=(out / "health.json" if obs.health is not None
                     else None),
        schedule=args.schedule, engine=args.engine, codec=args.codec)
    if args.metrics and hist is not None:
        written["history_json"] = write_history_json(
            hist, out / "run_history.json", schedule=args.schedule,
            engine=args.engine, codec=args.codec)
    for kind, path in sorted(written.items()):
        print(f"obs: wrote {kind} -> {path}")
    return written


def train_vit(args):
    device = resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    cfg = reduced(load_arch("vit-tiny"), num_layers=args.layers,
                  d_model=args.d_model, num_heads=4, num_kv_heads=4,
                  d_ff=2 * args.d_model)
    ssl_cfg = SSLConfig(proj_hidden=256, pred_hidden=256, proj_dim=64)
    fl = FLConfig(num_clients=args.clients, rounds=args.rounds,
                  local_epochs=args.local_epochs, schedule=args.schedule,
                  server_epochs=1, depth_dropout=args.depth_dropout,
                  clients_per_round=args.clients_per_round, seed=args.seed)
    tc = TrainConfig(batch_size=args.batch, base_lr=1.5e-4)
    images, labels = synthetic_images(gen, args.samples, 10, 32)
    if args.dirichlet_beta > 0:
        idx = dirichlet_partition(labels.cpu().numpy(), fl.num_clients,
                                  args.dirichlet_beta, seed=args.seed)
    else:
        idx = iid_partition(args.samples, fl.num_clients, seed=args.seed)
    aux = images[:max(args.batch, args.samples // 10)]
    sim = make_sim_from_args(args, fl.num_clients)
    obs = obs_from_args(args, "vit")
    t0 = time.time()
    with ConsoleRenderer(live=args.live) as log:
        state, hist = run_fedssl(cfg, ssl_cfg, fl, tc, images=images,
                                 client_indices=idx, aux_images=aux,
                                 log=log, device=device, engine=args.engine,
                                 codec=args.codec,
                                 transport_kernels=args.transport_kernels,
                                 sim=sim, obs=obs,
                                 privacy=privacy_from_args(args))
    export_obs(obs, args, hist=hist)
    print(f"training done in {time.time() - t0:.1f}s; "
          f"total comm {hist.total_comm / 1e6:.2f} MB analytic, "
          f"{hist.total_wire / 1e6:.2f} MB on the wire "
          f"({args.codec}: {hist.compression_ratio:.2f}x)")
    if hist.epsilon:
        print(f"privacy: eps {hist.epsilon[-1]:.4g} at delta "
              f"{args.dp_delta:g} after {len(hist.epsilon)} rounds; "
              f"mean clip fraction "
              f"{sum(hist.clip_fraction) / len(hist.clip_fraction):.2f}; "
              f"secure-agg overhead "
              f"{sum(hist.secure_agg_overhead_bytes) / 1e6:.2f} MB/client")
    if sim is not None:
        print(f"simulated fleet '{args.fleet}' / policy "
              f"'{args.round_policy}': {hist.total_wall_clock:.1f}s "
              f"wall-clock, {hist.total_device_seconds:.1f} device-s, "
              f"{hist.total_energy:.1f}J, "
              f"{hist.total_dropped} dropped client-rounds")
    enc = ssl_mod.make_vit_encoder(cfg)
    n_eval = min(args.samples // 2, 512)
    acc = fl_eval.linear_eval(
        enc, subtree(state["online"], "enc"), images[:n_eval],
        labels[:n_eval], images[n_eval:2 * n_eval],
        labels[n_eval:2 * n_eval], num_classes=10, epochs=5, batch_size=64)
    print(f"linear evaluation accuracy: {acc * 100:.2f}%")
    return acc


# --mode lm: the archs, each with what it adds on top of reduced(): zamba2
# and xlstm the overrides of the reference's arch smoke test
# (tests/test_arch_smoke.py), the dense decoders and deepseek-v2 nothing (2
# stages), llama4 nothing (1 stage: 2 blocks in one group of moe_every = 2)
LM_ARCHS = {"zamba2-2.7b": dict(num_layers=4, attn_every=2),
            "xlstm-125m": dict(num_layers=4, xlstm=XLSTMConfig(
                slstm_every=2, proj_factor=2.0)),
            "internlm2-1.8b": {}, "internlm2-20b": {}, "starcoder2-15b": {},
            "mistral-large-123b": {}, "internvl2-1b": {},
            "llama4-maverick-400b-a17b": {}, "deepseek-v2-236b": {}}
# the port's own LM archs (no counterpart in the JAX package), on the
# sequential engine only: zamba2-7b at reduced() widths (d 256, 4 heads),
# the shared block's heads spanning the 2 d joined input, no GQA
PORT_LM_ARCHS = {"zamba2-7b": dict(num_layers=6, stage_layers=2,
                                   hybrid_layer_ids=(2, 3, 5),
                                   num_kv_heads=4, head_dim=128,
                                   adapter_rank=8)}
# the encoder-decoder, which this launcher does not run
ENCDEC_REFUSAL = (
    "the reference's launcher trains this arch as a decoder-only dense LM "
    "on the sequential engine (its family is audio, so lm.topology sees a "
    "uniform dense stack) and fails on the vmap engine (KeyError: "
    "'frontend'); the encoder-decoder trains through "
    "repro_torch.launch.steps (make_train_step, make_fl_round_program)")


def train_lm(args):
    """LM-family layer-wise FedSSL on synthetic token shards (the
    reference's ``train_lm``); returns (params, history)."""
    device = resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    cfg = reduced(load_arch(args.arch),
                  **{**LM_ARCHS, **PORT_LM_ARCHS}[args.arch])
    fl = FLConfig(num_clients=args.clients, rounds=args.rounds,
                  local_epochs=args.local_epochs, schedule=args.schedule,
                  seed=args.seed)
    tc = TrainConfig(batch_size=args.batch, base_lr=3e-4)
    toks, labs = synthetic_tokens(gen, args.samples, args.seq_len,
                                  cfg.vocab_size)
    shards = iid_partition(args.samples, fl.num_clients, seed=args.seed)
    params = lm_mod.init_lm(cfg, gen, device)
    obs = obs_from_args(args, "lm")
    prv = make_privacy(privacy_from_args(args))
    with ConsoleRenderer(live=args.live) as log:
        params, hist = run_lm_fedssl(
            cfg, fl, tc, tokens=toks, labels=labs, shards=shards,
            params=params, device=device, codec=args.codec,
            transport_kernels=args.transport_kernels, log=log, obs=obs,
            privacy=prv, engine=args.engine)
    export_obs(obs, args)
    print(f"final loss {hist.loss[-1]:.4f} (start {hist.loss[0]:.4f}); "
          f"{hist.total_wire / 1e6:.2f} MB/client on the wire "
          f"({args.codec}: {hist.compression_ratio:.2f}x)")
    if prv is not None and prv.dp:
        print(f"privacy: eps {hist.epsilon[-1]:.4g} at delta "
              f"{prv.cfg.delta:g} after {len(hist.loss)} rounds")
    return params, hist


def make_sim_from_args(args, num_clients):
    """The fleet simulator of the CLI flags; None when --fleet is unset."""
    if not args.fleet:
        if args.round_policy != "synchronous":
            raise SystemExit(
                "--round-policy needs --fleet (one of "
                + ", ".join(fleet_mod.PROFILES) + ")")
        return None
    kw = {}
    if args.round_policy == "deadline":
        kw = {"overcommit": args.overcommit}
        if args.deadline_s > 0:
            kw["deadline_s"] = args.deadline_s
    elif args.round_policy == "buffered-async":
        kw = {"buffer": args.async_buffer, "alpha": args.staleness_alpha}
    return sim_mod.make_sim(args.fleet, args.round_policy,
                            num_clients=num_clients, seed=args.seed, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="vit", choices=("vit", "lm"))
    ap.add_argument("--arch", default="internlm2-1.8b",
                    help="--mode lm: the LM architecture, at reduced(); "
                         "ported: " + ", ".join(LM_ARCHS) + " (zamba2-2.7b "
                         "and xlstm-125m with the reference's arch "
                         "smoke-test overrides num_layers=4, attn_every=2 "
                         "and num_layers=4, slstm_every=2, since reduced() "
                         "alone leaves them no stage); the port's own: "
                         + ", ".join(PORT_LM_ARCHS) + " (sequential "
                         "engine)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--schedule", default="lw_fedssl",
                    choices=sched.SCHEDULES)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--clients-per-round", type=int, default=0)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--depth-dropout", type=float, default=0.0)
    ap.add_argument("--dirichlet-beta", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="sequential", choices=ENGINES,
                    help="round engine: sequential, or vmap (the round's "
                         "participants in one batched step)")
    ap.add_argument("--codec", default="fp32",
                    help="wire codec: fp32, fp16, bf16, int8 or "
                         "topk[:fraction] (default fraction 0.1)")
    ap.add_argument("--transport-kernels", default="xla",
                    choices=TRANSPORT_KERNELS,
                    help="the reference's wire-engine names; both select "
                         "the port's one wire path")
    ap.add_argument("--fleet", default="",
                    choices=("",) + fleet_mod.PROFILES,
                    help="simulate a heterogeneous device fleet drawn from "
                         "this named profile; empty = no simulation")
    ap.add_argument("--round-policy", default="synchronous",
                    choices=sim_mod.POLICIES,
                    help="round scheduling policy over the simulated "
                         "fleet: synchronous (wait for all), deadline "
                         "(overcommit + drop stragglers), buffered-async "
                         "(staleness-weighted FedBuff aggregation)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="fixed round deadline in simulated seconds "
                         "(0 = adaptive: the cohort's 60th percentile)")
    ap.add_argument("--overcommit", type=float, default=1.5,
                    help="deadline policy: sample this factor more "
                         "clients, clamped to the population")
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="buffered-async: aggregate once this many "
                         "updates arrived (0 = half the cohort)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="buffered-async: (1+staleness)^-alpha weight "
                         "discount")
    ap.add_argument("--dp-clip", type=float, default=0.0,
                    help="client-level DP: L2 clip on each client's "
                         "stage-payload update (0 = off; 'inf' runs the "
                         "clipping machinery as an exact pass-through)")
    ap.add_argument("--dp-noise-multiplier", type=float, default=0.0,
                    help="client-level DP: noise multiplier z; the server "
                         "adds N(0, (z*clip*max_w)^2) to the aggregate; "
                         "requires a finite --dp-clip > 0")
    ap.add_argument("--dp-delta", type=float, default=1e-5,
                    help="delta of the reported (eps, delta) guarantee")
    ap.add_argument("--dp-epsilon-budget", type=float, default=0.0,
                    help="halt training once cumulative eps exceeds this "
                         "(0 = unlimited)")
    ap.add_argument("--secure-agg", action="store_true",
                    help="pairwise-mask secure aggregation: FedAvg runs "
                         "as a masked fixed-point sum, the server never "
                         "sees an individual update")
    ap.add_argument("--measure-resources", action="store_true",
                    help="count the FLOPs of each stage's first local step "
                         "(torch.utils.flop_counter) and attach them (res.*) "
                         "to the stage-opening round span (--mode vit)")
    ap.add_argument("--trace", action="store_true",
                    help="record a span trace of the run and write "
                         "run_trace.jsonl + run_trace.chrome.json (the "
                         "latter loads in Perfetto / chrome://tracing) "
                         "under --obs-dir; analyse with `python -m "
                         "repro.launch.trace`; spans are host-timed")
    ap.add_argument("--metrics", action="store_true",
                    help="record typed counters/gauges/histograms and "
                         "write run_metrics.csv + run_history.json under "
                         "--obs-dir")
    ap.add_argument("--health", action="store_true",
                    help="attach the streaming health monitor (NaN/inf "
                         "loss, z-score loss spikes, compression-ratio "
                         "drift) and write health.json under --obs-dir")
    ap.add_argument("--halt-on-unhealthy", action="store_true",
                    help="stop training on a fatal health alert "
                         "(implies --health)")
    ap.add_argument("--profile-dir", default="",
                    help="also capture a torch.profiler trace (CPU, and "
                         "CUDA on the card) into this directory as "
                         "torch_profile.json")
    ap.add_argument("--obs-dir", default="results",
                    help="directory for observability artifacts")
    ap.add_argument("--live", action="store_true",
                    help="render round progress as a single live-updating "
                         "console line instead of one line per round")
    args = ap.parse_args(argv)
    try:
        make_codec(args.codec)
    except ValueError as e:
        ap.error(f"--codec {args.codec}: {e}")
    try:
        make_privacy(privacy_from_args(args))
    except ValueError as e:
        ap.error(str(e))
    if args.mode == "vit":
        return train_vit(args)
    if args.fleet:
        ap.error("--fleet simulation drives the vit driver; use --mode vit")
    if args.measure_resources:
        ap.error("--measure-resources measures the vit driver's steps; use "
                 "--mode vit")
    if args.arch == "seamless-m4t-medium":
        ap.error(f"--arch {args.arch}: {ENCDEC_REFUSAL}")
    if args.arch not in LM_ARCHS and args.arch not in PORT_LM_ARCHS:
        ap.error(f"--arch {args.arch}: not an LM architecture of "
                 f"repro_torch (--mode lm takes: "
                 f"{', '.join([*LM_ARCHS, *PORT_LM_ARCHS])})")
    if args.arch in PORT_LM_ARCHS and args.engine != "sequential":
        ap.error(f"--arch {args.arch}: trains on the sequential engine "
                 f"only, not --engine {args.engine}")
    return train_lm(args)


if __name__ == "__main__":
    main()
