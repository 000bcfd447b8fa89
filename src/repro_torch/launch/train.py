"""Federated SSL training launcher of the port (``repro.launch.train``).

Two modes:
  vit   the paper's experiment: a reduced ViT with MoCo v3 federated SSL
        on synthetic images under any of the five schedules, then a linear
        probe.
  lm    LM-family FedSSL (``--arch zamba2-2.7b``, the one LM ported): each
        client runs next-token SSL plus representation alignment on
        synthetic token shards, on the reduced arch of the reference's
        arch smoke test (``num_layers=4, attn_every=2``: the reference's
        ``reduced()`` alone leaves zamba2 no stage).

It runs on the card (``--device cuda``, the default) and raises without
one; ``--device cpu`` runs the plain PyTorch versions of the kernels.
``--engine`` picks the round engine (``sequential``, or ``vmap``: the
round's participants train together, one batched step at a time).
``--codec`` picks the wire compression (fp32, fp16, bf16, int8,
topk[:fraction]); ``--transport-kernels xla|pallas`` is accepted so that
the reference's command lines parse, and both select the port's one wire
path. ``--trace``, ``--metrics``, ``--health``, ``--halt-on-unhealthy``
and ``--profile-dir`` record the run as the reference does and write the
artifacts under ``--obs-dir`` (``run_trace.jsonl``,
``run_trace.chrome.json``, ``run_metrics.csv``, ``run_history.json``,
``health.json``; the profiler's ``torch_profile.json`` under
``--profile-dir``); ``--live`` rewrites one progress line in place.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit \\
      --schedule lw_fedssl --rounds 12 --clients 4 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit --engine vmap
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit --codec int8
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit \\
      --codec topk:0.1 --transport-kernels pallas
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch zamba2-2.7b --device cpu --rounds 4 --batch 8 --samples 64 \\
      --seq-len 64
  PYTHONPATH=src python -m repro_torch.launch.train --mode vit --trace \\
      --metrics --health --obs-dir results/obs
"""
from __future__ import annotations

import argparse
import pathlib
import time

import torch

from repro_torch.configs.base import (FLConfig, SSLConfig, TrainConfig,
                                      load_arch, reduced)
from repro_torch.convert import subtree
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as ssl_mod
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import synthetic_images, synthetic_tokens
from repro_torch.federated import eval as fl_eval
from repro_torch.federated.driver import (TRANSPORT_KERNELS, resolve_device,
                                          run_fedssl, run_lm_fedssl)
from repro_torch.federated.engine import ENGINES
from repro_torch.federated.transport import make_codec
from repro_torch.models import lm as lm_mod
from repro_torch.obs import ConsoleRenderer, make_obs, write_history_json

# flags of the reference launcher whose features the port does not have
# yet: flag -> (the value that means "off", what is missing)
NOT_PORTED = {
    "fleet": ("", "fleet simulation"),
    "round_policy": ("synchronous", "fleet round policies"),
    "dp_clip": (0.0, "differential privacy"),
    "dp_noise_multiplier": (0.0, "differential privacy"),
    "dp_epsilon_budget": (0.0, "differential privacy"),
    "secure_agg": (False, "secure aggregation"),
    "measure_resources": (False, "resource measurement"),
}


def obs_from_args(args, mode):
    """Observability bundle from --trace/--metrics/--profile-dir plus the
    health monitor (--health/--halt-on-unhealthy)."""
    return make_obs(trace=args.trace, metrics=args.metrics,
                    profile_dir=args.profile_dir or None,
                    health=args.health,
                    halt_on_unhealthy=args.halt_on_unhealthy,
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
    obs = obs_from_args(args, "vit")
    t0 = time.time()
    with ConsoleRenderer(live=args.live) as log:
        state, hist = run_fedssl(cfg, ssl_cfg, fl, tc, images=images,
                                 client_indices=idx, aux_images=aux,
                                 log=log, device=device, engine=args.engine,
                                 codec=args.codec,
                                 transport_kernels=args.transport_kernels,
                                 obs=obs)
    export_obs(obs, args, hist=hist)
    print(f"training done in {time.time() - t0:.1f}s; "
          f"total comm {hist.total_comm / 1e6:.2f} MB analytic, "
          f"{hist.total_wire / 1e6:.2f} MB on the wire "
          f"({args.codec}: {hist.compression_ratio:.2f}x)")
    enc = ssl_mod.make_vit_encoder(cfg)
    n_eval = min(args.samples // 2, 512)
    acc = fl_eval.linear_eval(
        enc, subtree(state["online"], "enc"), images[:n_eval],
        labels[:n_eval], images[n_eval:2 * n_eval],
        labels[n_eval:2 * n_eval], num_classes=10, epochs=5, batch_size=64)
    print(f"linear evaluation accuracy: {acc * 100:.2f}%")
    return acc


# --mode lm: the archs ported, each with the override of the reference's
# arch smoke test (tests/test_arch_smoke.py) applied on top of reduced()
LM_ARCHS = {"zamba2-2.7b": dict(num_layers=4, attn_every=2)}


def train_lm(args):
    """LM-family layer-wise FedSSL on synthetic token shards (the
    reference's ``train_lm``); returns (params, history)."""
    device = resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    cfg = reduced(load_arch(args.arch), **LM_ARCHS[args.arch])
    fl = FLConfig(num_clients=args.clients, rounds=args.rounds,
                  local_epochs=args.local_epochs, schedule=args.schedule)
    tc = TrainConfig(batch_size=args.batch, base_lr=3e-4)
    toks, labs = synthetic_tokens(gen, args.samples, args.seq_len,
                                  cfg.vocab_size)
    shards = iid_partition(args.samples, fl.num_clients, seed=args.seed)
    params = lm_mod.init_lm(cfg, gen, device)
    obs = obs_from_args(args, "lm")
    with ConsoleRenderer(live=args.live) as log:
        params, hist = run_lm_fedssl(
            cfg, fl, tc, tokens=toks, labels=labs, shards=shards,
            params=params, device=device, codec=args.codec,
            transport_kernels=args.transport_kernels, log=log, obs=obs)
    export_obs(obs, args)
    print(f"final loss {hist.loss[-1]:.4f} (start {hist.loss[0]:.4f}); "
          f"{hist.total_wire / 1e6:.2f} MB/client on the wire "
          f"({args.codec}: {hist.compression_ratio:.2f}x)")
    return params, hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="vit", choices=("vit", "lm"))
    ap.add_argument("--arch", default="internlm2-1.8b",
                    help="--mode lm: the LM architecture; zamba2-2.7b is "
                         "the one ported, run with the reference's arch "
                         "smoke-test override (num_layers=4, attn_every=2) "
                         "on top of reduced(), since reduced() alone leaves "
                         "it no stage")
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
    # accepted so that the reference's command lines parse; any value
    # other than "off" is refused below
    ap.add_argument("--fleet", default="")
    ap.add_argument("--round-policy", default="synchronous")
    ap.add_argument("--dp-clip", type=float, default=0.0)
    ap.add_argument("--dp-noise-multiplier", type=float, default=0.0)
    ap.add_argument("--dp-epsilon-budget", type=float, default=0.0)
    ap.add_argument("--secure-agg", action="store_true")
    ap.add_argument("--measure-resources", action="store_true")
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
    for name, (off, what) in NOT_PORTED.items():
        if getattr(args, name) != off:
            ap.error(f"--{name.replace('_', '-')} {getattr(args, name)}: "
                     f"{what} is not ported to repro_torch yet")
    try:
        make_codec(args.codec)
    except ValueError as e:
        ap.error(f"--codec {args.codec}: {e}")
    if args.mode == "vit":
        return train_vit(args)
    if args.engine != "sequential":
        ap.error(f"--engine {args.engine} with --mode lm: the LM vmap engine "
                 f"is not ported to repro_torch yet")
    if args.arch not in LM_ARCHS:
        ap.error(f"--arch {args.arch}: this LM architecture is not ported "
                 f"to repro_torch yet (ported: {', '.join(LM_ARCHS)})")
    return train_lm(args)


if __name__ == "__main__":
    main()
