"""Batched serving driver of the port (``repro.launch.serve``): prefill a
batch of prompts by stepping the decoder over them (cache-exact), then
decode greedily; the encoder-decoder encodes the frontend stub's frames
once and decodes against that memory from token 0.

Without ``--full`` it serves a reduced variant of the arch: the
reference's ``reduced()``, plus the launcher's overrides for zamba2-2.7b
and xlstm-125m (``launch.train.LM_ARCHS``: ``num_layers=4`` with
``attn_every=2`` / ``slstm_every=2``). ``reduced()`` alone cuts them to 2
layers but keeps ``attn_every`` / ``slstm_every`` at 6, which leaves no
block at all: the reference's ``serve`` then answers from the embedding,
the final norm and the head alone. ``--full`` serves the published
config.

It runs on the card (``--device cuda``, the default) and raises without
one; ``--device cpu`` runs the plain PyTorch versions of the kernels. The
loop keeps the tokens on the device and reads them back once, after the
clock stops; the reference reads each step's tokens back as it goes.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 4 --prompt-len 64 --gen 32 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Tuple

import torch

from repro_torch.configs.base import load_arch, reduced
from repro_torch.federated.driver import resolve_device
from repro_torch.launch.steps import is_encdec, make_decode_step
from repro_torch.launch.train import LM_ARCHS
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod


def serve_config(arch: str, full: bool = False):
    """The config ``serve`` runs: the published one with ``full``, else
    ``reduced()`` with the launcher's overrides (zamba2, xlstm)."""
    cfg = load_arch(arch)
    return cfg if full else reduced(cfg, **LM_ARCHS.get(arch, {}))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, source: torch.Tensor,
             gen: int) -> Tuple[torch.Tensor, float]:
    """The reference's greedy serving loop on ``params``. ``source``: the
    prompts (B, P) of a decoder-only LM, stepped through the decoder at
    positions 0..P-1, or the encoder memory (B, T, d) of the
    encoder-decoder, which starts from token 0 at position 0. Caches hold
    the P + gen positions the loop reaches (gen for the
    encoder-decoder). As in the reference, the
    loop starts from the prefill's argmax and records the ``gen`` tokens
    after it. Returns (the tokens (gen, B) on the host, the decode loop's
    seconds)."""
    decode = make_decode_step(cfg)
    device = source.device
    B = source.shape[0]
    if is_encdec(cfg):
        caches = encdec_mod.init_dec_caches(cfg, B, gen, device=device)
        tok = torch.zeros((B, 1), dtype=torch.int64, device=device)
        start, extra = 0, (source,)
    else:
        P = source.shape[1]
        caches = lm_mod.init_caches(cfg, B, P + gen, device=device)
        for t in range(P):
            logits, caches = decode(params, caches, source[:, t:t + 1], t)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        start, extra = P, ()
    out = []
    _sync(device)
    t0 = time.perf_counter()
    for t in range(gen):
        logits, caches = decode(params, caches, tok, start + t, *extra)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok[:, 0])
    _sync(device)
    dt = time.perf_counter() - t0
    return torch.stack(out).cpu(), dt


def serve(arch: str, batch: int, prompt_len: int, gen: int, seed: int = 0,
          full: bool = False, log=print, device="cuda"):
    """Serve ``batch`` random prompts of ``prompt_len`` tokens (or, for
    the encoder-decoder, random frames) with random weights from
    ``seed``; returns (tokens (gen, batch), tokens per second)."""
    device = resolve_device(device)
    cfg = serve_config(arch, full)
    g = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        if is_encdec(cfg):
            params = encdec_mod.init_encdec(cfg, g, device)
            frames = torch.randn((batch, cfg.frontend_embed_len, cfg.d_model),
                                 generator=g, device=device)
            source = encdec_mod.encode(params, frames, cfg)
        else:
            params = lm_mod.init_lm(cfg, g, device)
            source = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=g, device=device)
    tokens, dt = generate(cfg, params, source, gen)
    tps = batch * gen / dt
    log(f"{arch}: generated {gen} tokens x {batch} seqs in {dt:.2f}s "
        f"({tps:.1f} tok/s on {device.type})")
    return tokens, tps


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve an LM of the port: prefill, then greedy decode.")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: reduced)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    return serve(args.arch, args.batch, args.prompt_len, args.gen, args.seed,
                 full=args.full, device=args.device)


if __name__ == "__main__":
    main()
