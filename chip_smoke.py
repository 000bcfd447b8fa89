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
   from the same states, within 1e-4 (their gradients are printed). Then
   the vmap engine's memory: one e2e step at full width, batch 256, on
   ``train_step`` and on ``stacked_train_step`` at C = 1 and 4, each
   step's peak above its state within 1.25 x C x the sequential step's;
   the MiB a client and the clients the card holds at that slope.
2d. LM path: LW-FedSSL on the zamba2-2.7b LM at its published widths
   (d 2560, 32 heads of 80, SwiGLU d_ff 10240, vocab 32000, Mamba2 state 64,
   head dim 64, expand 2, chunk 256, bf16 compute, fp32 params), depth cut
   from 54 Mamba2 blocks to 12 (2 stage groups of 6, each followed by the
   shared attention block): ``run_lm_fedssl``, 4 clients, 4 rounds (2 a
   stage), batch 4 x 1024 tokens, 64 synthetic sequences (4 local steps a
   client and round), fp32 wire. Counters set to 0 before, read after;
   losses finite, wire bytes equal to the analytic bytes in every round,
   and the ``ssd_scan``, ``flash_attention`` and ``rope`` launches equal to
   the counts the plan implies (12 s scans and 2 s attentions a local step
   at stage s: the online forward, frozen groups included, and the global
   model's; a RoPE launch an attention and one more in the backward of
   each trained group's);
   seconds per round and peak memory; the run again from the same seed,
   with bit-identical losses. Then ``gather_pack`` and
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
2f. resources, the paper's table and the fleet simulator: (a)
   ``launch.trace.paper_table`` on the card at full ViT-Tiny width, batch
   256, both engines x the five schedules (one counted local step per plan
   signature: 98 steps): full-scale comm bytes equal to
   ``client_costs.schedule_costs``' and at the paper's multipliers (0.08 /
   0.31 / 0.54), each signature's counted FLOPs within ``FLOPS_RTOL`` of
   the analytic count and its peak within ``MEMORY_FACTOR`` of the eager
   memory model (each signature's numbers printed);
   one reduced step (4 blocks, 3 heads of 64) counted on the card and on
   the CPU, equal op by op, with counting changing neither the loss nor a
   launch count. (b) the ViT path at full width, depth cut to 4
   blocks, 8 clients, 4 a round, 4 rounds, int8 wire, with a simulated
   pareto-stragglers fleet under the deadline and the buffered-async
   policies (finite losses, accounting lengths, ``train_ids`` within the
   cohort, weights summing to 1, cohorts at most the population, and for
   the deadline policy no client both dropped and aggregated: the
   buffered-async records break that one as the reference's do, and the
   overlap is printed), and a uniform fleet under the synchronous policy,
   bit-identical to no simulator. (c) ``measure_resources`` on both
   engines: losses bit-identical to the unmeasured run's, ``res.*`` on
   each stage's first round span (counted FLOPs within ``FLOPS_RTOL`` of
   analytic), ``mem.*`` on every round span. Prints the phase's seconds.
2g. privacy and checkpoints: (a) phase 2's run again with
   ``PrivacyConfig(clip=inf)``: losses and final state bit-identical to
   phase 2's, epsilon inf and clip fraction 0 every round; the clients'
   update norms are read, and their median, to 3 digits, is the clip C of
   (b). (b) the int8 run of phase 2b with C and z = 1.1: finite losses,
   clip fractions in [0, 1] and some above 0, epsilon equal to
   ``compute_epsilon`` round by round, the last round's noised aggregate
   minus the noiseless one with a sample std within 1% of sigma, and every
   launch count equal to the int8 run's but ``gather_pack`` (2 more a
   round: the clip's shared reference, the aggregate that takes the noise)
   and ``scatter_unpack`` (1 more: the noised aggregate); then the same on
   the vmap engine over the top-k wire. (c) secure aggregation at the
   stage-12 upload (4 clients): masked = unmasked fixed-point sum = the
   CPU's, to the bit, within n x 2^-40 of the exact FedAvg, int64 add
   wrapping at +-2^63, masks with the top bit in half the draws, its
   seconds and bytes; one secure e2e round on each engine, one secure round
   of the deadline and the buffered-async policies at phase 2f's fleet
   configuration, each aggregate held to the exact FedAvg of its decoded
   uploads. (d) phase 2d's LM for 2 rounds with DP (C = 1e-3, z = 1.1) and
   secure aggregation: finite losses, epsilon, the noise's std, the secure
   aggregation's seconds and added bytes, the peak memory. (e) (a)'s final
   state through ``save_fl_state`` and back, bit-identical on the card and
   on the CPU. Prints each part's seconds and the phase's.
2h. the other SSL methods and optimizers: phase 2's main path (fp32 wire,
   12 rounds, no linear eval) with SimCLR + SGD with momentum on the
   sequential engine, then BYOL + Adafactor on the vmap engine: finite
   losses, wire bytes equal to the analytic bytes every round (SimCLR's
   download and upload exactly the prediction head's bytes below phase
   2's MoCo v3, BYOL's equal), every launch count equal to the plan's
   (``vit_expected_launches``: SimCLR has no target forward and only the
   alignment's InfoNCE terms), seconds per round and peak memory; then one
   full-width step of each on 8 images at fp32, card against CPU: the
   loss before and after each device's step (1e-4) and the optimizer's
   update of one gradient (1e-5 of the largest update); the gradients'
   difference is printed.
2i. dense LM: LW-FedSSL on internlm2-1.8b at its published widths (d
   2048, 16 q heads over 8 kv heads of 128, SwiGLU d_ff 8192, vocab 92544,
   untied head, bf16 compute, fp32 params), depth cut from 24 blocks to 4
   (630,736,896 parameters; one stage a block): ``run_lm_fedssl``, 4
   clients, 4 rounds, batch 4 x 1024 tokens, 64 sequences, fp32 wire.
   Finite losses, wire bytes equal to the analytic bytes, attention,
   RMSNorm, InfoNCE and pack/unpack launches equal to the plan's
   (``dense_expected_launches``), seconds per round and peak memory; the
   run again from the same seed, with bit-identical losses
   (``check_repeat``); ``lm_ssl_loss`` card against CPU at fp32 (stage 1,
   2 x 512 tokens). Then both LM engines at depth 2 (504,899,584
   parameters), 4 clients, 2 rounds, batch 2 x 1024 (the vmap engine:
   ``launch.steps.make_fl_round_program``): launches equal to the plan's,
   peak memory, and the vmap engine's losses within half a bf16 step
   (2^-9, relative) of the sequential engine's.
2j. xLSTM LM: LW-FedSSL on xlstm-125m at its published widths and depth (d
   768, 4 heads, mLSTM inner width 1536 in heads of 384, 12 blocks in 2
   stage groups of 5 mLSTM + 1 sLSTM, vocab 50304, untied head, bf16
   compute; 190,670,672 parameters, no cut): ``run_lm_fedssl``, 4 clients,
   2 rounds (one a stage), batch 4 x 1024 tokens, 64 sequences, fp32 wire,
   on the sequential and then the vmap engine from the same draws. Finite
   losses, wire bytes equal to the analytic bytes, RMSNorm, InfoNCE and
   pack/unpack launches equal to the plan's and no attention launch
   (``xlstm_expected_launches``), seconds per round and peak memory; one
   stage-2 local step run twice from the same state, bit-identical;
   ``lm_ssl_loss`` card against CPU at fp32 (stage 1, 2 x 512 tokens: the
   chunkwise mLSTM, 2 chunks); the share of a stage-2 local step that its
   four sLSTM layer calls take (CUDA events); the vmap engine's losses
   within 5e-4 (relative) of the sequential engine's and its parameter
   updates within 0.17 of theirs (``update_gap``, L1).
2k. encoder-decoder: seamless-m4t-medium at its published widths (d
   1024, 16 heads of 64, SwiGLU d_ff 4096, vocab 256206, untied head,
   512 frame embeddings from the frontend stub, drawn from the phase's
   seed). (a) ``launch.steps.make_train_step`` (train_lw) at full depth,
   12 encoder + 12 decoder blocks (977,758,208 parameters), one client,
   3 steps of batch 2 x 1024 tokens, AdamW: finite losses and updated
   parameters, ms per step, peak memory. (b) ``make_fl_round_program``
   with depth cut to 4 + 4 blocks (675,727,360 parameters, 4 stages), 2
   clients of 16 samples, 4 rounds of LW-FedSSL at batch 2 x 1024 tokens
   + 512 frames, driven round by round with ``transfer_model`` at each
   new stage and the fp32 transport: wire bytes equal to the analytic
   bytes every round; attention launches counted apart (encoder,
   decoder self-attention, cross attention), RMSNorm, InfoNCE and
   pack/unpack launches equal to the plan's
   (``encdec_expected_launches``); peak memory; then the
   encoder-decoder's loss with alignment card against CPU at fp32 (the
   last stage, 2 x 256 tokens).
2l. MoE and MLA: (a) LW-FedSSL on deepseek-v2-236b at its published widths
   (d 5120, 128 heads, MLA with kv rank 512, q rank 1536, q/k heads 128 +
   64 and v heads 128, routed experts of width 1536 top-6 and 2 shared,
   vocab 102400, bf16 compute), depth cut from 60 blocks to 2 (2 stages)
   and the routed experts from 160 to 8 (1,818,993,664 parameters):
   ``run_lm_fedssl`` with Adafactor (its ``TRAIN``), 2 clients, 2 rounds,
   batch 2 x 1024 tokens, 8 sequences, fp32 wire. Finite losses, wire
   bytes equal to the analytic bytes, attention (MLA's 192 / 128 head
   dims), RMSNorm, InfoNCE and pack/unpack launches equal to the plan's,
   peak memory; the run again from the same seed, bit-identical; then
   ``lm_ssl_loss`` card against CPU at fp32 (stage 1, 2 x 256 tokens).
   (b) ``python -m repro_torch.launch.train --mode lm`` for
   deepseek-v2-236b and llama4-maverick-400b-a17b at the launcher's
   ``reduced()`` configs on both engines (four processes at once, 2
   rounds, batch 4 x 64): each exits 0 with finite losses, and each arch's
   engines agree.
2m. serving: (a) ``python -m repro_torch.launch.serve --arch
   internlm2-1.8b --full --batch 4 --prompt-len 64 --gen 64`` through its
   ``main``: the published config at full depth (24 blocks,
   1,889,110,016 parameters, fp32 weights, bf16 compute), 64 prompt
   tokens stepped through the decoder, then 64 generated greedily; tok/s,
   ms a decode step, peak memory; launches equal to the plan's (attention
   24 and RMSNorm 49 a step over 128 steps, no other kernel); one decode
   step's wall time against the device's busy time under torch.profiler,
   by kernel (``profile_device``). (b) The same
   model at fp32 compute: the decoder stepped over 2 x 32 tokens against
   ``forward_hidden``'s logits within 1e-4 of the largest logit; at bf16
   the same error printed, not checked; a 2-block copy's decode card
   against CPU within 1e-4. (c) Each other family's decode against its
   own forward at fp32 within 1e-4: zamba2-2.7b at its published widths
   and depth, xlstm-125m at its published widths and depth, deepseek-v2
   at phase 2l's cut with a capacity factor of 2 E / k (no token drops,
   as in the reference's decode parity test), llama4-maverick at
   ``reduced()`` likewise, seamless-m4t-medium at its published widths
   and depth over 512 frames against ``decode_train``. (d) The ring
   buffer: internlm2-1.8b's widths at 2 blocks with a window of 16 (a
   cache of 16 slots), 48 steps against the windowed forward within 1e-4.
   Prints each part's seconds and the phase's.
2n. sharding, expert parallelism and the prefill hand-off: (a)
   deepseek-v2-236b's MoE layer at its published widths with all 160
   routed experts (15.1 GB of fp32 expert weights; phase 2l's cut of 160
   to 8 lifted for this one layer), fp32 compute, 2 x 1024 tokens:
   ``moe_ffn_local`` as 4 shards of 40 experts one after another, their
   partial outputs summed, against one call with ``e_local = 160``: the
   sum within 1e-5 of the largest output, ``aux`` equal to the bit, the
   shards' ``dropped`` summing to the whole's; its peak memory; then
   card against CPU at ``reduced()`` (4 experts, 2 shards) within 1e-5.
   (b) ``make_sharded_train_step`` on a real one-rank mesh (``nccl``,
   world size 1, mesh (1, 1)): internlm2-1.8b at its published widths,
   4 blocks, batch 4 x 1024; its loss and updated parameters equal the
   unsharded ``make_train_step``'s to the bit, and its kernel launches
   (counters set to 0 before, read after) equal the unsharded step's.
   (c) ``python -m repro_torch.launch.dryrun`` as two subprocesses at
   once, on ``meta`` over fake process groups: internlm2-1.8b train_4k on
   16 x 16 and deepseek-v2-236b decode_32k on 2 x 16 x 16; each exits 0
   and prints its roofline row and its collective bytes by source (the
   rules' layouts apart from the port's own reshards). (d) The prefill hand-off on phase 2d's
   zamba2 model (12 Mamba2 blocks at published widths): each block on its
   own input, 4 prompts of 1024 tokens, as two halves, the first half's
   (h_final, conv) handed to the second as ``h0`` / ``conv0``; the first
   half's final state against the plain scan on the card within 1e-4 and
   against ``mamba2_decode`` stepped over the same 512 tokens within
   1e-4 of the largest state entry; the second half's scan with ``h0``
   against the plain scan within 1e-4; the gap between the two-part run
   and one pass printed (the reference's ignored ``conv0``). Counters set
   to 0 before (b) and before (d), read after each.
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
   kernels' times), the same from a non-zero ``h0`` with its final state
   (the prefill hand-off; y and the state within 1e-4, timed, and the
   backward's gradients for every input and h0 at a small shape), five
   other shapes of one to five chunks, and its
   backward; causal attention at (4, 1024, 32, 80) bf16 and at the dense
   LM's (4, 1024, 16/8, 128) bf16 (GQA), against
   ``F.scaled_dot_product_attention(enable_gqa=True)``; RMSNorm at (4096,
   2560), (4096, 5120) and (4096, 2048); InfoNCE at (1, 4, 2560), with
   the two-call yardstick, and at widths above 4096. Phases 2j and 2k's
   shapes: non-causal bf16 attention over seamless-m4t's 16 heads of 64,
   cross attention (2, 1024 queries over 512 keys) and the encoder's (2,
   512), against ``ref.sdpa_ref`` (2e-2) and beside
   ``F.scaled_dot_product_attention``; RMSNorm at (4096, 1536) in bf16
   (the mLSTM's inner norm) beside ``F.rms_norm``; InfoNCE at (1, 4, 768)
   and (1, 2, 1024); pack and unpack bit-identical on every xLSTM and
   encoder-decoder payload layout of their plans, timed at the largest.
   Phase 2l's: causal attention with MLA's head dims, (2, 1024, 128/128,
   192 / 128) in bf16 and fp32 and the reduced (4, 64, 4/4, 48 / 32) in
   fp32, and llama4-maverick's (2, 1024, 40/8, 128) bf16, against
   ``ref.sdpa_ref`` and beside ``F.scaled_dot_product_attention``; the
   attention backward at the MLA head dims. Phase 2m's: the dense LM's
   decode attention, one query over 128 keys (4, 1 / 128, 16/8 heads of
   128, non-causal, bf16), beside ``F.scaled_dot_product_attention``, and
   its RMSNorm at (4, 2048) fp32 beside ``F.rms_norm``. Zamba2-7B's (the
   benchmark's zamba2-7b cell): causal bf16 attention at (1, 4096, 32,
   224), the SSD scan at (1, 4096, 112, 64), N 64, 2 groups, RMSNorm at
   (4096, 3584) and (4096, 7168) fp32 and at (2, 4096, 3584) with a (2,
   3584) scale (the gated norm's groups), and pack and unpack
   bit-identical on the 18-layer cut's stage-3 download (the whole model,
   2,245,451,680 floats, above 2**31) and upload, timed at the download.
   RoPE (``rope_rotate_kernel``, which replaces no TPU kernel: the
   reference's RoPE is jnp code) rotating q and k in one launch at the
   ViT cell's (4096, 65, 3, 64) bf16 and at Zamba2-7B's (1, 4096, 32, 224)
   bf16: forward and backward bit-identical to the plain version, timed
   beside it and against its byte bound, of which it must reach
   ``ROPE_BOUND_SHARE`` at the ViT's shape.

With ``--profile``, a fifth phase traces one local step of the last stage
with ``torch.profiler``, of one client and of four at once (the vmap
engine's step), and one local step of the LM path at stage 2, and prints
where their device time goes; then it splits the LM step by source with
CUDA events (forward, forward and backward, AdamW, the
``SSDScanFn.backward`` calls inside the step, and one such call alone);
then one full-width e2e ViT step's memory under autograd and under
``torch.func.grad`` (``grad_memory_split``), and the host time a
kernel-backed op takes to enqueue directly and through its custom op
(``dispatch_overhead``).

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
mesh = None  # repro_torch.launch.mesh (the card's peak rates), once imported

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
    # replaces none: the reference's RoPE is jnp code
    # (src/repro/models/layers/rope.py:12)
    "rope": ("src/repro_torch/kernels/csrc/rope.cu", None),
}
# the kernels each path must launch; a kernel's "launches" in the kernels
# line is its count on the first path that lists it. info_nce_rows_dk is on
# no path: every negative of the loss is detached, so only chip_smoke's
# check launches it.
MAIN_KERNELS = ("gather_pack", "scatter_unpack", "rmsnorm_rows",
                "flash_attention", "info_nce_rows", "info_nce_rows_dq",
                "rope")
PATH_KERNELS = {
    "fp32": MAIN_KERNELS,
    "int8": ("int8_quant_matrix", "int8_dequant_matrix"),
    "topk": ("compensate", "topk_ef_update"),
    "vmap": MAIN_KERNELS,
    "lm": MAIN_KERNELS + ("ssd_scan",),
    "simclr_sgdm": MAIN_KERNELS,
    "byol_adafactor": MAIN_KERNELS,
    "lm_dense": MAIN_KERNELS,
    "lm_vmap": MAIN_KERNELS,
    # the xLSTM launches no attention
    "lm_xlstm": ("gather_pack", "scatter_unpack", "rmsnorm_rows",
                 "info_nce_rows", "info_nce_rows_dq"),
    "lm_xlstm_vmap": ("gather_pack", "scatter_unpack", "rmsnorm_rows",
                      "info_nce_rows", "info_nce_rows_dq"),
    "encdec": MAIN_KERNELS,
    "lm_moe": MAIN_KERNELS,
    # serving: decode attention over the KV cache and the decode RMSNorms
    "serve": ("flash_attention", "rmsnorm_rows", "rope"),
    # phase 2n: the sharded dense step and the Mamba2 prefill hand-off
    "sharded": ("flash_attention", "rmsnorm_rows", "rope"),
    "prefill": ("ssd_scan", "rmsnorm_rows"),
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
    global mesh  # the card's peak rates, for the kernels' bounds
    if not (SRC / "repro_torch" / "__init__.py").exists():
        raise SmokeFailure(f"no src/repro_torch beside {__file__}: run this "
                           f"script from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import repro_torch
    from repro_torch.launch import mesh
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
              rounds_per_stage=(), engine="sequential", obs=None, sim=None,
              clients_per_round=0, privacy=None, schedule="lw_fedssl",
              optimizer="adamw"):
    """LW-FedSSL (or ``schedule``) through ``run_fedssl`` (and
    ``linear_eval`` unless ``eval_epochs`` is 0) on ``device`` with
    ``optimizer``, recorded by ``obs``, simulated by ``sim`` and private
    under ``privacy`` if given.
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
                  schedule=schedule, seed=seed,
                  rounds_per_stage=rounds_per_stage,
                  clients_per_round=clients_per_round)
    tc = TrainConfig(batch_size=batch, optimizer=optimizer)
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
                             obs=obs, sim=sim, privacy=privacy)
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
    there, the vmap engine's (``stacked_loss_and_grads``) against each
    client's on the sequential engine's route (``loss_and_grads``), are
    printed and not checked: a ReLU input that lands within rounding of 0
    takes the other subgradient under another summation order, which
    changes a whole client's gradient by far more than rounding (the CPU
    shows it too, between two thread counts of the same code)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import subtree
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data.augment import draw_params, two_views
    from repro_torch.federated.client import (
        loss_and_grads, stacked_loss_and_grads, stacked_train_step,
        train_step)
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
    grad_kw = {k: v for k, v in kw.items() if k != "opt"}

    lock = gerr = gl2 = 0.0
    for _ in range(steps):
        x1, x2 = two_views(images[:C * B], draw_params(gen, C * B, 32, 32),
                           draw_params(gen, C * B, 32, 32))
        _, gv = stacked_loss_and_grads(st, x1.unflatten(0, (C, B)),
                                       x2.unflatten(0, (C, B)), **grad_kw)
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
            _, _, gs = loss_and_grads(one, x1[c * B:(c + 1) * B],
                                      x2[c * B:(c + 1) * B], **grad_kw)
            gerr = max(gerr, max(float((gv[k][c] - g).abs().max())
                                 for k, g in gs.items())
                       / max(float(g.abs().max()) for g in gs.values()))
            gl2 = max(gl2, math.sqrt(
                sum(float(((gv[k][c] - g) ** 2).sum()) for k, g in gs.items())
                / sum(float((g ** 2).sum()) for g in gs.values())))
        st, opt_state = new_st, new_opt
    return seq_loss, vm_loss, perr, lock, gerr, gl2


# ---------------------------------------------------------------------------
# phase 2h: the other SSL methods and optimizers on the main path
# ---------------------------------------------------------------------------
# (SSLConfig.method, TrainConfig.optimizer, engine) of each run
METHOD_RUNS = (("simclr", "sgdm", "sequential"),
               ("byol", "adafactor", "vmap"))


def vit_expected_launches(ssl_cfg, fl, plans, counts, batch, aux, engine):
    """The ViT path's launches its plan implies, per kernel: each local
    step at stage s runs the encoder's s blocks (attention and two
    RMSNorms each, the frozen prefix included) and its final RMSNorm, once
    a view in the online branch, the target branch (moco_v3, byol) and,
    where the plan aligns, the global encoder; its InfoNCE terms (forward
    and dq) are MoCo's two and the alignment's two. A calibration step
    (``server_epochs`` passes over ``aux`` images) is a local step without
    the alignment. RoPE launches once an attention (q and k together), and
    once more in the backward of each trained block's attention of the
    online branch (blocks ``active_from`` up; all in calibration). The
    vmap engine launches once a batched step, so its step count is the
    largest client's. Every round packs and unpacks the download once and
    each client's upload once."""
    target = ssl_cfg.method in ("moco_v3", "byol")
    moco = 2 if ssl_cfg.method == "moco_v3" else 0
    steps = [n // batch * fl.local_epochs for n in counts]
    calib = fl.server_epochs * max(1, aux // batch)
    out = dict.fromkeys(("flash_attention", "rmsnorm_rows", "info_nce_rows",
                         "info_nce_rows_dq", "gather_pack", "scatter_unpack",
                         "rope"), 0)

    def add(s, act, align, n):
        encoders = 2 * (1 + target + align)
        out["flash_attention"] += n * encoders * s
        out["rmsnorm_rows"] += n * encoders * (2 * s + 1)
        out["info_nce_rows"] += n * (moco + 2 * align)
        out["info_nce_rows_dq"] += n * (moco + 2 * align)
        out["rope"] += n * (encoders * s + 2 * (s - act))

    for plan in plans:
        s = plan.sub_layers
        add(s, min(plan.active_from, s),
            plan.align and ssl_cfg.align_weight > 0,
            max(steps) if engine == "vmap" else sum(steps))
        if plan.server_calibrate:
            add(s, 0, False, calib)
        out["gather_pack"] += 1 + len(counts)
        out["scatter_unpack"] += 1 + len(counts)
    return out


def method_step_check(model_cfg, ssl_cfg, optimizer, state, images):
    """One full-width local step of ``ssl_cfg.method`` with ``optimizer``
    (stage 12 with the alignment) on 8 images at fp32 compute, from the
    trained ``state``, with the kernels on the card against the plain
    versions on the CPU: the loss; the loss again after each device's own
    step; and the optimizer's update of one gradient (the CPU's) on both
    devices. The gradients' relative L2 difference is returned and not
    checked: a ReLU input of the heads within rounding of 0 (BatchNorm over
    8 samples puts many there) takes the other subgradient on the other
    device, which changes that unit's row of the gradient by far more than
    rounding; and Adafactor's first step moves every coordinate by about
    the rate whatever its gradient's size, so the update is compared on one
    gradient. Returns (relative loss difference before the step, after
    it, largest update difference over the largest update, relative L2
    difference of the gradient, the leaf that holds most of it)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import subtree
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data.augment import draw_params, two_views
    from repro_torch.federated.masks import stage_update_mask
    from repro_torch.optim import make_optimizer

    cfg = dataclasses.replace(model_cfg, compute_dtype="float32")
    L = cfg.num_layers
    enc = ssl_mod.make_vit_encoder(cfg)
    opt = make_optimizer(TrainConfig(batch_size=8, optimizer=optimizer))
    gen = torch.Generator("cpu").manual_seed(1)
    x1, x2 = two_views(images[:8].cpu(), draw_params(gen, 8, 32, 32),
                       draw_params(gen, 8, 32, 32))

    def loss_of(st, online, dev):
        return ssl_mod.ssl_loss(
            {**st, "online": online}, x1.to(dev), x2.to(dev), enc, ssl_cfg,
            sub_layers=L, active_from=L - 1,
            global_enc=subtree(st["online"], "enc"),
            align_weight=ssl_cfg.align_weight)[0]

    out = {}
    for dev in ("cuda", "cpu"):
        st = {b: {k: v.to(dev) for k, v in t.items()}
              for b, t in state.items()}
        online = {k: v.clone().requires_grad_()
                  for k, v in st["online"].items()}
        loss = loss_of(st, online, dev)
        grads = torch.autograd.grad(loss, list(online.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(online.items(), grads)}
        mask = stage_update_mask(st["online"], L, L - 1)
        new, _ = opt.update(grads, opt.init(st["online"]), st["online"],
                            1e-3, mask)
        with torch.no_grad():
            after = float(loss_of(st, new, dev))
        out[dev] = (float(loss.detach()), after, st, mask,
                    {k: g.cpu() for k, g in grads.items()})
    rel, rel_after = (abs(out["cuda"][i] - out["cpu"][i]) / abs(out["cpu"][i])
                      for i in (0, 1))
    steps = {}
    for dev in ("cuda", "cpu"):
        st, mask = out[dev][2], out[dev][3]
        new, _ = opt.update({k: g.to(dev) for k, g in out["cpu"][4].items()},
                            opt.init(st["online"]), st["online"], 1e-3, mask)
        steps[dev] = {k: (v - st["online"][k]).cpu() for k, v in new.items()}
    uerr = max(float((steps["cuda"][k] - d).abs().max())
               for k, d in steps["cpu"].items()) / max(
        float(d.abs().max()) for d in steps["cpu"].values())
    gu, gc = out["cuda"][4], out["cpu"][4]
    sq = {k: float(((gu[k] - gc[k]) ** 2).sum()) for k in gc}
    grel = math.sqrt(sum(sq.values()) / max(
        sum(float((g ** 2).sum()) for g in gc.values()), 1e-30))
    return rel, rel_after, uerr, grel, max(sq, key=sq.get)


def methods_phase(model_cfg, moco_state, moco_hist):
    """Phase 2h; ``moco_state``, ``moco_hist`` are phase 2's. Returns
    {path: launch counts}."""
    import torch
    from repro_torch.configs.base import FLConfig, SSLConfig
    from repro_torch.core import schedule as sched
    from repro_torch.federated import comm
    from repro_torch.kernels import ops

    pred_b = comm.tree_bytes({k: v for k, v in moco_state["online"].items()
                              if k.startswith("pred/")})
    launches = {}
    for method, optimizer, engine in METHOD_RUNS:
        ssl_cfg = SSLConfig(method=method)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        state, hist, _, secs, images = main_path(
            "cuda", model_cfg=model_cfg, ssl_cfg=ssl_cfg, eval_epochs=0,
            engine=engine, optimizer=optimizer)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        what = f"{method} + {optimizer} ({engine})"
        launches[f"{method}_{optimizer}"] = got
        check_history(hist, state["online"])
        has_pred = any(k.startswith("pred/") for k in state["online"])
        check(has_pred == (method != "simclr")
              and ("target" in state) == (method != "simclr"),
              f"{what}: state branches {sorted(state)}")
        for way in ("download_bytes", "upload_bytes"):
            less = [m - g for m, g in zip(getattr(moco_hist, way),
                                          getattr(hist, way))]
            check(less == [0 if has_pred else pred_b] * len(less),
                  f"{what}: {way} {getattr(hist, way)} against moco_v3's "
                  f"{getattr(moco_hist, way)}")
        fl = FLConfig(num_clients=4, rounds=12, local_epochs=1,
                      schedule="lw_fedssl")
        want = vit_expected_launches(
            ssl_cfg, fl, sched.build_schedule(fl, model_cfg.num_layers),
            [1024] * 4, 256, int(4096 * fl.aux_fraction), engine)
        print(f"  {what}: seconds per round {[round(x, 3) for x in secs]}; "
              f"losses {hist.loss[0]:.4f} -> {hist.loss[-1]:.4f}; wire bytes "
              f"equal analytic bytes in all {len(hist.loss)} rounds, "
              f"{sum(hist.wire_upload_bytes)} up per client ({pred_b} a "
              f"round {'fewer' if not has_pred else 'more'} than moco_v3's: "
              f"{'no ' if not has_pred else ''}prediction head); "
              f"{peak_line(base)}", flush=True)
        check_launches(what, got, want)
        rel, after, uerr, grel, worst = method_step_check(
            model_cfg, ssl_cfg, optimizer, state, images)
        print(f"  {what}: one full-width step on 8 images, fp32, card "
              f"against CPU: loss relative difference {rel:.3e} before the "
              f"step and {after:.3e} after it (tolerance 1e-4 each); "
              f"{optimizer} update of one gradient, largest difference over "
              f"the largest update {uerr:.3e} (tolerance 1e-5); gradient "
              f"relative L2 difference {grel:.3e}, most of it in {worst} "
              f"(not checked)", flush=True)
        check(rel <= 1e-4 and after <= 1e-4 and uerr <= 1e-5,
              f"{what}: card and CPU disagree ({rel}, {after}, {uerr})")
        del state
    return launches


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
            codec="fp32", privacy=None, cfg=None, engine="sequential",
            optimizer="adamw"):
    """LW-FedSSL through ``run_lm_fedssl`` on ``cfg`` (default
    ``lm_config()``) on ``engine`` with ``optimizer``. Returns (cfg, final
    params, history, per-round seconds, plans, each client's local steps a
    round, tokens)."""
    import torch
    from repro_torch.configs.base import FLConfig, TrainConfig
    from repro_torch.core import schedule as sched
    from repro_torch.data.partition import iid_partition
    from repro_torch.federated.driver import run_lm_fedssl
    from repro_torch.models import lm

    cfg = cfg or lm_config()
    fl = FLConfig(num_clients=clients, rounds=rounds, local_epochs=1,
                  schedule="lw_fedssl", seed=seed)
    tc = TrainConfig(batch_size=batch, base_lr=3e-4, optimizer=optimizer)
    toks, labs, params = lm_init(device, cfg, samples, seq_len, seed)
    shards = iid_partition(samples, clients, seed=seed)
    print(f"  {cfg.arch_id}: {cfg.num_layers} blocks in "
          f"{lm.num_stages(cfg)} stages, d {cfg.d_model}, "
          f"{sum(t.numel() for t in params.values())} parameters; {engine} "
          f"engine", flush=True)
    stamps = []

    def log(line):
        stamps.append(time.perf_counter())
        print("  " + line, flush=True)

    t0 = time.perf_counter()
    params, hist = run_lm_fedssl(cfg, fl, tc, tokens=toks, labels=labs,
                                 shards=shards, params=params, device=device,
                                 codec=codec, log=log, privacy=privacy,
                                 engine=engine)
    secs = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    steps = [max(1, len(ix) // batch) * fl.local_epochs for ix in shards]
    return (cfg, params, hist, secs,
            sched.build_schedule(fl, lm.num_stages(cfg)), steps, toks)


def lm_init(device, cfg, samples, seq_len, seed=0):
    """``lm_path``'s tokens, labels and initial parameters, from ``seed``."""
    import torch
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.models import lm

    gen = torch.Generator(device).manual_seed(seed)
    toks, labs = synthetic_tokens(gen, samples, seq_len, cfg.vocab_size)
    return toks, labs, lm.init_lm(cfg, gen, device)


def lm_expected_launches(cfg, plans, steps):
    """(ssd_scan, flash_attention, rope) launches the LM path's plan
    implies: per local step at stage s, s groups of ``attn_every`` scans
    and one attention each, in the online forward (frozen groups included)
    and again in the global model's when the plan aligns; RoPE once an
    attention and once more in the backward of each trained group's (those
    from ``active_from`` up, in the online forward)."""
    scans = attns = ropes = 0
    for plan in plans:
        passes = 2 if plan.align else 1
        s = plan.sub_layers
        for n in steps:
            scans += n * passes * s * cfg.attn_every
            attns += n * passes * s
            ropes += n * (passes * s + s - min(plan.active_from, s))
    return scans, attns, ropes


def lm_pack_checks(params, plans, tag="lm", label="LM", stages=None):
    """gather_pack and scatter_unpack against their plain versions on an
    LM path's own payloads: every distinct download and upload layout of
    ``plans`` over the trained tree (for zamba the (groups, attn_every,
    ...) block stacks, shared_attn, embed, lm_head, final_ln; ``stages``
    maps a zamba2-topology leaf to its stages), bit-identical; unpack of a
    random payload into fresh leaves. Times at the largest payload.
    Returns {name_<tag>: record}."""
    import torch
    from repro_torch.federated.transport import Transport
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(9)
    specs = {}
    for plan in plans:
        for direction, spec in Transport(stages=stages).plan_specs(
                params, plan).items():
            key = (spec.total, tuple(map(tuple, spec.layout)),
                   tuple(s.path for s in spec.slots))
            names = specs.setdefault(key, ([], spec))[0]
            if f"stage {plan.stage} {direction}" not in names:
                names.append(f"stage {plan.stage} {direction}")
    specs = [(" = ".join(names), spec) for names, spec in specs.values()]
    for where, spec in specs:
        leaves = [params["/".join(s.path)] for s in spec.slots]
        flat = ops.wire_pack(leaves, spec.layout, spec.total)
        err = max_err(flat, ref.wire_pack_ref(leaves, spec.layout,
                                              spec.total))
        print(f"  gather_pack {label} {where} ({spec.total} floats in "
              f"{len(spec.slots)} slots): max |kernel - plain| = {err:.3e} "
              f"(tolerance 0)", flush=True)
        check(err == 0.0, f"gather_pack {label} {where}: error {err}")
        del flat
        new = torch.randn(spec.total, generator=gen, device=dev)
        err = max_err(ops.wire_unpack(new, leaves, spec.layout),
                      ref.wire_unpack_ref(new, leaves, spec.layout))
        print(f"  scatter_unpack {label} {where}: max |kernel - plain| = "
              f"{err:.3e} (tolerance 0)", flush=True)
        check(err == 0.0, f"scatter_unpack {label} {where}: error {err}")
        del new
    where, spec = max(specs, key=lambda ws: ws[1].total)
    leaves = [params["/".join(s.path)] for s in spec.slots]
    leaf_bytes = 4 * sum(t.numel() for t in leaves)
    slices = [t.reshape(-1)[a:a + n] for t, (a, _, n) in
              zip(leaves, spec.layout)]
    new = torch.randn(spec.total, generator=gen, device=dev)
    rec = {f"gather_pack_{tag}": dict(
        kernel="gather_pack", max_abs_err=0.0,
        ms=time_ms([lambda: ops.wire_pack(leaves, spec.layout, spec.total)]),
        plain_ms=time_ms([lambda: ref.wire_pack_ref(leaves, spec.layout,
                                                    spec.total)]),
        library_ms=time_ms([lambda: torch.cat(slices)]),
        bound_ms=2 * 4 * spec.total / mesh.HBM_BW * 1e3, bound_by="bytes",
        shape=f"{label} {where} payload {spec.total} fp32 in "
              f"{len(leaves)} slots"),
        f"scatter_unpack_{tag}": dict(
        kernel="scatter_unpack", max_abs_err=0.0,
        ms=time_ms([lambda: ops.wire_unpack(new, leaves, spec.layout)]),
        plain_ms=time_ms([lambda: ref.wire_unpack_ref(new, leaves,
                                                      spec.layout)]),
        library_ms=None,
        bound_ms=2 * leaf_bytes / mesh.HBM_BW * 1e3, bound_by="bytes",
        shape=f"{label} {where} payload {spec.total} fp32 into "
              f"{leaf_bytes // 4} leaf elements")}
    for name, r in rec.items():
        print(f"  {label} shapes, {name} [{r['shape']}]: kernel {r['ms']} ms, "
              f"plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']})", flush=True)
    return rec


# ---------------------------------------------------------------------------
# phase 2i: the dense LM
# ---------------------------------------------------------------------------
# internlm2-1.8b at its published widths, depth cut from 24 blocks to 4
DENSE_ARCH, DENSE_LAYERS = "internlm2-1.8b", 4
DENSE_RUN = dict(clients=4, rounds=4, batch=4, seq_len=1024, samples=64)
# the LM vmap engine against the sequential one: depth 2, batch 2
DENSE_VMAP_LAYERS = 2
DENSE_VMAP_RUN = dict(clients=4, rounds=2, batch=2, seq_len=1024,
                      samples=16)
# bf16 compute: both engines compute each client's step from the same
# parameters and batches, in batched (vmap) or single products summed in
# another order; half a bf16 rounding step (2^-9) of the loss
DENSE_VMAP_RTOL = 2.0 ** -9


def zamba2_pack_checks():
    """``lm_pack_checks`` on Zamba2-7B's stage-3 payloads at the zamba2-7b
    benchmark cell's cut (published widths, layers 0-17, random fp32
    leaves on the card): the download is the whole model, 2,245,451,680
    floats (above 2**31 elements), and the upload the stage's 821,584,352;
    timed at the download."""
    import dataclasses

    import torch
    from repro_torch.configs.base import FLConfig, load_arch
    from repro_torch.core import schedule as sched
    from repro_torch.federated.transport import Transport
    from repro_torch.models import lm

    cfg = dataclasses.replace(load_arch("zamba2-7b"), num_layers=18,
                              hybrid_layer_ids=(6, 11, 17))
    stages = lm.leaf_stages(cfg)
    gen = torch.Generator("cuda").manual_seed(10)
    params = {k: torch.randn(s, generator=gen, device="cuda")
              for k, s in lm.lm_shapes(cfg).items()}
    plans = sched.build_schedule(FLConfig(rounds=3,
                                          rounds_per_stage=(0, 0, 3)),
                                 lm.num_stages(cfg))[:1]
    specs = Transport(stages=stages).plan_specs(params, plans[0])
    check(specs["download"].total == cfg.param_count() > 2 ** 31,
          f"Zamba2-7B stage 3 download: {specs['download'].total} floats, "
          f"not the whole {cfg.param_count()}-float model above 2**31")
    rec = lm_pack_checks(params, plans, "zamba2_7b", "Zamba2-7B", stages)
    del params
    torch.cuda.empty_cache()
    return rec


def dense_config(layers=DENSE_LAYERS, **kw):
    """internlm2-1.8b at its published widths, depth cut to ``layers``
    blocks (one stage each)."""
    from repro_torch.configs.base import load_arch
    return dataclasses.replace(load_arch(DENSE_ARCH), num_layers=layers, **kw)


def dense_expected_launches(plans, steps, engine="sequential", ropes=1):
    """The dense LM path's launches its plan implies: per local step at
    stage s, the online forward runs s blocks (attention and two RMSNorms
    each, the frozen prefix included) and the final RMSNorm, and again the
    global model's where the plan aligns, whose InfoNCE is one forward and
    one dq; the vmap engine launches once a batched step (the largest
    client's step count). Every round packs and unpacks the download once
    and each client's upload once. RoPE: ``ropes`` launches an attention
    (q and k together: 1; MLA's rope parts of q and of k apart: 2), as
    many again in the backward of each trained block's (the online
    forward's blocks from ``active_from`` up)."""
    return stack_expected_launches(plans, steps, engine, norms=2, attns=1,
                                   ropes=ropes)


def stack_expected_launches(plans, steps, engine, *, norms, attns, ropes=1):
    """The launches of an LM path whose stage runs ``norms`` RMSNorms and
    ``attns`` attentions (see ``dense_expected_launches``)."""
    out = dict.fromkeys(("flash_attention", "rmsnorm_rows", "info_nce_rows",
                         "info_nce_rows_dq", "gather_pack", "scatter_unpack",
                         "rope"), 0)
    n = max(steps) if engine == "vmap" else sum(steps)
    for plan in plans:
        passes, s = 1 + plan.align, plan.sub_layers
        trained = s - min(plan.active_from, s)
        out["flash_attention"] += n * passes * s * attns
        out["rope"] += n * (passes * s + trained) * attns * ropes
        out["rmsnorm_rows"] += n * passes * (norms * s + 1)
        out["info_nce_rows"] += n * plan.align
        out["info_nce_rows_dq"] += n * plan.align
        out["gather_pack"] += 1 + len(steps)
        out["scatter_unpack"] += 1 + len(steps)
    return out


def peak_line(base: int) -> str:
    """The device's peak since the last reset, and above ``base`` (what
    the process held before the run: earlier phases' results)."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    return (f"peak device memory {peak / 2**30:.2f} GiB, "
            f"{(peak - base) / 2**30:.2f} GiB above what was held before")


def dense_phase():
    """Phase 2i. Returns {path: launch counts}."""
    import torch
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    cfg, params, hist, secs, plans, steps, toks = lm_path(
        "cuda", cfg=dense_config(), **DENSE_RUN)
    torch.cuda.synchronize()
    launches = {"lm_dense": ops.launch_counts()}
    check(len(hist.loss) == DENSE_RUN["rounds"]
          and hist.round_stage == [p.stage for p in plans],
          f"dense LM rounds {hist.round_stage}")
    check(all(math.isfinite(x) for x in hist.loss),
          f"non-finite dense LM loss: {hist.loss}")
    check(hist.wire_download_bytes == hist.download_bytes
          and hist.wire_upload_bytes == hist.upload_bytes,
          f"dense LM wire bytes {hist.wire_download_bytes} / "
          f"{hist.wire_upload_bytes} differ from the analytic "
          f"{hist.download_bytes} / {hist.upload_bytes}")
    print(f"  dense LM: seconds per round {[round(x, 3) for x in secs]}; "
          f"losses {[round(x, 4) for x in hist.loss]}; wire bytes equal "
          f"analytic bytes in all {len(hist.loss)} rounds: download "
          f"{hist.wire_download_bytes}, upload {hist.wire_upload_bytes} per "
          f"client; {peak_line(base)}", flush=True)
    check_launches("dense LM", launches["lm_dense"],
                   dense_expected_launches(plans, steps))
    check_repeat("dense LM", hist, dense_config(), DENSE_RUN)
    rels = lm_reference_check(params, toks, cfg=cfg)
    print(f"  dense LM lm_ssl_loss at full width, stage 1, 2 x 512 tokens, "
          f"fp32, card against CPU: relative differences {rels} (tolerance "
          f"1e-4)", flush=True)
    check(all(v <= 1e-4 for v in rels.values()),
          "dense LM: card and CPU disagree")
    del params
    runs = {}
    for engine in ("sequential", "vmap"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        vcfg, _, vhist, vsecs, vplans, vsteps, _ = lm_path(
            "cuda", cfg=dense_config(DENSE_VMAP_LAYERS), engine=engine,
            **DENSE_VMAP_RUN)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        runs[engine] = vhist.loss
        print(f"  dense LM, {DENSE_VMAP_LAYERS} blocks, {engine} engine: "
              f"seconds per round {[round(x, 3) for x in vsecs]}; losses "
              f"{vhist.loss}; {peak_line(base)}", flush=True)
        check(vhist.wire_upload_bytes == vhist.upload_bytes,
              f"dense LM {engine}: wire bytes differ from the analytic")
        check_launches(f"dense LM {engine}", got,
                       dense_expected_launches(vplans, vsteps, engine))
        if engine == "vmap":
            launches["lm_vmap"] = got
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["vmap"],
                                                  runs["sequential"]))
    print(f"  dense LM engines: largest relative loss difference {rel:.3e} "
          f"(tolerance {DENSE_VMAP_RTOL:.3e})", flush=True)
    check(rel <= DENSE_VMAP_RTOL,
          f"dense LM engines disagree: {runs['vmap']} / {runs['sequential']}")
    return launches


def check_repeat(what, hist, cfg, run):
    """The LM path ``run`` on ``cfg`` once more from the same seed: its
    losses must be ``hist``'s to the bit."""
    import torch
    torch.cuda.empty_cache()
    again = lm_path("cuda", cfg=cfg, **run)[2]
    print(f"  {what}: the run again from the same seed, losses "
          f"{again.loss} (first run {hist.loss}); bit-identical "
          f"{again.loss == hist.loss}", flush=True)
    check(again.loss == hist.loss,
          f"{what}: losses do not repeat: {again.loss} / {hist.loss}")


def check_launches(what, got, want):
    print(f"  {what}: kernel launches {got}; the plan implies {want}",
          flush=True)
    for name, n in want.items():
        check(got[name] == n, f"{what}: {name} launched {got[name]} times, "
                              f"the plan implies {n}")


# ---------------------------------------------------------------------------
# phase 2j: the xLSTM LM
# ---------------------------------------------------------------------------
# xlstm-125m at its published widths and depth: 12 blocks in 2 groups of 5
# mLSTM + 1 sLSTM, no cut; 2 rounds, one a stage: the phase is host-bound
# by the sLSTM's eager loop, and 4 rounds took the script past 700 s
XLSTM_ARCH = "xlstm-125m"
XLSTM_RUN = dict(clients=4, rounds=2, batch=4, seq_len=1024, samples=64)
# its parameters by the reference's init_lm (its config's param_count()
# says 133,926,912)
XLSTM_PARAMS = 190670672
# bf16 compute: both engines compute each client's step from the same
# parameters and batches, in batched (vmap) or single products summed in
# another order. The losses measured 5.2e-5 to 9.2e-5 apart (relative) on
# an H100. The runs' parameter updates (``update_gap``) measured 0.101
# apart there: AdamW moves each element by about its rate whatever the
# gradient's size, so the elements whose gradient is near bf16 rounding
# noise move apart. A vmap engine that drops each client's last step
# measured 0.241 (the reduced xLSTM in bf16 on the CPU, where the sound
# engines are 0.0065 apart), so the limit sits between
XLSTM_VMAP_RTOL = 5e-4
XLSTM_VMAP_UPDATE_GAP = 0.17


def xlstm_config(**kw):
    from repro_torch.configs.base import load_arch
    return dataclasses.replace(load_arch(XLSTM_ARCH), **kw)


def xlstm_expected_launches(cfg, plans, steps, engine="sequential"):
    """The xLSTM path's launches its plan implies: a stage is one group of
    ``slstm_every - 1`` mLSTM blocks (two RMSNorms each: the block's and
    the inner norm at d_inner) and one sLSTM block (one RMSNorm; its
    LayerNorm is plain PyTorch, as in the reference), no attention; the
    rest as ``dense_expected_launches``."""
    per = cfg.xlstm.slstm_every
    return stack_expected_launches(plans, steps, engine,
                                   norms=2 * (per - 1) + 1, attns=0)


def stage2_step(cfg, params, tokens, batch):
    """A closure running one stage-2 local step (``lm_train_step`` with the
    alignment, group 1 frozen) from ``params`` on the first ``batch``
    sequences; it returns (new params, metrics)."""
    import torch
    from repro_torch.federated.client import lm_train_step
    from repro_torch.core.ssl import ALIGN_WEIGHT
    from repro_torch.optim import make_optimizer
    from repro_torch.configs.base import TrainConfig

    opt = make_optimizer(TrainConfig(batch_size=batch))
    tok = tokens[:batch]
    b = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}

    def step():
        new, _, metrics = lm_train_step(
            params, opt.init(params), b, 1e-5, cfg=cfg, opt=opt,
            sub_layers=2, active_from=1, global_params=params,
            align_weight=ALIGN_WEIGHT)
        return new, metrics
    return step


def check_step_repeat(what, step):
    """``step`` twice from the same state: the loss and every updated
    parameter must repeat to the bit."""
    import torch
    (p1, m1), (p2, m2) = step(), step()
    same = (float(m1["loss"]) == float(m2["loss"])
            and all(torch.equal(p1[k], p2[k]) for k in p1))
    print(f"  {what}: one stage-2 local step twice from the same state, "
          f"loss {float(m1['loss'])} / {float(m2['loss'])}; loss and all "
          f"{len(p1)} updated leaves bit-identical {same}", flush=True)
    check(same, f"{what}: the local step does not repeat")


def slstm_share(cfg, params, step, batch, seq_len, dev="cuda"):
    """The share of one stage-2 local step (``step``, from
    ``stage2_step``) that the step's four sLSTM layer calls take, by CUDA
    events: the frozen group's and the global model's two forwards without
    gradient, and the trained group's forward and backward, each timed
    alone at the step's shapes. Returns (step ms, sLSTM ms, share)."""
    import torch
    from repro_torch.convert import subtree
    from repro_torch.models import blocks

    sp = {k: v[1] for k, v in subtree(params, "slstm").items()}
    gen = torch.Generator(dev).manual_seed(4)
    x = torch.randn((batch, seq_len, cfg.d_model), generator=gen,
                    device=dev)

    def fwd():
        with torch.no_grad():
            blocks.block_apply(sp, x, cfg, "slstm")

    def fwd_bwd():
        p = {k: v.detach().requires_grad_() for k, v in sp.items()}
        xr = x.detach().requires_grad_()
        out, _ = blocks.block_apply(p, xr, cfg, "slstm")
        torch.autograd.grad(out.float().sum(), [xr, *p.values()])

    def ms(fn, reps=2):
        fn()
        torch.cuda.synchronize()
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return a.elapsed_time(e) / reps

    t_step, t_fwd, t_both = ms(step), ms(fwd), ms(fwd_bwd)
    t_slstm = 3 * t_fwd + t_both
    return t_step, t_slstm, t_slstm / t_step


def update_gap(init, got, want) -> float:
    """How far two runs from ``init`` moved apart: the L1 norm of ``got -
    want`` over that of ``want - init``, on what no stage's weight transfer
    overwrites (every leaf outside ``TRANSFER_STACKS`` and the stacks'
    first row), so that ``want - init`` is training alone. L1, because
    AdamW moves an element whose gradient is rounding noise by up to its
    rate either way: the few such elements weigh on an L2 norm."""
    from repro_torch.core.schedule import TRANSFER_STACKS
    heads = tuple(f"{s}/" for s in TRANSFER_STACKS)
    num = den = 0.0
    for k in want:
        g, w, i = (t[k][:1] if k.startswith(heads) else t[k]
                   for t in (got, want, init))
        num += float((g.double() - w.double()).abs().sum())
        den += float((w.double() - i.double()).abs().sum())
    return num / den


def xlstm_phase(dev="cuda"):
    """Phase 2j. Returns ({path: launch counts}, {name: kernel record at
    the xLSTM's payloads})."""
    import torch
    from repro_torch.kernels import ops

    launches, runs, finals, rec = {}, {}, {}, {}
    for engine in ("sequential", "vmap"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        cfg, params, hist, secs, plans, steps, toks = lm_path(
            dev, cfg=xlstm_config(), engine=engine, **XLSTM_RUN)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        n_params = sum(t.numel() for t in params.values())
        check(n_params == XLSTM_PARAMS, f"{cfg.arch_id} holds {n_params} "
                                        f"parameters, not {XLSTM_PARAMS}")
        path = "lm_xlstm" if engine == "sequential" else "lm_xlstm_vmap"
        launches[path] = got
        runs[engine] = hist.loss
        finals[engine] = params
        check(len(hist.loss) == XLSTM_RUN["rounds"]
              and hist.round_stage == [p.stage for p in plans],
              f"xLSTM rounds {hist.round_stage}")
        check(all(math.isfinite(x) for x in hist.loss),
              f"non-finite xLSTM loss: {hist.loss}")
        check(hist.wire_download_bytes == hist.download_bytes
              and hist.wire_upload_bytes == hist.upload_bytes,
              f"xLSTM {engine}: wire bytes differ from the analytic")
        print(f"  xLSTM, {engine} engine: seconds per round "
              f"{[round(x, 3) for x in secs]}; losses {hist.loss}; wire bytes "
              f"equal analytic bytes in all {len(hist.loss)} rounds: "
              f"download {hist.wire_download_bytes}, upload "
              f"{hist.wire_upload_bytes} per client; {peak_line(base)}",
              flush=True)
        want = xlstm_expected_launches(cfg, plans, steps, engine)
        check_launches(f"xLSTM {engine}", got, want)
        check(got["flash_attention"] == 0,
              "attention launched on the xLSTM path")
        if engine == "sequential":
            rels = lm_reference_check(params, toks, cfg=cfg)
            print(f"  xLSTM lm_ssl_loss at full width, stage 1, 2 x 512 "
                  f"tokens (the chunkwise mLSTM, 2 chunks), fp32, card "
                  f"against CPU: relative differences {rels} (tolerance "
                  f"1e-4)", flush=True)
            check(all(v <= 1e-4 for v in rels.values()),
                  "xLSTM: card and CPU disagree")
            # the run's own repeat is 2d's and 2i's (the same driver);
            # here the xLSTM's step, whose sLSTM loop dominates the phase
            step = stage2_step(cfg, params, toks, XLSTM_RUN["batch"])
            check_step_repeat("xLSTM", step)
            t_step, t_slstm, share = slstm_share(
                cfg, params, step, XLSTM_RUN["batch"], XLSTM_RUN["seq_len"],
                dev)
            del step
            print(f"  xLSTM stage-2 local step (batch "
                  f"{XLSTM_RUN['batch']} x {XLSTM_RUN['seq_len']}, with the "
                  f"alignment): {t_step:.2f} ms; its four sLSTM layer calls "
                  f"(3 forwards without gradient, 1 forward and backward), "
                  f"timed alone: {t_slstm:.2f} ms, {100 * share:.1f}% of "
                  f"the step", flush=True)
            rec = lm_pack_checks(params, plans, "xlstm", "xLSTM")
        del params
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["vmap"],
                                                  runs["sequential"]))
    print(f"  xLSTM engines: largest relative loss difference {rel:.3e} "
          f"(tolerance {XLSTM_VMAP_RTOL:.3e})", flush=True)
    check(rel <= XLSTM_VMAP_RTOL,
          f"xLSTM engines disagree: {runs['vmap']} / {runs['sequential']}")
    init = lm_init(dev, cfg, XLSTM_RUN["samples"], XLSTM_RUN["seq_len"])[2]
    gap = update_gap(init, finals["vmap"], finals["sequential"])
    print(f"  xLSTM engines: parameter updates over the run apart by "
          f"{gap:.4e} of the sequential update's L1 norm (tolerance "
          f"{XLSTM_VMAP_UPDATE_GAP})", flush=True)
    check(gap <= XLSTM_VMAP_UPDATE_GAP,
          f"xLSTM engines' updates {gap} apart")
    return launches, rec


# ---------------------------------------------------------------------------
# phase 2k: the encoder-decoder
# ---------------------------------------------------------------------------
# seamless-m4t-medium at its published widths: (a) full depth (12 encoder +
# 12 decoder blocks), one client's train_lw step; (b) the round program at
# 4 + 4 blocks (depth cut to fit two clients' vmap step on one card)
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_STEP = dict(batch=2, seq_len=1024, steps=3)
ENCDEC_ROUNDS = dict(layers=4, clients=2, rounds=4, batch=2, seq_len=1024,
                     samples=16)
# the parameters of (a) and (b), by the reference's init_encdec
ENCDEC_PARAMS = (977758208, 675727360)


def encdec_config(layers=None, **kw):
    from repro_torch.configs.base import load_arch
    cfg = load_arch(ENCDEC_ARCH)
    if layers is not None:
        kw = dict(num_layers=layers, dec_layers=layers, **kw)
    return dataclasses.replace(cfg, **kw)


def encdec_data(cfg, n, seq_len, gen):
    """n token sequences and n x frontend_embed_len frame embeddings."""
    import torch
    from repro_torch.data.synthetic import synthetic_tokens
    toks, labs = synthetic_tokens(gen, n, seq_len, cfg.vocab_size)
    frames = torch.randn((n, cfg.frontend_embed_len, cfg.d_model),
                         generator=gen, device=toks.device)
    return {"tokens": toks, "labels": labs, "frontend": frames}


class AttentionKinds:
    """Counts the encoder-decoder's attention calls by kind while it is
    entered, by wrapping ``ops.flash_attention``: causal (the decoder's
    self-attention), non-causal over as many keys as queries (the
    encoder's) and non-causal over another count (cross attention). Each
    call launches the kernel once on the card, under vmap too."""

    def __init__(self):
        self.counts = dict.fromkeys(("encoder", "decoder_self", "cross"), 0)

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops, self._orig = ops, ops.flash_attention

        def counted(q, k, v, **kw):
            kind = ("decoder_self" if kw.get("causal", True) else
                    "encoder" if q.shape[-3] == k.shape[-3] else "cross")
            self.counts[kind] += 1
            return self._orig(q, k, v, **kw)

        ops.flash_attention = counted
        return self

    def __exit__(self, *exc):
        self._ops.flash_attention = self._orig


def encdec_expected_launches(cfg, plans, steps):
    """The round program's launches its plan implies, per batched step at
    stage s (every client's step at once, ``max(steps)`` a round): the
    loss encodes s blocks (an attention and two RMSNorms each, then the
    encoder's RMSNorm) and, where the plan aligns, encodes again from the
    local and from the global parameters (as the reference does); the
    decoder runs every block once (self-attention, cross attention, three
    RMSNorms) and the final RMSNorm; the alignment is one InfoNCE forward
    and one dq. Every round packs and unpacks the download once and each
    client's upload once. RoPE launches once an encoder or decoder
    self-attention (q and k together; cross attention has none), and once
    more in the backward of each trained one: the decoder's, and the
    encoder's from ``active_from`` up in the loss's encode and in the
    alignment's local one."""
    L = cfg.dec_layers
    out = dict.fromkeys(("encoder", "decoder_self", "cross", "rmsnorm_rows",
                         "info_nce_rows", "info_nce_rows_dq", "gather_pack",
                         "scatter_unpack", "rope"), 0)
    n = max(steps)
    for plan in plans:
        passes, s = 1 + 2 * plan.align, plan.sub_layers
        trained = (1 + plan.align) * (s - min(plan.active_from, s))
        out["encoder"] += n * passes * s
        out["decoder_self"] += n * L
        out["cross"] += n * L
        out["rope"] += n * (passes * s + trained + 2 * L)
        out["rmsnorm_rows"] += n * (passes * (2 * s + 1) + 3 * L + 1)
        out["info_nce_rows"] += n * plan.align
        out["info_nce_rows_dq"] += n * plan.align
        out["gather_pack"] += 1 + len(steps)
        out["scatter_unpack"] += 1 + len(steps)
    return out


def encdec_phase(dev="cuda"):
    """Phase 2k. Returns ({path: launch counts}, {name: kernel record at
    the 4 + 4 encoder-decoder's payloads})."""
    import torch
    from repro_torch.configs.base import FLConfig, TrainConfig
    from repro_torch.core import schedule as sched
    from repro_torch.data.partition import iid_partition, stack_shards
    from repro_torch.federated import aggregate, comm
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.federated.engine import lm_batch_indices, lm_batch_plan
    from repro_torch.federated.transport import Transport
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import encdec
    from repro_torch.optim.schedules import learning_rate, scaled_base_lr

    # (a) make_train_step at full depth
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = encdec_config()
    gen = torch.Generator(dev).manual_seed(0)
    params = encdec.init_encdec(cfg, gen, dev)
    n_params = sum(t.numel() for t in params.values())
    print(f"  (a) {cfg.arch_id}: {cfg.num_layers} encoder + "
          f"{cfg.dec_layers} decoder blocks, d {cfg.d_model}, {n_params} "
          f"parameters; make_train_step (train_lw: the last encoder block "
          f"trained, alignment on the encoder memory), AdamW, batch "
          f"{ENCDEC_STEP['batch']} x {ENCDEC_STEP['seq_len']} tokens + "
          f"{cfg.frontend_embed_len} frames", flush=True)
    check(n_params == ENCDEC_PARAMS[0], f"seamless-m4t-medium holds "
                                        f"{n_params} parameters, not "
                                        f"{ENCDEC_PARAMS[0]}")
    B = ENCDEC_STEP["batch"]
    data = encdec_data(cfg, B * ENCDEC_STEP["steps"], ENCDEC_STEP["seq_len"],
                       gen)
    step, opt = lsteps.make_train_step(cfg, TrainConfig(batch_size=B),
                                       mode="train_lw", lr=1e-4)
    p, o = params, opt.init(params)
    losses, times = [], []
    for i in range(ENCDEC_STEP["steps"]):
        batch = {k: v[i * B:(i + 1) * B] for k, v in data.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(p, o, batch, params)
        losses.append(float(m["loss"]))
        times.append(1e3 * (time.perf_counter() - t0))
    trained = [k for k, v in p.items() if not torch.equal(v, params[k])]
    finite = all(bool(torch.isfinite(v).all()) for v in p.values())
    print(f"  (a) losses {losses}; ms per step {[round(t, 1) for t in times]}"
          f"; {len(trained)} leaves updated, all finite {finite}; "
          f"{peak_line(base)}", flush=True)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(finite and trained, "the full-depth step left non-finite or no "
                              "updated parameters")
    del p, o, params, data, step, opt
    torch.cuda.empty_cache()

    # (b) make_fl_round_program at 4 + 4 blocks, LW-FedSSL over the wire
    R = ENCDEC_ROUNDS
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = encdec_config(R["layers"])
    gen = torch.Generator(dev).manual_seed(1)
    params = encdec.init_encdec(cfg, gen, dev)
    n_params = sum(t.numel() for t in params.values())
    S = ssl_mod.lm_stages(cfg)
    print(f"  (b) {cfg.arch_id} cut to {cfg.num_layers} + {cfg.dec_layers} "
          f"blocks (from 12 + 12; widths unchanged): {n_params} parameters, "
          f"{S} stages; make_fl_round_program, {R['clients']} clients, "
          f"{R['rounds']} rounds of LW-FedSSL, batch {R['batch']} x "
          f"{R['seq_len']} tokens + {cfg.frontend_embed_len} frames, "
          f"{R['samples']} samples a client, fp32 wire", flush=True)
    check(n_params == ENCDEC_PARAMS[1], f"the 4 + 4 cut holds {n_params} "
                                        f"parameters, not {ENCDEC_PARAMS[1]}")
    n = R["clients"] * R["samples"]
    data = encdec_data(cfg, n, R["seq_len"], gen)
    shards = iid_partition(n, R["clients"], seed=0)
    pool = {k: stack_shards(v, shards)[0] for k, v in data.items()}
    starts = lm_batch_plan([len(ix) for ix in shards], R["batch"], 1)
    batch_idx = lm_batch_indices(starts, R["batch"]).to(dev)
    valid = torch.tensor([[t < len(s) for t in range(batch_idx.shape[1])]
                          for s in starts], device=dev)
    nsteps = [len(s) for s in starts]
    fl = FLConfig(num_clients=R["clients"], rounds=R["rounds"],
                  local_epochs=1, schedule="lw_fedssl")
    tc = TrainConfig(batch_size=R["batch"], base_lr=3e-4)
    plans = sched.build_schedule(fl, S)
    base_lr = scaled_base_lr(tc.base_lr, tc.batch_size)
    w = aggregate.client_weights([len(ix) for ix in shards])
    wire = Transport("fp32")
    secs, losses = [], []
    ops.reset_launch_counts()
    with AttentionKinds() as kinds:
        for plan in plans:
            t0 = time.perf_counter()
            if plan.new_stage:
                params = sched.transfer_model(params, plan.stage)
            lr = learning_rate(plan.round_idx, fl.rounds, base_lr,
                               tc.lr_schedule)
            dparams, down = wire.broadcast(params, plan)
            round_fn, _ = lsteps.make_fl_round_program(
                cfg, tc, sub_layers=plan.sub_layers,
                active_from=plan.active_from, align=plan.align,
                transport=wire, plan=plan)
            params, lvec, up = round_fn(
                {"params": dparams, "server": params,
                 "global_params": dparams if plan.align else None},
                pool, batch_idx, valid, w, lr)
            cb = comm.round_comm_bytes(params, plan)
            losses.append(lvec.tolist())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check(down["wire_bytes"] == cb["download"]
                  and up["wire_bytes"] == cb["upload"],
                  f"encoder-decoder round {plan.round_idx + 1}: wire bytes "
                  f"{down['wire_bytes']} / {up['wire_bytes']}, analytic "
                  f"{cb['download']} / {cb['upload']}")
            print(f"  (b) round {plan.round_idx + 1} stage {plan.stage}: "
                  f"client losses {lvec.tolist()}; wire bytes equal analytic:"
                  f" download {cb['download']}, upload {cb['upload']}; "
                  f"{secs[-1]:.3f} s", flush=True)
    torch.cuda.synchronize()
    got = {**ops.launch_counts(), **kinds.counts}
    print(f"  (b) {peak_line(base)}", flush=True)
    check(all(math.isfinite(x) for r in losses for x in r),
          f"non-finite encoder-decoder losses {losses}")
    want = encdec_expected_launches(cfg, plans, nsteps)
    check_launches("encoder-decoder", got, want)
    check(got["flash_attention"] == sum(kinds.counts.values()),
          "attention launches and calls differ")

    # encdec_loss with alignment, card against CPU at fp32
    rels = encdec_reference_check(params, data, cfg)
    print(f"  encdec_loss with alignment, {cfg.num_layers} + "
          f"{cfg.dec_layers} blocks at full width, the last encoder stage, "
          f"2 x 256 tokens + {cfg.frontend_embed_len} frames, fp32, card "
          f"against CPU: relative differences {rels} (tolerance 1e-4)",
          flush=True)
    check(all(v <= 1e-4 for v in rels.values()),
          "encoder-decoder: card and CPU disagree")
    return {"encdec": got}, lm_pack_checks(params, plans, "encdec",
                                           "encoder-decoder")


def encdec_reference_check(params, data, cfg, n=2, seq=256):
    """``launch.steps``' encoder-decoder loss (``encdec_loss`` plus the
    alignment on the mean-pooled encoder memory) at the last stage of
    ``cfg``, fp32 compute, on ``n`` x ``seq`` tokens and the frames: kernels
    on the card against the plain versions on the CPU; the global model is
    the trained one nudged as in ``lm_reference_check``. Returns {metric:
    relative difference}."""
    import torch
    from repro_torch.core import ssl as ssl_mod

    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    S = ssl_mod.lm_stages(cfg)
    gen = torch.Generator("cpu").manual_seed(3)
    local = {k: v.cpu() for k, v in params.items()}
    glob = {k: v + 1e-3 * v.std() * torch.randn(v.shape, generator=gen)
            if v.numel() > 1 else v for k, v in local.items()}
    batch = {"tokens": data["tokens"][:n, :seq].cpu(),
             "labels": data["labels"][:n, :seq].cpu(),
             "frontend": data["frontend"][:n].cpu()}
    out = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            _, m = ssl_mod.lm_loss(
                cfg, {k: v.to(dev) for k, v in local.items()},
                {k: v.to(dev) for k, v in batch.items()}, sub_layers=S,
                active_from=S - 1,
                global_params={k: v.to(dev) for k, v in glob.items()},
                align_weight=ssl_mod.ALIGN_WEIGHT, remat=False)
        out[dev] = {k: float(v) for k, v in m.items() if k != "aux"}
    print(f"  card {out['cuda']}, CPU {out['cpu']}", flush=True)
    return {k: abs(out["cuda"][k] - v) / max(abs(v), 1e-12)
            for k, v in out["cpu"].items()}


# ---------------------------------------------------------------------------
# phase 2l: the MoE and MLA families
# ---------------------------------------------------------------------------
# deepseek-v2-236b at its published widths (MLA, 2 shared + routed experts
# of width 1536, top-6), depth cut from 60 blocks to 2 (2 stages) and the
# routed experts from 160 to 8; Adafactor, its TRAIN's optimizer
MOE_ARCH, MOE_LAYERS, MOE_EXPERTS = "deepseek-v2-236b", 2, 8
MOE_RUN = dict(clients=2, rounds=2, batch=2, seq_len=1024, samples=8,
               optimizer="adafactor")
# per block 149,225,472 MLA + 235,970,560 MoE + 10,240 norms; embedding and
# head 2 x 524,288,000; final norm 5,120
MOE_PARAMS = 1818993664
# the launcher's reduced() MoE archs, each on both engines
LAUNCHER_MOE_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
LAUNCHER_MOE_ARGS = ("--mode", "lm", "--rounds", "2", "--clients", "2",
                     "--batch", "4", "--samples", "16", "--seq-len", "64")
# the engines' fp32 losses at reduced(): the same steps, batched (vmap) or
# one client at a time, summed in another order on the card
LAUNCHER_ENGINE_RTOL = 1e-4


def moe_config():
    """deepseek-v2-236b at its published widths, ``MOE_LAYERS`` blocks (one
    stage each) of ``MOE_EXPERTS`` routed experts."""
    from repro_torch.configs.base import load_arch
    cfg = load_arch(MOE_ARCH)
    return dataclasses.replace(
        cfg, num_layers=MOE_LAYERS,
        moe=dataclasses.replace(cfg.moe, num_experts=MOE_EXPERTS))


def moe_phase():
    """Phase 2l (a): deepseek-v2 through ``run_lm_fedssl``. Returns {path:
    launch counts}."""
    import torch
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    cfg, params, hist, secs, plans, steps, toks = lm_path(
        "cuda", cfg=moe_config(), **MOE_RUN)
    torch.cuda.synchronize()
    launches = {"lm_moe": ops.launch_counts()}
    n_params = sum(t.numel() for t in params.values())
    check(n_params == MOE_PARAMS,
          f"{cfg.arch_id} holds {n_params} parameters, not {MOE_PARAMS}")
    check(len(hist.loss) == MOE_RUN["rounds"]
          and hist.round_stage == [p.stage for p in plans],
          f"MoE LM rounds {hist.round_stage}")
    check(all(math.isfinite(x) for x in hist.loss),
          f"non-finite MoE LM loss: {hist.loss}")
    check(hist.wire_download_bytes == hist.download_bytes
          and hist.wire_upload_bytes == hist.upload_bytes,
          f"MoE LM wire bytes {hist.wire_download_bytes} / "
          f"{hist.wire_upload_bytes} differ from the analytic "
          f"{hist.download_bytes} / {hist.upload_bytes}")
    print(f"  MoE LM: seconds per round {[round(x, 3) for x in secs]}; "
          f"losses {hist.loss}; wire bytes equal analytic bytes in all "
          f"{len(hist.loss)} rounds: download {hist.wire_download_bytes}, "
          f"upload {hist.wire_upload_bytes} per client; {peak_line(base)}",
          flush=True)
    # a block is an MLA attention and two RMSNorms, as a dense block; MLA
    # rotates the rope parts of q and of k in a launch each
    check_launches("MoE LM", launches["lm_moe"],
                   dense_expected_launches(plans, steps, ropes=2))
    check_repeat("MoE LM", hist, moe_config(), MOE_RUN)
    rels = lm_reference_check(params, toks, seq=256, cfg=cfg)
    print(f"  MoE LM lm_ssl_loss at full width, stage 1, 2 x 256 tokens, "
          f"fp32, card against CPU: relative differences {rels} (tolerance "
          f"1e-4)", flush=True)
    check(all(v <= 1e-4 for v in rels.values()),
          "MoE LM: card and CPU disagree")
    return launches


def launcher_moe_runs():
    """Phase 2l (b): ``python -m repro_torch.launch.train --mode lm`` for
    each of ``LAUNCHER_MOE_ARCHS`` on both engines, on the card at the
    launcher's ``reduced()`` configs, the four processes at once: each
    exits 0 with a finite final loss, and the engines' losses agree."""
    import torch
    torch.cuda.empty_cache()        # the card's memory for the four
    procs = {}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for arch in LAUNCHER_MOE_ARCHS:
        for engine in ("sequential", "vmap"):
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   *LAUNCHER_MOE_ARGS, "--arch", arch, "--engine", engine]
            procs[arch, engine] = subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    losses = {}
    for (arch, engine), proc in procs.items():
        out, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"the launcher on {arch} ({engine}) "
                                    f"exited {proc.returncode}: {err[-3000:]}")
        rounds = [float(ln.split(" loss ")[1].split()[0])
                  for ln in out.splitlines() if ln.startswith("round ")]
        final = [ln for ln in out.splitlines() if ln.startswith("final loss")]
        check(len(rounds) == 2 and all(math.isfinite(x) for x in rounds)
              and final, f"the launcher on {arch} ({engine}): {out[-2000:]}")
        losses[arch, engine] = rounds
        print(f"  --arch {arch} --engine {engine}: round losses {rounds}; "
              f"{final[0]}", flush=True)
    for arch in LAUNCHER_MOE_ARCHS:
        a, b = losses[arch, "vmap"], losses[arch, "sequential"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        print(f"  {arch}: the engines' losses {rel:.3e} apart (relative; "
              f"tolerance {LAUNCHER_ENGINE_RTOL:g}, as printed to 4 "
              f"decimals)", flush=True)
        check(rel <= LAUNCHER_ENGINE_RTOL,
              f"{arch}: the launcher's engines disagree: {a} / {b}")


# ---------------------------------------------------------------------------
# phase 2m: serving
# ---------------------------------------------------------------------------
# (a) the entry point at internlm2-1.8b's published widths and depth: 64
# prompt tokens stepped through the decoder, then 64 generated, batch 4
SERVE_ARCH = "internlm2-1.8b"
SERVE_RUN = dict(batch=4, prompt_len=64, gen=64)
# its parameters: 630,736,896 at 4 blocks (phase 2i) + 20 x 62,918,656
SERVE_PARAMS = 1889110016
# decode against the full-sequence forward at fp32 (TF32 off), and the
# card's decode against the CPU's: the same math summed in another order
# (one position's products against the whole sequence's, the kernels
# against the plain versions), through up to 54 blocks; relative to the
# largest logit
SERVE_RTOL = 1e-4
# (b), (c): the tokens stepped
SERVE_CHECK = dict(batch=2, tokens=32)
# (d) the ring buffer: a window of 16 slots at 2 blocks, 48 steps
RING = dict(window=16, layers=2, steps=48)


def serve_expected_launches(cfg, steps):
    """The serving path's launches: a step runs every block once at S = 1
    (one attention, its RoPE of q and k, and two RMSNorms a dense block)
    and the final RMSNorm; no other kernel."""
    out = dict.fromkeys(("gather_pack", "scatter_unpack", "info_nce_rows",
                         "info_nce_rows_dq", "info_nce_rows_dk",
                         "ssd_scan"), 0)
    out["flash_attention"] = out["rope"] = steps * cfg.num_layers
    out["rmsnorm_rows"] = steps * (2 * cfg.num_layers + 1)
    return out


def decode_logits(cfg, params, toks, memory=None, seq_len=None):
    """The decoder stepped over ``toks`` (B, S) one position a step from
    fresh caches of ``seq_len`` (default S) slots; (B, S, V) fp32."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import encdec, lm

    B, S = toks.shape
    dev = toks.device
    if memory is None:
        caches = lm.init_caches(cfg, B, seq_len or S, device=dev)
    else:
        caches = encdec.init_dec_caches(cfg, B, seq_len or S, device=dev)
    step = steps.make_decode_step(cfg)
    extra = () if memory is None else (memory,)
    outs = []
    for t in range(S):
        logits, caches = step(params, caches, toks[:, t:t + 1], t, *extra)
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1)


def forward_logits(cfg, params, toks, memory=None):
    """The full-sequence forward's logits at every position, (B, S, V)
    fp32: ``forward_hidden`` (or the encoder-decoder's ``decode_train``)
    and the head, in the compute dtype as the decode step computes them."""
    import torch
    from repro_torch.models import encdec, lm

    cdt = getattr(torch, cfg.compute_dtype)
    with torch.no_grad():
        if memory is None:
            hidden, _ = lm.forward_hidden(params, lm.embed(params, toks, cfg),
                                          cfg)
            head = lm._head_matrix(params, cfg)
        else:
            hidden = encdec.decode_train(params, toks, memory, cfg)
            head = params["lm_head"]
        return (hidden.to(cdt) @ head.to(cdt)).to(torch.float32)


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def no_drop(cfg):
    """``cfg`` with a MoE capacity factor of twice E / k: every expert can
    take every token of a row, so the forward's capacity dispatch drops
    none and equals the decode's dense experts (the reference's decode
    parity test does the same)."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=2.0 * m.num_experts / m.experts_per_token))


def serve_phase():
    """Phase 2m. Returns {"serve": launch counts of (a)}."""
    import torch
    from repro_torch.configs.base import load_arch, reduced
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import encdec, lm

    dev = torch.device("cuda")
    # (a) the entry point, through its main
    cfg = serve.serve_config(SERVE_ARCH, full=True)
    n_params = sum(math.prod(s) for s in lm.lm_shapes(cfg).values())
    check(n_params == SERVE_PARAMS,
          f"{SERVE_ARCH} holds {n_params} parameters, not {SERVE_PARAMS}")
    argv = ["--arch", SERVE_ARCH, "--full", "--batch",
            str(SERVE_RUN["batch"]), "--prompt-len",
            str(SERVE_RUN["prompt_len"]), "--gen", str(SERVE_RUN["gen"])]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, tps = serve.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"serve": ops.launch_counts()}
    check(tokens.shape == (SERVE_RUN["gen"], SERVE_RUN["batch"])
          and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size,
          f"served tokens {tokens.shape}, range {int(tokens.min())}.."
          f"{int(tokens.max())}")
    steps = SERVE_RUN["prompt_len"] + SERVE_RUN["gen"]
    print(f"  (a) python -m repro_torch.launch.serve {' '.join(argv)}: "
          f"{SERVE_ARCH}, {cfg.num_layers} blocks, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
          f"{cfg.compute_dtype} compute, {n_params} parameters; "
          f"{tps:.1f} tok/s, {SERVE_RUN['batch'] * 1e3 / tps:.3f} ms a "
          f"decode step; {secs:.1f}s in all (parameters, {steps} steps); "
          f"{peak_line(base)}", flush=True)
    check_launches("serve", launches["serve"],
                   serve_expected_launches(cfg, steps))
    # where a decode step's time goes: its wall time against the device's
    # busy time (torch.profiler), at the position after the prompt
    params = lm.init_lm(cfg, torch.Generator(dev).manual_seed(0), dev)
    caches = lm.init_caches(cfg, SERVE_RUN["batch"], steps, device=dev)
    tok = torch.zeros((SERVE_RUN["batch"], 1), dtype=torch.long, device=dev)
    profile_device(lambda: lm.decode_step(params, caches, tok,
                                          SERVE_RUN["prompt_len"], cfg),
                   f"(a) one decode step of {SERVE_ARCH}, batch "
                   f"{SERVE_RUN['batch']}, at position "
                   f"{SERVE_RUN['prompt_len']}", 8)
    del params, caches

    # (b) decode against forward at full width and depth, fp32
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    g = torch.Generator(dev).manual_seed(11)
    params = lm.init_lm(cfg32, g, dev)
    toks = torch.randint(0, cfg.vocab_size,
                         (SERVE_CHECK["batch"], SERVE_CHECK["tokens"]),
                         generator=g, device=dev)
    dec = decode_logits(cfg32, params, toks)
    err = rel_err(dec, forward_logits(cfg32, params, toks))
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    err16 = rel_err(decode_logits(cfg16, params, toks),
                    forward_logits(cfg16, params, toks))
    two = dataclasses.replace(cfg32, num_layers=2)
    p2 = {k: v[:2] if k.startswith("blocks/") else v
          for k, v in params.items()}
    cpu = decode_logits(two, {k: v.cpu() for k, v in p2.items()},
                        toks.cpu())
    err_cpu = rel_err(decode_logits(two, p2, toks).cpu(), cpu)
    print(f"  (b) {SERVE_ARCH} at {cfg.num_layers} blocks, "
          f"{SERVE_CHECK['batch']} x {SERVE_CHECK['tokens']} tokens: decode "
          f"against forward_hidden's logits, fp32 {err:.3e} (tolerance "
          f"{SERVE_RTOL:g}), bf16 {err16:.3e} (not checked); at 2 blocks, "
          f"card against CPU fp32 {err_cpu:.3e} (tolerance {SERVE_RTOL:g}); "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    check(err <= SERVE_RTOL and err_cpu <= SERVE_RTOL,
          f"{SERVE_ARCH}: decode {err} from the forward, {err_cpu} from the "
          f"CPU")
    del params, p2, dec
    torch.cuda.empty_cache()

    # (c) every other family's decode against its own forward, fp32
    def capacity_cut(c):
        return (f"capacity factor {c.moe.capacity_factor:g} -> "
                f"{no_drop(c).moe.capacity_factor:.4g} so that no token "
                f"drops")

    llama4 = reduced(load_arch("llama4-maverick-400b-a17b"))
    families = (
        ("zamba2-2.7b", load_arch("zamba2-2.7b"), "published widths and "
         "depth, no cut"),
        ("xlstm-125m", load_arch("xlstm-125m"), "published widths and depth, "
         "no cut"),
        (MOE_ARCH, no_drop(moe_config()), f"phase 2l's cut, {MOE_LAYERS} "
         f"blocks of {MOE_EXPERTS} routed experts; "
         f"{capacity_cut(moe_config())}"),
        ("llama4-maverick-400b-a17b", no_drop(llama4),
         f"reduced(); {capacity_cut(llama4)}"),
        (ENCDEC_ARCH, load_arch(ENCDEC_ARCH), "published widths and depth, "
         f"{load_arch(ENCDEC_ARCH).frontend_embed_len} frames"))
    for name, fcfg, cut in families:
        t0 = time.perf_counter()
        fcfg = dataclasses.replace(fcfg, compute_dtype="float32")
        g = torch.Generator(dev).manual_seed(12)
        toks = torch.randint(0, fcfg.vocab_size,
                             (SERVE_CHECK["batch"], SERVE_CHECK["tokens"]),
                             generator=g, device=dev)
        memory = None
        if name == ENCDEC_ARCH:
            params = encdec.init_encdec(fcfg, g, dev)
            frames = torch.randn((SERVE_CHECK["batch"],
                                  fcfg.frontend_embed_len, fcfg.d_model),
                                 generator=g, device=dev)
            with torch.no_grad():
                memory = encdec.encode(params, frames, fcfg)
        else:
            params = lm.init_lm(fcfg, g, dev)
        err = rel_err(decode_logits(fcfg, params, toks, memory),
                      forward_logits(fcfg, params, toks, memory))
        print(f"  (c) {name} ({cut}; {fcfg.num_layers} blocks, "
              f"{sum(t.numel() for t in params.values())} parameters): "
              f"decode against the forward, fp32, {err:.3e} (tolerance "
              f"{SERVE_RTOL:g}); {time.perf_counter() - t0:.1f}s",
              flush=True)
        check(err <= SERVE_RTOL, f"{name}: decode {err} from the forward")
        del params, memory
        torch.cuda.empty_cache()

    # (d) the ring buffer past its window
    t0 = time.perf_counter()
    rcfg = dataclasses.replace(cfg32, num_layers=RING["layers"],
                               window=RING["window"])
    g = torch.Generator(dev).manual_seed(13)
    params = lm.init_lm(rcfg, g, dev)
    toks = torch.randint(0, rcfg.vocab_size,
                         (SERVE_CHECK["batch"], RING["steps"]), generator=g,
                         device=dev)
    caches = lm.init_caches(rcfg, SERVE_CHECK["batch"], RING["steps"],
                            device=dev)
    check(caches["k"].shape[2] == RING["window"],
          f"ring cache of {caches['k'].shape[2]} slots")
    err = rel_err(decode_logits(rcfg, params, toks),
                  forward_logits(rcfg, params, toks))
    print(f"  (d) the ring buffer: {SERVE_ARCH} widths, {RING['layers']} "
          f"blocks, window {RING['window']} (a cache of {RING['window']} "
          f"slots), {RING['steps']} steps: decode against the windowed "
          f"forward, fp32, {err:.3e} (tolerance {SERVE_RTOL:g}); "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    check(err <= SERVE_RTOL, f"ring buffer: decode {err} from the forward")
    return launches


# ---------------------------------------------------------------------------
# phase 2e: observability on the card
# ---------------------------------------------------------------------------
# phase 2n: the MoE layer at published widths, all routed experts, as
# MOE_SHARDS expert shards; the sharded dense step (phase 2i's model);
# the dry runs; the prefill hand-off on phase 2d's model
MOE_SHARDS, MOE_TOKENS = 4, 2 * 1024
SHARDED_BATCH = (4, 1024)
DRYRUNS = (("internlm2-1.8b", "train_4k", False),
           ("deepseek-v2-236b", "decode_32k", True))
DRYRUN_TIMEOUT = 300
PREFILL = dict(batch=4, seq_len=1024)


def moe_local_check():
    """Phase 2n (a): ``moe_ffn_local`` at deepseek-v2's published widths
    with all routed experts, as ``MOE_SHARDS`` shards against one call;
    then card against CPU at ``reduced()``."""
    import torch
    from repro_torch.configs.base import load_arch, reduced
    from repro_torch.models.layers import moe

    cfg = dataclasses.replace(load_arch(MOE_ARCH), compute_dtype="float32")
    m = cfg.moe
    E, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
    gen = torch.Generator("cuda").manual_seed(11)

    def weights(E, d, f, dev="cuda", g=gen):
        def rn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        return {"router": rn(d, E) * (0.1 / math.sqrt(d)),
                "w_gate": rn(E, d, f) / math.sqrt(d),
                "w_up": rn(E, d, f) / math.sqrt(d),
                "w_down": rn(E, f, d) / math.sqrt(f)}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    p = weights(E, d, f)
    x = torch.randn((MOE_TOKENS, d), generator=gen, device="cuda")
    cap = moe.capacity(MOE_TOKENS, cfg)
    wbytes = sum(p[k].numel() * 4 for k in ("w_gate", "w_up", "w_down"))
    t0 = time.perf_counter()
    whole, wa = moe.moe_ffn_local(p, x, cfg, 0, E, cap)
    torch.cuda.synchronize()
    t_whole = time.perf_counter() - t0
    per = E // MOE_SHARDS
    t0 = time.perf_counter()
    total, parts = torch.zeros_like(whole), []
    for i in range(MOE_SHARDS):
        shard = {k: v if k == "router" else v[i * per:(i + 1) * per]
                 for k, v in p.items()}
        out, a = moe.moe_ffn_local(shard, x, cfg, i * per, per, cap)
        total, parts = total + out, parts + [a]
    torch.cuda.synchronize()
    t_parts = time.perf_counter() - t0
    err = rel_err(total, whole)
    dropped = [int(a["dropped"]) for a in parts]
    print(f"  (a) {MOE_ARCH} MoE layer: {E} routed experts, top-"
          f"{m.experts_per_token}, d {d}, expert width {f}, "
          f"{wbytes / 1e9:.2f} GB of fp32 expert weights, {MOE_TOKENS} "
          f"tokens, capacity {cap}; one call {t_whole:.3f}s, "
          f"{MOE_SHARDS} shards of {per} {t_parts:.3f}s; summed shards "
          f"against one call {err:.3e} of the largest output (tolerance "
          f"1e-5); aux {float(wa['aux'])}; dropped {dropped} (sum "
          f"{sum(dropped)}) of {int(wa['dropped'])}; {peak_line(base)}",
          flush=True)
    check(err <= 1e-5, f"MoE shards disagree with one call: {err}")
    check(all(torch.equal(a["aux"], wa["aux"]) for a in parts),
          "MoE aux differs between the shards and one call")
    check(sum(dropped) == int(wa["dropped"]),
          f"MoE drops {dropped} do not sum to {int(wa['dropped'])}")
    del p, x, whole, total
    torch.cuda.empty_cache()
    # card against CPU at reduced(), two shards
    rcfg = reduced(load_arch(MOE_ARCH))
    rm = rcfg.moe
    cpu_gen = torch.Generator().manual_seed(12)
    rp = weights(rm.num_experts, rcfg.d_model, rm.d_ff_expert, "cpu",
                 cpu_gen)
    rx = torch.randn((64, rcfg.d_model), generator=cpu_gen)
    rcap, half = moe.capacity(64, rcfg), rm.num_experts // 2
    errs = []
    for i in range(2):
        shard = {k: v if k == "router" else v[i * half:(i + 1) * half]
                 for k, v in rp.items()}
        want, wa = moe.moe_ffn_local(shard, rx, rcfg, i * half, half, rcap)
        got, ga = moe.moe_ffn_local({k: v.cuda() for k, v in shard.items()},
                                    rx.cuda(), rcfg, i * half, half, rcap)
        errs.append(rel_err(got.cpu(), want))
        check(int(ga["dropped"]) == int(wa["dropped"]),
              "MoE drops differ between card and CPU")
    print(f"  (a) reduced() MoE layer, 2 shards, card against CPU: "
          f"{[f'{e:.2e}' for e in errs]} of the largest output (tolerance "
          f"1e-5)", flush=True)
    check(max(errs) <= 1e-5, f"MoE card and CPU disagree: {errs}")


def sharded_step_check():
    """Phase 2n (b): ``make_sharded_train_step`` on a one-rank ``nccl``
    mesh against ``make_train_step``. Returns the sharded step's launch
    counts."""
    import socket
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import load_train
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules

    cfg, tc = dense_config(), load_train(DENSE_ARCH)
    B, S = SHARDED_BATCH
    toks, labs, params = lm_init("cuda", cfg, B, S, seed=3)
    batch = {"tokens": toks, "labels": labs}
    step, opt = steps.make_train_step(cfg, tc)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    want_p, _, want_m = step(params, opt.init(params), batch)
    torch.cuda.synchronize()
    want_launch = ops.launch_counts()
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh("cuda")

        def put(tree, specs):
            return {k: distribute_tensor(v, mesh, rules.to_placements(
                specs[k], mesh)) for k, v in tree.items()}

        p_specs = rules.param_pspecs(params, mesh)
        st = opt.init(params)
        o_specs = rules.opt_state_specs(st, p_specs, tc.optimizer, mesh)
        dst = {k: (put(v, o_specs[k]) if isinstance(v, dict) else v)
               for k, v in st.items()}
        dp = put(params, p_specs)
        db = put(batch, rules.batch_specs(batch, mesh))
        sstep, _ = steps.make_sharded_train_step(cfg, tc, mesh)
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        got_p, _, got_m = sstep(dp, dst, db)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        secs = time.perf_counter() - t0
        same = [k for k, v in want_p.items()
                if torch.equal(got_p[k].to_local(), v)]
        print(f"  (b) sharded train step, {DENSE_ARCH} at published widths, "
              f"{cfg.num_layers} blocks, batch {B} x {S}, mesh (1, 1) over "
              f"nccl: {secs:.2f}s; loss {float(got_m['loss'])} against "
              f"{float(want_m['loss'])} unsharded (equal bits "
              f"{torch.equal(got_m['loss'], want_m['loss'])}); {len(same)} "
              f"of {len(want_p)} parameters bit-identical; launches "
              f"{ {k: v for k, v in launches.items() if v} } against "
              f"{ {k: v for k, v in want_launch.items() if v} }",
              flush=True)
        check(torch.equal(got_m["loss"], want_m["loss"]),
              "the one-rank sharded step's loss differs from the unsharded")
        check(len(same) == len(want_p),
              f"parameters differ: {sorted(set(want_p) - set(same))[:5]}")
        check(launches == want_launch,
              f"sharded launches {launches} != unsharded {want_launch}")
    finally:
        dist.destroy_process_group()
    return launches


def dryrun_check():
    """Phase 2n (c): the dry runs as subprocesses, both at once."""
    procs = []
    for arch, shape, pod in DRYRUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape] + (["--multi-pod"] if pod else [])
        procs.append((arch, shape, pod, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for arch, shape, pod, t0, proc in procs:
        try:
            out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        finally:
            proc.kill()
        rows = [ln for ln in out.splitlines() if ln.startswith(arch)]
        split = [ln for ln in out.splitlines()
                 if ln.startswith("  collectives by source")]
        print(f"  (c) dry run {arch} {shape} on "
              f"{'2x16x16' if pod else '16x16'} (meta, fake process group): "
              f"exit {proc.returncode} in {time.perf_counter() - t0:.1f}s; "
              f"{rows[0] if rows else out[-2000:]}", flush=True)
        if split:
            print(f"  {split[0]}", flush=True)
        check(proc.returncode == 0 and rows and split and "DRY-RUN OK" in out,
              f"dry run {arch} {shape} failed")


def prefill_check():
    """Phase 2n (d): the prefill hand-off on phase 2d's model. Returns the
    launch counts."""
    import torch
    from repro_torch.convert import subtree
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import mamba2

    cfg = lm_config()
    B, S = PREFILL["batch"], PREFILL["seq_len"]
    half, Q = S // 2, min(cfg.ssm.chunk_size, S // 2)
    _, _, params = lm_init("cuda", cfg, 1, 8, seed=4)
    blocks = subtree(params, "blocks")
    gen = torch.Generator("cuda").manual_seed(13)
    errs = {"h vs plain": 0.0, "h vs decode": 0.0, "second half vs plain":
            0.0}
    gaps = []
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    layers = [(g, i) for g in range(blocks["mamba/w_in"].shape[0])
              for i in range(blocks["mamba/w_in"].shape[1])]
    with torch.no_grad():
        for g, i in layers:
            p = subtree({k: v[g, i] for k, v in blocks.items()}, "mamba")
            x = torch.randn((B, S, cfg.d_model), generator=gen,
                            device="cuda")
            y1, (h1, c1) = mamba2.mamba2_apply(p, x[:, :half], cfg,
                                               return_state=True)
            y2, (h2, _) = mamba2.mamba2_apply(p, x[:, half:], cfg, h1, c1,
                                              return_state=True)
            whole = mamba2.mamba2_apply(p, x, cfg)
            gaps.append(rel_err(y2, whole[:, half:]))
            # the first half's scan: kernel against the plain scan
            _, _, xh, dt, A, Bm, Cm = mamba2.scan_inputs(p, x[:, :half], cfg)
            _, hp = ref.ssd_explicit(xh, dt, dt * A, Bm, Cm, Q)
            errs["h vs plain"] = max(errs["h vs plain"], rel_err(h1, hp))
            # the recurrent decode over the same tokens
            st = mamba2.init_state(cfg, B, "cuda")
            for t in range(half):
                _, st = mamba2.mamba2_decode(p, x[:, t:t + 1], st, cfg)
            errs["h vs decode"] = max(errs["h vs decode"],
                                      rel_err(h1, st["h"]))
            # the second half's scan from h0: kernel against plain
            _, _, xh, dt, A, Bm, Cm = mamba2.scan_inputs(p, x[:, half:], cfg)
            yk, hk = ops.ssd_scan(xh, dt, dt * A, Bm, Cm, chunk=Q, h0=h1,
                                  return_state=True)
            yp, hp = ref.ssd_explicit(xh, dt, dt * A, Bm, Cm, Q, h1)
            errs["second half vs plain"] = max(
                errs["second half vs plain"], rel_err(yk, yp),
                rel_err(hk, hp), rel_err(h2, hp))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"  (d) prefill hand-off, {cfg.arch_id} at published widths, "
          f"{len(layers)} Mamba2 blocks, {B} prompts of {S} tokens as two "
          f"halves of {half} (chunk {Q}), {time.perf_counter() - t0:.1f}s: "
          f"largest errors over the blocks, of the largest value, "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tolerance 1e-4); "
          f"two parts against one pass, the second half's outputs, "
          f"{[f'{v:.2e}' for v in gaps]} of the largest (the reference's "
          f"conv0 is ignored, so the second half's first "
          f"{cfg.ssm.conv_width - 1} convolution outputs differ; printed, "
          f"not checked); launches {launches}", flush=True)
    check(all(v <= 1e-4 for v in errs.values()),
          f"prefill hand-off errors {errs}")
    return launches


def sharding_phase():
    """Phase 2n. Returns {path: launch counts} of (b) and (d)."""
    t = time.perf_counter()
    moe_local_check()
    print(f"  (a) took {time.perf_counter() - t:.1f}s", flush=True)
    t = time.perf_counter()
    launches = {"sharded": sharded_step_check()}
    print(f"  (b) took {time.perf_counter() - t:.1f}s", flush=True)
    t = time.perf_counter()
    dryrun_check()
    print(f"  (c) took {time.perf_counter() - t:.1f}s", flush=True)
    t = time.perf_counter()
    launches["prefill"] = prefill_check()
    print(f"  (d) took {time.perf_counter() - t:.1f}s", flush=True)
    return launches


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
               "info_nce_grad_kernel<false>", "rope_rotate_kernel")


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
# phase 2f: resources, the paper's table and the fleet simulator
# ---------------------------------------------------------------------------
# (b), (c): full ViT-Tiny width, depth cut to 4 blocks (one LW-FedSSL stage a
# round), 8 clients of 256 images (one local step a round), 4 a round
FLEET_RUN = dict(clients=8, clients_per_round=4, rounds=4, samples=2048,
                 eval_epochs=0, codec="int8")
FLEET_LAYERS = 4


def paper_table_phase():
    """(a) ``launch.trace.paper_table`` on the card at full ViT-Tiny width,
    batch 256, both engines x five schedules: comm bytes equal to
    ``client_costs``' exactly and at the paper's multipliers, each
    signature's counted FLOPs within ``FLOPS_RTOL`` of the analytic count,
    each measured peak within ``MEMORY_FACTOR`` of the memory model. Then
    one reduced step per engine, counted on the card and on the CPU: the
    counts must be equal, op by op; and counting changes neither the loss
    nor the kernel launches. Returns the table document."""
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import schedule as sched
    from repro_torch.kernels import ops
    from repro_torch.launch import trace as trace_mod
    from repro_torch.obs import resources as res_mod
    from repro_torch.roofline import client_costs as cc

    t0 = time.perf_counter()
    doc = trace_mod.paper_table(device="cuda")
    secs = time.perf_counter() - t0
    trace_mod.print_paper_table(doc)
    for s in sched.SCHEDULES:
        want = cc.schedule_costs(s)["comm_total"]
        for r in doc["rows"]:
            if r["schedule"] == s:
                check(r["comm_bytes"] == want,
                      f"{s}: full-scale comm {r['comm_bytes']} != analytic "
                      f"{want}")
                check(abs(r["comm_ratio"] - cc.PAPER_MULT[s][2]) <= 0.005,
                      f"{s}: comm ratio {r['comm_ratio']:.4f}, paper "
                      f"{cc.PAPER_MULT[s][2]}")
    worst_f, worst_m = 0.0, 1.0
    for r in doc["rows"]:
        for st in r["stages"]:
            rf = st["flops_per_sample"] / st["analytic_flops_per_sample"]
            rm = st["peak_memory"] / st["program_peak_analytic"]
            worst_f = max(worst_f, abs(rf - 1.0))
            worst_m = max(worst_m, rm, 1.0 / rm)
            check(abs(rf - 1.0) <= res_mod.FLOPS_RTOL,
                  f"{r['engine']}/{r['schedule']} sub {st['sub_layers']} "
                  f"act {st['active_from']}: counted/analytic FLOPs {rf:.4f}")
            check(1.0 / res_mod.MEMORY_FACTOR <= rm <= res_mod.MEMORY_FACTOR,
                  f"{r['engine']}/{r['schedule']} sub {st['sub_layers']} "
                  f"act {st['active_from']}: peak {st['peak_memory']:.0f} vs "
                  f"model {st['program_peak_analytic']:.0f} ({rm:.3f}x)")
    n_sigs = sum(len(r["stages"]) for r in doc["rows"])
    print(f"  paper table: {n_sigs} measured steps in {secs:.1f}s; comm "
          f"bytes equal the analytic bytes; largest |counted/analytic - 1| "
          f"{worst_f:.4f} (tolerance {res_mod.FLOPS_RTOL}); largest peak vs "
          f"model factor {worst_m:.3f} (tolerance {res_mod.MEMORY_FACTOR})",
          flush=True)
    for r in doc["rows"]:
        print(f"  {r['engine']}/{r['schedule']}: per stage (sub, act, "
              f"counted GFLOP/sample, analytic, peak MiB, model MiB) "
              + "; ".join(f"({st['sub_layers']}, {st['active_from']}, "
                          f"{st['flops_per_sample'] / 1e9:.4f}, "
                          f"{st['analytic_flops_per_sample'] / 1e9:.4f}, "
                          f"{st['peak_memory'] / 2**20:.1f}, "
                          f"{st['program_peak_analytic'] / 2**20:.1f})"
                          for st in r["stages"]), flush=True)

    # the trap: the card's count of a step equals the CPU's, op by op; the
    # reduced config with 3 heads of 64 (its 2 heads of 96 are a head dim
    # the attention kernel does not take)
    cfg, ssl, train = res_mod.measurement_config()
    cfg = dataclasses.replace(cfg, num_heads=3, num_kv_heads=3)
    plan = [p for p in sched.build_schedule(
        FLConfig(rounds=4, schedule="lw_fedssl"), cfg.num_layers)
        if p.align][0]
    for engine, clients in (("sequential", 1), ("vmap", 2)):
        kw = dict(cfg=cfg, ssl=ssl, train=train, clients=clients)
        cpu = res_mod.measure_step(plan, engine, device="cpu", **kw)
        ops.reset_launch_counts()
        card = res_mod.measure_step(plan, engine, device="cuda", **kw)
        counted = ops.launch_counts()
        ops.reset_launch_counts()
        bare = res_mod.measure_step(plan, engine, device="cuda",
                                    count=False, **kw)
        torch.cuda.synchronize()
        uncounted = ops.launch_counts()
        print(f"  {engine} step (reduced, 3 heads of 64, stage "
              f"{plan.stage}: sub {plan.sub_layers} act "
              f"{plan.active_from}, alignment on): card {card['flops']} "
              f"FLOPs, CPU {cpu['flops']}; by op "
              f"{card['by_op']}; launches counted {counted}, uncounted "
              f"{uncounted}; loss counted {card['loss']}, uncounted "
              f"{bare['loss']}", flush=True)
        check(card["flops"] == cpu["flops"] and card["by_op"] == cpu["by_op"],
              f"{engine}: card counts {card['by_op']}, CPU {cpu['by_op']}")
        check(counted == uncounted and card["loss"] == bare["loss"],
              f"{engine}: counting changed the step: launches {counted} vs "
              f"{uncounted}, loss {card['loss']} vs {bare['loss']}")
        for name in ("flash_attention", "info_nce_rows", "info_nce_rows_dq",
                     "rmsnorm_rows"):
            check(counted[name] > 0, f"{engine}: {name} not launched in the "
                  f"counted step")
    return doc


def fleet_phase(model_cfg, ssl_cfg):
    """(b) the ViT path at full width (4 blocks) with a simulated
    pareto-stragglers fleet under the deadline and the buffered-async
    policies on the int8 wire, held to the simulator's invariants; a
    uniform fleet under the synchronous policy bit-identical to no
    simulator. (c) ``measure_resources``: losses bit-identical to the
    unmeasured run's on both engines, ``res.*`` on each stage's first round
    span, ``mem.*`` on every round span."""
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import schedule as sched
    from repro_torch.federated import simulation as sim_mod
    from repro_torch.obs import make_obs
    from repro_torch.obs import resources as res_mod
    from repro_torch.roofline import client_costs as cc

    cfg = dataclasses.replace(model_cfg, num_layers=FLEET_LAYERS)
    n = FLEET_RUN["clients"]
    base = {}
    for engine in ("sequential", "vmap"):
        _, base[engine], _, _, _ = main_path(
            "cuda", model_cfg=cfg, ssl_cfg=ssl_cfg, engine=engine,
            **FLEET_RUN)
    check(all(math.isfinite(x) for x in base["sequential"].loss),
          f"non-finite losses {base['sequential'].loss}")
    for policy, kw in (("deadline", {"overcommit": 1.5}),
                       ("buffered-async", {})):
        sim = sim_mod.make_sim("pareto-stragglers", policy, num_clients=n,
                               seed=0, **kw)
        _, hist, _, secs, _ = main_path("cuda", model_cfg=cfg,
                                        ssl_cfg=ssl_cfg, sim=sim,
                                        **FLEET_RUN)
        rounds = len(hist.loss)
        overlaps = []
        check(rounds == FLEET_RUN["rounds"]
              and all(math.isfinite(x) for x in hist.loss),
              f"{policy}: losses {hist.loss}")
        check(len(hist.round_wall_clock) == len(hist.device_seconds)
              == len(hist.energy_joules) == len(hist.dropped_clients)
              == len(hist.participants) == rounds,
              f"{policy}: simulator accounting lengths")
        check(hist.total_wall_clock > 0 and hist.total_energy > 0,
              f"{policy}: wall clock {hist.total_wall_clock}, energy "
              f"{hist.total_energy}")
        for rec in sim.records:
            check(set(rec.train_ids) <= set(rec.cohort),
                  f"{policy}: trained {rec.train_ids} outside the cohort "
                  f"{rec.cohort}")
            # the reference's buffered-async policy reports a client whose
            # stale update a stage transition discarded as dropped, and
            # aggregates it in the same round when it was relaunched and
            # arrived (tests/test_simulation.py fails on it); the port
            # keeps the reference's records, so only the deadline policy
            # is held to this invariant (the overlap is printed)
            overlap = set(rec.dropped) & set(rec.aggregated)
            check(policy == "buffered-async" or not overlap,
                  f"{policy}: dropped {rec.dropped} and aggregated "
                  f"{rec.aggregated} overlap")
            if overlap:
                overlaps.append((rec.round_idx, sorted(overlap)))
            check(rec.weights is None or not rec.weights
                  or abs(sum(rec.weights) - 1.0) <= 1e-9,
                  f"{policy}: weights {rec.weights}")
            check(len(rec.cohort) <= n, f"{policy}: cohort {rec.cohort}")
        print(f"  {policy}: losses {[round(x, 4) for x in hist.loss]}; "
              f"simulated {hist.total_wall_clock:.2f} s wall clock, "
              f"{hist.total_device_seconds:.2f} device-s, "
              f"{hist.total_energy:.2f} J, {hist.total_dropped} dropped; "
              f"cohorts {[len(r.cohort) for r in sim.records]}, trained "
              f"{[len(r.train_ids) for r in sim.records]}, aggregated "
              f"{[len(r.aggregated) for r in sim.records]}; (round, clients "
              f"both dropped and aggregated) {overlaps}; seconds per round "
              f"{[round(x, 3) for x in secs]}", flush=True)
    sim = sim_mod.make_sim("uniform", "synchronous", num_clients=n, seed=0)
    _, uhist, _, _, _ = main_path("cuda", model_cfg=cfg, ssl_cfg=ssl_cfg,
                                  sim=sim, **FLEET_RUN)
    check(uhist.loss == base["sequential"].loss,
          f"uniform synchronous losses {uhist.loss} differ from no "
          f"simulator {base['sequential'].loss}")
    print(f"  uniform/synchronous: losses bit-identical to no simulator "
          f"{[round(x, 4) for x in uhist.loss]}; simulated "
          f"{uhist.total_wall_clock:.2f} s, {uhist.total_dropped} dropped",
          flush=True)

    costs = cc.vit_costs(cfg, ssl_cfg)
    plans = sched.build_schedule(FLConfig(rounds=FLEET_RUN["rounds"],
                                          schedule="lw_fedssl"),
                                 FLEET_LAYERS)
    for engine in ("sequential", "vmap"):
        obs = make_obs(trace=True, measure_resources=True,
                       mode="chip_smoke")
        _, mhist, _, _, _ = main_path("cuda", model_cfg=cfg,
                                      ssl_cfg=ssl_cfg, engine=engine,
                                      obs=obs, **FLEET_RUN)
        check(mhist.loss == base[engine].loss,
              f"{engine}: measured losses {mhist.loss} differ from the "
              f"unmeasured {base[engine].loss}")
        spans = sorted((e for e in obs.tracer.events
                        if e["name"] == "round"), key=lambda e: e["seq"])
        check(all(e["args"].get("mem.source") == "device"
                  and e["args"]["mem.peak_bytes"] > 0 for e in spans),
              f"{engine}: mem.* missing from a round span")
        per = []
        for e, p in zip(spans, plans):
            has = "res.flops" in e["args"]
            check(has == p.new_stage,
                  f"{engine}: round {p.round_idx} res.* {has}, new stage "
                  f"{p.new_stage}")
            if has:
                ratio = (e["args"]["res.flops_per_sample"]
                         / cc.flops_per_sample_round(costs, p))
                per.append(round(ratio, 4))
                check(abs(ratio - 1.0) <= res_mod.FLOPS_RTOL,
                      f"{engine}: round {p.round_idx} counted/analytic "
                      f"{ratio}")
        print(f"  measure_resources ({engine}): losses bit-identical to the "
              f"unmeasured run; res.* on the {len(per)} stage-opening round "
              f"spans (counted/analytic FLOPs per sample {per}), mem.* on "
              f"all {len(spans)}", flush=True)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 2g: privacy and checkpoints on the card
# ---------------------------------------------------------------------------
DP_Z, DP_DELTA = 1.1, 1e-5
# the LM's clip: below every client's update norm there, so that the noise
# (sigma = z*C*max_w, 2.75e-4 an element) stays small against its weights
LM_DP_CLIP = 1e-3
STAGE12_UPLOAD = 21_177_920


def privacy_probe(cfg):
    """A ``PrivacyEngine`` for ``cfg`` that keeps what phase 2g checks and
    changes nothing the engine computes: every client's update norm (0-d
    tensors on the card, read after the run), the last noised round's
    trees, and for each secure aggregation its seconds, the bytes it adds
    above what was held at its start, and its largest per-element error
    against the exact (float64) FedAvg of the same decoded uploads, less
    the fp32 rounding of the output."""
    import torch
    from repro_torch.federated.transport import pack_stage_payload
    from repro_torch.privacy import PrivacyEngine

    class Probe(PrivacyEngine):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.norms, self.noised, self.secure = [], None, []
            self.run_peak = 0

        def clip(self, flat, ref_flat):
            self.norms.append(torch.linalg.vector_norm(flat - ref_flat))
            return super().clip(flat, ref_flat)

        def add_noise(self, tree, spec, draws, round_idx, sigma):
            out = super().add_noise(tree, spec, draws, round_idx, sigma)
            self.noised = (tree, out, spec, sigma)
            return out

        def secure_fedavg(self, trees, weights, client_ids, **kw):
            torch.cuda.synchronize()
            self.run_peak = max(self.run_peak,
                                torch.cuda.max_memory_allocated())
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = super().secure_fedavg(trees, weights, client_ids, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            extra = torch.cuda.max_memory_allocated() - held
            spec = kw["spec"]
            got = pack_stage_payload(out, spec).double()
            err = torch.zeros_like(got)
            for t, w in zip(trees, weights):
                err += pack_stage_payload(t, spec).double() * float(w)
            err = (got - err).abs() - got.abs() * 2.0 ** -24
            self.secure.append({"clients": len(trees), "seconds": secs,
                                "extra_bytes": extra,
                                "err": float(err.max()) / len(trees)})
            return out

        def peak(self):
            return max(self.run_peak, torch.cuda.max_memory_allocated())

    return Probe(cfg)


def check_secure_rounds(probe, what):
    check(probe.secure, f"{what}: no secure aggregation ran")
    for r in probe.secure:
        check(r["err"] <= 2.0 ** -40,
              f"{what}: secure aggregate {r['err']:.3e} per client from the "
              f"exact FedAvg (bound 2^-40)")
    return "; ".join(f"{r['clients']} clients {r['seconds'] * 1e3:.2f} ms, "
                     f"+{r['extra_bytes'] / 2**20:.1f} MiB, err/client "
                     f"{r['err']:.3e}" for r in probe.secure)


def check_dp_history(hist, what, q=1.0):
    """Finite losses, clip fractions in [0, 1], epsilon round by round
    equal to ``compute_epsilon`` at sampling fraction ``q``."""
    from repro_torch.privacy import compute_epsilon
    check(all(math.isfinite(x) for x in hist.loss),
          f"{what}: non-finite loss {hist.loss}")
    check(all(0.0 <= c <= 1.0 for c in hist.clip_fraction)
          and len(hist.clip_fraction) == len(hist.loss),
          f"{what}: clip fractions {hist.clip_fraction}")
    want = [compute_epsilon(q, DP_Z, r + 1, DP_DELTA)
            for r in range(len(hist.loss))]
    check(hist.epsilon == want,
          f"{what}: epsilon {hist.epsilon}, the accountant gives {want}")


def check_noise(probe, what):
    """The noised aggregate minus the noiseless one: its sample std within
    1% of sigma over the payload. Returns (std, sigma, elements)."""
    from repro_torch.federated.transport import pack_stage_payload
    tree, out, spec, sigma = probe.noised
    diff = (pack_stage_payload(out, spec).double()
            - pack_stage_payload(tree, spec).double())
    std = float(diff.std())
    check(abs(std / sigma - 1.0) <= 0.01,
          f"{what}: noise std {std} against sigma {sigma}")
    return std, sigma, spec.total


def privacy_phase(model_cfg, ssl_cfg, state, hist, int8_launches):
    """Phase 2g; ``state``, ``hist`` are phase 2's, ``int8_launches`` phase
    2b's int8 counts. Returns the launches of its DP paths."""
    import statistics

    import torch
    from repro_torch.checkpoint import load_fl_state, save_fl_state
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import schedule as sched
    from repro_torch.federated import simulation as sim_mod
    from repro_torch.federated.aggregate import client_weights
    from repro_torch.federated.transport import (Transport,
                                                 pack_stage_payload)
    from repro_torch.kernels import ops
    from repro_torch.federated.draws import TorchDraws
    from repro_torch.privacy import (PrivacyConfig, PrivacyEngine,
                                     SecureAggregator)

    launches, parts = {}, {}
    tphase = time.perf_counter()

    t = time.perf_counter()
    probe = privacy_probe(PrivacyConfig(clip=math.inf))
    astate, ahist, _, asecs, _ = main_path(
        "cuda", model_cfg=model_cfg, ssl_cfg=ssl_cfg, eval_epochs=0,
        privacy=probe)
    check(ahist.loss == hist.loss,
          f"clip=inf losses {ahist.loss} differ from phase 2's {hist.loss}")
    for branch, flat in state.items():
        for k, v in flat.items():
            check(torch.equal(astate[branch][k], v),
                  f"clip=inf: {branch}/{k} differs from phase 2's")
    check(ahist.epsilon == [math.inf] * len(hist.loss)
          and ahist.clip_fraction == [0.0] * len(hist.loss),
          f"clip=inf: epsilon {ahist.epsilon}, clip fraction "
          f"{ahist.clip_fraction}")
    norms = torch.stack(probe.norms).tolist()
    clip = float(f"{statistics.median(norms):.3g}")
    parts["a"] = time.perf_counter() - t
    print(f"  (a) clip=inf: losses and final state bit-identical to phase "
          f"2's, epsilon inf and clip fraction 0 in all {len(ahist.loss)} "
          f"rounds; seconds per round {[round(x, 3) for x in asecs]}; the "
          f"{len(norms)} client update norms {min(norms):.4g} to "
          f"{max(norms):.4g}, median -> C = {clip}", flush=True)

    t = time.perf_counter()
    probe = privacy_probe(PrivacyConfig(clip=clip, noise_multiplier=DP_Z,
                                        delta=DP_DELTA))
    ops.reset_launch_counts()
    _, bhist, _, bsecs, _ = main_path(
        "cuda", model_cfg=model_cfg, ssl_cfg=ssl_cfg, eval_epochs=0,
        codec="int8", privacy=probe)
    torch.cuda.synchronize()
    launches["dp_int8"] = ops.launch_counts()
    check_dp_history(bhist, "DP int8")
    check(any(c > 0 for c in bhist.clip_fraction),
          f"C = {clip} clipped no client: {bhist.clip_fraction}")
    # the design: each round packs the shared reference the clip needs
    # (int8 is not a delta codec, so nothing else packs it) and the
    # aggregate that takes the noise, and unpacks the noised aggregate
    rounds = len(bhist.loss)
    want = dict(int8_launches)
    want["gather_pack"] += 2 * rounds
    want["scatter_unpack"] += rounds
    check(launches["dp_int8"] == want,
          f"DP int8 launches {launches['dp_int8']}, the design gives {want}")
    std, sigma, n = check_noise(probe, "DP int8")
    check(sigma == DP_Z * clip * float(client_weights([1024] * 4).max()),
          f"sigma {sigma}")
    print(f"  (b) DP, sequential, int8 wire, C = {clip}, z = {DP_Z}: losses "
          f"{[round(x, 4) for x in bhist.loss]}; clip fraction "
          f"{bhist.clip_fraction}; epsilon "
          f"{[round(e, 4) for e in bhist.epsilon]} (= compute_epsilon); "
          f"noise std {std:.6g} against sigma "
          f"{sigma:.6g} over {n} elements; gather_pack "
          f"{launches['dp_int8']['gather_pack']} and scatter_unpack "
          f"{launches['dp_int8']['scatter_unpack']} launches (int8 without "
          f"DP: {int8_launches['gather_pack']}, "
          f"{int8_launches['scatter_unpack']}); seconds per round "
          f"{[round(x, 3) for x in bsecs]}", flush=True)
    probe = privacy_probe(PrivacyConfig(clip=clip, noise_multiplier=DP_Z,
                                        delta=DP_DELTA))
    ops.reset_launch_counts()
    _, vhist, _, vsecs, _ = main_path(
        "cuda", model_cfg=model_cfg, ssl_cfg=ssl_cfg, eval_epochs=0,
        codec="topk", engine="vmap", privacy=probe)
    torch.cuda.synchronize()
    launches["dp_topk_vmap"] = ops.launch_counts()
    check_dp_history(vhist, "DP top-k vmap")
    for name in MAIN_KERNELS + ("compensate", "topk_ef_update"):
        check(launches["dp_topk_vmap"][name] > 0,
              f"{name} never launched on the DP top-k vmap path")
    std, sigma, n = check_noise(probe, "DP top-k vmap")
    parts["b"] = time.perf_counter() - t
    print(f"  (b) the same on the vmap engine, top-k wire: losses "
          f"{[round(x, 4) for x in vhist.loss]}; clip fraction "
          f"{vhist.clip_fraction}; noise std {std:.6g} against sigma "
          f"{sigma:.6g}; launches {launches['dp_topk_vmap']}; seconds per "
          f"round {[round(x, 3) for x in vsecs]}", flush=True)

    t = time.perf_counter()
    plan = sched.build_schedule(FLConfig(rounds=12, schedule="lw_fedssl"),
                                12)[-1]
    spec = Transport("fp32").plan_specs(state["online"], plan)["upload"]
    check(spec.total == STAGE12_UPLOAD, f"stage-12 upload {spec.total}")
    base = pack_stage_payload(state["online"], spec)
    flats = [base * (1.0 + 0.1 * i) for i in range(4)]
    w = client_weights([1100, 1000, 1000, 996]).tolist()
    ids, seed = [0, 1, 2, 3], (2024, 20)
    agg = SecureAggregator()
    masked = agg.aggregate(flats, w, ids, seed)
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        again = agg.aggregate(flats, w, ids, seed)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        extra = torch.cuda.max_memory_allocated() - held
        check(torch.equal(again, masked), "masked aggregate not repeatable")
    t0 = time.perf_counter()
    fedavg = sum(f * wi for f, wi in zip(flats, w))
    torch.cuda.synchronize()
    fedavg_secs = time.perf_counter() - t0
    plain = agg.aggregate(flats, w, ids, seed, mask=False)
    check(torch.equal(masked, plain), "masked aggregate differs from the "
          "unmasked fixed-point sum")
    t0 = time.perf_counter()
    cpu = agg.aggregate([f.cpu() for f in flats], w, ids, seed, mask=False)
    cpu_secs = time.perf_counter() - t0
    check(torch.equal(masked.cpu(), cpu), "card and CPU fixed-point sums "
          "differ")
    acc = torch.zeros(spec.total, dtype=torch.int64, device="cuda")
    for f, wi, c in zip(flats, w, ids):
        agg.accumulate(acc, f, wi, c, ids, seed)
    fixed = acc.double() / 2.0 ** 40
    exact = sum(f.double() * wi for f, wi in zip(flats, w))
    ferr = float((fixed - exact).abs().max())
    check(ferr <= len(flats) * 2.0 ** -40,
          f"fixed-point sum {ferr:.3e} from the exact FedAvg")
    check(torch.equal(fixed.float(), masked), "output is not the fixed-point "
          "sum's fp32 rounding")
    x = torch.tensor([2 ** 63 - 1, -2 ** 63, 2 ** 62], dtype=torch.int64,
                     device="cuda")
    y = torch.tensor([1, -1, 2 ** 62], dtype=torch.int64, device="cuda")
    check((x + y).tolist() == [-2 ** 63, 2 ** 63 - 1, -2 ** 63]
          and ((x + y) - y).tolist() == x.tolist(),
          f"int64 add does not wrap on the card: {(x + y).tolist()}")
    m = agg.pair_mask(seed, 0, 1, STAGE12_UPLOAD, device="cuda")
    top = float((m < 0).double().mean())
    check(abs(top - 0.5) <= 0.001, f"mask top bit set in {top} of draws")
    # one round's clip (the shared reference's pack, then each client's
    # clip) and noise (pack, draw, add, unpack) at this payload
    eng = PrivacyEngine(PrivacyConfig(clip=clip, noise_multiplier=DP_Z))
    draws = TorchDraws(0, "cuda")

    def clip_round():
        ref = pack_stage_payload(state["online"], spec)
        for f in flats:
            eng.clip(f, ref)

    def noise_round():
        eng.add_noise(state["online"], spec, draws, 0, eng.sigma(0.25))

    step_ms = {}
    for name, fn in (("clip", clip_round), ("noise", noise_round)):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms[name] = times
    print(f"  (c) stage-12 upload ({spec.total} floats), 4 clients, chunk "
          f"{agg.chunk}: masked = unmasked fixed-point sum = the CPU's, to "
          f"the bit; fixed-point sum {ferr:.3e} from the exact FedAvg "
          f"(bound {len(flats)} x 2^-40 = {len(flats) * 2.0 ** -40:.3e}), "
          f"fp32 output {float((masked - fedavg).abs().max()):.3e} from the "
          f"fp32 FedAvg; int64 add wraps at +-2^63; mask top bit in {top:.5f}"
          f" of draws; masked aggregate "
          f"{[round(x * 1e3, 3) for x in secs]} ms (fp32 FedAvg "
          f"{fedavg_secs * 1e3:.3f} ms, CPU {cpu_secs * 1e3:.1f} ms), "
          f"+{extra / 2**20:.1f} MiB above its inputs; a round's clip "
          f"{[round(x, 3) for x in step_ms['clip']]} ms, its noise "
          f"{[round(x, 3) for x in step_ms['noise']]} ms", flush=True)
    del flats, masked, plain, acc, fixed, exact, m, fedavg, again
    for engine in ("sequential", "vmap"):
        probe = privacy_probe(PrivacyConfig(secure_agg=True))
        _, shist, _, ssecs, _ = main_path(
            "cuda", model_cfg=model_cfg, ssl_cfg=ssl_cfg, eval_epochs=0,
            rounds=1, schedule="e2e", engine=engine, privacy=probe)
        check(all(math.isfinite(x) for x in shist.loss)
              and shist.secure_agg_overhead_bytes[0] > 0,
              f"secure {engine}: {shist.loss}, "
              f"{shist.secure_agg_overhead_bytes}")
        print(f"  (c) one secure e2e round, {engine}: loss "
              f"{shist.loss[0]:.4f}, {ssecs[0]:.3f} s; "
              f"{check_secure_rounds(probe, engine)}", flush=True)
    cfg = dataclasses.replace(model_cfg, num_layers=FLEET_LAYERS)
    for policy, kw in (("deadline", {"overcommit": 1.5}),
                       ("buffered-async", {})):
        sim = sim_mod.make_sim("pareto-stragglers", policy,
                               num_clients=FLEET_RUN["clients"], seed=0,
                               **kw)
        probe = privacy_probe(PrivacyConfig(secure_agg=True))
        _, fhist, _, _, _ = main_path(
            "cuda", model_cfg=cfg, ssl_cfg=ssl_cfg, sim=sim, privacy=probe,
            schedule="e2e", **{**FLEET_RUN, "rounds": 1})
        rec = sim.records[0]
        check(all(math.isfinite(x) for x in fhist.loss),
              f"secure {policy}: {fhist.loss}")
        print(f"  (c) one secure round, {policy} ({FLEET_LAYERS} blocks, "
              f"{FLEET_RUN['clients']} clients, cohort {len(rec.cohort)}, "
              f"trained {len(rec.train_ids)}, aggregated "
              f"{len(rec.aggregated)}): loss {fhist.loss[0]:.4f}; "
              f"{check_secure_rounds(probe, policy)}", flush=True)
    parts["c"] = time.perf_counter() - t

    t = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probe = privacy_probe(PrivacyConfig(clip=LM_DP_CLIP,
                                        noise_multiplier=DP_Z,
                                        delta=DP_DELTA, secure_agg=True))
    ops.reset_launch_counts()
    _, lparams, lhist, lsecs, _, _, _ = lm_path(
        "cuda", **{**LM_RUN, "rounds": 2}, privacy=probe)
    torch.cuda.synchronize()
    launches["lm_dp"] = ops.launch_counts()
    peak = probe.peak()
    check_dp_history(lhist, "LM DP")
    for name in MAIN_KERNELS + ("ssd_scan",):
        check(launches["lm_dp"][name] > 0,
              f"{name} never launched on the LM DP path")
    secure = check_secure_rounds(probe, "LM")
    std, sigma, n = check_noise(probe, "LM")
    del lparams
    parts["d"] = time.perf_counter() - t
    print(f"  (d) {LM_ARCH}, 2 rounds, DP (C = {LM_DP_CLIP}, z = {DP_Z}) and "
          f"secure aggregation: losses {[round(x, 4) for x in lhist.loss]}; "
          f"clip fraction {lhist.clip_fraction}; epsilon "
          f"{[round(e, 4) for e in lhist.epsilon]}; noise std {std:.6g} "
          f"against sigma {sigma:.6g} over {n} elements; secure "
          f"aggregation {secure}; peak device memory {peak / 2**30:.2f} GiB; "
          f"seconds per round {[round(x, 3) for x in lsecs]}", flush=True)

    t = time.perf_counter()
    out = ROOT / "results" / "chip_smoke_ckpt"
    shutil.rmtree(out, ignore_errors=True)
    try:
        save_fl_state(out, astate, len(ahist.loss), {"schedule": "lw_fedssl"})
        size = (out / "global_state.npz").stat().st_size
        for device in ("cuda", "cpu"):
            like = {b: {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                        for k, v in flat.items()}
                    for b, flat in astate.items()}
            got, rnd, meta = load_fl_state(out, like)
            check(rnd == len(ahist.loss) and meta["schedule"] == "lw_fedssl",
                  f"checkpoint meta {meta}")
            for b, flat in astate.items():
                for k, v in flat.items():
                    check(got[b][k].device.type == device
                          and torch.equal(got[b][k].to(v.device), v),
                          f"checkpoint {b}/{k} on {device} differs")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    parts["e"] = time.perf_counter() - t
    print(f"  (e) save_fl_state of (a)'s final state ({size} bytes) loads "
          f"back bit-identical on the card and on the CPU", flush=True)
    print(f"  phase 2g took {time.perf_counter() - tphase:.1f}s: "
          + ", ".join(f"({k}) {v:.1f}s" for k, v in parts.items()),
          flush=True)
    return launches


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


def lm_reference_check(params, tokens, n=2, seq=512, cfg=None):
    """``lm_ssl_loss`` with alignment at full width, stage 1 (of ``cfg``,
    default phase 2d's zamba2), on ``n`` x ``seq`` tokens at fp32 compute:
    kernels on the card against the plain versions on the CPU. The global
    model is the trained one with every leaf nudged by 1e-3 of its spread
    (noise from a fixed seed), so the alignment compares two models; with
    one sequence its InfoNCE would have a single row and be 0 exactly,
    hence two. Returns {metric: relative difference}."""
    import torch
    from repro_torch.core.ssl import lm_ssl_loss

    cfg = dataclasses.replace(cfg or lm_config(), compute_dtype="float32")
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
# the least share of its byte bound the RoPE kernel takes at the ViT cell's
# shape
ROPE_BOUND_SHARE = 0.7


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


def bound(nbytes, flops, peak=None):
    """(bound ms, what bounds it) of work moving ``nbytes`` and doing
    ``flops`` at ``peak``."""
    tb = nbytes / mesh.HBM_BW
    tf = flops / (peak or mesh.PEAK_FLOPS_FP32)
    return max(tb, tf) * 1e3, "bytes" if tb > tf else "operations"


def copies(nbytes: int) -> int:
    """Input copies to cycle through so that they exceed the L2 cache."""
    return max(1, math.ceil(2 * 50e6 / nbytes))


def max_err(a, b) -> float:
    if isinstance(a, (list, tuple)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def rope_record(shape, k_heads, dtype, gen, what):
    """The RoPE kernel on q of ``shape`` (B, S, H, hd) and k of ``k_heads``
    heads in one launch, over positions 0..S-1: forward and backward equal
    to the plain version's to the bit (the kernel's contract), then
    timed against the plain rotation of q and of k (``ref.rope_ref``, the
    arithmetic the port ran before the kernel) from the same table, and
    against its bound (one read and one write of q and k, the table read
    once). Returns the kernel record."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = gen.device
    B, S, H, hd = shape
    q = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, k_heads, hd), generator=gen,
                    device=dev).to(dtype)
    cos, sin = ref.rope_table(torch.arange(S, device=dev), hd)
    got = ops.rope_qk(q, k, cos, sin)
    want = [ref.rope_ref(t, cos, sin) for t in (q, k)]
    qg, kg = q.clone().requires_grad_(), k.clone().requires_grad_()
    gq, gk = (torch.randn(t.shape, generator=gen, device=dev).to(dtype)
              for t in (q, k))
    dgot = torch.autograd.grad(ops.rope_qk(qg, kg, cos, sin), (qg, kg),
                               (gq, gk))
    dwant = torch.autograd.grad([ref.rope_ref(t, cos, sin) for t in (qg, kg)],
                                (qg, kg), (gq, gk))
    same = all(torch.equal(a, b) for a, b in zip((*got, *dgot),
                                                 (*want, *dwant)))
    print(f"  rope {what}: q {tuple(shape)}, k {k_heads} heads, {dtype}: "
          f"forward and backward bit-identical to the plain version: "
          f"{same}", flush=True)
    check(same, f"rope {what}: the kernel's bits differ from the plain "
                f"version's")
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size() + \
        2 * 4 * cos.numel()
    sets = [(q, k)] + [tuple(torch.randn(t.shape, generator=gen, device=dev)
                             .to(dtype) for t in (q, k))
                       for _ in range(copies(nbytes) - 1)]
    bms, by = bound(nbytes, 6 * (q.numel() + k.numel()))
    ms = time_ms([lambda a=a: ops.rope_qk(*a, cos, sin) for a in sets])
    return dict(
        kernel="rope", max_abs_err=max_err(got, want), ms=ms,
        plain_ms=time_ms([lambda a=a: [ref.rope_ref(t, cos, sin) for t in a]
                          for a in sets]),
        library_ms=None, bound_ms=bms, bound_by=by,
        shape=f"q {tuple(shape)}, k {k_heads} heads, {dtype} ({what}); "
              f"{100 * bms / ms:.1f}% of the bound")


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
        bound_ms=2 * payload / mesh.HBM_BW * 1e3, bound_by="bytes",
        shape=f"upload payload {spec.total} fp32 in {len(leaves)} slots")
    rec["scatter_unpack"] = dict(
        max_abs_err=err_u,
        ms=time_ms([lambda: ops.wire_unpack(new, leaves, spec.layout)]),
        plain_ms=time_ms([lambda: ref.wire_unpack_ref(new, leaves,
                                                      spec.layout)]),
        library_ms=None,
        bound_ms=2 * leaf_bytes / mesh.HBM_BW * 1e3, bound_by="bytes",
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
    bms, by = bound(nbytes, flops, mesh.PEAK_FLOPS_BF16)
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
    # GQA, and MLA's narrower v (reduced and published head dims)
    for Sg, Hq, Hkv, hdq, hdv in ((65, 4, 2, 64, 64), (65, 4, 4, 48, 32),
                                  (130, 2, 2, 192, 128)):
        qg, kg, vg = (torch.randn((2, Sg, h, w), generator=gen, device=dev)
                      .requires_grad_()
                      for h, w in ((Hq, hdq), (Hkv, hdq), (Hkv, hdv)))
        go = torch.randn((2, Sg, Hq, hdv), generator=gen, device=dev)
        got = torch.autograd.grad(
            ops.flash_attention(qg, kg, vg, causal=True), (qg, kg, vg), go)
        want = torch.autograd.grad(
            ref.sdpa_ref(qg.transpose(1, 2), kg.transpose(1, 2),
                         vg.transpose(1, 2), causal=True).transpose(1, 2),
            (qg, kg, vg), go)
        line(f"flash_attention backward (causal, S {Sg}, Hq {Hq}, Hkv "
             f"{Hkv}, head dims {hdq} / {hdv})", max_err(got, want), 1e-4)

    # RoPE: the benchmark's ViT cell rotates q and k of 16 clients x 256
    # images in one launch; at least ROPE_BOUND_SHARE of its byte bound
    rec["rope"] = rope_record((16 * B, S, Hh, hd), Hh, torch.bfloat16, gen,
                              "the ViT cell's 16 clients")
    share = rec["rope"]["bound_ms"] / rec["rope"]["ms"]
    check(share >= ROPE_BOUND_SHARE,
          f"rope at the ViT cell's shape: {100 * share:.1f}% of its bound, "
          f"under {100 * ROPE_BOUND_SHARE:.0f}%")
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
        library_ms=None, bound_ms=(5 * n + 4 * nscales) / mesh.HBM_BW * 1e3,
        bound_by="bytes",
        shape=f"{n} fp32 in {len(segs)} segments, {nscales} scales")
    rec["int8_dequant_matrix"] = dict(
        max_abs_err=max_err(dec, wdec),
        ms=time_ms([lambda: ops.wire_int8_decode(q, scales, segs, n)]),
        plain_ms=time_ms([lambda: ref.int8_decode_ref(q, scales, segs, n)]),
        library_ms=None, bound_ms=(5 * n + 4 * nscales) / mesh.HBM_BW * 1e3,
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
        library_ms=None, bound_ms=20 * n / mesh.HBM_BW * 1e3, bound_by="bytes",
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
        library_ms=None, bound_ms=(8 * n + 8 * k) / mesh.HBM_BW * 1e3,
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


def ssd_flops(B, S, H, P, N, chunk, G=1):
    """Operations the scan needs: C.B^T over the causal half (Q (Q + 1) / 2
    entries) once per (batch, group, chunk), since a group's Bm and Cm are
    shared by its heads; per (batch, head, chunk) M.x over the causal half,
    C.h^T and the state update."""
    Q = chunk
    return (B * G * (S // Q) * Q * (Q + 1) * N
            + B * H * (S // Q) * (Q * (Q + 1) * P + 4 * Q * N * P))


# the LM paths' attention: (record, (B, S, T, Hq, Hkv, q/k head dim, v head
# dim, causal, dtype), use)
LM_ATTENTION = (
    ("flash_attention", (4, 1024, 1024, 32, 32, 80, 80, True, "bfloat16"),
     "zamba2's shared block"),
    ("flash_attention_dense",
     (4, 1024, 1024, 16, 8, 128, 128, True, "bfloat16"), "the dense LM's"),
    ("flash_attention_cross",
     (2, 1024, 512, 16, 16, 64, 64, False, "bfloat16"),
     "seamless-m4t's cross attention"),
    ("flash_attention_encoder",
     (2, 512, 512, 16, 16, 64, 64, False, "bfloat16"),
     "seamless-m4t's encoder"),
    ("flash_attention_decoder",
     (2, 1024, 1024, 16, 16, 64, 64, True, "bfloat16"),
     "seamless-m4t's decoder self-attention"),
    ("flash_attention_mla",
     (2, 1024, 1024, 128, 128, 192, 128, True, "bfloat16"),
     "deepseek-v2's MLA, phase 2l"),
    ("flash_attention_mla_fp32",
     (2, 1024, 1024, 128, 128, 192, 128, True, "float32"),
     "deepseek-v2's MLA at fp32"),
    ("flash_attention_llama4",
     (2, 1024, 1024, 40, 8, 128, 128, True, "bfloat16"),
     "llama4-maverick's GQA 40/8"),
    ("flash_attention_mla_reduced",
     (4, 64, 64, 4, 4, 48, 32, True, "float32"),
     "deepseek-v2's reduced() MLA, the launcher's in phase 2l(b)"),
    ("flash_attention_decode",
     (4, 1, 128, 16, 8, 128, 128, False, "bfloat16"),
     "the dense LM's decode step over its 128-slot KV cache, phase 2m"),
    ("flash_attention_zamba2_7b",
     (1, 4096, 4096, 32, 32, 224, 224, True, "bfloat16"),
     "Zamba2-7B's shared block over the 7168-wide joined input"))
# their RMSNorms: (record, (rows, d, dtype[, G]), use); with G, x is (G,
# rows, d) and the scale (G, d), the form of a grouped or per-client scale
LM_RMSNORM = (
    ("rmsnorm_rows_2560", (4096, 2560, "float32"), "zamba2's residual stream"),
    ("rmsnorm_rows_5120", (4096, 5120, "float32"), "zamba2's gated norm"),
    ("rmsnorm_rows_2048", (4096, 2048, "float32"),
     "the dense LM's residual stream"),
    ("rmsnorm_rows_768", (4096, 768, "float32"),
     "the xLSTM's residual stream"),
    ("rmsnorm_rows_1536_bf16", (4096, 1536, "bfloat16"),
     "the mLSTM's inner norm"),
    ("rmsnorm_rows_1024", (2048, 1024, "float32"),
     "seamless-m4t's decoder blocks"),
    ("rmsnorm_rows_1024_enc", (1024, 1024, "float32"),
     "seamless-m4t's encoder blocks"),
    ("rmsnorm_rows_2048_decode", (4, 2048, "float32"),
     "the dense LM's decode step, batch 4, phase 2m"),
    ("rmsnorm_rows_3584", (4096, 3584, "float32"),
     "Zamba2-7B's residual stream and its shared block's ff norm"),
    ("rmsnorm_rows_7168", (4096, 7168, "float32"),
     "Zamba2-7B's shared block's norm over the joined [x, e] input"),
    ("rmsnorm_rows_3584_g2", (4096, 3584, "float32", 2),
     "Zamba2-7B's gated norm: 2 groups of rows, one scale row a group"))
# InfoNCE: (record suffix, (C, B, d)); a suffix of None is checked only
LM_INFONCE = (("", (1, 4, 2560)), (None, (1, 4, 5000)), (None, (2, 40, 4100)),
              ("xlstm", (1, 4, 768)), ("encdec", (1, 2, 1024)))
LM_INFONCE_USE = {"": "zamba2's alignment", "xlstm": "the xLSTM's alignment",
                  "encdec": "the encoder-decoder's alignment"}


def lm_kernel_checks():
    """The kernels at the LM paths' shapes against their plain versions,
    with times and bounds: the SSD scan (and a small case with another
    chunk, and the Function's backward), attention at each path's shapes
    and dtype (``LM_ATTENTION``; head dim 80 in fp32 too), RMSNorm at each
    path's rows and widths (``LM_RMSNORM``), InfoNCE on each alignment's
    pooled states and above 4096 (``LM_INFONCE``).
    Returns {record name: record of the LM path's shape}; each record names
    its kernel."""
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
    bms, by = bound(nbytes, 3 * ssd_flops(B, S, H, P, N, Q),
                    mesh.PEAK_FLOPS_TF32)
    rec["ssd_scan"] = dict(
        max_abs_err=max_err(ops.ssd_scan(*sets[0], chunk=Q),
                            ref.ssd_scan_ref(*sets[0], chunk=Q)),
        kernel="ssd_scan",
        ms=time_ms([lambda a=a: ops.ssd_scan(*a, chunk=Q) for a in sets]),
        plain_ms=time_ms([lambda a=a: ref.ssd_scan_ref(*a, chunk=Q)
                          for a in sets]),
        library_ms=None, bound_ms=bms, bound_by=by,
        shape=f"xh ({B}, {S}, {H}, {P}), N {N}, chunk {Q}, fp32 "
              f"(one Mamba2 block of the LM path)")
    # the prefill hand-off: the scan from a non-zero h0, returning its
    # final state, against the plain scan with the same h0
    h0s = [0.5 * torch.randn((B, H, P, N), generator=gen, device=dev)
           for _ in sets]

    def with_h0(i):
        return ops.ssd_scan(*sets[i], chunk=Q, h0=h0s[i], return_state=True)

    def plain_h0(i):
        return ref.ssd_scan_ref(*sets[i], chunk=Q, h0=h0s[i],
                                return_state=True)

    line(f"ssd_scan ({B}, {S}, {H}, {P}) N {N} chunk {Q} fp32 from a "
         f"non-zero h0, y and the final state", rel(with_h0(0), plain_h0(0)),
         1e-4)
    ins = [t.clone().requires_grad_() for t in ssd_inputs(2, 256, 4, 32, 16,
                                                          gen)]
    h0 = (0.5 * torch.randn((2, 4, 32, 16), generator=gen, device=dev)) \
        .requires_grad_()
    gy = torch.randn((2, 256, 4, 32), generator=gen, device=dev)
    gh = torch.randn((2, 4, 32, 16), generator=gen, device=dev)
    grads = []
    for fn in (ops.ssd_scan, ref.ssd_scan_ref):
        y, h = fn(*ins, chunk=64, h0=h0, return_state=True)
        grads.append(torch.autograd.grad((y * gy).sum() + (h * gh).sum(),
                                         ins + [h0]))
    line("ssd_scan backward from h0 (2, 256, 4, 32) N 16 chunk 64, every "
         "input's gradient and h0's", max(rel(a, b) for a, b in
                                          zip(*grads)), 1e-4)
    # h0 read and the final state written, 2 x B H P N floats more
    bms, by = bound(nbytes + 4 * 2 * B * H * P * N,
                    3 * ssd_flops(B, S, H, P, N, Q), mesh.PEAK_FLOPS_TF32)
    rec["ssd_scan_h0"] = dict(
        max_abs_err=max_err(with_h0(0), plain_h0(0)), kernel="ssd_scan",
        ms=time_ms([lambda i=i: with_h0(i) for i in range(len(sets))]),
        plain_ms=time_ms([lambda i=i: plain_h0(i) for i in range(len(sets))]),
        library_ms=None, bound_ms=bms, bound_by=by,
        shape=f"xh ({B}, {S}, {H}, {P}), N {N}, chunk {Q}, fp32, from a "
              f"non-zero h0, returning the final state (the prefill "
              f"hand-off)")
    r = rec["ssd_scan_h0"]
    print(f"  ssd_scan with h0 [{r['shape']}]: kernel {r['ms']} ms, plain "
          f"{r['plain_ms']} ms, bound {r['bound_ms']} ms ({r['bound_by']}); "
          f"without h0 {rec['ssd_scan']['ms']} ms", flush=True)
    # two groups of B and C: Zamba2-7B's Mamba2 layers (112 heads of 64,
    # head h reading group h // 56)
    B, S, H, P, N, G, Q = 1, 4096, 112, 64, 64, 2, 256

    def grouped():
        x, dt, a, _, _ = ssd_inputs(B, S, H, P, N, gen)
        bc = F.silu(torch.randn((B, S, 2 * G * N), generator=gen,
                                device=dev))
        return (x, dt, a, *(t.unflatten(-1, (G, N))
                            for t in bc.split(G * N, dim=-1)))
    sets = [grouped() for _ in range(2)]
    line(f"ssd_scan ({B}, {S}, {H}, {P}) N {N} G {G} chunk {Q} fp32",
         rel(ops.ssd_scan(*sets[0], chunk=Q),
             ref.ssd_scan_ref(*sets[0], chunk=Q)), 1e-4)
    bms, by = bound(4 * (2 * B * S * H * P + 2 * B * S * H + 2 * B * S * G * N
                         + B * H * P * N),
                    3 * ssd_flops(B, S, H, P, N, Q, G), mesh.PEAK_FLOPS_TF32)
    rec["ssd_scan_g2"] = dict(
        max_abs_err=max_err(ops.ssd_scan(*sets[0], chunk=Q),
                            ref.ssd_scan_ref(*sets[0], chunk=Q)),
        kernel="ssd_scan",
        ms=time_ms([lambda a=a: ops.ssd_scan(*a, chunk=Q) for a in sets]),
        plain_ms=time_ms([lambda a=a: ref.ssd_scan_ref(*a, chunk=Q)
                          for a in sets]),
        library_ms=None, bound_ms=bms, bound_by=by,
        shape=f"xh ({B}, {S}, {H}, {P}), N {N}, G {G}, chunk {Q}, fp32 "
              f"(one Mamba2 layer of Zamba2-7B)")
    r = rec["ssd_scan_g2"]
    print(f"  ssd_scan grouped [{r['shape']}]: kernel {r['ms']} ms, plain "
          f"{r['plain_ms']} ms, bound {r['bound_ms']} ms ({r['bound_by']})",
          flush=True)

    # attention at each path's shapes, against ref.sdpa_ref: bf16 within
    # 2e-2, fp32 within 1e-5 of the largest value; beside
    # F.scaled_dot_product_attention
    for name, (B, S, T, Hq, Hkv, hd, dv, causal, dtype), what in \
            LM_ATTENTION:
        dt = getattr(torch, dtype)
        nbytes = dt.itemsize * B * (S * Hq * (hd + dv) + T * Hkv * (hd + dv))
        sets = [tuple(torch.randn((B, n, h, w), generator=gen, device=dev)
                      .to(dt) for n, h, w in ((S, Hq, hd), (T, Hkv, hd),
                                              (T, Hkv, dv)))
                for _ in range(copies(nbytes))]

        def plain(q, k, v, causal=causal):
            return ref.sdpa_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2),
                                causal=causal).transpose(1, 2)

        err = max_err(ops.flash_attention(*sets[0], causal=causal),
                      plain(*sets[0]))
        dims = f"{hd}" if dv == hd else f"{hd} / {dv}"
        shape = (f"q ({B}, {S}, {Hq}), k, v ({B}, {T}, {Hkv}), head dims "
                 f"{dims}, {dtype}, {'causal' if causal else 'non-causal'} "
                 f"({what})")
        if dt == torch.bfloat16:
            print(f"  {name} {shape}: max |kernel - plain| = {err:.3e} "
                  f"(tolerance 2e-2)", flush=True)
            check(err <= 2e-2, f"{name}: error {err}")
        else:
            line(f"{name} {shape}",
                 rel(ops.flash_attention(*sets[0], causal=causal),
                     plain(*sets[0])), 1e-5)
        if name == "flash_attention":
            q32 = [t.float() for t in sets[0]]
            line(f"flash_attention ({B}, {S}, {Hq}, {hd}) fp32 causal",
                 rel(ops.flash_attention(*q32, causal=True), plain(*q32)),
                 1e-5)
        bhsd = [tuple(t.transpose(1, 2).contiguous() for t in qkv)
                for qkv in sets]
        pairs = S * (S + 1) // 2 if causal else S * T
        bms, by = bound(nbytes, 2 * B * Hq * pairs * (hd + dv),
                        mesh.PEAK_FLOPS_BF16 if dt == torch.bfloat16
                        else mesh.PEAK_FLOPS_FP32)
        rec[name] = dict(
            kernel="flash_attention", max_abs_err=err,
            ms=time_ms([lambda a=a: ops.flash_attention(*a, causal=causal)
                        for a in sets]),
            plain_ms=time_ms([lambda a=a: plain(*a) for a in sets]),
            library_ms=time_ms([lambda a=a: F.scaled_dot_product_attention(
                *a, is_causal=causal, enable_gqa=Hq != Hkv) for a in bhsd]),
            bound_ms=bms, bound_by=by, shape=shape)

    # RMSNorm at each path's rows and width: fp32 within 1e-5 of the
    # largest value, bf16 (rounded once, like the plain version) within 2e-2
    for name, (R, d, dtype, *grp), what in LM_RMSNORM:
        dt = getattr(torch, dtype)
        size = dt.itemsize
        G = grp[0] if grp else 1
        lead = (G,) if grp else ()
        xs = [torch.randn(lead + (R, d), generator=gen, device=dev).to(dt)
              for _ in range(copies(2 * size * G * R * d))]
        sc = 1 + 0.1 * torch.randn(lead + (d,), generator=gen, device=dev)
        err = max_err(ops.rmsnorm(xs[0], sc), ref.rmsnorm_ref(xs[0], sc))
        where = f"rmsnorm_rows {lead + (R, d)}" + (
            f" scale {tuple(sc.shape)}" if grp else "")
        if dt == torch.float32:
            line(f"{where} fp32",
                 rel(ops.rmsnorm(xs[0], sc), ref.rmsnorm_ref(xs[0], sc)),
                 1e-5)
        else:
            print(f"  {where} {dtype}: max |kernel - plain| "
                  f"= {err:.3e} (tolerance 2e-2)", flush=True)
            check(err <= 2e-2, f"{where} {dtype}: error {err}")
        n = G * R * d
        bms, by = bound(2 * size * n + 4 * G * d, 4 * n)
        rec[name] = dict(
            kernel="rmsnorm_rows", max_abs_err=err,
            ms=time_ms([lambda a=a: ops.rmsnorm(a, sc) for a in xs]),
            plain_ms=time_ms([lambda a=a: ref.rmsnorm_ref(a, sc)
                              for a in xs]),
            # the library's norm takes one scale row
            library_ms=None if grp else time_ms([lambda a=a: F.rms_norm(
                a, (d,), sc.to(a.dtype), 1e-5) for a in xs]),
            bound_ms=bms, bound_by=by,
            shape=f"x {lead + (R, d)} {dtype}" + (
                f", scale {tuple(sc.shape)}" if grp else "") + f" ({what})")

    # InfoNCE forward, dq and dk on the alignment's mean-pooled states, and
    # wider; each within 1e-5 of the largest plain value
    tau = 0.2
    for tag, (C, Bn, d) in LM_INFONCE:
        q, k = (F.normalize(torch.randn((C, Bn, d), generator=gen,
                                        device=dev), dim=-1)
                for _ in range(2))
        gg = torch.randn((C, Bn), generator=gen, device=dev) / Bn
        loss, lse = nce.info_nce_fwd(q, k, tau)
        wl, wlse = ref.info_nce_rows_ref(q, k, tau)
        errs = {"info_nce_rows": rel([loss, lse], [wl, wlse])}
        for kname, wrt_k in (("info_nce_rows_dq", False),
                             ("info_nce_rows_dk", True)):
            errs[kname] = rel(nce.info_nce_bwd(q, k, wlse, gg, tau, wrt_k),
                              ref.info_nce_rows_bwd_ref(q, k, wlse, gg, tau,
                                                        wrt_k))
        for kname, e in errs.items():
            line(f"{kname} ({C}, {Bn}, {d})", e, 1e-5)
        if tag is None:
            continue
        suffix = f"_{tag}" if tag else ""
        shape = f"q, k ({C}, {Bn}, {d}) fp32 ({LM_INFONCE_USE[tag]})"
        labels = torch.arange(Bn, device=dev)
        two = time_ms([lambda: F.cross_entropy(
            torch.matmul(q[0], k[0].transpose(0, 1)) / tau, labels,
            reduction="none")])
        bms, by = bound(4 * (2 * C * Bn * d + 2 * C * Bn),
                        2 * C * Bn * Bn * d)
        rec["info_nce_rows" + suffix] = dict(
            kernel="info_nce_rows",
            max_abs_err=max_err([loss, lse], [wl, wlse]),
            ms=time_ms([lambda: nce.info_nce_fwd(q, k, tau)]),
            plain_ms=time_ms([lambda: ref.info_nce_rows_ref(q, k, tau)]),
            library_ms=None, bound_ms=bms, bound_by=by, context_ms=two,
            shape=f"{shape}; matmul + cross_entropy {two} ms (two calls)")
        for kname, wrt_k in (("info_nce_rows_dq", False),
                             ("info_nce_rows_dk", True)):
            bms, by = bound(4 * (3 * C * Bn * d + 2 * C * Bn),
                            4 * C * Bn * Bn * d)
            rec[kname + suffix] = dict(
                kernel=kname,
                max_abs_err=max_err(
                    nce.info_nce_bwd(q, k, wlse, gg, tau, wrt_k),
                    ref.info_nce_rows_bwd_ref(q, k, wlse, gg, tau, wrt_k)),
                ms=time_ms([lambda w=wrt_k: nce.info_nce_bwd(
                    q, k, wlse, gg, tau, w)]),
                plain_ms=time_ms([lambda w=wrt_k: ref.info_nce_rows_bwd_ref(
                    q, k, wlse, gg, tau, w)]),
                library_ms=None, bound_ms=bms, bound_by=by, shape=shape)
    # RoPE at Zamba2-7B's shared block (the benchmark's zamba2-7b cell)
    rec["rope_zamba2_7b"] = rope_record((1, 4096, 32, 224), 32,
                                        torch.bfloat16, gen,
                                        "Zamba2-7B's shared block")
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
                             "ssd_chunk_scan_kernel"),
                "rope": ("rope_rotate_kernel",)}


def vmap_memory_check(model_cfg, ssl_cfg, batch=256, clients=(1, 4)):
    """One e2e local step at full width, batch 256, on each engine's step
    function: the sequential engine's ``train_step``, then the vmap
    engine's ``stacked_train_step`` at each C of ``clients`` from one
    expanded state, as the engine's first local step of a round. Each step
    runs once to warm up, then once measured: the allocator's peak during
    it above what was allocated just before it (the state, moments and
    views). Returns {0 (sequential) or C: (peak MiB above the state, MiB
    the state, moments and views hold, ms of the measured step)}."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data import augment
    from repro_torch.federated import client as client_mod
    from repro_torch.optim import make_optimizer

    dev = torch.device("cuda")
    enc = ssl_mod.make_vit_encoder(model_cfg)
    opt = make_optimizer(TrainConfig(batch_size=batch))
    kw = dict(encoder=enc, ssl_cfg=ssl_cfg, opt=opt,
              sub_layers=enc.num_stages, active_from=0)
    out = {}
    for C in (0, *clients):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        gen = torch.Generator(dev).manual_seed(0)
        state = ssl_mod.ssl_init(enc, ssl_cfg, gen, dev)
        img = torch.rand(max(C, 1), batch, 32, 32, 3, generator=gen,
                         device=dev)
        views = [augment.two_views(x, augment.draw_params(gen, batch, 32, 32),
                                   augment.draw_params(gen, batch, 32, 32))
                 for x in img]
        if C == 0:
            opt_state = opt.init(state["online"])

            def step():
                return client_mod.train_step(state, opt_state, *views[0],
                                             1e-4, **kw)
        else:
            cstate = {br: {k: v.expand(C, *v.shape) for k, v in t.items()}
                      for br, t in state.items()}
            opt_state = client_mod.stacked_opt_init(opt, cstate["online"])
            x1 = torch.stack([v[0] for v in views])
            x2 = torch.stack([v[1] for v in views])

            def step():
                return client_mod.stacked_train_step(cstate, opt_state, x1,
                                                     x2, 1e-4, **kw)
        del img
        step()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        result = step()
        torch.cuda.synchronize()
        out[C] = ((torch.cuda.max_memory_allocated() - base) / 2**20,
                  (base - before) / 2**20, (time.perf_counter() - t) * 1e3)
        del result, step, state, views, opt_state
        if C:
            del cstate, x1, x2
    return out


def grad_memory_split(model_cfg, ssl_cfg, batch=256):
    """What each way of taking a gradient holds: one e2e local step's
    loss and gradient at full width, batch 256, taken four ways: plain
    autograd (the sequential engine's ``torch.autograd.grad``), a
    ``torch.func.vmap`` of one client with autograd outside it (the vmap
    engine's, ``client.stacked_loss_and_grads``),
    ``torch.func.grad_and_value`` under ``vmap``, and ``grad_and_value``
    alone (both keep the backward's intermediates to the end). Returns
    {way: (MiB allocated at the end of the forward, MiB peak, both above
    the bytes held before it; ms of the call, host clock to a
    synchronise)}."""
    import torch
    from torch.func import grad_and_value, vmap
    from repro_torch.core import ssl as ssl_mod
    from repro_torch.data import augment

    dev = torch.device("cuda")
    enc = ssl_mod.make_vit_encoder(model_cfg)
    gen = torch.Generator(dev).manual_seed(0)
    state = ssl_mod.ssl_init(enc, ssl_cfg, gen, dev)
    img = torch.rand(batch, 32, 32, 3, generator=gen, device=dev)
    x1, x2 = augment.two_views(img, augment.draw_params(gen, batch, 32, 32),
                               augment.draw_params(gen, batch, 32, 32))
    fwd_end = {}

    def loss_fn(online, target, a, b, way):
        loss, m = ssl_mod.ssl_loss({"online": online, "target": target}, a,
                                   b, enc, ssl_cfg)
        torch.cuda.synchronize()
        fwd_end[way] = torch.cuda.memory_allocated()
        return loss, m

    one = {br: {k: v[None] for k, v in state[br].items()}
           for br in ("online", "target")}

    def autograd():
        on = {k: v.detach().requires_grad_()
              for k, v in state["online"].items()}
        loss, _ = loss_fn(on, state["target"], x1, x2, "autograd")
        return torch.autograd.grad(loss, list(on.values()),
                                   allow_unused=True)

    def vmap_autograd():
        on = {k: v.detach().clone().requires_grad_()
              for k, v in one["online"].items()}
        loss = vmap(lambda o, t, a, b: loss_fn(o, t, a, b, "vmap_autograd")
                    [0])(on, one["target"], x1[None], x2[None])
        return torch.autograd.grad(loss.sum(), list(on.values()),
                                   allow_unused=True)

    def vmap_func_grad():
        return vmap(lambda o, t, a, b: grad_and_value(
            lambda oo: loss_fn(oo, t, a, b, "vmap_func_grad"),
            has_aux=True)(o))(one["online"], one["target"], x1[None],
                              x2[None])

    def func_grad():
        return grad_and_value(
            lambda oo: loss_fn(oo, state["target"], x1, x2, "func_grad"),
            has_aux=True)(state["online"])

    out = {}
    for way, fn in (("autograd", autograd), ("vmap_autograd", vmap_autograd),
                    ("vmap_func_grad", vmap_func_grad),
                    ("func_grad", func_grad)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        out[way] = ((fwd_end[way] - base) / 2**20,
                    (torch.cuda.max_memory_allocated() - base) / 2**20, ms)
        del result
    return out


def dispatch_overhead(calls=2000):
    """Host microseconds a call of a kernel-backed op takes to enqueue,
    called directly and through its ``torch.library.custom_op`` (the route
    it takes while a FLOP counter is active), at the ViT's attention and
    MoCo InfoNCE shapes; each timed twice, in turns."""
    import torch
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(256, 65, 3, 64, generator=g, device=dev).to(
        torch.bfloat16)
    qn = torch.nn.functional.normalize(
        torch.randn(1, 256, 256, generator=g, device=dev), dim=-1)
    cases = {"attention": (
        lambda: ops._attention_impl(q, q, q, False, 0, None, None),
        lambda: ops._attention_op(q, q, q, False, 0, None, None)),
        "info_nce": (lambda: ops._info_nce_impl(qn, qn, 0.2),
                     lambda: ops._info_nce_op(qn, qn, 0.2))}
    out = {}
    for name, (direct, op) in cases.items():
        for f in (direct, op):
            for _ in range(50):
                f()
        times = {"direct": [], "custom_op": []}
        for label, f in (("direct", direct), ("custom_op", op),
                         ("custom_op", op), ("direct", direct)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                f()
            times[label].append((time.perf_counter() - t) / calls * 1e6)
            torch.cuda.synchronize()
        out[name] = times
    return out


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

    def marked_backward(ctx, *grads):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain_backward(ctx, *grads)
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
    ctx = types.SimpleNamespace(saved_tensors=(*ins, None), chunk=256,
                                layout=None)
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
    t_mem = time.perf_counter()
    mem = vmap_memory_check(model_cfg, ssl_cfg)
    seq_mib = mem[0][0]
    slope = ((mem[4][0] + mem[4][1]) - (mem[1][0] + mem[1][1])) / 3
    fixed = mem[1][0] + mem[1][1] - slope
    total = torch.cuda.get_device_properties(0).total_memory / 2**20
    print(f"  one e2e step's peak above its state, full width, batch 256: "
          f"sequential {seq_mib:.1f} MiB; vmap "
          + ", ".join(f"C={c} {mem[c][0]:.1f} MiB ({mem[c][0] / c:.1f} a "
                      f"client, {mem[c][0] / (c * seq_mib):.3f}x C x "
                      f"sequential)" for c in (1, 4))
          + "; ms of the measured step: " + ", ".join(
              f"{'sequential' if c == 0 else f'C={c}'} {m[2]:.1f}"
              for c, m in mem.items())
          + f"; state, moments and views held: sequential "
          f"{mem[0][1]:.1f}, C=1 {mem[1][1]:.1f}, C=4 {mem[4][1]:.1f} MiB; "
          f"{slope:.1f} MiB a client over {fixed:.1f} MiB, so "
          f"{total:.0f} MiB holds {int((total - fixed) // slope)} clients "
          f"({time.perf_counter() - t_mem:.1f}s) on {card}", flush=True)
    for c in (1, 4):
        check(mem[c][0] <= 1.25 * c * seq_mib,
              f"vmap step at C={c} holds {mem[c][0]:.1f} MiB above its "
              f"state, over 1.25 x {c} x the sequential step's "
              f"{seq_mib:.1f}")

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
    want_scans, want_attn, want_rope = lm_expected_launches(lcfg, lplans,
                                                            lsteps)
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
    check(launches["lm"]["rope"] == want_rope,
          f"rope launched {launches['lm']['rope']} times, the plan implies "
          f"{want_rope}")
    check(launches["lm"]["info_nce_rows_dk"] == 0,
          "info_nce_rows_dk launched on the LM path (its k is detached)")
    check_repeat("LM", lhist, lcfg, LM_RUN)
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

    print("[2f] resources, the paper's table and the fleet simulator: the "
          "paper table at full ViT-Tiny width, batch 256, both engines x "
          "five schedules; the fleet simulator and --measure-resources at "
          f"full width, {FLEET_LAYERS} blocks", flush=True)
    t2f = time.perf_counter()
    torch.cuda.empty_cache()
    print(card, flush=True)
    paper_table_phase()
    fleet_phase(model_cfg, ssl_cfg)
    print(f"  phase 2f took {time.perf_counter() - t2f:.1f}s", flush=True)

    print("[2g] privacy and checkpoints: DP pass-through against phase 2, "
          "DP on both engines, secure aggregation at the stage-12 payload "
          f"and in rounds, the {LM_ARCH} path with DP and secure "
          "aggregation, the checkpoint round trip", flush=True)
    torch.cuda.empty_cache()
    launches.update(privacy_phase(model_cfg, ssl_cfg, state, hist,
                                  launches["int8"]))

    print("[2h] the other SSL methods and optimizers on phase 2's main "
          "path (fp32 wire, 12 rounds): " + "; ".join(
              f"{m} + {o} on the {e} engine" for m, o, e in METHOD_RUNS),
          flush=True)
    t2h = time.perf_counter()
    launches.update(methods_phase(model_cfg, state, hist))
    print(f"  phase 2h took {time.perf_counter() - t2h:.1f}s", flush=True)

    print(f"[2i] dense LM: LW-FedSSL on {DENSE_ARCH} at its published "
          f"widths, {DENSE_LAYERS} blocks, {DENSE_RUN['clients']} clients, "
          f"{DENSE_RUN['rounds']} rounds, batch {DENSE_RUN['batch']} x "
          f"{DENSE_RUN['seq_len']} tokens, fp32 wire; then both LM engines "
          f"at {DENSE_VMAP_LAYERS} blocks, batch {DENSE_VMAP_RUN['batch']} x "
          f"{DENSE_VMAP_RUN['seq_len']}", flush=True)
    t2i = time.perf_counter()
    launches.update(dense_phase())
    print(f"  phase 2i took {time.perf_counter() - t2i:.1f}s", flush=True)

    print(f"[2j] xLSTM LM: LW-FedSSL on {XLSTM_ARCH} at its published "
          f"widths and depth, {XLSTM_RUN['clients']} clients, "
          f"{XLSTM_RUN['rounds']} rounds, batch {XLSTM_RUN['batch']} x "
          f"{XLSTM_RUN['seq_len']} tokens, fp32 wire, on both LM engines",
          flush=True)
    t2j = time.perf_counter()
    got, xlstm_pack_rec = xlstm_phase()
    launches.update(got)
    print(f"  phase 2j took {time.perf_counter() - t2j:.1f}s", flush=True)

    print(f"[2k] encoder-decoder: {ENCDEC_ARCH} at its published widths, "
          f"make_train_step at full depth, then make_fl_round_program at "
          f"{ENCDEC_ROUNDS['layers']} + {ENCDEC_ROUNDS['layers']} blocks",
          flush=True)
    t2k = time.perf_counter()
    got, encdec_pack_rec = encdec_phase()
    launches.update(got)
    print(f"  phase 2k took {time.perf_counter() - t2k:.1f}s", flush=True)

    print(f"[2l] MoE and MLA: LW-FedSSL on {MOE_ARCH} at its published "
          f"widths, {MOE_LAYERS} blocks of {MOE_EXPERTS} routed experts, "
          f"{MOE_RUN['clients']} clients, {MOE_RUN['rounds']} rounds, batch "
          f"{MOE_RUN['batch']} x {MOE_RUN['seq_len']} tokens, "
          f"{MOE_RUN['optimizer']}, fp32 wire; then the launcher on "
          f"{' and '.join(LAUNCHER_MOE_ARCHS)} at reduced(), both engines",
          flush=True)
    t2l = time.perf_counter()
    launches.update(moe_phase())
    launcher_moe_runs()
    print(f"  phase 2l took {time.perf_counter() - t2l:.1f}s", flush=True)

    print(f"[2m] serving: python -m repro_torch.launch.serve --full on "
          f"{SERVE_ARCH} (batch {SERVE_RUN['batch']}, "
          f"{SERVE_RUN['prompt_len']} prompt + {SERVE_RUN['gen']} generated "
          f"tokens); decode against forward on every family at fp32; the "
          f"ring buffer", flush=True)
    t2m = time.perf_counter()
    launches.update(serve_phase())
    print(f"  phase 2m took {time.perf_counter() - t2m:.1f}s", flush=True)

    print("[2n] sharding: deepseek-v2's MoE layer with all 160 routed "
          "experts as 4 expert shards; the sharded train step on a "
          "one-rank mesh; the dry runs on meta; the prefill hand-off on "
          "phase 2d's zamba2 model", flush=True)
    t2n = time.perf_counter()
    launches.update(sharding_phase())
    print(f"  phase 2n took {time.perf_counter() - t2n:.1f}s", flush=True)
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(launches[path][name] > 0,
                  f"{name} never launched on the {path} path")

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
    lm_rec.update(zamba2_pack_checks())
    lm_rec.update(lm_pack_rec)
    lm_rec.update(xlstm_pack_rec)
    lm_rec.update(encdec_pack_rec)
    rec["ssd_scan"] = lm_rec["ssd_scan"]
    at_lm = {}                      # the LM paths' shapes, by kernel
    for n, r in lm_rec.items():
        if n != "ssd_scan":
            at_lm.setdefault(r["kernel"], []).append(n)
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
        split = grad_memory_split(model_cfg, ssl_cfg)
        print("  one e2e step's memory above what it starts from, MiB (end "
              "of the forward, peak; vmap_autograd is the vmap engine's "
              "route) and ms of the call: " + "; ".join(
                  f"{k} {a:.1f}, {b:.1f}, {ms:.1f} ms"
                  for k, (a, b, ms) in split.items()), flush=True)
        print("  host us a call to enqueue, direct and through the custom "
              "op (two runs each of 2000 calls): " + "; ".join(
                  f"{k} direct {[round(x, 2) for x in v['direct']]}, "
                  f"custom op {[round(x, 2) for x in v['custom_op']]}"
                  for k, v in dispatch_overhead().items()), flush=True)
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
