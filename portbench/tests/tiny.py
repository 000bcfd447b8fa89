"""Tiny cells for the harness's CPU tests: the two traffic drivers at a
few thousand parameters, defined only by files in a folder of their own
(``BENCHMARK.json``, configs, traffic mixes, limits), as a later PR would
add a cell."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

VIT = {"arch_id": "vit-tiny", "family": "dense", "num_layers": 2,
       "d_model": 16, "num_heads": 2, "num_kv_heads": 2, "d_ff": 32,
       "vocab_size": 0, "head_dim": 0, "rope_theta": 10000.0,
       "causal": False, "act": "gelu", "norm_eps": 1e-05,
       "param_dtype": "float32", "compute_dtype": "bfloat16"}
LM = {"arch_id": "zamba2-2.7b", "family": "hybrid", "num_layers": 4,
      "d_model": 32, "num_heads": 2, "num_kv_heads": 2, "d_ff": 64,
      "vocab_size": 64, "head_dim": 16, "rope_theta": 10000.0,
      "causal": True, "act": "swiglu", "attn_every": 2, "norm_eps": 1e-05,
      "param_dtype": "float32", "compute_dtype": "bfloat16",
      "ssm": {"state_dim": 8, "head_dim": 16, "expand": 2, "conv_width": 4,
              "chunk_size": 8}}
TRAIN = {"optimizer": "adamw", "base_lr": 0.00015, "weight_decay": 1e-05,
         "lr_schedule": "cosine", "batch_size": 8, "b1": 0.9, "b2": 0.999,
         "eps": 1e-08}
SSL = {"method": "moco_v3", "temperature": 0.2, "momentum": 0.99,
       "proj_dim": 8, "proj_hidden": 16, "pred_hidden": 16,
       "align_weight": 0.01}
MIXES = {
    "tiny-vit": {"driver": "fedssl_vit", "schedule": "lw_fedssl",
                 "stage": 2, "stage_rounds": 10, "engine": "vmap",
                 "codec": "fp32", "clients": 2, "clients_per_round": 0,
                 "images_per_client": 16, "local_epochs": 1,
                 "weight_transfer": True, "aux_fraction": 0.5,
                 "server_epochs": 1, "check_rounds": 2, "trace_rounds": 1},
    "tiny-lm": {"driver": "fedssl_lm", "schedule": "lw_fedssl", "stage": 2,
                "stage_rounds": 10, "engine": "sequential", "codec": "fp32",
                "clients": 2, "seqs_per_client": 4, "seq_len": 16,
                "local_epochs": 1, "weight_transfer": True,
                "check_rounds": 2, "trace_rounds": 1},
}
LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}
# the LM mixes' metrics, which no cell of BENCHMARK.json reports yet
LM_METRICS = {
    "end_to_end": [{"name": "lm_tokens_per_s", "unit": "tokens/s",
                    "better": "higher", "bound": 0.01,
                    "source": "host_clock", "workloads": ["lm"]}],
    "per_layer": [{"name": n, "unit": "%", "better": b, "source": src,
                   "layer": layer, "moves": "lm_tokens_per_s",
                   "workloads": ["lm"]}
                  for n, b, src, layer in [
                      ("local_train_pct.lm", "higher", "program_span",
                       "engine"),
                      ("mfu_pct.lm", "higher", "host_clock", "whole step"),
                      ("ssd_scan_roofline_pct.lm", "higher", "device_trace",
                       "kernels"),
                      ("device_idle_pct.lm", "lower", "device_trace",
                       "device")]]}


def make_root(tmp: Path, compute_dtype: str = "float32", limits=None,
              **mix_changes) -> Path:
    """A folder holding only the files of the cells ``vit`` and ``lm``
    (and the harness's BENCHMARK.json metrics, their workloads renamed,
    with ``LM_METRICS`` for ``lm``)."""
    tmp = Path(tmp)
    for d in ("configs", "traffic", "workloads"):
        (tmp / "portbench" / d).mkdir(parents=True, exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    vit = {"name": "tiny-vit", "model": {**VIT, "compute_dtype":
                                        compute_dtype},
           "ssl": SSL, "train": TRAIN}
    lm = {"name": "tiny-lm", "model": {**LM, "compute_dtype": compute_dtype},
          "train": {**TRAIN, "batch_size": 2}}
    for cfg in (vit, lm):
        (tmp / "portbench" / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
    for name, mix in MIXES.items():
        (tmp / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps({**mix, **mix_changes}))
    for cell in ("vit", "lm"):
        (tmp / "portbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": limits or LIMITS}))
    bench["configs"] = [
        {"name": n, "source": "tests", "file": f"portbench/configs/{n}.json",
         "reduced": [], "why": "a CPU test"} for n in ("tiny-vit", "tiny-lm")]
    bench["workloads"] = [
        {"name": c, "config": f"tiny-{c}", "traffic": f"tiny-{c}",
         "chips": 1, "why": "a CPU test"} for c in ("vit", "lm")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["vit" if "vit" in w else "lm"
                              for w in m["workloads"]]
    for key, ms in LM_METRICS.items():
        have = {m["name"] for m in bench[key]}
        bench[key] += [m for m in ms if m["name"] not in have]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
