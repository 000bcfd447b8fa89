"""The Zamba2 cell's files, counts, plain reference and a tiny copy of the
cell run through the harness on the CPU."""
import importlib.util
import json
import math
import time
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.counts import zamba2 as counts
from portbench.lib import cells
from portbench.reference import zamba2 as ref
from portbench.reference.common import Numerics, round_plan
from portbench.tests.tiny import ROOT

CELL = "zamba2-7b.lw-s3.seq4"
METRICS = {"attn_fwd_roofline_pct.zamba2", "ssd_scan_roofline_pct.zamba2",
           "mfu_pct.zamba2", "device_idle_pct.zamba2",
           "local_train_pct.zamba2"}
TINY = {"arch_id": "zamba2-7b", "family": "hybrid", "num_layers": 6,
        "d_model": 32, "num_heads": 4, "num_kv_heads": 4, "d_ff": 64,
        "vocab_size": 64, "head_dim": 16, "rope_theta": 10000.0,
        "causal": True, "act": "geglu", "norm_eps": 1e-05,
        "tie_embeddings": True, "param_dtype": "float32",
        "compute_dtype": "float32", "hybrid_layer_ids": [2, 3, 5],
        "num_mem_blocks": 2, "adapter_rank": 4, "stage_layers": 2,
        "ssm": {"state_dim": 8, "head_dim": 8, "expand": 2, "conv_width": 4,
                "chunk_size": 8, "n_groups": 2}}


def _published():
    spec = importlib.util.spec_from_file_location(
        "zamba2_published", ROOT / "references" / "zamba2_published.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cell_files_load():
    c = cells.load(ROOT, CELL)
    assert c.chips == 1 and c.traffic["driver"] == "fedssl_zamba2"
    assert cells.driver(c).Run.__module__ == "portbench.drivers.fedssl_zamba2"
    assert {m["name"] for m in c.per_layer} == METRICS
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "peak_mem_gib"}
    for m in c.per_layer:
        assert m["moves"] == "setup_s" and callable(cells.reader(ROOT,
                                                                 m["name"]))
    m = c.config["model"]
    assert (m["d_model"], m["num_heads"], m["head_dim"], m["d_ff"]) == \
        (3584, 32, 224, 14336)
    assert m["ssm"]["n_groups"] == 2 and m["hybrid_layer_ids"] == [6, 11, 17]
    assert c.config["hybrid_layer_ids"] == m["hybrid_layer_ids"]
    assert c.config["num_hidden_layers"] == m["num_layers"] == 18


def _reckoned(cfg, mix, plan):
    """The round's FLOPs from the layout's shapes: 2 x tokens x each
    product's weight, the convolution's taps, and the scan and attention
    by their own sums over positions."""
    m = cfg["model"]
    T = cfg["train"]["batch_size"] * mix["seq_len"]
    S, per = mix["seq_len"], m["stage_layers"]
    shapes = {k: s for k, (s, _) in ref.layout(m).items()}
    products = ("w_in", "w_out", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                "w_down", "adapter_a", "adapter_b", "linear")

    def weights(prefix):
        return sum(math.prod(s) for k, s in shapes.items()
                   if k.startswith(prefix) and k.split("/")[-1] in products)
    s = m["ssm"]
    H = s["expand"] * m["d_model"] // s["head_dim"]
    G, N, P, Q = s["n_groups"], s["state_dim"], s["head_dim"], s["chunk_size"]
    conv = shapes["layers/0/mamba/conv_w"]
    # the scan: per chunk and group C.B^T on i >= j; per head the masked
    # M.x on i >= j, C.h^T and the state update (2 N P each a position)
    scan = sum(2 * N * G + 2 * P * H for i in range(Q) for j in range(i + 1))
    scan = scan * (S // Q) + S * H * 4 * N * P
    mamba = 2 * T * weights("layers/0/") + 2 * T * math.prod(conv) + scan
    # attention's causal half as the port's FLOP formula counts it (S^2 / 2
    # pairs: ``ops.attention_flops``), q.k and p.v 2 hd each a pair
    att = 2 * 2 * m["head_dim"] * S * S // 2
    use = 2 * T * (weights("mem_blocks/0/") + weights("hybrid/0/")) \
        + att * m["num_heads"]
    built = plan.sub_layers * per
    uses = [l for l in m["hybrid_layer_ids"] if l < built]

    def fwd(lo, hi):
        return (hi - lo) * mamba + sum(use for l in uses if lo <= l < hi)
    head = 2 * T * m["d_model"] * m["vocab_size"]
    step = 2 * fwd(0, built) + head + 2 * fwd(plan.active_from * per, built) \
        + head
    steps = mix["local_epochs"] * mix["seqs_per_client"] // \
        cfg["train"]["batch_size"]
    return mix["clients"] * steps * step


def test_counts_equal_an_independent_reckoning():
    c = cells.load(ROOT, CELL)
    plan = round_plan("lw_fedssl", 3, 0, 3)
    w = counts.round_work(c.config, c.traffic, plan)
    assert w["model_flops"] == _reckoned(c.config, c.traffic, plan)
    # 4 clients x 4 steps x 2 passes (online, global): 3 uses, 18 layers
    assert w["kernels"]["attention"]["calls"] == 96
    assert w["kernels"]["ssd_scan"]["calls"] == 576
    assert 0.9e15 < w["model_flops"] < 0.95e15
    # attention and the scan a call: operations bound
    f, b = counts.attention(1, 4096, 32, 224)
    assert f == 2 * 32 * 4096 * 4096 // 2 * 2 * 224 and b == 8 * 4096 * 32 \
        * 224
    f, b = counts.ssd_scan(1, 4096, 112, 64, 64, 2, 256)
    assert f == 15196487680 and f / 165e12 > b / 3.35e12


def test_reference_copy_agrees_with_the_published_reference():
    """The harness's copy (chunked scan, products in the compute dtype)
    against ``references/zamba2_published.py`` (the exact recurrence) at
    float32 on seeded weights: losses and trained-leaf gradients."""
    pub = _published()
    cfg = {**TINY, "ssm": dict(TINY["ssm"])}
    g = torch.Generator().manual_seed(3)
    params = {k: torch.randn(s, generator=g) / math.sqrt(max(s[0], 1))
              if len(s) > 1 else 1 + 0.1 * torch.randn(s, generator=g)
              for k, (s, _) in ref.layout(cfg).items()}
    gp = {k: v + 0.01 * torch.randn(v.shape, generator=g)
          for k, v in params.items()}
    tok = torch.randint(0, 64, (2, 16), generator=g)
    lab = torch.randint(0, 64, (2, 16), generator=g)
    num = Numerics("float32")
    for stage in (1, 2, 3):
        keys = ref.stage_leaves(cfg, params, stage, stage - 1)
        assert sorted(keys) == sorted(pub.stage_leaves(cfg, params, stage,
                                                       stage - 1))
        leaves = {k: params[k].clone().requires_grad_() for k in keys}
        loss = ref.lm_ssl_loss({**params, **leaves}, tok, lab, cfg, num,
                               sub_stages=stage, active_from=stage - 1,
                               global_params=gp)
        got = torch.autograd.grad(loss, list(leaves.values()))
        want_loss, want = pub.loss_and_grads(
            params, keys, tok, lab, cfg, sub_stages=stage,
            active_from=stage - 1, global_params=gp)
        assert abs(float(loss.detach()) - float(want_loss)) < 1e-5
        for k, t in zip(keys, got):
            err = float((t - want[k]).abs().max())
            assert err <= 1e-4 * float(want[k].abs().max()) + 1e-7, (stage, k)


def _tiny_root(tmp: Path) -> Path:
    """A folder holding only a tiny copy of the cell's files."""
    for d in ("configs", "traffic", "workloads"):
        (tmp / "portbench" / d).mkdir(parents=True, exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/zamba2-7b.json").read_text())
    cfg = {**cfg, "model": TINY, "train": {**cfg["train"], "batch_size": 1}}
    (tmp / "portbench/configs/z2.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "portbench/traffic/lw-s3.seq4-4k.json")
                     .read_text())
    mix.update(seqs_per_client=2, seq_len=16, clients=2, stage_rounds=10,
               trace_rounds=1)
    (tmp / "portbench/traffic/z2.json").write_text(json.dumps(mix))
    (tmp / "portbench/workloads/z2.json").write_text(json.dumps({"limits": {
        "loss_gap": 1e-4, "grad_gap": 1e-3, "grad_median_gap": 1e-4,
        "change_gap": 1e-3}}))
    bench["configs"] = [{**next(c for c in bench["configs"]
                                if c["name"] == "zamba2-7b"),
                         "name": "z2", "file": "portbench/configs/z2.json"}]
    bench["workloads"] = [{"name": "z2", "config": "z2", "traffic": "z2",
                           "chips": 1, "why": "a CPU test"}]
    for m in bench["per_layer"]:
        m["workloads"] = ["z2" if w == CELL else w for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_correct(tmp_path, trace):
    root = _tiny_root(tmp_path)
    c = cells.load(root, "z2")
    res = run.run_cell(c, 2 ** 31 + 5, 0.0, trace, torch.device("cpu"),
                       t0=time.perf_counter())
    assert isinstance(res, dict), res
    # float32 products: the program and the reference agree to rounding
    assert res["correct"], res["check"]
    assert res["attempted"] == 1 and res["failed"] == 0
    if trace:
        # no device on the CPU: the kernels' rooflines are silent
        assert set(res["metrics"]) == {n for n in METRICS
                                       if "roofline" not in n}
    else:
        assert set(res["metrics"]) == {"setup_s", "peak_mem_gib"}
