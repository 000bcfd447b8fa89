"""The port's dry run (``launch.dryrun``): sharded steps on ``meta``
DTensors over fake process groups, counted by ``roofline.StepRecorder``.

At ``reduced()`` sizes (zamba2 and xLSTM with the launcher's overrides, so
that they hold blocks) and batches of 8 x 32 (train; internvl2's 16
frontend positions leave 16 tokens) or 8 x 16 (prefill, decode): the
published input shapes' batches and lengths make no difference to which
ops run, only to the counts.
- every architecture's train step on a (2, 2) mesh: it runs, its FLOPs per
  device lie between a quarter of the unsharded step's count and the count
  itself (4 devices; replicated work counts on each), and it issues
  collectives;
- train_lw, prefill and decode on internlm2-1.8b and deepseek-v2 (2, 2);
- a step on the (2, 16, 16) ("pod", "data", "model") production mesh
  (512 fake ranks): internlm2-1.8b's decode at its published size. Not on
  a (2, 2, 2) mesh: there DTensor's costing of its many candidate layouts
  for each op (every dim shards over a 2-wide axis) takes minutes a
  reduced step on a CPU;
- on a (1, 1) mesh the FLOPs equal the unsharded step's
  ``FlopCounterMode`` count exactly (the same local ops, the kernels'
  custom ops counted by their formulas);
- the CLI at published sizes on the (16, 16) mesh: its JSON row carries
  every key of the reference's ``RooflineResult.to_dict()``;
- ``lm.SEQ_SHARD`` on: the step runs with other collectives;
- the collectives filed by source (``sharding.aten.collective_source``):
  the sources' bytes and counts add up to each kind's; a decode step's
  cache writes and reads, the gathered embedding table and train_lw's
  replicated InfoNCE rows stand apart from the rules' layouts, and at
  (16, 16) the replicated view operands too.
"""
import dataclasses
import json

import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline.analysis import RooflineResult as JRooflineResult
from repro_torch.configs.base import (ARCH_IDS, ShapeConfig, load_arch,
                                      load_train, reduced)
from repro_torch.launch import dryrun, inputs, steps, train

ASSIGNED = [a for a in ARCH_IDS if a != "vit-tiny"]
SHAPES = {"train": ("train_4k", ShapeConfig("train_4k", 32, 8, "train")),
          "train_lw": ("train_4k", ShapeConfig("train_4k", 32, 8, "train")),
          "prefill": ("prefill_32k",
                      ShapeConfig("prefill_32k", 16, 8, "prefill")),
          "decode": ("decode_32k", ShapeConfig("decode_32k", 16, 8,
                                               "decode"))}
_MESHES = {}


def _cfg(arch):
    return reduced(load_arch(arch), **train.LM_ARCHS.get(arch, {}))


def _mesh(sizes, names=("data", "model")):
    """One mesh per shape while its fake group lives: a mesh made again,
    equal to the first, after its group was destroyed would meet DTensor's
    plans cached for the first (the (2, 2) tests therefore run together,
    before the tests on other meshes)."""
    n = 1
    for s in sizes:
        n *= s
    if not (dist.is_initialized() and dist.get_world_size() == n):
        _MESHES.clear()
        dryrun.init_fake_group(n)
    if sizes not in _MESHES:
        _MESHES[sizes] = init_device_mesh("cpu", sizes,
                                          mesh_dim_names=names)
    return _MESHES[sizes]


@pytest.fixture(scope="module", autouse=True)
def _group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _row(arch, mode, mesh):
    name, shape = SHAPES[mode]
    return dryrun.run_one(arch, name, mode=mode, mesh=mesh,
                          cfg_override=_cfg(arch), shape_override=shape,
                          verbose=False)


def _unsharded_train_flops(arch) -> int:
    cfg = _cfg(arch)
    step, opt = steps.make_train_step(cfg, load_train(arch))
    params = inputs.param_shapes(cfg)
    batch = inputs.batch_shapes(cfg, SHAPES["train"][1], for_train=True)
    with FlopCounterMode(display=False) as fc:
        step(params, opt.init(params), batch)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_runs_sharded_on_meta(arch):
    row = _row(arch, "train", _mesh((2, 2)))
    count = _unsharded_train_flops(arch)
    assert count / 4 <= row["flops_dev"] <= count, (row["flops_dev"],
                                                     count)
    assert row["coll_bytes_dev"] > 0 and row["coll_detail"]["total"] > 0
    mem = row["mem_per_device"]
    assert 0 < mem["argument_bytes"] < mem["peak_bytes"]


@pytest.mark.parametrize("mode", ["train_lw", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b"])
def test_other_modes_run_sharded_on_meta(arch, mode):
    row = _row(arch, mode, _mesh((2, 2)))
    assert row["mode"] == mode and row["flops_dev"] > 0
    assert row["n_devices"] == 4 and row["mesh"] == "2x2"


def test_seq_shard_lays_out_the_residual_stream(monkeypatch):
    """``lm.SEQ_SHARD`` (off by default, as the reference's knob) makes each
    block's output a ("data", "model", None) layout: the step still runs,
    with other collectives than without it."""
    from repro_torch.models import lm
    mesh = _mesh((2, 2))
    off = _row("internlm2-1.8b", "train", mesh)
    monkeypatch.setattr(lm, "SEQ_SHARD", True)
    on = _row("internlm2-1.8b", "train", mesh)
    assert on["coll_detail"]["counts"] != off["coll_detail"]["counts"]
    assert on["flops_dev"] > 0


SOURCES = {"layout", "view", "lookup", "loss", "cache-write", "cache-read"}


def _check_sources(row, want):
    """The row's ``by_source`` adds up to its bytes and counts per kind,
    and holds the sources ``want`` (all of them from ``SOURCES``)."""
    by = row["coll_detail"]["by_source"]
    assert want <= set(by) <= SOURCES, set(by)
    for key in ("bytes", "counts"):
        for kind, n in row["coll_detail"][key].items():
            assert sum(v[key].get(kind, 0) for v in by.values()) == n, \
                (key, kind)


@pytest.mark.parametrize("mode,want", [
    ("train", {"layout", "lookup"}),
    ("train_lw", {"layout", "lookup", "loss"}),
    ("decode", {"layout", "lookup", "cache-write", "cache-read"})])
def test_collectives_are_filed_by_source(mode, want):
    _check_sources(_row("internlm2-1.8b", mode, _mesh((2, 2))), want)


def test_multi_pod_mesh_runs_on_meta():
    row = dryrun.run_one("internlm2-1.8b", "decode_32k", multi_pod=True,
                         verbose=False)
    assert row["n_devices"] == 512 and row["mesh"] == "2x16x16"
    assert row["coll_detail"]["total"] > 0
    assert set(row["coll_detail"]["by_axis"]) <= {"pod", "data", "model"}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b",
                                  "zamba2-2.7b"])
def test_one_device_flops_equal_the_unsharded_count(arch):
    row = _row(arch, "train", _mesh((1, 1)))
    assert row["flops_dev"] == _unsharded_train_flops(arch)


def test_cli_rows_carry_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "rows.json"
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--rolled", "--out", str(out)])
    text = capsys.readouterr().out
    assert "DRY-RUN OK: 1 combinations" in text and "--rolled" in text
    assert "internlm2-1.8b" in text and "16x16" in text
    (row,) = json.loads(out.read_text())
    fields = {f.name: 0.0 for f in dataclasses.fields(JRooflineResult)}
    want = set(JRooflineResult(**{**fields, "coll_detail": {},
                                  "mem_per_device": {}}).to_dict())
    assert want <= set(row), want - set(row)
    assert row["n_devices"] == 256 and row["mode"] == "decode"
    assert set(row["coll_detail"]["bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert set(row["mem_per_device"]) == {"argument_bytes", "output_bytes",
                                          "temp_bytes", "peak_bytes"}
    assert "collectives by source: " in text
    _check_sources(row, {"layout", "lookup", "view", "cache-write",
                         "cache-read"})

