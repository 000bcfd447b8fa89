"""The check that decides ``correct`` sees faults in the timed path: each
planted in the program underneath a whole CPU run makes ``correct``
false, and the unbroken program passes (float32 products, tight
limits). The fp8 control reads higher than the program, and the
calibration's verdicts fail the control and every fault."""
import time

import pytest
import torch

from portbench import calibrate, run
from portbench.lib import cells
from portbench.lib.fl import compare, verdict
from portbench.reference.common import Numerics
from portbench.tests import tiny


def _unchanged_lm(real):
    def step(params, opt_state, batch, lr, **kw):
        _, opt_state, m = real(params, opt_state, batch, lr, **kw)
        return params, opt_state, m
    return step


def _unchanged_vit(real):
    def step(state, opt_state, *a, **kw):
        _, opt_state, losses = real(state, opt_state, *a, **kw)
        return state, opt_state, losses
    return step


def _half_lm(real):
    def loss(params, batch, cfg, **kw):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return real(params, half, cfg, **kw)
    return loss


def _half_vit(real):
    def loss(state, x1, x2, *a, **kw):
        return real(state, x1[:x1.shape[0] // 2], x2[:x2.shape[0] // 2],
                    *a, **kw)
    return loss


def _no_exchange(real):
    def fedavg(trees, weights):
        return dict(trees[0])
    return fedavg


def _altered(real):
    def fedavg(trees, weights):
        out = real(trees, weights)
        k = sorted(out)[0]
        return {**out, k: out[k] * 1.01}
    return fedavg


FAULTS = {
    "unchanged": {"lm": ("repro_torch.federated.driver.lm_train_step",
                         _unchanged_lm),
                  "vit": ("repro_torch.federated.client.stacked_train_step",
                          _unchanged_vit)},
    "half_batch": {"lm": ("repro_torch.core.ssl.lm_ssl_loss", _half_lm),
                   "vit": ("repro_torch.core.ssl.ssl_loss", _half_vit)},
    "no_exchange": {c: ("repro_torch.federated.aggregate.fedavg",
                        _no_exchange) for c in ("lm", "vit")},
    "altered_answer": {c: ("repro_torch.federated.aggregate.fedavg",
                           _altered) for c in ("lm", "vit")},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("cells"))


def _run(root, cell):
    c = cells.load(root, cell)
    res = run.run_cell(c, 977, 0.0, 0, torch.device("cpu"),
                       t0=time.perf_counter())
    assert isinstance(res, dict), res
    return res


@pytest.mark.parametrize("cell", ["lm", "vit"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails(root, monkeypatch, cell, fault):
    target, wrap = FAULTS[fault][cell]
    mod, name = target.rsplit(".", 1)
    import importlib
    m = importlib.import_module(mod)
    monkeypatch.setattr(m, name, wrap(getattr(m, name)))
    res = _run(root, cell)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", ["lm", "vit"])
def test_control_reads_higher(tmp_path, cell):
    """At bf16 products the fp8 control lies at least three times further
    from the reference than the program does, on some number."""
    c = cells.load(tiny.make_root(tmp_path, "bfloat16"), cell)
    prog = _run(tmp_path, cell)["check"]
    r = cells.driver(c).Run(c, 977, torch.device("cpu"))
    ref, grads = r.follow(Numerics("bfloat16"))
    ctl, _ = r.follow(Numerics("bfloat16", control=True))
    nums = compare(ctl, ref, grads)
    ratio = {k: nums[k][0] / max(prog[k]["value"], 1e-30) for k in prog}
    k = max(ratio, key=ratio.get)
    assert ratio[k] >= 3.0, (nums, prog)
    # a limit set between the two readings by the cells' rule: the
    # harness's verdict passes the program and fails the control
    limits = {k: prog[k]["value"] * ratio[k] ** 0.6}
    assert verdict({k: (prog[k]["value"], "")}, limits)[1]
    assert not verdict(nums, limits)[1]


@pytest.mark.parametrize("cell", ["lm", "vit"])
def test_calibration_judges_its_readings(root, cell):
    """``calibrate.py`` puts every reading through ``run.py``'s verdict
    under the cell's limits: the program's seeds come out correct, the
    control and each fault (the unchanged model included) not."""
    recs = []
    wrong = calibrate.readings(cells.load(root, cell), torch.device("cpu"),
                               [977], [978], recs.append)
    assert wrong == [], recs
    got = {r["kind"]: r["correct"] for r in recs}
    assert got == {"program": True, "control": False, "unchanged": False,
                   **{f: False for f in calibrate.FAULTS}}
    assert all(set(r["check"]) == set(tiny.LIMITS) for r in recs
               if r["kind"] != "unchanged")
