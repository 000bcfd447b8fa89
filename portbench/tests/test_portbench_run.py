"""A whole run of the harness on the CPU, the chip's look skipped: cells
defined only by files in a folder of their own, found by the harness's
lookup, run through the program and checked against the reference."""
import time

import pytest
import torch

from portbench import run
from portbench.lib import cells
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("cell", ["vit", "lm"])
@pytest.mark.parametrize("trace", [0, 1])
def test_run_cell(root, cell, trace):
    c = cells.load(root, cell)
    res = run.run_cell(c, 2 ** 31 + 11, 0.0, trace, torch.device("cpu"),
                       t0=time.perf_counter())
    assert isinstance(res, dict), res
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "check"
    # float32 products: the program and the reference agree to rounding
    assert res["correct"], res["check"]
    assert res["attempted"] == 1 and res["failed"] == 0
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    got = set(res["metrics"])
    if trace:
        # no device on the CPU: the kernels' rooflines are silent
        assert got == {n for n in names if "roofline" not in n}
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == names
        assert res["metrics"]["setup_s"]["value"] > 0


def test_plan_running_out(root):
    """A plan shorter than the window is no result."""
    tiny.make_root(root / "short", stage_rounds=1)
    c = cells.load(root / "short", "lm")
    res = run.run_cell(c, 3, 0.0, 0, torch.device("cpu"),
                       t0=time.perf_counter())
    assert res == "the program's plan ran out before the window closed"


def test_unknown_cell(root):
    with pytest.raises(KeyError):
        cells.load(root, "no-such-cell")


def test_no_card_no_result(capsys):
    """Without a CUDA card the command fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", "vit-tiny.lw-s12.vmap16", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
