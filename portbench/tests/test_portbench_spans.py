"""The readers of the program's step and calibration spans
(``calibrate_pct``, ``opt_update_pct``, ``views_pct``,
``calibrate_idle_pct``): their numbers on hand-built spans and a stub
stretch, their failure where the traffic runs a phase and its spans are
missing, their silence for a program that records no step phases, and a
traced run of the tiny ViT cell on the CPU."""
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import run
from portbench.lib import cells
from portbench.tests import tiny
from portbench.tests.tiny import ROOT

NAMES = ("calibrate_pct", "opt_update_pct", "views_pct",
         "calibrate_idle_pct")
CALIBRATING = {"schedule": "lw_fedssl", "stage": 12, "engine": "vmap",
               "server_epochs": 3, "aux_fraction": 0.1}
# a round of 10 s from t = 100 s: the clients' steps, then calibration
ROUND = [("round", 100.0, 110.0),
         ("local_train", 100.0, 106.0),
         ("engine.inputs", 100.0, 100.5),
         ("local_step", 100.5, 103.0),
         ("step.views", 100.5, 100.75),
         ("step.update", 102.5, 103.0),
         ("local_step", 103.0, 106.0),
         ("step.views", 103.0, 103.25),
         ("step.update", 105.0, 106.0),
         ("calibrate", 106.5, 110.0),
         ("calibrate.step", 106.5, 110.0),
         ("step.views", 106.5, 107.0),
         ("step.update", 109.0, 110.0)]
OFFSET_NS = 5 * 10 ** 9          # the profiler's clock, 5 s ahead


def _reader(name):
    return cells.reader(ROOT, f"{name}.vit")


def _stretch(busy_s):
    """A stretch over the round whose device is busy in ``busy_s``
    (seconds on the spans' clock)."""
    def ns(t):
        return int(round(t * 1e9)) + OFFSET_NS
    return SimpleNamespace(t0=ns(100.0), t1=ns(110.0),
                           clock_offset_ns=OFFSET_NS,
                           busy=lambda: [(ns(a), ns(b)) for a, b in busy_s])


def _ctx(spans=ROUND, traffic=CALIBRATING, busy_s=((100.0, 107.0),
                                                     (108.0, 109.0))):
    # the window: the round and, after the hooks' pause, nothing more
    return SimpleNamespace(spans=list(spans), t0=100.0, t1=110.0,
                           window_s=10.0, traffic=traffic, cuda=True,
                           stretch=_stretch(busy_s))


@pytest.mark.parametrize("name,want", [
    ("calibrate_pct", 35.0),                   # 3.5 s of 10
    ("opt_update_pct", 25.0),                  # 0.5 + 1 + 1
    ("views_pct", 15.0),                       # 0.5 + 0.25 + 0.25 + 0.5
    # calibrate is 106.5-110: busy 106.5-107 and 108-109, idle 2 s
    ("calibrate_idle_pct", 20.0)])
def test_reader_on_hand_built_spans(name, want):
    assert _reader(name)(_ctx()) == pytest.approx(want)


def test_spans_outside_the_window_do_not_count():
    late = [(n, a + 10.0, b + 10.0) for n, a, b in ROUND]
    ctx = _ctx(ROUND + late)
    for name in ("calibrate_pct", "opt_update_pct", "views_pct"):
        assert _reader(name)(ctx) == pytest.approx(_reader(name)(_ctx()))
    # a span across the window's end counts up to it
    ctx = _ctx([("calibrate", 108.0, 115.0)], busy_s=())
    assert _reader("calibrate_pct")(ctx) == pytest.approx(20.0)
    assert _reader("calibrate_idle_pct")(ctx) == pytest.approx(20.0)


@pytest.mark.parametrize("name,span", [
    ("calibrate_pct", "calibrate"), ("opt_update_pct", "step.update"),
    ("views_pct", "step.views"), ("views_pct", "engine.inputs"),
    ("calibrate_idle_pct", "calibrate")])
def test_missing_spans_fail_the_run_and_name_the_span(name, span):
    ctx = _ctx([s for s in ROUND if s[0] != span])
    with pytest.raises(RuntimeError, match=f"'{span}'"):
        _reader(name)(ctx)


@pytest.mark.parametrize("mix", [{"server_epochs": 0}, {"aux_fraction": 0},
                                 {"schedule": "e2e"}])
def test_no_calibration_reads_nought(mix):
    ctx = _ctx([s for s in ROUND if s[0] != "calibrate"],
               traffic={**CALIBRATING, **mix})
    assert _reader("calibrate_pct")(ctx) == 0.0
    assert _reader("calibrate_idle_pct")(ctx) == 0.0


def test_sequential_engine_needs_no_round_inputs():
    ctx = _ctx([s for s in ROUND if s[0] != "engine.inputs"],
               traffic={**CALIBRATING, "engine": "sequential"})
    assert _reader("views_pct")(ctx) == pytest.approx(10.0)


def test_program_without_step_spans_is_silent():
    """A program whose step functions take no tracer records no step
    phases: their readers return nothing and raise nothing."""
    ctx = _ctx([s for s in ROUND if s[0] in ("round", "local_train",
                                              "calibrate")])
    for name in ("opt_update_pct", "views_pct"):
        read = _reader(name)
        mp = pytest.MonkeyPatch()
        mp.setitem(read.__globals__, "records_steps", lambda: False)
        try:
            assert read(ctx) is None
        finally:
            mp.undo()
    assert _reader("calibrate_pct")(ctx) == pytest.approx(35.0)


def test_traffic_read_from_the_harness():
    """Without ``ctx.traffic`` the readers take the cell's mix from the
    harness's ``run_cell``, and fail outside it."""
    ctx = _ctx()
    del ctx.traffic

    def run_cell(cell):
        return _reader("calibrate_pct")(ctx)

    assert run_cell(SimpleNamespace(traffic=CALIBRATING)) == \
        pytest.approx(35.0)
    with pytest.raises(RuntimeError, match="run_cell"):
        _reader("calibrate_pct")(ctx)


def test_traced_tiny_vit_cell_prints_the_span_metrics(tmp_path):
    root = tiny.make_root(tmp_path)
    c = cells.load(root, "vit")
    res = run.run_cell(c, 2 ** 31 + 29, 0.0, 1, torch.device("cpu"),
                       t0=time.perf_counter())
    assert isinstance(res, dict), res
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NAMES:
        assert 0.0 <= got[f"{name}.vit"] <= 100.0, name
    for name in ("calibrate_pct", "opt_update_pct", "views_pct"):
        assert got[f"{name}.vit"] > 0.0, name
    # the clients' steps and the calibration do not overlap
    assert got["calibrate_pct.vit"] + got["local_train_pct.vit"] <= 101.0
    assert got["calibrate_idle_pct.vit"] <= got["device_idle_pct.vit"]
    assert all(res["metrics"][f"{n}.vit"]["unit"] == "%" for n in NAMES)
