"""The harness's pieces: the initial weights, the draws, the comparison,
the device trace's arithmetic, the clock's peaks and the rooflines'
readers."""
import math
import re
import time

import pytest
import torch

from portbench.lib import cells
from portbench.lib import draws as D
from portbench.lib.fl import compare, leaf_gap, moved_leaves
from portbench.lib.init import init_tree
from portbench.lib.profile import Stretch
from portbench.lib.window import RoundClock, StopWindow
from portbench.tests.tiny import ROOT


def test_init_repeats_and_follows_its_rules():
    layout = {"blocks/ln/scale": ((2, 4), torch.float32),
              "blocks/mamba/a_log": ((2, 3), torch.float32),
              "blocks/mamba/dt_bias": ((2, 3), torch.float32),
              "blocks/mamba/conv_b": ((5,), torch.float32),
              "embed": ((64, 16), torch.float32),
              "w": ((256, 512), torch.float32)}
    a = init_tree(layout, 2 ** 33 + 1, "cpu")
    b = init_tree(layout, 2 ** 33 + 1, "cpu")
    c = init_tree(layout, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in layout)
    assert not torch.equal(a["w"], c["w"])
    assert torch.all(a["blocks/ln/scale"] == 1)
    assert torch.all(a["blocks/mamba/conv_b"] == 0)
    A = torch.exp(a["blocks/mamba/a_log"])
    assert torch.all((A >= 1) & (A <= 16))
    dt = torch.nn.functional.softplus(a["blocks/mamba/dt_bias"])
    assert torch.all((dt > 0.99e-3) & (dt < 0.101))
    w = a["w"]
    assert abs(float(w.std()) * math.sqrt(256) - 0.88) < 0.02
    assert float(w.abs().max()) <= 2 / math.sqrt(256) + 1e-6
    assert abs(float(a["embed"].std()) - 0.0176) < 0.002


def test_draws_do_not_depend_on_call_order():
    """The program's draws object and the reference's functions give the
    same numbers whatever order a round asks in."""
    d = D.BenchDraws(5, "cpu", state=None)
    assert d.cohort(4, 4) == [0, 1, 2, 3]
    plans = [d.batch_plan(16, 2, 4) for _ in range(3)]
    cal = d.batch_plan(8, 1, 4, calibration=True)
    for k in (2, 0, 1):
        ref = D.batch_plan(5, "cpu", 0, k, 16, 2, 4)
        assert all(torch.equal(a[0], b[0]) and a[1] == b[1]
                   for a, b in zip(plans[k], ref))
    assert torch.equal(cal[0][0], D.batch_plan(5, "cpu", 0, "server", 8, 1,
                                               4)[0][0])
    handle = plans[1][3][1]
    v1, v2 = d.views(handle, 4, 32, 32)
    w1, _ = D.views(5, "cpu", handle, 4, 32, 32)
    assert all(torch.equal(v1[f], w1[f]) for f in v1)
    assert not torch.equal(v1["area"], v2["area"])
    d.cohort(4, 4)
    assert not torch.equal(d.batch_plan(16, 2, 4)[0][0], plans[0][0][0])


def test_leaf_rule_and_gaps():
    grads = {"local": {"a": 1.0, "b": 2.0, "c": 1e-9, "d": 3.0},
             "server": {}}
    keys = ["online/a", "online/b", "online/c", "target/a", "d"]
    assert moved_leaves(grads, keys) == ["online/a", "online/b", "target/a",
                                         "d"]
    ref = {"a": 1.0, "b": 0.01, "d": 2.0}
    # b is small: measured against the median, not itself
    gap, leaf = leaf_gap({"a": 1.0, "b": 0.02, "d": 2.0}, ref,
                         ["a", "b", "d"])
    assert leaf == "b" and abs(gap - 0.01) < 1e-12
    assert leaf_gap({"a": 0.0, "b": 0.01, "d": 2.0}, ref,
                    ["a", "b", "d"])[0] == 1.0
    n = {"a": 1.0, "b": 1.0}
    nums = compare([([2.0, 3.0], n, None), ([2.0, 3.0], None, n)],
                   [([2.0, 3.3], n, None), ([2.0, 3.0], None, n)],
                   {"local": {"a": 1.0, "b": 1.0}})
    assert abs(nums["loss_gap"][0] - 0.3 / 3.3) < 1e-12
    assert nums["loss_gap"][1] == "round 1 client 1"
    assert nums["grad_gap"][0] == 0.0


def test_busy_union_and_idle_gaps():
    st = Stretch.__new__(Stretch)
    st.t0, st.t1 = 0, 100
    st.device = [("k1", 10, 30), ("k2", 20, 40), ("k1", 60, 70),
                 ("k3", 95, 120)]
    st.host = [("aten::mm", 0, 100), ("aten::item", 45, 55)]
    st.clock_offset_ns = 0
    assert st.busy() == [(10, 40), (60, 70), (95, 100)]
    assert abs(st.busy_seconds() - 45e-9) < 1e-18
    assert st.kernel_seconds(lambda n: n == "k1") == (30e-9, 2)
    top = st.top_device_ops()[0]
    assert top[0] == "k1" and abs(top[1] - 30e-9) < 1e-18
    gaps = st.idle_gaps([("calibrate", 0.0, 1.0)])
    # gaps: 0-10, 40-60 (host in aten::item at 50), 70-95
    assert [g[0] for g in gaps] == ["calibrate/aten::mm",
                                    "calibrate/aten::item",
                                    "calibrate/aten::mm"]
    assert [round(g[1] * 1e9) for g in gaps] == [25, 20, 10]


def test_peaks_leave_out_the_hooks(monkeypatch):
    """The set-up's and the window's peaks are the program's: read before
    the round's hooks, the device's peak reset after them."""
    mem = {"peak": 0}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda: mem["peak"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda: mem.update(peak=0))

    def hook(n, frame):         # the harness's captures allocate most
        mem["peak"] = max(mem["peak"], 10_000)

    rc = RoundClock(time.perf_counter(), 3600.0, hook, "cpu")
    rc.cuda = True

    def driver_round(program_peak):
        losses = [1.0]  # noqa: F841 (read from this frame by the clock)
        mem["peak"] = max(mem["peak"], program_peak)
        rc.log("")

    for peak in (100, 300, 200):
        driver_round(peak)
    rc.seconds = 0.0
    with pytest.raises(StopWindow):
        driver_round(250)
    assert (rc.setup_peak, rc.window_peak) == (100, 300)
    assert rc.rounds == 3


class _Ctx:
    def __init__(self, cuda, calls, launched, device):
        self.cuda = cuda
        self.work = {"kernels": {"attention": {"calls": calls,
                                               "least_s": 1e-3}}}
        st = Stretch.__new__(Stretch)
        st.t0, st.t1, st.rounds = 0, 10 ** 9, 2
        st.device = device
        st.launches = {"flash_attention": launched}
        self.stretch = st


@pytest.mark.parametrize("case, want", [
    ("measured", 20.0),
    ("no device trace", None),
    ("no call expected", None),
    ("kernel renamed", "no kernel named '*flash_fwd*'"),
    ("counter short", "reads 3 calls"),
])
def test_roofline_fails_where_expected_calls_vanish(case, want):
    """A roofline is silent only with nothing to read; calls that the
    counts expect and the trace or the launch counter lacks fail the run,
    naming what is missing."""
    kernels = [("flash_fwd_bf16_kernel<64, 64>", 0, 5 * 10 ** 6),
               ("flash_fwd_bf16_kernel<64, 64>", 10 ** 7, 1.5 * 10 ** 7)]
    ctx = {"measured": _Ctx(True, 2, 4, kernels),
           "no device trace": _Ctx(False, 2, 0, []),
           "no call expected": _Ctx(True, 0, 0, []),
           "kernel renamed": _Ctx(True, 2, 4, [("attn_v2", 0, 10 ** 7)]),
           "counter short": _Ctx(True, 2, 3, kernels)}[case]
    read = cells.reader(ROOT, "attn_fwd_roofline_pct.vit")
    if isinstance(want, str):
        with pytest.raises(RuntimeError, match=re.escape(want)):
            read(ctx)
    elif want is None:
        assert read(ctx) is None
    else:
        # 2 rounds x 1 ms of least time over 10 ms of kernels
        assert abs(read(ctx) - want) < 1e-9
