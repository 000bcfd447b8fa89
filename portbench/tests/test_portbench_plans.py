"""``rounds_per_stage`` with zeros around the cell's stage yields that
stage's rounds of a full run (the port's ``RoundPlan`` fields apart from
``round_idx``), and the reference's plan agrees with them."""
import dataclasses

import pytest

from portbench.lib.fl import rounds_per_stage
from portbench.reference.common import round_plan
from portbench.tests import tiny  # noqa: F401  (puts src on the path)
from repro_torch.configs.base import FLConfig
from repro_torch.core.schedule import build_schedule

CASES = [("lw_fedssl", 12, 12), ("lw_fedssl", 2, 9), ("lw_fedssl", 1, 3),
         ("e2e", 12, 12)]


def _fields(p):
    return {k: v for k, v in dataclasses.asdict(p).items()
            if k != "round_idx"}


@pytest.mark.parametrize("schedule,stage,stages", CASES)
def test_zeros_yield_the_stages_plans(schedule, stage, stages):
    full = build_schedule(FLConfig(rounds=3 * stages, schedule=schedule,
                                   rounds_per_stage=(3,) * stages
                                   if schedule != "e2e" else ()), stages)
    want = [p for p in full if p.stage == stage]
    per = rounds_per_stage(stages, stage, 3) if schedule != "e2e" else ()
    got = build_schedule(FLConfig(rounds=3, schedule=schedule,
                                  rounds_per_stage=per), stages)
    assert [_fields(p) for p in got] == [_fields(p) for p in want[:3]]
    for j, p in enumerate(got):
        r = round_plan(schedule, stage, j, stages)
        assert (r.stage, r.sub_layers, r.active_from, r.new_stage, r.align,
                r.server_calibrate) == (p.stage, p.sub_layers, p.active_from,
                                        p.new_stage, p.align,
                                        p.server_calibrate)
