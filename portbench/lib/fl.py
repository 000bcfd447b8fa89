"""What the FL drivers share: the round plan of a traffic mix, the state
each round reads, and the comparison that decides ``correct``.

One run is one call of the program's driver. The warm-up round and the
next ``check_rounds - 1`` rounds of that same call are the steps the plain
reference follows: at each of their ends the harness reads the clients'
losses and the server's model from the driver's frame (the names the
driver binds them to: ``losses`` and the model, given by each traffic
driver), and keeps the losses and, after the first and the last of them,
each leaf's distance from the model the first round started from: the
first round's FedAvg aggregate (the driver's name for it, given by each
traffic driver) and the last round's model. After
the window the reference runs the same rounds from the same seed, and
``compare`` sets the two side by side:

  loss_gap    the largest relative gap between a client's loss in the
              program and in the reference, over the followed rounds
  grad_gap    the first round's FedAvg aggregate against the model the
              round started from (the pseudo-gradient, as the server's
              update gets it): the gap between the program's and the
              reference's norm of each leaf's change, over the reference's
              norm of that leaf or of the median leaf, whichever is larger,
              worst leaf
  grad_median_gap  the median leaf's gap of the same change: steady
              from seed to seed where the worst leaf swings (in the ViT,
              block 12's attention q and k, whose small gradients Adam
              turns into full steps)
  change_gap  grad_gap's measure for the server's model after the last
              followed round (calibration included)

A cell compares the numbers that its file (``portbench/workloads``)
gives a limit.

Both gaps leave out the leaves whose gradient in the reference is nought
to rounding: under a thousandth of the median leaf's at the first step of
every phase that trains (the clients' first local step, the server's first
calibration step). Adam moves such a leaf by round-off alone, a full step
a step (the last BatchNorm bias of the projection head, whose shift the
prediction head's BatchNorm takes out). A target-branch leaf goes with its
online leaf.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

import torch

from portbench.reference.common import round_plan, transfer

RULE = 1e-3     # a leaf moves when its change is over RULE x the median's


def rounds_per_stage(num_stages: int, stage: int, rounds: int) -> tuple:
    """Every round in ``stage``: zero rounds in the others."""
    return tuple(rounds if s == stage else 0 for s in range(1, num_stages + 1))


def delta_norms(tree: Dict[str, torch.Tensor],
                base: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's fp32 distance from its leaf in ``base``, read back
    once."""
    keys = sorted(tree)
    n = torch.stack([torch.linalg.vector_norm(
        tree[k].detach().to(torch.float32) - base[k]) for k in keys])
    return dict(zip(keys, n.tolist()))


def moved_leaves(grads: Dict[str, Dict[str, float]], keys) -> List[str]:
    """The leaves of ``keys`` (flat paths, a branch name first where the
    model has branches) whose reference gradient is not nought to rounding
    in some phase: at least ``RULE`` x the phase's median leaf's."""
    live = set()
    for norms in grads.values():
        if norms:
            med = statistics.median(norms.values())
            live |= {k for k, v in norms.items() if v >= RULE * med}
    return [k for k in keys
            if k in live or k.split("/", 1)[-1] in live]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             moved: List[str]) -> Tuple[float, str]:
    """(worst gap, its leaf) over ``moved``: |prog - ref| / max(ref,
    median ref), the median over the leaves the reference moves."""
    med = statistics.median([ref[k] for k in moved if ref[k] > 0] or [0.0])
    worst, leaf = 0.0, ""
    for k in moved:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if not math.isfinite(gap):
            return math.inf, k
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


def median_gap(prog: Dict[str, float], ref: Dict[str, float],
               moved: List[str]) -> float:
    """The median over ``moved`` of ``leaf_gap``'s per-leaf gaps."""
    med = statistics.median([ref[k] for k in moved if ref[k] > 0] or [0.0])
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med)
                             for k in moved)


def detail(prog, ref, grads) -> Dict[str, float]:
    """Numbers the limits were not set on, read beside them when they
    were chosen: the largest relative gap of a round's mean loss and of
    the first round's client losses, and the last model's median leaf."""
    last = ref[-1][2]
    return {"loss_mean_gap": max(
        abs(statistics.fmean(lp) - statistics.fmean(lr))
        / abs(statistics.fmean(lr)) for (lp, *_), (lr, *_) in zip(prog, ref)),
        "loss_r1_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(prog[0][0], ref[0][0])),
        "change_median_gap": median_gap(prog[-1][2], last,
                                        moved_leaves(grads, sorted(last)))}


def compare(prog, ref, grads) -> Dict[str, Tuple[float, str]]:
    """``prog`` and ``ref``: per followed round (the clients' losses, the
    leaves' distances from the start of the first round's aggregate, and
    of the last round's model; None where not taken); ``grads``: the
    reference's first gradients by phase. Returns {number: (value,
    where)}."""
    if len(prog) != len(ref):
        raise ValueError(f"the program ran {len(prog)} of the followed "
                         f"rounds, the reference {len(ref)}")
    gap, where = 0.0, ""
    for r, ((lp, *_), (lr, *_)) in enumerate(zip(prog, ref)):
        if len(lp) != len(lr):
            raise ValueError(f"round {r + 1}: {len(lp)} client losses in the "
                             f"program, {len(lr)} in the reference")
        for c, (a, b) in enumerate(zip(lp, lr)):
            g = abs(a - b) / max(abs(b), 1e-12)
            if not math.isfinite(g):
                g = math.inf
            if g >= gap:
                gap, where = g, f"round {r + 1} client {c}"
    agg, last = ref[0][1], ref[-1][2]
    moved = moved_leaves(grads, sorted(agg))
    return {"loss_gap": (gap, where),
            "grad_gap": leaf_gap(prog[0][1], agg, moved),
            "grad_median_gap": (median_gap(prog[0][1], agg, moved),
                                "median leaf"),
            "change_gap": leaf_gap(prog[-1][2], last,
                                   moved_leaves(grads, sorted(last)))}


def verdict(nums: Dict[str, Tuple[float, str]], limits: Dict[str, float]):
    """``compare``'s numbers that ``limits`` names, each beside its limit
    (``{number: {value, limit, where}}``), and ``correct``: every one
    finite and within its limit."""
    check = {k: {"value": v, "limit": limits[k], "where": where}
             for k, (v, where) in nums.items() if k in limits}
    return check, all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                      for c in check.values())


class FLRun:
    """One FL cell's run: the plan of its traffic, the benchmark's initial
    model, the captures at the followed rounds' ends and the reference's
    replay of them. Subclasses give the model's layout, the program's
    call, the model in the driver's frame and the reference's rounds."""

    model_var = ""      # the driver's name for the server's model
    agg_var = ""        # ... and for a round's FedAvg aggregate

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.cfg = cell.config
        self.mix = cell.traffic
        self.check_rounds = int(self.mix["check_rounds"])
        self.captured: List[tuple] = []

    # -- the traffic's plan ---------------------------------------------------
    def plan_for(self, r: int):
        return round_plan(self.mix["schedule"], self.mix["stage"], r,
                          self.num_stages)

    def fl_settings(self) -> dict:
        return {"num_clients": self.mix["clients"],
                "clients_per_round": self.mix.get("clients_per_round", 0),
                "rounds": self.mix["stage_rounds"],
                "local_epochs": self.mix["local_epochs"],
                "server_epochs": self.mix.get("server_epochs", 0),
                "weight_transfer": self.mix["weight_transfer"]}

    # -- the starting point ----------------------------------------------------
    def start(self) -> Dict[str, torch.Tensor]:
        """The model the first round trains from, flat: the initial one
        after the first plan's stage transfer."""
        tree = self.flat(self.initial_state())
        p = self.plan_for(0)
        if p.new_stage and self.mix["weight_transfer"]:
            tree = {**tree, **self.transfer(tree, p.stage)}
        return tree

    # -- the captures -----------------------------------------------------------
    def capture(self, r: int, frame) -> None:
        """At the end of round ``r`` (1-based): the clients' losses, after
        the first round the leaves' distances from the start of its
        aggregate, after the last followed round those of the model."""
        if r > self.check_rounds:
            return
        v = frame.f_locals
        self.captured.append(self._norms(
            r, [float(x) for x in v["losses"]],
            lambda: self.flat_agg(v[self.agg_var]),
            lambda: self.flat(v[self.model_var])))

    def _norms(self, r, losses, agg, model):
        base = self.start() if r in (1, self.check_rounds) else None
        return (losses,
                delta_norms(agg(), base) if r == 1 else None,
                delta_norms(model(), base) if r == self.check_rounds
                else None)

    def follow(self, num, fault: Optional[str] = None):
        """(the reference's followed rounds in ``capture``'s form, its
        first gradients by phase)."""
        out, grads = [], {}
        for r, (losses, agg, model) in enumerate(
                self.reference_rounds(num, fault, grads)):
            out.append(self._norms(r + 1, losses,
                                   lambda: self.flat_agg(agg),
                                   lambda: self.flat(model)))
        return out, grads
