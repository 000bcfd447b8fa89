"""Stage schedules for layer-wise / progressive federated training
(``repro.core.schedule``).

Builds a per-round plan for the five training modes of the paper:

  e2e          FedMoCo: full model every round.
  layerwise    FedMoCo-LW: stage s trains only L_s, exchanges only L_s.
  lw_fedssl    LW-FedSSL: layerwise + server-side calibration (download is
               L_1..L_s because the server updates every layer) +
               representation alignment in the local loss.
  progressive  Prog-FedSSL: stage s trains and exchanges L_1..L_s.
  fll_dd       FLL + depth dropout: layerwise, frozen layers dropped with
               probability ``depth_dropout`` during local training.

Round allocation across stages (paper Section 5.10): ``uniform``,
``right_skewed`` and ``left_skewed``; the total is always ``fl.rounds``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch


@dataclass(frozen=True)
class RoundPlan:
    round_idx: int          # 0-based global communication round
    stage: int              # 1-based stage s
    sub_layers: int         # depth of the stage-s sub-model, in stages
    active_from: int        # stages < active_from are frozen in local training
    new_stage: bool         # first round of its stage (append layer / transfer)
    download_stages: Tuple[int, int]   # [lo, hi) stage range client downloads
    upload_stages: Tuple[int, int]     # [lo, hi) stage range client uploads
    server_calibrate: bool  # run server-side SSL on D_g after aggregation
    align: bool             # add representation-alignment loss locally
    depth_dropout: float    # frozen-layer drop probability (FLL+DD)


SCHEDULES = ("e2e", "layerwise", "lw_fedssl", "progressive", "fll_dd")


def stage_rounds(total_rounds: int, num_stages: int, allocation: str
                 ) -> List[int]:
    """Number of rounds per stage; sums exactly to ``total_rounds``."""
    S = num_stages
    if total_rounds < S:
        raise ValueError(
            f"need at least one round per stage: rounds={total_rounds} < "
            f"stages={S}")
    if allocation == "uniform":
        w = [1.0] * S
    elif allocation == "right_skewed":    # more rounds early
        w = [float(S - s) for s in range(S)]
    elif allocation == "left_skewed":     # more rounds late
        w = [float(s + 1) for s in range(S)]
    else:
        raise ValueError(allocation)
    tot = sum(w)
    out = [max(1, int(total_rounds * x / tot)) for x in w]
    # fix rounding drift, preserving the skew direction
    i = 0
    while sum(out) < total_rounds:
        out[i % S] += 1
        i += 1
    while sum(out) > total_rounds:
        j = max((s for s in range(S) if out[s] > 1), key=lambda s: out[s])
        out[j] -= 1
    return out


def build_schedule(fl, num_stages: int) -> List[RoundPlan]:
    """fl: FLConfig. Returns one RoundPlan per communication round."""
    mode = fl.schedule
    if mode not in SCHEDULES:
        raise ValueError(f"unknown schedule '{mode}'; one of {SCHEDULES}")
    R, S = fl.rounds, num_stages
    if mode == "e2e":
        return [RoundPlan(r, S, S, 0, False, (0, S), (0, S), False, False,
                          0.0) for r in range(R)]
    per_stage = (list(fl.rounds_per_stage) if fl.rounds_per_stage
                 else stage_rounds(R, S, fl.stage_allocation))
    if len(per_stage) != S or sum(per_stage) != R:
        raise ValueError(f"rounds_per_stage {per_stage} must have {S} "
                         f"entries summing to {R}")
    plans: List[RoundPlan] = []
    r = 0
    for s in range(1, S + 1):
        for j in range(per_stage[s - 1]):
            new = j == 0
            if mode in ("layerwise", "fll_dd"):
                dd = fl.depth_dropout if mode == "fll_dd" else 0.0
                plans.append(RoundPlan(r, s, s, s - 1, new, (s - 1, s),
                                       (s - 1, s), False, False, dd))
            elif mode == "lw_fedssl":
                plans.append(RoundPlan(r, s, s, s - 1, new, (0, s),
                                       (s - 1, s), True, True, 0.0))
            else:  # progressive
                plans.append(RoundPlan(r, s, s, 0, new, (0, s), (0, s),
                                       False, False, 0.0))
            r += 1
    return plans


# ---------------------------------------------------------------------------
# weight transfer (paper Appendix B.2): init L_s from L_{s-1} at stage start
# ---------------------------------------------------------------------------
def weight_transfer(stacked: torch.Tensor, stage: int) -> torch.Tensor:
    """A copy of a stage-stacked leaf with row ``stage-2`` copied into row
    ``stage-1`` (0-based). The input is returned as it is for stage 1."""
    if stage < 2:
        return stacked
    out = stacked.clone()
    out[stage - 1] = stacked[stage - 2]
    return out


# the block stacks the reference's ``transfer_model`` transfers; it leaves
# ``moe_blocks`` and the encoder-decoder's ``dec_blocks`` alone
TRANSFER_STACKS = ("blocks", "mlstm", "slstm", "enc_blocks")


def transfer_model(params: Dict[str, torch.Tensor], stage: int,
                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """Weight transfer on every leaf of the block stacks
    ``<prefix><stack>/...`` for each of ``TRANSFER_STACKS`` in a flat
    params dict; other leaves are shared with the input."""
    heads = tuple(f"{prefix}{s}/" for s in TRANSFER_STACKS)
    return {k: (weight_transfer(v, stage) if k.startswith(heads) else v)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# depth dropout (FLL+DD): gates over frozen stages
# ---------------------------------------------------------------------------
def depth_dropout_gates(uniforms: torch.Tensor, active_from: int,
                        rate: float) -> torch.Tensor:
    """(S,) float gates from (S,) uniform draws: active and unbuilt stages
    always 1, frozen stages kept when their draw is >= ``rate``. A gate
    multiplies its block's residual delta."""
    keep = (uniforms >= rate).to(torch.float32)
    idx = torch.arange(uniforms.shape[0], device=uniforms.device)
    return torch.where(idx >= active_from, torch.ones_like(keep), keep)
