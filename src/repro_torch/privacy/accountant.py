"""(ε, δ) accounting for client-level DP-FedAvg via Rényi DP (a copy of
``repro.privacy.accountant``, which is Python and numpy only: the same
rounds give the same numbers in both packages).

Every round the server releases one Gaussian-mechanism output: the
clipped, weighted client-update mean plus N(0, σ²) noise with
σ = z·C·max_w (``repro_torch.privacy.dp``), whose client-level L2
sensitivity is bounded by C·max_w — so the *effective* noise multiplier
is exactly ``z``, independent of the round's weights. Rounds compose in
RDP space:

  rdp_T(α) = Σ_t rdp(q_t, z, α)

with ``q_t = |cohort_t| / num_clients`` the round's sampling fraction
(subsampling amplification). The per-round term is the subsampled
Gaussian mechanism RDP at integer orders α ≥ 2 (Mironov, Talwar & Zhang
2019, "Rényi Differential Privacy of the Sampled Gaussian Mechanism",
eq. for integer α — a binomial sum, exact, evaluated in log space), with
the q=1 closed form α/(2z²) (Mironov 2017, Table II). The conversion to
(ε, δ) is Mironov 2017, Proposition 3:

  ε(δ) = min_α  rdp_T(α) + log(1/δ) / (α - 1)

All arithmetic is host-side Python/numpy — the accountant never touches
the training chain. ``z = 0`` (or a non-finite clip with noise off)
yields ε = ∞: without calibrated noise there is no DP guarantee, and the
driver records that honestly rather than omitting the field.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Integer Rényi orders. Dense low range (where subsampled mechanisms
# minimize) plus sparse high orders (where the q=1 Gaussian mechanism
# with small log(1/δ)/(α-1) tails minimizes).
DEFAULT_ORDERS: Tuple[int, ...] = tuple(range(2, 64)) + (
    80, 96, 128, 192, 256, 384, 512)


def _log_binom(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def _logsumexp(xs: Sequence[float]) -> float:
    m = max(xs)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(x - m) for x in xs))


def rdp_sampled_gaussian(q: float, sigma: float, alpha: int) -> float:
    """RDP of one step of the Poisson-subsampled Gaussian mechanism with
    sampling fraction ``q`` and noise multiplier ``sigma`` at integer
    order ``alpha`` >= 2 — exact (Mironov et al. 2019):

      rdp(α) = 1/(α-1) · log Σ_{k=0..α} C(α,k) (1-q)^{α-k} q^k
                               · exp(k(k-1) / (2σ²))

    Closed forms: q=0 → 0 (nothing released about anyone),
    q=1 → α/(2σ²) (plain Gaussian mechanism), σ=0 → ∞.
    """
    if not isinstance(alpha, int) or alpha < 2:
        raise ValueError(f"integer alpha >= 2 required: {alpha!r}")
    if not (0.0 <= q <= 1.0):
        raise ValueError(f"sampling fraction must be in [0, 1]: {q}")
    if q == 0.0:
        return 0.0
    if sigma <= 0.0:
        return math.inf
    if q == 1.0:
        return alpha / (2.0 * sigma * sigma)
    terms = []
    for k in range(alpha + 1):
        log_coef = (_log_binom(alpha, k)
                    + (alpha - k) * math.log1p(-q)
                    + (k * math.log(q) if k else 0.0))
        terms.append(log_coef + k * (k - 1) / (2.0 * sigma * sigma))
    return _logsumexp(terms) / (alpha - 1)


def rdp_to_epsilon(rdp: Sequence[float], orders: Sequence[int],
                   delta: float) -> float:
    """Mironov 2017, Prop. 3: ε = min_α rdp(α) + log(1/δ)/(α-1)."""
    if not (0.0 < delta < 1.0):
        raise ValueError(f"delta must be in (0, 1): {delta}")
    log_inv = math.log(1.0 / delta)
    return min(r + log_inv / (a - 1) for r, a in zip(rdp, orders))


class RDPAccountant:
    """Cumulative RDP ledger for one FL run.

    One ``observe_round(q)`` call per communication round; ``epsilon``
    converts the running ledger to an (ε, δ) guarantee at any time — the
    driver calls it every round to fill ``FLHistory.epsilon`` and enforce
    ``--dp-epsilon-budget``.
    """

    def __init__(self, noise_multiplier: float,
                 orders: Sequence[int] = DEFAULT_ORDERS):
        if noise_multiplier < 0.0:
            raise ValueError(
                f"noise multiplier must be >= 0: {noise_multiplier}")
        self.noise_multiplier = float(noise_multiplier)
        self.orders = tuple(int(a) for a in orders)
        self._rdp = np.zeros(len(self.orders), np.float64)
        self._per_q: Dict[float, np.ndarray] = {}
        self.rounds: List[float] = []     # observed q per round

    def _round_rdp(self, q: float) -> np.ndarray:
        if q not in self._per_q:
            self._per_q[q] = np.asarray(
                [rdp_sampled_gaussian(q, self.noise_multiplier, a)
                 for a in self.orders], np.float64)
        return self._per_q[q]

    def observe_round(self, q: float) -> None:
        """Account one round with sampling fraction ``q``."""
        self.rounds.append(float(q))
        if self.noise_multiplier > 0.0:
            self._rdp = self._rdp + self._round_rdp(float(q))

    def epsilon(self, delta: float) -> float:
        """Cumulative ε at ``delta`` over every observed round."""
        if not self.rounds:
            return 0.0
        if self.noise_multiplier <= 0.0:
            return math.inf
        return rdp_to_epsilon(self._rdp, self.orders, delta)


def compute_epsilon(q: float, noise_multiplier: float, steps: int,
                    delta: float,
                    orders: Sequence[int] = DEFAULT_ORDERS) -> float:
    """ε after ``steps`` identical rounds — the closed-loop form the
    reference-value tests pin against."""
    acct = RDPAccountant(noise_multiplier, orders)
    for _ in range(steps):
        acct.observe_round(q)
    return acct.epsilon(delta)
