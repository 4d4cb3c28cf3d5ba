"""Executable convergence-rate bounds — the paper's Tables 1, 2 and 4 plus the
Thm. 5.4 / Cor. 5.5 lower bounds, as plain functions of the problem constants.

These are *order* bounds (Õ hides polylog factors and absolute constants); the
benchmarks and tests use them for ordering/regime checks, not exact values.
Every formula cites its table row.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Constants:
    delta: float  # Δ, initial suboptimality (B.9)
    d: float  # D, initial distance (B.10)
    mu: float
    beta: float
    zeta: float
    sigma: float = 0.0
    n: int = 8  # N clients
    s: int = 8  # S sampled per round
    k: int = 16  # oracle calls per client per round

    @property
    def kappa(self):
        return self.beta / self.mu if self.mu > 0 else math.inf

    @property
    def part_frac(self):
        """(1 − S/N) sampling-heterogeneity factor."""
        return max(0.0, 1.0 - self.s / self.n)


def _sampling_term_sc(c: Constants, r: int) -> float:
    """(1 − S/N)·ζ²/(μSR) — strongly convex sampling error."""
    if c.mu <= 0:
        return math.inf
    return c.part_frac * c.zeta**2 / (c.mu * c.s * r)


def _variance_term_sc(c: Constants, r: int) -> float:
    if c.mu <= 0:
        return math.inf
    return c.sigma**2 / (c.mu * c.s * c.k * r)


# --------------------------- Table 1: strongly convex ----------------------

def sgd_strongly_convex(c: Constants, r: int) -> float:
    """Δ·exp(−R/κ) + σ²/(μSKR) + (1−S/N)·ζ²/(μSR)   (Thm. D.1)."""
    return c.delta * math.exp(-r / c.kappa) + _variance_term_sc(c, r) + _sampling_term_sc(c, r)


def asg_strongly_convex(c: Constants, r: int) -> float:
    """Δ·exp(−R/√κ) + σ²/(μSKR) + (1−S/N)·ζ²/(μSR)  (Thm. D.3)."""
    return c.delta * math.exp(-r / c.kappa**0.5) + _variance_term_sc(c, r) + _sampling_term_sc(c, r)


def fedavg_strongly_convex(c: Constants, r: int) -> float:
    """κ·(ζ²/μ)·R⁻² (Woodworth et al. 2020a row of Table 1; σ-term omitted
    per the paper's footnote 2 — made negligible by large K)."""
    return c.kappa * (c.zeta**2 / c.mu) / r**2 + c.sigma**2 / (c.mu * c.k**0.5)


def fedavg_sgd_strongly_convex(c: Constants, r: int) -> float:
    """FedChain FedAvg→SGD (Thm. 4.1): min{Δ, ζ²/μ}·exp(−R/κ) + (1−S/N)ζ²/(μSR)."""
    head = min(c.delta, c.zeta**2 / c.mu) * math.exp(-r / c.kappa)
    return head + _variance_term_sc(c, r) + _sampling_term_sc(c, r)


def fedavg_asg_strongly_convex(c: Constants, r: int) -> float:
    """FedChain FedAvg→ASG (Thm. 4.2): min{Δ, ζ²/μ}·exp(−R/√κ) + (1−S/N)ζ²/(μSR)."""
    head = min(c.delta, c.zeta**2 / c.mu) * math.exp(-r / c.kappa**0.5)
    return head + _variance_term_sc(c, r) + _sampling_term_sc(c, r)


def fedavg_saga_strongly_convex(c: Constants, r: int) -> float:
    """FedChain FedAvg→SAGA (Thm. 4.3), requires R ≥ N/S:
    min{Δ, ζ²/μ}·exp(−min{1/κ, S/N}·R)  — no sampling term."""
    rate = min(1.0 / c.kappa, c.s / c.n)
    return min(c.delta, c.zeta**2 / c.mu) * math.exp(-rate * r) + _variance_term_sc(c, r)


def fedavg_ssnm_strongly_convex(c: Constants, r: int) -> float:
    """FedChain FedAvg→SSNM (Thm. 4.4): κ·min{Δ,ζ²/μ}·exp(−min{S/N, √(S/(Nκ))}·R)."""
    rate = min(c.s / c.n, (c.s / (c.n * c.kappa)) ** 0.5)
    return c.kappa * min(c.delta, c.zeta**2 / c.mu) * math.exp(-rate * r)


def lower_bound_strongly_convex(c: Constants, r: int, *, algo_c: float = 1.0) -> float:
    """Thm. 5.4: Ω(min{Δ, (1/(cκ^{3/2}))·ζ²/β}·exp(−R/√κ)).

    (App. G Eq. 332 has constant 18 in the exponent; we keep the clean −R/√κ
    form of the theorem statement and treat constants as 1.)
    """
    head = min(c.delta, c.zeta**2 / (algo_c * c.kappa**1.5 * c.beta))
    return head * math.exp(-r / c.kappa**0.5)


# --------------------------- Table 2: general convex -----------------------

def sgd_convex(c: Constants, r: int) -> float:
    return c.beta * c.d**2 / r + c.part_frac**0.5 * c.zeta * c.d / (c.s * r) ** 0.5


def asg_convex(c: Constants, r: int) -> float:
    return c.beta * c.d**2 / r**2 + c.part_frac**0.5 * c.zeta * c.d / (c.s * r) ** 0.5


def fedavg_convex(c: Constants, r: int) -> float:
    """Woodworth et al. 2020a row: (β ζ² D⁴ / R²)^{1/3}."""
    return (c.beta * c.zeta**2 * c.d**4 / r**2) ** (1.0 / 3.0)


def fedavg_sgd_convex(c: Constants, r: int) -> float:
    """Thm. 4.1 general convex."""
    head = min(c.beta * c.d**2 / r, (c.beta * c.zeta * c.d**3) ** 0.5 / r**0.5)
    tail = c.part_frac**0.25 * (c.beta * c.zeta * c.d**3) ** 0.5 / (c.s * r) ** 0.25
    return head + tail


def fedavg_asg_convex(c: Constants, r: int) -> float:
    """Thm. 4.2 general convex."""
    head = min(c.beta * c.d**2 / r**2, (c.beta * c.zeta * c.d**3) ** 0.5 / r)
    tail = (
        c.part_frac**0.5 * c.zeta * c.d / (c.s * r) ** 0.5
        + c.part_frac**0.25 * (c.beta * c.zeta * c.d**3) ** 0.5 / (c.s * r) ** 0.25
    )
    return head + tail


def lower_bound_convex(c: Constants, r: int, *, algo_c: float = 1.0) -> float:
    """Thm. 5.4 (μ=0): Ω(min{βD²/R², ζD/(√c·R^{5/2})})."""
    return min(c.beta * c.d**2 / r**2, c.zeta * c.d / (algo_c**0.5 * r**2.5))


# --------------------------- Table 4: PL -----------------------------------

def sgd_pl(c: Constants, r: int) -> float:
    return (
        c.delta * math.exp(-r / c.kappa)
        + c.kappa * c.sigma**2 / (c.mu * c.s * c.k * r)
        + c.part_frac * c.kappa * c.zeta**2 / (c.mu * c.s * r)
    )


def fedavg_pl(c: Constants, r: int) -> float:
    """Karimireddy et al. 2020a row: κΔ·exp(−R/κ) + κ²ζ²/(μR²)."""
    return c.kappa * c.delta * math.exp(-r / c.kappa) + c.kappa**2 * c.zeta**2 / (c.mu * r**2)


def fedavg_sgd_pl(c: Constants, r: int) -> float:
    """Thm. 4.1 PL: min{Δ, ζ²/μ}·exp(−R/κ) + (1−S/N)κζ²/(μSR)."""
    head = min(c.delta, c.zeta**2 / c.mu) * math.exp(-r / c.kappa)
    return head + c.part_frac * c.kappa * c.zeta**2 / (c.mu * c.s * r)


def fedavg_saga_pl(c: Constants, r: int) -> float:
    """Thm. 4.3 PL: min{Δ, ζ²/μ}·exp(−R/(κ(N/S)^{2/3}))."""
    return min(c.delta, c.zeta**2 / c.mu) * math.exp(-r / (c.kappa * (c.n / c.s) ** (2.0 / 3.0)))


def lower_bound_pl(c: Constants, r: int, *, algo_c: float = 1.0) -> float:
    """Cor. 5.5 — same as the strongly convex lower bound."""
    return lower_bound_strongly_convex(c, r, algo_c=algo_c)


TABLE1 = {
    "sgd": sgd_strongly_convex,
    "asg": asg_strongly_convex,
    "fedavg": fedavg_strongly_convex,
    "fedavg->sgd": fedavg_sgd_strongly_convex,
    "fedavg->asg": fedavg_asg_strongly_convex,
    "fedavg->saga": fedavg_saga_strongly_convex,
    "fedavg->ssnm": fedavg_ssnm_strongly_convex,
    "lower_bound": lower_bound_strongly_convex,
}

TABLE2 = {
    "sgd": sgd_convex,
    "asg": asg_convex,
    "fedavg": fedavg_convex,
    "fedavg->sgd": fedavg_sgd_convex,
    "fedavg->asg": fedavg_asg_convex,
    "lower_bound": lower_bound_convex,
}

TABLE4 = {
    "sgd": sgd_pl,
    "fedavg": fedavg_pl,
    "fedavg->sgd": fedavg_sgd_pl,
    "fedavg->saga": fedavg_saga_pl,
    "lower_bound": lower_bound_pl,
}
