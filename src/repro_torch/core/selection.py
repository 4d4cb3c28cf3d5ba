"""Better-point selection (middle step of Algo 1, analyzed in Lemma H.2).

Sample S clients, draw K function-value samples ẑ_{i,k} per client, and keep
the candidate with the smaller empirical average

    x̂_1 = argmin_{x ∈ candidates} (1/SK) Σ_{i∈S} Σ_k f(x; ẑ_{i,k}).

Lemma H.2 guarantees E[F(x̂_1)] ≤ min_x F(x) + 4σ_F/√(SK) + 4√(1−(S−1)/(N−1))·ζ_F/√S.

All candidates are scored on the SAME samples: the clients and the [S, K]
value noise are drawn once and every candidate is evaluated on them. The
values are float64, so the comparison at full width is not rounding.
"""
from __future__ import annotations

import torch

from repro_torch.core.algorithms import base


def empirical_values(problem, candidates, gen, *, s: int, k: int):
    """Empirical (1/SK)ΣΣ f(x; ẑ) for every candidate on shared samples,
    as a float64 tensor [len(candidates)]."""
    cids = base.sample_clients(gen, problem.num_clients, s, problem.device)
    noise = torch.randn((s, k), generator=gen, device=problem.device)
    return torch.stack([torch.mean(problem.value_oracle(x, cids, noise))
                        for x in candidates])


def select_better(problem, candidates, gen, *, s: int, k: int):
    """Returns (best_candidate, best_index, empirical_values)."""
    vals = empirical_values(problem, candidates, gen, s=s, k=k)
    idx = int(torch.argmin(vals))
    return candidates[idx], idx, vals


def selection_error_bound(problem, *, s: int, k: int):
    """The Lemma H.2 additive error term 4σ_F/√(SK) + 4√(1−(S−1)/(N−1))·ζ_F/√S."""
    n = problem.num_clients
    frac = 0.0 if n <= 1 else max(0.0, 1.0 - (s - 1) / (n - 1))
    return 4.0 * problem.sigma_f / (s * k) ** 0.5 + 4.0 * (frac**0.5) * problem.zeta_f / s**0.5
