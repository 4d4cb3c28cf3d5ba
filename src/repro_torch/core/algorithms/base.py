"""Common machinery for the federated algorithms (Algos 2, 4 and 7).

Conventions, as in ``repro.core.algorithms.base``:

* An algorithm is a small frozen dataclass of hyperparameters with

    init(problem, x0)            -> state   (a NamedTuple)
    round(problem, state, gen)   -> state   (ONE communication round)
    output(state)                -> params  (the returned iterate x̂)

  ``gen`` is the round's ``torch.Generator``; a round draws its clients and
  then its oracle noise from it.
* Every state carries ``.x`` (the server iterate, a flat [D] tensor),
  ``.eta`` (the base stepsize, a Python float) and ``.r`` (the round
  counter, an int). ``round`` passes ``eta`` through unchanged;
  ``audit_state`` checks the protocol.
* Client sampling is uniform without replacement (paper §2).
* ``Grad`` (Algo 7): each sampled client averages K stochastic gradient
  queries at the server iterate.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels.aggregate import ops as agg_ops

REQUIRED_STATE_FIELDS = ("x", "eta", "r")


def audit_state(state):
    """Raise unless ``state`` follows the x/eta/r state protocol."""
    missing = [f for f in REQUIRED_STATE_FIELDS if not hasattr(state, f)]
    if missing:
        raise TypeError(
            f"{type(state).__name__} violates the state protocol: missing "
            f"field(s) {missing}")
    if not hasattr(state, "_replace"):
        raise TypeError(f"{type(state).__name__} must be a NamedTuple")
    return state


def flat_params(x) -> bool:
    """True when params are a single flat [D] vector, the layout the
    aggregation kernels take."""
    return isinstance(x, torch.Tensor) and x.ndim == 1


def _require_flat(x):
    if not flat_params(x):
        raise TypeError(f"params must be a flat [D] tensor, got "
                        f"{type(x).__name__} {getattr(x, 'shape', '')}")


def client_mean(x, stacked):
    """Mean over the leading client axis of ``stacked`` [S, D], through the
    ``mean_over_clients`` kernel (``x``, the server iterate, fixes the
    layout)."""
    _require_flat(x)
    return agg_ops.mean_over_clients(stacked)


def fused_server_step(x, g_per, eta, *, c_i=None, c_mean=None):
    """The server update x − η·(meanᵢ(gᵢ − cᵢ) + c̄) as one
    ``chain_aggregate`` pass.

    η is folded into the operands as in the JAX package: weights η/S per
    client, c = η·c̄ (zeros without a server variate), c_i zeros without
    client variates, lr = 1.
    """
    _require_flat(x)
    s = g_per.shape[0]
    w = torch.full((s,), 1.0, dtype=torch.float32, device=x.device) * (eta / s)
    ci = torch.zeros_like(g_per) if c_i is None else c_i
    c = torch.zeros_like(x) if c_mean is None else eta * c_mean
    return agg_ops.chain_aggregate(x, g_per, ci, c, weights=w, lr=1.0)


def sample_clients(gen, num_clients: int, s: int, device=None):
    """S of N clients uniformly without replacement (paper §2), as a [S]
    index tensor on ``device``."""
    if not 0 < s <= num_clients:
        raise ValueError(
            f"cannot sample {s} of {num_clients} clients without "
            f"replacement")
    return torch.randperm(num_clients, generator=gen, device=device)[:s]


def grad_k(problem, x, client_ids, gen, k: int):
    """Algo 7 ``Grad``: per-client average of K stochastic gradients at x,
    as an [S, D] tensor (K separate noise draws per client)."""
    return problem.grad_oracle(x, client_ids, gen, k)


def value_k(problem, x, client_ids, gen, k: int):
    """Average of K stochastic function-value queries per client, then the
    mean over clients (a float64 0-d tensor)."""
    noise = torch.randn((len(client_ids), k), generator=gen,
                        device=problem.device)
    return torch.mean(problem.value_oracle(x, client_ids, noise))


class AvgTracker(NamedTuple):
    """Numerically stable tracker for x̂ = (1/W_R)·Σ w_r x_r,
    w_r = (1−ημ)^{−r}.

    Normalized recurrence: W'_r = 1 + (1−ημ)·W'_{r−1};
    avg_r = avg_{r−1} + (x_r − avg_{r−1}) / W'_r.
    """

    avg: torch.Tensor
    wprime: float

    @staticmethod
    def init(x):
        return AvgTracker(avg=x, wprime=1.0)

    def update(self, x, decay: float):
        """decay = (1 − ημ) ∈ [0, 1]; decay=1 gives the uniform average."""
        wprime = 1.0 + decay * self.wprime
        return AvgTracker(avg=self.avg + (x - self.avg) / wprime,
                          wprime=wprime)


@dataclasses.dataclass(frozen=True)
class FederatedAlgorithm:
    """Base class; concrete algorithms override init/round/output."""

    eta: float = 0.1
    k: int = 16  # oracle queries per client per round (paper's K)
    s: int = 0  # sampled clients per round; 0 => full participation (S=N)
    name: str = "base"

    def participation(self, problem):
        return self.s if self.s and self.s > 0 else problem.num_clients

    def sample(self, problem, gen):
        """This round's client ids."""
        return sample_clients(gen, problem.num_clients,
                              self.participation(problem), problem.device)

    # --- to be overridden -------------------------------------------------
    def init(self, problem, x0):
        raise NotImplementedError

    def round(self, problem, state, gen):
        raise NotImplementedError

    def output(self, state):
        return state.x
