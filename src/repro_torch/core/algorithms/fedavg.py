"""FedAvg — the paper's Algorithm 4 (local-update method).

The paper splits the per-round oracle budget K into √K local steps, each
with a √K-sample-averaged stochastic gradient; ``from_k`` builds that
convention from K, and (local_steps, inner_batch) are exposed directly.

Server update: x^{r+1} = (1 − server_lr)·x^r + server_lr·meanᵢ y_{i,final}
(the paper uses server_lr = 1, plain iterate averaging); the client mean runs
through the ``mean_over_clients`` kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import tree_math as tm
from repro_torch.core.algorithms import base


class FedAvgState(NamedTuple):
    x: torch.Tensor
    eta: float
    r: int


@dataclasses.dataclass(frozen=True)
class FedAvg(base.FederatedAlgorithm):
    local_steps: int = 4  # √K in the paper
    inner_batch: int = 4  # gradient samples averaged per local step (√K)
    server_lr: float = 1.0
    name: str = "fedavg"

    @classmethod
    def from_k(cls, k: int, **kw):
        root = max(1, int(round(math.sqrt(k))))
        return cls(k=k, local_steps=root, inner_batch=root, **kw)

    def round(self, problem, state, gen):
        cids = self.sample(problem, gen)
        # one row of y per sampled client, all starting at the server iterate
        y = state.x.expand(len(cids), -1)
        for _ in range(self.local_steps):
            g = problem.grad_oracle(y, cids, gen, self.inner_batch)
            y = tm.tree_axpy(-state.eta, g, y)
        y_mean = base.client_mean(state.x, y)
        x = tm.tree_lerp(self.server_lr, state.x, y_mean)
        return FedAvgState(x=x, eta=state.eta, r=state.r + 1)

    def init(self, problem, x0):
        return FedAvgState(x=x0, eta=float(self.eta), r=0)

    def output(self, state):
        return state.x
