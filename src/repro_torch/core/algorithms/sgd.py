"""SGD — the paper's Algorithm 2 (global-update method).

Each round: sample S clients, every sampled client returns the average of K
stochastic gradients at the server iterate (Algo 7), the server averages and
takes one step through the ``chain_aggregate`` kernel (η folded into the
client weights, ``base.fused_server_step``). The returned iterate follows
Thm. D.1:

  * strongly convex: weighted average with w_r = (1 − ημ)^{−(r+1)}
  * general convex:  uniform average (``uniform_avg`` with mu_avg = 0)
  * PL:              last iterate
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.algorithms import base


class SGDState(NamedTuple):
    x: torch.Tensor
    tracker: base.AvgTracker
    eta: float
    r: int


@dataclasses.dataclass(frozen=True)
class SGD(base.FederatedAlgorithm):
    mu_avg: float = 0.0  # μ used for the Thm. D.1 averaging weights
    output_mode: str = "weighted_avg"  # weighted_avg | uniform_avg | last
    name: str = "sgd"

    def init(self, problem, x0):
        return SGDState(x=x0, tracker=base.AvgTracker.init(x0),
                        eta=float(self.eta), r=0)

    def round(self, problem, state, gen):
        cids = self.sample(problem, gen)
        g_per = base.grad_k(problem, state.x, cids, gen, self.k)
        x = base.fused_server_step(state.x, g_per, state.eta)
        decay = min(max(1.0 - state.eta * self.mu_avg, 0.0), 1.0)
        tracker = state.tracker.update(x, decay)
        return SGDState(x=x, tracker=tracker, eta=state.eta, r=state.r + 1)

    def output(self, state):
        if self.output_mode == "last":
            return state.x
        return state.tracker.avg
