"""Accelerated SGD: the practical Nesterov variant the paper runs in its
experiments (App. I.1, "the more easily implementable version in Aybat et
al. (2019)"). AC-SA (Algo 3) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import tree_math as tm
from repro_torch.core.algorithms import base


class NesterovState(NamedTuple):
    x: torch.Tensor
    v: torch.Tensor  # momentum buffer
    eta: float
    r: int


@dataclasses.dataclass(frozen=True)
class NesterovSGD(base.FederatedAlgorithm):
    """Nesterov momentum on the global gradient; momentum defaults to the
    strongly convex optimum (√κ−1)/(√κ+1) when μ > 0. The client average of
    the lookahead gradients runs through the ``mean_over_clients`` kernel.
    """

    mu: float = 0.0
    beta: float = 1.0
    momentum: float = -1.0  # <0 => derive from kappa
    name: str = "asg"

    def _momentum(self):
        if self.momentum >= 0:
            return self.momentum
        if self.mu > 0:
            sk = (self.beta / self.mu) ** 0.5
            return (sk - 1.0) / (sk + 1.0)
        return 0.9

    def init(self, problem, x0):
        return NesterovState(x=x0, v=tm.tree_zeros_like(x0),
                             eta=float(self.eta), r=0)

    def round(self, problem, state, gen):
        m = self._momentum()
        x_look = tm.tree_axpy(m, state.v, state.x)  # lookahead point
        cids = self.sample(problem, gen)
        g = base.client_mean(
            state.x, base.grad_k(problem, x_look, cids, gen, self.k))
        v = m * state.v - state.eta * g
        x = tm.tree_add(state.x, v)
        return NesterovState(x=x, v=v, eta=state.eta, r=state.r + 1)

    def output(self, state):
        return state.x
