"""The round loop: run one federated algorithm for R rounds.

An eager Python loop over rounds (JAX scans a compiled schedule). Round r
draws from its own stream ``(seed, ROUND_TAG, r)`` on the problem's device.
After every round the history records F(x̂_r) − F* in float64, where x̂_r is
the algorithm's returned iterate.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as dev_lib
from repro_torch.core.algorithms import base

ROUND_TAG = 0x726E  # stream tag of algorithm rounds ("rn")


@dataclasses.dataclass
class RunResult:
    state: object  # final algorithm state
    x_hat: torch.Tensor  # algorithm's returned iterate
    history: torch.Tensor  # [R] float64: F(x̂_r) − F* after each round


def run(algo, problem, x0, rounds: int, seed: int, *,
        device=None) -> RunResult:
    """Run ``rounds`` communication rounds from ``x0``; record the
    suboptimality after each one. ``device`` must be the problem's."""
    dev = dev_lib.check_same(device, problem.device)
    state = base.audit_state(algo.init(problem, x0))
    history = torch.empty((rounds,), dtype=torch.float64, device=dev)
    for r in range(rounds):
        state = algo.round(problem, state,
                           dev_lib.generator(dev, seed, ROUND_TAG, r))
        history[r] = problem.suboptimality(algo.output(state))
    return RunResult(state=state, x_hat=algo.output(state), history=history)
