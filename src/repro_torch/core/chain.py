"""FedChain — the paper's Algorithm 1, and its multi-stage form.

  x̂_1/2 ← A_local(x̂_0)                      (local_fraction · R rounds)
  x̂_1   ← better of {x̂_0, x̂_1/2}            (Lemma H.2 selection, S clients × K samples)
  x̂_2   ← A_global(x̂_1)                     (remaining rounds)

``Chain`` runs an ordered list of stages. Its per-round schedule is the JAX
package's (``_schedule``): which stage runs each round, whether the round is
a costed selection round, and how the next stage is entered (the handoff
modes below). Here it drives an eager Python loop. Randomness comes from
named streams of the run's seed: stage i's round j draws from
``(seed, ROUND_TAG, i, j)`` and the selection after stage i from
``(seed, SELECT_TAG, i)``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.core import selection
from repro_torch.core import tree_math as tm
from repro_torch.core.algorithms import base
from repro_torch.core.runner import ROUND_TAG

SELECT_TAG = 0x736C  # stream tag of selections ("sl")

# handoff modes (the transition INTO stage j, applied before its first round)
_H_NONE = 0  # no handoff this round
_H_ANCHOR = 1  # init from the anchor (a costed selection round already ran)
_H_SELECT = 2  # inline selection between anchor and previous stage's output
_H_TAKE = 3  # take the previous stage's output unconditionally


@dataclasses.dataclass
class ChainResult:
    x_hat: torch.Tensor
    history: torch.Tensor  # [R] float64 per-round suboptimality
    switch_rounds: list  # round indices where a stage switch happened
    selected_initial: list  # per selection: True if it kept the pre-stage point


@dataclasses.dataclass(frozen=True)
class _Schedule:
    """Static per-round schedule for a chain execution."""

    stage_id: np.ndarray  # [R] which stage's round (or whose output, kind=1)
    kind: np.ndarray  # [R] 0 = algorithm round, 1 = selection round
    hmode: np.ndarray  # [R] handoff mode before the round (_H_*)
    round_slot: np.ndarray  # [R] the round's index within its stage
    sel_stage: np.ndarray  # [R] selection stream index (stage whose stream to use)
    budgets: tuple  # per-stage round budgets
    switch_rounds: tuple  # cumulative totals after each stage
    sel_indices: tuple  # round indices carrying a selection decision


@dataclasses.dataclass(frozen=True)
class Chain:
    """A FedChain instantiation: an ordered list of algorithms + fractions."""

    stages: Sequence[object]  # algorithm instances
    fractions: Sequence[float]  # round fractions per stage (sums to <= 1)
    selection_k: int = 16
    select_between_stages: bool = True
    selection_costs_round: bool = True
    name: str = "chain"

    def budgets(self, rounds: int):
        if len(self.stages) != len(self.fractions):
            raise ValueError(f"{len(self.stages)} stages but "
                             f"{len(self.fractions)} fractions")
        budgets = [max(1, int(round(f * rounds))) for f in self.fractions]
        # spend any rounding surplus/deficit on the last stage
        budgets[-1] += rounds - sum(budgets) - (
            (len(self.stages) - 1)
            if (self.select_between_stages and self.selection_costs_round) else 0
        )
        budgets[-1] = max(1, budgets[-1])
        return budgets

    def _schedule(self, rounds: int) -> _Schedule:
        budgets = self.budgets(rounds)
        n = len(self.stages)
        stage_id, kind, hmode, round_slot, sel_stage = [], [], [], [], []
        switch_rounds, sel_indices = [], []

        for i, b in enumerate(budgets):
            for j in range(b):
                mode = _H_NONE
                if i > 0 and j == 0:
                    if self.select_between_stages and self.selection_costs_round:
                        mode = _H_ANCHOR
                    elif self.select_between_stages:
                        mode = _H_SELECT
                        sel_indices.append(len(stage_id))
                    else:
                        mode = _H_TAKE
                stage_id.append(i)
                kind.append(0)
                hmode.append(mode)
                round_slot.append(j)
                sel_stage.append(max(i - 1, 0))
            if i + 1 < n and self.select_between_stages and self.selection_costs_round:
                sel_indices.append(len(stage_id))
                stage_id.append(i)
                kind.append(1)
                hmode.append(_H_NONE)
                round_slot.append(0)
                sel_stage.append(i)
            switch_rounds.append(len(stage_id))

        return _Schedule(
            stage_id=np.asarray(stage_id, np.int32),
            kind=np.asarray(kind, np.int32),
            hmode=np.asarray(hmode, np.int32),
            round_slot=np.asarray(round_slot, np.int32),
            sel_stage=np.asarray(sel_stage, np.int32),
            budgets=tuple(budgets),
            switch_rounds=tuple(switch_rounds),
            sel_indices=tuple(sel_indices),
        )

    def _select2(self, problem, anchor, cand, gen):
        """Lemma H.2 pick between the anchor and a candidate. Returns the
        pick and a 0-d bool tensor, True when it kept the anchor (ties keep
        the anchor); nothing waits for the device. It scores every client."""
        vals = selection.empirical_values(
            problem, [anchor, cand], gen, s=problem.num_clients,
            k=self.selection_k)
        keep = vals[0] <= vals[1]
        return tm.tree_where(keep, anchor, cand), keep

    def run(self, problem, x0, rounds: int, seed: int, *,
            device=None) -> ChainResult:
        """Execute the chain for a total budget of ``rounds`` communication
        rounds (costed selection rounds included) from ``x0``. ``device``
        must be the problem's."""
        dev = dev_lib.check_same(device, problem.device)
        sched = self._schedule(rounds)
        stages = list(self.stages)
        states = [base.audit_state(a.init(problem, x0)) for a in stages]
        anchor = x0
        history = torch.empty((len(sched.stage_id),), dtype=torch.float64,
                              device=dev)
        kept = {}
        for t in range(len(sched.stage_id)):
            sid, hmd = int(sched.stage_id[t]), int(sched.hmode[t])
            if hmd != _H_NONE:
                prev_out = stages[sid - 1].output(states[sid - 1])
                if hmd == _H_ANCHOR:
                    x_init = anchor
                elif hmd == _H_SELECT:
                    x_init, kept[t] = self._select2(
                        problem, anchor, prev_out, dev_lib.generator(
                            dev, seed, SELECT_TAG, int(sched.sel_stage[t])))
                else:
                    x_init = prev_out
                eta = states[sid].eta
                states[sid] = stages[sid].init(problem, x_init)._replace(
                    eta=eta)
            if sched.kind[t] == 1:
                cand = stages[sid].output(states[sid])
                anchor, kept[t] = self._select2(
                    problem, anchor, cand, dev_lib.generator(
                        dev, seed, SELECT_TAG, int(sched.sel_stage[t])))
                history[t] = problem.suboptimality(anchor)
            else:
                states[sid] = stages[sid].round(
                    problem, states[sid], dev_lib.generator(
                        dev, seed, ROUND_TAG, sid, int(sched.round_slot[t])))
                history[t] = problem.suboptimality(
                    stages[sid].output(states[sid]))
        return ChainResult(
            x_hat=stages[-1].output(states[-1]),
            history=history,
            switch_rounds=list(sched.switch_rounds[:-1]),
            selected_initial=[bool(kept[i]) for i in sched.sel_indices],
        )


def fedchain(a_local, a_global, *, local_fraction: float = 0.5, **kw) -> Chain:
    """The canonical two-stage FedChain (Algo 1)."""
    name = kw.pop("name", f"{a_local.name}->{a_global.name}")
    return Chain(
        stages=[a_local, a_global],
        fractions=[local_fraction, 1.0 - local_fraction],
        name=name,
        **kw,
    )
