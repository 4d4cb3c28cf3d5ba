"""Carry a problem and algorithm states across from numpy arrays.

The JAX package's random streams cannot be reproduced in PyTorch, so a run
that must match the JAX package starts from the same arrays: the caller
turns the JAX leaves into numpy (``np.asarray``) and these functions build
the port's objects from them. They take numpy arrays and Python scalars,
never JAX objects.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.core.algorithms import base
from repro_torch.data import spec as spec_lib


def _tensor(a, dev):
    return torch.as_tensor(np.array(a, copy=True), device=dev)


def spec_from_numpy(data: dict, consts: dict, x0, x_star, *,
                    name: str = "quadratic", device=None):
    """The port's quadratic ``ProblemSpec`` from a JAX spec's leaves:
    ``data`` with ``a_i``, ``a_bar``, ``b``, ``b_bar``; ``consts`` with μ, β,
    ζ, ζ_F, σ, σ_F; ``x0``; ``x_star``. F* is recomputed as F(x*) in
    float64 rather than taken from the float32 ``consts["f_star"]``."""
    dev = dev_lib.resolve(device)
    tensors = {k: _tensor(data[k], dev) for k in ("a_i", "a_bar", "b", "b_bar")}
    c = {k: float(np.asarray(consts[k])) for k in spec_lib.CONST_KEYS
         if k != "f_star"}
    return spec_lib.make_quadratic(
        tensors, x0=_tensor(x0, dev), x_star=_tensor(x_star, dev), name=name,
        **c)


def state_from_numpy(algo, fields: dict, *, device=None):
    """The port's state of ``algo`` from numpy fields: ``x``, ``eta`` and
    ``r`` always; ``avg`` and ``wprime`` for an ``AvgTracker``; ``v`` for a
    momentum buffer."""
    dev = dev_lib.resolve(device)
    state = algo.init(None, _tensor(fields["x"], dev))
    repl = dict(eta=float(np.asarray(fields["eta"])),
                r=int(np.asarray(fields["r"])))
    if "avg" in fields:
        repl["tracker"] = base.AvgTracker(
            avg=_tensor(fields["avg"], dev),
            wprime=float(np.asarray(fields["wprime"])))
    if "v" in fields:
        repl["v"] = _tensor(fields["v"], dev)
    return base.audit_state(state._replace(**repl))
