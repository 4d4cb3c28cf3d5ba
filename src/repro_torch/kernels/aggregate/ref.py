"""Plain PyTorch versions of the aggregation kernels.

They follow ``repro.kernels.aggregate.ref`` term for term: fp32
accumulation, the output in the input's dtype, uniform weights when
``weights`` is None. The CPU path runs them; on the card they are what
the kernels are held against.
"""
from __future__ import annotations

import torch


def chain_aggregate_ref(x, g, c_i, c, *, lr: float, weights=None):
    """out = x − lr·(Σᵢ wᵢ·(gᵢ − cᵢ) + c).

    x, c: [D]; g, c_i: [S, D]; weights: [S] or None (uniform 1/S)."""
    s = g.shape[0]
    if weights is None:
        weights = torch.full((s,), 1.0 / s, dtype=torch.float32,
                             device=g.device)
    else:
        weights = weights.float()
    diff = g.float() - c_i.float()
    update = torch.einsum("s,sd->d", weights, diff) + c.float()
    return (x.float() - lr * update).to(x.dtype)


def mean_over_clients_ref(t):
    """Mean over a leading client axis, any trailing shape."""
    return torch.mean(t.float(), dim=0).to(t.dtype)
