"""Dispatch of the aggregation kernels by the device of the tensors.

A CPU tensor takes the plain PyTorch version (``ref``); a CUDA tensor takes
the CUDA kernel (``aggregate``), which launches or raises. There is no other
path and no switch: a CUDA tensor never reaches the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.aggregate import aggregate, ref


def chain_aggregate(x, g, c_i, c, weights, *, lr: float):
    if x.device.type == "cpu":
        return ref.chain_aggregate_ref(x, g, c_i, c, lr=lr, weights=weights)
    return aggregate.chain_aggregate(x, g, c_i, c, weights, lr=lr)


def mean_over_clients(t):
    if t.device.type == "cpu":
        return ref.mean_over_clients_ref(t)
    return aggregate.mean_over_clients(t)
