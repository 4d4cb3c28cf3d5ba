"""Parameter arithmetic on flat ``[D]`` tensors.

The JAX package writes these over arbitrary pytrees; this slice of the port
has flat params only, so each helper is the one-leaf case, term for term.
"""
from __future__ import annotations

import torch


def tree_add(a, b):
    return a + b


def tree_axpy(s, a, b):
    """b + s * a  (elementwise)."""
    return b + s * a


def tree_lerp(t, a, b):
    """(1 - t) * a + t * b."""
    return (1.0 - t) * a + t * b


def tree_zeros_like(a):
    return torch.zeros_like(a)


def tree_sq_norm(a):
    return torch.sum(a * a)


def tree_where(pred, a, b):
    return torch.where(pred, a, b)
