"""Wrappers that launch the CUDA aggregation kernels (``csrc/aggregate.cu``).

They take CUDA tensors only: each checks device, dtype (float32 or
bfloat16), shape and contiguity and raises on anything else, allocates its
output with ``torch.empty``, launches on the current stream and raises if
the launch returns a CUDA error. ``LAUNCHES`` counts the launches of each
kernel; nothing else changes it.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import _build

LAUNCHES: collections.Counter = collections.Counter()

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("aggregate")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"chain_aggregate_{sfx}")
        fn.argtypes = [ptr] * 6 + [i64, i64, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"mean_over_clients_{sfx}")
        fn.argtypes = [ptr, ptr, i64, i64, ptr]
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, tensors: dict, dtype, device):
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _launch(name, fn, *args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = _lib().cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def chain_aggregate(x, g, c_i, c, weights, *, lr: float):
    """out = x − lr·(Σᵢ wᵢ·(gᵢ − cᵢ) + c), accumulated in float32.

    x, c: [D]; g, c_i: [S, D], all float32 or all bfloat16; weights: [S]
    float32. Returns [D] in x's dtype.
    """
    if x.device.type != "cuda":
        raise ValueError(f"chain_aggregate: x is on {x.device}; the kernel "
                         f"takes CUDA tensors")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"chain_aggregate: dtype {x.dtype} is not float32 "
                        f"or bfloat16")
    if x.ndim != 1 or g.ndim != 2:
        raise ValueError(f"chain_aggregate: x must be [D] and g [S, D], got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    s, d = g.shape
    if s < 1 or d < 1:
        raise ValueError(f"chain_aggregate: empty operand, S={s}, D={d}")
    for arg, t, shape in (("x", x, (d,)), ("c_i", c_i, (s, d)),
                          ("c", c, (d,)), ("weights", weights, (s,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"chain_aggregate: {arg} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    _check("chain_aggregate", dict(x=x, g=g, c_i=c_i, c=c), x.dtype,
           x.device)
    _check("chain_aggregate", dict(weights=weights), torch.float32, x.device)
    out = torch.empty_like(x)
    fn = getattr(_lib(), f"chain_aggregate_{_SUFFIX[x.dtype]}")
    _launch("chain_aggregate", fn, x.data_ptr(), g.data_ptr(),
            c_i.data_ptr(), c.data_ptr(), weights.data_ptr(), out.data_ptr(),
            s, d, float(lr), device=x.device)
    return out


def mean_over_clients(t):
    """Mean over the leading client axis of a [C, ...] tensor, accumulated
    in float32; returns [...] in t's dtype."""
    if t.device.type != "cuda":
        raise ValueError(f"mean_over_clients: t is on {t.device}; the kernel "
                         f"takes CUDA tensors")
    if t.dtype not in _SUFFIX:
        raise TypeError(f"mean_over_clients: dtype {t.dtype} is not float32 "
                        f"or bfloat16")
    if t.ndim < 1 or t.numel() == 0:
        raise ValueError(f"mean_over_clients: need a non-empty [C, ...] "
                         f"tensor, got {tuple(t.shape)}")
    _check("mean_over_clients", dict(t=t), t.dtype, t.device)
    c = t.shape[0]
    d = t.numel() // c
    out = torch.empty(t.shape[1:], dtype=t.dtype, device=t.device)
    fn = getattr(_lib(), f"mean_over_clients_{_SUFFIX[t.dtype]}")
    _launch("mean_over_clients", fn, t.data_ptr(), out.data_ptr(), c, d,
            device=t.device)
    return out
