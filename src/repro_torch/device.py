"""Where tensors live, and the named random streams that fill them.

The device rule, in one place: ``device=None`` means ``"cuda"``. An entry
point never falls back to the CPU on its own; a caller that wants the CPU
(the tests) asks for it with ``device="cpu"``.

Random streams: a run takes an integer seed, and every stream it draws from
(one per stage round, one per selection, the problem construction) is a
``torch.Generator`` on the run's device, seeded from the seed and the
stream's integer tags through ``numpy.random.SeedSequence``. Streams with
different tags are independent; the same seed and tags give the same stream.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on; raises rather than fall back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def check_same(device, spec_device) -> torch.device:
    """Resolve ``device`` and require it to be the problem's device."""
    dev = resolve(device)
    if dev.type != spec_device.type or (
            dev.index is not None and dev.index != spec_device.index):
        raise ValueError(f"run asked for device {dev}, but the problem "
                         f"lives on {spec_device}")
    return spec_device


def generator(device: torch.device, seed: int, *tags: int) -> torch.Generator:
    """The random stream named by ``(seed, *tags)`` on ``device``."""
    # the tag count leads, so tag tuples that differ only by trailing zeros
    # (which SeedSequence's entropy pool would merge) stay distinct
    words = np.random.SeedSequence(
        [int(seed), len(tags), *map(int, tags)]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen
