"""FedChain core on PyTorch: algorithms, selection, runner and chain."""
from repro_torch.core import algorithms, chain, runner, selection, theory, tree_math
from repro_torch.core.chain import Chain, fedchain

__all__ = ["algorithms", "chain", "runner", "selection", "theory",
           "tree_math", "Chain", "fedchain"]
