"""FedChain on PyTorch and CUDA: the port of the ``repro`` JAX package.

Module paths mirror ``repro``: ``repro_torch/core/algorithms/sgd.py``
answers to ``repro/core/algorithms/sgd.py``. Params are flat ``[D]``
tensors. Every entry point (the spec constructors, ``core.runner.run`` and
``core.chain.Chain.run``) takes ``device=None``, which means ``"cuda"``; see
``repro_torch.device``. The kernels of the main path are hand-written CUDA
(``kernels/*/csrc``), built with ``nvcc`` at first use.
"""
