"""Federated optimization algorithms of the main path (Algos 2, 4, 7 and
the practical Nesterov ASG)."""
from repro_torch.core.algorithms.base import (
    FederatedAlgorithm, grad_k, sample_clients, value_k)
from repro_torch.core.algorithms.asg import NesterovSGD
from repro_torch.core.algorithms.fedavg import FedAvg
from repro_torch.core.algorithms.sgd import SGD

__all__ = ["FederatedAlgorithm", "grad_k", "sample_clients", "value_k",
           "SGD", "NesterovSGD", "FedAvg"]
