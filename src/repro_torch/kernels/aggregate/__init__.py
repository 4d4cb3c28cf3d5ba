"""The client-aggregation kernels: ``chain_aggregate``, ``mean_over_clients``."""
