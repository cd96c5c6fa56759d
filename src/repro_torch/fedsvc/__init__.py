"""Federated control-plane math of the port (``repro.fedsvc``'s FedAvg)."""

from .aggregation import fedavg_leaves

__all__ = ["fedavg_leaves"]
