"""Federated control plane of the port: coordinator service, client
workers and their math (port of ``repro.fedsvc``).

  coordinator.py — threaded TCP service that registers workers, serves
                   the global model, collects client updates and
                   aggregates them (sync FedAvg, bit-compatible with the
                   in-process trainer, or async FedBuff).
  worker.py      — a client process running its clients' share of every
                   round through ``FederatedGNNTrainer.client_round``
                   over the TCP embedding wire.
  protocol.py    — the coordinator wire protocol: JSON headers + raw
                   tensor blocks, the JAX package's bytes.
  aggregation.py — the pure math, shared by the in-process trainer and
                   the coordinator so the two paths cannot drift.
  runtime.py     — RunConfig: one declarative description of a
                   deployment that every participant rebuilds.

CLIs live in ``repro_torch.launch.fed_coordinator`` and
``repro_torch.launch.fed_worker``.
"""

# Lazy exports (PEP 562): importing repro_torch.fedsvc.aggregation from
# repro_torch.core must not drag in the worker (which imports the core).
_EXPORTS = {
    "fedavg_leaves": "aggregation",
    "leaf_add": "aggregation",
    "leaf_sub": "aggregation",
    "staleness_scale": "aggregation",
    "apply_buffered_deltas": "aggregation",
    "CoordinatorClient": "protocol",
    "CoordinatorState": "coordinator",
    "serve_in_thread": "coordinator",
    "FedWorker": "worker",
    "WorkerScenario": "worker",
    "run_in_thread": "worker",
    "RunConfig": "runtime",
    "EvalHarness": "runtime",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
