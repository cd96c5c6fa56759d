"""Core runtime of the port: cost model, embedding server and the
publish half of the federated runtime (imports nothing at package level,
so the exchange and core modules can import each other's submodules)."""
