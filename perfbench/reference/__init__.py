"""The plain reference of the federated GNN rounds.

Plain PyTorch and numpy that imports neither JAX nor anything of the
program.  It is handed the benchmark's own inputs (the graph, the fixed
partition, the initial weights, the seed and the configuration) and
works out everything the program derives from them again: the shards
and their pruning, the sampled minibatches, the forward and backward,
Adam, the exchange through the stated codec, FedAvg and the evaluation.  Where it needs a sampler, a shard builder or a
codec it uses the frozen copies in this package, each of which names
its source.
"""
