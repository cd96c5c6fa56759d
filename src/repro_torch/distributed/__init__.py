"""Sharding rules of the port (``repro.distributed``)."""

from .sharding import (P, ShardingRules, batch_specs, cache_specs,
                       logical_constraint, make_rules, opt_specs,
                       param_specs, placements)

__all__ = ["P", "ShardingRules", "make_rules", "param_specs", "opt_specs",
           "batch_specs", "cache_specs", "placements", "logical_constraint"]
