"""Tensor-parallel placement rules and per-rank sharding."""
