"""Sharding of the subscription index over a grid of devices."""

from .sharded import (
    Mesh, ShardedIndex, ShardedMatchEngine, assemble_sharded,
    build_sharded_index, make_mesh, shard_of, sharded_match,
)

__all__ = [
    "Mesh",
    "ShardedIndex",
    "ShardedMatchEngine",
    "assemble_sharded",
    "build_sharded_index",
    "make_mesh",
    "shard_of",
    "sharded_match",
]
