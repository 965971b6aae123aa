"""Durable storage (the `emqx_durable_storage` layer).

`api` defines the emqx_ds-style behavior (store_batch / get_streams /
make_iterator / next) with value-typed resumable iterators;
`builtin_local` is the real single-node backend on the native C++
dslog engine; `lts` adds the learned topic structure on top of it;
`sharded` splits the store by stream hash into N independent
segment-log + metadata pairs; `journal` owns the incremental-metadata
algebra (append-only delta journal, fold-into-snapshot); `durability`
is the group-commit fsync gate (per-shard gates front a `GateGroup`);
`reference` is the trivially-correct in-memory oracle used by the
differential tests.
"""

from .api import DurableStorage, IterRef, StreamRef
from .builtin_local import LocalStorage
from .durability import GateGroup, SyncGate
from .journal import MetaJournal
from .lts import LtsStorage
from .reference import ReferenceStorage
from .sharded import ShardedStorage

__all__ = [
    "DurableStorage",
    "IterRef",
    "StreamRef",
    "LocalStorage",
    "LtsStorage",
    "ShardedStorage",
    "MetaJournal",
    "SyncGate",
    "GateGroup",
    "ReferenceStorage",
]
