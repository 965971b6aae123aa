"""Trivially-correct in-memory DS backend — the test oracle.

The reference ships `emqx_ds_storage_reference` for exactly this
purpose (EMQX apps/emqx_durable_storage/src/
emqx_ds_storage_reference.erl): a backend simple enough to be obviously
right, used to differential-test the real storage layouts.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

from .. import topic as T
from ..message import Message
from .api import DurableStorage, IterRef, StreamRef, filter_streams, stream_of


class ReferenceStorage(DurableStorage):
    def __init__(self, n_streams: int = 16) -> None:
        self.n_streams = n_streams
        self._seq = itertools.count(1)
        # shard -> ordered list of (ts_us, seq, Message)
        self._data: Dict[int, List[Tuple[int, int, Message]]] = {}

    def store_batch(self, msgs: Sequence[Message], sync: bool = False) -> None:
        for msg in msgs:
            shard = stream_of(msg.topic, self.n_streams)
            ts_us = int(msg.timestamp * 1e6)
            self._data.setdefault(shard, []).append(
                (ts_us, next(self._seq), msg)
            )
        for lst in self._data.values():
            lst.sort(key=lambda e: (e[0], e[1]))

    def get_streams(
        self, topic_filter: str, start_time_us: int = 0
    ) -> List[StreamRef]:
        only = filter_streams(topic_filter, self.n_streams)
        shards = self._data.keys() if only is None else [only]
        return [StreamRef(shard=s) for s in sorted(shards) if s in self._data]

    def next(self, it: IterRef, n: int) -> Tuple[IterRef, List[Message]]:
        out: List[Message] = []
        ts, seq = it.ts, it.seq
        fwords = T.words(it.topic_filter)
        for ets, eseq, msg in self._data.get(it.stream.shard, ()):
            # strictly-after cursor; the initial (start_ts, 0) cursor is
            # inclusive of start_ts because real seqs start at 1
            if (ets, eseq) <= (ts, seq):
                continue
            if len(out) >= n:
                break
            if T.match_words(T.words(msg.topic), fwords):
                out.append(msg)
            ts, seq = ets, eseq
        return IterRef(it.stream, it.topic_filter, ts, seq), out
