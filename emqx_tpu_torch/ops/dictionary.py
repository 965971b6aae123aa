"""Token dictionary: topic level strings -> dense int32 ids.

A batched matcher needs integer tokens, so topics become fixed-shape
``[batch, max_levels]`` int32 tensors.  The dictionary is append-only
between automaton rebuilds so token ids baked into device tables stay
valid.

Reserved negative ids (never produced by ``add``):
  * ``UNKNOWN_TOK`` — a topic level never seen in any filter.  It misses
    every literal edge but still matches ``+``/``#``.
  * ``PLUS_TOK`` — the ``+`` wildcard as a filter body token (routed to
    the dense ``plus_child`` column, never the literal hash table).
  * ``PAD_TOK`` — padding beyond a topic/filter's real length.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .tokdict_native import NativeEncoder

UNKNOWN_TOK = -2
PLUS_TOK = -3
PAD_TOK = -4

# int32 max; used for "no node" everywhere (sorts after all real ids)
SENTINEL = np.int32(2**31 - 1)


class TokenDict:
    """Append-only word -> id map shared by table builds and encoders.

    Lookups stay on the Python dict.  Batch encodes go through a
    native mirror (`tokdict_native.NativeEncoder`, created by
    `native`) that splits and maps in one GIL-released C++ call and
    reports new words back, so both maps always hold the same word ->
    id relation; once the mirror exists it allocates the ids.
    Mutations are not thread-safe — callers serialize them."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._native = None  # the NativeEncoder, once created
        # two encoders seeded moments apart would alias token ids
        self._nat_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._ids)

    def add(self, word: str) -> int:
        wid = self._ids.get(word)
        if wid is None:
            nat = self._native
            wid = nat.add(word) if nat is not None else len(self._ids)
            self._ids[word] = wid
        return wid

    def get(self, word: str) -> int:
        """Lookup without inserting; unknown words -> UNKNOWN_TOK."""
        return self._ids.get(word, UNKNOWN_TOK)

    def native(self):
        """The native batch encoder, created and seeded with the words
        already here on first use; raises RuntimeError when its library
        does not build."""
        if self._native is None:
            with self._nat_lock:
                if self._native is None:
                    self._native = NativeEncoder(self._ids)
        return self._native

    def encode_filters_into(
        self, items, max_levels: int,
        mat: np.ndarray, blen: np.ndarray, ish: np.ndarray,
    ) -> None:
        """Encode ``(fid, words)`` pairs into the given arrays (row i =
        item i) through the native encoder; new words get ids as
        `encode_filter` would give them.  Raises ValueError for a filter
        body deeper than ``max_levels``."""
        self.native().encode_filters_into(
            self._ids, items, max_levels, mat, blen, ish)


def encode_topics(
    tdict: TokenDict,
    topics: Sequence[Tuple[str, ...]],
    levels: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode concrete topic word-tuples into kernel-ready arrays.

    Returns ``(tokens [B, levels] int32, lengths [B] int32,
    dollar [B] bool)``.  ``levels`` should be the automaton's
    ``kernel_levels``; deeper topics are *truncated*, which is exact:
    no filter body reaches that depth, so only ``#`` terminals (all
    shallower) can match a deeper topic, and they are fully decided by
    the first ``levels`` words.
    """
    b = len(topics)
    tokens = np.full((b, levels), PAD_TOK, np.int32)
    lengths = np.zeros(b, np.int32)
    dollar = np.zeros(b, bool)
    get = tdict.get
    for i, ws in enumerate(topics):
        n = min(len(ws), levels)
        lengths[i] = n
        dollar[i] = bool(ws) and ws[0].startswith("$")
        for j in range(n):
            tokens[i, j] = get(ws[j])
    return tokens, lengths, dollar


def encode_filter(
    tdict: TokenDict, ws: Tuple[str, ...]
) -> Tuple[List[int], bool]:
    """Encode a validated filter's words; adds new literals to the dict.

    Returns ``(body_token_ids, is_hash)`` where ``is_hash`` marks a
    trailing ``#`` (stripped from the body, mirroring how the host trie
    stores ``a/#`` as hash-terminal on node ``a``).
    """
    is_hash = bool(ws) and ws[-1] == "#"
    body = ws[:-1] if is_hash else ws
    out: List[int] = []
    for w in body:
        out.append(PLUS_TOK if w == "+" else tdict.add(w))
    return out, is_hash
