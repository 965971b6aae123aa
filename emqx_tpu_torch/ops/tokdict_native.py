"""ctypes binding for the native token dictionary (``native/tokdict.cpp``).

One call encodes a batch of filters (split, word -> id, ``+``/``#``
handling) or of topic names (get-only lookups, truncation at the
kernel's levels, the ``$`` flag) with the GIL released.  Ids are
bit-identical to `dictionary.TokenDict`'s: new words are mirrored back
into the Python dict after each call, so both maps always agree, and
the Python dict stays the lookup path for single words."""

from __future__ import annotations

import ctypes

import numpy as np

from . import _native


def _spans(parts):
    """(blob, starts, lens) of byte strings laid end to end: spans are
    length-delimited, never split on content."""
    n = len(parts)
    lens = np.fromiter((len(p) for p in parts), np.int64, count=n)
    starts = np.zeros(n, np.int64)
    if n:
        np.cumsum(lens[:-1], out=starts[1:])
    return b"".join(parts), starts, lens


class NativeEncoder:
    """The native mirror of one TokenDict, with its batch encoders."""

    def __init__(self, ids: dict) -> None:
        lib = self._lib = _native.load("tokdict")
        self._h = lib.td_new()
        if ids:
            # a Python dict iterates in insertion order, which is id
            # order: position i is word i's id
            blob, starts, lens = _spans([w.encode() for w in ids])
            lib.td_seed(self._h, blob, _native.ptr(starts),
                        _native.ptr(lens), len(ids))

    def __del__(self) -> None:
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.td_free(h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.td_len(self._h)

    def add(self, word: str) -> int:
        w = word.encode()
        return self._lib.td_add(self._h, w, len(w))

    def encode_filters_into(
        self, ids: dict, items, max_levels: int,
        mat: np.ndarray, blen: np.ndarray, ish: np.ndarray,
    ) -> None:
        """Encode ``items`` (``(fid, words)`` pairs) into the given
        arrays (row i = item i) in ONE GIL-released call, then mirror
        the new words into the Python ``ids`` dict."""
        n = len(items)
        _check(mat, (n, max_levels), np.int32)
        _check(blen, (n,), np.int32)
        _check(ish, (n,), np.bool_)
        blob, starts, lens = _spans(
            [("/".join(ws)).encode() for _, ws in items])
        cap = int(lens.sum()) + 1  # new words <= total bytes
        new_ids = np.empty(cap, np.int32)
        new_spans = np.empty(2 * cap, np.int64)
        err_i = ctypes.c_int64(-1)
        n_new = self._lib.td_encode_filters(
            self._h, blob, _native.ptr(starts), _native.ptr(lens), n,
            max_levels, _native.ptr(mat, ctypes.c_int32),
            _native.ptr(blen, ctypes.c_int32),
            _native.ptr(ish.view(np.uint8), ctypes.c_uint8),
            _native.ptr(new_ids, ctypes.c_int32), _native.ptr(new_spans),
            cap, ctypes.byref(err_i),
        )
        # mirror the new words BEFORE reporting a failure: the native
        # map already holds the words of the filters ahead of a too-deep
        # one, and the two dictionaries must never diverge
        for k in range(int(n_new)):
            o, ln = int(new_spans[2 * k]), int(new_spans[2 * k + 1])
            ids[blob[o:o + ln].decode()] = int(new_ids[k])
        if err_i.value >= 0:
            _fid, ws = items[int(err_i.value)]
            raise ValueError(
                f"filter deeper than max_levels={max_levels}: {ws}")

    def encode_topics_into(
        self, topics, levels: int,
        mat: np.ndarray, out_lens: np.ndarray, dollar: np.ndarray,
    ) -> None:
        """Encode topic names (strings) into the given arrays (row i =
        topic i) in one GIL-released call: get-only lookups (unknown
        words -> UNKNOWN_TOK), truncation at ``levels``, the ``$``
        flag — `dictionary.encode_topics` on each topic's words."""
        n = len(topics)
        _check(mat, (n, levels), np.int32)
        _check(out_lens, (n,), np.int32)
        _check(dollar, (n,), np.bool_)
        blob, starts, lens = _spans([t.encode() for t in topics])
        self._lib.td_encode_topics_into(
            self._h, blob, _native.ptr(starts), _native.ptr(lens), n,
            levels, _native.ptr(mat, ctypes.c_int32),
            _native.ptr(out_lens, ctypes.c_int32),
            _native.ptr(dollar.view(np.uint8), ctypes.c_uint8),
        )


def _check(a: np.ndarray, shape, dtype) -> None:
    if a.shape != shape or a.dtype != dtype or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(
            f"expected a C-contiguous {np.dtype(dtype)} array of shape "
            f"{shape}, got {a.dtype} {a.shape}")
