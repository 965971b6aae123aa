"""int64 argsort and unique+inverse in C++ (``native/sortutil.cpp``),
with the GIL released: the automaton build's sorts over its edge and
code arrays.  Results equal numpy's ``argsort(kind="stable")`` and
``unique(return_inverse=True)``."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import _native


def argsort_i64(arr: np.ndarray) -> np.ndarray:
    """Stable argsort of int64 keys."""
    lib = _native.load("sortutil")
    a = np.ascontiguousarray(arr, np.int64)
    out = np.empty(len(a), np.int64)
    lib.su_argsort_i64(_native.ptr(a), len(a), _native.ptr(out))
    return out


def unique_inverse_i64(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(arr, return_inverse=True)`` of int64 keys."""
    lib = _native.load("sortutil")
    a = np.ascontiguousarray(arr, np.int64)
    n = len(a)
    uniq = np.empty(n, np.int64)
    inv = np.empty(n, np.int64)
    scratch = np.empty(n, np.int64)
    m = lib.su_unique_inverse_i64(_native.ptr(a), n, _native.ptr(uniq),
                                  _native.ptr(inv), _native.ptr(scratch))
    return uniq[:m].copy(), inv


def sorts(native: bool):
    """``(argsort, unique_inverse)`` for int64 keys: the native pair, or
    numpy's (the referee) with ``native=False``."""
    if native:
        return argsort_i64, unique_inverse_i64
    return (lambda a: np.argsort(a, kind="stable"),
            lambda a: np.unique(a, return_inverse=True))
