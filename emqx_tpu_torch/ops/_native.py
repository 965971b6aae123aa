"""Build and bind the host-side C++ helpers in ``emqx_tpu_torch/native``.

Four libraries, each from one source with a plain C interface:

  ``hosttrie``     the wildcard-filter trie (`trie_native.NativeTrie`)
  ``tokdict``      the token dictionary's batch encoder
                   (`tokdict_native.NativeEncoder`)
  ``sortutil``     int64 argsort and unique+inverse (`sortutil_native`)
  ``dispatchasm``  the PUBLISH splice of a dispatch window (`dispatchasm`)

and, outside ``NAMES`` (the engine's set, which `load_all` builds), the
durable store's segment log ``dslog`` (`ds.native.DsLog`), built when a
store first opens.

At first use a library is compiled with ``g++ -O3 -fPIC -shared
-std=c++17 -Wall`` into ``ops/build/``, under a name that carries a
hash of the compiler, its flags and the source (a stale library is
never loaded), with the compiler's output beside it in
``<library>.log``, and bound with ctypes.  A build works in a private
directory and renames the library into place, so concurrent builds are
safe.

There is no fallback: a library that does not build or load raises
`RuntimeError`.  The Python versions (`trie_host.HostTrie`,
`dictionary.encode_topics`, numpy's sorts, the per-delivery
`Session.deliver_decided` loop) are reached only through an explicit
``native=False``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(os.path.dirname(_HERE), "native")
BUILD_DIR = os.path.join(_HERE, "build")
NAMES = ("hosttrie", "tokdict", "sortutil", "dispatchasm")
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": compile seconds (0.0 when cached), "log": the
# compiler's output, "path": the library}
build_info: Dict[str, dict] = {}

_V = ctypes.c_void_p
_CP = ctypes.c_char_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
I64P = ctypes.POINTER(ctypes.c_int64)
I32P = ctypes.POINTER(ctypes.c_int32)
U8P = ctypes.POINTER(ctypes.c_uint8)

# name -> {function: (restype, argtypes)}
SIGNATURES = {
    "hosttrie": {
        "ht_new": (_V, []),
        "ht_free": (None, [_V]),
        "ht_len": (_I64, [_V]),
        "ht_insert": (_I64, [_V, _CP, _I64]),
        "ht_insert_batch": (None, [_V, _CP, I64P, I64P, I64P, _I64, I64P]),
        "ht_seq": (_I64, [_V]),
        "ht_delete": (_I32, [_V, _I64]),
        "ht_match": (_I64, [_V, _CP, I64P, _I64]),
        "ht_match_since": (_I64, [_V, _CP, _I64, I64P, _I64]),
    },
    "tokdict": {
        "td_new": (_V, []),
        "td_free": (None, [_V]),
        "td_len": (_I64, [_V]),
        "td_add": (_I32, [_V, _CP, _I64]),
        "td_get": (_I32, [_V, _CP, _I64]),
        "td_seed": (None, [_V, _CP, I64P, I64P, _I64]),
        "td_encode_topics_into": (
            None, [_V, _CP, I64P, I64P, _I64, _I32, I32P, I32P, U8P]),
        "td_encode_filters": (
            _I64, [_V, _CP, I64P, I64P, _I64, _I32, I32P, I32P, U8P, I32P,
                   I64P, _I64, I64P]),
    },
    "sortutil": {
        "su_argsort_i64": (None, [I64P, _I64, I64P]),
        "su_unique_inverse_i64": (_I64, [I64P, _I64, I64P, I64P, I64P]),
    },
    "dslog": {
        "dslog_open": (_V, [_CP, ctypes.c_uint64]),
        "dslog_close": (None, [_V]),
        "dslog_append": (_I64, [_V, ctypes.c_uint32, ctypes.c_uint64, _CP,
                                ctypes.c_uint32]),
        "dslog_sync": (ctypes.c_int, [_V]),
        "dslog_streams": (ctypes.c_int, [_V, ctypes.POINTER(ctypes.c_uint32),
                                         ctypes.c_int]),
        "dslog_iter_new": (_V, [_V, ctypes.c_uint32, ctypes.c_uint64]),
        "dslog_iter_free": (None, [_V]),
        "dslog_iter_next": (_I64, [_V, _CP, ctypes.c_uint32,
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.POINTER(ctypes.c_uint64)]),
        "dslog_stream_count": (_I64, [_V, ctypes.c_uint32]),
        "dslog_corrupt_records": (_I64, [_V]),
        "dslog_quarantined_count": (ctypes.c_int, [_V]),
        "dslog_gc": (_I64, [_V, ctypes.c_uint64]),
        "dslog_gc2": (_I64, [_V, ctypes.c_uint64, ctypes.c_uint32]),
        "dslog_seg_for": (_I64, [_V, ctypes.c_uint32, ctypes.c_uint64,
                                 ctypes.c_uint64]),
        "dslog_cur_seg": (_I64, [_V]),
    },
    "dispatchasm": {
        "da_assemble_run": (
            _I64, [U8P, I64P, I64P, I64P, I64P, I64P, I64P, _I64, U8P]),
        "da_assemble_window": (
            _I64, [U8P, I64P, I64P, I64P, I64P, I64P, I64P, I64P, I64P,
                   _I64, _I64, U8P]),
    },
}


def source_path(name: str) -> str:
    return os.path.join(SOURCE_DIR, f"{name}.cpp")


def library_path(name: str) -> str:
    digest = hashlib.sha256("\0".join([CXX, *CXX_FLAGS]).encode())
    with open(source_path(name), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(*names: str) -> Dict[str, str]:
    """Compile every named library whose build does not exist yet, one
    compiler process each, all started together; returns name -> path.
    Raises RuntimeError, with the compiler's output, if any fails."""
    paths = {n: library_path(n) for n in names or NAMES}
    todo = [n for n, p in paths.items() if not os.path.exists(p)]
    for n, p in paths.items():
        if n not in todo and build_info.get(n, {}).get("path") != p:
            log = ""
            if os.path.exists(p + ".log"):
                with open(p + ".log") as f:
                    log = f.read()
            build_info[n] = {"seconds": 0.0, "log": log, "path": p}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        for n in todo:
            out = os.path.join(tmp, f"lib{n}.so")
            try:
                procs[n] = (out, subprocess.Popen(
                    [CXX, *CXX_FLAGS, "-o", out, source_path(n)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            except OSError as exc:
                raise RuntimeError(
                    f"cannot run the C++ compiler {CXX!r} for native "
                    f"library {n}: {exc}") from exc
        failed = []
        logs = {}
        for n, (out, proc) in procs.items():
            logs[n] = proc.communicate()[0]
            if proc.returncode != 0 or not os.path.exists(out):
                failed.append(n)
        if failed:
            raise RuntimeError("native library build failed: " + "; ".join(
                f"{n} ({CXX} exit {procs[n][1].returncode}): {logs[n]}"
                for n in failed))
        secs = time.perf_counter() - t0
        for n, (out, _proc) in procs.items():
            with open(out + ".log", "w") as f:
                f.write(logs[n])
            os.replace(out + ".log", paths[n] + ".log")
            os.replace(out, paths[n])
            build_info[n] = {"seconds": secs, "log": logs[n],
                             "path": paths[n]}
    return paths


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            try:
                lib = ctypes.CDLL(build(name)[name])
            except OSError as exc:
                raise RuntimeError(
                    f"native library {name} does not load: {exc}") from exc
            for fn, (res, args) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = res
                f.argtypes = args
            _libs[name] = lib
    return lib


def load_all() -> None:
    """Build (in parallel) and bind every library; raises on a failure."""
    with _lock:
        missing = [n for n in NAMES if n not in _libs]
        if missing:
            build(*missing)
    for n in NAMES:
        load(n)


def ptr(arr, ctype=ctypes.c_int64):
    """A ctypes pointer to a contiguous numpy array's data."""
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
