"""Build and bind ``csrc/match_kernels.cu``.

At first use the source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``ops/build/`` (named by
a hash of the source and flags, so a stale library is never loaded),
and bound with ctypes.  Pointers and the stream pass as
``ctypes.c_void_p``; each entry point returns ``cudaGetLastError()``
and a non-zero code raises here.

The callers in `match_kernel.py` have checked dtypes, shapes, devices
and contiguity; this module checks what only the launch needs (a CUDA
device, 16-byte aligned table rows) and launches on the current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "match_kernels.cu")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info = {"seconds": None, "log": "", "path": None}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(
        BUILD_DIR, f"libmatch_kernels-{digest.hexdigest()[:16]}.so"
    )


def build() -> str:
    """Compile the kernels unless this source's library exists; returns
    its path.  Concurrent builds each write a private file and rename
    it into place."""
    path = library_path()
    if os.path.exists(path):
        build_info.update(seconds=0.0, path=path)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    build_info.update(seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr, path=path)
    return path


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.emqx_error_string.argtypes = [_I]
            lib.emqx_error_string.restype = ctypes.c_char_p
            lib.emqx_match_rows.argtypes = [
                _P, _I, _P, _I, ctypes.c_uint32, _P, _P, _P, _I, _I, _I,
                _I, _P, _P, _P, _P,
            ]
            lib.emqx_match_rows.restype = _I
            lib.emqx_compact.argtypes = [
                _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
            ]
            lib.emqx_compact.restype = _I
            lib.emqx_decide.argtypes = [_P] * 10 + [_I, _P, _P]
            lib.emqx_decide.restype = _I
            _lib = lib
        return _lib


def _ptr(t: torch.Tensor) -> _P:
    return _P(t.data_ptr())


def _stream(device: torch.device) -> _P:
    if device.type != "cuda":
        raise ValueError(f"CUDA kernels need CUDA tensors, got {device}")
    return _P(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.emqx_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def match_rows(fp_rows, node_rows, salt, tokens, lengths, dollar,
               f_width, m_cap, codes, counts, ovf) -> None:
    """Launch the frontier scan: dense codes, clipped counts, overflow."""
    dev = tokens.device
    stream = _stream(dev)
    for name, t in (("fp_rows", fp_rows), ("node_rows", node_rows)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = load()
    b, levels = tokens.shape
    with torch.cuda.device(dev):
        rc = lib.emqx_match_rows(
            _ptr(fp_rows), fp_rows.shape[0], _ptr(node_rows),
            node_rows.shape[0], salt, _ptr(tokens), _ptr(lengths),
            _ptr(dollar), b, levels, f_width, m_cap, _ptr(codes),
            _ptr(counts), _ptr(ovf), stream,
        )
    _raise_on(lib, rc, "match_rows")


def compact(codes, counts, ovf, m_cap, c_cap, row_start, total, flat,
            counts_out) -> None:
    """Launch the count scan and the scatter into the flat buffer."""
    dev = codes.device
    stream = _stream(dev)
    lib = load()
    with torch.cuda.device(dev):
        rc = lib.emqx_compact(
            _ptr(codes), _ptr(counts), _ptr(ovf), codes.shape[0], m_cap,
            c_cap, _ptr(row_start), _ptr(total), _ptr(flat),
            _ptr(counts_out), stream,
        )
    _raise_on(lib, rc, "compact")


def decide(oa_qos, oa_nl, oa_rap, oa_subid, opts_rows, client_rows,
           msg_idx, m_qos, m_retain, m_from_row, out) -> None:
    """Launch the per-delivery decide pass."""
    dev = opts_rows.device
    stream = _stream(dev)
    lib = load()
    cols = (oa_qos, oa_nl, oa_rap, oa_subid, opts_rows, client_rows,
            msg_idx, m_qos, m_retain, m_from_row)
    with torch.cuda.device(dev):
        rc = lib.emqx_decide(
            *(_ptr(t) for t in cols), opts_rows.shape[0], _ptr(out), stream,
        )
    _raise_on(lib, rc, "decide")
