"""Build and bind the CUDA sources in ``csrc/`` (every ``*.cu``).

At first use each source is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and the objects are linked
into one shared library with a plain C interface, under ``ops/build/``
(named by a hash of the sources and flags, so a stale library is never
loaded, with the compiler's output beside it in ``<library>.log``), and
bound with ctypes.  Pointers and the stream pass as
``ctypes.c_void_p``; each entry point returns ``cudaGetLastError()``
and a non-zero code raises here.

The callers in `match_kernel.py` have checked dtypes, shapes, devices
and contiguity; this module checks what only the launch needs (a CUDA
device, 16-byte aligned table rows) and launches on the current stream.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = sorted(glob.glob(os.path.join(_HERE, "csrc", "*.cu")))
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(
        BUILD_DIR, f"libemqx_kernels-{digest.hexdigest()[:16]}.so"
    )


def build() -> str:
    """Compile the kernels unless these sources' library exists;
    returns its path.  Each build works in a private directory and
    renames the library into place, so concurrent builds are safe."""
    path = library_path()
    if os.path.exists(path):
        log = ""
        if os.path.exists(path + ".log"):
            with open(path + ".log") as f:
                log = f.read()
        build_info.update(seconds=0.0, log=log, path=path)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                for s in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)
        ]
        log = "".join(f"== {os.path.basename(s)}\n{p.communicate()[0]}"
                      for s, p in zip(SOURCES, procs))
        lib = os.path.join(tmp, "lib.so")
        ok = all(p.returncode == 0 for p in procs)
        if ok:
            link = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log += f"== link\n{link.stdout}"
            ok = link.returncode == 0
        if not ok:
            raise RuntimeError(f"nvcc failed:\n{log}")
        with open(os.path.join(tmp, "log"), "w") as f:
            f.write(log)
        os.replace(os.path.join(tmp, "log"), path + ".log")
        os.replace(lib, path)
    build_info.update(seconds=time.perf_counter() - t0, log=log, path=path)
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
            lib.emqx_match_compact_scratch.argtypes = [_I, _I, _I, _I]
            lib.emqx_match_compact_scratch.restype = ctypes.c_longlong
            lib.emqx_match_compact.argtypes = [
                _P, _I, _P, _I, ctypes.c_uint32, _P, _P, _P, _I, _I, _I,
                _I, _I, _P, _P, _P, _P, ctypes.c_longlong, _P,
            ]
            lib.emqx_match_compact.restype = _I
            lib.emqx_decide.argtypes = [
                _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
            ]
            lib.emqx_decide.restype = _I
            lib.emqx_rules_eval.argtypes = [
                _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P,
            ]
            lib.emqx_rules_eval.restype = _I
            lib.emqx_sharded_match_rows.argtypes = [
                _P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                _P, _P, _P,
            ]
            lib.emqx_sharded_match_rows.restype = _I
            lib.emqx_predicate_eval.argtypes = [
                _P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P,
            ]
            lib.emqx_predicate_eval.restype = _I
            _lib = lib
        return _lib


def _ptr(t: torch.Tensor) -> _P:
    return _P(t.data_ptr())


def _stream(device: torch.device) -> _P:
    if device.type != "cuda":
        raise ValueError(f"CUDA kernels need CUDA tensors, got {device}")
    return _P(torch.cuda.current_stream(device).cuda_stream)


def _on(device: torch.device):
    """Makes ``device`` the current card for a launch (nothing to do
    when it already is)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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
    with _on(dev):
        rc = lib.emqx_match_rows(
            _ptr(fp_rows), fp_rows.shape[0], _ptr(node_rows),
            node_rows.shape[0], salt, _ptr(tokens), _ptr(lengths),
            _ptr(dollar), b, levels, f_width, m_cap, _ptr(codes),
            _ptr(counts), _ptr(ovf), stream,
        )
    _raise_on(lib, rc, "match_rows")


def compact_scratch_words(n_rows, levels, f_width, m_cap) -> int:
    """The int64 words of the look-back scratch `match_compact` needs
    for this batch; raises when a block's staged codes cannot fit the
    card's shared memory (a topic depth far past any automaton's)."""
    words = load().emqx_match_compact_scratch(n_rows, levels, f_width,
                                              m_cap)
    if words < 0:
        raise ValueError(
            f"no compact match shape for B={n_rows}, L={levels}, "
            f"F={f_width}, M={m_cap}")
    return words


def match_compact(fp_rows, node_rows, salt, tokens, lengths, dollar,
                  f_width, m_cap, c_cap, flat, counts_out, total,
                  scratch) -> None:
    """Launch the one-pass compact scan: flat codes (-1 filled past the
    total), int16 counts (negative on overflow) and the total.  The
    entry point fills ``flat`` and zeroes ``scratch`` (int64, at least
    `compact_scratch_words`) before the launch, so both may be reused."""
    dev = tokens.device
    stream = _stream(dev)
    for name, t in (("fp_rows", fp_rows), ("node_rows", node_rows)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = load()
    b, levels = tokens.shape
    with _on(dev):
        rc = lib.emqx_match_compact(
            _ptr(fp_rows), fp_rows.shape[0], _ptr(node_rows),
            node_rows.shape[0], salt, _ptr(tokens), _ptr(lengths),
            _ptr(dollar), b, levels, f_width, m_cap, c_cap, _ptr(flat),
            _ptr(counts_out), _ptr(total), _ptr(scratch), scratch.numel(),
            stream,
        )
    _raise_on(lib, rc, "match_compact")


def decide(oa, opts_rows, client_rows, msg_idx, m_qos, m_retain,
           m_from_row, out, error) -> None:
    """Launch the per-delivery decide pass.  The entry point zeroes
    ``error`` (int32 [1]) first; the kernel sets it when a delivery
    indexes outside the opts or message columns."""
    dev = opts_rows.device
    stream = _stream(dev)
    lib = load()
    with _on(dev):
        rc = lib.emqx_decide(
            _ptr(oa), oa.shape[0], _ptr(opts_rows), _ptr(client_rows),
            _ptr(msg_idx), _ptr(m_qos), _ptr(m_retain), _ptr(m_from_row),
            m_qos.shape[0], opts_rows.shape[0], _ptr(out), _ptr(error),
            stream,
        )
    _raise_on(lib, rc, "decide")


def rules_eval(steps, lits, meta, lit_ranks, num, sid, err, prs,
               out) -> None:
    """Launch the rules x window program (``out`` is ``[R, W]``, one
    byte per cell) over the lowered step records."""
    dev = num.device
    stream = _stream(dev)
    if steps.data_ptr() % 16:
        raise ValueError("steps must be 16-byte aligned")
    lib = load()
    n_rules, n_steps, _ = steps.shape
    n_planes, w_n = num.shape
    with _on(dev):
        rc = lib.emqx_rules_eval(
            _ptr(steps), _ptr(lits), _ptr(meta), n_rules, n_steps,
            lits.shape[1], _ptr(lit_ranks), _ptr(num), _ptr(sid), _ptr(err),
            _ptr(prs), n_planes, w_n, _ptr(out), stream,
        )
    _raise_on(lib, rc, "rules_eval")


def sharded_match_rows(fp_rows, node_rows, salts, tokens, lengths, dollar,
                       f_width, m_cap, codes, counts, ovf, total) -> None:
    """Launch the sharded frontier scan: a (row, shard) grid over the
    stacked tables, dense codes per shard, and the count total summed
    into ``total`` (which the caller zeroed)."""
    dev = tokens.device
    stream = _stream(dev)
    for name, t in (("fp_rows", fp_rows), ("node_rows", node_rows)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = load()
    k, nb, _ = fp_rows.shape
    b, levels = tokens.shape
    with _on(dev):
        rc = lib.emqx_sharded_match_rows(
            _ptr(fp_rows), nb, _ptr(node_rows), node_rows.shape[1],
            _ptr(salts), k, _ptr(tokens), _ptr(lengths), _ptr(dollar), b,
            levels, f_width, m_cap, _ptr(codes), _ptr(counts), _ptr(ovf),
            _ptr(total), stream,
        )
    _raise_on(lib, rc, "sharded_match_rows")


def predicate_eval(steps, lit, result, num, sid, err, lit_ids, slots,
                   out) -> None:
    """Launch one rule's predicate program over a batch (``out`` is
    ``[W]``, one byte per message) on the smallest instance that holds
    ``slots`` numeric registers."""
    dev = num.device
    stream = _stream(dev)
    lib = load()
    n_vars, w_n = num.shape
    with _on(dev):
        rc = lib.emqx_predicate_eval(
            _ptr(steps), _ptr(lit), steps.shape[0], result, _ptr(num),
            _ptr(sid), _ptr(err), n_vars, _ptr(lit_ids), lit_ids.shape[0],
            w_n, slots, _ptr(out), stream,
        )
    _raise_on(lib, rc, "predicate_eval")
