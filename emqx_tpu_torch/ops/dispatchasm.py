"""ctypes binding for ``native/dispatchasm.cpp``: the GIL-released
PUBLISH splice of the dispatch fan-out.

One call splices a client run, or a whole window of runs — head span,
2-byte packet-id patch, tail span per delivery — out of the window
encoder's arena (`codec.mqtt.DispatchEncoder`) into one contiguous
wire buffer.  The wire equals what the per-delivery Python path
(`Session.deliver_decided`) sends."""

from __future__ import annotations

import ctypes

import numpy as np

from . import _native

I64P = _native.I64P


def load() -> ctypes.CDLL:
    return _native.load("dispatchasm")


def _out(out: bytearray):
    return (ctypes.c_uint8 * len(out)).from_buffer(out) if out else None


def assemble_run(views, body: np.ndarray, pid: np.ndarray,
                 out: bytearray) -> int:
    """Splice one run into ``out`` (sized by the caller).  ``views`` is
    the encoder's ``native_views()``; ``body`` the run's int64 arena
    slots and ``pid`` its packet ids (-1 = QoS 0, no packet id).
    Returns the bytes written."""
    arena, ho, hl, to, tl = views
    return load().da_assemble_run(
        arena, ho, hl, to, tl, _native.ptr(body), _native.ptr(pid),
        len(body), _out(out))


def assemble_window(views, body: np.ndarray, pid: np.ndarray,
                    run_start: np.ndarray, run_out_off: np.ndarray,
                    out: bytearray) -> int:
    """Splice a whole dispatch window — every client's run — into
    ``out`` with one call.  ``body``/``pid`` are the window-wide int64
    delivery columns; ``run_start`` indexes each run's first delivery
    and ``run_out_off`` its planned byte offset into ``out``.  Returns
    the bytes written, or a NEGATIVE -(j+1) when run ``j``'s bytes
    would not land at its planned offset (a span-table mismatch the
    caller must treat as a failed window, never as wire)."""
    for a in (body, pid, run_start, run_out_off):
        if a.dtype != np.int64 or not a.flags["C_CONTIGUOUS"]:
            raise ValueError("the splice plan takes C-contiguous int64 "
                             "columns")
    if len(body) != len(pid) or len(run_start) != len(run_out_off):
        raise ValueError("mismatched splice plan columns")
    arena, ho, hl, to, tl = views
    return load().da_assemble_window(
        arena, ho, hl, to, tl, _native.ptr(body), _native.ptr(pid),
        _native.ptr(run_start), _native.ptr(run_out_off),
        len(run_start), len(body), _out(out))
