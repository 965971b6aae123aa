"""Automaton tables and rule programs on the device.

`tables_from_reference` turns the arrays an automaton build produced
(numpy: ``fp_rows``, ``node_rows``, ``salt``, ``code_off``,
``code_idx``) into the port's tables: the two gather tables as
contiguous int32 tensors on ``device``, the salt as a Python int, and
the CSR fan-out kept on the host, where codes expand to filter
positions.  The port's own build (`ops.automaton`) produces the same
arrays as the JAX package's, so the same function serves tables built
by either package.

`rules_program_from_reference` and `columns_from_reference` do the same
for the rule engine: a stacked WHERE program (`StackedRules` arrays of
either package) and one window's column planes (`WindowColumns`
arrays) become the tensors `ops.match_kernel.rules_eval_batch` takes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops.automaton import BUCKET
from .rules.predicate import MAX_STEPS, R_PRES


class DeviceTables(NamedTuple):
    fp_rows: torch.Tensor  # [nb, 2*BUCKET] int32, nb a power of two
    node_rows: torch.Tensor  # [N, 8] int32
    salt: int  # uint32 hash salt
    code_off: np.ndarray  # [2*N' + 1] CSR offsets by match code
    code_idx: np.ndarray  # [n_filters] filter positions


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a usable
    card raises: the port never drops to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def tables_from_reference(fp_rows, node_rows, salt, code_off, code_idx,
                          device) -> DeviceTables:
    fp = np.ascontiguousarray(fp_rows, dtype=np.int32)
    nodes = np.ascontiguousarray(node_rows, dtype=np.int32)
    nb = fp.shape[0]
    if fp.ndim != 2 or fp.shape[1] != 2 * BUCKET or nb < 1 or nb & (nb - 1):
        raise ValueError(f"fp_rows must be [power of two, {2 * BUCKET}]")
    if nodes.ndim != 2 or nodes.shape[1] != 8 or nodes.shape[0] < 1:
        raise ValueError("node_rows must be [N>=1, 8]")
    dev = resolve_device(device)
    return DeviceTables(
        fp_rows=torch.from_numpy(fp).to(dev),
        node_rows=torch.from_numpy(nodes).to(dev),
        salt=int(salt),
        code_off=np.asarray(code_off),
        code_idx=np.asarray(code_idx),
    )


class RulesProgram(NamedTuple):
    code: torch.Tensor  # [R, S] int32 opcodes
    a0: torch.Tensor  # [R, S] int32 operands
    a1: torch.Tensor
    a2: torch.Tensor
    a3: torch.Tensor
    litn: torch.Tensor  # [R, S] float64 numeric literals
    last: torch.Tensor  # [R] int32 result register


class WindowPlanes(NamedTuple):
    num: torch.Tensor  # [P, W] float64, NaN = not a number
    sid: torch.Tensor  # [P, W] int32 string rank / reserved ids
    err: torch.Tensor  # [P, W] bool lookup raised
    prs: torch.Tensor  # [P, W] bool present and not null
    lit_ranks: torch.Tensor  # [L] int32


def rules_program_from_reference(code, a0, a1, a2, a3, litn, last,
                                 device) -> RulesProgram:
    """A stacked WHERE program on ``device``.  Checks what the kernel
    relies on: ``1 <= S <= MAX_STEPS``, known opcodes, and each rule's
    result register inside its row."""
    ops = [np.ascontiguousarray(a, dtype=np.int32)
           for a in (code, a0, a1, a2, a3)]
    lit = np.ascontiguousarray(litn, dtype=np.float64)
    res = np.ascontiguousarray(last, dtype=np.int32)
    shape = ops[0].shape
    if len(shape) != 2 or any(a.shape != shape for a in (*ops, lit)):
        raise ValueError("code, a0..a3 and litn must share one [R, S] shape")
    r, s = shape
    if not 1 <= s <= MAX_STEPS:
        raise ValueError(f"programs must have 1..{MAX_STEPS} steps, got {s}")
    if res.shape != (r,):
        raise ValueError(f"last must be [{r}], got {res.shape}")
    if r and (ops[0].min() < 0 or ops[0].max() > R_PRES):
        raise ValueError("unknown opcode in code")
    if r and (res.min() < 0 or res.max() >= s):
        raise ValueError(f"last must index a step in [0, {s})")
    dev = resolve_device(device)
    return RulesProgram(
        *(torch.from_numpy(a).to(dev) for a in ops),
        torch.from_numpy(lit).to(dev), torch.from_numpy(res).to(dev),
    )


def columns_from_reference(num, sid, err, prs, lit_ranks,
                           device) -> WindowPlanes:
    """One window's column planes on ``device``."""
    n = np.ascontiguousarray(num, dtype=np.float64)
    planes = (
        n,
        np.ascontiguousarray(sid, dtype=np.int32),
        np.ascontiguousarray(err, dtype=bool),
        np.ascontiguousarray(prs, dtype=bool),
    )
    if n.ndim != 2 or any(a.shape != n.shape for a in planes):
        raise ValueError("num, sid, err and prs must share one [P, W] shape")
    dev = resolve_device(device)
    return WindowPlanes(
        *(torch.from_numpy(a).to(dev) for a in planes),
        torch.from_numpy(
            np.ascontiguousarray(lit_ranks, dtype=np.int32)).to(dev),
    )
