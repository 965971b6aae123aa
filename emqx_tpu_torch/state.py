"""Automaton tables on the device.

`tables_from_reference` turns the arrays an automaton build produced
(numpy: ``fp_rows``, ``node_rows``, ``salt``, ``code_off``,
``code_idx``) into the port's tables: the two gather tables as
contiguous int32 tensors on ``device``, the salt as a Python int, and
the CSR fan-out kept on the host, where codes expand to filter
positions.  The port's own build (`ops.automaton`) produces the same
arrays as the JAX package's, so the same function serves tables built
by either package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops.automaton import BUCKET


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
