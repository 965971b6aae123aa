"""Automaton tables and rule programs on the device.

`tables_from_reference` turns the arrays an automaton build produced
(numpy: ``fp_rows``, ``node_rows``, ``salt``, ``code_off``,
``code_idx``) into the port's tables: the two gather tables as
contiguous int32 tensors on ``device``, the salt as a Python int, and
the CSR fan-out kept on the host, where codes expand to filter
positions.  The port's own build (`ops.automaton`) produces the same
arrays as the JAX package's, so the same function serves tables built
by either package.

`sharded_tables_from_reference` places the stacked tables of a sharded
index (``ShardedIndex.tables`` of either package) on a mesh
(`parallel.sharded.Mesh`): each device gets the slices of the shards
of its block stacked there, as `ops.match_kernel.sharded_match_local`
takes them.  Both upload through `put_arrays`, which the engines' fold
and builder threads give a side stream of the card (`UploadStreams`).

`rules_program_from_reference` and `columns_from_reference` do the same
for the rule engine: a stacked WHERE program (`StackedRules` arrays of
either package) and one window's column planes (`WindowColumns`
arrays) become the tensors `ops.match_kernel.rules_eval_batch` takes.
`rules_lowered_from_reference` puts a stacked program, lowered once
(per rules rev) by `ops.rules_lowering`, on the device for the K4
kernel (`ops.match_kernel.rules_eval_lowered`).  `HostStage` packs one call's
host arrays into a buffer it keeps (pinned for a card) and puts them on
the device in one copy.
`predicate_program_from_code` and `predicate_columns_from_reference`
do it for one rule's predicate (K6): its register program and the
columns `PredicateProgram.extract_columns` pulls (a dict of either
package's, with `_literal_ids`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.automaton import BUCKET
from .ops.rules_lowering import LoweredRules, lower_rules, rules_arrays
from .rules import predicate as P


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


class UploadStreams:
    """One side stream per card for table uploads made off the window
    path (the engines' builder and fold threads), so that a large
    upload does not queue in front of the next window's launch on the
    default stream."""

    def __init__(self) -> None:
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def get(self, device: torch.device) -> Optional["torch.cuda.Stream"]:
        if device.type != "cuda":
            return None
        s = self._streams.get(device)
        if s is None:
            s = self._streams.setdefault(device, torch.cuda.Stream(device))
        return s


def put_arrays(arrays: Sequence[np.ndarray], device: torch.device,
               stream=None) -> List[torch.Tensor]:
    """``arrays`` (C-contiguous numpy) as tensors on ``device``.  With a
    side ``stream`` on a card: packed into one pinned staging buffer,
    copied up on that stream, each tensor recorded on the card's default
    stream (where windows read it, so that the caching allocator hands
    its blocks out again only after the last window that read them) and
    the stream synchronised before returning, so a caller may publish
    the tensors to any thread.  Without a stream: a plain copy on the
    current stream; on the CPU the tensors share the arrays' memory."""
    if device.type != "cuda" or stream is None:
        return [torch.from_numpy(a).to(device) for a in arrays]
    offs, size = [], 0
    for a in arrays:
        offs.append(size)
        size += -(-a.nbytes // 256) * 256
    host = torch.empty(max(size, 1), dtype=torch.uint8, pin_memory=True)
    hbuf = host.numpy()
    for a, o in zip(arrays, offs):
        hbuf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    consumer = torch.cuda.default_stream(device)
    out = []
    with torch.cuda.device(device), torch.cuda.stream(stream):
        for a, o in zip(arrays, offs):
            src = host[o:o + a.nbytes].view(_TORCH_DTYPE[a.dtype]).view(
                a.shape)
            t = torch.empty(a.shape, dtype=src.dtype, device=device)
            t.copy_(src, non_blocking=True)
            t.record_stream(consumer)
            out.append(t)
    stream.synchronize()
    return out


def tables_from_reference(fp_rows, node_rows, salt, code_off, code_idx,
                          device, stream=None) -> DeviceTables:
    """``stream``: a side stream for the upload (`put_arrays`)."""
    fp = np.ascontiguousarray(fp_rows, dtype=np.int32)
    nodes = np.ascontiguousarray(node_rows, dtype=np.int32)
    nb = fp.shape[0]
    if fp.ndim != 2 or fp.shape[1] != 2 * BUCKET or nb < 1 or nb & (nb - 1):
        raise ValueError(f"fp_rows must be [power of two, {2 * BUCKET}]")
    if nodes.ndim != 2 or nodes.shape[1] != 8 or nodes.shape[0] < 1:
        raise ValueError("node_rows must be [N>=1, 8]")
    dev = resolve_device(device)
    fp_t, nodes_t = put_arrays((fp, nodes), dev, stream)
    return DeviceTables(
        fp_rows=fp_t,
        node_rows=nodes_t,
        salt=int(salt),
        code_off=np.asarray(code_off),
        code_idx=np.asarray(code_idx),
    )


class ShardedTables(NamedTuple):
    """Per device of a mesh, the stacked slices of the shards of its
    block (`Mesh.blocks`) on that device."""

    fp_rows: Dict[torch.device, torch.Tensor]  # [k, nb, 2*BUCKET] int32
    node_rows: Dict[torch.device, torch.Tensor]  # [k, N, 8] int32
    salts: Dict[torch.device, torch.Tensor]  # [k] uint32


def sharded_tables_from_reference(fp_rows, node_rows, salts,
                                  mesh, streams=None) -> ShardedTables:
    """Place stacked shard tables (``fp_rows [K, nb, 2*BUCKET]``,
    ``node_rows [K, N, 8]``, ``salts [K]`` uint32) on ``mesh``: each
    device gets the shards of its block, stacked.  ``streams`` (an
    `UploadStreams`) uploads each card's share on that card's side
    stream (`put_arrays`)."""
    fp = np.ascontiguousarray(fp_rows, dtype=np.int32)
    nodes = np.ascontiguousarray(node_rows, dtype=np.int32)
    sl = np.asarray(salts)
    if sl.ndim != 1 or ((sl < 0) | (sl > 0xFFFFFFFF)).any():
        raise ValueError("salts must be [K] uint32 values")
    sl = sl.astype(np.uint32)
    k = mesh.shape["sub"]
    nb = fp.shape[1] if fp.ndim == 3 else 0
    if fp.shape[:1] != (k,) or fp.ndim != 3 or fp.shape[2] != 2 * BUCKET \
            or nb < 1 or nb & (nb - 1):
        raise ValueError(f"fp_rows must be [{k}, power of two, "
                         f"{2 * BUCKET}], got {fp.shape}")
    if nodes.ndim != 3 or nodes.shape[0] != k or nodes.shape[2] != 8 \
            or nodes.shape[1] < 1:
        raise ValueError(f"node_rows must be [{k}, N>=1, 8], got "
                         f"{nodes.shape}")
    if sl.shape != (k,):
        raise ValueError(f"salts must be [{k}], got {sl.shape}")
    out = ShardedTables({}, {}, {})
    for dev, shards, _ in mesh.blocks:
        out.fp_rows[dev], out.node_rows[dev], out.salts[dev] = put_arrays(
            [np.ascontiguousarray(a[shards]) for a in (fp, nodes, sl)],
            dev, None if streams is None else streams.get(dev))
    return out


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
    arrays = rules_arrays(code, a0, a1, a2, a3, litn, last)
    dev = resolve_device(device)
    return RulesProgram(*(torch.from_numpy(a).to(dev) for a in arrays))


def rules_lowered_from_reference(code, a0, a1, a2, a3, litn, last, device,
                                 n_lits: Optional[int] = None
                                 ) -> LoweredRules:
    """A stacked WHERE program lowered into K4's step records
    (`ops.rules_lowering.lower_rules`, which raises ValueError for a
    program the kernel could not run unchecked) on ``device``."""
    return lower_rules(code, a0, a1, a2, a3, litn, last,
                       resolve_device(device), n_lits)


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


class PredicateColumns(NamedTuple):
    num: torch.Tensor  # [V, W] float64, NaN = not a number
    sid: torch.Tensor  # [V, W] int32 batch string id, -1 = not a string
    err: torch.Tensor  # [V, W] bool lookup raised
    lit_ids: torch.Tensor  # [L] int32 literal ids, -2 = not in the batch
    names: Tuple[str, ...]  # var lanes, in the columns' order
    lits: Tuple[str, ...]  # string literals, sorted


def predicate_columns_from_reference(cols, lit_ids,
                                     device) -> PredicateColumns:
    """One predicate's columns on ``device``: ``cols`` is a
    ``PredicateProgram.extract_columns`` dict (``n:``/``s:``/``e:``
    lanes per var, in var order) and ``lit_ids`` its `_literal_ids`."""
    names = tuple(k[2:] for k in cols if k.startswith("n:"))
    if not names:
        raise ValueError("a predicate's columns need at least one var")
    num = np.stack([np.asarray(cols["n:" + n], np.float64) for n in names])
    sid = np.stack([np.asarray(cols["s:" + n], np.int32) for n in names])
    err = np.stack([np.asarray(cols["e:" + n], bool) for n in names])
    lits = tuple(sorted(lit_ids))
    ids = np.array([lit_ids[s] for s in lits], np.int32)
    dev = resolve_device(device)
    return PredicateColumns(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (num, sid, err, ids)),
        names, lits,
    )


class PredicateDeviceCode(NamedTuple):
    steps: torch.Tensor  # [S, 8] int32
    lit: torch.Tensor  # [S] float64
    result: int
    slots: int  # numeric registers the program names (K6's instance)


def predicate_program_from_code(code, device) -> PredicateDeviceCode:
    """A `rules.predicate.PredicateCode` on ``device``.  Checks what
    the kernel relies on, since it clamps nothing: known opcodes,
    registers inside the file, var lanes and literal indices inside
    their tables; and counts the numeric registers the program names,
    which pick the kernel's instance."""
    steps = np.ascontiguousarray(code.steps, dtype=np.int32)
    lit = np.ascontiguousarray(code.lit, dtype=np.float64)
    if steps.ndim != 2 or steps.shape[1] != 8 or len(steps) < 1 \
            or lit.shape != (len(steps),):
        raise ValueError("steps must be [S>=1, 8] with a [S] literal row")
    op, v = steps[:, 0], len(code.names)
    if op.min() < P.P_NLOAD or op.max() > P.P_EQS:
        raise ValueError("unknown opcode in steps")
    two = (P.P_NADD, P.P_NSUB, P.P_NMUL, P.P_NDIV, P.P_NIDV, P.P_NMOD,
           P.P_BAND, P.P_BOR, P.P_CGT, P.P_CLT, P.P_CGE, P.P_CLE, P.P_EQN)
    regs = np.concatenate([
        steps[:, 1], [code.result],
        steps[np.isin(op, two + (P.P_NNEG, P.P_BNOT)), 2],
        steps[np.isin(op, two), 3],
    ])
    if ((regs < 0) | (regs >= P.PRED_REGS)).any():
        raise ValueError(f"registers must be in [0, {P.PRED_REGS})")
    eqn = steps[op == P.P_EQN]
    lanes = steps[np.isin(op, (P.P_NLOAD, P.P_EQS)), 2]
    if ((lanes < 0) | (lanes >= v)).any() or (
            (eqn[:, 4:6] < -1) | (eqn[:, 4:6] >= v)).any():
        raise ValueError(f"var lanes must be in [0, {v})")
    li = steps[op == P.P_EQS, 3]
    if ((li < 0) | (li >= len(code.lits))).any():
        raise ValueError("string-literal index outside the literal table")
    dev = resolve_device(device)
    return PredicateDeviceCode(torch.from_numpy(steps).to(dev),
                               torch.from_numpy(lit).to(dev),
                               int(code.result), P.numeric_slots(steps))


_TORCH_DTYPE = {np.dtype(d): t for d, t in (
    (np.float64, torch.float64), (np.int32, torch.int32),
    (np.int8, torch.int8), (np.uint8, torch.uint8), (np.bool_, torch.bool),
    (np.uint32, torch.uint32),
)}


class HostStage:
    """A call's host arrays, packed at 16 B aligned offsets into one
    buffer that this object keeps and grows (pinned when ``device`` is a
    card), go up in one copy into a device buffer it also keeps; results
    come down into pinned memory with one synchronise.  The views of a
    layout are made once and reused while calls repeat it, so the
    arrays `upload` returns on a card are overwritten by the next call's
    upload (in stream order).  Not thread-safe: a caller holds its own
    lock from `views` until `download` has returned."""

    ALIGN = 16

    def __init__(self, device) -> None:
        self.device = resolve_device(device)
        self._host: Optional[torch.Tensor] = None
        self._dev: Optional[torch.Tensor] = None
        self._specs: Optional[List] = None
        self._size = 0
        self._host_views: List[np.ndarray] = []
        self._dev_views: List[torch.Tensor] = []

    def views(self, specs: Sequence[Tuple[type, Tuple[int, ...]]]
              ) -> List[np.ndarray]:
        """Host arrays of these ``(dtype, shape)``s in the buffer, for
        the caller to fill before `upload`."""
        specs = list(specs)
        if specs == self._specs:
            return self._host_views
        layout, size = [], 0
        for dtype, shape in specs:
            dt = np.dtype(dtype)
            n = int(np.prod(shape)) * dt.itemsize
            layout.append((size, n, dt, tuple(shape)))
            size += -(-n // self.ALIGN) * self.ALIGN
        card = self.device.type == "cuda"
        if self._host is None or self._host.numel() < size:
            cap = max(size, 2 * (0 if self._host is None
                                 else self._host.numel()), 4096)
            self._host = torch.empty(cap, dtype=torch.uint8, pin_memory=card)
            self._dev = (torch.empty(cap, dtype=torch.uint8,
                                     device=self.device) if card else None)
        buf = self._host.numpy()
        self._host_views = [buf[o:o + n].view(dt).reshape(sh)
                            for o, n, dt, sh in layout]
        self._dev_views = [self._dev[o:o + n].view(_TORCH_DTYPE[dt]).view(sh)
                           for o, n, dt, sh in layout] if card else []
        self._specs, self._size = specs, size
        return self._host_views

    def upload(self) -> List[torch.Tensor]:
        """The arrays of the last `views`, on the device: one copy (on
        the CPU, fresh tensors)."""
        if self.device.type != "cuda":
            return [torch.from_numpy(a.copy()) for a in self._host_views]
        self._dev[:self._size].copy_(self._host[:self._size],
                                     non_blocking=True)
        return self._dev_views

    def download(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """``tensors`` on the host, each copied into pinned memory of
        its own, after one synchronise."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
               for t in tensors]
        for h, t in zip(out, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in out]
