"""Sharding of the subscription index over a grid of devices.

A port of the JAX package's ``parallel/sharded.py``.  The filter set is
partitioned over the devices:

  * mesh axis ``sub`` — each position holds one shard of the wildcard
    automaton (the shards' tables share one geometry and are stacked on
    a leading axis); a publish batch is matched against every shard and
    the union of the shards' results is the route set;
  * mesh axis ``pub`` — the publish batch itself is split into equal
    slices, one per column.

A mesh here is a ``(sub, pub)`` grid of ``torch.device``s, and one
device may fill several positions: ``make_mesh(devices=[cuda:0] * 4,
sub=4)`` holds a 4-shard index on one card, as the JAX package's tests
hold one on a virtual 8-device CPU mesh.  Each device fills one block
of adjacent shards and batch columns (`Mesh`).  `sharded_match`
launches `ops.match_kernel.sharded_match_local` (K5) once per device,
over the shards and the batch slice of its block, and adds the
per-device partial counts: the JAX package's ``psum`` over ``sub``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import topic as T
from ..engine import MatchEngine, _EncArena, make_fid_arr
from ..ops.automaton import (
    Automaton, assemble_automaton, encode_filters, expand_codes_host,
)
from ..ops.dictionary import PAD_TOK, SENTINEL, TokenDict
from ..ops.match_kernel import sharded_match_local
from ..state import (
    ShardedTables, resolve_device, sharded_tables_from_reference,
)


class Mesh:
    """A ``(sub, pub)`` grid of devices (``devices`` is an object
    array of ``torch.device``; one device may appear more than once).

    Each device must fill one block of the grid: adjacent shards by
    adjacent batch columns.  That covers one device at every position
    (a 4-shard index on one card, the CPU tests' mesh) and one shard per
    card; ``blocks`` lists ``(device, shards, columns)`` as slices, and
    `sharded_match` launches once per block."""

    axis_names = ("sub", "pub")

    def __init__(self, devices: np.ndarray) -> None:
        self.devices = devices
        self.shape = {"sub": devices.shape[0], "pub": devices.shape[1]}
        self.blocks: List[Tuple[torch.device, slice, slice]] = []
        for dev in dict.fromkeys(devices.ravel().tolist()):
            ks, js = np.nonzero(devices == dev)
            shards = slice(int(ks.min()), int(ks.max()) + 1)
            cols = slice(int(js.min()), int(js.max()) + 1)
            if not (devices[shards, cols] == dev).all():
                raise ValueError(
                    f"{dev} does not fill one block of adjacent shards "
                    f"and batch columns of the mesh")
            self.blocks.append((dev, shards, cols))


def make_mesh(
    n_devices: Optional[int] = None,
    sub: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2D ``(sub, pub)`` mesh over ``devices`` (default: every
    CUDA device; raises without one).  Asking for more devices than
    there are raises, as does naming a card that does not exist."""
    if devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
        for d in devs:
            if d.type == "cuda" and (d.index or 0) >= \
                    torch.cuda.device_count():
                raise ValueError(f"{d} does not exist: "
                                 f"{torch.cuda.device_count()} card(s)")
    devs = [torch.device(d.type, 0) if d.type == "cuda" and d.index is None
            else d for d in devs]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    n = len(devs)
    if sub is None:
        # favor filter-set sharding; publishes shard over what's left
        sub = n
        while sub > 1 and n % sub:
            sub -= 1
    pub = n // sub if sub else 0
    if pub < 1:
        raise ValueError(f"cannot lay {n} devices out with sub={sub}")
    arr = np.empty(sub * pub, object)
    arr[:] = devs[: sub * pub]
    return Mesh(arr.reshape(sub, pub))


@dataclass
class ShardedIndex:
    """K automaton shards with common geometry, stacked for a mesh."""

    shards: List[Automaton]
    # (fp_rows [K,Hb,2*B], node_rows [K,N,8], salts [K] uint32)
    tables: Tuple[np.ndarray, ...]
    max_levels: int
    kernel_levels: int
    # filter positions of each shard as assembled: an engine's encode
    # arena goes on appending to a shard's filter list while this index
    # serves, so the offsets must not follow the list
    sizes: Tuple[int, ...]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_nodes(self) -> int:
        return max(a.n_nodes for a in self.shards)

    @property
    def offsets(self) -> List[int]:
        """Global filter-position offset of each shard (shard-local
        positions + offset = position into the concatenated fid list)."""
        out, acc = [], 0
        for n in self.sizes:
            out.append(acc)
            acc += n
        return out


def shard_of(fid: Hashable, n_shards: int) -> int:
    """Stable fid -> shard assignment.  hash() matches the equality
    semantics of every engine dict (np.int64(7) and 7 land together).
    Python salts hash() of a str per process: tables that must agree
    byte for byte across processes use int fids."""
    return hash(fid) % n_shards


def assemble_sharded(
    shard_inputs: Sequence[Tuple],
    max_levels: int,
    min_buckets: int = 4,
    min_nodes: int = 16,
    native: bool = True,
) -> ShardedIndex:
    """Assemble per-shard encoded arrays (`encode_filters` outputs)
    into one stacked index with identical geometry (shared hash size,
    padded node count), so one launch serves every shard.
    ``min_buckets``/``min_nodes`` pin sticky capacity classes across
    rebuilds; ``native`` selects the sorts (`assemble_automaton`)."""
    shards = [
        assemble_automaton(*inp, max_levels=max_levels,
                           hash_buckets=min_buckets, native=native)
        for inp in shard_inputs
    ]
    nb = max(len(a.fp_rows) for a in shards)
    if any(len(a.fp_rows) != nb for a in shards):
        shards = [
            assemble_automaton(*inp, max_levels=max_levels,
                               hash_buckets=nb, native=native)
            for inp in shard_inputs
        ]
    n_nodes = max(max(a.n_nodes for a in shards), min_nodes)
    cap = 16
    while cap < n_nodes:
        cap *= 2
    n_nodes = cap  # power-of-two class: a bounded set of shapes

    def pad_nodes(a: np.ndarray) -> np.ndarray:
        # padded node rows are never terminal, have no '+' child, and
        # no incoming edge (verification-dead)
        out = np.zeros((n_nodes, 8), np.int32)
        out[:, 0] = SENTINEL
        out[:, 4] = -1
        out[:, 5] = -1
        out[: len(a)] = a
        return out

    ht = np.stack([a.fp_rows for a in shards])
    nrows = np.stack([pad_nodes(a.node_rows) for a in shards])
    salts = np.array([a.salt for a in shards], np.uint32)
    return ShardedIndex(
        shards=shards,
        tables=(ht, nrows, salts),
        max_levels=max_levels,
        kernel_levels=max(a.kernel_levels for a in shards),
        sizes=tuple(len(inp[3]) for inp in shard_inputs),
    )


def build_sharded_index(
    filters: Sequence[Tuple[Hashable, Tuple[str, ...]]],
    tdict: TokenDict,
    n_shards: int,
    max_levels: int = 16,
    native: bool = True,
) -> ShardedIndex:
    """Partition filters into ``n_shards`` automata with identical
    geometry (same hash size / node count / probe bound)."""
    parts: List[List] = [[] for _ in range(n_shards)]
    for fid, ws in filters:
        parts[shard_of(fid, n_shards)].append((fid, ws))
    return assemble_sharded(
        [encode_filters(p, tdict, max_levels, native=native)
         for p in parts],
        max_levels, native=native,
    )


def sharded_match(
    mesh: Mesh,
    fp_rows,
    node_rows,
    salts,
    tokens,
    lengths,
    dollar,
    *,
    f_width: int,
    m_cap: int,
):
    """Match a topic batch against every shard of the index.

    The tables are the stacked arrays of `ShardedIndex.tables` or, as
    the engine passes them, already placed on the mesh
    (`state.sharded_tables_from_reference`).  The batch (numpy or
    tensors; ``B`` a multiple of ``pub``) splits over ``pub``.  Returns
    ``(codes [K, B, m_cap], counts [K, B], ovf [K, B], total [B])`` on
    the mesh's first device, ``total`` being each topic's match count
    summed over the shards.

    One K5 launch (`sharded_match_local`) per block of the mesh, on
    that block's device over its shards and its columns' batch rows;
    with one card that is one launch for the whole grid.  Otherwise the
    other devices are synchronised, and their outputs and partial totals
    are copied to the mesh's first device and added there."""
    if not isinstance(fp_rows, dict):
        fp_rows, node_rows, salts = sharded_tables_from_reference(
            fp_rows, node_rows, salts, mesh)
    tok, ln, dl = (torch.as_tensor(np.asarray(a) if not isinstance(
        a, torch.Tensor) else a) for a in (tokens, lengths, dollar))
    sub, pub = mesh.shape["sub"], mesh.shape["pub"]
    b = tok.shape[0]
    if b % pub:
        raise ValueError(f"batch of {b} does not split over pub={pub}")
    bs = b // pub
    parts = []
    for dev, shards, cols in mesh.blocks:
        rows = slice(cols.start * bs, cols.stop * bs)
        out = sharded_match_local(
            fp_rows[dev], node_rows[dev], salts[dev],
            *(t[rows].contiguous().to(dev) for t in (tok, ln, dl)),
            f_width=f_width, m_cap=m_cap,
        )
        parts.append((dev, shards, rows, out))
    if len(parts) == 1:
        return parts[0][3]  # one device holds the whole grid
    home = mesh.devices[0, 0]
    for dev, *_ in parts:
        if dev.type == "cuda" and dev != home:
            torch.cuda.synchronize(dev)
    codes = torch.empty((sub, b, m_cap), dtype=torch.int32, device=home)
    counts = torch.empty((sub, b), dtype=torch.int32, device=home)
    ovf = torch.empty((sub, b), dtype=torch.bool, device=home)
    total = torch.zeros(b, dtype=torch.int32, device=home)
    for _, shards, rows, (c, n, o, t) in parts:
        codes[shards, rows] = c.to(home)
        counts[shards, rows] = n.to(home)
        ovf[shards, rows] = o.to(home)
        total[rows] += t.to(home)
    return codes, counts, ovf, total


class ShardedMatchEngine(MatchEngine):
    """The mutable `MatchEngine` with its base automaton partitioned
    over the mesh's ``sub`` axis and matched by `sharded_match` (K5):
    the same insert/delete/residual/overlay semantics, the same delta
    automaton (one automaton on ``device``, matched by K1 beside K5)
    and the same background rebuild, with one encode arena per shard.

    ``index``/``tdict`` may seed the engine with a pre-built
    `ShardedIndex`; its filters re-enter through `insert` and one
    rebuild re-shards them with this engine's own `TokenDict`.
    ``device`` (default: the mesh's first device) runs the rest of the
    engine's device work (the delta automaton, decide, rules)."""

    def __init__(
        self,
        mesh: Mesh,
        index: Optional[ShardedIndex] = None,
        tdict: Optional[TokenDict] = None,
        f_width: int = 16,
        m_cap: int = 128,
        max_levels: int = 16,
        rebuild_threshold: int = 4096,
        device=None,
        native: bool = True,
        background_rebuild: bool = False,
    ) -> None:
        super().__init__(
            max_levels=index.max_levels if index is not None else max_levels,
            f_width=f_width,
            m_cap=m_cap,
            rebuild_threshold=rebuild_threshold,
            device=mesh.devices[0, 0] if device is None else device,
            native=native,
            background_rebuild=background_rebuild,
        )
        self.mesh = mesh
        # sticky geometry classes (never shrink): rebuilds keep one
        # table shape instead of one per size
        self._shard_min_buckets = 4
        self._shard_min_nodes = 16
        if tdict is not None:
            self._tdict = tdict
        if index is not None:
            self._adopt(index)

    @property
    def index(self) -> Optional[ShardedIndex]:
        return self._aut

    def _adopt(self, index: ShardedIndex) -> None:
        if index.n_shards != self.mesh.shape["sub"]:
            raise ValueError(
                f"index has {index.n_shards} shards but mesh 'sub' axis "
                f"is {self.mesh.shape['sub']}"
            )
        for a in index.shards:
            for fid, ws in a.filters:
                self.insert(T.join(ws), fid)
        self.rebuild()

    def _build(self, inputs, hash_buckets: int = 0):
        """The incremental sharded build: one `_EncArena` per shard,
        `shard_of` routing each delta item and tombstone to its arena,
        so only the delta is encoded; the shards are assembled with the
        sticky geometry and placed on the mesh, each card's share on its
        side stream.  The fid array is concatenated in shard order."""
        n_shards = self.mesh.shape["sub"]
        parts: List[List] = [[] for _ in range(n_shards)]
        drops: List[List] = [[] for _ in range(n_shards)]
        for fid, ws in inputs[1]:
            parts[shard_of(fid, n_shards)].append((fid, ws))
        with self._enc_lock:
            if inputs[0] == "full":
                arenas = [_EncArena(self.max_levels, self.native)
                          for _ in range(n_shards)]
            else:
                arenas = self._build_cache
                for fid in inputs[2]:
                    drops[shard_of(fid, n_shards)].append(fid)
            for arena, items, dropped in zip(arenas, parts, drops):
                arena.apply(items, dropped, self._tdict)
            views = [a.views() for a in arenas]
            fid_views = [a.fid_view() for a in arenas]
            n_live = sum(len(a.rows) for a in arenas)
        index = assemble_sharded(
            views, self.max_levels,
            min_buckets=self._shard_min_buckets,
            min_nodes=self._shard_min_nodes,
            native=self.native,
        )
        self._shard_min_buckets = index.tables[0].shape[1]
        self._shard_min_nodes = index.tables[1].shape[1]
        if all(v.dtype != object for v in fid_views):
            fid_arr = np.concatenate(fid_views)
        else:
            fid_arr = make_fid_arr([f for v in fid_views for f in v.tolist()])
        t0 = time.perf_counter()
        tables = sharded_tables_from_reference(*index.tables, self.mesh,
                                               self._streams)
        self._event("upload", t0, bytes=index.tables[0].nbytes
                    + index.tables[1].nbytes + index.tables[2].nbytes)
        return index, tables, fid_arr, n_live, arenas

    def _encode_base(self, snap, words):
        """The window's rows at the index's levels (not deduplicated)."""
        idx, mat, lens, dol = self._encode_rows(words, snap[0].kernel_levels)
        return mat[idx], lens[idx], dol[idx]

    def _flat_submit(self, snap, enc):
        """Launch K5 on the window and complete it at once (the sharded
        launch and its downloads are synchronous): ``("done", (rows,
        global filter positions, overflowed rows))``."""
        index: ShardedIndex = snap[0]
        tables: ShardedTables = snap[1]
        tokens, lengths, dollar = enc
        # pad the batch to a power of two (at least 16), then to a
        # pub-axis multiple: a bounded set of shapes
        b = tokens.shape[0]
        pub = self.mesh.shape["pub"]
        bp = 16
        while bp < b:
            bp *= 2
        while bp % pub:
            bp += 1
        if bp != b:
            tokens = np.pad(tokens, ((0, bp - b), (0, 0)),
                            constant_values=PAD_TOK)
            lengths = np.pad(lengths, (0, bp - b))
            dollar = np.pad(dollar, (0, bp - b), constant_values=True)
        codes, _, ovf, _ = sharded_match(
            self.mesh, *tables, tokens, lengths, dollar,
            f_width=self.f_width, m_cap=self.m_cap,
        )
        codes = codes.cpu().numpy()[:, :b]
        ovf_rows = ovf.cpu().numpy()[:, :b].any(axis=0)
        rows_all: List[np.ndarray] = []
        gpos_all: List[np.ndarray] = []
        for k, (aut, off) in enumerate(zip(index.shards, index.offsets)):
            r, p = expand_codes_host(aut.code_off, aut.code_idx, codes[k])
            rows_all.append(r)
            gpos_all.append(p + off)
        rows = np.concatenate(rows_all)
        gpos = np.concatenate(gpos_all)
        order = np.argsort(rows, kind="stable")
        return ("done", (rows[order], gpos[order], ovf_rows))
