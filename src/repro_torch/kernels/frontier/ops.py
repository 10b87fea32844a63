"""PAA levels and fixpoints on the fused frontier kernel.

Port of ``repro/kernels/frontier/ops.py`` for the S2 ``frontier_kernel``
path.  Compilation is **two-stage**, as in ``repro``:

* **Stage A — graph-dependent, automaton-independent.**
  :func:`stage_graph` packs every label's adjacency into block-sparse
  B×B tiles — plus one *any-label union store* per direction, so a
  wildcard transition costs one tile list instead of |labels| — into ONE
  device tile tensor with per-(direction, label) offset tables.

* **Stage B — automaton-dependent, cheap.**  :func:`build_level_schedule`
  only computes the step order and the seven id arrays over the Stage-A
  offsets, plus the port's ``run_ptr`` (the CSR offsets of the output
  block runs) and ``work`` (the runs' valid steps in chunks, which the
  level kernels B1-B4 give one CTA each).  Transitions sharing
  (dst_state, direction, label) fuse into ONE pass over a *fan-in union
  row* appended to the frontier by :func:`extend_frontier`.

The out-of-core tile store (:class:`repro_torch.core.plans._SlabCache`)
builds Stage A one (direction, label) slab at a time on the host
(:func:`pack_label_store`) and assembles a subset of slabs on the device
(:func:`assemble_staged`), byte-identical to the same keys of the full
staging.

The site-sharded backend stages per site: :func:`stage_sharded_graph`
packs each site's own edges into a host slab, :func:`merge_staged_sites`
unions the slabs of co-located sites, :func:`bucket_staged_sites` stacks
them on the device in power-of-two shape buckets, and
:func:`build_sharded_level_schedule` schedules each site, padded to its
bucket.  Each bucket carries one work list over all its member rows
(:func:`bucket_work`), so :func:`expand_level_sharded` runs a level as one
B1 or B3 launch per bucket.  Over ranks (``repro``'s mesh program) a
rank stages only its own block of sites, merged into its one group slab
(:func:`stage_rank_group`), and agrees the shape classes with the other
groups by an ``all_reduce(MAX)`` of its counts
(:func:`bucket_rank_group`, :func:`build_rank_level_schedule`): its
bucket arrays are its rows of the one-card plan, and a level is its
launch, clamped, then a ``pmax`` over the site axes.

Stage A stages either tile store: ``tile_dtype="f32"`` (dense 0/1
B×B tiles) or ``"uint32"`` (the dst axis packed into ⌈B/32⌉ bit-plane
words per tile row, 1/32 of the bytes), held in torch as int32 with the
same bits.  One Stage-B schedule serves both, and the level kernels pick
their variant off the tile dtype.

The fixpoints (:func:`reach_fixpoint` on f32 rows of 8 stacked queries,
:func:`reach_fixpoint_packed` on int32 lane words of 256) run one fused
level launch per BFS level.  ``repro`` runs them in a
``lax.while_loop`` with no host sync; here a :class:`LevelLoop` keeps the
loop's state on the device and runs :data:`LEVELS_PER_CHECK` levels, each
gated by an "active" flag on the device, per host check: on a card
captured once in a CUDA graph and replayed.  The per-rank S2 fixpoints
(``core/strategies.py``) run on the same loop: captured with their
``pmax`` on an NCCL rank, eagerly at :data:`LEVELS_PER_CHECK_GLOO`
levels a check on a ``gloo`` one.  :data:`FIXPOINT_COUNTERS` counts the
levels and those host syncs.  Their witness forms
(:func:`reach_fixpoint_levels`, :func:`reach_fixpoint_packed_levels`)
also carry each product state's discovery level, and
:func:`count_paths_bounded` runs the same level on run counts (the
counting semiring); the three take the f32 tile store only.

The per-transition baseline (:func:`make_blocked_graph`,
:func:`expand_level`, :func:`multi_source_reach_baseline`) is the
pre-fusion path: one ``frontier_step_blocks`` launch per (transition,
label store) and level, and a host loop, as in ``repro``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import threading

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core.automaton import FWD, INV, CompiledAutomaton
from repro_torch.core.witness import INF_LEVEL
from repro_torch.dist import collectives
from repro_torch.graph.structure import LabeledGraph
from repro_torch.kernels.frontier import frontier as fkernel
from repro_torch.kernels.frontier.frontier import (
    bucket_level_blocks,
    frontier_step_blocks,
    fused_level_blocks,
    packed_level_blocks,
    unpack_lane_rows,
)
from repro_torch.kernels.frontier.ref import (
    TILE_DTYPES,
    pack_blocks,
    pack_blocks_chunked,
    tile_words,
)

# f32 sublane minimum of the TPU tile, kept as the query stack height: up
# to QPAD independent queries' frontiers ride each automaton state's rows.
QPAD = 8
# query lanes of the packed path: QPAD word rows of 32 bits per state
QPACK = QPAD * 32
# BFS levels a fixpoint runs on the device per host check (LevelLoop).  A
# Table-2 query's fixpoints take 6 (q1, f32 rows) to 12.5 (q12) levels on
# the f32 paths and 9 to 18 on the packed ones, a served request's 3.1 on
# average; each body costs a capture's worth of host work once per
# executor and up to k - 1 levels past convergence, which launch on an
# empty frontier (an empty packed level still unpacks its meters' 256
# lanes).  4 reads a served fixpoint about once and a path's every 4
# levels.
LEVELS_PER_CHECK = 4
# BFS levels a per-rank fixpoint runs per host check where its site group
# is a gloo group (the CPU ranks, ranks sharing a card).  gloo's
# all_reduce already waits on the host every level, so a level past
# convergence saves no sync and still puts a whole merged frontier on the
# wire (1.6 MB a level on the twin's sharded (i)): one level a body.
LEVELS_PER_CHECK_GLOO = 1
# Run the level bodies eagerly on a card as on the CPU, with no CUDA
# graph: the loop that the graphs are held to (chip_smoke.py, the card
# tests).  False on every path a caller runs.
EAGER = False

# offset-table key for the any-label union store (wildcard transitions);
# real label ids are >= 0 so the key space is disjoint.
ANY_LABEL = -1

# smallest power-of-two shape class for the site-sharded backend's bucketed
# grids: buckets never round below this, so near-empty sites share one
# tiny class instead of fragmenting into one bucket each.
BUCKET_FLOOR = 8

# Build-path instrumentation: every Stage-A packing/staging op and every
# Stage-B schedule construction bumps a counter (same keys as ``repro``).
BUILD_COUNTERS: collections.Counter = collections.Counter()

# Fixpoint instrumentation: "levels" counts BFS levels run (one level
# kernel launch each on a host loop; read from the device counter when a
# LevelLoop's fixpoint ends), "host_syncs" the reads of a frontier or of
# a loop's flag, "fixpoints" the fixpoints a LevelLoop ran, "bodies" the
# k-level bodies they ran (each launches its levels' kernels, converged or
# not), "replays" those replayed from a CUDA graph, "captures" the graphs
# captured, "all_reduces" the collectives the bodies made (a per-rank
# level's pmax: k a body, captured or not).
FIXPOINT_COUNTERS: collections.Counter = collections.Counter()


def reset_build_counters() -> None:
    BUILD_COUNTERS.clear()


# ---------------------------------------------------------------------------
# Per-label block stores (the baseline path's graph)
# ---------------------------------------------------------------------------


def column_runs(cols: np.ndarray) -> np.ndarray:
    """The offsets of each distinct column's run in a non-decreasing
    ``cols`` (``pack_blocks`` order), closed by ``len(cols)``: the runs
    inside which :func:`store_work` cuts a store's chunks."""
    cols = np.asarray(cols)
    if (cols[1:] < cols[:-1]).any():
        raise ValueError("block cols must be non-decreasing")
    starts = np.flatnonzero(np.r_[True, cols[1:] != cols[:-1]]) if len(cols) else []
    return np.append(starts, len(cols)).astype(np.int32)


@dataclasses.dataclass
class BlockedGraph:
    """Every label's adjacency as its own block-sparse tile list, forward
    and inverse (``repro``'s ``BlockedGraph``).  Unlike ``repro``'s, each
    entry is ``(tiles, rows, cols, work)`` on the device: ``work``
    (:func:`store_work`, kernel B5's work list) is built once here, so a
    step launch needs no host work on the tile list.  ``device`` is where
    the tiles live."""

    n_nodes: int
    v_pad: int
    block_size: int
    fwd: dict[int, tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]
    inv: dict[int, tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]
    device: torch.device


def store_work(cols: np.ndarray) -> np.ndarray:
    """Kernel B5's work list for one label store: its tiles, in order, cut
    into chunks of :data:`WORK_CHUNK_F32` inside each column's run
    (:func:`level_work` with every step valid).  Built once per store by
    :func:`blocked_entry`, counted in :data:`BUILD_COUNTERS`."""
    BUILD_COUNTERS["store_work"] += 1
    return level_work(np.ones(len(cols), np.int32), column_runs(cols), WORK_CHUNK_F32)


def blocked_entry(
    tiles: np.ndarray, rows: np.ndarray, cols: np.ndarray, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One label store of a :class:`BlockedGraph`, with its work list,
    moved to ``device``."""
    work = store_work(cols)
    return tuple(
        torch.from_numpy(np.array(a)).to(device)  # a writable copy
        for a in (tiles, np.asarray(rows, np.int32), np.asarray(cols, np.int32), work)
    )


def make_blocked_graph(
    graph: LabeledGraph, block_size: int = 128, device: str | torch.device | None = None
) -> BlockedGraph:
    """Pack every label's edges into f32 tiles, forward and inverse, one
    store at a time on the host, each moved to ``device`` (``None``: the
    GPU) as soon as it is packed.  Labels with no edges get no entry."""
    device = resolve_device(device)
    BUILD_COUNTERS["make_blocked_graph"] += 1
    fwd, inv = {}, {}
    for (direction, lid), (t, r, c), _ in _label_tile_lists(graph, block_size, None, "f32"):
        (fwd if direction == FWD else inv)[lid] = blocked_entry(t, r, c, device)
    v_pad = -(-graph.n_nodes // block_size) * block_size
    return BlockedGraph(graph.n_nodes, v_pad, block_size, fwd, inv, device)


# ---------------------------------------------------------------------------
# Stage A: staged tile tensors (graph-dependent, automaton-independent)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StagedGraph:
    """Stage-A artifact: every label store's tiles in ONE device tensor.

    ``tiles[0]`` is the all-zero cover tile; ``offsets[(direction,
    label_id)] = (base, block_rows, block_cols)`` says where that label
    store's tiles start and which (row, col) block each occupies.  The
    ``(direction, ANY_LABEL)`` entries are the any-label union stores.
    Byte-identical to ``repro``'s staging of the same graph (the uint32
    store through ``.view(np.uint32)``)."""

    n_nodes: int
    v_pad: int
    block_size: int
    # "f32": (1 + sum nnz, B, B) float32 0/1; "uint32": (1 + sum nnz, B,
    # ⌈B/32⌉) int32 bit-plane words (dst d = bit d % 32 of word d // 32).
    # Index 0 is the zero cover tile.
    tiles: torch.Tensor
    offsets: dict[tuple[int, int], tuple[int, np.ndarray, np.ndarray]]
    # total edge-list slices consumed by chunked packing (0 when one-shot)
    staging_chunks: int = 0
    tile_dtype: str = "f32"

    @property
    def tile_store_bytes(self) -> int:
        """Total staged tile-tensor bytes (cover tile included)."""
        return self.tiles.numel() * self.tiles.element_size()

    def slab_bytes(self) -> dict[tuple[int, int], int]:
        """Per-(direction, label) staged bytes: each store's tile count
        times the per-tile footprint of this store's dtype."""
        per_tile = self.tile_store_bytes // max(int(self.tiles.shape[0]), 1)
        return {k: len(rows) * per_tile for k, (_, rows, _) in self.offsets.items()}


def _pack(src, dst, n_nodes, block_size, chunk_edges, tile_dtype):
    """One store's (tiles, rows, cols, n_chunks), one-shot or chunked."""
    if chunk_edges is None:
        t, r, c, _ = pack_blocks(src, dst, n_nodes, block_size, tile_dtype)
        return t, r, c, 0
    t, r, c, _, nc = pack_blocks_chunked(src, dst, n_nodes, block_size, chunk_edges, tile_dtype)
    return t, r, c, nc


def _label_tile_lists(
    graph: LabeledGraph, block_size: int, chunk_edges: int | None, tile_dtype: str
):
    """Host tile lists per (direction, label), packed one store at a time:
    yields ``((direction, label_id), (tiles, rows, cols), n_chunks)``.
    Labels with no edges yield nothing (no offset key, as in ``repro``).
    A generator, so the host holds one label store at a time."""
    for lid in range(graph.n_labels):
        src, dst = graph.edges_with_label(lid)
        if len(src) == 0:
            continue
        BUILD_COUNTERS["pack_blocks"] += 2
        for direction, (s, d) in ((FWD, (src, dst)), (INV, (dst, src))):
            t, r, c, nc = _pack(s, d, graph.n_nodes, block_size, chunk_edges, tile_dtype)
            yield (direction, lid), (t, r, c), nc


def _union_store(
    graph: LabeledGraph,
    direction: int,
    block_size: int,
    chunk_edges: int | None,
    tile_dtype: str,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """The any-label union store of one direction: the block-sparse OR of
    every label store's tiles (an edge with any label is an edge), so a
    wildcard grounds to ONE tile list instead of |labels|.

    ``repro`` ORs the packed label stores tile by tile (``np.maximum`` on
    f32, ``np.bitwise_or`` on bit-plane words); packing every edge of the
    direction at once gives the same bytes (both sort blocks by (col,
    row) and store binary presence, and the bit-plane scatter ORs
    repeated edges — ``repro``'s own ``pack_label_store(ANY_LABEL)``
    relies on this) without holding all label stores on the host.
    ``None`` when the graph has no edges."""
    if graph.n_edges == 0:
        return None
    src, dst = (graph.src, graph.dst) if direction == FWD else (graph.dst, graph.src)
    t, r, c, _ = _pack(src, dst, graph.n_nodes, block_size, chunk_edges, tile_dtype)
    return t, r, c


def _store_sizes(graph: LabeledGraph, block_size: int) -> dict[tuple[int, int], int]:
    """Tile count of every store :func:`stage_graph` will pack, from the
    distinct block keys alone (no tiles are allocated)."""
    nb = -(-graph.n_nodes // block_size)

    def n_blocks(s: np.ndarray, d: np.ndarray) -> int:
        return len(np.unique((d // block_size).astype(np.int64) * nb + s // block_size))

    sizes = {}
    for lid in range(graph.n_labels):
        src, dst = graph.edges_with_label(lid)
        if len(src):
            sizes[(FWD, lid)] = n_blocks(src, dst)
            sizes[(INV, lid)] = n_blocks(dst, src)
    if graph.n_edges:
        sizes[(FWD, ANY_LABEL)] = n_blocks(graph.src, graph.dst)
        sizes[(INV, ANY_LABEL)] = n_blocks(graph.dst, graph.src)
    return sizes


def _concat_stores(
    sizes: dict[tuple[int, int], int], block_size: int, tile_dtype: str, device: torch.device
) -> tuple[torch.Tensor, dict[tuple[int, int], int]]:
    """The concatenated layout: the zero cover tile at index 0, then every
    store in sorted key order (``repro``'s order).  Allocates the device
    tile tensor once, zeroed, and returns it with each store's base: f32
    (n, B, B), or int32 (n, B, ⌈B/32⌉) holding ``repro``'s uint32 bits."""
    bases, off = {}, 1
    for key in sorted(sizes):
        bases[key] = off
        off += sizes[key]
    if tile_dtype == "uint32":
        shape, dtype = (off, block_size, tile_words(block_size)), torch.int32
    else:
        shape, dtype = (off, block_size, block_size), torch.float32
    return torch.zeros(shape, dtype=dtype, device=device), bases


def _stage_blocked(bg: BlockedGraph) -> StagedGraph:
    """Stage A from a :class:`BlockedGraph`, on its device: the label
    stores are copied into one tensor device to device, and each union
    store is the ``index_add_`` of its direction's label tiles onto their
    (row, col) block, clamped to 1 — on {0,1} tiles the same bytes as
    ``repro``'s ``np.maximum`` fold, in ``pack_blocks``' (col, row)
    order."""
    nb = bg.v_pad // bg.block_size
    host = {
        (direction, lid): (e[0], e[1].cpu().numpy(), e[2].cpu().numpy())
        for direction, store in ((FWD, bg.fwd), (INV, bg.inv))
        for lid, e in store.items()
    }
    union_keys = {}
    for direction in (FWD, INV):
        keys = [c.astype(np.int64) * nb + r for (d, _), (_, r, c) in host.items() if d == direction]
        if keys:
            union_keys[direction] = np.unique(np.concatenate(keys))
    sizes = {key: len(r) for key, (_, r, _) in host.items()}
    sizes.update({(d, ANY_LABEL): len(k) for d, k in union_keys.items()})
    tiles, bases = _concat_stores(sizes, bg.block_size, "f32", bg.device)
    offsets = {}
    for key, (t, r, c) in host.items():
        base = bases[key]
        tiles[base : base + len(r)].copy_(t)
        offsets[key] = (base, r, c)
        ukeys, ubase = union_keys[key[0]], bases[(key[0], ANY_LABEL)]
        pos = np.searchsorted(ukeys, c.astype(np.int64) * nb + r) + ubase
        tiles.index_add_(0, torch.from_numpy(pos).to(bg.device), t)
    for direction, ukeys in union_keys.items():
        base = bases[(direction, ANY_LABEL)]
        tiles[base : base + len(ukeys)].clamp_(max=1.0)
        rows, cols = (ukeys % nb).astype(np.int32), (ukeys // nb).astype(np.int32)
        offsets[(direction, ANY_LABEL)] = (base, rows, cols)
    return StagedGraph(
        n_nodes=bg.n_nodes,
        v_pad=bg.v_pad,
        block_size=bg.block_size,
        tiles=tiles,
        offsets=dict(sorted(offsets.items())),
    )


def stage_graph(
    source: LabeledGraph | BlockedGraph,
    block_size: int = 128,
    chunk_edges: int | None = None,
    tile_dtype: str = "f32",
    device: str | torch.device | None = None,
) -> StagedGraph:
    """Stage A for the fused backend: pack every label's tiles — plus the
    per-direction any-label union stores — into one device tensor +
    offsets, byte-identical to ``repro``'s ``stage_graph``.

    A :class:`BlockedGraph` source is staged on its own device from its
    f32 tiles (``block_size``, ``chunk_edges`` and ``device`` are then
    not read), and, as in ``repro``, refuses ``tile_dtype="uint32"``.

    ``repro`` packs every store on the host and then concatenates them,
    so the host peaks at twice the store.  Here the device tensor is
    allocated once (sized by a cheap pass over the block keys) and each
    (direction, label) store is copied into its slice as soon as it is
    packed: the host peaks at one store — the largest is a union store.
    ``chunk_edges`` streams each store's packing in edge slices
    (:func:`~repro_torch.kernels.frontier.ref.pack_blocks_chunked`).
    ``tile_dtype="uint32"`` stages the bit-plane store (1/32 the bytes,
    boolean semiring only) as int32 words with ``repro``'s uint32 bits."""
    if tile_dtype not in TILE_DTYPES:
        raise ValueError(f"tile_dtype must be one of {TILE_DTYPES}, got {tile_dtype!r}")
    if isinstance(source, BlockedGraph):
        if tile_dtype != "f32":
            raise ValueError(
                "a BlockedGraph carries pre-packed f32 tiles; stage from the "
                "LabeledGraph to get a tile_dtype='uint32' store"
            )
        BUILD_COUNTERS["stage_graph"] += 1
        return _stage_blocked(source)
    graph = source
    device = resolve_device(device)
    BUILD_COUNTERS["stage_graph"] += 1
    sizes = _store_sizes(graph, block_size)
    tiles, bases = _concat_stores(sizes, block_size, tile_dtype, device)
    offsets: dict[tuple[int, int], tuple[int, np.ndarray, np.ndarray]] = {}
    staging_chunks = 0

    def put(key, store) -> None:
        t, r, c = store
        base = bases[key]
        if len(r) != sizes[key]:
            raise RuntimeError(f"store {key} packed {len(r)} tiles, sized {sizes[key]}")
        if t.dtype == np.uint32:
            t = t.view(np.int32)  # torch has no uint32 bit ops on the CPU
        tiles[base : base + len(r)].copy_(torch.from_numpy(t))
        offsets[key] = (base, r, c)

    for key, store, nc in _label_tile_lists(graph, block_size, chunk_edges, tile_dtype):
        put(key, store)
        staging_chunks += nc
    for direction in (FWD, INV):
        u = _union_store(graph, direction, block_size, chunk_edges, tile_dtype)
        if u is not None:
            put((direction, ANY_LABEL), u)
    BUILD_COUNTERS["staging_chunks"] += staging_chunks
    v_pad = -(-graph.n_nodes // block_size) * block_size
    return StagedGraph(
        n_nodes=graph.n_nodes,
        v_pad=v_pad,
        block_size=block_size,
        tiles=tiles,
        offsets=dict(sorted(offsets.items())),
        staging_chunks=staging_chunks,
        tile_dtype=tile_dtype,
    )


def pack_label_store(
    graph: LabeledGraph,
    direction: int,
    label_id: int,
    block_size: int,
    chunk_edges: int | None = None,
    tile_dtype: str = "f32",
) -> tuple[tuple[np.ndarray, np.ndarray, np.ndarray] | None, int]:
    """Pack ONE (direction, label) slab on the host straight from the edge
    stream — the out-of-core tile store's build and rebuild unit (see
    :meth:`repro_torch.core.plans.GraphPlanStore.staged_graph`).

    ``label_id == ANY_LABEL`` packs every edge of the direction: the same
    packing as :func:`stage_graph`'s union store, so the same bytes.
    Returns ``(slab | None, n_chunks)``, the slab as numpy ``(tiles,
    rows, cols)`` (bit-plane tiles in ``repro``'s uint32); ``None`` when
    the graph has no matching edges (full staging omits that offset key
    too)."""
    if label_id == ANY_LABEL:
        src, dst = graph.src, graph.dst
    else:
        src, dst = graph.edges_with_label(label_id)
    if direction == INV:
        src, dst = dst, src
    if len(src) == 0:
        return None, 0
    BUILD_COUNTERS["pack_blocks"] += 1
    t, r, c, nc = _pack(src, dst, graph.n_nodes, block_size, chunk_edges, tile_dtype)
    BUILD_COUNTERS["staging_chunks"] += nc
    return (t, r, c), nc


def assemble_staged(
    stores: dict[tuple[int, int], tuple[np.ndarray, np.ndarray, np.ndarray]],
    n_nodes: int,
    block_size: int,
    tile_dtype: str = "f32",
    staging_chunks: int = 0,
    device: str | torch.device | None = None,
) -> StagedGraph:
    """A :class:`StagedGraph` on ``device`` (``None``: the GPU) from
    already-packed host slabs — the label-subset assembly path of the
    byte-budgeted tile store.  Packs nothing (slabs come from
    :func:`pack_label_store` or a spill file); the stores land behind the
    zero cover tile in sorted key order, as in ``repro``, so a schedule
    built against the subset sees exactly the offset keys in ``stores``,
    which must cover the automaton's :func:`required_offset_keys`."""
    device = resolve_device(device)
    sizes = {key: len(r) for key, (_, r, _) in stores.items()}
    tiles, bases = _concat_stores(sizes, block_size, tile_dtype, device)
    offsets = {}
    for key in sorted(stores):
        t, r, c = stores[key]
        if t.dtype == np.uint32:
            t = t.view(np.int32)
        tiles[bases[key] : bases[key] + len(r)].copy_(torch.from_numpy(np.ascontiguousarray(t)))
        offsets[key] = (bases[key], r, c)
    return StagedGraph(
        n_nodes=n_nodes,
        v_pad=-(-n_nodes // block_size) * block_size,
        block_size=block_size,
        tiles=tiles,
        offsets=offsets,
        staging_chunks=staging_chunks,
        tile_dtype=tile_dtype,
    )


# ---------------------------------------------------------------------------
# Stage A, site-sharded: per-site slabs on the host, shape buckets on the device
# ---------------------------------------------------------------------------


def shape_class(n: int, floor: int = BUCKET_FLOOR) -> int:
    """The power-of-two shape bucket ``n`` rounds up into (≥ ``floor``)."""
    n = max(int(n), 1)
    return max(floor, 1 << (n - 1).bit_length())


def _host_tiles(n: int, block_size: int, tile_dtype: str) -> np.ndarray:
    """``n`` zeroed host tiles: f32 (n, B, B), or int32 (n, B, ⌈B/32⌉)
    holding ``repro``'s uint32 bit-plane words."""
    if tile_dtype == "uint32":
        return np.zeros((n, block_size, tile_words(block_size)), np.int32)
    return np.zeros((n, block_size, block_size), np.float32)


@dataclasses.dataclass
class StagedShardedGraph:
    """Stage A for the site-sharded backend (``repro``'s
    ``StagedShardedGraph``): per-site staged tile slabs, each at its own
    natural tile count, with the layout of :func:`stage_graph` (cover tile
    0, stores in sorted key order).  The slabs stay on the host, as in
    ``repro``; :func:`bucket_staged_sites` moves them to the device once
    per shape bucket.  Bit-plane slabs are int32 numpy arrays holding
    ``repro``'s uint32 bits."""

    n_sites: int
    n_nodes: int
    v_pad: int
    block_size: int
    site_tiles: tuple[np.ndarray, ...]  # per site: (n_tiles_s, B, B) f32 or (n_tiles_s, B, W) int32
    site_offsets: tuple[dict[tuple[int, int], tuple[int, np.ndarray, np.ndarray]], ...]
    tile_dtype: str = "f32"

    @property
    def site_n_tiles(self) -> tuple[int, ...]:
        return tuple(int(t.shape[0]) for t in self.site_tiles)

    @property
    def tile_store_bytes(self) -> int:
        """Total staged bytes across every site slab."""
        return int(sum(t.nbytes for t in self.site_tiles))


def _stage_site(graph: LabeledGraph, block_size: int, tile_dtype: str):
    """One site's host slab and offsets: its label stores and any-label
    union stores packed from its own edges, concatenated behind the cover
    tile in sorted key order (``repro``'s ``_concat_stores``)."""
    stores = {key: store for key, store, _ in _label_tile_lists(graph, block_size, None, tile_dtype)}
    for direction in (FWD, INV):
        u = _union_store(graph, direction, block_size, None, tile_dtype)
        if u is not None:
            stores[(direction, ANY_LABEL)] = u
    slab = _host_tiles(1 + sum(len(r) for _, r, _ in stores.values()), block_size, tile_dtype)
    offsets, off = {}, 1
    for key in sorted(stores):
        t, r, c = stores[key]
        slab[off : off + len(r)] = t.view(np.int32) if t.dtype == np.uint32 else t
        offsets[key] = (off, r, c)
        off += len(r)
    return slab, offsets


def stage_sharded_graph(
    site_graphs: list[LabeledGraph], block_size: int = 128, tile_dtype: str = "f32"
) -> StagedShardedGraph:
    """Stage A per site (``repro``'s ``stage_sharded_graph``): each site's
    tile lists come from its own edge partition, replicas included, kept
    at the site's natural size on the host.  Every site graph must share
    ``n_nodes`` (the global node id space); a site with no edges holds
    only the cover tile.  Byte-identical to ``repro``'s slabs (bit-planes
    through ``.view(np.uint32)``)."""
    if tile_dtype not in TILE_DTYPES:
        raise ValueError(f"tile_dtype must be one of {TILE_DTYPES}, got {tile_dtype!r}")
    if not site_graphs:
        raise ValueError("need at least one site graph")
    n_nodes = site_graphs[0].n_nodes
    if any(g.n_nodes != n_nodes for g in site_graphs):
        raise ValueError("site graphs must share the global node id space")
    BUILD_COUNTERS["stage_sharded_graph"] += 1
    sites = [_stage_site(g, block_size, tile_dtype) for g in site_graphs]
    return StagedShardedGraph(
        n_sites=len(site_graphs),
        n_nodes=n_nodes,
        v_pad=-(-n_nodes // block_size) * block_size,
        block_size=block_size,
        site_tiles=tuple(t for t, _ in sites),
        site_offsets=tuple(o for _, o in sites),
        tile_dtype=tile_dtype,
    )


def merge_staged_sites(staged: StagedShardedGraph, n_groups: int) -> StagedShardedGraph:
    """Merge blocks of co-located sites into one deduplicated union slab
    per group (``repro``'s ``merge_staged_sites``): group ``d`` holds sites
    ``[d·k, (d+1)·k)``, ``k = n_sites / n_groups``, as ``repro``'s
    ``shard_map`` blocks them over the site axes.  The boolean level is
    the same on the union; per-site identity stays in the meters.
    Returns ``staged`` itself when ``k == 1``.

    ``repro`` folds tile by tile in a Python loop.  Here each group's
    blocks are coded ``(key, col, row)``, sorted once (``np.unique``: the
    key order of ``_concat_stores``, then ``pack_blocks``' (col, row)
    order), and each site's slab is folded into its blocks' places in one
    vectorised ``np.maximum`` (f32) or ``np.bitwise_or`` (bit-planes) —
    a site holds each block of a store once, so its places are distinct.
    Max and OR are exact in any order: the bytes are ``repro``'s."""
    if staged.n_sites % n_groups:
        raise ValueError(f"n_sites={staged.n_sites} must be divisible by n_groups={n_groups}")
    k = staged.n_sites // n_groups
    if k == 1:
        return staged
    BUILD_COUNTERS["merge_staged_sites"] += 1
    combine = np.bitwise_or if staged.tile_dtype == "uint32" else np.maximum
    nb = staged.v_pad // staged.block_size
    site_tiles, site_offsets = [], []
    for d in range(n_groups):
        sites = range(d * k, (d + 1) * k)
        keys = sorted(set().union(*(staged.site_offsets[s] for s in sites)))
        key_id = {key: i for i, key in enumerate(keys)}
        codes, takes = [], []
        for s in sites:
            ents = staged.site_offsets[s].items()
            codes.append(np.concatenate([np.zeros(0, np.int64)] + [
                (key_id[key] * nb + c.astype(np.int64)) * nb + r for key, (_, r, c) in ents
            ]))
            takes.append(np.concatenate([np.zeros(0, np.int64)] + [
                base + np.arange(len(r)) for _, (base, r, _) in ents
            ]))
        uniq = np.unique(np.concatenate(codes))
        slab = _host_tiles(1 + len(uniq), staged.block_size, staged.tile_dtype)
        for s, code, take in zip(sites, codes, takes):
            pos = 1 + np.searchsorted(uniq, code)
            slab[pos] = combine(slab[pos], staged.site_tiles[s][take])
        bounds = np.searchsorted(uniq, np.arange(len(keys) + 1, dtype=np.int64) * nb * nb)
        offsets = {}
        for i, key in enumerate(keys):
            u = uniq[bounds[i] : bounds[i + 1]]
            offsets[key] = (1 + int(bounds[i]), (u % nb).astype(np.int32), (u // nb % nb).astype(np.int32))
        site_tiles.append(slab)
        site_offsets.append(offsets)
    return StagedShardedGraph(
        n_sites=n_groups,
        n_nodes=staged.n_nodes,
        v_pad=staged.v_pad,
        block_size=staged.block_size,
        site_tiles=tuple(site_tiles),
        site_offsets=tuple(site_offsets),
        tile_dtype=staged.tile_dtype,
    )


@dataclasses.dataclass
class TileBucket:
    """One power-of-two tile shape class of :func:`bucket_staged_sites`:
    the member sites' slabs zero-padded to ``n_tiles`` and stacked on the
    device, row ``d * len(slots) + j`` the site at slot ``slots[j]`` of
    group ``d`` (``repro``'s ``shard_map`` row order)."""

    n_tiles: int  # power-of-two padded per-site tile count
    slots: tuple[int, ...]  # local site indices (uniform across groups)
    sites: tuple[int, ...]  # global site ids, row by row (group-major)
    tiles: torch.Tensor  # (rows, n_tiles, B, B) f32 or (rows, n_tiles, B, W) int32


@dataclasses.dataclass
class ShardedTileBuckets:
    """Stage-A shape buckets (``repro``'s ``ShardedTileBuckets``): the
    staged slabs grouped into power-of-two tile-count classes by *slot*
    (a site's index within its group of ``n_sites / axis_size``); a
    slot's class is the roundup of the largest tile count among the sites
    sharing it across groups.  ``bucket_id`` is a pure function of (site
    tile counts, axis_size, floor)."""

    axis_size: int
    s_local: int
    floor: int
    buckets: tuple[TileBucket, ...]

    @property
    def bucket_id(self) -> tuple:
        """The shape-bucket descriptor; it joins the executor cache's
        graph key (see ``repro_torch.serve.plancache``)."""
        return (self.axis_size, self.floor, tuple((b.n_tiles, b.slots) for b in self.buckets))


def bucket_staged_sites(
    staged: StagedShardedGraph,
    axis_size: int = 1,
    floor: int = BUCKET_FLOOR,
    device: str | torch.device | None = None,
) -> ShardedTileBuckets:
    """Group the staged slabs into power-of-two tile shape buckets and
    stack each bucket on ``device`` (``None``: the GPU), as ``repro``'s
    ``bucket_staged_sites``: a bucket with one member keeps its natural
    tile count.  Each member's slab is copied straight into its row of a
    zeroed device stack, so no padded copy is made on the host."""
    if staged.n_sites % axis_size:
        raise ValueError(
            f"n_sites={staged.n_sites} must be divisible by the site-axis "
            f"size {axis_size} (sites are blocked over the site axes)"
        )
    device = resolve_device(device)
    BUILD_COUNTERS["bucket_staged_sites"] += 1
    s_local = staged.n_sites // axis_size
    n_tiles = staged.site_n_tiles
    slot_class = {
        sl: shape_class(max(n_tiles[d * s_local + sl] for d in range(axis_size)), floor)
        for sl in range(s_local)
    }
    by_class: dict[int, list[int]] = {}
    for sl in range(s_local):
        by_class.setdefault(slot_class[sl], []).append(sl)
    b = staged.block_size
    buckets = []
    for cls in sorted(by_class):
        slots = tuple(sorted(by_class[cls]))
        sites = tuple(d * s_local + sl for d in range(axis_size) for sl in slots)
        if len(sites) == 1:  # nothing to unify: natural shape, no roundup
            cls = n_tiles[sites[0]]
        stack = _device_stack([staged.site_tiles[s] for s in sites], cls, staged, device)
        buckets.append(TileBucket(n_tiles=cls, slots=slots, sites=sites, tiles=stack))
    return ShardedTileBuckets(axis_size=axis_size, s_local=s_local, floor=floor,
                              buckets=tuple(buckets))


def _device_stack(
    slabs: list[np.ndarray], n_tiles: int, staged: StagedShardedGraph, device
) -> torch.Tensor:
    """``slabs`` zero-padded to ``n_tiles`` and stacked on ``device``, each
    slab copied straight into its row of a zeroed device stack."""
    b = staged.block_size
    width, dtype = (tile_words(b), torch.int32) if staged.tile_dtype == "uint32" else (b, torch.float32)
    stack = torch.zeros((len(slabs), n_tiles, b, width), dtype=dtype, device=device)
    for row, slab in enumerate(slabs):
        stack[row, : slab.shape[0]].copy_(torch.from_numpy(slab))
    return stack


def stage_rank_group(site_graphs: list[LabeledGraph], block_size: int = 128,
                     tile_dtype: str = "f32") -> StagedShardedGraph:
    """One rank's Stage A: its block of sites staged per site
    (:func:`stage_sharded_graph`) and merged into its one group slab
    (:func:`merge_staged_sites`), the bytes of that group's slab in the
    one-card merge.  Returns a one-group :class:`StagedShardedGraph`."""
    return merge_staged_sites(stage_sharded_graph(site_graphs, block_size, tile_dtype), 1)


def bucket_rank_group(
    group: StagedShardedGraph,
    mesh,
    site_axes=("data",),
    floor: int = BUCKET_FLOOR,
    device: str | torch.device | None = None,
) -> ShardedTileBuckets:
    """:func:`bucket_staged_sites` for one rank of a mesh: ``group`` is the
    rank's one merged slab (:func:`stage_rank_group`).  The merged groups
    form one bucket of one slot; its class is the roundup of the largest
    group's tile count, agreed by an ``all_reduce(MAX)`` over
    ``site_axes``, and a single group (axis size 1) keeps its natural
    count.  The bucket's one row is the rank's row of the one-card stack:
    ``sites`` holds the rank's group index."""
    if group.n_sites != 1:
        raise ValueError(f"a rank holds one merged group slab, got {group.n_sites}")
    device = resolve_device(device)
    BUILD_COUNTERS["bucket_staged_sites"] += 1
    axis_size = collectives.axis_size(mesh, site_axes)
    n_tiles = group.site_n_tiles[0]
    most = int(collectives.pmax(torch.tensor([n_tiles], dtype=torch.int64, device=device),
                                site_axes, mesh)[0])
    cls = shape_class(most, floor) if axis_size > 1 else n_tiles
    stack = _device_stack([group.site_tiles[0]], cls, group, device)
    bucket = TileBucket(n_tiles=cls, slots=(0,), sites=(collectives.axis_index(mesh, site_axes),),
                        tiles=stack)
    return ShardedTileBuckets(axis_size=axis_size, s_local=1, floor=floor, buckets=(bucket,))


# ---------------------------------------------------------------------------
# Stage B: fan-in union rows and the fused level schedule
# ---------------------------------------------------------------------------


def fanin_frontier_rows(
    ca: CompiledAutomaton,
) -> tuple[dict[tuple[int, int, int], int], tuple[tuple[int, ...], ...]]:
    """Fan-in transition grouping: transitions sharing (dst_state,
    direction, label) read ONE frontier row, because under saturating
    counts ``Σ_src f[src] @ A == (Σ_src f[src]) @ A``.

    Returns ``(frow_map, union_members)``: ``frow_map[(dst, direction,
    label_id)]`` is the frontier row-block the group reads — the single
    source state, or a virtual union row ``n_states + u`` whose member
    states are ``union_members[u]``.  Identical source sets share one
    union row across groups."""
    groups: dict[tuple[int, int, int], set[int]] = {}
    for t in ca.transitions:
        groups.setdefault((t.dst, t.direction, t.label_id), set()).add(t.src)
    frow_map: dict[tuple[int, int, int], int] = {}
    union_index: dict[tuple[int, ...], int] = {}
    union_members: list[tuple[int, ...]] = []
    for key in sorted(groups):
        srcs = tuple(sorted(groups[key]))
        if len(srcs) == 1:
            frow_map[key] = srcs[0]
        else:
            if srcs not in union_index:
                union_index[srcs] = len(union_members)
                union_members.append(srcs)
            frow_map[key] = ca.n_states + union_index[srcs]
    return frow_map, tuple(union_members)


def extend_frontier(
    frontier: torch.Tensor,  # (n_states * q_pad, v_pad) f32 0/1
    union_members: tuple[tuple[int, ...], ...],
    n_states: int,
    q_pad: int,
) -> torch.Tensor:
    """Append one virtual row-block per fan-in source union: row-block
    ``n_states + u`` is the elementwise OR (max on {0,1}) of the member
    states' frontiers.  Plain torch outside the kernel; member rows are
    read by integer index, so no index tensor is copied to the device."""
    if not union_members:
        return frontier
    v_pad = frontier.shape[-1]
    fr3 = frontier.reshape(n_states, q_pad, v_pad)
    ext = [fr3] + [
        functools.reduce(torch.maximum, (fr3[s] for s in m)).unsqueeze(0)
        for m in union_members
    ]
    return torch.cat(ext, dim=0).reshape((n_states + len(union_members)) * q_pad, v_pad)


def extend_frontier_sum(
    frontier: torch.Tensor,  # (n_states * q_pad, v_pad) f32 run counts
    union_members: tuple[tuple[int, ...], ...],
    n_states: int,
    q_pad: int,
) -> torch.Tensor:
    """:func:`extend_frontier` on the counting semiring: fan-in union
    rows are the SUM of the member states' count rows, not the max —
    ``Σ_src f[src] @ A`` is literal there (no saturation to hide under).
    Used by :func:`count_paths_bounded`; the boolean fixpoints keep the
    max form."""
    if not union_members:
        return frontier
    v_pad = frontier.shape[-1]
    fr3 = frontier.reshape(n_states, q_pad, v_pad)
    ext = [fr3] + [
        functools.reduce(torch.add, (fr3[s] for s in m)).unsqueeze(0) for m in union_members
    ]
    return torch.cat(ext, dim=0).reshape((n_states + len(union_members)) * q_pad, v_pad)


@dataclasses.dataclass
class FusedLevelPlan:
    """Host-built schedule for :func:`fused_level_blocks`, on the device.

    One step per (fan-in transition group, label, nonzero tile), plus one
    zero-tile cover step per output block no real step writes.  Steps are
    sorted by (dst_state, block_col); ``firsts`` marks each output
    block's first step and ``valids`` the steps that carry a real tile.
    The seven id arrays are byte-identical to ``repro``'s; ``run_ptr`` is
    the port's own: ``run_ptr[k] .. run_ptr[k+1]`` are the steps of output
    block ``k = dst_state · nb + block_col``.  ``work`` is the port's
    too: the work list of kernels B1-B4 (:func:`level_work`), the
    valid steps of every run cut into chunks of at most
    ``work_chunk(tile_dtype)``; the fused and the packed level share it."""

    n_states: int
    n_nodes: int
    v_pad: int
    block_size: int
    q_pad: int
    n_real_steps: int  # steps carrying a real tile (excludes covers)
    union_members: tuple[tuple[int, ...], ...]
    tiles: torch.Tensor  # (n_tiles, B, B); index 0 is the all-zero cover tile
    firsts: torch.Tensor  # (n_steps,) int32 0/1
    valids: torch.Tensor  # (n_steps,) int32 0/1; 0 = cover step, product skipped
    tile_ids: torch.Tensor  # (n_steps,) int32
    f_rows: torch.Tensor  # (n_steps,) int32: src state or union row
    f_cols: torch.Tensor  # (n_steps,) int32: tile block row
    o_rows: torch.Tensor  # (n_steps,) int32: dst automaton state
    o_cols: torch.Tensor  # (n_steps,) int32: tile block col
    run_ptr: torch.Tensor  # (n_states · nb + 1,) int32 run offsets
    work: torch.Tensor  # (n_chunks, work_chunk(tile_dtype)) int32 valid steps, -1 past a chunk's end
    # dtype of the aliased tile store ("f32" or "uint32"); the kernels
    # dispatch off the tensor's dtype, executors check it against theirs
    tile_dtype: str = "f32"
    # the reach_fixpoint* functions' LevelLoops on this plan, with their graphs
    loops: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def release(self) -> None:
        """Free the graphs of this plan's fixpoint loops."""
        for loop in self.loops.values():
            loop.release()
        self.loops.clear()


def required_offset_keys(ca: CompiledAutomaton) -> tuple[tuple[int, int], ...]:
    """The (direction, label) slab keys a Stage-B schedule for ``ca``
    reads: real labels stay themselves, wildcard transitions ground to
    the per-direction ``ANY_LABEL`` union store."""
    keys = {
        (t.direction, t.label_id if t.label_id >= 0 else ANY_LABEL)
        for t in ca.transitions
    }
    return tuple(sorted(keys))


def _schedule_steps(
    ca: CompiledAutomaton,
    offsets: dict[tuple[int, int], tuple[int, np.ndarray, np.ndarray]],
    nb: int,
    frow_map: dict[tuple[int, int, int], int],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Stage-B core: the sorted (orow, ocol, frow, fcol, tid) step table
    for one automaton over one staged offset map, plus ``firsts``,
    ``valids``, and the real-step count.  Pure host indexing — no tile
    packing.  Each fan-in group contributes one pass per tile of its
    label store (the any-label union store for wildcards); labels with
    empty stores contribute nothing."""
    steps: list[tuple[int, int, int, int, int]] = []  # (orow, ocol, frow, fcol, tid)
    for (dst, direction, label_id), frow in sorted(frow_map.items()):
        if label_id >= 0:
            lids = [label_id]
        elif (direction, ANY_LABEL) in offsets:
            lids = [ANY_LABEL]
        else:  # no union store staged
            lids = sorted(l for (d, l) in offsets if d == direction and l >= 0)
        for lid in lids:
            ent = offsets.get((direction, lid))
            if ent is None:
                continue  # empty label store: no edges, nothing to expand
            base, rows, cols = ent
            for j in range(len(rows)):
                steps.append((dst, int(cols[j]), frow, int(rows[j]), base + j))
    n_real = len(steps)

    covered = {(s[0], s[1]) for s in steps}
    for s_dst in range(ca.n_states):
        for cblk in range(nb):
            if (s_dst, cblk) not in covered:
                steps.append((s_dst, cblk, 0, 0, 0))  # zero tile: pure init

    steps.sort(key=lambda s: (s[0], s[1]))
    arr = np.asarray(steps, np.int32).reshape(len(steps), 5)
    firsts = np.ones(len(steps), np.int32)
    if len(steps) > 1:
        same = (arr[1:, 0] == arr[:-1, 0]) & (arr[1:, 1] == arr[:-1, 1])
        firsts[1:][same] = 0
    valids = (arr[:, 4] > 0).astype(np.int32)  # tile 0 = zero cover tile
    return arr, firsts, valids, n_real


def run_offsets(arr: np.ndarray, firsts: np.ndarray, n_states: int, nb: int) -> np.ndarray:
    """``run_ptr``: the CSR offsets of the output-block runs of a step
    table, checked to hold exactly one run per output block, in block
    order — the contract that lets :func:`level_work` cut the runs into
    chunks that each write one output block.  ``repro``'s cover steps
    guarantee it; a schedule that breaks it raises."""
    starts = np.nonzero(firsts)[0]
    blocks = arr[starts, 0].astype(np.int64) * nb + arr[starts, 1]
    if len(starts) != n_states * nb or not (blocks == np.arange(n_states * nb)).all():
        raise ValueError(
            f"schedule holds {len(starts)} runs for {n_states * nb} output blocks: "
            "need exactly one run per output block, in (o_row, o_col) order"
        )
    return np.append(starts, len(firsts)).astype(np.int32)


# valid steps per chunk of kernels B3 and B4 (bit-plane tiles): the
# Alibaba twin's q1/q9/q12 levels hold 241-370 valid steps in runs of up
# to 24, so chunks of 2 give 121-190 CTAs, about one per SM, each with two
# steps' operands (2 KB tiles) in flight
WORK_CHUNK = 2
# valid steps per chunk of kernels B1, B2 and B5 (f32 tiles).  A step there
# moves a 64 KB tile and a 4 KB frontier block (B = 128); a CTA's ring of
# two 34 KB slots holds one step's operands in flight, and three CTAs fit
# on an SM.  Chunks of 1 make a q1, q9 or q12 level 241, 370 or 245 CTAs:
# one wave on 132 SMs (396 slots), every step's tile in flight at once.
# Chunks of 2 would make 124, 188 or 128 CTAs, half the bytes in flight,
# and each CTA would wait for its second tile after its first.
WORK_CHUNK_F32 = 1


def work_chunk(tile_dtype: str) -> int:
    """The chunk length of a level's work list on ``tile_dtype`` tiles."""
    return WORK_CHUNK if tile_dtype == "uint32" else WORK_CHUNK_F32


def level_work(valids: np.ndarray, run_ptr: np.ndarray, chunk: int = WORK_CHUNK) -> np.ndarray:
    """The work list of kernels B1-B5: the valid steps of each
    run, in step order, cut into chunks of at most ``chunk``, each inside
    one run.  Cover steps (``valids == 0``) get no entry, so an output
    block made only of cover steps has no chunk.  Returns (n_chunks,
    chunk) int32 step indices, -1 past a chunk's end; chunk c's output
    block is that of its first step.  Built once per plan or per label
    store, in numpy."""
    steps = np.nonzero(np.asarray(valids))[0]
    run = np.searchsorted(np.asarray(run_ptr), steps, side="right") - 1
    idx = np.arange(len(steps))
    run_start = np.ones(len(steps), bool)
    run_start[1:] = run[1:] != run[:-1]
    rank = idx - np.maximum.accumulate(np.where(run_start, idx, 0))
    chunk_id = np.cumsum(rank % chunk == 0) - 1
    work = np.full((int(chunk_id[-1]) + 1 if len(steps) else 0, chunk), -1, np.int32)
    work[chunk_id, rank % chunk] = steps
    return work


def build_level_schedule(
    ca: CompiledAutomaton, staged: StagedGraph, q_pad: int = QPAD
) -> FusedLevelPlan:
    """Stage B: schedule one fused BFS level for ``ca`` over Stage-A
    artifacts, on the staged tiles' device.  The returned plan *aliases*
    ``staged.tiles`` — zero tile packing, zero tile transfers."""
    BUILD_COUNTERS["level_schedule"] += 1
    nb = staged.v_pad // staged.block_size
    frow_map, union_members = fanin_frontier_rows(ca)
    arr, firsts, valids, n_real = _schedule_steps(ca, staged.offsets, nb, frow_map)
    run_ptr = run_offsets(arr, firsts, ca.n_states, nb)
    dev = staged.tiles.device

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return FusedLevelPlan(
        n_states=ca.n_states,
        n_nodes=staged.n_nodes,
        v_pad=staged.v_pad,
        block_size=staged.block_size,
        q_pad=q_pad,
        n_real_steps=n_real,
        union_members=union_members,
        tiles=staged.tiles,
        firsts=put(firsts),
        valids=put(valids),
        tile_ids=put(arr[:, 4]),
        f_rows=put(arr[:, 2]),
        f_cols=put(arr[:, 3]),
        o_rows=put(arr[:, 0]),
        o_cols=put(arr[:, 1]),
        run_ptr=put(run_ptr),
        work=put(level_work(valids, run_ptr, work_chunk(staged.tile_dtype))),
        tile_dtype=staged.tile_dtype,
    )


def build_level_plan(
    ca: CompiledAutomaton,
    source: LabeledGraph | BlockedGraph | StagedGraph,
    q_pad: int = QPAD,
    block_size: int = 128,
    device: str | torch.device | None = None,
) -> FusedLevelPlan:
    """One-shot wrapper: stage (Stage A, when given a graph or a
    :class:`BlockedGraph`) then schedule (Stage B).  Pass a
    :class:`StagedGraph` to skip straight to Stage B.  ``block_size`` and
    ``device`` are read only for a :class:`LabeledGraph`; the other
    sources carry their own."""
    if isinstance(source, StagedGraph):
        staged = source
    elif isinstance(source, BlockedGraph):
        staged = stage_graph(source)
    else:
        staged = stage_graph(source, block_size, device=device)
    return build_level_schedule(ca, staged, q_pad)


# ---------------------------------------------------------------------------
# Stage B, site-sharded: shape-bucketed per-site schedules and their work lists
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanBucket:
    """One shape bucket of a :class:`ShardedLevelPlan` (``repro``'s
    ``PlanBucket``): the member sites' schedules stacked in row order and
    padded to ``n_steps``.  Padding steps are ``firsts=0, valids=0``
    zero-tile references to the last output block.  The seven
    (rows, n_steps) arrays are byte-identical to ``repro``'s.

    The rest is the port's, for one launch of kernel B1 or B3 over all
    member rows (:func:`~repro_torch.kernels.frontier.frontier.bucket_level_blocks`):
    ``run_ptr`` holds each row's run offsets (:func:`run_offsets`, one run
    per output block, the padding tail inside the last run);
    ``flat_tile_ids`` is ``tile_ids + row · n_tiles``, the ids into the
    flattened (rows · n_tiles, B, ·) stack; ``work`` is the rows' work
    lists (:func:`level_work`) concatenated, each step index offset by
    ``row · n_steps`` into the flattened step arrays.  Padding steps get no
    work entry."""

    n_steps: int  # power-of-two padded grid length (shape class)
    n_tiles: int  # power-of-two padded per-site tile count (shape class)
    slots: tuple[int, ...]  # local site indices in this bucket
    sites: tuple[int, ...]  # global site ids, row by row (group-major)
    tiles: torch.Tensor  # (rows, n_tiles, B, B) f32 or (rows, n_tiles, B, W) int32
    firsts: torch.Tensor  # (rows, n_steps) int32 0/1
    valids: torch.Tensor  # (rows, n_steps) int32 0/1
    tile_ids: torch.Tensor  # (rows, n_steps) int32, into the row's own tiles
    f_rows: torch.Tensor  # (rows, n_steps) int32
    f_cols: torch.Tensor  # (rows, n_steps) int32
    o_rows: torch.Tensor  # (rows, n_steps) int32
    o_cols: torch.Tensor  # (rows, n_steps) int32
    run_ptr: torch.Tensor  # (rows, n_states · nb + 1) int32 per-row run offsets
    flat_tile_ids: torch.Tensor  # (rows · n_steps,) int32
    work: torch.Tensor  # (n_chunks, work_chunk(tile_dtype)) int32 flattened steps, -1 past a chunk's end


@dataclasses.dataclass
class ShardedLevelPlan:
    """Per-site fused level schedules, shape-bucketed (``repro``'s
    ``ShardedLevelPlan``): each site is scheduled over its own staged
    offsets and padded only to its bucket's power-of-two grid length, so
    padding waste stops growing with the site count.  ``union_members``
    is the fan-in union row layout every site shares (the frontier is
    extended once per level with :func:`extend_frontier`)."""

    n_sites: int
    n_states: int
    n_nodes: int
    v_pad: int
    block_size: int
    q_pad: int
    axis_size: int
    union_members: tuple[tuple[int, ...], ...]
    buckets: tuple[PlanBucket, ...]
    n_real_steps: tuple[int, ...]  # per site: steps carrying a real tile
    useful_steps: int  # Σ per-site unpadded schedule lengths
    padded_steps: int  # Σ per-bucket rows × n_steps (executed grid slots)
    tile_dtype: str = "f32"  # dtype of the aliased bucket tile stacks

    @property
    def pad_waste_ratio(self) -> float:
        return self.padded_steps / max(self.useful_steps, 1)

    @property
    def bucket_shapes(self) -> tuple[tuple[int, int, int], ...]:
        """Per bucket: (n_steps class, n_tiles class, member rows)."""
        return tuple((b.n_steps, b.n_tiles, len(b.sites)) for b in self.buckets)


def bucket_work(
    valids: np.ndarray, firsts: np.ndarray, o_rows: np.ndarray, o_cols: np.ndarray,
    n_states: int, nb: int, chunk: int,
) -> tuple[np.ndarray, np.ndarray]:
    """A bucket's run offsets and its one work list, from its (rows,
    n_steps) step arrays: each row's run offsets are checked by
    :func:`run_offsets` (one run per output block) and cut into chunks by
    :func:`level_work`, and the rows' chunks are concatenated with their
    step indices offset by ``row · n_steps``.  Several chunks of one list
    then write one output block, one per member row that reaches it: the
    level kernels add every chunk into a zeroed output with atomics, so
    the launch sums the members' levels."""
    rows, n_steps = valids.shape
    run_ptr = np.stack([
        run_offsets(np.stack([o_rows[r], o_cols[r]], axis=1), firsts[r], n_states, nb)
        for r in range(rows)
    ])
    lists = []
    for r in range(rows):
        w = level_work(valids[r], run_ptr[r], chunk)
        lists.append(np.where(w >= 0, w + r * n_steps, -1).astype(np.int32))
    return run_ptr, np.concatenate(lists) if lists else np.zeros((0, chunk), np.int32)


def build_sharded_level_schedule(
    ca: CompiledAutomaton,
    staged: StagedShardedGraph,
    tile_buckets: ShardedTileBuckets | None = None,
    q_pad: int = QPAD,
    axis_size: int = 1,
    bucket_floor: int = BUCKET_FLOOR,
    device: str | torch.device | None = None,
) -> ShardedLevelPlan:
    """Stage B per site over the staged slabs, bucketed into power-of-two
    shape classes (``repro``'s ``build_sharded_level_schedule``).
    ``tile_buckets`` accepts the Stage-A shape buckets (e.g. from
    :class:`repro_torch.core.plans.GraphPlanStore`); without them they are
    built here on ``device``.  The plan aliases the bucket tile stacks and
    lives on their device; each bucket also carries its work list
    (:func:`bucket_work`)."""
    BUILD_COUNTERS["sharded_level_schedule"] += 1
    if tile_buckets is None:
        tile_buckets = bucket_staged_sites(staged, axis_size, bucket_floor, device)
    nb = staged.v_pad // staged.block_size
    frow_map, union_members = fanin_frontier_rows(ca)
    site_steps = [_schedule_steps(ca, offsets, nb, frow_map) for offsets in staged.site_offsets]
    buckets = []
    useful = sum(arr.shape[0] for arr, _, _, _ in site_steps)
    padded = 0
    for tb in tile_buckets.buckets:
        max_len = max(site_steps[s][0].shape[0] for s in tb.sites)
        # singleton buckets run at natural length: the roundup only buys
        # shape agreement between members
        n_steps = shape_class(max_len, tile_buckets.floor) if len(tb.sites) > 1 else max_len
        padded += n_steps * len(tb.sites)
        buckets.append(_plan_bucket(ca, tb, [site_steps[s] for s in tb.sites], n_steps, nb,
                                    staged.tile_dtype))
    return ShardedLevelPlan(
        n_sites=staged.n_sites,
        n_states=ca.n_states,
        n_nodes=staged.n_nodes,
        v_pad=staged.v_pad,
        block_size=staged.block_size,
        q_pad=q_pad,
        axis_size=tile_buckets.axis_size,
        union_members=union_members,
        buckets=tuple(buckets),
        n_real_steps=tuple(n_real for _, _, _, n_real in site_steps),
        useful_steps=useful,
        padded_steps=padded,
        tile_dtype=staged.tile_dtype,
    )


def _plan_bucket(ca: CompiledAutomaton, tb: TileBucket, rows_steps: list, n_steps: int, nb: int,
                 tile_dtype: str) -> PlanBucket:
    """One :class:`PlanBucket` on ``tb``'s device: each row's step table
    (:func:`_schedule_steps`) padded to ``n_steps``, the rows' run offsets
    and one work list (:func:`bucket_work`), and the flattened tile ids."""

    def pad_steps(col: np.ndarray, fill: int) -> np.ndarray:
        return np.concatenate([col, np.full(n_steps - len(col), fill, np.int32)])

    cols = {k: [] for k in ("fi", "vl", "ti", "fr", "fc", "orw", "oc")}
    for arr, fi, vl, _ in rows_steps:
        cols["fi"].append(pad_steps(fi, 0))
        cols["vl"].append(pad_steps(vl, 0))
        cols["ti"].append(pad_steps(arr[:, 4], 0))  # zero cover tile
        cols["fr"].append(pad_steps(arr[:, 2], 0))
        cols["fc"].append(pad_steps(arr[:, 3], 0))
        cols["orw"].append(pad_steps(arr[:, 0], ca.n_states - 1))
        cols["oc"].append(pad_steps(arr[:, 1], nb - 1))
    host = {k: np.stack(v) for k, v in cols.items()}
    run_ptr, work = bucket_work(
        host["vl"], host["fi"], host["orw"], host["oc"], ca.n_states, nb, work_chunk(tile_dtype),
    )
    offsets = (np.arange(len(rows_steps), dtype=np.int32) * tb.n_tiles)[:, None]
    dev = tb.tiles.device

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return PlanBucket(
        n_steps=n_steps, n_tiles=tb.n_tiles, slots=tb.slots, sites=tb.sites, tiles=tb.tiles,
        firsts=put(host["fi"]), valids=put(host["vl"]), tile_ids=put(host["ti"]),
        f_rows=put(host["fr"]), f_cols=put(host["fc"]), o_rows=put(host["orw"]),
        o_cols=put(host["oc"]), run_ptr=put(run_ptr),
        flat_tile_ids=put((host["ti"] + offsets).reshape(-1)), work=put(work),
    )


def build_rank_level_schedule(
    ca: CompiledAutomaton,
    group: StagedShardedGraph,
    tile_buckets: ShardedTileBuckets,
    mesh,
    site_axes=("data",),
    q_pad: int = QPAD,
) -> ShardedLevelPlan:
    """:func:`build_sharded_level_schedule` for one rank of a mesh, on its
    one group slab and :func:`bucket_rank_group`'s bucket: the bucket's
    grid length is the roundup of the longest group schedule, agreed by an
    ``all_reduce(MAX)`` over ``site_axes`` (a single group keeps its
    natural length), so the plan's bucket arrays are the rank's row of the
    one-card plan at the same axis size (``work`` and ``flat_tile_ids``
    index the rank's one row)."""
    BUILD_COUNTERS["sharded_level_schedule"] += 1
    nb = group.v_pad // group.block_size
    frow_map, union_members = fanin_frontier_rows(ca)
    steps = _schedule_steps(ca, group.site_offsets[0], nb, frow_map)
    (tb,) = tile_buckets.buckets
    length = steps[0].shape[0]
    dev = tb.tiles.device
    most = int(collectives.pmax(torch.tensor([length], dtype=torch.int64, device=dev),
                                site_axes, mesh)[0])
    n_steps = shape_class(most, tile_buckets.floor) if tile_buckets.axis_size > 1 else length
    return ShardedLevelPlan(
        n_sites=1,
        n_states=ca.n_states,
        n_nodes=group.n_nodes,
        v_pad=group.v_pad,
        block_size=group.block_size,
        q_pad=q_pad,
        axis_size=tile_buckets.axis_size,
        union_members=union_members,
        buckets=(_plan_bucket(ca, tb, [steps], n_steps, nb, group.tile_dtype),),
        n_real_steps=(steps[3],),
        useful_steps=length,
        padded_steps=n_steps,
        tile_dtype=group.tile_dtype,
    )


def build_sharded_level_plan(
    ca: CompiledAutomaton,
    site_graphs: list[LabeledGraph] | StagedShardedGraph,
    block_size: int = 128,
    q_pad: int = QPAD,
    axis_size: int = 1,
    bucket_floor: int = BUCKET_FLOOR,
    device: str | torch.device | None = None,
) -> ShardedLevelPlan:
    """One-shot wrapper: stage every site (Stage A), bucket the slabs on
    ``device``, then schedule (Stage B).  Pass a
    :class:`StagedShardedGraph` to skip straight to bucketing and Stage B."""
    staged = (
        site_graphs
        if isinstance(site_graphs, StagedShardedGraph)
        else stage_sharded_graph(site_graphs, block_size)
    )
    return build_sharded_level_schedule(
        ca, staged, q_pad=q_pad, axis_size=axis_size, bucket_floor=bucket_floor, device=device
    )


# ---------------------------------------------------------------------------
# Fused level and fixpoint
# ---------------------------------------------------------------------------


def level_counts(plan: FusedLevelPlan, extended: torch.Tensor) -> torch.Tensor:
    """One fused level launch on ``plan``: the raw f32 sums
    (n_states · q_pad, v_pad) of a frontier that already carries its
    fan-in union rows (:func:`extend_frontier` or
    :func:`extend_frontier_sum`)."""
    return fused_level_blocks(
        extended, plan.tiles, plan.firsts, plan.valids, plan.tile_ids,
        plan.f_rows, plan.f_cols, plan.o_rows, plan.o_cols,
        plan.block_size, plan.q_pad,
        n_out_rows=plan.n_states * plan.q_pad, run_ptr=plan.run_ptr, work=plan.work,
    )


def expand_level_fused(plan: FusedLevelPlan, frontier: torch.Tensor) -> torch.Tensor:
    """One BFS level over all grounded transitions — ONE kernel launch,
    on either tile store.  ``frontier`` is (n_states · q_pad, v_pad) f32
    0/1; returns the same shape, thresholded to 0/1."""
    fre = extend_frontier(frontier, plan.union_members, plan.n_states, plan.q_pad)
    return torch.clamp(level_counts(plan, fre), max=1.0)


def expand_level_sharded(
    plan: ShardedLevelPlan, frontier: torch.Tensor, mesh=None, site_axes=("data",)
) -> torch.Tensor:
    """One BFS level over every site's grid: the frontier is extended
    once, each bucket runs ONE kernel launch over its members' work lists
    (B1 on f32 tiles, B3 on bit-planes; the launch sums its members'
    levels), and the buckets are max-merged and clamped to {0, 1} — the
    synchronous OR merge of every site's discoveries, ``repro``'s per-level
    ``pmax`` form.  On a ``mesh`` the plan is one rank's
    (:func:`build_rank_level_schedule`) and the clamped level is then
    ``pmax``-ed over ``site_axes`` as uint8, so every rank of the site
    group holds the same merged level.  ``frontier`` is (n_states · q_pad,
    v_pad) f32 0/1."""
    fre = extend_frontier(frontier, plan.union_members, plan.n_states, plan.q_pad)
    merged = None
    for b in plan.buckets:
        counts = bucket_level_blocks(
            fre, b.tiles, b.firsts, b.valids, b.tile_ids, b.f_rows, b.f_cols, b.o_rows, b.o_cols,
            plan.block_size, plan.q_pad, n_out_rows=plan.n_states * plan.q_pad,
            run_ptr=b.run_ptr, work=b.work, flat_tile_ids=b.flat_tile_ids,
        )
        merged = counts if merged is None else torch.maximum(merged, counts)
    level = torch.clamp(merged, max=1.0)
    if mesh is None:
        return level
    return collectives.pmax(level.to(torch.uint8), site_axes, mesh).to(level.dtype)


def frontier_nonempty(frontier: torch.Tensor) -> bool:
    """``(frontier != 0).any()`` read on the host — f32 0/1 rows and int32
    lane words alike (a word with only bit 31 set is negative): the
    per-transition baseline's one host sync per level, counted in
    :data:`FIXPOINT_COUNTERS`."""
    FIXPOINT_COUNTERS["host_syncs"] += 1
    return bool(frontier.any())


def stamp_levels(levmap: torch.Tensor, new: torch.Tensor, lev) -> torch.Tensor:
    """The witness plane with the states in ``new`` (a bool mask) stamped
    at ``lev + 2``: level 1 is the start, so the expansion after ``lev``
    levels reaches level ``lev + 2``.  ``lev`` is a host int (a
    shape-only level, :func:`host_loop`: filled in place) or a device
    int32 0-d tensor (a :class:`LevelLoop` body: a new plane, no host
    read)."""
    if isinstance(lev, torch.Tensor):
        return torch.where(new, (lev + 2).to(levmap.dtype), levmap)
    return levmap.masked_fill_(new, lev + 2.0)


def host_loop(level, state: tuple, levels: int) -> tuple:
    """A shape-only fixpoint (a meta frontier, which has no values):
    exactly one level, as XLA's cost analysis counts a ``while`` body once
    (``tests/test_torch_launch.py`` checks it), ``lev`` the host int 0.
    Every fixpoint with values runs on a :class:`LevelLoop`."""
    if not state[0].is_meta:
        raise ValueError("host_loop runs shape-only (meta) fixpoints; a fixpoint with values runs on a LevelLoop")
    if levels > 0:
        state = level(state, 0)
        FIXPOINT_COUNTERS["levels"] += 1
    return state


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    static: tuple  # the body's carry, read and written in place by each replay
    launches: dict  # the level kernels the body launches, by launch_counts() name
    wire: collectives.Recorded  # the all_reduces the body makes (a per-rank level's pmax)


# LevelLoop modes: "graph" captures the body in a CUDA graph on a card;
# "eager" never captures; "gloo" never captures and runs
# LEVELS_PER_CHECK_GLOO levels a body
LOOP_MODES = ("graph", "eager", "gloo")


class LevelLoop:
    """A fixpoint's level loop with its state on the device, read by the
    host once per k levels: ``repro``'s ``lax.while_loop``.

    ``level(state, lev)`` runs one BFS level: ``state`` is a tuple of
    tensors whose first is the frontier, ``lev`` the levels run before
    it (an int32 0-d tensor on the device), and it returns the next
    state and reads nothing on the host.  A body runs k levels, each
    gated by an "active" flag on the device, "the frontier is nonempty
    and ``lev < levels``": the frontier is multiplied by the flag before
    the level and ``lev`` grows by it, so a level after convergence or
    past ``levels`` expands an empty frontier and adds nothing (no new
    state, no meter count, no witness stamp).  After each body the host
    reads the flag and ``lev`` in one sync and stops when the flag is
    down; ``lev`` is then the fixpoint's BFS levels, at most ``levels``.
    A fixpoint of L levels reads max(1, ⌈L / k⌉) times.

    A per-rank level (``repro``'s ``shard_map`` body) ends in a ``pmax``
    of the frontier over the site axes, so the flag, read from the merged
    frontier, is the same on every rank of the site group: its ranks run
    the same bodies and leave after the same one, with no collective for
    the flag, as ``repro``'s ``cond`` reads the merged frontier.

    ``mode`` (:data:`LOOP_MODES`) says how a body runs:

    * ``"graph"`` (k = :data:`LEVELS_PER_CHECK`): on a CUDA device the
      body is captured once per k in a CUDA graph, on a side stream
      (``capture_error_mode="thread_local"``: another thread's CUDA calls
      do not break it; the thread's cyclic garbage collector is off
      meanwhile), after one eager body that loads the kernels, raises
      their shared-memory limits and, on an NCCL rank, makes the
      communicator and the cached groups of the level's collectives (no
      ``new_group`` runs inside a capture); each run copies its start
      state into the graph's static carry and replays, and returns copies
      of the final state.  A capture or a replay that fails raises: there
      is no fallback.  The launches and the ``all_reduce`` calls that a
      capture records count at each replay (``frontier.add_launches``,
      ``collectives.add_wire``).  On the CPU, and on a card under
      :data:`EAGER`, the same body runs eagerly.
    * ``"eager"`` (k = :data:`LEVELS_PER_CHECK`): the body runs eagerly on
      a card too, for a loop whose graph would be captured once per run
      (S1's BFS, on a new device graph every request).
    * ``"gloo"`` (k = :data:`LEVELS_PER_CHECK_GLOO`): eagerly, for a
      per-rank level whose ``pmax`` runs on a ``gloo`` group, which no
      CUDA graph captures and whose ``all_reduce`` waits on the host.

    The per-rank executors pick ``"graph"`` or ``"gloo"`` from their site
    group's backend when they are built.  ``counters`` takes the loop's
    counts (:data:`FIXPOINT_COUNTERS`: ``levels``, ``bodies``,
    ``host_syncs``, ``fixpoints``, ``replays``, ``captures``,
    ``all_reduces``).  A lock serialises runs (one static carry per
    graph); :meth:`release` frees the graphs and their static carries."""

    def __init__(self, level, levels: int, mode: str = "graph", counters: collections.Counter | None = None):
        if mode not in LOOP_MODES:
            raise ValueError(f"mode {mode!r} is not one of {LOOP_MODES}")
        self.level = level
        self.levels = min(int(levels), 2**31 - 1)
        self.mode = mode
        self.counters = FIXPOINT_COUNTERS if counters is None else counters
        self._graphs: dict[int, _Captured] = {}
        self._lock = threading.Lock()

    def _body(self, k: int, carry: tuple) -> tuple:
        act, lev, *state = carry
        for _ in range(k):
            state = self.level((state[0] * act.to(state[0].dtype), *state[1:]), lev)
            lev = lev + act.to(lev.dtype)
            act = state[0].ne(0).any() & (lev < self.levels)
        return (act, lev, *state)

    def _capture(self, k: int, carry: tuple) -> _Captured:
        dev = carry[0].device
        static = tuple(t.clone() for t in carry)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        # no cyclic garbage collection in this thread while it captures: a
        # collected executor's graph would be destroyed inside the capture,
        # which invalidates it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with fkernel.recording_launches() as launches, collectives.recording_wire() as wire, \
                    torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    for s, o in zip(static, self._body(k, static)):
                        if o is not s:
                            s.copy_(o)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.counters["captures"] += 1
        return _Captured(graph, static, dict(launches), wire)

    def run(self, state: tuple) -> tuple:
        """The fixpoint from ``state``: the final state, the same layout."""
        dev = state[0].device
        act = (state[0].ne(0).any() if self.levels > 0
               else torch.zeros((), dtype=torch.bool, device=dev))
        carry = (act, torch.zeros((), dtype=torch.int32, device=dev), *state)
        k = LEVELS_PER_CHECK_GLOO if self.mode == "gloo" else LEVELS_PER_CHECK
        graphed = self.mode == "graph" and dev.type == "cuda" and not EAGER
        counters = self.counters
        with self._lock:
            wire0 = collectives.WIRE_COUNTERS["all_reduces"]
            entry = self._graphs.get(k) if graphed else None
            if entry is not None:
                for s, c in zip(entry.static, carry):
                    s.copy_(c)
                carry = entry.static
            while True:
                if entry is not None:
                    entry.graph.replay()
                    fkernel.add_launches(entry.launches)
                    collectives.add_wire(entry.wire)
                    counters["replays"] += 1
                else:
                    carry = self._body(k, carry)
                    if graphed:
                        entry = self._graphs[k] = self._capture(k, carry)
                        carry = entry.static
                counters["bodies"] += 1
                counters["host_syncs"] += 1
                active, lev = torch.stack((carry[0].to(torch.int32), carry[1])).tolist()
                if not active:
                    break
            counters["levels"] += lev
            counters["fixpoints"] += 1
            if collectives.WIRE_COUNTERS["all_reduces"] > wire0:
                counters["all_reduces"] += collectives.WIRE_COUNTERS["all_reduces"] - wire0
            final = carry[2:]
            return tuple(t.clone() for t in final) if entry is not None else tuple(final)

    def release(self) -> None:
        """Free the CUDA graphs and their static carries."""
        with self._lock:
            for entry in self._graphs.values():
                entry.graph.reset()
            self._graphs.clear()


def _plan_loop(plan: "FusedLevelPlan", kind: str, level, levels: int) -> LevelLoop:
    """The plan's :class:`LevelLoop` of fixpoint ``kind`` at ``levels``,
    made at first use and kept on the plan, with its graphs."""
    key = (kind, levels)
    loop = plan.loops.get(key)
    if loop is None:
        loop = plan.loops[key] = LevelLoop(level, levels)
    return loop


def reach_fixpoint(
    plan: FusedLevelPlan,
    frontier0: torch.Tensor,  # (n_states * q_pad, v_pad) f32 0/1
    max_levels: int = 64,
) -> torch.Tensor:
    """Visited product states (same layout as ``frontier0``) at fixpoint,
    on the plan's :class:`LevelLoop`."""

    def level(state, lev):
        frontier, visited = state
        new = expand_level_fused(plan, frontier) * (1.0 - visited)  # exact on {0,1} floats
        return new, torch.maximum(visited, new)

    return _plan_loop(plan, "reach", level, max_levels).run((frontier0, frontier0))[1]


def _require_f32_tiles(plan: FusedLevelPlan, what: str) -> None:
    """The uint32 tile store carries one boolean bit per edge slot — a
    contract the witness-level and counting entry points refuse rather
    than silently extend: callers wanting those semirings restage at
    ``tile_dtype="f32"`` (the S2 executor's witness semantics does
    exactly that — see :mod:`repro_torch.core.strategies`)."""
    if plan.tile_dtype != "f32":
        raise ValueError(
            f"{what} requires the f32 tile store; this plan aliases the "
            f"boolean-only tile_dtype={plan.tile_dtype!r} staging — restage "
            "with tile_dtype='f32' or use the boolean fixpoints"
        )


def initial_levels(started: torch.Tensor) -> torch.Tensor:
    """The discovery-level plane of a fixpoint's start: 1 where
    ``started`` is true, :data:`~repro_torch.core.witness.INF_LEVEL`
    elsewhere, f32."""
    levels = torch.full(started.shape, float(INF_LEVEL), dtype=torch.float32, device=started.device)
    return levels.masked_fill_(started, 1.0)


def reach_fixpoint_levels(
    plan: FusedLevelPlan,
    frontier0: torch.Tensor,  # (n_states * q_pad, v_pad) f32 0/1
    max_levels: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`reach_fixpoint` + BFS discovery levels (same layout, f32,
    ``INF_LEVEL`` = unreached) for host-side witness reconstruction:
    start pairs at level 1, a pair first reached by expansion ``i`` at
    level ``i + 1``.  Refuses a ``tile_dtype="uint32"`` plan
    (boolean-only store)."""
    _require_f32_tiles(plan, "reach_fixpoint_levels")

    def level(state, lev):
        frontier, visited, levels = state
        new = expand_level_fused(plan, frontier) * (1.0 - visited)  # exact on {0,1} floats
        return new, torch.maximum(visited, new), stamp_levels(levels, new > 0, lev)

    state = (frontier0, frontier0, initial_levels(frontier0 > 0))
    return _plan_loop(plan, "levels", level, max_levels).run(state)[1:]


def count_paths_bounded(
    plan: FusedLevelPlan,
    frontier0: torch.Tensor,  # (n_states * q_pad, v_pad) f32 start counts
    accepting: tuple[int, ...],
    n_levels: int,
) -> torch.Tensor:
    """Bounded-length counting-semiring sum over the SAME Stage-B level
    schedule the boolean fixpoint runs: drop the saturating ``min(·, 1)``
    clamp so the fused tile products accumulate run counts, sum fan-in
    unions instead of maxing them (:func:`extend_frontier_sum`), and
    total the accepting rows after every one of ``n_levels`` expansions.
    Returns (q_pad, v_pad) f32: per stacked query, the number of
    accepting *runs* of length ≤ ``n_levels`` from its starts to each
    node (see :func:`repro_torch.core.witness.count_paths`, the host
    oracle).  ``n_levels`` level launches, no host sync.

    Caveats, as ``repro``'s: counts are exact f32 integers only below
    2**24 — the level kernel adds its chunks' sums with atomics in no
    fixed order, which is exact only there — so bound the length
    accordingly; and wildcard transitions ride the saturated any-label
    union store, so a wildcard hop counts parallel edges that carry
    different labels once, not per label — match the oracle on
    wildcard-free automata.  Refuses a ``tile_dtype="uint32"`` plan
    (the counting semiring is contracted to the f32 store)."""
    _require_f32_tiles(plan, "count_paths_bounded")
    n_states, q_pad = plan.n_states, plan.q_pad

    def accept_sum(counts: torch.Tensor) -> torch.Tensor:
        c3 = counts.reshape(n_states, q_pad, -1)
        return functools.reduce(torch.add, (c3[qf] for qf in accepting))

    counts = frontier0
    total = accept_sum(counts)
    for _ in range(n_levels):
        fre = extend_frontier_sum(counts, plan.union_members, n_states, q_pad)
        counts = level_counts(plan, fre)
        total = total + accept_sum(counts)
        FIXPOINT_COUNTERS["levels"] += 1
    return total


def stack_start_masks(
    plan: FusedLevelPlan, start_state: int, start_masks: np.ndarray
) -> np.ndarray:
    """Pack Q ≤ q_pad per-query start masks (Q, n_nodes) into the fused
    frontier layout (n_states * q_pad, v_pad): row s·q_pad + q is query
    q's frontier for automaton state s."""
    q = start_masks.shape[0]
    if q > plan.q_pad:
        raise ValueError(f"at most q_pad={plan.q_pad} stacked queries, got {q}")
    f0 = np.zeros((plan.n_states, plan.q_pad, plan.v_pad), np.float32)
    f0[start_state, :q, : start_masks.shape[1]] = start_masks
    return f0.reshape(plan.n_states * plan.q_pad, plan.v_pad)


def multi_query_reach(
    ca: CompiledAutomaton,
    bg: BlockedGraph | StagedGraph,
    start_masks: np.ndarray,  # (Q, n_nodes) f32 0/1 — one row per query
    max_levels: int = 64,
    plan: FusedLevelPlan | None = None,
) -> np.ndarray:
    """Fixpoint reachability for Q stacked queries; returns (Q, n_nodes)
    bool answer masks (nodes reached in an accepting state, per query).
    Queries ride the q_pad row dim in chunks of 8, one fixpoint per
    chunk, on the tiles' device.  Without a ``plan`` one is built
    (:func:`build_level_plan`: a :class:`BlockedGraph` is staged first)."""
    start_masks = np.atleast_2d(np.asarray(start_masks, np.float32))
    if plan is None:
        plan = build_level_plan(ca, bg)
    n_q = start_masks.shape[0]
    out = np.zeros((n_q, bg.n_nodes), bool)
    for lo in range(0, n_q, plan.q_pad):
        chunk = start_masks[lo : lo + plan.q_pad]
        f0 = torch.from_numpy(stack_start_masks(plan, ca.start, chunk)).to(plan.tiles.device)
        visited = reach_fixpoint(plan, f0, max_levels).reshape(
            plan.n_states, plan.q_pad, plan.v_pad
        )
        acc = torch.zeros_like(visited[0])
        for qf in ca.accepting:
            acc = torch.maximum(acc, visited[qf])
        out[lo : lo + chunk.shape[0]] = acc[: chunk.shape[0], : bg.n_nodes].cpu().numpy() > 0
    return out


def multi_source_reach(
    ca: CompiledAutomaton,
    bg: BlockedGraph | StagedGraph,
    start_mask: np.ndarray,
    max_levels: int = 64,
    plan: FusedLevelPlan | None = None,
) -> np.ndarray:
    """Single-query fixpoint reachability on the fused level kernel."""
    return multi_query_reach(
        ca, bg, np.asarray(start_mask, np.float32)[None, :],
        max_levels=max_levels, plan=plan,
    )[0]


# ---------------------------------------------------------------------------
# Lane-packed path: 256 query lanes per fixpoint (int32 lane words)
# ---------------------------------------------------------------------------


def pack_lane_masks(masks: np.ndarray) -> np.ndarray:
    """Pack Q ≤ QPACK per-lane 0/1 masks (Q, n) into QPAD uint32 word
    rows (QPAD, n): lane q lands in word row ``q // 32``, bit ``q % 32``.
    Lanes past Q stay zero — the cross-lane leakage invariant starts
    here and the bitwise level/fixpoint ops preserve it."""
    masks = np.atleast_2d(np.asarray(masks))
    q, n = masks.shape
    if q > QPACK:
        raise ValueError(f"at most QPACK={QPACK} packed lanes, got {q}")
    words = np.zeros((QPAD, n), np.uint32)
    bits = masks != 0
    for lane in range(q):
        words[lane // 32] |= bits[lane].astype(np.uint32) << np.uint32(lane % 32)
    return words


def unpack_lane_words(words: np.ndarray, n_lanes: int) -> np.ndarray:
    """Inverse of :func:`pack_lane_masks`: the first ``n_lanes`` lanes of
    (QPAD, n) word rows, uint32 or the port's int32, as (n_lanes, n) bool."""
    words = np.asarray(words).view(np.uint32)
    out = np.zeros((n_lanes, words.shape[1]), bool)
    for lane in range(n_lanes):
        out[lane] = (words[lane // 32] >> np.uint32(lane % 32)) & 1 != 0
    return out


def stack_start_masks_packed(
    plan: FusedLevelPlan, start_state: int, start_masks: np.ndarray
) -> np.ndarray:
    """Pack Q ≤ QPACK per-query start masks (Q, n_nodes) into the packed
    frontier layout (n_states * q_pad, v_pad) uint32: word row
    s·q_pad + w carries lanes [32w, 32w+32) of automaton state s.  The
    caller views it as int32 to hand it to torch."""
    q = start_masks.shape[0]
    if q > QPACK:
        raise ValueError(f"at most QPACK={QPACK} stacked queries, got {q}")
    f0 = np.zeros((plan.n_states, plan.q_pad, plan.v_pad), np.uint32)
    f0[start_state, :, : start_masks.shape[1]] = pack_lane_masks(start_masks)
    return f0.reshape(plan.n_states * plan.q_pad, plan.v_pad)


def stack_start_nodes_packed(
    plan: FusedLevelPlan, start_state: int, start_nodes: np.ndarray
) -> np.ndarray:
    """:func:`stack_start_masks_packed` of one-hot masks, lane q starting
    at node ``start_nodes[q]``, scattered straight into the words: O(Q)
    host work where packing (Q, n_nodes) masks is O(Q · n_nodes).  Lanes
    carry distinct bits, so OR-scattering two lanes onto one node keeps
    both."""
    q = len(start_nodes)
    if q > QPACK:
        raise ValueError(f"at most QPACK={QPACK} stacked queries, got {q}")
    lanes = np.arange(q)
    f0 = np.zeros((plan.n_states, plan.q_pad, plan.v_pad), np.uint32)
    bits = np.uint32(1) << (lanes % 32).astype(np.uint32)
    np.bitwise_or.at(f0, (start_state, lanes // 32, np.asarray(start_nodes)), bits)
    return f0.reshape(plan.n_states * plan.q_pad, plan.v_pad)


def extend_frontier_packed(
    frontier: torch.Tensor,  # (n_states * q_pad, v_pad) int32 lane words
    union_members: tuple[tuple[int, ...], ...],
    n_states: int,
    q_pad: int,
) -> torch.Tensor:
    """:func:`extend_frontier` on lane words: the fan-in union of member
    states is the bitwise OR of their word rows (each query lane unions
    independently in its own bit).  torch has no bitwise-OR reduction,
    so the members fold pairwise."""
    if not union_members:
        return frontier
    v_pad = frontier.shape[-1]
    fr3 = frontier.reshape(n_states, q_pad, v_pad)
    ext = [fr3] + [
        functools.reduce(torch.bitwise_or, (fr3[s] for s in m)).unsqueeze(0)
        for m in union_members
    ]
    return torch.cat(ext, dim=0).reshape((n_states + len(union_members)) * q_pad, v_pad)


def expand_level_packed(plan: FusedLevelPlan, frontier: torch.Tensor) -> torch.Tensor:
    """One packed BFS level over all grounded transitions — ONE kernel
    launch on the SAME Stage-B plan and work list the f32 path uses, on
    either tile store.  ``frontier`` is (n_states · q_pad, v_pad) int32 lane words;
    returns the OR-accumulated words, boolean per bit already."""
    fre = extend_frontier_packed(frontier, plan.union_members, plan.n_states, plan.q_pad)
    return packed_level_blocks(
        fre, plan.tiles, plan.firsts, plan.valids, plan.tile_ids,
        plan.f_rows, plan.f_cols, plan.o_rows, plan.o_cols,
        plan.block_size, plan.q_pad,
        n_out_rows=plan.n_states * plan.q_pad, run_ptr=plan.run_ptr, work=plan.work,
    )


def reach_fixpoint_packed(
    plan: FusedLevelPlan,
    frontier0: torch.Tensor,  # (n_states * q_pad, v_pad) int32 lane words
    max_levels: int = 64,
) -> torch.Tensor:
    """Visited lane words (same layout as ``frontier0``) at fixpoint: all
    256 lanes advance together, ``new = nxt & ~visited`` per bit, and the
    loop ends when every word of the frontier is zero."""

    def level(state, lev):
        frontier, visited = state
        new = expand_level_packed(plan, frontier) & ~visited
        return new, visited | new

    return _plan_loop(plan, "packed", level, max_levels).run((frontier0, frontier0))[1]


def lane_states(words: torch.Tensor, n_states: int) -> torch.Tensor:
    """Packed lane words (n_states · q_pad, v_pad) as a bool mask
    (n_states, q_pad · 32, v_pad): lane q of word row ``q // 32``, bit
    ``q % 32``, at row q of its state — the layout of the packed level
    plane."""
    return unpack_lane_rows(words).reshape(n_states, -1, words.shape[-1]) > 0


def reach_fixpoint_packed_levels(
    plan: FusedLevelPlan,
    frontier0: torch.Tensor,  # (n_states * q_pad, v_pad) int32 lane words
    max_levels: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`reach_fixpoint_packed` + per-lane discovery levels: returns
    (visited lane words, levels) where levels is (n_states, QPACK, v_pad)
    f32 — lane q of word row ``q // 32``, bit ``q % 32`` unpacks to level
    row q, 32× the lane words' bytes.  The newly set bits of each
    expansion are unpacked to stamp their lanes' levels.  Refuses a
    ``tile_dtype="uint32"`` plan (witness levels are contracted to the
    f32 store)."""
    _require_f32_tiles(plan, "reach_fixpoint_packed_levels")

    def level(state, lev):
        frontier, visited, levels = state
        new = expand_level_packed(plan, frontier) & ~visited
        return new, visited | new, stamp_levels(levels, lane_states(new, plan.n_states), lev)

    state = (frontier0, frontier0, initial_levels(lane_states(frontier0, plan.n_states)))
    return _plan_loop(plan, "packed_levels", level, max_levels).run(state)[1:]


def multi_query_reach_packed(
    ca: CompiledAutomaton,
    staged: StagedGraph,
    start_masks: np.ndarray,  # (Q, n_nodes) 0/1 — one row per query lane
    max_levels: int = 64,
    plan: FusedLevelPlan | None = None,
) -> np.ndarray:
    """Fixpoint reachability for Q lane-packed queries; returns (Q,
    n_nodes) bool answer masks, bit-exact against :func:`multi_query_reach`.
    Queries ride the bit axis in chunks of QPACK = 256, one fixpoint per
    chunk, on the staged tiles' device; the same ``plan`` serves both."""
    start_masks = np.atleast_2d(np.asarray(start_masks))
    if plan is None:
        plan = build_level_schedule(ca, staged)
    n_q = start_masks.shape[0]
    out = np.zeros((n_q, staged.n_nodes), bool)
    for lo in range(0, n_q, QPACK):
        chunk = start_masks[lo : lo + QPACK]
        f0 = stack_start_masks_packed(plan, ca.start, chunk).view(np.int32)
        visited = reach_fixpoint_packed(
            plan, torch.from_numpy(f0).to(plan.tiles.device), max_levels
        ).reshape(plan.n_states, plan.q_pad, plan.v_pad)
        acc = functools.reduce(
            torch.bitwise_or, (visited[qf] for qf in ca.accepting), torch.zeros_like(visited[0])
        )
        lanes = unpack_lane_rows(acc)[: chunk.shape[0], : staged.n_nodes]
        out[lo : lo + chunk.shape[0]] = lanes.cpu().numpy() > 0
    return out


# ---------------------------------------------------------------------------
# Per-transition baseline (one launch per transition × label store)
# ---------------------------------------------------------------------------


def expand_operand(frontier_row: torch.Tensor) -> torch.Tensor:
    """B5's frontier operand for one transition: the source state's row
    in row 0 of an 8-row frontier (the f32 row-block minimum, so the
    launch shape does not grow with the automaton), the other rows 0."""
    row_sel = torch.zeros((8, frontier_row.shape[0]), dtype=torch.float32, device=frontier_row.device)
    row_sel[0] = frontier_row
    return row_sel


def _expand_one(frontier_row: torch.Tensor, entry, block_size: int) -> torch.Tensor:
    """One (transition × label store) block product: one B5 launch on
    :func:`expand_operand`, and row 0 of the counts clamped to 0/1."""
    tiles, rows, cols, work = entry
    counts = frontier_step_blocks(
        expand_operand(frontier_row), tiles, rows, cols, block_size, work=work
    )
    return torch.clamp(counts[0], max=1.0)


def baseline_entries(ca: CompiledAutomaton, bg: BlockedGraph):
    """The (transition, label store) pairs one baseline level launches,
    in launch order: a labelled transition reads its label's store, a
    wildcard every store of its direction; labels with no edges have no
    store and launch nothing."""
    for t in ca.transitions:
        store = bg.fwd if t.direction == FWD else bg.inv
        entries = [store.get(t.label_id)] if t.label_id >= 0 else list(store.values())
        for entry in entries:
            if entry is not None:
                yield t, entry


def expand_level(
    ca: CompiledAutomaton,
    bg: BlockedGraph,
    frontier: torch.Tensor,  # (n_states, v_pad) f32 0/1 — rows = automaton states
) -> torch.Tensor:
    """One BFS level over all grounded transitions; returns the new 0/1
    mask (n_states, v_pad).  Baseline path: one B5 launch per transition
    × label store, each merged into its destination state's row with
    ``amax`` — see :func:`expand_level_fused` for the one-launch form."""
    out = torch.zeros((ca.n_states, bg.v_pad), dtype=torch.float32, device=frontier.device)
    for t, entry in baseline_entries(ca, bg):
        out[t.dst] = torch.maximum(out[t.dst], _expand_one(frontier[t.src], entry, bg.block_size))
    return (out > 0).float()


def multi_source_reach_baseline(
    ca: CompiledAutomaton,
    bg: BlockedGraph,
    start_mask: np.ndarray,
    max_levels: int = 64,
) -> np.ndarray:
    """Fixpoint reachability with per-transition level launches and a
    host loop — the pre-fusion path, kept as the benchmark baseline.
    Frontier and visited set stay on the device; each level reads
    ``new.any()`` once on the host.  :data:`FIXPOINT_COUNTERS` counts the
    levels (one :func:`expand_level` each) and those syncs."""
    frontier = torch.zeros((ca.n_states, bg.v_pad), dtype=torch.float32, device=bg.device)
    frontier[ca.start, : len(start_mask)] = torch.as_tensor(
        np.asarray(start_mask, np.float32), device=bg.device
    )
    visited = frontier.clone()
    for _ in range(max_levels):
        nxt = expand_level(ca, bg, frontier)
        FIXPOINT_COUNTERS["levels"] += 1
        new = nxt * (1.0 - visited)  # exact on {0,1} floats
        if not frontier_nonempty(new):
            break
        visited = torch.maximum(visited, new)
        frontier = new
    acc = torch.zeros(bg.v_pad, dtype=torch.bool, device=bg.device)
    for qf in ca.accepting:
        acc |= visited[qf] > 0
    return acc[: bg.n_nodes].cpu().numpy()
