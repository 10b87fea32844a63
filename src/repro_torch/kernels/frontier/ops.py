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
  block runs the CUDA kernel gives one CTA each).  Transitions sharing
  (dst_state, direction, label) fuse into ONE pass over a *fan-in union
  row* appended to the frontier by :func:`extend_frontier`.

Stage A stages either tile store: ``tile_dtype="f32"`` (dense 0/1
B×B tiles) or ``"uint32"`` (the dst axis packed into ⌈B/32⌉ bit-plane
words per tile row, 1/32 of the bytes), held in torch as int32 with the
same bits.  One Stage-B schedule serves both, and the level kernels pick
their variant off the tile dtype.

The fixpoints (:func:`reach_fixpoint` on f32 rows of 8 stacked queries,
:func:`reach_fixpoint_packed` on int32 lane words of 256) run one fused
level launch per BFS level.  ``repro`` runs them in a
``lax.while_loop`` with no host sync; here a Python loop reads
``frontier.any()`` once per level, and :data:`FIXPOINT_COUNTERS` counts
the levels and those host syncs.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core.automaton import FWD, INV, CompiledAutomaton
from repro_torch.graph.structure import LabeledGraph
from repro_torch.kernels.frontier.frontier import (
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

# offset-table key for the any-label union store (wildcard transitions);
# real label ids are >= 0 so the key space is disjoint.
ANY_LABEL = -1

# Build-path instrumentation: every Stage-A packing/staging op and every
# Stage-B schedule construction bumps a counter (same keys as ``repro``).
BUILD_COUNTERS: collections.Counter = collections.Counter()

# Fixpoint instrumentation: "levels" counts BFS levels run (one fused
# kernel launch each), "host_syncs" the frontier.any() reads.
FIXPOINT_COUNTERS: collections.Counter = collections.Counter()


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


def stage_graph(
    graph: LabeledGraph,
    block_size: int = 128,
    chunk_edges: int | None = None,
    tile_dtype: str = "f32",
    device: str | torch.device | None = None,
) -> StagedGraph:
    """Stage A for the fused backend: pack every label's tiles — plus the
    per-direction any-label union stores — into one device tensor +
    offsets, byte-identical to ``repro``'s ``stage_graph``.

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


@dataclasses.dataclass
class FusedLevelPlan:
    """Host-built schedule for :func:`fused_level_blocks`, on the device.

    One step per (fan-in transition group, label, nonzero tile), plus one
    zero-tile cover step per output block no real step writes.  Steps are
    sorted by (dst_state, block_col); ``firsts`` marks each output
    block's first step and ``valids`` the steps that carry a real tile.
    The seven id arrays are byte-identical to ``repro``'s; ``run_ptr`` is
    the port's own: ``run_ptr[k] .. run_ptr[k+1]`` are the steps of output
    block ``k = dst_state · nb + block_col``."""

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
    # dtype of the aliased tile store ("f32" or "uint32"); the kernels
    # dispatch off the tensor's dtype, executors check it against theirs
    tile_dtype: str = "f32"


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
    order — the contract that lets the CUDA kernel give each output
    block one CTA and store it once.  ``repro``'s cover steps guarantee
    it; a schedule that breaks it raises."""
    starts = np.nonzero(firsts)[0]
    blocks = arr[starts, 0].astype(np.int64) * nb + arr[starts, 1]
    if len(starts) != n_states * nb or not (blocks == np.arange(n_states * nb)).all():
        raise ValueError(
            f"schedule holds {len(starts)} runs for {n_states * nb} output blocks: "
            "need exactly one run per output block, in (o_row, o_col) order"
        )
    return np.append(starts, len(firsts)).astype(np.int32)


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
        tile_dtype=staged.tile_dtype,
    )


def build_level_plan(
    ca: CompiledAutomaton,
    source: LabeledGraph | StagedGraph,
    q_pad: int = QPAD,
    block_size: int = 128,
    device: str | torch.device | None = None,
) -> FusedLevelPlan:
    """One-shot wrapper: stage (Stage A, when given a graph) then
    schedule (Stage B).  Pass a :class:`StagedGraph` to skip straight to
    Stage B (``block_size`` and ``device`` then come from it)."""
    staged = (
        source
        if isinstance(source, StagedGraph)
        else stage_graph(source, block_size, device=device)
    )
    return build_level_schedule(ca, staged, q_pad)


# ---------------------------------------------------------------------------
# Fused level and fixpoint
# ---------------------------------------------------------------------------


def expand_level_fused(plan: FusedLevelPlan, frontier: torch.Tensor) -> torch.Tensor:
    """One BFS level over all grounded transitions — ONE kernel launch,
    on either tile store.  ``frontier`` is (n_states · q_pad, v_pad) f32
    0/1; returns the same shape, thresholded to 0/1."""
    fre = extend_frontier(frontier, plan.union_members, plan.n_states, plan.q_pad)
    counts = fused_level_blocks(
        fre, plan.tiles, plan.firsts, plan.valids, plan.tile_ids,
        plan.f_rows, plan.f_cols, plan.o_rows, plan.o_cols,
        plan.block_size, plan.q_pad,
        n_out_rows=plan.n_states * plan.q_pad, run_ptr=plan.run_ptr,
    )
    return torch.clamp(counts, max=1.0)


def frontier_nonempty(frontier: torch.Tensor) -> bool:
    """``(frontier != 0).any()`` read on the host — f32 0/1 rows and int32
    lane words alike (a word with only bit 31 set is negative): the
    fixpoint's one host sync per level, counted in
    :data:`FIXPOINT_COUNTERS`."""
    FIXPOINT_COUNTERS["host_syncs"] += 1
    return bool(frontier.any())


def reach_fixpoint(
    plan: FusedLevelPlan,
    frontier0: torch.Tensor,  # (n_states * q_pad, v_pad) f32 0/1
    max_levels: int = 64,
) -> torch.Tensor:
    """Visited product states (same layout as ``frontier0``) at fixpoint."""
    visited = frontier = frontier0
    level = 0
    while level < max_levels and frontier_nonempty(frontier):
        nxt = expand_level_fused(plan, frontier)
        new = nxt * (1.0 - visited)  # exact on {0,1} floats
        visited = torch.maximum(visited, new)
        frontier = new
        level += 1
        FIXPOINT_COUNTERS["levels"] += 1
    return visited


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
    staged: StagedGraph,
    start_masks: np.ndarray,  # (Q, n_nodes) f32 0/1 — one row per query
    max_levels: int = 64,
    plan: FusedLevelPlan | None = None,
) -> np.ndarray:
    """Fixpoint reachability for Q stacked queries; returns (Q, n_nodes)
    bool answer masks (nodes reached in an accepting state, per query).
    Queries ride the q_pad row dim in chunks of 8, one fixpoint per
    chunk, on the staged tiles' device."""
    start_masks = np.atleast_2d(np.asarray(start_masks, np.float32))
    if plan is None:
        plan = build_level_schedule(ca, staged)
    n_q = start_masks.shape[0]
    out = np.zeros((n_q, staged.n_nodes), bool)
    for lo in range(0, n_q, plan.q_pad):
        chunk = start_masks[lo : lo + plan.q_pad]
        f0 = torch.from_numpy(stack_start_masks(plan, ca.start, chunk)).to(plan.tiles.device)
        visited = reach_fixpoint(plan, f0, max_levels).reshape(
            plan.n_states, plan.q_pad, plan.v_pad
        )
        acc = torch.zeros_like(visited[0])
        for qf in ca.accepting:
            acc = torch.maximum(acc, visited[qf])
        out[lo : lo + chunk.shape[0]] = acc[: chunk.shape[0], : staged.n_nodes].cpu().numpy() > 0
    return out


def multi_source_reach(
    ca: CompiledAutomaton,
    staged: StagedGraph,
    start_mask: np.ndarray,
    max_levels: int = 64,
    plan: FusedLevelPlan | None = None,
) -> np.ndarray:
    """Single-query fixpoint reachability on the fused level kernel."""
    return multi_query_reach(
        ca, staged, np.asarray(start_mask, np.float32)[None, :],
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
    launch on the SAME Stage-B plan the f32 path uses, on either tile
    store.  ``frontier`` is (n_states · q_pad, v_pad) int32 lane words;
    returns the OR-accumulated words, boolean per bit already."""
    fre = extend_frontier_packed(frontier, plan.union_members, plan.n_states, plan.q_pad)
    return packed_level_blocks(
        fre, plan.tiles, plan.firsts, plan.valids, plan.tile_ids,
        plan.f_rows, plan.f_cols, plan.o_rows, plan.o_cols,
        plan.block_size, plan.q_pad,
        n_out_rows=plan.n_states * plan.q_pad, run_ptr=plan.run_ptr,
    )


def reach_fixpoint_packed(
    plan: FusedLevelPlan,
    frontier0: torch.Tensor,  # (n_states * q_pad, v_pad) int32 lane words
    max_levels: int = 64,
) -> torch.Tensor:
    """Visited lane words (same layout as ``frontier0``) at fixpoint: all
    256 lanes advance together, ``new = nxt & ~visited`` per bit, and the
    loop ends when every word of the frontier is zero."""
    visited = frontier = frontier0
    level = 0
    while level < max_levels and frontier_nonempty(frontier):
        new = expand_level_packed(plan, frontier) & ~visited
        visited = visited | new
        frontier = new
        level += 1
        FIXPOINT_COUNTERS["levels"] += 1
    return visited


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
