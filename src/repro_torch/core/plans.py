"""GraphPlanStore — the shared Stage-A cache of two-stage compilation.

Port of ``repro/core/plans.py``.  Everything here is **graph-dependent
and automaton-independent**, built once per ``(graph-stats epoch,
block_size, placement)`` and shared by every automaton signature, every
kernel backend, and all sites:

* the staged global tile tensor —
  :func:`repro_torch.kernels.frontier.ops.stage_graph`, keyed by tile
  dtype (f32 or the uint32 bit-planes) and, under a
  ``tile_store_budget_bytes``, backed by the byte-budgeted out-of-core
  :class:`_SlabCache` (cold per-(direction, label) host slabs spill to
  disk and reload on touch),
* staged per-site tile slabs —
  :func:`repro_torch.kernels.frontier.ops.stage_sharded_graph` (the
  ``frontier_kernel_sharded`` backend), their group-granular merges and
  their power-of-two shape buckets on the device —
  :func:`~repro_torch.kernels.frontier.ops.bucket_staged_sites`, keyed by
  (axis_size, floor) on top of the staging key; the resulting
  ``bucket_id`` also joins the executor cache's graph key,
* the placement's padded site edge arrays on the device (the
  ``reference`` executor's and S1's gather operands),
* per-site site-local graph views,
* per-(site, label, direction) degree vectors — the §4.2.2 meter vectors
  of :func:`repro_torch.core.strategies._site_symbol_degrees` reduce to
  row sums over these.

The store holds its artifacts on its ``device``.  Given a ``mesh`` (a
``DeviceMesh`` of ranks) and ``site_axes``, the per-site artifacts — the
site-local graphs, per-site slabs, the group merge and its bucket, the
padded site arrays and the degree vectors — are only the rank's share:
its block of sites (``collectives.site_block``), keyed by that block,
so one rank's host and device memory hold ``1/axis_size`` of them.  The
merge is then the rank's one group slab and its bucket the rank's row of
the one-card stack (:func:`repro_torch.kernels.frontier.ops.stage_rank_group`,
:func:`~repro_torch.kernels.frontier.ops.bucket_rank_group`).  The
automaton-dependent
half (Stage B) stays in
:func:`repro_torch.kernels.frontier.ops.build_level_schedule` and
:func:`~repro_torch.kernels.frontier.ops.build_sharded_level_schedule`; it packs
no tile, so a warm executor build for a new query signature on a hot
graph packs zero tiles.

Invalidation: entries carry the graph-stats epoch they were built for;
:meth:`GraphPlanStore.invalidate_epoch` drops every other epoch's
entries in one sweep.  Dropping only removes the store's references: an
executor already built against the old epoch keeps its staged tensors
alive through its own closure and completes normally.  The device memory
frees once the last executor holding them is released too (see
:class:`repro_torch.serve.plancache.ExecutorCache`).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import weakref
from collections import OrderedDict
from typing import Any, Callable, Hashable

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core import strategies
from repro_torch.core.automaton import FWD, INV
from repro_torch.dist import collectives
from repro_torch.graph.partition import Placement
from repro_torch.graph.structure import LabeledGraph
from repro_torch.kernels.frontier import ops as fops


def label_degree_vectors(
    site_graphs: list[LabeledGraph], n_labels: int, v_pad: int
) -> np.ndarray:
    """Per-(site, label, direction) matching-edge counts by node.

    ``deg[s, l, d, v]`` is the number of site ``s``'s edges with label
    ``l`` incident to node ``v`` in direction ``d`` (0 = FWD counts at
    the source endpoint, 1 = INV at the destination).  Any symbol set's
    §4.2.2 response-degree vector is a row sum over these (a wildcard
    sums every label: each edge has exactly one label)."""
    deg = np.zeros((len(site_graphs), n_labels, 2, v_pad), np.float32)
    for s, g in enumerate(site_graphs):
        np.add.at(deg[s, :, 0], (g.lbl, g.src), 1.0)
        np.add.at(deg[s, :, 1], (g.lbl, g.dst), 1.0)
    return deg


class _SlabCache:
    """Byte-budgeted out-of-core Stage A for ONE (graph, block_size,
    tile_dtype) triple: per-(direction, label) host slabs with touch
    *heat* (touches since the cache was built; an epoch bump drops the
    whole cache), spilled coldest-first to an on-disk snapshot when
    resident bytes exceed ``budget_bytes``, and restored — or rebuilt
    from the edge stream if the spill file is gone — on the next touch.

    The slabs live in host numpy, as in ``repro``: the budget bounds the
    host slabs, not device memory.  Each :meth:`assemble` copies the
    requested subset to ``device``, and the executor that asked for it
    holds that copy through its closure.

    Slabs are immutable once packed, so a spill file written once stays
    valid for the cache's lifetime: re-spilling a reloaded slab only
    drops the memory copy.  Spill writes are atomic (``mkstemp`` +
    ``os.replace``) and the spill directory is removed when the cache is
    garbage-collected.  ``BUILD_COUNTERS["spills"/"reloads"]`` mirror the
    per-cache counters."""

    def __init__(
        self,
        graph: LabeledGraph,
        block_size: int,
        tile_dtype: str,
        chunk_edges: int | None = None,
        device: torch.device | None = None,
    ):
        self.graph = graph
        self.block_size = block_size
        self.tile_dtype = tile_dtype
        self.chunk_edges = chunk_edges
        self.device = resolve_device(device)
        self.budget_bytes: int | None = None
        # key -> resident host slab (tiles, rows, cols), or None for a
        # label/direction without edges (resident at zero bytes, never spilled)
        self._slabs: dict[tuple[int, int], tuple | None] = {}
        self._heat: dict[tuple[int, int], int] = {}
        self._spilled: dict[tuple[int, int], str] = {}
        self.spills = 0
        self.reloads = 0
        self.staging_chunks = 0
        self._dir = tempfile.mkdtemp(prefix="repro-tile-spill-")
        self._cleanup = weakref.finalize(self, shutil.rmtree, self._dir, True)

    @staticmethod
    def _slab_nbytes(slab: tuple | None) -> int:
        return int(slab[0].nbytes) if slab is not None else 0

    def resident_bytes(self) -> int:
        """Host bytes currently held by in-memory slab tiles."""
        return sum(self._slab_nbytes(s) for s in self._slabs.values())

    def resident_slabs(self) -> int:
        return sum(1 for s in self._slabs.values() if s is not None)

    def spilled_slabs(self) -> int:
        return sum(1 for k in self._spilled if k not in self._slabs)

    def _build(self, key: tuple[int, int]) -> tuple | None:
        slab, n_chunks = fops.pack_label_store(
            self.graph, key[0], key[1], self.block_size, self.chunk_edges, self.tile_dtype,
        )
        self.staging_chunks += n_chunks
        return slab

    def _restore(self, key: tuple[int, int]) -> tuple | None:
        path = self._spilled.get(key)
        if path is not None and os.path.exists(path):
            with np.load(path) as z:
                slab = (z["tiles"], z["rows"], z["cols"])
            self.reloads += 1
            fops.BUILD_COUNTERS["reloads"] += 1
            return slab
        # never packed yet, or the spill file vanished: (re)build from the
        # edge stream, chunked when the cache was configured so
        return self._build(key)

    def _spill(self, key: tuple[int, int]) -> None:
        slab = self._slabs.pop(key)
        if key not in self._spilled:
            path = os.path.join(self._dir, f"slab_{key[0]}_{key[1]}.npz")
            fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, tiles=slab[0], rows=slab[1], cols=slab[2])
            os.replace(tmp, path)  # atomic: never a torn spill file
            self._spilled[key] = path
        self.spills += 1
        fops.BUILD_COUNTERS["spills"] += 1

    def touch(self, keys: tuple[tuple[int, int], ...]) -> None:
        """Bump heat and make every requested slab resident, then evict
        the coldest non-requested slabs until the budget holds.  If the
        requested set alone exceeds the budget it stays resident: a
        single assembly is never split."""
        for k in keys:
            self._heat[k] = self._heat.get(k, 0) + 1
            if k not in self._slabs:
                self._slabs[k] = self._restore(k)
        if self.budget_bytes is None:
            return
        resident = self.resident_bytes()
        pinned = frozenset(keys)
        victims = sorted(
            (k for k, s in self._slabs.items() if s is not None and k not in pinned),
            key=lambda k: self._heat.get(k, 0),
        )
        for k in victims:
            if resident <= self.budget_bytes:
                break
            resident -= self._slab_nbytes(self._slabs[k])
            self._spill(k)

    def assemble(self, keys: tuple[tuple[int, int], ...] | None = None) -> fops.StagedGraph:
        """A :class:`~repro_torch.kernels.frontier.ops.StagedGraph` on the
        cache's device covering exactly ``keys`` (default: every
        (direction, label) plus the any-label unions — the full store).
        Each call concatenates the requested host slabs behind a fresh
        cover tile; the device tensor holds only the requested subset."""
        if keys is None:
            keys = tuple(
                (d, lid)
                for d in (FWD, INV)
                for lid in (*range(self.graph.n_labels), fops.ANY_LABEL)
            )
        keys = tuple(sorted(set(keys)))
        self.touch(keys)
        stores = {k: self._slabs[k] for k in keys if self._slabs[k] is not None}
        return fops.assemble_staged(
            stores, self.graph.n_nodes, self.block_size, self.tile_dtype, device=self.device
        )


class GraphPlanStore:
    """LRU cache of Stage-A artifacts on ``device`` (``None``: the GPU),
    keyed by (kind, graph identity, graph-stats epoch, block size).

    Graph identity is the *object*: the store pins a reference to the
    placement or graph it staged (so ``id()`` stays unambiguous for the
    entry's lifetime), and a service uses one store per placement.
    Eviction and invalidation drop the store's references to staged
    tensors; live executors keep theirs through their closures."""

    def __init__(self, maxsize: int = 16, device: str | torch.device | None = None):
        self.maxsize = maxsize
        self.device = resolve_device(device)
        # key -> (anchor object, artifact, epoch); the anchor pins the
        # id()-keyed source, the epoch is recorded explicitly
        self._lru: OrderedDict[Hashable, tuple[Any, Any, int]] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # grid-step padding accounting of every sharded plan built
        # against this store (see record_plan_pad_waste)
        self._pad_useful = 0
        self._pad_padded = 0
        self._bucket_steps: dict[str, int] = {}
        # edge-list slices consumed by chunked Stage-A packing through
        # this store; feeds the serve `frontier_mem` block
        self._staging_chunks = 0

    # -- core get-or-build --------------------------------------------------

    def _get(self, key: Hashable, anchor: Any, epoch: int, build: Callable[[], Any]) -> Any:
        if key in self._lru:
            self._lru.move_to_end(key)
            self.hits += 1
            return self._lru[key][1]
        self.misses += 1
        value = build()
        self._lru[key] = (anchor, value, epoch)
        while len(self._lru) > self.maxsize:
            self._lru.popitem(last=False)
            self.evictions += 1
        return value

    # -- Stage-A artifacts --------------------------------------------------

    def staged_graph(
        self,
        graph: LabeledGraph,
        block_size: int = 128,
        epoch: int = 0,
        chunk_edges: int | None = None,
        tile_dtype: str = "f32",
        budget_bytes: int | None = None,
        keys: tuple[tuple[int, int], ...] | None = None,
    ) -> fops.StagedGraph:
        """The global fused backends' staged tile tensor + offsets, on the
        store's device.

        Keyed by tile dtype: the f32 and uint32 stores cache
        independently; both frontier backends read either.
        ``chunk_edges`` streams the packing in bounded edge slices; the
        artifact is byte-identical, so the key is unchanged.

        ``budget_bytes`` switches to the **out-of-core** path: Stage A
        becomes a :class:`_SlabCache` of per-(direction, label) host
        slabs under that resident-byte budget, and the returned graph is
        assembled on the device from exactly ``keys`` (an automaton's
        :func:`~repro_torch.kernels.frontier.ops.required_offset_keys`;
        ``None`` = every slab).  The budget bounds the host slabs, not
        device memory; the assembled subset is NOT cached here —
        executors hold it through their closures."""
        if budget_bytes is not None:
            cache = self._slab_cache(graph, block_size, epoch, chunk_edges, tile_dtype)
            cache.budget_bytes = int(budget_bytes)
            before = cache.staging_chunks
            staged = cache.assemble(keys)
            self._staging_chunks += cache.staging_chunks - before
            return staged

        def build() -> fops.StagedGraph:
            staged = fops.stage_graph(graph, block_size, chunk_edges, tile_dtype, self.device)
            self._staging_chunks += staged.staging_chunks
            return staged

        key = ("staged_graph", id(graph), epoch, block_size, tile_dtype)
        return self._get(key, graph, epoch, build)

    def _slab_cache(
        self,
        graph: LabeledGraph,
        block_size: int,
        epoch: int,
        chunk_edges: int | None,
        tile_dtype: str,
    ) -> _SlabCache:
        """The out-of-core slab cache behind budgeted staging, one per
        (graph, block_size, tile_dtype); the budget is mutable state on
        the cache (not part of the key), so a budget change re-uses the
        slabs already packed."""
        key = ("slab_cache", id(graph), epoch, block_size, tile_dtype)
        return self._get(
            key, graph, epoch,
            lambda: _SlabCache(graph, block_size, tile_dtype, chunk_edges, self.device),
        )

    @staticmethod
    def share(placement: Placement, mesh, site_axes) -> tuple:
        """The key suffix of a rank's share: ``()`` for the whole placement
        (``mesh=None``), else ``((site_axes, lo, hi),)``, the rank's block
        of sites."""
        if mesh is None:
            return ()
        return ((tuple(site_axes), *collectives.site_block(placement.n_sites, site_axes, mesh)),)

    def local_graphs(
        self, placement: Placement, epoch: int = 0, mesh=None, site_axes=("data",)
    ) -> list[LabeledGraph]:
        """Per-site site-local graph views of the placement (on a ``mesh``,
        of the rank's block of sites)."""
        share = self.share(placement, mesh, site_axes)
        sites = range(*share[0][1:]) if share else range(placement.n_sites)
        key = ("local_graphs", id(placement), epoch) + share
        return self._get(
            key, placement, epoch, lambda: [placement.local_graph(s) for s in sites],
        )

    def staged_sharded(
        self, placement: Placement, block_size: int = 128, epoch: int = 0, tile_dtype: str = "f32",
        mesh=None, site_axes=("data",),
    ) -> fops.StagedShardedGraph:
        """The sharded backend's per-site staged host slabs (keyed by tile
        dtype like :meth:`staged_graph`; the sharded path stages whole
        placements, so it gets the dtype but not the byte budget, as in
        ``repro``).  On a ``mesh``: the rank's sites only."""
        key = ("staged_sharded", id(placement), epoch, block_size, tile_dtype)
        key += self.share(placement, mesh, site_axes)
        return self._get(
            key, placement, epoch,
            lambda: fops.stage_sharded_graph(
                self.local_graphs(placement, epoch, mesh, site_axes), block_size, tile_dtype
            ),
        )

    def staged_merged(
        self,
        placement: Placement,
        block_size: int = 128,
        n_groups: int = 1,
        epoch: int = 0,
        tile_dtype: str = "f32",
        mesh=None,
        site_axes=("data",),
    ) -> fops.StagedShardedGraph:
        """Group-granular staging: each group's co-located sites merged
        into one deduplicated union slab
        (:func:`~repro_torch.kernels.frontier.ops.merge_staged_sites`), the
        sharded executor's expansion operand.  When every site is its own
        group this is the per-site staging itself (no copy).  On a
        ``mesh`` (``n_groups`` the site axes' size): the rank's one group."""
        key = ("staged_merged", id(placement), epoch, block_size, n_groups, tile_dtype)
        share = self.share(placement, mesh, site_axes)
        if share and n_groups != collectives.axis_size(mesh, site_axes):
            raise ValueError(f"n_groups={n_groups}: the site axes {tuple(site_axes)} hold "
                             f"{collectives.axis_size(mesh, site_axes)} groups")
        return self._get(
            key + share, placement, epoch,
            lambda: fops.merge_staged_sites(
                self.staged_sharded(placement, block_size, epoch, tile_dtype, mesh, site_axes),
                1 if share else n_groups,
            ),
        )

    def tile_buckets(
        self,
        placement: Placement,
        block_size: int = 128,
        axis_size: int = 1,
        epoch: int = 0,
        floor: int = fops.BUCKET_FLOOR,
        tile_dtype: str = "f32",
        mesh=None,
        site_axes=("data",),
    ) -> fops.ShardedTileBuckets:
        """The sharded backend's Stage-A shape buckets: the merged slabs
        grouped into power-of-two tile classes and stacked on the store's
        device per bucket.  Keyed by (placement, axis_size, floor) on top
        of the staging key; the resulting ``bucket_id`` joins the executor
        cache's graph key.  On a ``mesh``: the rank's one bucket row
        (``all_reduce(MAX)`` of the groups' tile counts)."""
        key = ("tile_buckets", id(placement), epoch, block_size, axis_size, floor, tile_dtype)
        share = self.share(placement, mesh, site_axes)

        def build() -> fops.ShardedTileBuckets:
            merged = self.staged_merged(
                placement, block_size, axis_size, epoch, tile_dtype, mesh, site_axes
            )
            if share:
                return fops.bucket_rank_group(merged, mesh, site_axes, floor, self.device)
            return fops.bucket_staged_sites(merged, axis_size, floor, self.device)

        return self._get(key + share, placement, epoch, build)

    def site_device_arrays(
        self, placement: Placement, epoch: int = 0, mesh=None, site_axes=("data",)
    ) -> dict[str, torch.Tensor]:
        """The placement's padded per-site edge arrays on the store's
        device (the ``reference`` executor's and S1's gather operands; on a
        ``mesh``, the rank's rows)."""
        key = ("site_arrays", id(placement), epoch) + self.share(placement, mesh, site_axes)
        return self._get(
            key, placement, epoch,
            lambda: strategies.stage_site_arrays(placement, self.device, mesh, site_axes),
        )

    def label_degrees(
        self,
        anchor: Placement | LabeledGraph,
        site_graphs: list[LabeledGraph],
        n_labels: int,
        v_pad: int,
        epoch: int = 0,
        mesh=None,
        site_axes=("data",),
    ) -> np.ndarray:
        """Per-(site, label, direction) degree vectors (§4.2.2 meter
        inputs, host numpy); ``anchor`` is the placement or graph the
        site list came from (on a ``mesh``, the placement whose rank's
        share ``site_graphs`` is)."""
        key = ("label_degrees", id(anchor), epoch, v_pad) + self.share(anchor, mesh, site_axes)
        return self._get(
            key, anchor, epoch, lambda: label_degree_vectors(site_graphs, n_labels, v_pad)
        )

    # -- persistence hooks (see repro_torch.serve.persist) ------------------

    def export_entries(self, anchor: Any) -> list[tuple[tuple, Any, int]]:
        """Every entry anchored to ``anchor`` as ``(portable_key,
        artifact, epoch)``.  Store keys are ``(kind, id(anchor), epoch,
        *rest)``; the portable key drops the two process-local slots,
        ``(kind, *rest)``, as ``repro``'s does."""
        out = []
        for key, (a, v, ep) in self._lru.items():
            if a is anchor:
                out.append(((key[0], *key[3:]), v, ep))
        return out

    def install_entry(self, portable_key: tuple, anchor: Any, epoch: int, artifact: Any) -> None:
        """Install one restored Stage-A artifact under ``anchor`` at
        ``epoch`` (the inverse of :meth:`export_entries`).  Counts as
        neither hit nor miss."""
        kind, *rest = portable_key
        key = (kind, id(anchor), epoch) + tuple(rest)
        self._lru[key] = (anchor, artifact, epoch)
        self._lru.move_to_end(key)
        while len(self._lru) > self.maxsize:
            self._lru.popitem(last=False)
            self.evictions += 1

    # -- invalidation -------------------------------------------------------

    def invalidate_epoch(self, keep_epoch: int) -> int:
        """Drop every entry not built for ``keep_epoch``; returns how many.
        References held by already-built executors stay valid."""
        stale = [k for k, (_, _, ep) in self._lru.items() if ep != keep_epoch]
        for k in stale:
            del self._lru[k]
        self.evictions += len(stale)
        return len(stale)

    def clear(self) -> None:
        self.evictions += len(self._lru)
        self._lru.clear()

    # -- padding accounting --------------------------------------------------

    def record_plan_pad_waste(self, plan) -> None:
        """Accumulate one sharded plan's grid-step padding accounting:
        ``useful`` counts each site's own (unpadded) schedule length,
        ``padded`` the grid slots its shape bucket executes, and per bucket
        ``"<n_steps>x<n_tiles>"`` the executed steps."""
        self._pad_useful += int(plan.useful_steps)
        self._pad_padded += int(plan.padded_steps)
        for b in plan.buckets:
            key = f"{b.n_steps}x{b.n_tiles}"
            self._bucket_steps[key] = self._bucket_steps.get(key, 0) + b.n_steps * len(b.sites)

    @property
    def staging_chunks(self) -> int:
        """Chunked Stage-A edge slices consumed through this store (kept
        out of :meth:`stats`, whose key set is a stable schema)."""
        return self._staging_chunks

    def tile_store_stats(self) -> dict:
        """Staged tile-store accounting across every live entry: bytes per
        tile dtype (full stagings count their device tensor, slab caches
        their resident host slabs) plus the out-of-core spill and reload
        counters.  Entries are deduplicated by artifact identity
        (``staged_merged`` may be ``staged_sharded`` itself); per-site
        stagings count their host slabs, as ``repro``'s do."""
        bytes_by_dtype = {d: 0 for d in fops.TILE_DTYPES}
        slabs_resident = slabs_spilled = spills = reloads = 0
        seen: set[int] = set()
        for _, (_, v, _) in self._lru.items():
            if id(v) in seen:
                continue
            seen.add(id(v))
            if isinstance(v, _SlabCache):
                bytes_by_dtype[v.tile_dtype] += v.resident_bytes()
                slabs_resident += v.resident_slabs()
                slabs_spilled += v.spilled_slabs()
                spills += v.spills
                reloads += v.reloads
            elif isinstance(v, (fops.StagedGraph, fops.StagedShardedGraph)):
                bytes_by_dtype[v.tile_dtype] += v.tile_store_bytes
        return {
            "bytes_by_dtype": bytes_by_dtype,
            "slabs_resident": slabs_resident,
            "slabs_spilled": slabs_spilled,
            "spills": spills,
            "reloads": reloads,
        }

    def pad_stats(self) -> dict:
        return {
            "useful_steps": self._pad_useful,
            "padded_steps": self._pad_padded,
            "pad_waste_ratio": self._pad_padded / self._pad_useful if self._pad_useful else 0.0,
            "bucket_grid_steps": dict(self._bucket_steps),
        }

    # -- reporting ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "size": len(self._lru),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "evictions": self.evictions,
        }


__all__ = ["GraphPlanStore", "label_degree_vectors"]
