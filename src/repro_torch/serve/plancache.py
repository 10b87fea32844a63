"""Plan + executor caches for the serving runtime.

Port of ``repro/serve/plancache.py``.  Two caches with different keys,
mirroring the two expensive phases of a query's life:

* :class:`PlanCache` — LRU over ``(canonical query key, graph-stats
  epoch)`` → the planner's :class:`~repro_torch.core.planner.PlanEstimates`
  (plus the compiled automaton and parsed AST).  The canonical key
  normalizes α-equivalent queries — commutative-operator reordering
  (``(a|b)`` ≡ ``(b|a)`` ≡ ``{a,b}`` ≡ ``{b|a}``), duplicate union arms,
  and whitespace — so repeated *query classes* skip the rollout
  estimation, not just repeated strings.  The stats epoch in the key
  invalidates every entry implicitly when the service refits its
  statistical model on fresh sample data.

* :class:`ExecutorCache` — a TWO-LEVEL LRU mirroring two-stage
  compilation (see :mod:`repro_torch.core.plans`): the outer key is the
  *graph key* ``(stats epoch, placement/graph identity, backend, block
  size, shape-bucket id)`` — everything Stage A depends on — and the
  inner key is the *automaton signature* (:class:`Signature`).  Builds
  route Stage A through the cache's shared
  :class:`~repro_torch.core.plans.GraphPlanStore`, so distinct signatures
  on one hot graph share staged tiles (zero tile packing on warm
  builds).  Eviction drops the executor's closure — its Stage-B plan,
  degree vectors and its reference to the staged tensors — so their
  device memory frees once the plan store's Stage-A entry goes too.

The signature carries the mesh's shape and its site and batch axes, as
``repro``'s does, so an executor built for one mesh is never served on
another; the port names its fields.  The sharded backend's ``axis_size``
shapes its buckets, so it reaches the graph key through the bucket
descriptor.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Hashable, NamedTuple

from repro_torch.core import plans as plans_mod
from repro_torch.core import regex as rx
from repro_torch.core import strategies
from repro_torch.core.automaton import CompiledAutomaton
from repro_torch.dist import sharding as shd
from repro_torch.kernels.frontier import ops as fops
from repro_torch.serve import metrics

# ---------------------------------------------------------------------------
# Query normalization (α-equivalence up to commutative reordering)
# ---------------------------------------------------------------------------


def normalize(node: rx.Node) -> rx.Node:
    """Canonical form of an RPQ AST.

    Union parts and label-class members are sorted and deduplicated;
    unions of plain same-direction atoms collapse into a
    :class:`~repro_torch.core.regex.LabelClass`; singleton classes collapse to
    a :class:`~repro_torch.core.regex.Label`; nested Concat/Union flatten.
    Two queries with the same normal form compile to automata with
    identical answer semantics, so they may share a cached plan.
    """
    if isinstance(node, rx.Label):
        return node
    if isinstance(node, rx.Wildcard):
        return node
    if isinstance(node, rx.LabelClass):
        names = tuple(sorted(set(node.names)))
        if len(names) == 1:
            return rx.Label(names[0], inverse=node.inverse)
        return rx.LabelClass(names, inverse=node.inverse)
    if isinstance(node, rx.Concat):
        parts: list[rx.Node] = []
        for p in node.parts:
            q = normalize(p)
            parts.extend(q.parts if isinstance(q, rx.Concat) else [q])
        return parts[0] if len(parts) == 1 else rx.Concat(tuple(parts))
    if isinstance(node, rx.Union):
        flat: list[rx.Node] = []
        for p in node.parts:
            q = normalize(p)
            flat.extend(q.parts if isinstance(q, rx.Union) else [q])
        # a union of plain labels/classes with one direction is a class
        if all(isinstance(p, (rx.Label, rx.LabelClass)) for p in flat) and len(
            {p.inverse for p in flat}
        ) == 1:
            names: set[str] = set()
            for p in flat:
                names |= {p.name} if isinstance(p, rx.Label) else set(p.names)
            return normalize(rx.LabelClass(tuple(sorted(names)), inverse=flat[0].inverse))
        uniq = {serialize(p): p for p in flat}
        parts = tuple(uniq[k] for k in sorted(uniq))
        return parts[0] if len(parts) == 1 else rx.Union(parts)
    if isinstance(node, rx.Star):
        return rx.Star(normalize(node.inner))
    if isinstance(node, rx.Plus):
        return rx.Plus(normalize(node.inner))
    if isinstance(node, rx.Optional_):
        return rx.Optional_(normalize(node.inner))
    raise TypeError(node)


def serialize(node: rx.Node) -> str:
    """Deterministic string form of an AST (used as the cache key)."""
    inv = lambda n: "^-1" if getattr(n, "inverse", False) else ""  # noqa: E731
    if isinstance(node, rx.Label):
        return f"L[{node.name}]{inv(node)}"
    if isinstance(node, rx.Wildcard):
        return f".{inv(node)}"
    if isinstance(node, rx.LabelClass):
        return "{" + ",".join(node.names) + "}" + inv(node)
    if isinstance(node, rx.Concat):
        return "(" + " ".join(serialize(p) for p in node.parts) + ")"
    if isinstance(node, rx.Union):
        return "(" + "|".join(serialize(p) for p in node.parts) + ")"
    if isinstance(node, rx.Star):
        return serialize(node.inner) + "*"
    if isinstance(node, rx.Plus):
        return serialize(node.inner) + "+"
    if isinstance(node, rx.Optional_):
        return serialize(node.inner) + "?"
    raise TypeError(node)


def canonical_key(query: str | rx.Node) -> str:
    """Normalized cache key for a query string or AST."""
    ast = rx.parse(query) if isinstance(query, str) else query
    return serialize(normalize(ast))


# ---------------------------------------------------------------------------
# LRU
# ---------------------------------------------------------------------------


class _LRU:
    """Tiny LRU dict with hit/miss counters."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable) -> Any | None:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"size": len(self._d), "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate}


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanEntry:
    """Everything reusable across requests of one (query class, epoch).

    The last fields are per-service constants of the entry (the
    service's config is fixed), precomputed at miss time so
    warm-cache requests skip the transition-run scan entirely."""

    key: str
    ast: rx.Node
    ca: CompiledAutomaton
    estimates: Any  # planner.PlanEstimates
    fkey: tuple = ()  # feedback.label_class_key(ast)
    label_mask: Any = None  # (n_labels,) bool
    sig: tuple = ()  # automaton_signature for the service's config
    # query-class fast path (planner.classify_query): the automaton the
    # executors actually run — reduced to 1 state for pure closures —
    # and its level cap; plus the witness-semantics signature, so pairs
    # and witness requests of one query class resolve distinct executors
    exec_ca: CompiledAutomaton | None = None
    exec_max_levels: int | None = None
    query_class: Any = None  # planner.QueryClass
    sig_witness: tuple = ()


class PlanCache:
    """LRU of :class:`PlanEntry` keyed by (canonical key, stats epoch)."""

    def __init__(self, maxsize: int = 256):
        self._lru = _LRU(maxsize)

    def get(self, key: str, epoch: int) -> PlanEntry | None:
        return self._lru.get((key, epoch))

    def put(self, key: str, epoch: int, entry: PlanEntry) -> None:
        self._lru.put((key, epoch), entry)

    def stats(self) -> dict:
        return self._lru.stats()

    @property
    def hit_rate(self) -> float:
        return self._lru.hit_rate


# ---------------------------------------------------------------------------
# Executor cache
# ---------------------------------------------------------------------------


class Signature(NamedTuple):
    """Structural identity of a compiled S2 executor: everything
    :func:`~repro_torch.core.strategies.make_s2_step_fn` closes over.
    ``repro``'s positional tuple, read by name, with its three mesh
    fields last: ``mesh_key``, ``((axis name, size), ...)`` of the mesh
    (``()`` with none), and the site and batch axes."""

    n_states: int
    start: int
    accepting: tuple[int, ...]
    runs: tuple
    n_nodes: int
    max_levels: int | None
    backend: str
    block_size: int
    semantics: str
    tile_dtype: str
    mesh_key: tuple = ()
    site_axes: tuple[str, ...] = ("data",)
    batch_axis: str | None = "model"


def mesh_key(mesh) -> tuple:
    """``((axis name, size), ...)`` of ``mesh`` in its axis order; ``()``
    for one card."""
    if mesh is None:
        return ()
    return tuple(shd.mesh_sizes(mesh).items())


def automaton_signature(
    ca: CompiledAutomaton,
    n_nodes: int,
    max_levels: int | None = None,
    backend: str = "reference",
    block_size: int = 128,
    semantics: str = "pairs",
    tile_dtype: str = "f32",
    mesh=None,
    site_axes: tuple[str, ...] = ("data",),
    batch_axis: str | None = "model",
) -> Signature:
    """Structural identity of a compiled S2 executor: the fused transition
    runs, start/accepting states, node count, the level cap, the backend
    and its tile block size, the answer semantics (``"pairs"`` and
    ``"witness"`` executors carry different planes), the staged tile
    dtype, and the mesh's shape with the site and batch axes (a program
    per rank of one mesh is not another's).  The out-of-core ``tile_store_budget_bytes`` is deliberately
    NOT part of it: it changes where Stage A's bytes live, never the
    staged values an executor reads.  Two queries with equal signatures
    build identical executors and share one."""
    return Signature(
        n_states=ca.n_states,
        start=ca.start,
        accepting=tuple(ca.accepting),
        runs=strategies.transition_runs(ca),
        n_nodes=n_nodes,
        max_levels=max_levels,
        backend=backend,
        block_size=block_size,
        semantics=semantics,
        tile_dtype=tile_dtype,
        mesh_key=mesh_key(mesh),
        site_axes=tuple(site_axes),
        batch_axis=batch_axis,
    )


@dataclasses.dataclass
class _ExecEntry:
    """One built executor and the keys it lives under.  ``anchor`` pins
    the placement/graph whose ``id()`` is in ``graph_key``, so a
    collected placement cannot hand its address to a new object and
    alias a stale executor.  ``release()`` frees the executor's fixpoint
    loops (``fn.release()``: their CUDA graphs and static state) and drops
    its closure (its Stage-B plan, degree vectors and staged tensors), so
    an evicted signature's device memory frees once the shared Stage-A
    entry in the plan store is dropped too."""

    graph_key: tuple
    sig: Signature
    fn: Callable | None
    anchor: Any = None

    def release(self) -> None:
        if self.fn is not None and hasattr(self.fn, "release"):
            self.fn.release()
        self.fn = None


class ExecutorCache:
    """Two-level LRU of S2 executors: graph key → automaton signature
    (see the module docstring).  Owns (or shares) the
    :class:`~repro_torch.core.plans.GraphPlanStore` that Stage A of every
    build is routed through."""

    def __init__(self, maxsize: int = 64, plan_store: plans_mod.GraphPlanStore | None = None):
        self.maxsize = maxsize
        self.plan_store = plan_store if plan_store is not None else plans_mod.GraphPlanStore()
        self._lru: OrderedDict[tuple, _ExecEntry] = OrderedDict()  # (graph_key, sig) ->
        self._by_graph: dict[tuple, set[Signature]] = {}  # graph_key -> {sig}
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.releases = 0

    @staticmethod
    def graph_key(
        stats_epoch: int,
        backend: str,
        block_size: int,
        graph: Any = None,
        placement: Any = None,
        bucket_id: tuple | None = None,
    ) -> tuple:
        """Everything Stage A depends on: the graph-stats epoch, the
        data's identity (the placement when given, else the global
        graph), the staging parameters, and for the sharded backend the
        shape-bucket descriptor
        (:attr:`repro_torch.kernels.frontier.ops.ShardedTileBuckets.bucket_id`):
        two executors over one placement with different bucket layouts
        (axis size, floor, tile classes) read different tile stacks and
        must not alias."""
        anchor = placement if placement is not None else graph
        return (stats_epoch, id(anchor) if anchor is not None else None, backend, block_size, bucket_id)

    def _evict(self, key: tuple) -> None:
        entry = self._lru.pop(key)
        sigs = self._by_graph.get(entry.graph_key)
        if sigs is not None:
            sigs.discard(entry.sig)
            if not sigs:
                del self._by_graph[entry.graph_key]
        entry.release()
        self.releases += 1

    def get_or_build(
        self,
        ca: CompiledAutomaton,
        n_nodes: int,
        max_levels: int | None = None,
        signature: Signature | None = None,
        backend: str = "frontier_kernel",
        graph: Any = None,
        replication_factor: float = 1.0,
        block_size: int = 128,
        placement: Any = None,
        stats_epoch: int = 0,
        semantics: str = "pairs",
        tile_dtype: str = "f32",
        tile_store_budget_bytes: int | None = None,
        axis_size: int = 1,
        bucket_floor: int | None = None,
        mesh=None,
        site_axes: tuple[str, ...] = ("data",),
        batch_axis: str | None = "model",
    ) -> tuple[Signature, Callable]:
        """``signature`` accepts the precomputed key (the service computes
        it once per request during planning).  ``stats_epoch`` scopes the
        Stage-A artifacts the build reuses from the plan store, on the
        store's device.  For the sharded backend the placement's shape
        buckets at (``axis_size``, ``bucket_floor``) are resolved first (a
        store hit when the placement is hot; on a ``mesh``, the rank's
        row, whose first build is a collective), and their descriptor
        joins the graph key.  ``mesh``, ``site_axes`` and ``batch_axis``
        reach the signature and the executor: on a mesh the build is the
        rank's program, and ``axis_size`` must be the site axes' size."""
        sig = (
            signature
            if signature is not None
            else automaton_signature(ca, n_nodes, max_levels, backend, block_size, semantics, tile_dtype,
                                     mesh, site_axes, batch_axis)
        )
        bucket_id = None
        if backend == "frontier_kernel_sharded" and placement is not None:
            floor = fops.BUCKET_FLOOR if bucket_floor is None else bucket_floor
            bucket_id = self.plan_store.tile_buckets(
                placement, block_size, axis_size, stats_epoch, floor,
                "f32" if semantics == "witness" else tile_dtype, mesh, site_axes,
            ).bucket_id
        gkey = self.graph_key(stats_epoch, backend, block_size, graph, placement, bucket_id)
        key = (gkey, sig)
        entry = self._lru.get(key)
        if entry is not None:
            self._lru.move_to_end(key)
            self.hits += 1
            return sig, entry.fn
        self.misses += 1
        fn = strategies.make_s2_step_fn(
            ca, n_nodes, max_levels,
            backend=backend, graph=graph, replication_factor=replication_factor,
            block_size=block_size, semantics=semantics, tile_dtype=tile_dtype,
            plan_store=self.plan_store, stats_epoch=stats_epoch,
            tile_store_budget_bytes=tile_store_budget_bytes, placement=placement,
            axis_size=None if mesh is not None else axis_size, bucket_floor=bucket_floor,
            mesh=mesh, site_axes=site_axes, batch_axis=batch_axis,
        )
        self._lru[key] = _ExecEntry(
            graph_key=gkey, sig=sig, fn=fn, anchor=placement if placement is not None else graph,
        )
        self._by_graph.setdefault(gkey, set()).add(sig)
        self.builds += 1
        while len(self._lru) > self.maxsize:
            self._evict(next(iter(self._lru)))
        return sig, fn

    def drop_epoch(self, keep_epoch: int) -> int:
        """Release every executor whose graph key belongs to another stats
        epoch, and the plan store's stale Stage-A entries with them — the
        one-shot invalidation a graph-epoch bump triggers.  Executors
        already handed out keep working: only cache references go."""
        stale = [k for k, e in self._lru.items() if e.graph_key[0] != keep_epoch]
        for k in stale:
            self._evict(k)
        self.plan_store.invalidate_epoch(keep_epoch)
        return len(stale)

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "size": len(self._lru),
            "graphs": len(self._by_graph),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "builds": self.builds,
            "releases": self.releases,
        }

    def frontier_mem_stats(self) -> dict:
        """The frontier memory-roofline block of the serve summary (schema:
        :func:`repro_torch.serve.metrics._empty_frontier_mem_stats`), from
        the cached executors' signatures alone: every fused executor's
        fixpoint chunk carries a ``(n_states · QPAD, v_pad)`` frontier at
        4 bytes an element whatever its dtype — f32 rows hold 8 query
        lanes a chunk, packed lane words 256 — so ``bytes_per_lane`` is
        the roofline the dtypes differ on (32×).  ``staging_chunks`` and
        the ``tile_store`` block come from the shared plan store."""
        out = metrics._empty_frontier_mem_stats()
        for entry in self._lru.values():
            sig = entry.sig
            if sig.backend == "frontier_kernel_packed":
                dtype, lanes = "packed", fops.QPACK
            elif sig.backend in ("frontier_kernel", "frontier_kernel_sharded"):
                dtype, lanes = "f32", fops.QPAD
            else:
                continue  # reference backend: no tiled frontier operand
            v_pad = -(-sig.n_nodes // sig.block_size) * sig.block_size
            out["executors"][dtype] += 1
            out["frontier_bytes"][dtype] += sig.n_states * fops.QPAD * v_pad * 4
            out["lane_capacity"][dtype] += lanes
        for dtype in ("f32", "packed"):
            lanes = out["lane_capacity"][dtype]
            out["bytes_per_lane"][dtype] = out["frontier_bytes"][dtype] / lanes if lanes else 0.0
        out["staging_chunks"] = self.plan_store.staging_chunks
        out["tile_store"] = self.plan_store.tile_store_stats()
        return out
