"""Distributed RPQ processing strategies (paper §3) and message
accounting, on one device.

Port of ``repro/core/strategies.py``:

* **S1 — top-down** (§3.3, §4.2.1): one broadcast of the query's distinct
  labels; every site unicasts its label-matching edges; the PAA then runs
  locally on the collected (deduplicated) subgraph.  The sites are the
  leading dimension of the placement's padded arrays on the device.
* **S2 — bottom-up** (§3.3, §4.2.2): the PAA runs at the querying site;
  each BFS level's neighbour lookup is a broadcast search answered by the
  sites holding matching edges, with a local cache deduplicating repeated
  searches.  Two global fused backends: ``frontier_kernel`` (8 stacked
  queries in f32 rows) and ``frontier_kernel_packed`` (256 query lanes in
  int32 words), on either tile store.
* **S3 — query shipping** (§3.1/§3.5.5) and **S4 — query decomposition**
  (§3.2/§3.5.6) are meters only, as in ``repro``.

The meters count message symbols with the paper's conventions (a symbol
= one node id or label; an edge = 3 symbols; broadcasting b symbols costs
2·N_c·b messages).

Both fused backends also run ``semantics="witness"``: the fixpoint
carries each product state's discovery level, the implicit parent
pointers of :mod:`repro_torch.core.witness`.

Executor builds are two-stage: with ``plan_store`` (a
:class:`repro_torch.core.plans.GraphPlanStore`) the fused backends fetch
their Stage A — the staged tiles, under a ``tile_store_budget_bytes``
the out-of-core subset, and the per-label degree vectors — from the
shared store, and only Stage B is built per executor.

What waits for a later slice (each raises ``NotImplementedError`` naming
its ``ROADMAP.md`` item): the ``reference`` and ``frontier_kernel_sharded``
backends and the multi-device S1 gather (A12).  The ``mesh``,
``site_axes`` and ``batch_axis`` parameters of ``repro`` are dropped: on
one device nothing uses them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core import paa
from repro_torch.core.automaton import FWD, CompiledAutomaton
from repro_torch.core.regex import Node, has_wildcard, labels_of, query_size
from repro_torch.graph.partition import Placement
from repro_torch.graph.structure import LabeledGraph
from repro_torch.kernels.frontier import frontier as fkernel
from repro_torch.kernels.frontier import ops as fops

# ---------------------------------------------------------------------------
# Message accounting (the paper's cost metrics, §4.2)
# ---------------------------------------------------------------------------

EDGE_SYMBOLS = 3  # "an edge is expressed as 3 symbols" (§4.2.1)


@dataclasses.dataclass(frozen=True)
class StrategyCost:
    """Symbol counts for one query execution under one strategy.

    ``broadcast_symbols`` is the paper's Q_lbl (S1) / Q_bc (S2);
    ``unicast_symbols`` is D_s1 / D_s2 — *single-copy* data, the K
    replication multiplier is applied by the cost functions (Eqs. 1–2).
    ``site_unicast_symbols`` is the measured per-site response breakdown
    that only the site-sharded backend (A12) fills in."""

    strategy: str
    broadcast_symbols: float
    unicast_symbols: float
    n_broadcasts: int = 0
    edges_retrieved: int = 0
    site_unicast_symbols: tuple[float, ...] = ()


def s1_costs(ast: Node, graph: LabeledGraph) -> StrategyCost:
    """§4.2.1: broadcast = #distinct labels; unicast = 3 × matching edges.

    A wildcard forces the full edge set (§3.6 — 'the mere presence of a
    wildcard is enough' to hit the worst case)."""
    lbls = labels_of(ast)
    lmap = graph.label_to_id
    if has_wildcard(ast):
        n_match = graph.n_edges
    else:
        ids = [lmap[l] for l in lbls if l in lmap]
        counts = graph.label_counts()
        n_match = int(sum(counts[i] for i in ids))
    return StrategyCost(
        strategy="S1",
        broadcast_symbols=float(len(lbls)),
        unicast_symbols=float(EDGE_SYMBOLS * n_match),
        n_broadcasts=1,
        edges_retrieved=n_match,
    )


def s2_costs(
    ca: CompiledAutomaton,
    index: paa.HostIndex,
    start_node: int,
    max_pops: int | None = None,
) -> StrategyCost:
    """§4.2.2: instrumented PAA (cache on).  Also usable as the §3.6
    'interruptible' capped execution via ``max_pops``."""
    tr = paa.run_instrumented(ca, index, start_node, max_pops=max_pops)
    return StrategyCost(
        strategy="S2",
        broadcast_symbols=float(tr.q_bc),
        unicast_symbols=float(tr.d_s2),
        n_broadcasts=tr.n_broadcasts,
        edges_retrieved=tr.edges_traversed,
    )


def s3_costs(ca: CompiledAutomaton, index: paa.HostIndex, start_node: int) -> StrategyCost:
    """§3.5.5: query shipping = S2's traversal with no cache (each hop's
    broadcast is issued by a different site, so nothing deduplicates)."""
    tr = _run_uncached(ca, index, start_node)
    return StrategyCost(
        strategy="S3",
        broadcast_symbols=float(tr.q_bc),
        unicast_symbols=float(tr.d_s2),
        n_broadcasts=tr.n_broadcasts,
        edges_retrieved=tr.edges_traversed,
    )


def s4_costs(ast: Node, graph: LabeledGraph, placement: Placement) -> StrategyCost:
    """§3.5.6 at the non-localized degenerate bound: sites must exchange
    their potentially-outgoing edges (all of them — K·|E| copies, 3 symbols
    each) before the one-round query; responses may carry the full traversed
    subgraph.  We charge the label-restricted subgraph as the response
    (the best case S4 could do with the paper's label selection)."""
    m = query_size(ast)
    K = placement.replication_factor
    bc = EDGE_SYMBOLS * K * graph.n_edges + m
    s1 = s1_costs(ast, graph)
    return StrategyCost(
        strategy="S4",
        broadcast_symbols=float(bc),
        unicast_symbols=float(s1.unicast_symbols),
        n_broadcasts=1 + placement.n_sites,
        edges_retrieved=s1.edges_retrieved,
    )


def _run_uncached(ca, index, start_node):
    """Instrumented PAA variant with the broadcast cache disabled (S3)."""
    graph = index.graph
    tr = paa.S2Trace()
    outs: dict[int, list] = {}
    for t in ca.transitions:
        outs.setdefault(t.src, []).append(t)
    state_symbols = {q: sorted({(t.label_id, t.direction) for t in ts}) for q, ts in outs.items()}
    visited = {(ca.start, int(start_node))}
    queue = [(ca.start, int(start_node))]
    accepting = set(ca.accepting)
    if ca.start in accepting:
        tr.answers.add(int(start_node))
    seen_edges: set[int] = set()
    while queue:
        q, v = queue.pop()
        tr.nodes_visited += 1
        symbols = state_symbols.get(q)
        if not symbols:
            continue
        tr.n_broadcasts += 1
        tr.q_bc += 1 + len(symbols)
        for (label_id, direction) in symbols:
            if label_id >= 0:
                eids = index.out_edges(v, label_id) if direction == FWD else index.in_edges(v, label_id)
            else:
                eids = index.all_out_edges(v) if direction == FWD else index.all_in_edges(v)
            tr.d_s2 += EDGE_SYMBOLS * len(eids)
            for e in eids:
                seen_edges.add(int(e) if direction == FWD else -int(e) - 1)
        for t in outs[q]:
            if t.label_id >= 0:
                eids = index.out_edges(v, t.label_id) if t.direction == FWD else index.in_edges(v, t.label_id)
            else:
                eids = index.all_out_edges(v) if t.direction == FWD else index.all_in_edges(v)
            nbrs = graph.dst[eids] if t.direction == FWD else graph.src[eids]
            for nb in nbrs:
                key = (t.dst, int(nb))
                if key not in visited:
                    visited.add(key)
                    queue.append(key)
                if t.dst in accepting:
                    tr.answers.add(int(nb))
    tr.edges_traversed = len(seen_edges)
    return tr


# ---------------------------------------------------------------------------
# S1 executor — one broadcast, one gather, local PAA
# ---------------------------------------------------------------------------


def stage_site_arrays(
    placement: Placement, device: str | torch.device | None = None
) -> dict[str, torch.Tensor]:
    """The placement's padded per-site arrays
    (:meth:`~repro_torch.graph.partition.Placement.padded_device_arrays`)
    on ``device`` (``None``: the GPU), staged once for every S1 gather."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(a).to(dev) for k, a in placement.padded_device_arrays().items()}


def s1_gather(
    site_arrays: dict[str, torch.Tensor],
    label_mask: np.ndarray,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Collect, from every site, its edges whose label is in ``label_mask``.

    Each site compacts matches to a static ``cap``-sized buffer (matched
    edges sorted first) — the unicast response phase of S1 with static
    shapes.  ``cap`` is chosen by the planner from the D_s1 estimate
    (§5.2.2); the returned ``overflow`` count is non-zero if any site had
    more matches than the buffer, in which case the caller re-runs with a
    larger cap.

    ``site_arrays`` holds the (n_sites, max_e) arrays on one device
    (:func:`stage_site_arrays`).  The compaction is a stable sort of each
    site's row on a uint8 ``~match`` key, so the buffers hold ``repro``'s
    ``argsort(stable=True)`` order.  Returns (src, lbl, dst, valid_mask)
    of shape (n_sites, min(cap, max_e)) on that device plus the global
    overflow count, read on the host (one sync).
    """
    src, lbl, dst, mask = (site_arrays[k] for k in ("src", "lbl", "dst", "mask"))
    lblmask = torch.as_tensor(label_mask, dtype=torch.bool, device=src.device)
    match = mask & lblmask.index_select(0, lbl.reshape(-1)).reshape(lbl.shape)
    take = torch.sort((~match).to(torch.uint8), dim=1, stable=True).indices[:, :cap]
    overflow = int((match.sum(dim=1) - cap).clamp_min(0).sum())
    return src.gather(1, take), lbl.gather(1, take), dst.gather(1, take), match.gather(1, take), overflow


def query_label_mask(ast: Node, graph: LabeledGraph) -> np.ndarray:
    """(n_labels,) bool mask of the query's labels; all-True on wildcard
    (§3.6 — a wildcard defeats S1's label selection)."""
    mask = np.zeros(graph.n_labels, bool)
    if has_wildcard(ast):
        mask[:] = True
    else:
        lbl_ids = {graph.label_to_id[l] for l in labels_of(ast) if l in graph.label_to_id}
        mask[sorted(lbl_ids)] = True
    return mask


def gathered_subgraph(
    graph: LabeledGraph,
    src: torch.Tensor,
    lbl: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
) -> LabeledGraph:
    """The querying site's view of one gather: the valid entries, in site
    order, copied to the host and deduplicated there (replicated copies
    collapse, §3.5.1), as ``repro``'s :func:`s1_collect` does."""
    v = valid.reshape(-1)
    sub = LabeledGraph(
        graph.n_nodes, *(a.reshape(-1)[v].cpu().numpy() for a in (src, lbl, dst)), graph.labels
    )
    return sub.dedup()


def s1_collect(
    placement: Placement,
    label_mask: np.ndarray,
    cap: int | None = None,
    device_arrays: dict[str, torch.Tensor] | None = None,
    device: str | torch.device | None = None,
) -> LabeledGraph:
    """S1's retrieval phase: gather every site's ``label_mask``-matching
    edges and deduplicate the replicated copies at the querying site.

    ``device_arrays`` accepts the placement's already-staged padded site
    arrays (:func:`stage_site_arrays`), so serving loops skip the
    per-call rebuild; without them they are staged on ``device``
    (``None``: the GPU)."""
    site_arrays = device_arrays if device_arrays is not None else stage_site_arrays(placement, device)
    if cap is None:
        cap = site_arrays["src"].shape[1]
    while True:
        src, lbl, dst, valid, overflow = s1_gather(site_arrays, label_mask, cap)
        if overflow == 0:
            break
        cap = min(2 * cap, site_arrays["src"].shape[1])  # planner underestimated: grow
    return gathered_subgraph(placement.graph, src, lbl, dst, valid)


def s1_execute(
    placement: Placement,
    ast: Node,
    ca: CompiledAutomaton,
    start_node: int,
    cap: int | None = None,
    device_arrays: dict[str, torch.Tensor] | None = None,
    device: str | torch.device | None = None,
) -> tuple[set[int], StrategyCost]:
    """Full S1: broadcast labels → gather matching edges → dedup → local
    PAA (the device BFS, :func:`repro_torch.core.paa.answers_single_source`,
    on the sites' device)."""
    graph = placement.graph
    site_arrays = device_arrays if device_arrays is not None else stage_site_arrays(placement, device)
    sub = s1_collect(placement, query_label_mask(ast, graph), cap, site_arrays)
    dg = paa.device_form(sub, site_arrays["src"].device)
    acc = paa.answers_single_source(ca, dg, start_node).cpu().numpy()
    answers = set(np.nonzero(acc)[0].tolist())
    return answers, s1_costs(ast, graph)


# ---------------------------------------------------------------------------
# S2 executor structure
# ---------------------------------------------------------------------------


def _fuse_label_runs(ids: list[int]) -> list[tuple[int | None, int | None]]:
    """Fuse a sorted label-id list into contiguous (lo, hi) ranges; a
    negative id (wildcard) yields the (None, None) match-everything run."""
    runs: list[tuple[int | None, int | None]] = []
    if any(i < 0 for i in ids):
        runs.append((None, None))
    ids = sorted(i for i in ids if i >= 0)
    start = prev = None
    for i in ids:
        if start is None:
            start = prev = i
        elif i == prev + 1:
            prev = i
        else:
            runs.append((start, prev))
            start = prev = i
    if start is not None:
        runs.append((start, prev))
    return runs


def transition_runs(
    ca: CompiledAutomaton,
) -> tuple[tuple[int, int, int, int | None, int | None], ...]:
    """Transitions that share (src_state, dst_state, direction) and carry
    *contiguous* label ids fuse into ONE range predicate.  The run list is
    also the executor's *structural signature* (the serve layer's
    executor cache keys on it)."""
    groups: dict[tuple[int, int, int], list[int]] = {}
    for t in ca.transitions:
        groups.setdefault((t.src, t.dst, t.direction), []).append(t.label_id)
    runs: list[tuple[int, int, int, int | None, int | None]] = []
    for (s_st, d_st, direction), ids in sorted(groups.items()):
        for lo, hi in _fuse_label_runs(ids):
            runs.append((s_st, d_st, direction, lo, hi))
    return tuple(runs)


def symbol_set_groups(
    ca: CompiledAutomaton,
) -> tuple[tuple[tuple[tuple[int, int], ...], tuple[int, ...]], ...]:
    """Automaton states grouped by their out-symbol set, as
    ``((symset, states), ...)`` with ``symset`` the sorted distinct
    (label_id, direction) pairs.  States with no out-transitions issue no
    broadcast (§4.2.2) and are omitted.  This is the §4.2.2 broadcast-cache
    key structure: the device meters dedup by (group, node) to agree with
    the host meter."""
    syms: dict[int, set] = {}
    for t in ca.transitions:
        syms.setdefault(t.src, set()).add((t.label_id, t.direction))
    groups: dict[tuple, list[int]] = {}
    for q, s in syms.items():
        groups.setdefault(tuple(sorted(s)), []).append(q)
    return tuple(
        sorted((symset, tuple(sorted(states))) for symset, states in groups.items())
    )


def _site_symbol_degrees(
    sgroups, site_graphs: list[LabeledGraph], v_pad: int, label_deg: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Per-site, per-symbol-set-group matching-edge counts by node.

    ``deg[s, g, v]`` is the number of edges site ``s`` holds that match
    group ``g``'s symbol set and are incident (in the search direction)
    to node ``v`` — the unicast response size site ``s`` contributes to
    one broadcast at ``v`` (§4.2.2).  ``payloads[g]`` is the broadcast
    payload 1 + |symset|.

    ``label_deg`` accepts the Stage-A per-(site, label, direction)
    vectors of :func:`repro_torch.core.plans.label_degree_vectors`: the
    group vectors then reduce to row sums (a wildcard sums every label —
    each edge has exactly one), so warm executor builds skip the
    per-edge ``np.add.at`` scans."""
    n_groups = max(len(sgroups), 1)
    deg = np.zeros((len(site_graphs), n_groups, v_pad), np.float32)
    payloads = np.zeros(n_groups, np.float32)
    for gi, (symset, _) in enumerate(sgroups):
        payloads[gi] = 1 + len(symset)
        if label_deg is not None:
            for lid, dirn in symset:
                d = 0 if dirn == FWD else 1
                if lid < 0:
                    deg[:, gi] += label_deg[:, :, d].sum(axis=1)
                else:
                    deg[:, gi] += label_deg[:, lid, d]
            continue
        for s, g_s in enumerate(site_graphs):
            for lid, dirn in symset:
                sel = slice(None) if lid < 0 else g_s.lbl == lid
                ends = (g_s.src if dirn == FWD else g_s.dst)[sel]
                np.add.at(deg[s, gi], ends, 1.0)
    return deg, payloads


_PORTED = {
    "backend": ("frontier_kernel", "frontier_kernel_packed"),
    "semantics": ("pairs", "witness"),
    "tile_dtype": fops.TILE_DTYPES,
}
_NOT_PORTED = {
    "backend": {"reference": "A12", "frontier_kernel_sharded": "A12"},
    "semantics": {},
    "tile_dtype": {},
}


def _require_ported(backend: str, semantics: str, tile_dtype: str) -> None:
    for name, value in (("backend", backend), ("semantics", semantics), ("tile_dtype", tile_dtype)):
        if value in _PORTED[name]:
            continue
        item = _NOT_PORTED[name].get(value)
        if item is None:
            raise ValueError(f"unknown {name}={value!r}")
        raise NotImplementedError(
            f"{name}={value!r} is not ported yet (ROADMAP.md {item}); "
            f"this package runs {name} in {_PORTED[name]}"
        )


def make_s2_step_fn(
    ca: CompiledAutomaton,
    n_nodes: int,
    max_levels: int | None = None,
    backend: str = "frontier_kernel",
    graph: LabeledGraph | None = None,
    replication_factor: float = 1.0,
    block_size: int = 128,
    semantics: str = "pairs",
    tile_dtype: str = "f32",
    staged=None,
    device: str | torch.device | None = None,
    plan_store=None,
    stats_epoch: int = 0,
    tile_store_budget_bytes: int | None = None,
):
    """Build the batched S2 executor.

    ``backend="frontier_kernel"`` — the fused level kernel: the whole BFS
    level over all transitions is ONE launch on the block-sparse tiles of
    ``graph`` (required), with up to 8 queries stacked into the rows of
    each automaton state.  ``backend="frontier_kernel_packed"`` — the
    same level on int32 lane words: 256 queries per fixpoint, one bit
    each.  ``tile_dtype`` picks the tile store either backend reads:
    ``"f32"`` or the ``"uint32"`` bit-planes.  ``replication_factor``
    scales the unicast symbols to ``repro``'s summed-per-site convention
    (in f32, as ``repro`` does) so :func:`s2_execute` can divide it back
    out.
    Retrieval is modeled on the deduplicated *global* graph.

    Stage A comes from one of three places: ``staged``, a prebuilt
    Stage A (:func:`repro_torch.kernels.frontier.ops.stage_graph` of
    ``graph`` at ``block_size`` and ``tile_dtype``); ``plan_store``, the
    shared :class:`~repro_torch.core.plans.GraphPlanStore`, keyed by
    ``stats_epoch`` (its device is the executor's, and it also serves the
    meters' per-label degree vectors); or neither, and the executor
    stages its own on ``device`` (``None``: the GPU).
    ``tile_store_budget_bytes`` turns on the out-of-core tile store and
    needs ``plan_store``: Stage A is assembled from only the automaton's
    required (direction, label) slabs, cold host slabs spilling to disk
    beyond the budget (see
    :meth:`repro_torch.core.plans.GraphPlanStore.staged_graph`).

    Returns ``fn(starts) -> (answers, q_bc, d_s2, n_bc)``: ``starts``
    (B,) int node ids; answers (B, n_nodes) bool, and per start the
    observed §4.2 meters — broadcast symbols, unicast response symbols
    (× K) and distinct broadcast searches — all torch tensors on the
    device.  The meters dedup broadcasts by (symbol-set, node), the
    §4.2.2 cache key, so they agree with the host meter.

    ``semantics="witness"`` grows the fixpoint's carry by one f32
    *discovery level* plane (see :mod:`repro_torch.core.witness`) and
    appends one output, last: ``levels`` (B, n_states, n_nodes) f32 on
    the device — level 1 at the start pair, +1 per expansion,
    ``INF_LEVEL`` when unreached.  Answers and meters are unchanged.  The
    bit-plane store is boolean-only, so witness semantics stages f32
    whatever ``tile_dtype`` asks for, as ``repro`` does; a prebuilt
    ``staged`` that is not the f32 store raises ``ValueError`` rather
    than being restaged behind the caller's back.
    """
    _require_ported(backend, semantics, tile_dtype)
    if semantics == "witness":
        if staged is not None and staged.tile_dtype != "f32":
            raise ValueError(
                "semantics='witness' needs the f32 tile store; the staged graph holds "
                f"tile_dtype {staged.tile_dtype!r} (pass an f32 Stage A, or none)"
            )
        tile_dtype = "f32"
    make = (
        _make_frontier_packed_step_fn
        if backend == "frontier_kernel_packed"
        else _make_frontier_step_fn
    )
    return make(
        ca, n_nodes, max_levels, graph, replication_factor, block_size, tile_dtype,
        staged, device, semantics, plan_store, stats_epoch, tile_store_budget_bytes,
    )


def _fetch_staged_graph(
    ca: CompiledAutomaton,
    graph: LabeledGraph,
    block_size: int,
    plan_store,
    stats_epoch: int,
    tile_dtype: str,
    budget_bytes: int | None,
    device,
):
    """Stage-A fetch shared by the two global fused executors: from the
    plan store when one is passed (the budgeted path assembles only the
    automaton's required (direction, label) slabs), staged locally on
    ``device`` otherwise.  The budget requires a store: the out-of-core
    slab cache lives in the :class:`~repro_torch.core.plans.GraphPlanStore`."""
    if plan_store is not None:
        if budget_bytes is not None:
            return plan_store.staged_graph(
                graph, block_size, epoch=stats_epoch, tile_dtype=tile_dtype,
                budget_bytes=budget_bytes, keys=fops.required_offset_keys(ca),
            )
        return plan_store.staged_graph(graph, block_size, epoch=stats_epoch, tile_dtype=tile_dtype)
    if budget_bytes is not None:
        raise ValueError(
            "tile_store_budget_bytes requires plan_store= (the out-of-core "
            "slab cache lives in the GraphPlanStore)"
        )
    return fops.stage_graph(graph, block_size, tile_dtype=tile_dtype, device=device)


def _frontier_setup(
    ca: CompiledAutomaton,
    n_nodes: int,
    graph: LabeledGraph | None,
    block_size: int,
    tile_dtype: str,
    staged,
    device,
    backend: str,
    plan_store=None,
    stats_epoch: int = 0,
    budget_bytes: int | None = None,
):
    """What both fused executors build before their first call: the
    Stage-B plan over ``staged`` (fetched by :func:`_fetch_staged_graph`
    when ``None``), and the meters' symbol-set groups with their degree
    vectors and payloads on the plan's device."""
    if graph is None:
        raise ValueError(
            f"backend={backend!r} requires graph= (the placement's global graph)"
        )
    if graph.n_nodes != n_nodes:
        raise ValueError(f"graph has {graph.n_nodes} nodes, executor built for {n_nodes}")
    if staged is None:
        staged = _fetch_staged_graph(
            ca, graph, block_size, plan_store, stats_epoch, tile_dtype, budget_bytes, device
        )
    elif plan_store is not None or budget_bytes is not None:
        raise ValueError("pass staged= or plan_store= (with its budget), not both")
    elif (staged.n_nodes, staged.block_size, staged.tile_dtype) != (n_nodes, block_size, tile_dtype):
        raise ValueError(
            f"staged graph is ({staged.n_nodes} nodes, block {staged.block_size}, "
            f"tile_dtype {staged.tile_dtype!r}), executor built for ({n_nodes} nodes, "
            f"block {block_size}, tile_dtype {tile_dtype!r})"
        )
    plan = fops.build_level_schedule(ca, staged)
    dev = plan.tiles.device
    sgroups = symbol_set_groups(ca)
    label_deg = (
        plan_store.label_degrees(graph, [graph], graph.n_labels, plan.v_pad, epoch=stats_epoch)
        if plan_store is not None
        else None
    )
    deg, payloads = _site_symbol_degrees(sgroups, [graph], plan.v_pad, label_deg)
    deg_c = torch.from_numpy(deg[0]).to(dev)
    pay_c = torch.from_numpy(payloads).to(dev)
    return plan, sgroups, deg_c, pay_c


def _make_frontier_step_fn(
    ca: CompiledAutomaton,
    n_nodes: int,
    max_levels: int | None,
    graph: LabeledGraph | None,
    replication_factor: float,
    block_size: int,
    tile_dtype: str = "f32",
    staged=None,
    device: str | torch.device | None = None,
    semantics: str = "pairs",
    plan_store=None,
    stats_epoch: int = 0,
    tile_store_budget_bytes: int | None = None,
):
    """The fused-kernel S2 executor (``backend="frontier_kernel"``).

    Each call stacks the start batch into chunks of ``QPAD`` (=8) queries
    and runs one fixpoint per chunk: one kernel launch and one host sync
    per BFS level (``repro`` runs the chunks under ``lax.map`` and each
    fixpoint in a ``lax.while_loop``).  Rows of a last, short chunk stay
    empty, where ``repro`` starts them at node 0 and discards them: the
    answers and meters of the real rows are the same.

    The §4.2 observed accounting runs inside the same loop on
    per-(symbol-set group) degree vectors, with a (group, node) dedup
    bitmap carried across levels — the same cache semantics as the host
    meter.  Every sum is of integers below 2^24 in f32, so it is exact.

    With ``semantics="witness"`` the loop also stamps each newly reached
    (state, query, node) with its level, where ``repro`` stamps it, and
    ``fn`` writes each chunk's real rows of that plane into one
    (B, n_states, n_nodes) tensor.
    """
    plan, sgroups, deg_c, pay_c = _frontier_setup(
        ca, n_nodes, graph, block_size, tile_dtype, staged, device, "frontier_kernel",
        plan_store, stats_epoch, tile_store_budget_bytes,
    )
    dev = plan.tiles.device
    witness = semantics == "witness"
    n_states, q_pad, v_pad = ca.n_states, plan.q_pad, plan.v_pad
    levels = max_levels if max_levels is not None else n_states * n_nodes
    rep = torch.tensor(replication_factor, dtype=torch.float32, device=dev)

    def fixpoint(f0: torch.Tensor):  # (n_states, q_pad, v_pad) f32 0/1
        visited = frontier = f0.reshape(n_states * q_pad, v_pad)
        done = [torch.zeros((q_pad, v_pad), device=dev) for _ in sgroups]
        q_bc = torch.zeros(q_pad, device=dev)
        d_s2 = torch.zeros(q_pad, device=dev)
        n_bc = torch.zeros(q_pad, device=dev)
        levmap = fops.initial_levels(visited > 0) if witness else None
        lev = 0
        while lev < levels and fops.frontier_nonempty(frontier):
            fr3 = frontier.reshape(n_states, q_pad, v_pad)
            for gi, (_, states) in enumerate(sgroups):
                now_g = functools.reduce(torch.maximum, (fr3[s] for s in states))
                new_g = now_g * (1.0 - done[gi])
                cnt = new_g.sum(dim=1)
                q_bc = q_bc + pay_c[gi] * cnt
                n_bc = n_bc + cnt
                d_s2 = d_s2 + EDGE_SYMBOLS * (new_g * deg_c[gi]).sum(dim=1)
                done[gi] = torch.maximum(done[gi], now_g)
            nxt = fops.expand_level_fused(plan, frontier)
            new = nxt * (1.0 - visited)
            if witness:
                levmap.masked_fill_(new > 0, lev + 2.0)
            visited = torch.maximum(visited, new)
            frontier = new
            lev += 1
            fops.FIXPOINT_COUNTERS["levels"] += 1
        vis3 = visited.reshape(n_states, q_pad, v_pad)
        acc = torch.zeros((q_pad, v_pad), device=dev)
        for qf in ca.accepting:
            acc = torch.maximum(acc, vis3[qf])
        out = (acc[:, :n_nodes] > 0, q_bc, d_s2 * rep, n_bc)
        if witness:  # (n_states, q_pad, v_pad) -> (q_pad, n_states, n_nodes)
            out += (levmap.reshape(n_states, q_pad, v_pad).transpose(0, 1)[:, :, :n_nodes],)
        return out

    def fn(starts) -> tuple[torch.Tensor, ...]:
        starts = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
        lev_out = torch.empty((len(starts), n_states, n_nodes), device=dev) if witness else None
        outs = [
            (
                torch.zeros((0, n_nodes), dtype=torch.bool, device=dev),
                *(torch.zeros(0, device=dev) for _ in range(3)),
            )
        ]
        for lo in range(0, starts.shape[0], q_pad):
            chunk = starts[lo : lo + q_pad]
            f0 = torch.zeros((n_states, q_pad, v_pad), device=dev)
            f0[ca.start, torch.arange(chunk.shape[0], device=dev), chunk] = 1.0
            out = fixpoint(f0)
            if witness:
                lev_out[lo : lo + chunk.shape[0]] = out[4][: chunk.shape[0]]
            outs.append(out[:4])
        acc, q_bc, d_s2, n_bc = (torch.cat(col)[: starts.shape[0]] for col in zip(*outs))
        result = (acc, q_bc, d_s2, n_bc.to(torch.int32))
        return result + (lev_out,) if witness else result

    return fn


def _make_frontier_packed_step_fn(
    ca: CompiledAutomaton,
    n_nodes: int,
    max_levels: int | None,
    graph: LabeledGraph | None,
    replication_factor: float,
    block_size: int,
    tile_dtype: str = "f32",
    staged=None,
    device: str | torch.device | None = None,
    semantics: str = "pairs",
    plan_store=None,
    stats_epoch: int = 0,
    tile_store_budget_bytes: int | None = None,
):
    """The lane-packed S2 executor (``backend="frontier_kernel_packed"``).

    Same Stage A and Stage B as :func:`_make_frontier_step_fn`, but the
    frontier is int32 lane words: chunk lane ``q`` lives in word row
    ``q // 32``, bit ``q % 32``, so one fixpoint answers ``QPACK`` = 256
    starts, one packed kernel launch and one host sync per BFS level.
    The start words are built on the host in numpy uint32
    (:func:`~repro_torch.kernels.frontier.ops.stack_start_nodes_packed`)
    and viewed as int32.  Lanes of a last, short chunk stay empty, where
    ``repro`` starts them at node 0 and discards them.

    The §4.2 meters stay per lane: the (group, node) dedup bitmap is
    carried packed, and each level's newly broadcast words are unpacked
    to 256 f32 lanes only for the per-lane count and degree sums — the
    same integers below 2^24, in the same f32, as the f32 backend.

    With ``semantics="witness"`` the level plane is per lane, (n_states,
    QPACK, v_pad) f32 a chunk — 32× the lane words' bytes — stamped from
    the newly set bits of each expansion, unpacked
    (:func:`~repro_torch.kernels.frontier.ops.lane_states`).
    """
    plan, sgroups, deg_c, pay_c = _frontier_setup(
        ca, n_nodes, graph, block_size, tile_dtype, staged, device, "frontier_kernel_packed",
        plan_store, stats_epoch, tile_store_budget_bytes,
    )
    dev = plan.tiles.device
    witness = semantics == "witness"
    n_states, q_pad, v_pad = ca.n_states, plan.q_pad, plan.v_pad
    q_pack = fops.QPACK
    levels = max_levels if max_levels is not None else n_states * n_nodes
    rep = torch.tensor(replication_factor, dtype=torch.float32, device=dev)

    def fixpoint(f0: torch.Tensor):  # (n_states * q_pad, v_pad) int32 lane words
        visited = frontier = f0
        done = [torch.zeros((q_pad, v_pad), dtype=torch.int32, device=dev) for _ in sgroups]
        q_bc = torch.zeros(q_pack, device=dev)
        d_s2 = torch.zeros(q_pack, device=dev)
        n_bc = torch.zeros(q_pack, device=dev)
        levmap = fops.initial_levels(fops.lane_states(f0, n_states)) if witness else None
        lev = 0
        while lev < levels and fops.frontier_nonempty(frontier):
            fr3 = frontier.reshape(n_states, q_pad, v_pad)
            for gi, (_, states) in enumerate(sgroups):
                now_g = functools.reduce(torch.bitwise_or, (fr3[s] for s in states))
                bits = fkernel.unpack_lane_rows(now_g & ~done[gi])  # (q_pack, v_pad)
                cnt = bits.sum(dim=1)
                q_bc = q_bc + pay_c[gi] * cnt
                n_bc = n_bc + cnt
                d_s2 = d_s2 + EDGE_SYMBOLS * (bits * deg_c[gi]).sum(dim=1)
                done[gi] = done[gi] | now_g
            new = fops.expand_level_packed(plan, frontier) & ~visited
            if witness:
                levmap.masked_fill_(fops.lane_states(new, n_states), lev + 2.0)
            visited = visited | new
            frontier = new
            lev += 1
            fops.FIXPOINT_COUNTERS["levels"] += 1
        vis3 = visited.reshape(n_states, q_pad, v_pad)
        acc = torch.zeros((q_pad, v_pad), dtype=torch.int32, device=dev)
        for qf in ca.accepting:
            acc = acc | vis3[qf]
        out = (fkernel.unpack_lane_rows(acc)[:, :n_nodes] > 0, q_bc, d_s2 * rep, n_bc)
        if witness:  # (n_states, q_pack, v_pad) -> (q_pack, n_states, n_nodes)
            out += (levmap.transpose(0, 1)[:, :, :n_nodes],)
        return out

    def fn(starts) -> tuple[torch.Tensor, ...]:
        starts = np.asarray(starts, np.int64)
        lev_out = torch.empty((len(starts), n_states, n_nodes), device=dev) if witness else None
        outs = [
            (
                torch.zeros((0, n_nodes), dtype=torch.bool, device=dev),
                *(torch.zeros(0, device=dev) for _ in range(3)),
            )
        ]
        for lo in range(0, starts.shape[0], q_pack):
            chunk = starts[lo : lo + q_pack]
            f0 = fops.stack_start_nodes_packed(plan, ca.start, chunk)
            out = fixpoint(torch.from_numpy(f0.view(np.int32)).to(dev))
            if witness:
                lev_out[lo : lo + len(chunk)] = out[4][: len(chunk)]
            outs.append(out[:4])
        acc, q_bc, d_s2, n_bc = (torch.cat(col)[: starts.shape[0]] for col in zip(*outs))
        result = (acc, q_bc, d_s2, n_bc.to(torch.int32))
        return result + (lev_out,) if witness else result

    return fn


def s2_execute(
    placement: Placement,
    ca: CompiledAutomaton,
    start_nodes: np.ndarray,
    max_levels: int | None = None,
    step_fn=None,
    backend: str = "frontier_kernel",
    block_size: int = 128,
    semantics: str = "pairs",
    tile_dtype: str = "f32",
    staged=None,
    device: str | torch.device | None = None,
    plan_store=None,
    stats_epoch: int = 0,
    tile_store_budget_bytes: int | None = None,
) -> tuple[np.ndarray, list[StrategyCost]] | tuple[np.ndarray, list[StrategyCost], np.ndarray]:
    """Run the batched S2 executor for ``start_nodes``.

    Returns ``(answers, costs)``: answers (B, V) bool, plus one *observed*
    :class:`StrategyCost` per start node, measured by the executor itself.
    Under ``semantics="witness"`` it returns ``(answers, costs, levels)``,
    levels (B, n_states, V) f32 numpy, copied from the device once
    (:func:`repro_torch.core.witness.reconstruct_path` walks them).
    Unicast symbols are converted back to the meters' single-copy
    convention by dividing the summed per-site responses by the
    placement's replication factor K (in float64, as ``repro`` does; the
    f32 ×K and ÷K round trip may leave them off the integer count by far
    less than one symbol).

    ``step_fn`` accepts a prebuilt executor from :func:`make_s2_step_fn`;
    ``staged``, or ``plan_store`` keyed by ``stats_epoch`` (with
    ``tile_store_budget_bytes`` for the out-of-core store), the Stage A
    of the executor built here."""
    if step_fn is None:
        step_fn = make_s2_step_fn(
            ca, placement.graph.n_nodes, max_levels,
            backend=backend, graph=placement.graph,
            replication_factor=placement.replication_factor,
            block_size=block_size, semantics=semantics, tile_dtype=tile_dtype,
            staged=staged, device=device, plan_store=plan_store, stats_epoch=stats_epoch,
            tile_store_budget_bytes=tile_store_budget_bytes,
        )
    out = step_fn(start_nodes)
    if len(out) != (5 if semantics == "witness" else 4):
        raise ValueError(f"semantics={semantics!r} needs a step_fn built with it")
    acc, q_bc, d_s2, n_bc = (t.cpu().numpy() for t in out[:4])
    k_rep = max(placement.replication_factor, 1e-9)
    costs = [
        StrategyCost(
            strategy="S2",
            broadcast_symbols=float(q_bc[i]),
            unicast_symbols=float(d_s2[i]) / k_rep,
            n_broadcasts=int(n_bc[i]),
            edges_retrieved=int(round(float(d_s2[i]) / (EDGE_SYMBOLS * k_rep))),
        )
        for i in range(len(q_bc))
    ]
    if semantics == "witness":
        return acc, costs, out[4].cpu().numpy()
    return acc, costs
