"""Distributed RPQ processing strategies (paper §3) and message
accounting, on one device or per rank of a mesh.

Port of ``repro/core/strategies.py``:

* **S1 — top-down** (§3.3, §4.2.1): one broadcast of the query's distinct
  labels; every site unicasts its label-matching edges; the PAA then runs
  locally on the collected (deduplicated) subgraph.  The sites are the
  leading dimension of the placement's padded arrays on the device.
* **S2 — bottom-up** (§3.3, §4.2.2): the PAA runs at the querying site;
  each BFS level's neighbour lookup is a broadcast search answered by the
  sites holding matching edges, with a local cache deduplicating repeated
  searches.  Four backends: ``reference`` (plain torch on the padded
  site arrays, no kernel; ``repro``'s default), the global fused
  ``frontier_kernel`` (8 stacked queries in f32 rows) and
  ``frontier_kernel_packed`` (256 query lanes in int32 words), and the
  site-sharded fused ``frontier_kernel_sharded`` with per-site meters;
  the kernel backends on either tile store.
* **S3 — query shipping** (§3.1/§3.5.5) and **S4 — query decomposition**
  (§3.2/§3.5.6) are meters only, as in ``repro``.

The meters count message symbols with the paper's conventions (a symbol
= one node id or label; an edge = 3 symbols; broadcasting b symbols costs
2·N_c·b messages).

Every backend also runs ``semantics="witness"``: the fixpoint carries
each product state's discovery level, the implicit parent pointers of
:mod:`repro_torch.core.witness`.

Executor builds are two-stage: with ``plan_store`` (a
:class:`repro_torch.core.plans.GraphPlanStore`) the kernel backends fetch
their Stage A — the staged tiles (under a ``tile_store_budget_bytes``
the out-of-core subset; per site, merged and bucketed for the sharded
backend) and the per-label degree vectors — from the shared store, and
only Stage B is built per executor.

With ``mesh=None`` (the default) everything runs on one device: the
sites are a leading dimension of one card's tensors, and the sharded
backend takes ``axis_size``, the product of ``repro``'s site-axis sizes,
to group them as ``repro``'s mesh would.  With a ``mesh`` (a
``torch.distributed`` ``DeviceMesh`` of ranks, one process each) S1's
gather and the ``reference`` and ``frontier_kernel_sharded`` executors
run as ``repro``'s ``shard_map`` programs do, each rank on its own block
of sites over ``site_axes`` and its block of starts over ``batch_axis``,
joined by the collectives of :mod:`repro_torch.dist.collectives`: a
level is the rank's expansion, ``pmax``-ed over the site axes, so every
rank of a site group holds the same frontier, leaves the level loop at
the same level, and every level is a BFS level; meters are ``psum``-ed,
and outputs gathered, so every rank returns the whole result.  Where
``repro``'s sharded backend forwards discoveries around a ``ppermute``
ring, the port merges them synchronously each level, on one card and
over ranks alike.  The global fused backends have no mesh program (as
in ``repro``, they run whole on each device) and ignore the mesh.
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
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
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
    (raw symbols each site unicast, copies included) that only the
    site-sharded backend fills in; its sum is the K-weighted response
    total."""

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
    placement: Placement,
    device: str | torch.device | None = None,
    mesh=None,
    site_axes: tuple[str, ...] = ("data",),
) -> dict[str, torch.Tensor]:
    """The placement's padded per-site arrays
    (:meth:`~repro_torch.graph.partition.Placement.padded_device_arrays`)
    on ``device`` (``None``: the GPU), staged once for every S1 gather.
    On a ``mesh``: the rows of the rank's block of sites over
    ``site_axes`` only (``repro``'s ``P(site_axes, None)`` shard)."""
    dev = resolve_device(device)
    if mesh is None:
        rows = placement.padded_device_arrays()
    else:
        rows = placement.padded_site_rows(*collectives.site_block(placement.n_sites, site_axes, mesh))
    return {k: torch.from_numpy(a).to(dev) for k, a in rows.items()}


def s1_gather(
    site_arrays: dict[str, torch.Tensor],
    label_mask: np.ndarray,
    cap: int,
    mesh=None,
    site_axes: tuple[str, ...] = ("data",),
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

    On a ``mesh`` ``site_arrays`` holds the rank's rows
    (``stage_site_arrays(..., mesh=mesh)``): the rank compacts its own
    sites, the buffers are gathered over ``site_axes``
    (``collectives.gather_rows``) and the overflow summed, so every rank
    returns the (n_sites, cap) buffers, ``repro``'s bytes.
    """
    src, lbl, dst, mask = (site_arrays[k] for k in ("src", "lbl", "dst", "mask"))
    lblmask = torch.as_tensor(label_mask, dtype=torch.bool, device=src.device)
    match = mask & lblmask.index_select(0, lbl.reshape(-1)).reshape(lbl.shape)
    take = torch.sort((~match).to(torch.uint8), dim=1, stable=True).indices[:, :cap]
    overflow = (match.sum(dim=1) - cap).clamp_min(0).sum()
    out = [src.gather(1, take), lbl.gather(1, take), dst.gather(1, take), match.gather(1, take)]
    if mesh is not None:
        n_sites = collectives.axis_size(mesh, site_axes) * src.shape[0]
        out = [collectives.gather_rows(t, site_axes, n_sites, mesh) for t in out]
        overflow = collectives.psum(overflow, site_axes, mesh)
    return (*out, int(overflow))


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
    mesh=None,
    site_axes: tuple[str, ...] = ("data",),
) -> LabeledGraph:
    """S1's retrieval phase: gather every site's ``label_mask``-matching
    edges and deduplicate the replicated copies at the querying site.

    ``device_arrays`` accepts the placement's already-staged padded site
    arrays (:func:`stage_site_arrays`; on a ``mesh``, the rank's rows),
    so serving loops skip the per-call rebuild; without them they are
    staged on ``device`` (``None``: the GPU).  On a ``mesh`` every rank
    gathers over ``site_axes`` and returns the same subgraph."""
    site_arrays = (device_arrays if device_arrays is not None
                   else stage_site_arrays(placement, device, mesh, site_axes))
    if cap is None:
        cap = site_arrays["src"].shape[1]
    while True:
        src, lbl, dst, valid, overflow = s1_gather(site_arrays, label_mask, cap, mesh, site_axes)
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
    mesh=None,
    site_axes: tuple[str, ...] = ("data",),
) -> tuple[set[int], StrategyCost]:
    """Full S1: broadcast labels → gather matching edges → dedup → local
    PAA (the device BFS, :func:`repro_torch.core.paa.answers_single_source`,
    on the sites' device).  On a ``mesh`` each rank gathers from its own
    sites (:func:`s1_collect`) and runs the local PAA on the gathered
    subgraph, as ``repro``'s querying site does."""
    graph = placement.graph
    site_arrays = (device_arrays if device_arrays is not None
                   else stage_site_arrays(placement, device, mesh, site_axes))
    sub = s1_collect(placement, query_label_mask(ast, graph), cap, site_arrays,
                     mesh=mesh, site_axes=site_axes)
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


BACKENDS = ("reference", "frontier_kernel", "frontier_kernel_packed", "frontier_kernel_sharded")
SEMANTICS = ("pairs", "witness")


def _require_ported(backend: str, semantics: str, tile_dtype: str) -> None:
    """Raise ``ValueError`` for a backend, semantics or tile dtype this
    package does not know."""
    for name, value, known in (
        ("backend", backend, BACKENDS),
        ("semantics", semantics, SEMANTICS),
        ("tile_dtype", tile_dtype, fops.TILE_DTYPES),
    ):
        if value not in known:
            raise ValueError(f"unknown {name}={value!r}; this package runs {name} in {known}")


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
    placement: Placement | None = None,
    axis_size: int | None = None,
    bucket_floor: int | None = None,
    mesh=None,
    site_axes: tuple[str, ...] = ("data",),
    batch_axis: str | None = "model",
):
    """Build the batched S2 executor.

    Four backends share one call contract:

    * ``"reference"`` — plain torch on the placement's padded site edge
      arrays, no kernel (``repro``'s is plain ``jnp`` under ``shard_map``):
      per BFS level each transition run gathers the frontier at one end
      of the matching edges and OR-scatters it into the other.  On one
      device the sites are one edge set, so ``repro``'s ``pmax`` and
      ``psum`` over the site axes vanish.  It reads the site arrays at
      call time (see below), and nothing at build time.
    * ``"frontier_kernel"`` — the fused level kernel: the whole BFS level
      over all transitions is ONE launch on the block-sparse tiles of
      ``graph`` (required), with up to 8 queries stacked into the rows of
      each automaton state.
    * ``"frontier_kernel_packed"`` — the same level on int32 lane words:
      256 queries per fixpoint, one bit each.
    * ``"frontier_kernel_sharded"`` — the fused level on *site-local*
      tiles (``placement`` required): each site's tiles come from its own
      edges, the sites of each of ``axis_size`` groups are merged into one
      grid (as ``repro``'s ``shard_map`` blocks them over its site axes,
      whose size product ``axis_size`` stands for) and padded only to
      their power-of-two shape bucket (``bucket_floor`` sets the smallest
      class), and each level is one B1 or B3 launch per bucket, merged
      synchronously.  Its meters run per site.

    ``tile_dtype`` picks the tile store the kernel backends read: ``"f32"``
    or the ``"uint32"`` bit-planes.  ``replication_factor`` scales the
    global fused backends' unicast symbols to ``repro``'s summed-per-site
    convention (in f32, as ``repro`` does) so :func:`s2_execute` can
    divide it back out; the reference and sharded backends count every
    site's matched edges, replicas included.

    The global fused backends take Stage A from one of three places:
    ``staged``, a prebuilt Stage A
    (:func:`repro_torch.kernels.frontier.ops.stage_graph` of ``graph`` at
    ``block_size`` and ``tile_dtype``); ``plan_store``, the shared
    :class:`~repro_torch.core.plans.GraphPlanStore`, keyed by
    ``stats_epoch`` (its device is the executor's, and it also serves the
    meters' per-label degree vectors); or neither, and the executor
    stages its own on ``device`` (``None``: the GPU).
    ``tile_store_budget_bytes`` turns on the out-of-core tile store and
    needs ``plan_store``: Stage A is assembled from only the automaton's
    required (direction, label) slabs, cold host slabs spilling to disk
    beyond the budget (see
    :meth:`repro_torch.core.plans.GraphPlanStore.staged_graph`).  The
    sharded backend takes its per-site staging, merges and buckets from
    ``plan_store`` or builds them on ``device``; it honours the dtype but
    not the budget, as ``repro``'s does.

    Returns ``fn(starts) -> (answers, q_bc, d_s2, n_bc)``: ``starts``
    (B,) int node ids; answers (B, n_nodes) bool, and per start the
    observed §4.2 meters — broadcast symbols, unicast response symbols
    (× K) and distinct broadcast searches — all torch tensors on the
    device.  The reference backend's is ``fn(starts, site_arrays)``,
    ``site_arrays`` the placement's padded site arrays on the device
    (:func:`stage_site_arrays`).  The sharded backend
    appends a fifth output, ``d_s2_sites`` (n_sites, B): each site's
    unicast symbols.  The meters dedup broadcasts by (symbol-set, node),
    the §4.2.2 cache key, so they agree with the host meter.  ``fn.backend``
    names the backend.

    ``mesh`` (a ``DeviceMesh`` of ranks; ``None``: one device) runs the
    reference and sharded backends as ``repro``'s mesh programs, per
    rank: the sites are blocked over ``site_axes`` and the starts over
    ``batch_axis`` (when the mesh has it), each level is ``pmax``-ed over
    the site axes, and every rank returns the whole gathered result.
    ``axis_size`` (the site axes' size product; ``None``: 1, or the
    mesh's) must agree with the mesh.  The reference executor then reads
    the rank's rows of the site arrays (``stage_site_arrays(...,
    mesh=mesh)``), and the sharded one stages its sites' share.

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
    if backend in ("reference", "frontier_kernel_sharded") and staged is not None:
        raise ValueError(f"staged= is the global Stage A; backend={backend!r} does not read it")
    axis_size = _site_axis_size(mesh, site_axes, axis_size)
    ranks = _RankAxes.of(mesh, site_axes, batch_axis)
    if backend == "reference":
        fn = _make_reference_step_fn(ca, n_nodes, max_levels, semantics, ranks)
    elif backend == "frontier_kernel_sharded":
        fn = _make_frontier_sharded_step_fn(
            ca, n_nodes, max_levels, placement, block_size, tile_dtype, device, semantics,
            plan_store, stats_epoch, axis_size,
            fops.BUCKET_FLOOR if bucket_floor is None else bucket_floor, ranks,
        )
    else:
        make = (
            _make_frontier_packed_step_fn
            if backend == "frontier_kernel_packed"
            else _make_frontier_step_fn
        )
        fn = make(
            ca, n_nodes, max_levels, graph, replication_factor, block_size, tile_dtype,
            staged, device, semantics, plan_store, stats_epoch, tile_store_budget_bytes,
        )
    fn.backend = backend
    return fn


def _site_axis_size(mesh, site_axes: tuple[str, ...], axis_size: int | None) -> int:
    """The site groups' count: ``axis_size``, which must agree with the
    product of ``site_axes``' sizes on ``mesh`` when there is one."""
    if mesh is None:
        return 1 if axis_size is None else axis_size
    n = collectives.axis_size(mesh, site_axes)
    if axis_size is not None and axis_size != n:
        raise ValueError(f"axis_size={axis_size} disagrees with the mesh: its site axes "
                         f"{tuple(site_axes)} hold {n} ranks")
    return n


@dataclasses.dataclass(frozen=True)
class _RankAxes:
    """Where one rank sits in a mesh program: the mesh, its site axes and
    its batch axis (``None`` when the mesh lacks it).  ``None`` stands for
    the one-device program, whose collectives and splits are identities."""

    mesh: object
    site_axes: tuple[str, ...]
    batch_axis: str | None

    @classmethod
    def of(cls, mesh, site_axes, batch_axis) -> "_RankAxes | None":
        if mesh is None:
            return None
        b_ax = batch_axis if batch_axis and batch_axis in shd.axis_names(mesh) else None
        return cls(mesh, tuple(site_axes), b_ax)

    def site_block(self, n_sites: int) -> tuple[int, int]:
        return collectives.site_block(n_sites, self.site_axes, self.mesh)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.pmax(x, self.site_axes, self.mesh)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.psum(x, self.site_axes, self.mesh)

    def batch_block(self, n: int) -> tuple[int, int]:
        """The starts ``[lo, hi)`` of ``n`` this rank runs: a contiguous
        block over the batch axis (all of them without one)."""
        return collectives.block_of(n, (self.batch_axis,), self.mesh) if self.batch_axis else (0, n)

    def gather_batch(self, x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
        """The whole batch of ``n`` from each rank's block along ``dim``."""
        if not self.batch_axis:
            return x
        return collectives.gather_rows(x, (self.batch_axis,), n, self.mesh, dim)

    def loop_mode(self) -> str:
        """The :class:`~repro_torch.kernels.frontier.ops.LevelLoop` mode of
        this rank's fixpoints, from its site group's backend when the
        executor is built: ``"graph"`` on NCCL, whose ``all_reduce`` a CUDA
        graph captures with the level's launches, else ``"gloo"``: the
        same gated body run eagerly (``gloo`` cannot be captured)."""
        return "graph" if collectives.backend(self.mesh, self.site_axes) == "nccl" else "gloo"


# the reference executor's budget for its (query chunk, matched edge)
# temporaries: a bool gather and an int32 scatter operand per pair
REFERENCE_CHUNK_BYTES = 2**30
_REFERENCE_BYTES_PER_PAIR = 5


def _reference_edge_sets(ca, runs, sgroups, site_arrays: dict[str, torch.Tensor], n_nodes: int):
    """The reference executor's loop-invariant edge sets over the padded
    site arrays, flattened into one edge set (``repro``'s ``local`` on one
    device): per transition run the (src, dst) ids of its matching valid
    edges, compacted; per symbol-set group and direction selection (in
    ``repro``'s order) the count of matching edges at each node of the
    search end, as f64 for an exact product with the broadcast bitmap."""
    src, lbl, dst, mask = (site_arrays[k].reshape(-1) for k in ("src", "lbl", "dst", "mask"))

    meta = src.is_meta  # a shape-only run: every padded slot matches, degrees have no values

    def range_sel(lo, hi):
        return mask if lo is None else mask & (lbl >= lo) & (lbl <= hi)

    run_edges = []
    for _, _, _, lo, hi in runs:
        if meta:
            idx = torch.arange(src.shape[0], device=src.device)
        else:
            idx = torch.nonzero(range_sel(lo, hi)).flatten()
        run_edges.append((src[idx].long(), dst[idx].long()))
    group_degs = []
    for symset, _ in sgroups:
        by_dir: dict[int, list[int]] = {}
        for lid, dirn in symset:
            by_dir.setdefault(dirn, []).append(lid)
        degs = []
        for dirn in sorted(by_dir):
            for lo, hi in _fuse_label_runs(by_dir[dirn]):
                if meta:
                    degs.append(torch.empty(n_nodes, dtype=torch.float64, device=src.device))
                    continue
                end = (src if dirn == FWD else dst)[range_sel(lo, hi)].long()
                degs.append(torch.bincount(end, minlength=n_nodes).double())
        group_degs.append(degs)
    return run_edges, group_degs


def _make_reference_step_fn(
    ca: CompiledAutomaton,
    n_nodes: int,
    max_levels: int | None,
    semantics: str = "pairs",
    ranks: _RankAxes | None = None,
):
    """The reference S2 executor (``backend="reference"``), the body of
    ``repro``'s ``make_s2_step_fn`` in plain torch on the padded site
    arrays, with no kernel.

    Each call batches its starts, in chunks sized so that the (chunk,
    edges) temporaries of the largest transition run stay under
    :data:`REFERENCE_CHUNK_BYTES` (edges: the run's matching valid edges,
    compacted once per site arrays: a call on the same tensors, unchanged,
    reuses them), and runs one fixpoint per chunk on a
    :class:`~repro_torch.kernels.frontier.ops.LevelLoop` (where it is
    captured, one graph per chunk height: on a card a chunk's rows pad to
    a power of two, the padded rows empty).  On meta site arrays (a
    shape-only run, ``launch/``) every padded slot stands for a matching
    edge, the degree vectors are empty, and each fixpoint takes one level
    (:func:`~repro_torch.kernels.frontier.ops.host_loop`).  A level gathers, per transition run, the
    frontier at one end of the run's edges and OR-scatters it into the
    other with an int32 ``scatter_add_`` (a count, never a wrapping
    uint8 sum), thresholded ``> 0``.

    The §4.2 meters run before each expansion, as ``repro``'s: per
    symbol-set group the newly broadcast nodes (the (group, node) dedup
    bitmap), their count, and per direction selection the matching edges
    at them, added in f32 in ``repro``'s order — per level, per group, per
    selection — so the sums are bit-exact while below 2^24.  Each edge
    count is a float64 product of the bitmap with the selection's degree
    vector: exact whatever TF32 setting is on.  ``d_s2`` sums every
    site's copies.  Witness levels are stamped after the merge, so there
    is one plane, as in ``repro``.

    Per rank (``ranks``, ``repro``'s ``shard_map`` body): ``site_arrays``
    are the rank's sites, whose edges alone it scans; each level's
    expansion is ``pmax``-ed over the site axes (so the frontier, the
    broadcast meters and the witness plane are one on every rank of the
    site group, and its ranks read the same flag and leave the loop after
    the same body), the loop captured with its ``pmax`` on an NCCL group
    and run eagerly on a ``gloo`` one (:meth:`_RankAxes.loop_mode`), ``d_s2`` is
    ``psum``-ed at the end (f32, exact below 2^24), and the starts are
    split over the batch axis in contiguous blocks whose outputs are
    gathered back.  The chunk size comes from the widest run over the
    site group (a ``pmax``), so its ranks run the same fixpoints; a
    shape-only run issues the ``pmax`` and keeps its own widest run (every
    padded slot matches on every rank alike)."""
    witness = semantics == "witness"
    n_states = ca.n_states
    levels = max_levels if max_levels is not None else n_states * n_nodes
    mode = "graph" if ranks is None else ranks.loop_mode()
    runs = transition_runs(ca)
    sgroups = symbol_set_groups(ca)
    n_groups = len(sgroups)

    def level_on(run_edges, group_degs, state_idx):
        """One level over these edge sets: the meters on the frontier,
        then the expansion (a :class:`~repro_torch.kernels.frontier.ops.LevelLoop`
        level)."""

        def level(state, lev):  # frontier, visited, q_bc, d_s2, n_bc, *done[, levmap]
            frontier, visited, q_bc, d_s2, n_bc, *rest = state
            b, dev = frontier.shape[0], frontier.device
            done = []
            for gi, (symset, _) in enumerate(sgroups):
                now_g = frontier[:, state_idx[gi]].any(dim=1)
                new_g = now_g & ~rest[gi]
                n_new = new_g.sum(dim=1)
                q_bc = q_bc + (1 + len(symset)) * n_new.float()
                n_bc = n_bc + n_new
                for deg in group_degs[gi]:
                    d_s2 = d_s2 + EDGE_SYMBOLS * (new_g.double() @ deg).float()
                done.append(rest[gi] | now_g)
            nxt = torch.zeros_like(frontier)
            for (s_st, d_st, direction, _, _), (e_src, e_dst) in zip(runs, run_edges):
                at, to = (e_src, e_dst) if direction == FWD else (e_dst, e_src)
                hits = torch.zeros((b, n_nodes), dtype=torch.int32, device=dev)
                hits.scatter_add_(1, to.expand(b, -1), frontier[:, s_st, at].int())
                nxt[:, d_st] |= hits > 0
            if ranks is not None:  # unicast-response combine: OR over every site
                nxt = ranks.pmax(nxt)
            new = nxt & ~visited
            out = (new, visited | new, q_bc, d_s2, n_bc, *done)
            return out + (fops.stamp_levels(rest[-1], new, lev),) if witness else out

        return level

    def fixpoint(starts: torch.Tensor, rows_pad: int, level, loop):
        dev, b = starts.device, starts.shape[0]
        visited = torch.zeros((rows_pad, n_states, n_nodes), dtype=torch.bool, device=dev)
        visited[torch.arange(b, device=dev), ca.start, starts] = True
        state = (visited, visited, torch.zeros(rows_pad, device=dev), torch.zeros(rows_pad, device=dev),
                 torch.zeros(rows_pad, dtype=torch.int64, device=dev),
                 *(torch.zeros((rows_pad, n_nodes), dtype=torch.bool, device=dev) for _ in range(n_groups)))
        if witness:
            state += (fops.initial_levels(visited),)
        state = loop.run(state) if loop is not None else fops.host_loop(level, state, levels)
        _, visited, q_bc, d_s2, n_bc, *rest = state
        acc = visited[:, list(ca.accepting)].any(dim=1)
        if ranks is not None:  # every site holding a matching edge answered
            d_s2 = ranks.psum(d_s2)
        out = (acc, q_bc, d_s2, n_bc.to(torch.int32)) + ((rest[-1],) if witness else ())
        return out if rows_pad == b else tuple(x[:b] for x in out)

    # the last call's site arrays (their tensors and versions), their edge
    # sets and the LevelLoop of each chunk height run on them
    held: dict = {}

    def release() -> None:
        for loop in held.get("loops", {}).values():
            loop.release()
        held.clear()

    def edge_sets(site_arrays: dict[str, torch.Tensor], dev):
        arrays = tuple(site_arrays[k] for k in ("src", "lbl", "dst", "mask"))
        # a shape-only run counts one call's work: its edge sets every call
        key = None if dev.type == "meta" else tuple((id(a), a._version) for a in arrays)
        if key is None or held.get("key") != key:
            release()
            run_edges, group_degs = _reference_edge_sets(ca, runs, sgroups, site_arrays, n_nodes)
            state_idx = [torch.tensor(states, device=dev) for _, states in sgroups]
            held.update(key=key, arrays=arrays, run_edges=run_edges, loops={},
                        level=level_on(run_edges, group_degs, state_idx))
        return held["run_edges"], held["level"], held["loops"]

    def fn(starts, site_arrays=None) -> tuple[torch.Tensor, ...]:
        if site_arrays is None:
            raise ValueError("backend='reference' reads the placement's padded site arrays: "
                             "pass site_arrays (stage_site_arrays, or s2_execute's device_arrays=)")
        dev = site_arrays["src"].device
        run_edges, level, loops = edge_sets(site_arrays, dev)
        widest = max([len(e) for e, _ in run_edges], default=0)
        if ranks is not None:
            agreed = ranks.pmax(torch.tensor([widest], device=dev))
            if not agreed.is_meta:  # a shape-only run: every rank's widest is its own
                widest = int(agreed[0])
        chunk = max(1, REFERENCE_CHUNK_BYTES // max(_REFERENCE_BYTES_PER_PAIR * widest, 1))
        if isinstance(starts, torch.Tensor):
            starts = starts.to(device=dev, dtype=torch.int64)
        else:
            starts = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
        n = starts.shape[0]
        if ranks is not None:
            starts = starts[slice(*ranks.batch_block(n))]

        def run(part: torch.Tensor):
            b = part.shape[0]
            if part.is_meta:  # no values: one level
                return fixpoint(part, b, level, None)
            # where the loop is captured, on a card a chunk's rows pad to a
            # power of two (at most the chunk), so few heights share the
            # graphs; the ranks of a site group share their batch block and
            # so their heights
            captured = dev.type == "cuda" and mode == "graph"
            rows_pad = min(1 << max(b - 1, 0).bit_length(), chunk) if captured else b
            loop = loops.get(rows_pad)
            if loop is None:
                loop = loops[rows_pad] = fops.LevelLoop(level, levels, mode)
            return fixpoint(part, rows_pad, level, loop)

        outs = [run(starts[lo : lo + chunk]) for lo in range(0, starts.shape[0], chunk)]
        if not outs:
            outs = [run(starts)]
        result = tuple(torch.cat(col) for col in zip(*outs))
        if ranks is not None:
            result = tuple(ranks.gather_batch(x, n) for x in result)
        return result

    fn.release = release
    return fn


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
    and runs one fixpoint per chunk on one
    :class:`~repro_torch.kernels.frontier.ops.LevelLoop`: one kernel
    launch per level, ``LEVELS_PER_CHECK`` levels per host check, on a
    card one captured graph replayed for every chunk (``repro`` runs the
    chunks under ``lax.map`` and each fixpoint in a ``lax.while_loop``).
    ``fn.release()`` frees the graph.  Rows of a last, short chunk stay
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

    n_groups = len(sgroups)

    def level(state, lev):  # frontier, visited, q_bc, d_s2, n_bc, *done[, levmap]
        frontier, visited, q_bc, d_s2, n_bc, *rest = state
        fr3 = frontier.reshape(n_states, q_pad, v_pad)
        done = []
        for gi, (_, states) in enumerate(sgroups):
            now_g = functools.reduce(torch.maximum, (fr3[s] for s in states))
            new_g = now_g * (1.0 - rest[gi])
            cnt = new_g.sum(dim=1)
            q_bc = q_bc + pay_c[gi] * cnt
            n_bc = n_bc + cnt
            d_s2 = d_s2 + EDGE_SYMBOLS * (new_g * deg_c[gi]).sum(dim=1)
            done.append(torch.maximum(rest[gi], now_g))
        new = fops.expand_level_fused(plan, frontier) * (1.0 - visited)
        out = (new, torch.maximum(visited, new), q_bc, d_s2, n_bc, *done)
        return out + (fops.stamp_levels(rest[-1], new > 0, lev),) if witness else out

    loop = fops.LevelLoop(level, levels)

    def fixpoint(f0: torch.Tensor):  # (n_states, q_pad, v_pad) f32 0/1
        visited = f0.reshape(n_states * q_pad, v_pad)
        state = (visited, visited, *(torch.zeros(q_pad, device=dev) for _ in range(3)),
                 *(torch.zeros((q_pad, v_pad), device=dev) for _ in range(n_groups)))
        if witness:
            state += (fops.initial_levels(visited > 0),)
        _, visited, q_bc, d_s2, n_bc, *rest = loop.run(state)
        vis3 = visited.reshape(n_states, q_pad, v_pad)
        acc = torch.zeros((q_pad, v_pad), device=dev)
        for qf in ca.accepting:
            acc = torch.maximum(acc, vis3[qf])
        out = (acc[:, :n_nodes] > 0, q_bc, d_s2 * rep, n_bc)
        if witness:  # (n_states, q_pad, v_pad) -> (q_pad, n_states, n_nodes)
            out += (rest[-1].reshape(n_states, q_pad, v_pad).transpose(0, 1)[:, :, :n_nodes],)
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

    fn.release = loop.release
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
    starts, one packed kernel launch per BFS level, on the same
    :class:`~repro_torch.kernels.frontier.ops.LevelLoop` form.
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

    n_groups = len(sgroups)

    def level(state, lev):  # frontier, visited, q_bc, d_s2, n_bc, *done[, levmap]
        frontier, visited, q_bc, d_s2, n_bc, *rest = state
        fr3 = frontier.reshape(n_states, q_pad, v_pad)
        done = []
        for gi, (_, states) in enumerate(sgroups):
            now_g = functools.reduce(torch.bitwise_or, (fr3[s] for s in states))
            bits = fkernel.unpack_lane_rows(now_g & ~rest[gi])  # (q_pack, v_pad)
            cnt = bits.sum(dim=1)
            q_bc = q_bc + pay_c[gi] * cnt
            n_bc = n_bc + cnt
            d_s2 = d_s2 + EDGE_SYMBOLS * (bits * deg_c[gi]).sum(dim=1)
            done.append(rest[gi] | now_g)
        new = fops.expand_level_packed(plan, frontier) & ~visited
        out = (new, visited | new, q_bc, d_s2, n_bc, *done)
        if witness:
            out += (fops.stamp_levels(rest[-1], fops.lane_states(new, n_states), lev),)
        return out

    loop = fops.LevelLoop(level, levels)

    def fixpoint(f0: torch.Tensor):  # (n_states * q_pad, v_pad) int32 lane words
        state = (f0, f0, *(torch.zeros(q_pack, device=dev) for _ in range(3)),
                 *(torch.zeros((q_pad, v_pad), dtype=torch.int32, device=dev) for _ in range(n_groups)))
        if witness:
            state += (fops.initial_levels(fops.lane_states(f0, n_states)),)
        _, visited, q_bc, d_s2, n_bc, *rest = loop.run(state)
        vis3 = visited.reshape(n_states, q_pad, v_pad)
        acc = torch.zeros((q_pad, v_pad), dtype=torch.int32, device=dev)
        for qf in ca.accepting:
            acc = acc | vis3[qf]
        out = (fkernel.unpack_lane_rows(acc)[:, :n_nodes] > 0, q_bc, d_s2 * rep, n_bc)
        if witness:  # (n_states, q_pack, v_pad) -> (q_pack, n_states, n_nodes)
            out += (rest[-1].transpose(0, 1)[:, :, :n_nodes],)
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

    fn.release = loop.release
    return fn


def _make_frontier_sharded_step_fn(
    ca: CompiledAutomaton,
    n_nodes: int,
    max_levels: int | None,
    placement: Placement | None,
    block_size: int,
    tile_dtype: str,
    device,
    semantics: str,
    plan_store,
    stats_epoch: int,
    axis_size: int,
    bucket_floor: int,
    ranks: _RankAxes | None = None,
):
    """The site-sharded S2 executor (``backend="frontier_kernel_sharded"``),
    ``repro``'s ``_make_frontier_sharded_step_fn`` on one device or per
    rank.

    Stage A — the per-site slabs, their merge into ``axis_size`` groups,
    the groups' shape buckets on the device, the site-local graphs and
    their per-label degree vectors — comes from ``plan_store`` when one
    is passed; only Stage B is built per executor, and the plan's padding
    feeds ``plan_store.record_plan_pad_waste``.  ``repro`` blocks the sites
    over its mesh's site axes; ``axis_size`` is the product of their
    sizes, and the sites block over it the same way, so the merged grids
    and buckets are ``repro``'s.

    The fixpoint runs on a
    :class:`~repro_torch.kernels.frontier.ops.LevelLoop`, on one device
    and per rank (captured with the level's ``pmax`` on an NCCL group,
    eagerly on a ``gloo`` one: :meth:`_RankAxes.loop_mode`).  One level
    (:func:`~repro_torch.kernels.frontier.ops.expand_level_sharded`):
    the frontier is extended once, each bucket is one B1 or B3 launch
    over its members' work list, and the buckets are max-merged and
    clamped — a synchronous OR merge, where ``repro`` forwards each
    iteration's discoveries around a ``ppermute`` ring.  So a level is a
    BFS level at every ``axis_size``: ``max_levels`` bounds BFS levels
    (``repro`` multiplies it by ``axis_size`` for its ring), and witness
    levels are BFS levels (``repro`` stamps ring iterations above
    ``axis_size = 1``, equal to BFS levels at 1).

    The §4.2 meters run on the merged frontier with the (group, node)
    dedup bitmap, per site: ``d_site`` (n_sites, q_pad) adds each site's
    matching edges at the newly broadcast nodes, as an f64 product of the
    site's degree vectors with the bitmap — exact whatever TF32 setting
    is on, where an f32 product would round through TF32 on the card —
    cast to f32 and added in ``repro``'s order.  Every product state
    enters the merged frontier once, as it enters each of ``repro``'s
    per-device pending streams once, so the per-site meters are
    ``repro``'s at every ``axis_size``.  ``d_s2`` is their sum over
    sites.

    Per rank (``ranks``): the rank holds its one group slab, its row of
    the bucket (``ops.stage_rank_group``, ``bucket_rank_group``,
    ``build_rank_level_schedule``; from ``plan_store`` keyed by its share
    when one is passed) and the degree vectors of its own sites.  A level
    is its launch, clamped, then a ``pmax`` over the site axes, so the
    merged frontier is the same on every rank of the site group and the
    loop's flag, read from it after each body, gives each the same answer
    with no other collective: a rank that left the loop alone would hang
    the others.
    ``q_bc`` and ``n_bc`` come from that replicated frontier; the rank's
    sites' meters are gathered into ``(n_sites, B)`` at the end, and the
    starts are split over the batch axis, as ``repro`` splits them."""
    if placement is None:
        raise ValueError(
            "backend='frontier_kernel_sharded' requires placement= (the site partition)"
        )
    if placement.graph.n_nodes != n_nodes:
        raise ValueError(f"placement has {placement.graph.n_nodes} nodes, executor built for {n_nodes}")
    if placement.n_sites % axis_size:
        raise ValueError(
            f"n_sites={placement.n_sites} must be divisible by axis_size={axis_size} "
            "(sites are blocked over the site axes)"
        )
    mesh, site_axes = (ranks.mesh, ranks.site_axes) if ranks is not None else (None, ("data",))
    if plan_store is not None:
        site_graphs = plan_store.local_graphs(placement, stats_epoch, mesh, site_axes)
        exec_staged = plan_store.staged_merged(
            placement, block_size, axis_size, stats_epoch, tile_dtype, mesh, site_axes
        )
        tile_buckets = plan_store.tile_buckets(
            placement, block_size, axis_size, stats_epoch, bucket_floor, tile_dtype, mesh, site_axes
        )
    elif ranks is not None:
        site_graphs = [placement.local_graph(s) for s in range(*ranks.site_block(placement.n_sites))]
        exec_staged = fops.stage_rank_group(site_graphs, block_size, tile_dtype)
        tile_buckets = fops.bucket_rank_group(exec_staged, mesh, site_axes, bucket_floor, device)
    else:
        site_graphs = [placement.local_graph(s) for s in range(placement.n_sites)]
        staged = fops.stage_sharded_graph(site_graphs, block_size, tile_dtype)
        exec_staged = fops.merge_staged_sites(staged, axis_size)
        tile_buckets = fops.bucket_staged_sites(exec_staged, axis_size, bucket_floor, device)
    if ranks is not None:
        plan = fops.build_rank_level_schedule(ca, exec_staged, tile_buckets, mesh, site_axes)
    else:
        plan = fops.build_sharded_level_schedule(
            ca, exec_staged, tile_buckets, axis_size=axis_size, bucket_floor=bucket_floor
        )
    if plan_store is not None:
        plan_store.record_plan_pad_waste(plan)
    dev = plan.buckets[0].tiles.device
    witness = semantics == "witness"
    n_states, q_pad, v_pad = ca.n_states, plan.q_pad, plan.v_pad
    levels = max_levels if max_levels is not None else n_states * n_nodes
    sgroups = symbol_set_groups(ca)
    label_deg = (
        plan_store.label_degrees(
            placement, site_graphs, placement.graph.n_labels, v_pad, stats_epoch, mesh, site_axes
        )
        if plan_store is not None
        else None
    )
    deg, payloads = _site_symbol_degrees(sgroups, site_graphs, v_pad, label_deg)
    deg64 = torch.from_numpy(deg).to(dev, torch.float64)  # (local sites, n_groups, v_pad)
    pay_c = torch.from_numpy(payloads).to(dev)
    n_sites = len(site_graphs)

    n_groups = len(sgroups)

    def level(state, lev):  # frontier, visited, q_bc, n_bc, d_site, *done[, levmap]
        frontier, visited, q_bc, n_bc, d_site, *rest = state
        fr3 = frontier.reshape(n_states, q_pad, v_pad)
        done = []
        for gi, (_, states) in enumerate(sgroups):
            now_g = functools.reduce(torch.maximum, (fr3[s] for s in states))
            new_g = now_g * (1.0 - rest[gi])
            cnt = new_g.sum(dim=1)
            q_bc = q_bc + pay_c[gi] * cnt
            n_bc = n_bc + cnt
            d_site = d_site + EDGE_SYMBOLS * (deg64[:, gi] @ new_g.double().T).float()
            done.append(torch.maximum(rest[gi], now_g))
        new = fops.expand_level_sharded(plan, frontier, mesh, site_axes) * (1.0 - visited)
        out = (new, torch.maximum(visited, new), q_bc, n_bc, d_site, *done)
        return out + (fops.stamp_levels(rest[-1], new > 0, lev),) if witness else out

    loop = fops.LevelLoop(level, levels, "graph" if ranks is None else ranks.loop_mode())

    def fixpoint(f0: torch.Tensor):  # (n_states, q_pad, v_pad) f32 0/1
        visited = f0.reshape(n_states * q_pad, v_pad)
        state = (visited, visited, torch.zeros(q_pad, device=dev), torch.zeros(q_pad, device=dev),
                 torch.zeros((n_sites, q_pad), device=dev),
                 *(torch.zeros((q_pad, v_pad), device=dev) for _ in range(n_groups)))
        if witness:
            state += (fops.initial_levels(visited > 0),)
        _, visited, q_bc, n_bc, d_site, *rest = loop.run(state)
        vis3 = visited.reshape(n_states, q_pad, v_pad)
        acc = torch.zeros((q_pad, v_pad), device=dev)
        for qf in ca.accepting:
            acc = torch.maximum(acc, vis3[qf])
        out = (acc[:, :n_nodes] > 0, q_bc, n_bc, d_site)
        if witness:  # (n_states, q_pad, v_pad) -> (q_pad, n_states, n_nodes)
            out += (rest[-1].reshape(n_states, q_pad, v_pad).transpose(0, 1)[:, :, :n_nodes],)
        return out

    def fn(starts) -> tuple[torch.Tensor, ...]:
        starts = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
        n = starts.shape[0]
        if ranks is not None:
            starts = starts[slice(*ranks.batch_block(n))]
        b = starts.shape[0]
        outs = [(
            torch.zeros((0, n_nodes), dtype=torch.bool, device=dev),
            torch.zeros(0, device=dev), torch.zeros(0, device=dev),
            torch.zeros((n_sites, 0), device=dev),
        ) + ((torch.zeros((0, n_states, n_nodes), device=dev),) if witness else ())]
        for lo in range(0, b, q_pad):
            chunk = starts[lo : lo + q_pad]
            f0 = torch.zeros((n_states, q_pad, v_pad), device=dev)
            f0[ca.start, torch.arange(chunk.shape[0], device=dev), chunk] = 1.0
            outs.append(fixpoint(f0))
        cols = list(zip(*outs))
        acc, q_bc, n_bc = (torch.cat(c)[:b] for c in cols[:3])
        d_site = torch.cat(cols[3], dim=1)[:, :b]
        lev = torch.cat(cols[4])[:b] if witness else None
        if ranks is not None:
            acc, q_bc, n_bc = (ranks.gather_batch(x, n) for x in (acc, q_bc, n_bc))
            d_site = collectives.gather_rows(ranks.gather_batch(d_site, n, dim=1), site_axes,
                                             placement.n_sites, mesh)
            lev = ranks.gather_batch(lev, n) if witness else None
        result = (acc, q_bc, d_site.sum(dim=0), n_bc.to(torch.int32), d_site)
        return result + (lev,) if witness else result

    fn.release = loop.release
    return fn


def s2_execute(
    placement: Placement,
    ca: CompiledAutomaton,
    start_nodes: np.ndarray,
    max_levels: int | None = None,
    step_fn=None,
    device_arrays: dict[str, torch.Tensor] | None = None,
    backend: str = "frontier_kernel",
    block_size: int = 128,
    semantics: str = "pairs",
    tile_dtype: str = "f32",
    staged=None,
    device: str | torch.device | None = None,
    plan_store=None,
    stats_epoch: int = 0,
    tile_store_budget_bytes: int | None = None,
    axis_size: int | None = None,
    bucket_floor: int | None = None,
    mesh=None,
    site_axes: tuple[str, ...] = ("data",),
    batch_axis: str | None = "model",
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
    less than one symbol).  The sharded backend's per-site responses land
    on each cost's ``site_unicast_symbols``.

    ``step_fn`` accepts a prebuilt executor from :func:`make_s2_step_fn`;
    ``staged``, or ``plan_store`` keyed by ``stats_epoch`` (with
    ``tile_store_budget_bytes`` for the out-of-core store), the Stage A
    of the executor built here; ``axis_size`` and ``bucket_floor`` the
    sharded backend's groups and smallest shape class.
    ``device_arrays`` accepts the placement's padded site arrays already
    on the device (:func:`stage_site_arrays`), so a serving loop does not
    stage them per call; the reference backend reads them, and without
    them they come from ``plan_store`` or are staged on ``device``.  The
    kernel backends skip them.

    ``mesh``, ``site_axes`` and ``batch_axis`` run the reference and
    sharded backends per rank (:func:`make_s2_step_fn`); the reference
    backend's ``device_arrays`` are then the rank's rows, and every rank
    returns the whole result."""
    if step_fn is None:
        step_fn = make_s2_step_fn(
            ca, placement.graph.n_nodes, max_levels,
            backend=backend, graph=placement.graph,
            replication_factor=placement.replication_factor,
            block_size=block_size, semantics=semantics, tile_dtype=tile_dtype,
            staged=staged, device=device, plan_store=plan_store, stats_epoch=stats_epoch,
            tile_store_budget_bytes=tile_store_budget_bytes, placement=placement,
            axis_size=axis_size, bucket_floor=bucket_floor, mesh=mesh, site_axes=site_axes,
            batch_axis=batch_axis,
        )
    if getattr(step_fn, "backend", None) == "reference":
        if device_arrays is None:
            device_arrays = (
                plan_store.site_device_arrays(placement, stats_epoch, mesh, site_axes)
                if plan_store is not None
                else stage_site_arrays(placement, device, mesh, site_axes)
            )
        out = step_fn(start_nodes, device_arrays)
    else:
        out = step_fn(start_nodes)
    extras = 1 if getattr(step_fn, "backend", None) == "frontier_kernel_sharded" else 0
    if len(out) != 4 + extras + (semantics == "witness"):
        raise ValueError(f"semantics={semantics!r} needs a step_fn built with it")
    acc, q_bc, d_s2, n_bc = (t.cpu().numpy() for t in out[:4])
    d_sites = out[4].cpu().numpy() if extras else None  # (n_sites, B)
    k_rep = max(placement.replication_factor, 1e-9)
    costs = [
        StrategyCost(
            strategy="S2",
            broadcast_symbols=float(q_bc[i]),
            unicast_symbols=float(d_s2[i]) / k_rep,
            n_broadcasts=int(n_bc[i]),
            edges_retrieved=int(round(float(d_s2[i]) / (EDGE_SYMBOLS * k_rep))),
            site_unicast_symbols=(
                tuple(float(x) for x in d_sites[:, i]) if d_sites is not None else ()
            ),
        )
        for i in range(len(q_bc))
    ]
    if semantics == "witness":
        return acc, costs, out[-1].cpu().numpy()
    return acc, costs
