"""Product Automaton Algorithm (PAA) — paper §2.5.

Port of ``repro/core/paa.py``.  Two implementations with one semantics:

* :func:`answers_single_source` / :func:`answers_multi_source` — the
  device form.  The product-automaton search is a *label-masked frontier
  expansion*: the BFS frontier is a 0/1 tensor ``F[b, q, v]`` over (start
  in the batch, automaton state, graph node); one BFS level applies every
  grounded NFA transition as a gather over the label's contiguous edge
  slice followed by ``scatter_reduce(amax)`` onto the edge destinations.
  The level loop is ``repro``'s ``lax.while_loop`` on the device: an
  ``ops.LevelLoop`` that runs ``LEVELS_PER_CHECK`` gated levels per host
  check, never captured (S1 builds a new device graph every request, so
  a CUDA graph would be captured once per run).  :data:`BFS_COUNTERS`
  counts the levels (from the device counter) and the host syncs, one a
  body.  Its levels share no code with the frontier kernel path, so it is
  that path's oracle on the card, and it is S1's local PAA.

* :func:`run_instrumented` — a host (numpy) BFS that additionally performs
  the paper's §4.2 message accounting for strategy S2: per-product-state
  broadcast queries (node id + out-symbol labels, deduplicated by the
  query cache) and unicast responses (3 symbols per matching edge).
  Verbatim from ``repro``.

RPQI (§2.3/§2.6) is handled natively: INV transitions traverse the same
edge slices with src/dst swapped — the extended graph G'_D is never
materialized.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

import torch

from repro_torch.core import automaton as am
from repro_torch.core import regex as rxmod
from repro_torch.core.automaton import FWD, CompiledAutomaton
from repro_torch.graph.structure import DeviceGraph, LabeledGraph, to_device_graph

# ---------------------------------------------------------------------------
# Device frontier-expansion PAA
# ---------------------------------------------------------------------------

# over every device BFS: "levels" expanded (from the loop's device
# counter), "host_syncs" the reads of the loop's flag (one a body),
# "bodies" and "fixpoints" (ops.LevelLoop's counts)
BFS_COUNTERS: collections.Counter = collections.Counter()


def _expand_once(
    ca: CompiledAutomaton, g: DeviceGraph, frontier: torch.Tensor
) -> torch.Tensor:
    """One BFS level: apply every grounded transition to ``frontier``.

    frontier: (B, n_states, V) int32 0/1.  Returns the raw expansion (not
    yet de-duplicated against the visited set).  int32 because the CUDA
    ``scatter_reduce(amax)`` is an integer atomic max there."""
    nxt = torch.zeros_like(frontier)
    b = frontier.shape[0]
    for t in ca.transitions:
        if t.label_id >= 0:
            src, dst = g.label_slice(t.label_id)
        else:  # wildcard: every edge (§3.3 — this is what defeats S1 selection)
            src, dst = g.src, g.dst
        if t.direction != FWD:  # INV: traverse the edge backwards (Δ')
            src, dst = dst, src
        if src.numel() == 0:
            continue
        vals = frontier[:, t.src].index_select(1, src)  # (B, E_label)
        nxt[:, t.dst].scatter_reduce_(
            1, dst.expand(b, -1), vals, reduce="amax", include_self=True
        )
    return nxt


def _reach(ca: CompiledAutomaton, g: DeviceGraph, visited: torch.Tensor, max_levels: int | None) -> torch.Tensor:
    """Fixpoint of frontier expansion from ``visited`` (B, n_states, V)
    int32 0/1, on an uncaptured ``ops.LevelLoop``: the visited set.
    ``max_levels`` defaults to the product-state count m·V (the BFS-depth
    bound guaranteeing termination, §2.7); the loop exits early on
    fixpoint."""
    # imported here: ops imports core.witness, which imports this module
    from repro_torch.kernels.frontier import ops as fops

    if max_levels is None:
        max_levels = ca.n_states * g.n_nodes

    def level(state, lev):
        frontier, seen = state
        new = _expand_once(ca, g, frontier) * (1 - seen)
        return new, seen | new

    return fops.LevelLoop(level, max_levels, "eager", BFS_COUNTERS).run((visited, visited))[1]


def _accepted(
    ca: CompiledAutomaton,
    g: DeviceGraph,
    starts: torch.Tensor,  # (B,) int64 start nodes
    max_levels: int | None = None,
) -> torch.Tensor:
    """Fixpoint of frontier expansion from one start node per batch row
    (:func:`_reach`); returns (B, V) bool: the nodes reached in an
    accepting state."""
    b = starts.shape[0]
    visited = torch.zeros((b, ca.n_states, g.n_nodes), dtype=torch.int32, device=g.device)
    visited[torch.arange(b, device=g.device), ca.start, starts] = 1
    visited = _reach(ca, g, visited, max_levels)
    acc = torch.zeros((b, g.n_nodes), dtype=torch.bool, device=g.device)
    for qf in ca.accepting:
        acc |= visited[:, qf] > 0
    return acc


def reachable(ca: CompiledAutomaton, g: DeviceGraph, start_mask) -> torch.Tensor:
    """Visited product states from an initial node mask (V,): (n_states,
    V) bool, the start state's row seeded with the mask."""
    mask = torch.as_tensor(start_mask, device=g.device).bool()
    visited = torch.zeros((1, ca.n_states, g.n_nodes), dtype=torch.int32, device=g.device)
    visited[0, ca.start] = mask.int()
    return _reach(ca, g, visited, None)[0] > 0


def answers_single_source(
    ca: CompiledAutomaton, g: DeviceGraph, start_node: int
) -> torch.Tensor:
    """Definition 2: nodes v_j with v_0 -w-> v_j, w ∈ L(r).  Returns (V,) bool."""
    starts = torch.tensor([int(start_node)], dtype=torch.int64, device=g.device)
    return _accepted(ca, g, starts)[0]


def answers_multi_source(
    ca: CompiledAutomaton,
    g: DeviceGraph,
    candidate_starts: np.ndarray | None = None,
    chunk: int = 128,
) -> tuple[np.ndarray, np.ndarray]:
    """Definition 1: all pairs (v_i, v_j).  Returns (pairs_src, pairs_dst).

    Runs batched single-source searches over ``candidate_starts`` (default:
    every node — but callers should pass :func:`valid_start_nodes`, the
    paper's '<2% of nodes are valid starting points' observation), at
    most ``chunk`` starts per batch."""
    if candidate_starts is None:
        candidate_starts = np.arange(g.n_nodes, dtype=np.int32)
    candidate_starts = np.asarray(candidate_starts, np.int32)
    out_src: list[np.ndarray] = []
    out_dst: list[np.ndarray] = []
    for lo in range(0, len(candidate_starts), chunk):
        batch = candidate_starts[lo : lo + chunk]
        starts = torch.from_numpy(batch.astype(np.int64)).to(g.device)
        acc = _accepted(ca, g, starts).cpu().numpy()
        bs, vs = np.nonzero(acc)
        out_src.append(batch[bs])
        out_dst.append(vs.astype(np.int32))
    if not out_src:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return np.concatenate(out_src), np.concatenate(out_dst)


def valid_start_nodes(ca: CompiledAutomaton, graph: LabeledGraph) -> np.ndarray:
    """Nodes with at least one adjacent edge matching a start transition —
    the paper's 'valid starting points' (§4.1, Table 2 last column)."""
    has = np.zeros(graph.n_nodes, bool)
    for t in ca.transitions:
        if t.src != ca.start:
            continue
        if t.label_id >= 0:
            mask = graph.lbl == t.label_id
        else:
            mask = np.ones(graph.n_edges, bool)
        if t.direction == FWD:
            has[graph.src[mask]] = True
        else:
            has[graph.dst[mask]] = True
    return np.nonzero(has)[0].astype(np.int32)


# ---------------------------------------------------------------------------
# Instrumented host PAA — exact §4.2 message accounting for S2
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class S2Trace:
    """Message-cost trace of one single-source S2 execution (§4.2.2).

    Symbol counting follows the paper exactly: each node id or edge label
    transmitted counts 1; an edge response counts 3 (two node ids + label).
    ``q_bc`` is the paper's Q_bc(q, G_D); ``d_s2`` is D_s2(q, G_D).
    """

    q_bc: int = 0  # total broadcast symbols
    d_s2: int = 0  # total unicast symbols (edges retrieved × 3)
    n_broadcasts: int = 0  # distinct broadcast queries (cache misses)
    n_cache_hits: int = 0
    edges_traversed: int = 0  # distinct edges retrieved (selectivity measure, §5.4)
    nodes_visited: int = 0  # distinct product states popped
    answers: set[int] = dataclasses.field(default_factory=set)


class HostIndex:
    """CSR indexes by (src,label) and (dst,label) for the host BFS."""

    def __init__(self, graph: LabeledGraph):
        self.graph = graph
        key_out = graph.src.astype(np.int64) * graph.n_labels + graph.lbl
        self.out_order = np.argsort(key_out, kind="stable")
        self.out_keys = key_out[self.out_order]
        key_in = graph.dst.astype(np.int64) * graph.n_labels + graph.lbl
        self.in_order = np.argsort(key_in, kind="stable")
        self.in_keys = key_in[self.in_order]

    def out_edges(self, node: int, label: int) -> np.ndarray:
        key = node * self.graph.n_labels + label
        lo = np.searchsorted(self.out_keys, key, "left")
        hi = np.searchsorted(self.out_keys, key, "right")
        return self.out_order[lo:hi]

    def in_edges(self, node: int, label: int) -> np.ndarray:
        key = node * self.graph.n_labels + label
        lo = np.searchsorted(self.in_keys, key, "left")
        hi = np.searchsorted(self.in_keys, key, "right")
        return self.in_order[lo:hi]

    def all_out_edges(self, node: int) -> np.ndarray:
        return np.nonzero(self.graph.src == node)[0]

    def all_in_edges(self, node: int) -> np.ndarray:
        return np.nonzero(self.graph.dst == node)[0]


def run_instrumented(
    ca: CompiledAutomaton,
    index: HostIndex,
    start_node: int,
    max_pops: int | None = None,
) -> S2Trace:
    """Single-source PAA with S2 message accounting (numpy BFS).

    The per-state broadcast is ``{node, labels(out-symbols of q)}`` costing
    ``1 + |labels|`` symbols; identical (node, labelset) queries are served
    from the local cache (§4.2.2's 'simple optimization').  ``max_pops``
    implements the paper's §3.6 cost cap: S2 can be interrupted once a
    limit is reached (at the expense of completeness).
    """
    graph = index.graph
    trace = S2Trace()
    # per automaton state: grouped transitions (label_id, direction, dst_state)
    outs: dict[int, list] = {}
    for t in ca.transitions:
        outs.setdefault(t.src, []).append(t)

    # broadcast payload per automaton state: distinct (label, dir) symbols
    state_symbols = {
        q: sorted({(t.label_id, t.direction) for t in ts}) for q, ts in outs.items()
    }

    visited: set[tuple[int, int]] = set()
    cache: set[tuple[int, tuple]] = set()
    seen_edges: set[int] = set()
    queue: list[tuple[int, int]] = [(ca.start, int(start_node))]
    visited.add(queue[0])
    accepting = set(ca.accepting)
    if ca.start in accepting:
        trace.answers.add(int(start_node))

    while queue:
        if max_pops is not None and trace.nodes_visited >= max_pops:
            break
        q, v = queue.pop()
        trace.nodes_visited += 1
        symbols = state_symbols.get(q)
        if not symbols:
            continue
        # ---- broadcast search for this product state (dedup by cache) ----
        cache_key = (v, tuple(symbols))
        if cache_key in cache:
            trace.n_cache_hits += 1
        else:
            cache.add(cache_key)
            trace.n_broadcasts += 1
            trace.q_bc += 1 + len(symbols)  # node id + one symbol per label
            # ---- unicast responses: matching edges, 3 symbols each ------
            for (label_id, direction) in symbols:
                if label_id >= 0:
                    eids = index.out_edges(v, label_id) if direction == FWD else index.in_edges(v, label_id)
                else:
                    eids = index.all_out_edges(v) if direction == FWD else index.all_in_edges(v)
                trace.d_s2 += 3 * len(eids)
                for e in eids:
                    seen_edges.add(int(e) if direction == FWD else -int(e) - 1)
        # ---- expand transitions against the (now locally cached) data ----
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
                    trace.answers.add(int(nb))
    trace.edges_traversed = len(seen_edges)
    return trace


def compile_query(regex_src: str, graph: LabeledGraph) -> CompiledAutomaton:
    """Parse + NFA-compile + ground a query against a graph's vocabulary."""
    return am.ground(am.build_nfa(rxmod.parse(regex_src)), graph.label_to_id)


def device_form(graph: LabeledGraph, device: str | torch.device | None = None) -> DeviceGraph:
    """``graph`` in the device PAA's form (:func:`to_device_graph`) on
    ``device`` (``None``: the GPU)."""
    return to_device_graph(graph, device)
