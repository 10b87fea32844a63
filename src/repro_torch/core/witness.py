"""Run-based witness semantics for RPQ answers (the semantics layer).

Port of ``repro/core/witness.py``: the host half of the layer, numpy
code kept verbatim on the port's ``core.automaton`` and ``core.paa``.
``repro``'s module cannot be imported, because it imports
``repro.core.paa``, which loads jax.

The paper's answers are node pairs, but run-based RPQ semantics (Francis
& Marsault, PAPERS.md) asks for the *run* that witnessed a pair: a walk
``start = v_0 -l_1-> v_1 ... -l_m-> v_m = target`` whose label sequence
is accepted by the query automaton.

* the executors (``strategies.make_s2_step_fn(semantics="witness")``
  and the ``reach_fixpoint*_levels`` fixpoints in
  :mod:`repro_torch.kernels.frontier.ops`) carry one extra f32 plane per
  product state — the **discovery level** of each (automaton state,
  node) pair, :data:`INF_LEVEL` when never reached.  Levels are
  *implicit parent pointers*: every discovered pair has, by
  construction, at least one in-edge in the product graph from a pair
  with a strictly smaller level, so no per-edge pointer storage is
  needed on device (the frontier stays one f32/int32 plane wide);
* :func:`reconstruct_path` walks those levels backwards through the
  global :class:`~repro_torch.core.paa.HostIndex` and returns a
  label-checked :class:`WitnessPath`;
* :func:`validate_witness` re-checks a path edge by edge against the
  label store, and :func:`nfa_accepts_symbols` re-matches its label
  sequence against the automaton — the two oracles every backend is
  held to;
* :func:`host_levels` is the pure-numpy product-BFS oracle;
* :func:`count_paths` is the bounded-length counting-semiring variant:
  the number of accepting *runs* per target over the same level
  structure (a DP over the product graph, one term per run — an
  ambiguous automaton counts each of a walk's runs once, which is the
  run-based semantics' counting notion).

Level convention (shared by every backend): the start pair
``(ca.start, start_node)`` has level 1; a pair first discovered by the
``i``-th BFS expansion (``i`` counted from 1) has level ``i + 1``.
The port's sharded backend merges every site's discoveries each level,
so its levels are BFS levels too.  ``repro``'s sharded ring backend
counts ring iterations rather than BFS levels above one device, but its
levels remain *valid* for reconstruction: at the device achieving a
pair's minimum level, the pair was discovered by local expansion from a
pair with a strictly smaller level, so the strict-decrease walk below
terminates on them too.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from repro_torch.core.automaton import FWD, CompiledAutomaton
from repro_torch.core.paa import HostIndex

# Discovery-level sentinel for "never reached".  Device fixpoints carry
# levels as f32, so the sentinel must be exactly representable and far
# above any reachable level (levels are bounded by n_states * n_nodes).
INF_LEVEL = np.float32(1e9)


def reached(levels: np.ndarray) -> np.ndarray:
    """Bool mask of product states with a finite discovery level."""
    return np.asarray(levels) < float(INF_LEVEL) / 2


@dataclasses.dataclass
class WitnessPath:
    """One accepting run: ``nodes[i] -steps[i]-> nodes[i+1]`` with the
    automaton in ``states[i]`` before the hop.  ``steps`` carries the
    *concrete* traversed edge label (never -1 — a wildcard transition
    records the label of the edge it actually matched) plus the
    traversal direction, so the path can be validated against the label
    store and re-matched against the regex without any device state."""

    nodes: list[int]  # graph nodes, nodes[0] = start, nodes[-1] = target
    steps: list[tuple[int, int]]  # per hop: (label_id, direction)
    states: list[int]  # automaton states, len(nodes) == len(states)

    def __len__(self) -> int:
        return len(self.steps)


def host_levels(
    ca: CompiledAutomaton,
    index: HostIndex,
    start_node: int,
    max_levels: int | None = None,
) -> np.ndarray:
    """Pure-numpy product-graph BFS discovery levels — the oracle the
    device level carries are differentially tested against, and the S1
    executor's witness source.  Returns (n_states, n_nodes) f32 with
    :data:`INF_LEVEL` marking unreached pairs."""
    graph = index.graph
    levels = np.full((ca.n_states, graph.n_nodes), INF_LEVEL, np.float32)
    levels[ca.start, int(start_node)] = 1.0
    by_src: dict[int, list] = defaultdict(list)
    for t in ca.transitions:
        by_src[t.src].append(t)
    frontier = [(ca.start, int(start_node))]
    lev = 1.0
    budget = max_levels if max_levels is not None else ca.n_states * graph.n_nodes
    while frontier and budget > 0:
        budget -= 1
        lev += 1.0
        nxt: list[tuple[int, int]] = []
        for q, v in frontier:
            for t in by_src[q]:
                if t.direction == FWD:
                    eids = (
                        index.out_edges(v, t.label_id)
                        if t.label_id >= 0
                        else index.all_out_edges(v)
                    )
                    nbrs = graph.dst[eids]
                else:
                    eids = (
                        index.in_edges(v, t.label_id)
                        if t.label_id >= 0
                        else index.all_in_edges(v)
                    )
                    nbrs = graph.src[eids]
                for nb in nbrs:
                    if levels[t.dst, nb] >= INF_LEVEL:
                        levels[t.dst, nb] = lev
                        nxt.append((t.dst, int(nb)))
        frontier = nxt
    return levels


def reconstruct_path(
    ca: CompiledAutomaton,
    index: HostIndex,
    levels: np.ndarray,
    start_node: int,
    target: int,
) -> WitnessPath:
    """Walk the discovery levels back from ``target`` to ``start_node``.

    At each step, pick the predecessor pair with the smallest level among
    all in-transitions of the current pair whose level is *strictly*
    smaller than the current one — strict decrease is what makes the walk
    terminate even on ``repro``'s sharded ring-iteration levels (see the
    module docstring).  Raises ``ValueError`` if ``target`` is not an
    answer under ``levels`` and ``RuntimeError`` if the levels are
    inconsistent with the graph (no strictly-decreasing predecessor)."""
    levels = np.asarray(levels)
    graph = index.graph
    target = int(target)
    state, lev = -1, float(INF_LEVEL)
    for qf in ca.accepting:
        if levels[qf, target] < lev:
            state, lev = qf, float(levels[qf, target])
    if state < 0 or not reached(np.float32(lev)):
        raise ValueError(f"node {target} is not an answer under these levels")
    by_dst: dict[int, list] = defaultdict(list)
    for t in ca.transitions:
        by_dst[t.dst].append(t)

    node = target
    r_nodes, r_steps, r_states = [node], [], [state]
    for _ in range(ca.n_states * graph.n_nodes + 1):
        if lev <= 1.0:
            break
        best = None  # (pred_level, pred_node, label_id, transition)
        for t in by_dst[state]:
            # invert one expansion: a FWD transition discovered (t.dst, v)
            # from (t.src, u) over an edge u -l-> v, an INV transition
            # over an edge v -l-> u
            if t.direction == FWD:
                eids = (
                    index.in_edges(node, t.label_id)
                    if t.label_id >= 0
                    else index.all_in_edges(node)
                )
                preds = graph.src[eids]
            else:
                eids = (
                    index.out_edges(node, t.label_id)
                    if t.label_id >= 0
                    else index.all_out_edges(node)
                )
                preds = graph.dst[eids]
            if len(preds) == 0:
                continue
            plev = levels[t.src, preds]
            j = int(np.argmin(plev))
            if plev[j] < lev and (best is None or plev[j] < best[0]):
                best = (float(plev[j]), int(preds[j]), int(graph.lbl[eids[j]]), t)
        if best is None:
            raise RuntimeError(
                f"levels inconsistent: no strictly-decreasing predecessor of "
                f"(state={state}, node={node}, level={lev})"
            )
        lev, node, label_id, t = best
        r_steps.append((label_id, t.direction))
        r_nodes.append(node)
        r_states.append(t.src)
        state = t.src
    if state != ca.start or node != int(start_node):
        raise RuntimeError(
            f"witness walk ended at (state={state}, node={node}), expected "
            f"(start={ca.start}, node={int(start_node)})"
        )
    return WitnessPath(
        nodes=r_nodes[::-1], steps=r_steps[::-1], states=r_states[::-1]
    )


def validate_witness(path: WitnessPath, graph) -> tuple[bool, str]:
    """Edge-by-edge label-store check: every hop of ``path`` must be a
    real edge of ``graph`` with the recorded label, traversed in the
    recorded direction.  Returns ``(ok, reason)``."""
    edges = set(
        zip(graph.src.tolist(), graph.lbl.tolist(), graph.dst.tolist())
    )
    if len(path.nodes) != len(path.steps) + 1:
        return False, f"{len(path.nodes)} nodes vs {len(path.steps)} steps"
    if len(path.states) != len(path.nodes):
        return False, f"{len(path.states)} states vs {len(path.nodes)} nodes"
    for i, (label_id, direction) in enumerate(path.steps):
        u, v = path.nodes[i], path.nodes[i + 1]
        edge = (u, label_id, v) if direction == FWD else (v, label_id, u)
        if edge not in edges:
            return False, f"hop {i}: edge {edge} not in the label store"
    return True, ""


def nfa_accepts_symbols(
    ca: CompiledAutomaton, steps: list[tuple[int, int]]
) -> bool:
    """Re-match a witness path's (label_id, direction) sequence against
    the grounded automaton — the regex side of the differential check.
    A wildcard transition (label_id -1) matches any concrete label of
    its direction; the empty sequence is accepted iff the start state
    accepts (the start-node self-answer case)."""
    cur = {ca.start}
    for label_id, direction in steps:
        cur = {
            t.dst
            for t in ca.transitions
            if t.src in cur
            and t.direction == direction
            and (t.label_id == label_id or t.label_id < 0)
        }
        if not cur:
            return False
    return bool(cur & set(ca.accepting))


def count_paths(
    ca: CompiledAutomaton,
    index: HostIndex,
    start_node: int,
    max_len: int,
) -> np.ndarray:
    """Bounded-length counting-semiring sum over the level structure:
    ``out[v]`` is the number of accepting runs of length ≤ ``max_len``
    from ``start_node`` to ``v`` (float64 — counts grow exponentially
    with length on cyclic graphs, which is why the bound is required).

    Host oracle for :func:`repro_torch.kernels.frontier.ops.count_paths_bounded`
    — the device variant rides the same Stage-B fused level schedule
    with the saturating min() clamp removed and fan-in unions summed."""
    graph = index.graph
    counts = np.zeros((ca.n_states, graph.n_nodes), np.float64)
    counts[ca.start, int(start_node)] = 1.0
    total = np.zeros(graph.n_nodes, np.float64)
    for qf in ca.accepting:
        total += counts[qf]
    for _ in range(max_len):
        nxt = np.zeros_like(counts)
        for t in ca.transitions:
            if t.label_id >= 0:
                sel = graph.lbl == t.label_id
                src, dst = graph.src[sel], graph.dst[sel]
            else:
                src, dst = graph.src, graph.dst
            if t.direction == FWD:
                np.add.at(nxt[t.dst], dst, counts[t.src][src])
            else:
                np.add.at(nxt[t.dst], src, counts[t.src][dst])
        counts = nxt
        for qf in ca.accepting:
            total += counts[qf]
    return total
