"""Query cost estimation via statistical graph models (paper §5).

Port of ``repro/core/estimation.py``.  The model fits, the rollouts and
the §5.2.2 point estimates are ``repro``'s numpy code, verbatim: the
same float64 counts, the same LIFO queue, the same sorted symbol sets
and the same ``rng.poisson`` then ``rng.integers`` draws, so a seed gives
``repro``'s rollouts exactly.  ``branching_tail`` is the one device
computation; torch's generator is not JAX's, so its samples equal
``repro``'s in distribution only.

Two generative models, both fitted from label statistics (obtainable from
a sample of the data, §5.2.2):

* :class:`GilbertModel` (§5.3.1): every labeled edge (v, a, u) exists
  i.i.d. with probability p(a) — per-node out-degree for label a is
  Binomial(V, p(a)) ≈ Poisson(λ_a), targets uniform.
* :class:`BayesianModel` (§5.3.2): the out-edge counts of a node are
  conditioned on the label that *reached* the node: upon arriving via
  label a, out-degree for label b is Poisson(λ_{b|a}) where λ_{b|a} is the
  empirical mean number of b-out-edges over nodes with an incoming a-edge.
  The start node (no incoming label) uses the unconditional rates.

``rollout`` replays the PAA against the generative model (the paper's
'replace the access to the data graph with a function that randomly
generates edges'), with the same §4.2.2 message accounting as the real S2
run, so the outputs are directly comparable distributions of
(Q_bc, D_s2, edges_traversed).

``branching_tail`` is a beyond-paper vectorized estimator: for the
Gilbert model, ignoring path merging, the frontier sizes form a multitype
(one type per automaton state) Poisson branching process — thousands of
rollouts become one (R, n_states) count matrix stepped on the device.  It
upper-bounds the BFS rollout (no dedup) and runs far faster.
"""

from __future__ import annotations

import dataclasses
import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core.automaton import FWD, CompiledAutomaton
from repro_torch.core.strategies import EDGE_SYMBOLS
from repro_torch.graph.structure import LabeledGraph


@dataclasses.dataclass
class RolloutResult:
    q_bc: int
    d_s2: int
    edges_traversed: int
    nodes_visited: int
    capped: bool


# ---------------------------------------------------------------------------
# Model fitting
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GilbertModel:
    n_nodes: int
    lam: np.ndarray  # (n_labels,) expected out-degree per label = p(a)·V
    lam_in: np.ndarray  # (n_labels,) expected in-degree per label (for INV)

    @classmethod
    def fit(cls, graph: LabeledGraph, sample_fraction: float = 1.0, seed: int = 0) -> "GilbertModel":
        counts = _sampled_label_counts(graph, sample_fraction, seed)
        lam = counts / graph.n_nodes
        return cls(graph.n_nodes, lam, lam.copy())

    def out_rate(self, label_id: int, via_label: int | None) -> float:
        return float(self.lam[label_id])

    def in_rate(self, label_id: int, via_label: int | None) -> float:
        return float(self.lam_in[label_id])


@dataclasses.dataclass(frozen=True)
class BayesianModel:
    n_nodes: int
    lam0: np.ndarray  # (n_labels,) unconditional rates (start node)
    lam_cond: np.ndarray  # (n_labels, n_labels): λ_{b|a}, arrival label a -> out label b
    lam0_in: np.ndarray
    lam_cond_in: np.ndarray  # conditional *in*-degree rates (for INV transitions)

    @classmethod
    def fit(cls, graph: LabeledGraph, sample_fraction: float = 1.0, seed: int = 0) -> "BayesianModel":
        g = _maybe_sample(graph, sample_fraction, seed)
        V, L = graph.n_nodes, graph.n_labels
        out_cnt = np.zeros((V, L), np.float64)
        in_cnt = np.zeros((V, L), np.float64)
        np.add.at(out_cnt, (g.src, g.lbl), 1.0)
        np.add.at(in_cnt, (g.dst, g.lbl), 1.0)
        scale = 1.0 / max(sample_fraction, 1e-12)
        lam0 = out_cnt.sum(0) * scale / V
        lam0_in = in_cnt.sum(0) * scale / V

        # λ_{b|a}: mean out-degree for b over *edge arrivals* via a.
        # in_cnt[:, a] weights each node by its number of incoming a-edges.
        arrivals = in_cnt.sum(0)  # (L,)
        lam_cond = np.zeros((L, L))
        lam_cond_in = np.zeros((L, L))
        nz = arrivals > 0
        lam_cond[nz] = (in_cnt.T[nz] @ out_cnt) / arrivals[nz, None]
        # conditional in-degree: subtract the arrival edge itself (you always
        # have >=1 in-edge of label a if you arrived via a — exclude it so the
        # INV model doesn't count the path you came from)
        lam_cond_in[nz] = (in_cnt.T[nz] @ in_cnt) / arrivals[nz, None]
        for a in range(L):
            if nz[a]:
                lam_cond_in[a, a] = max(lam_cond_in[a, a] - 1.0, 0.0)
        return cls(V, lam0, lam_cond, lam0_in, lam_cond_in)

    def out_rate(self, label_id: int, via_label: int | None) -> float:
        if via_label is None:
            return float(self.lam0[label_id])
        return float(self.lam_cond[via_label, label_id])

    def in_rate(self, label_id: int, via_label: int | None) -> float:
        if via_label is None:
            return float(self.lam0_in[label_id])
        return float(self.lam_cond_in[via_label, label_id])


def _sampled_label_counts(graph: LabeledGraph, fraction: float, seed: int) -> np.ndarray:
    g = _maybe_sample(graph, fraction, seed)
    scale = 1.0 / max(fraction, 1e-12)
    return np.bincount(g.lbl, minlength=graph.n_labels).astype(np.float64) * scale


def _maybe_sample(graph: LabeledGraph, fraction: float, seed: int) -> LabeledGraph:
    if fraction >= 1.0:
        return graph
    rng = np.random.default_rng(seed)
    take = rng.random(graph.n_edges) < fraction
    return LabeledGraph(
        graph.n_nodes, graph.src[take], graph.lbl[take], graph.dst[take], graph.labels
    )


# ---------------------------------------------------------------------------
# Generative PAA rollout (paper §5.3: the estimator itself)
# ---------------------------------------------------------------------------


def rollout(
    ca: CompiledAutomaton,
    model: GilbertModel | BayesianModel,
    rng: np.random.Generator,
    max_pops: int = 4000,
) -> RolloutResult:
    """One generative single-source PAA run with §4.2.2 accounting.

    The generated graph stays consistent within the rollout: the first
    query for (node, label, dir) samples and memoizes the edge list —
    mirroring the S2 cache, which would make a repeated real query free.
    """
    V = model.n_nodes
    outs: dict[int, list] = {}
    for t in ca.transitions:
        outs.setdefault(t.src, []).append(t)
    state_symbols = {q: sorted({(t.label_id, t.direction) for t in ts}) for q, ts in outs.items()}

    # arrival label per graph node for the Bayesian conditioning
    via: dict[int, int | None] = {0: None}
    start = 0  # node ids are exchangeable in both models
    memo: dict[tuple[int, int, int], np.ndarray] = {}
    q_bc = d_s2 = edges = pops = 0
    visited = {(ca.start, start)}
    queue = [(ca.start, start)]
    cache: set[tuple[int, tuple]] = set()
    capped = False

    def gen_edges(node: int, label_id: int, direction: int) -> np.ndarray:
        key = (node, label_id, direction)
        if key not in memo:
            via_l = via.get(node)
            rate = model.out_rate(label_id, via_l) if direction == FWD else model.in_rate(label_id, via_l)
            n = rng.poisson(rate)
            memo[key] = rng.integers(0, V, size=n)
        return memo[key]

    while queue:
        if pops >= max_pops:
            capped = True
            break
        q, v = queue.pop()
        pops += 1
        symbols = state_symbols.get(q)
        if not symbols:
            continue
        ck = (v, tuple(symbols))
        if ck not in cache:
            cache.add(ck)
            q_bc += 1 + len(symbols)
            for (lid, direction) in symbols:
                nbrs = gen_edges(v, lid, direction)
                d_s2 += EDGE_SYMBOLS * len(nbrs)
                edges += len(nbrs)
        for t in outs[q]:
            for nb in gen_edges(v, t.label_id, t.direction):
                nb = int(nb)
                if nb not in via:
                    via[nb] = t.label_id
                key = (t.dst, nb)
                if key not in visited:
                    visited.add(key)
                    queue.append(key)
    return RolloutResult(q_bc, d_s2, edges, pops, capped)


def estimate_distribution(
    ca: CompiledAutomaton,
    model: GilbertModel | BayesianModel,
    n_rollouts: int,
    seed: int = 0,
    max_pops: int = 4000,
) -> list[RolloutResult]:
    rng = np.random.default_rng(seed)
    return [rollout(ca, model, rng, max_pops) for _ in range(n_rollouts)]


# ---------------------------------------------------------------------------
# Beyond-paper: vectorized multitype branching-process estimator (device)
# ---------------------------------------------------------------------------


def _branching_matrices(ca: CompiledAutomaton, model: GilbertModel) -> tuple[np.ndarray, np.ndarray]:
    """M[q, q'] = expected children in automaton state q' per active path in
    state q; B[q] = broadcast symbols per popped path in state q."""
    n = ca.n_states
    M = np.zeros((n, n))
    for t in ca.transitions:
        rate = model.out_rate(t.label_id, None) if t.direction == FWD else model.in_rate(t.label_id, None)
        M[t.src, t.dst] += rate
    B = np.zeros(n)
    for q in range(n):
        syms = {(t.label_id, t.direction) for t in ca.transitions if t.src == q}
        B[q] = (1 + len(syms)) if syms else 0.0
    return M, B


def branching_tail(
    ca: CompiledAutomaton,
    model: GilbertModel,
    n_rollouts: int = 4096,
    seed: int = 0,
    max_levels: int = 64,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized (Q_bc, D_s2) samples under the Gilbert model, no-dedup
    upper bound.  Start state is assumed to be automaton state 0 — true
    for our NFA construction after renumbering (start maps to the lowest
    reachable id).

    The (n_rollouts, n_states) f32 count matrix stays on ``device``
    (``None``: the GPU) and takes exactly ``max_levels`` steps, each a
    ``torch.poisson`` draw of every (rollout, q, q') child count from one
    generator seeded with ``seed``, with no host read between them.  An
    extinct rollout's counts are 0, so its later steps add 0: the result
    is ``repro``'s ``while_loop``, which stops at extinction."""
    M, B = _branching_matrices(ca, model)
    # renumber so the start state is row 0
    perm = [ca.start] + [q for q in range(ca.n_states) if q != ca.start]
    M = M[np.ix_(perm, perm)]
    B = B[perm]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    m = torch.as_tensor(M, dtype=torch.float32, device=dev)
    b = torch.as_tensor(B, dtype=torch.float32, device=dev)
    counts = torch.zeros((n_rollouts, ca.n_states), dtype=torch.float32, device=dev)
    counts[:, 0] = 1.0
    q_bc = torch.zeros(n_rollouts, dtype=torch.float32, device=dev)
    d_s2 = torch.zeros(n_rollouts, dtype=torch.float32, device=dev)
    for _ in range(max_levels):
        # Poisson children per (state q -> state q') per active path
        children = torch.poisson(counts[:, :, None] * m, generator=gen)  # (R, n, n)
        q_bc += (counts * b).sum(1)
        d_s2 += EDGE_SYMBOLS * children.sum((1, 2))
        counts = children.sum(1)
    return q_bc.cpu().numpy(), d_s2.cpu().numpy()


# ---------------------------------------------------------------------------
# §5.2.2 point estimates
# ---------------------------------------------------------------------------


def estimate_d_s1(
    graph_sample: LabeledGraph,
    query_label_ids: set[int],
    total_edges: int,
    wildcard: bool = False,
) -> float:
    """D_s1 ≈ (sampled label frequency) × |E| × 3 symbols (§5.2.2)."""
    if wildcard:
        return float(EDGE_SYMBOLS * total_edges)
    counts = graph_sample.label_counts()
    sample_total = max(graph_sample.n_edges, 1)
    freq = sum(counts[i] for i in query_label_ids if i < len(counts)) / sample_total
    return float(EDGE_SYMBOLS * freq * total_edges)
