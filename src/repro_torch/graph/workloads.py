"""Synthetic RPQ workload generation by seed-path instantiation.

Port of ``repro/graph/workloads.py``, verbatim (numpy): on the same
graph and seed both packages draw the same stream, query for query and
start for start.

Benchmarking a serving runtime needs a query *stream*, and sampling
random regular expressions over the label vocabulary produces mostly
dead queries — on a sparse labeled graph an arbitrary label sequence
almost never matches a path, so every request degenerates to an empty
frontier after one level and nothing downstream (batching, S1/S2
choice, cost feedback) is exercised.  The standard fix (used by RPQ
workload studies over Wikidata/YAGO logs) is **seed-path
instantiation**: random-walk a real path through the graph, then
generalize its label sequence into a query — the walk's source node is
a witness, so the query is answerable by construction.

Generalization knobs mirror the query features the paper's cost model
cares about (§4): per-atom *wildcard* substitution (``.`` defeats S1's
label-based selection, §3.6), *union* widening (``(a|b)`` — bigger
label masks, bigger S1 gathers), and closure quantifiers (``+``/``*``
— unbounded path length, the S2 fixpoint's reason to exist).

The stream is **hot/cold skewed**: a small pool of hot query classes is
generated once and dominates the stream under a rank-weighted
distribution (serving realism — plan caches and batching lanes only pay
off when query classes repeat), with fresh cold queries filling the
rest.  Everything is deterministic under ``WorkloadConfig.seed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import LabeledGraph


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_queries: int = 100
    # seed-path length range (inclusive) = atoms per query
    min_len: int = 2
    max_len: int = 4
    # per-atom generalization probabilities
    wildcard_prob: float = 0.10
    union_prob: float = 0.20
    closure_prob: float = 0.15  # append '+' (or '*', half the time)
    # hot/cold skew: hot_fraction of the stream draws from a pool of
    # hot_pool pre-instantiated classes, rank-weighted (rank r gets
    # weight 1/(1+r)); the rest are fresh cold queries
    hot_fraction: float = 0.8
    hot_pool: int = 8
    # start nodes per request: the walk's source (a guaranteed witness)
    # plus uniform-random extras up to a size drawn from this range
    min_starts: int = 1
    max_starts: int = 8
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class WorkloadQuery:
    """One request of the stream."""

    query: str
    starts: np.ndarray  # (k,) int32; starts[0] is the seed-path witness
    hot: bool  # drawn from the hot pool (plan-cache-hit traffic)


def _out_csr(graph: LabeledGraph) -> tuple[np.ndarray, np.ndarray]:
    """Edge ids grouped by source node: (order, offsets)."""
    order = np.argsort(graph.src, kind="stable")
    offsets = np.zeros(graph.n_nodes + 1, np.int64)
    np.add.at(offsets[1:], graph.src, 1)
    np.cumsum(offsets, out=offsets)
    return order, offsets


def _seed_path(
    graph: LabeledGraph,
    order: np.ndarray,
    offsets: np.ndarray,
    length: int,
    rng: np.random.Generator,
) -> tuple[int, list[int]]:
    """Random-walk ``length`` edges; returns (source node, label ids).

    Starts are drawn from nodes with outgoing edges; a dead end cuts
    the walk short (the prefix is still a witnessed path)."""
    sources = np.unique(graph.src)
    if len(sources) == 0:
        return 0, []
    start = int(sources[rng.integers(len(sources))])
    node, labels = start, []
    for _ in range(length):
        lo, hi = offsets[node], offsets[node + 1]
        if hi <= lo:
            break
        eid = int(order[rng.integers(lo, hi)])
        labels.append(int(graph.lbl[eid]))
        node = int(graph.dst[eid])
    return start, labels


def _instantiate(
    graph: LabeledGraph, labels: list[int], cfg: WorkloadConfig, rng: np.random.Generator
) -> str:
    """Generalize a witnessed label sequence into a query string."""
    atoms = []
    for lid in labels:
        r = rng.random()
        if r < cfg.wildcard_prob:
            atom = "."
        elif r < cfg.wildcard_prob + cfg.union_prob and graph.n_labels > 1:
            other = int(rng.integers(graph.n_labels - 1))
            other += other >= lid  # any label but the witnessed one
            atom = f"({graph.labels[lid]}|{graph.labels[other]})"
        else:
            atom = graph.labels[lid]
        if rng.random() < cfg.closure_prob:
            # '+' keeps the witness valid unconditionally; '*' widens
            # (and on a wildcard atom forces the S2-flavored all-pairs
            # shape the closure knob exists to produce)
            atom = f"({atom})" + ("*" if rng.random() < 0.5 else "+")
        atoms.append(atom)
    return " ".join(atoms)


def generate(graph: LabeledGraph, config: WorkloadConfig | None = None) -> list[WorkloadQuery]:
    """The deterministic request stream for ``config.seed``.

    Every query is answerable from its first start node by construction
    (the seed path's source witnesses the un-generalized sequence, and
    every generalization step only widens the language)."""
    cfg = config or WorkloadConfig()
    rng = np.random.default_rng(cfg.seed)
    order, offsets = _out_csr(graph)

    def fresh() -> tuple[str, int]:
        length = int(rng.integers(cfg.min_len, cfg.max_len + 1))
        source, labels = _seed_path(graph, order, offsets, length, rng)
        while not labels:  # isolated pocket: rewalk
            source, labels = _seed_path(graph, order, offsets, length, rng)
        return _instantiate(graph, labels, cfg, rng), source

    hot_classes = [fresh() for _ in range(cfg.hot_pool)]
    hot_w = 1.0 / (1.0 + np.arange(len(hot_classes)))
    hot_w /= hot_w.sum()

    out: list[WorkloadQuery] = []
    for _ in range(cfg.n_queries):
        hot = rng.random() < cfg.hot_fraction and hot_classes
        if hot:
            query, source = hot_classes[int(rng.choice(len(hot_classes), p=hot_w))]
        else:
            query, source = fresh()
        k = int(rng.integers(cfg.min_starts, cfg.max_starts + 1))
        extras = rng.integers(0, graph.n_nodes, max(k - 1, 0))
        starts = np.concatenate([[source], extras]).astype(np.int32)
        out.append(WorkloadQuery(query=query, starts=starts, hot=bool(hot)))
    return out
