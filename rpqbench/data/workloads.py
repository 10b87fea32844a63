"""The seed-path request stream, frozen.

A copy of the port's ``graph/workloads.py`` ``generate``: random walks
over real paths, generalised into queries (wildcards, unions, closures),
a hot pool of classes under rank weights and fresh cold queries.  The one
change is that the walk's candidate sources are found once per stream,
not once per walk; the draws are the port's, query for query and start
for start (``rpqbench/tests/test_rpqbench_data.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rpqbench.data.graph import Graph


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    n_queries: int = 100
    min_len: int = 2
    max_len: int = 4
    wildcard_prob: float = 0.10
    union_prob: float = 0.20
    closure_prob: float = 0.15
    hot_fraction: float = 0.8
    hot_pool: int = 8
    min_starts: int = 1
    max_starts: int = 8
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Request:
    query: str
    starts: np.ndarray  # (k,) int32; starts[0] witnesses the seed path
    hot: bool


def _out_csr(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    order = np.argsort(graph.src, kind="stable")
    offsets = np.zeros(graph.n_nodes + 1, np.int64)
    np.add.at(offsets[1:], graph.src, 1)
    np.cumsum(offsets, out=offsets)
    return order, offsets


def _seed_path(graph: Graph, sources: np.ndarray, order: np.ndarray, offsets: np.ndarray,
               length: int, rng: np.random.Generator) -> tuple[int, list[int]]:
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


def _instantiate(graph: Graph, labels: list[int], cfg: StreamConfig, rng: np.random.Generator) -> str:
    atoms = []
    for lid in labels:
        r = rng.random()
        if r < cfg.wildcard_prob:
            atom = "."
        elif r < cfg.wildcard_prob + cfg.union_prob and graph.n_labels > 1:
            other = int(rng.integers(graph.n_labels - 1))
            other += other >= lid
            atom = f"({graph.labels[lid]}|{graph.labels[other]})"
        else:
            atom = graph.labels[lid]
        if rng.random() < cfg.closure_prob:
            atom = f"({atom})" + ("*" if rng.random() < 0.5 else "+")
        atoms.append(atom)
    return " ".join(atoms)


def generate(graph: Graph, cfg: StreamConfig) -> list[Request]:
    """The deterministic request stream of ``cfg.seed``."""
    rng = np.random.default_rng(cfg.seed)
    order, offsets = _out_csr(graph)
    sources = np.unique(graph.src)

    def fresh() -> tuple[str, int]:
        length = int(rng.integers(cfg.min_len, cfg.max_len + 1))
        source, labels = _seed_path(graph, sources, order, offsets, length, rng)
        while not labels:
            source, labels = _seed_path(graph, sources, order, offsets, length, rng)
        return _instantiate(graph, labels, cfg, rng), source

    hot_classes = [fresh() for _ in range(cfg.hot_pool)]
    hot_w = 1.0 / (1.0 + np.arange(len(hot_classes)))
    hot_w /= hot_w.sum()
    out: list[Request] = []
    for _ in range(cfg.n_queries):
        hot = rng.random() < cfg.hot_fraction and hot_classes
        if hot:
            query, source = hot_classes[int(rng.choice(len(hot_classes), p=hot_w))]
        else:
            query, source = fresh()
        k = int(rng.integers(cfg.min_starts, cfg.max_starts + 1))
        extras = rng.integers(0, graph.n_nodes, max(k - 1, 0))
        starts = np.concatenate([[source], extras]).astype(np.int32)
        out.append(Request(query=query, starts=starts, hot=bool(hot)))
    return out
