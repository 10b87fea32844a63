"""Layer-wise fanout neighbor sampling (GraphSAGE-style) for the
``minibatch_lg`` shapes: batch_nodes=1024, fanout 15-10.

Port of ``repro/graph/sampling.py``, verbatim numpy on the port's
``LabeledGraph``: the same draws from the same seed, so the same
subgraph.  The sampler is a *bounded S2 frontier expansion*: each hop is
a demand-driven neighbor retrieval of exactly the nodes the batch needs
— the bottom-up strategy of the paper, with a per-hop cap instead of a
regex automaton.  It returns static-shape padded arrays, so the sampled
step runs with one shape regardless of the drawn neighborhood.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import LabeledGraph


@dataclasses.dataclass
class SampledSubgraph:
    """Static-shape sampled block: layered bipartite edge lists.

    ``nodes`` maps compact local ids -> global node ids (padded with -1);
    ``edge_src``/``edge_dst`` are local ids per layer, padded with 0 and
    masked by ``edge_mask``.  Layer l's edges connect layer-(l+1) sources
    to layer-l destinations (messages flow toward the batch nodes)."""

    nodes: np.ndarray  # (max_nodes,) int32 global ids, -1 pad
    n_real_nodes: int
    edge_src: list[np.ndarray]  # per layer: (max_edges_l,) int32 local ids
    edge_dst: list[np.ndarray]
    edge_mask: list[np.ndarray]  # per layer: (max_edges_l,) bool
    batch_size: int  # first ``batch_size`` entries of ``nodes`` are the seeds


class NeighborSampler:
    """CSR-backed uniform fanout sampler over the (label-agnostic) graph."""

    def __init__(self, graph: LabeledGraph):
        order = np.argsort(graph.dst, kind="stable")  # in-edges: sample msg sources
        self.sorted_src = graph.src[order]
        self.offsets = np.zeros(graph.n_nodes + 1, np.int64)
        np.cumsum(np.bincount(graph.dst, minlength=graph.n_nodes), out=self.offsets[1:])
        self.n_nodes = graph.n_nodes

    @staticmethod
    def plan_shapes(batch_size: int, fanout: tuple[int, ...]) -> tuple[int, list[int]]:
        """Static shape plan: max nodes and per-layer max edges."""
        sizes = [batch_size]
        edges = []
        for f in fanout:
            edges.append(sizes[-1] * f)
            sizes.append(sizes[-1] * f)
        return sum(sizes), edges

    def sample(
        self, seeds: np.ndarray, fanout: tuple[int, ...], seed: int = 0
    ) -> SampledSubgraph:
        rng = np.random.default_rng(seed)
        seeds = np.asarray(seeds, np.int32)
        max_nodes, max_edges = self.plan_shapes(len(seeds), fanout)

        node_ids: list[int] = list(map(int, seeds))
        local: dict[int, int] = {int(n): i for i, n in enumerate(seeds)}
        frontier = list(map(int, seeds))
        edge_src_l, edge_dst_l, edge_mask_l = [], [], []

        for li, f in enumerate(fanout):
            es, ed = [], []
            nxt: list[int] = []
            for v in frontier:
                lo, hi = self.offsets[v], self.offsets[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, int(deg))
                picks = self.sorted_src[lo + rng.choice(deg, size=take, replace=False)]
                for u in picks:
                    u = int(u)
                    if u not in local:
                        local[u] = len(node_ids)
                        node_ids.append(u)
                        nxt.append(u)
                    es.append(local[u])
                    ed.append(local[v])
            n = len(es)
            cap = max_edges[li]
            src = np.zeros(cap, np.int32)
            dst = np.zeros(cap, np.int32)
            mask = np.zeros(cap, bool)
            src[:n] = es[:cap]
            dst[:n] = ed[:cap]
            mask[:n] = True
            edge_src_l.append(src)
            edge_dst_l.append(dst)
            edge_mask_l.append(mask)
            frontier = nxt

        nodes = np.full(max_nodes, -1, np.int32)
        nodes[: len(node_ids)] = node_ids
        return SampledSubgraph(
            nodes=nodes,
            n_real_nodes=len(node_ids),
            edge_src=edge_src_l,
            edge_dst=edge_dst_l,
            edge_mask=edge_mask_l,
            batch_size=len(seeds),
        )
