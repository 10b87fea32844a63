"""Arbitrary distribution and replication of graph data over sites.

Port of ``repro/graph/partition.py``, verbatim numpy: every random
draw is made in ``repro``'s order, so a seed gives the same placement and
the same overlay.

This is the paper's core *setting* (Fig. 1b): the components of the system
are autonomous, so each edge may be stored at arbitrary sites and
replicated — "non-localized" data.  ``distribute`` materializes such a
placement; ``Placement`` provides both the host view (per-site edge id
lists) and the padded per-site arrays that S1's gather reads (sites as
the leading dimension).

``OverlayNetwork`` models the communication graph of §3.5.1: N_p peers,
N_c connections, mean degree d = N_c/N_p; broadcasts cost between N_c and
2·N_c messages (we use the paper's 2·N_c worst case, §4.4).  It also
implements the §5.2.1 estimation probes (ping, degree count, replication
sampling).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import LabeledGraph


@dataclasses.dataclass
class Placement:
    """An arbitrary, replicated edge placement over ``n_sites`` sites."""

    graph: LabeledGraph
    n_sites: int
    site_edges: list[np.ndarray]  # per site: edge ids held (sorted)
    replication: np.ndarray  # (E,) number of sites holding each edge

    @property
    def replication_factor(self) -> float:
        """K — average number of locations per data resource (§3.5.1)."""
        return float(self.replication.mean())

    @property
    def replication_rate(self) -> float:
        """k = K / N_p (must satisfy k < 1 for a sane placement, §4.5)."""
        return self.replication_factor / self.n_sites

    def padded_device_arrays(self, pad_multiple: int = 8) -> dict[str, np.ndarray]:
        """Static-shape per-site edge arrays, numpy, as in ``repro``.

        Returns src/lbl/dst of shape (n_sites, max_edges) plus a validity
        mask; padding rows replicate edge 0 with mask=False."""
        g = self.graph
        max_e = max((len(e) for e in self.site_edges), default=1)
        max_e = max(1, -(-max_e // pad_multiple) * pad_multiple)
        src = np.zeros((self.n_sites, max_e), np.int32)
        lbl = np.zeros((self.n_sites, max_e), np.int32)
        dst = np.zeros((self.n_sites, max_e), np.int32)
        mask = np.zeros((self.n_sites, max_e), bool)
        for s, eids in enumerate(self.site_edges):
            n = len(eids)
            src[s, :n] = g.src[eids]
            lbl[s, :n] = g.lbl[eids]
            dst[s, :n] = g.dst[eids]
            mask[s, :n] = True
        return {"src": src, "lbl": lbl, "dst": dst, "mask": mask}

    def local_graph(self, site: int) -> LabeledGraph:
        eids = self.site_edges[site]
        g = self.graph
        return LabeledGraph(g.n_nodes, g.src[eids], g.lbl[eids], g.dst[eids], g.labels)


def distribute(
    graph: LabeledGraph,
    n_sites: int,
    replication_rate: float = 0.2,
    skew: float = 0.0,
    seed: int = 0,
) -> Placement:
    """Place each edge on sites independently with probability
    ``replication_rate`` (per-site Bernoulli, so E[copies] = k·N_p = K),
    then assign orphan edges one uniform site (every resource exists
    somewhere).  ``skew`` > 0 biases site popularity (Dirichlet) to model
    autonomous peers hosting very different amounts of data — 'arbitrarily
    distributed' includes non-uniform placements."""
    rng = np.random.default_rng(seed)
    E = graph.n_edges
    if skew > 0:
        site_w = rng.dirichlet(np.full(n_sites, 1.0 / (skew + 1e-9)))
        site_p = np.clip(site_w * replication_rate * n_sites, 0.0, 1.0)
    else:
        site_p = np.full(n_sites, replication_rate)

    holds = rng.random((n_sites, E)) < site_p[:, None]
    orphan = ~holds.any(axis=0)
    if orphan.any():
        owners = rng.integers(0, n_sites, orphan.sum())
        holds[owners, np.nonzero(orphan)[0]] = True

    site_edges = [np.nonzero(holds[s])[0].astype(np.int64) for s in range(n_sites)]
    replication = holds.sum(axis=0).astype(np.int32)
    return Placement(graph, n_sites, site_edges, replication)



@dataclasses.dataclass
class OverlayNetwork:
    """The peers' communication graph (§3.5.1/§4.4)."""

    n_peers: int
    adj_src: np.ndarray  # (2*N_c,) undirected edges stored both ways
    adj_dst: np.ndarray

    @property
    def n_connections(self) -> int:
        return len(self.adj_src) // 2

    @property
    def mean_degree(self) -> float:
        """d — (outgoing) node degree; N_c ≈ d·N_p (§4.4)."""
        return self.n_connections / self.n_peers

    def broadcast_message_cost(self, n_symbols: int) -> float:
        """Paper §4.4: cost of broadcasting b symbols ≈ 2·N_c·b = 2·d·N_p·b."""
        return 2.0 * self.n_connections * n_symbols

    # ---- §5.2.1 estimation probes ----------------------------------------
    def probe_ping(self) -> int:
        """Broadcast ping: every peer acks — yields N_p."""
        return self.n_peers

    def probe_connection_count(self) -> int:
        """Each peer reports active connections; sum = 2·N_c."""
        return int(len(self.adj_src))

    def probe_replication(
        self, placement: Placement, n_samples: int = 32, seed: int = 0
    ) -> float:
        """Query a sample of known resources; the average response count
        estimates K, divided by N_p gives k̂ (§5.2.1)."""
        rng = np.random.default_rng(seed)
        eids = rng.integers(0, placement.graph.n_edges, n_samples)
        responses = placement.replication[eids]
        return float(responses.mean()) / self.n_peers


def random_overlay(n_peers: int, mean_degree: float, seed: int = 0) -> OverlayNetwork:
    """Connected random overlay: ring (connectivity) + random chords to
    reach the target mean degree d = N_c/N_p."""
    rng = np.random.default_rng(seed)
    ring = [(i, (i + 1) % n_peers) for i in range(n_peers)]
    target_nc = int(round(mean_degree * n_peers))
    chords: set[tuple[int, int]] = set()
    existing = {tuple(sorted(e)) for e in ring}
    while len(chords) + len(ring) < target_nc:
        a, b = rng.integers(0, n_peers, 2)
        if a == b:
            continue
        key = tuple(sorted((int(a), int(b))))
        if key in existing or key in chords:
            continue
        chords.add(key)
    edges = ring + sorted(chords)
    src = np.array([e[0] for e in edges] + [e[1] for e in edges], np.int32)
    dst = np.array([e[1] for e in edges] + [e[0] for e in edges], np.int32)
    return OverlayNetwork(n_peers, src, dst)
