"""Arbitrary distribution and replication of graph data over sites.

Port of ``repro/graph/partition.py``: ``distribute`` is verbatim numpy,
and ``Placement`` keeps the host view and the replication statistics
(the S2 executor reads K, the replication factor, from the placement).
The padded per-site device view waits for the site-sharded backend, and
the overlay model for the planning slice.

This is the paper's core *setting* (Fig. 1b): the components of the system
are autonomous, so each edge may be stored at arbitrary sites and
replicated — "non-localized" data.  ``distribute`` materializes such a
placement; ``Placement`` holds its per-site edge id lists.
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

