"""The placement of edges over sites and the peers' overlay, frozen.

Copies of the port's ``graph/partition.py`` ``distribute`` and
``random_overlay``, drawing in the same order, so a seed gives the same
placement and overlay as the port's functions
(``rpqbench/tests/test_rpqbench_data.py``).  They return plain arrays;
the harness builds the port's ``Placement`` and ``OverlayNetwork`` from
them.
"""

from __future__ import annotations

import numpy as np


def distribute(
    n_edges: int, n_sites: int, replication_rate: float = 0.2, skew: float = 0.0, seed: int = 0
) -> tuple[list[np.ndarray], np.ndarray]:
    """Each edge on each site with probability ``replication_rate``, an
    orphan edge on one uniform site.  Returns (per-site sorted edge ids,
    the number of sites holding each edge)."""
    rng = np.random.default_rng(seed)
    if skew > 0:
        site_w = rng.dirichlet(np.full(n_sites, 1.0 / (skew + 1e-9)))
        site_p = np.clip(site_w * replication_rate * n_sites, 0.0, 1.0)
    else:
        site_p = np.full(n_sites, replication_rate)
    holds = rng.random((n_sites, n_edges)) < site_p[:, None]
    orphan = ~holds.any(axis=0)
    if orphan.any():
        owners = rng.integers(0, n_sites, orphan.sum())
        holds[owners, np.nonzero(orphan)[0]] = True
    site_edges = [np.nonzero(holds[s])[0].astype(np.int64) for s in range(n_sites)]
    return site_edges, holds.sum(axis=0).astype(np.int32)


def random_overlay(n_peers: int, mean_degree: float, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """A ring plus random chords up to mean degree N_c / N_p; returns the
    undirected connections stored both ways (src, dst)."""
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
    return src, dst
