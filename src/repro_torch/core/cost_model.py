"""Query cost functions and strategy choice (paper §4.4–§4.5).

Port of ``repro/core/cost_model.py``, verbatim: plain Python floats.

Implements Eqs. 1–3:

    cost_S1(q, G_D) = N_p · (2·d·Q_lbl + k·D_s1)                      (1)
    cost_S2(q, G_D) = N_p · (2·d·Q_bc  + k·D_s2)                      (2)
    discr(q, G_D)   = 2 · (Q_bc − Q_lbl) / (D_s1 − D_s2)
    S2 optimal  ⇔  k/d > discr(q, G_D)                                (3)

Direction check (the paper's §4.5 inequality chain starts from
cost_S1 < cost_S2): expanding Eqs. 1–2,
cost_S2 < cost_S1 ⇔ 2d(Q_bc − Q_lbl) < k(D_s1 − D_s2) ⇔ k/d > discr —
consistent with the §6 worked example (k/d = 0.067 > discr = 0.058 ⇒
"S2 has a 90% chance of being better").  Special cases (§4.5/Fig. 3),
all consistent with the k/d > discr rule:

  * Q_bc ≤ Q_lbl               → discr ≤ 0 < k/d → S2 necessarily optimal,
  * discr > 1 (given Q_bc>Q_lbl) → k/d < 1 < discr always in the feasible
    region k < 1 < d → S1 necessarily optimal,
  * D_s1 ≤ D_s2 with Q_bc > Q_lbl → discr = +inf → S1.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.strategies import StrategyCost


@dataclasses.dataclass(frozen=True)
class NetworkParams:
    """Distribution parameters of §4.4/§5.2.1."""

    n_peers: int  # N_p
    n_connections: int  # N_c
    replication_rate: float  # k

    @property
    def mean_degree(self) -> float:  # d = N_c / N_p
        return self.n_connections / self.n_peers

    def validate(self) -> None:
        if not (self.replication_rate < 1.0):
            raise ValueError("k >= 1 means every peer replicates the full graph (§4.5)")
        if not (self.mean_degree >= 1.0):
            raise ValueError("d < 1 cannot yield a connected network (§4.5)")


def cost_s1(net: NetworkParams, q_lbl: float, d_s1: float) -> float:
    """Eq. 1 (symbols × messages)."""
    return net.n_peers * (2.0 * net.mean_degree * q_lbl + net.replication_rate * d_s1)


def cost_s2(net: NetworkParams, q_bc: float, d_s2: float) -> float:
    """Eq. 2."""
    return net.n_peers * (2.0 * net.mean_degree * q_bc + net.replication_rate * d_s2)


def cost_of(net: NetworkParams, c: StrategyCost) -> float:
    """Generic Eq. 1/2 form: N_p(2d·bc + k·uc) for any metered strategy.

    Eq. 2's ``N_p·k·D_s2`` term estimates the total unicast response
    symbols across all sites (K = k·N_p copies of each matching edge
    answer).  A site-aware executor (``frontier_kernel_sharded``)
    *measures* that total per site; when ``site_unicast_symbols`` is
    present the measured sum replaces the estimate."""
    broadcast_cost = net.n_peers * 2.0 * net.mean_degree * c.broadcast_symbols
    if c.site_unicast_symbols:
        return broadcast_cost + float(sum(c.site_unicast_symbols))
    return broadcast_cost + net.n_peers * net.replication_rate * c.unicast_symbols


def discriminant(q_lbl: float, d_s1: float, q_bc: float, d_s2: float) -> float:
    """discr(q, G_D) = 2(Q_bc − Q_lbl)/(D_s1 − D_s2).

    Returns +inf when D_s1 == D_s2 and Q_bc > Q_lbl (S1 always wins there),
    and -inf when Q_bc <= Q_lbl (S2 always wins, §4.5 bullet 1)."""
    if q_bc <= q_lbl:
        return -math.inf
    if d_s1 <= d_s2:
        return math.inf
    return 2.0 * (q_bc - q_lbl) / (d_s1 - d_s2)


@dataclasses.dataclass(frozen=True)
class StrategyChoice:
    strategy: str  # "S1" | "S2"
    reason: str
    discr: float
    k_over_d: float
    cost_s1: float
    cost_s2: float


def choose_strategy(
    net: NetworkParams,
    s1: StrategyCost,
    s2: StrategyCost,
) -> StrategyChoice:
    """Apply condition (3) with the Fig.-3 case analysis."""
    net.validate()
    q_lbl, d_s1 = s1.broadcast_symbols, s1.unicast_symbols
    q_bc, d_s2 = s2.broadcast_symbols, s2.unicast_symbols
    disc = discriminant(q_lbl, d_s1, q_bc, d_s2)
    kd = net.replication_rate / net.mean_degree
    c1, c2 = cost_s1(net, q_lbl, d_s1), cost_s2(net, q_bc, d_s2)

    if q_bc <= q_lbl:
        return StrategyChoice("S2", "Q_bc <= Q_lbl: S2 necessarily optimal (§4.5)", disc, kd, c1, c2)
    if disc > 1.0:
        return StrategyChoice(
            "S1", "discr > 1: S2 triangle outside feasible k<1<d region (§4.5)", disc, kd, c1, c2
        )
    if kd > disc:
        return StrategyChoice("S2", "k/d > discr (Eq. 3)", disc, kd, c1, c2)
    return StrategyChoice("S1", "k/d <= discr (Eq. 3)", disc, kd, c1, c2)


def optimality_region(
    q_lbl: float, d_s1: float, q_bc: float, d_s2: float, grid: int = 64
) -> list[tuple[float, float, str]]:
    """Sample the (k, d) rectangle (0,1)×(1,8] — Fig. 3's picture.

    Returns (k, d, winner) triples, as ``repro``'s, which
    benchmarks/fig3_regions.py renders."""
    out = []
    for i in range(grid):
        k = (i + 0.5) / grid
        for j in range(grid):
            d = 1.0 + 7.0 * (j + 0.5) / grid
            net = NetworkParams(n_peers=100, n_connections=int(100 * d), replication_rate=k)
            c1 = cost_s1(net, q_lbl, d_s1)
            c2 = cost_s2(net, q_bc, d_s2)
            out.append((k, d, "S2" if c2 < c1 else "S1"))
    return out
