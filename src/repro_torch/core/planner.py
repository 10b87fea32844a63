"""Query planner — the paper's §6 decision workflow as a library.

Port of ``repro/core/planner.py``, verbatim: host Python and numpy, so
its plans equal ``repro``'s for the same inputs and seeds.

Given a query, a local data sample, and a live network, the planner:

  1. probes the network for N_p, N_c, k (§5.2.1),
  2. computes Q_lbl from the query and estimates D_s1 from sample label
     frequencies (§5.2.2),
  3. estimates the (Q_bc, D_s2) *distribution* with a statistical graph
     model (§5.3) fitted on the sample,
  4. evaluates the discriminant at configurable quantiles and produces a
     strategy decision with a traffic forecast and an S2 cost cap (§3.6).

The same machinery is reused by the framework for non-RPQ data-movement
decisions (DESIGN.md §5): ``embedding_placement`` maps the replicate-vs-
shard choice for recsys embedding tables onto the k/d-vs-discriminant
rule, and distributed GNN training uses the planner to pick between
gather-all-halo (S1) and per-hop demand-driven exchange (S2).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import cost_model, estimation, paa
from repro_torch.core import regex as rx
from repro_torch.core.automaton import (
    NFA,
    CompiledAutomaton,
    GroundedTransition,
    Transition,
)
from repro_torch.core.cost_model import NetworkParams, StrategyChoice
from repro_torch.core.strategies import StrategyCost
from repro_torch.graph.partition import OverlayNetwork, Placement
from repro_torch.graph.structure import LabeledGraph


@dataclasses.dataclass(frozen=True)
class QueryClass:
    """Structural query class (Casel & Schmid's easy-fragment view):
    the planner routes the easy classes to specialized kernel schedules
    instead of the general PAA fixpoint.

    ``kind`` is one of

    * ``"single_label"`` — the whole query matches exactly one symbol
      (a label, a label class, a wildcard, or a union of such): one BFS
      expansion answers it, so the fixpoint runs with ``max_levels=1``;
    * ``"closure"`` — pure transitive closure ``A*`` of a symbol set:
      the product automaton collapses to ONE state
      (:func:`reduce_automaton`), halving-or-better the fused grid work
      and the frontier carry;
    * ``"bounded"`` — a concatenation of symbol atoms: answer depth is
      exactly ``length``, so the fixpoint is level-capped instead of
      run-to-convergence;
    * ``"general"`` — everything else (the full PAA path).

    ``atoms`` records the sorted (name, inverse) symbol atoms for the
    easy kinds (informational — execution works from the *grounded*
    automaton); sorting makes structurally-equal queries classify
    identically regardless of operand order.  The *decision* (kind,
    length) is label-name-free, hence stable under α-renaming."""

    kind: str
    atoms: tuple = ()
    length: int = 0


_ATOM_NODES = (rx.Label, rx.Wildcard, rx.LabelClass)


def _atom_symbols(node: rx.Node) -> tuple | None:
    """The sorted symbol set a single-hop node matches, or None if the
    node is not a one-symbol atom (unions of atoms count: ``(a|b)`` is
    one hop over {a, b})."""
    if isinstance(node, rx.Label):
        return ((node.name, node.inverse),)
    if isinstance(node, rx.Wildcard):
        return (("*", node.inverse),)
    if isinstance(node, rx.LabelClass):
        return tuple(sorted((n, node.inverse) for n in node.names))
    if isinstance(node, rx.Union):
        parts = [_atom_symbols(p) for p in node.parts]
        if any(p is None for p in parts):
            return None
        return tuple(sorted({s for p in parts for s in p}))
    return None


def classify_query(query: str | rx.Node) -> QueryClass:
    """Classify a query into the planner's fast-path classes.  Accepts
    the query string or a parsed AST."""
    ast = rx.parse(query) if isinstance(query, str) else query
    atoms = _atom_symbols(ast)
    if atoms is not None:
        return QueryClass(kind="single_label", atoms=atoms, length=1)
    if isinstance(ast, rx.Star):
        inner = _atom_symbols(ast.inner)
        if inner is not None:
            return QueryClass(kind="closure", atoms=inner)
    if isinstance(ast, rx.Concat):
        parts = [_atom_symbols(p) for p in ast.parts]
        if all(p is not None for p in parts):
            merged = tuple(sorted({s for p in parts for s in p}))
            return QueryClass(kind="bounded", atoms=merged, length=len(parts))
    return QueryClass(kind="general")


def reduce_automaton(ca: CompiledAutomaton, qc: QueryClass) -> CompiledAutomaton:
    """The closure fast path: a pure-closure query's product automaton
    collapses to ONE state with a self-loop per distinct grounded symbol
    — reachability over the symbol-set edge relation IS the answer set
    (start accepting covers the empty run).  Every executor, meter, and
    the witness layer read only the *grounded* transitions, so the
    reduced NFA carries placeholder label names.  Non-closure classes
    return ``ca`` unchanged (their fast path is the level cap, not a
    state reduction)."""
    if qc.kind != "closure":
        return ca
    syms = sorted({(t.label_id, t.direction) for t in ca.transitions})
    nfa = NFA(
        n_states=1,
        start=0,
        accepting=frozenset({0}),
        transitions=tuple(
            Transition(0, f"#{lid}", dirn, 0) for lid, dirn in syms
        ),
    )
    return CompiledAutomaton(
        nfa=nfa,
        n_states=1,
        start=0,
        accepting=(0,),
        transitions=tuple(
            GroundedTransition(0, lid, dirn, 0) for lid, dirn in syms
        ),
        n_labels=ca.n_labels,
    )


def fast_path_max_levels(qc: QueryClass) -> int | None:
    """The fixpoint level cap a query class licenses: 1 for single-label
    queries, the concatenation length for bounded queries, None (run to
    convergence) otherwise."""
    if qc.kind == "single_label":
        return 1
    if qc.kind == "bounded":
        return qc.length
    return None


@dataclasses.dataclass
class QueryPlan:
    query: str
    choice: StrategyChoice
    net: NetworkParams
    q_lbl: float
    d_s1_est: float
    q_bc_quantiles: dict[float, float]
    d_s2_quantiles: dict[float, float]
    p_s2_optimal: float  # fraction of sampled rollouts where Eq. 3 favours S2
    s2_cost_cap: int  # §3.6: interrupt S2 beyond this many expansions
    forecast_symbols: dict[str, float]  # expected network traffic per strategy
    decision_quantile: float = 0.9
    query_class: QueryClass | None = None


@dataclasses.dataclass(frozen=True)
class PlanEstimates:
    """The expensive, *reusable* half of a plan: sample-label point
    estimates plus the raw (Q_bc, D_s2) rollout distribution.

    Everything here depends only on (query, graph statistics) — not on the
    network parameters, the decision quantile, or the serve layer's online
    calibration — so the serve layer's plan cache stores these and re-runs
    only the cheap :func:`decide_strategy` step per request."""

    query: str
    q_lbl: float
    d_s1: float  # un-calibrated §5.2.2 point estimate
    q_bc_samples: np.ndarray  # raw rollout Q_bc samples
    d_s2_samples: np.ndarray  # raw rollout D_s2 samples (not yet D_s1-bounded)
    wildcard: bool
    query_class: QueryClass | None = None  # structural fast-path class


def probe_network(net: OverlayNetwork, placement: Placement, seed: int = 0) -> NetworkParams:
    """§5.2.1: ping (N_p), connection count (2·N_c), replication sample (k)."""
    n_p = net.probe_ping()
    n_c = net.probe_connection_count() // 2
    k = net.probe_replication(placement, n_samples=64, seed=seed)
    return NetworkParams(n_peers=n_p, n_connections=n_c, replication_rate=k)


def fit_model(
    sample: LabeledGraph, model_kind: str = "bayesian"
) -> estimation.GilbertModel | estimation.BayesianModel:
    """Fit the §5.3 statistical graph model once per graph-stats epoch."""
    if model_kind == "gilbert":
        return estimation.GilbertModel.fit(sample)
    return estimation.BayesianModel.fit(sample)


def estimate_query(
    query: str,
    sample: LabeledGraph,
    total_edges: int | None = None,
    model: estimation.GilbertModel | estimation.BayesianModel | None = None,
    model_kind: str = "bayesian",
    n_rollouts: int = 2000,
    seed: int = 0,
) -> PlanEstimates:
    """§5.2.2 point estimates + §5.3 rollout distribution for ``query``.

    ``model`` accepts a prefit statistical model (from :func:`fit_model`)
    so a serving loop does not re-fit per request."""
    ast = rx.parse(query)
    ca = paa.compile_query(query, sample)
    total_edges = total_edges if total_edges is not None else sample.n_edges

    q_lbl = float(len(rx.labels_of(ast)))
    lmap = sample.label_to_id
    label_ids = {lmap[l] for l in rx.labels_of(ast) if l in lmap}
    wildcard = rx.has_wildcard(ast)
    d_s1 = estimation.estimate_d_s1(sample, label_ids, total_edges, wildcard)

    if model is None:
        model = fit_model(sample, model_kind)
    rollouts = estimation.estimate_distribution(ca, model, n_rollouts, seed=seed)
    return PlanEstimates(
        query=query,
        q_lbl=q_lbl,
        d_s1=d_s1,
        q_bc_samples=np.array([r.q_bc for r in rollouts], float),
        d_s2_samples=np.array([r.d_s2 for r in rollouts], float),
        wildcard=wildcard,
        query_class=classify_query(ast),
    )


def calibrated_samples(
    est: PlanEstimates,
    d_s1_scale: float = 1.0,
    q_bc_scale: float = 1.0,
    d_s2_scale: float = 1.0,
) -> tuple[float, np.ndarray, np.ndarray]:
    """Apply calibration factors and the §6 D_s1 bound; returns
    (d_s1, q_bc, d_s2) with zero-Q_bc rollouts filtered out."""
    d_s1 = est.d_s1 * d_s1_scale
    q_bc = est.q_bc_samples * q_bc_scale
    d_s2 = np.minimum(est.d_s2_samples * d_s2_scale, d_s1)  # §6: bounded by D_s1
    nz = q_bc > 0
    if nz.any():
        q_bc, d_s2 = q_bc[nz], d_s2[nz]
    return d_s1, q_bc, d_s2


def decide_strategy(
    est: PlanEstimates,
    net_params: NetworkParams,
    quantiles: tuple[float, ...] = (0.5, 0.9),
    decision_quantile: float = 0.9,
    d_s1_scale: float = 1.0,
    q_bc_scale: float = 1.0,
    d_s2_scale: float = 1.0,
) -> QueryPlan:
    """The cheap half of planning: evaluate the discriminant on (possibly
    calibrated) estimates and produce the strategy decision.

    The ``*_scale`` factors are the serve layer's cost-feedback
    recalibration (observed / forecast ratios per label class) — the
    paper's §5 estimation loop closed online.  Scales of 1.0 reproduce
    the paper's one-shot §6 workflow exactly."""
    q_lbl = est.q_lbl
    d_s1, q_bc_nz, d_s2_nz = calibrated_samples(est, d_s1_scale, q_bc_scale, d_s2_scale)
    qq = {q: float(np.quantile(q_bc_nz, q)) for q in quantiles}
    dq = {q: float(np.quantile(d_s2_nz, q)) for q in quantiles}

    # per-rollout Eq.-3 evaluation → probability that S2 is optimal
    kd = net_params.replication_rate / net_params.mean_degree
    wins = 0
    for qb, ds in zip(q_bc_nz, d_s2_nz):
        disc = cost_model.discriminant(q_lbl, d_s1, qb, ds)
        if kd > disc:  # Eq. 3 (see cost_model): S2 optimal iff k/d > discr
            wins += 1
    p_s2 = wins / max(len(q_bc_nz), 1)

    s1c = StrategyCost("S1", q_lbl, d_s1)
    s2c = StrategyCost("S2", qq[decision_quantile], dq[decision_quantile])
    choice = cost_model.choose_strategy(net_params, s1c, s2c)

    forecast = {
        "S1": cost_model.cost_of(net_params, s1c),
        "S2": cost_model.cost_of(net_params, s2c),
    }
    # cost cap: stop S2 once it has expanded 4× the decision-quantile estimate
    cap = int(4 * max(qq[decision_quantile], 1.0))
    return QueryPlan(
        query=est.query,
        choice=choice,
        net=net_params,
        q_lbl=q_lbl,
        d_s1_est=d_s1,
        q_bc_quantiles=qq,
        d_s2_quantiles=dq,
        p_s2_optimal=p_s2,
        s2_cost_cap=cap,
        forecast_symbols=forecast,
        decision_quantile=decision_quantile,
        query_class=est.query_class,
    )


def forecast_cost(plan: QueryPlan, strategy: str | None = None) -> float:
    """The plan's network-symbol forecast for ``strategy`` (default: the
    plan's own choice) — the serve layer's admission and batching-window
    sizing signal.

    This is the §4 cost model's *expected traffic* for the request, in
    symbols, already at the decision quantile and with any calibration
    scales the caller applied in :func:`decide_strategy`.  An async
    batcher converts it to seconds with an observed secs-per-symbol EWMA
    (``repro``'s ``serve/aio.py``, ROADMAP A11): expensive S2 fixpoints
    get a window that amortizes, cheap S1 streams flush almost
    immediately."""
    s = strategy or plan.choice.strategy
    if s not in plan.forecast_symbols:
        s = plan.choice.strategy
    return float(plan.forecast_symbols[s])


def plan_query(
    query: str,
    sample: LabeledGraph,
    net_params: NetworkParams,
    total_edges: int | None = None,
    model_kind: str = "bayesian",
    n_rollouts: int = 2000,
    quantiles: tuple[float, ...] = (0.5, 0.9),
    decision_quantile: float = 0.9,
    seed: int = 0,
    model: estimation.GilbertModel | estimation.BayesianModel | None = None,
    d_s1_scale: float = 1.0,
    q_bc_scale: float = 1.0,
    d_s2_scale: float = 1.0,
) -> QueryPlan:
    """Produce a strategy decision for ``query`` using only local data.

    ``sample`` is the planner's local subset of the graph (Alice's own
    data in §6); ``total_edges`` defaults to scaling the sample by 1
    (sample == full stats) and should be the |E| estimate from the
    broadcast count probe when available.

    One-shot convenience wrapper over :func:`estimate_query` +
    :func:`decide_strategy`; serving paths call those directly so the
    rollout distribution is computed once per query class."""
    est = estimate_query(
        query, sample, total_edges, model=model, model_kind=model_kind,
        n_rollouts=n_rollouts, seed=seed,
    )
    return decide_strategy(
        est, net_params, quantiles, decision_quantile,
        d_s1_scale=d_s1_scale, q_bc_scale=q_bc_scale, d_s2_scale=d_s2_scale,
    )


# ---------------------------------------------------------------------------
# Framework reuse of the discriminant rule (DESIGN.md §5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    mode: str  # "replicate" (S1-like) | "shard" (S2-like demand-driven)
    reason: str


def embedding_placement(
    table_rows: int,
    embed_dim: int,
    batch_lookups: int,
    n_devices: int,
    replicate_budget_bytes: int = 2 << 30,
) -> PlacementDecision:
    """Replicate-vs-shard for a recsys embedding table, phrased as the
    paper's trade-off: replicating is S1 (pay full data movement once per
    refresh, lookups free/local); sharding is S2 (pay per-lookup all-to-all
    for exactly the rows needed).

    Broadcast-side ≈ table bytes to every device; demand-side ≈ per-step
    gathered rows.  Small tables replicate; big tables shard."""
    table_bytes = table_rows * embed_dim * 4
    lookup_bytes = batch_lookups * embed_dim * 4
    if table_bytes <= replicate_budget_bytes // max(n_devices, 1) or table_bytes <= 4 * lookup_bytes:
        return PlacementDecision("replicate", f"table {table_bytes}B within replicate budget")
    return PlacementDecision("shard", f"table {table_bytes}B ≫ per-step demand {lookup_bytes}B")


def gnn_halo_strategy(
    n_layers: int,
    avg_degree: float,
    batch_nodes: int,
    n_nodes: int,
    net_params: NetworkParams,
) -> PlacementDecision:
    """S1-vs-S2 for distributed GNN feature retrieval on arbitrarily
    partitioned edges: the L-hop neighborhood is the query, Q_bc grows as
    the frontier (≈ batch·deg^L), D_s1 is the full feature set."""
    frontier = batch_nodes * (avg_degree ** n_layers)
    d_s1 = float(n_nodes)
    d_s2 = min(float(frontier), d_s1)
    q_lbl, q_bc = 1.0, float(n_layers * batch_nodes)
    disc = cost_model.discriminant(q_lbl, d_s1, q_bc, d_s2)
    kd = net_params.replication_rate / net_params.mean_degree
    if kd > disc:
        return PlacementDecision("shard", f"k/d={kd:.3f} > discr={disc:.3f}: demand-driven halo (S2)")
    return PlacementDecision("replicate", f"k/d={kd:.3f} <= discr={disc:.3f}: gather-all features (S1)")
