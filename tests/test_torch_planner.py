"""The port's planning layer against ``repro``'s: the overlay and its
probes, the cost model (Eqs. 1–3), the fitted statistical models, the
§5.3 rollouts, the plan estimates and plans, the query classes, and the
framework reuses of the discriminant rule.

Everything here but ``branching_tail`` is the same host Python and numpy
in both packages, drawing the same random stream from the same seed, so
it is compared for exact equality.  ``branching_tail`` draws its Poisson
children from torch's generator where ``repro`` draws from JAX's, so its
samples are held to ``repro``'s in distribution: each mean within 5
standard errors of the difference of the two means, over 4096 rollouts
and two seeds."""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from repro.core import cost_model as r_cost
from repro.core import estimation as r_est
from repro.core import paa as r_paa
from repro.core import planner as r_plan
from repro.core import strategies as r_st
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.graph import structure as r_struct

from repro_torch import interop
from repro_torch.core import cost_model, estimation, paa, planner, strategies
from repro_torch.core import regex as rx
from repro_torch.graph import generators, partition, structure

torch.set_num_threads(1)


def _graphs(name):
    """The same graph from each package."""
    if name == "example":
        return r_struct.example_graph(), structure.example_graph()
    if name == "random":
        return (r_gen.random_labeled_graph(300, 1500, 5, seed=4),
                generators.random_labeled_graph(300, 1500, 5, seed=4))
    probs = {"a": 3e-4, "b": 1e-4}
    return r_gen.gilbert_graph(400, probs, seed=1), generators.gilbert_graph(400, probs, seed=1)


def _same(a, b):
    """Two dataclasses, or tuples of them, are equal field by field (numpy
    fields exactly, with their dtypes)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    else:
        assert type(a) is type(b) and a == b, (a, b)


# ---------------------------------------------------------------------------
# the overlay network and its §5.2.1 probes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_peers, degree, seed", [(60, 3.0, 4), (150, 3.0, 0), (40, 1.0, 6), (7, 2.5, 1)])
def test_overlay_and_network_params(n_peers, degree, seed):
    ro, to = r_part.random_overlay(n_peers, degree, seed), partition.random_overlay(n_peers, degree, seed)
    _same(ro, to)
    assert (to.n_connections, to.mean_degree, to.broadcast_message_cost(5)) == (
        ro.n_connections, ro.mean_degree, ro.broadcast_message_cost(5))
    assert (to.probe_ping(), to.probe_connection_count()) == (ro.probe_ping(), ro.probe_connection_count())
    rg, tg = _graphs("random")
    rpl = r_part.distribute(rg, n_peers, replication_rate=0.15, seed=seed)
    tpl = partition.distribute(tg, n_peers, replication_rate=0.15, seed=seed)
    assert to.probe_replication(tpl, 32, seed) == ro.probe_replication(rpl, 32, seed)
    rp, tp = r_plan.probe_network(ro, rpl, seed=seed), planner.probe_network(to, tpl, seed=seed)
    assert dataclasses.astuple(rp) == dataclasses.astuple(tp)
    # repro's overlay and placement, carried across, probe the same
    carried = interop.overlay_from_numpy(ro.n_peers, ro.adj_src, ro.adj_dst)
    cpl = interop.placement_from_numpy(tg, rpl.n_sites, rpl.site_edges, rpl.replication)
    assert planner.probe_network(carried, cpl, seed=seed) == tp


# ---------------------------------------------------------------------------
# the cost model, Eqs. 1–3 (tests/test_estimation_and_planner.py's cases)
# ---------------------------------------------------------------------------

DISCRIMINANTS = [(5, 100, 4, 50), (5, 50, 50, 50), (18, 1800, 70, 15), (3, 10, 3, 20), (1, 5, 9, 5)]


@pytest.mark.parametrize("args", DISCRIMINANTS)
def test_discriminant(args):
    got, want = cost_model.discriminant(*args), r_cost.discriminant(*args)
    assert got == want
    if args[2] <= args[0]:
        assert got == -math.inf
    elif args[1] <= args[3]:
        assert got == math.inf


@pytest.mark.parametrize("n_peers, n_conn, k", [(100, 300, 0.2), (100, 300, 1.5), (100, 50, 0.2), (10, 10, 0.99)])
def test_network_params_validation(n_peers, n_conn, k):
    r_net, t_net = r_cost.NetworkParams(n_peers, n_conn, k), cost_model.NetworkParams(n_peers, n_conn, k)
    assert t_net.mean_degree == r_net.mean_degree
    try:
        r_net.validate()
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            t_net.validate()
    else:
        t_net.validate()


def _random_case(rng):
    q_lbl = rng.integers(1, 20)
    d_s1 = rng.integers(1, 5000)
    q_bc = rng.integers(0, 300)
    d_s2 = rng.integers(0, int(d_s1) + 1)
    k = rng.uniform(0.01, 0.95)
    d = rng.uniform(1.05, 8.0)
    return q_lbl, d_s1, q_bc, d_s2, k, d


# the draws of test_eq3_consistency_with_direct_costs, four blocks of 50,
# plus the paper's §6 worked example and the three special cases
CHOICE_CASES = [("eq3", b) for b in range(4)] + [
    ("fixed", (18, 1800, 70, 15, 0.2, 3.0)),
    ("fixed", (5, 100, 4, 50, 0.2, 3.0)),
    ("fixed", (5, 50, 50, 50, 0.2, 3.0)),
    ("fixed", (2, 40, 90, 10, 0.5, 1.5)),
]


@pytest.mark.parametrize("kind, case", CHOICE_CASES)
def test_costs_and_choose_strategy(kind, case):
    if kind == "eq3":
        rng = np.random.default_rng(0)
        draws = [_random_case(rng) for _ in range(200)][50 * case : 50 * (case + 1)]
    else:
        draws = [case]
    for q_lbl, d_s1, q_bc, d_s2, k, d in draws:
        r_net = r_cost.NetworkParams(100, int(100 * d), k)
        t_net = cost_model.NetworkParams(100, int(100 * d), k)
        assert cost_model.cost_s1(t_net, q_lbl, d_s1) == r_cost.cost_s1(r_net, q_lbl, d_s1)
        assert cost_model.cost_s2(t_net, q_bc, d_s2) == r_cost.cost_s2(r_net, q_bc, d_s2)
        r_c = r_cost.choose_strategy(
            r_net, r_st.StrategyCost("S1", q_lbl, d_s1), r_st.StrategyCost("S2", q_bc, d_s2))
        t_c = cost_model.choose_strategy(
            t_net, strategies.StrategyCost("S1", q_lbl, d_s1), strategies.StrategyCost("S2", q_bc, d_s2))
        assert dataclasses.astuple(t_c) == dataclasses.astuple(r_c)
        for sites in ((), (3.0, 4.5, 0.0)):
            r_sc = r_st.StrategyCost("S2", q_bc, d_s2, site_unicast_symbols=sites)
            t_sc = strategies.StrategyCost("S2", q_bc, d_s2, site_unicast_symbols=sites)
            assert cost_model.cost_of(t_net, t_sc) == r_cost.cost_of(r_net, r_sc)


@pytest.mark.parametrize("args", DISCRIMINANTS[2:])
def test_optimality_region(args):
    assert cost_model.optimality_region(*args, grid=12) == r_cost.optimality_region(*args, grid=12)


# ---------------------------------------------------------------------------
# the §5.3 statistical models, their rollouts and the §5.2.2 point estimate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("graph", ["example", "random", "gilbert"])
def test_fitted_models(graph, fraction):
    rg, tg = _graphs(graph)
    rgm, tgm = r_est.GilbertModel.fit(rg, fraction, seed=3), estimation.GilbertModel.fit(tg, fraction, seed=3)
    rbm, tbm = r_est.BayesianModel.fit(rg, fraction, seed=3), estimation.BayesianModel.fit(tg, fraction, seed=3)
    _same(rgm, tgm)
    _same(rbm, tbm)
    _same(interop.gilbert_from_numpy(rgm.n_nodes, rgm.lam, rgm.lam_in), tgm)
    _same(interop.bayesian_from_numpy(
        rbm.n_nodes, rbm.lam0, rbm.lam_cond, rbm.lam0_in, rbm.lam_cond_in), tbm)
    for lid in range(tg.n_labels):
        for via in (None, *range(tg.n_labels)):
            assert tbm.out_rate(lid, via) == rbm.out_rate(lid, via)
            assert tbm.in_rate(lid, via) == rbm.in_rate(lid, via)
            assert tgm.out_rate(lid, via) == rgm.out_rate(lid, via)
    rs = r_est._maybe_sample(rg, fraction, 3)
    ts = estimation._maybe_sample(tg, fraction, 3)
    _same((rs.src, rs.lbl, rs.dst), (ts.src, ts.lbl, ts.dst))
    ids = {0, 2}
    for wildcard in (False, True):
        assert estimation.estimate_d_s1(ts, ids, tg.n_edges * 3, wildcard) == r_est.estimate_d_s1(
            rs, ids, rg.n_edges * 3, wildcard)


ROLLOUTS = [
    ("example", "a b", "gilbert", 4000),
    ("example", "a* b^-1", "bayesian", 4000),
    ("example", "(a|b)+ c", "bayesian", 5),
    ("random", "l0 l1* l2", "bayesian", 4000),
    ("random", "(l0|l3)+ . l1^-1", "gilbert", 60),
    ("gilbert", "a b* a^-1", "bayesian", 4000),
]


@pytest.mark.parametrize("graph, expr, kind, max_pops", ROLLOUTS)
def test_rollouts_equal_repro(graph, expr, kind, max_pops):
    rg, tg = _graphs(graph)
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    rm, tm = r_plan.fit_model(rg, kind), planner.fit_model(tg, kind)
    want = r_est.estimate_distribution(rca, rm, 200, seed=5, max_pops=max_pops)
    got = estimation.estimate_distribution(tca, tm, 200, seed=5, max_pops=max_pops)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    if max_pops < 100:
        assert any(r.capped for r in got)
    # repro's fitted model, carried across, rolls out the same
    if kind == "bayesian":
        carried = interop.bayesian_from_numpy(rm.n_nodes, rm.lam0, rm.lam_cond, rm.lam0_in, rm.lam_cond_in)
        again = estimation.estimate_distribution(tca, carried, 200, seed=5, max_pops=max_pops)
        assert [dataclasses.astuple(r) for r in again] == [dataclasses.astuple(r) for r in want]


# (graph, query, subcritical): repro's test relation to the BFS rollouts
# holds where the branching process dies out, on the example graph; on
# the random graph "l0 l1*" grows, and the BFS rollouts' dedup and pop
# cap keep them far below the no-dedup bound
BRANCHING = [("example", "a b", True), ("example", "a* b^-1", True), ("random", "l0 l1* l2", False)]


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("graph, expr, subcritical", BRANCHING)
def test_branching_tail_matches_repro_in_distribution(graph, expr, subcritical, seed):
    """Each mean within 5 standard errors of the difference of the two
    means (4096 rollouts each); where subcritical, repro's own test
    relation to the BFS rollouts: >= 0.8x and <= 3x + 1 of their mean
    D_s2; else at least 0.8x, the no-dedup bound."""
    rg, tg = _graphs(graph)
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    rgm, tgm = r_est.GilbertModel.fit(rg), estimation.GilbertModel.fit(tg)
    n = 4096
    rq, rd = r_est.branching_tail(rca, rgm, n_rollouts=n, seed=seed)
    tq, td = estimation.branching_tail(tca, tgm, n_rollouts=n, seed=seed, device="cpu")
    assert tq.shape == td.shape == (n,) and tq.dtype == td.dtype == np.float32
    for name, r, t in (("q_bc", rq, tq), ("d_s2", rd, td)):
        se = math.sqrt(r.var() / n + t.var() / n)
        assert abs(float(t.mean()) - float(r.mean())) <= 5 * se + 1e-6, (name, t.mean(), r.mean(), se)
    rolls = estimation.estimate_distribution(tca, tgm, 3000, seed=seed)
    m_bfs = np.mean([r.d_s2 for r in rolls])
    assert td.mean() >= m_bfs * 0.8
    if subcritical:
        assert td.mean() <= m_bfs * 3.0 + 1.0


def test_branching_tail_runs_exactly_max_levels():
    """At max_levels 1 only the start state's first broadcast and its
    children count: Q_bc is the start state's payload in every rollout."""
    g = structure.example_graph()
    ca = paa.compile_query("a b", g)
    gm = estimation.GilbertModel.fit(g)
    q, d = estimation.branching_tail(ca, gm, n_rollouts=64, seed=0, max_levels=1, device="cpu")
    assert (q == 2.0).all() and (d % 3 == 0).all()
    q0, d0 = estimation.branching_tail(ca, gm, n_rollouts=64, seed=0, max_levels=0, device="cpu")
    assert not q0.any() and not d0.any()


# ---------------------------------------------------------------------------
# plans on the 8,000-node Alibaba twin (smaller sizes of alibaba_like emit
# node ids past n_nodes, ROADMAP §C)
# ---------------------------------------------------------------------------

# both choices and all three reasons, and a bounded class (q11)
PLAN_QUERIES = ["q1", "q6", "q7", "q9", "q10", "q11"]


@pytest.fixture(scope="module")
def twin():
    rg = r_gen.alibaba_like(n_nodes=8000, n_edges=40000, seed=0)
    tg = generators.alibaba_like(n_nodes=8000, n_edges=40000, seed=0)
    ro, to = r_part.random_overlay(40, 3.0, seed=6), partition.random_overlay(40, 3.0, seed=6)
    rpl = r_part.distribute(rg, 40, replication_rate=0.2, seed=0)
    tpl = partition.distribute(tg, 40, replication_rate=0.2, seed=0)
    r_net, t_net = r_plan.probe_network(ro, rpl, seed=6), planner.probe_network(to, tpl, seed=6)
    rm, tm = r_plan.fit_model(rg), planner.fit_model(tg)
    plans = {}
    for q in PLAN_QUERIES:
        expr = r_gen.TABLE2_QUERIES[q]
        r_e = r_plan.estimate_query(expr, rg, model=rm, n_rollouts=30, seed=6)
        t_e = planner.estimate_query(expr, tg, model=tm, n_rollouts=30, seed=6)
        plans[q] = (r_e, t_e, r_plan.decide_strategy(r_e, r_net), planner.decide_strategy(t_e, t_net))
    return {"rg": rg, "tg": tg, "r_net": r_net, "t_net": t_net, "rm": rm, "tm": tm, "plans": plans}


def test_twin_network_and_model(twin):
    assert dataclasses.astuple(twin["t_net"]) == dataclasses.astuple(twin["r_net"])
    _same(twin["rm"], twin["tm"])


def _same_plan(r_plan_, t_plan_):
    for f in dataclasses.fields(r_plan_):
        a, b = getattr(r_plan_, f.name), getattr(t_plan_, f.name)
        if f.name in ("choice", "net", "query_class"):
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert dataclasses.astuple(a) == dataclasses.astuple(b), f.name
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("q", PLAN_QUERIES)
def test_plan_equals_repro(twin, q):
    r_e, t_e, r_p, t_p = twin["plans"][q]
    for f in ("query", "q_lbl", "d_s1", "wildcard"):
        assert getattr(t_e, f) == getattr(r_e, f), f
    _same((r_e.q_bc_samples, r_e.d_s2_samples), (t_e.q_bc_samples, t_e.d_s2_samples))
    assert dataclasses.astuple(t_e.query_class) == dataclasses.astuple(r_e.query_class)
    _same_plan(r_p, t_p)
    for s in (None, "S1", "S2", "S3"):
        assert planner.forecast_cost(t_p, s) == r_plan.forecast_cost(r_p, s)
    scales = {"d_s1_scale": 1.7, "q_bc_scale": 0.6, "d_s2_scale": 2.5}
    _same(planner.calibrated_samples(t_e, **scales), r_plan.calibrated_samples(r_e, **scales))
    _same_plan(r_plan.decide_strategy(r_e, twin["r_net"], (0.25, 0.5, 0.9), 0.5, **scales),
               planner.decide_strategy(t_e, twin["t_net"], (0.25, 0.5, 0.9), 0.5, **scales))
    # repro's estimates, carried across, decide the same plan
    qc = r_e.query_class
    carried = interop.estimates_from_numpy(
        r_e.query, r_e.q_lbl, r_e.d_s1, r_e.q_bc_samples, r_e.d_s2_samples, r_e.wildcard,
        (qc.kind, qc.atoms, qc.length))
    _same_plan(r_p, planner.decide_strategy(carried, twin["t_net"]))


def test_plans_cover_both_choices_all_reasons_and_a_bounded_class(twin):
    plans = [t_p for _, _, _, t_p in twin["plans"].values()]
    reasons = {p.choice.reason.split(":")[0].split(" (")[0] for p in plans}
    assert {p.choice.strategy for p in plans} == {"S1", "S2"}
    assert reasons == {"Q_bc <= Q_lbl", "discr > 1", "k/d > discr"}, reasons
    assert twin["plans"]["q11"][3].query_class == planner.QueryClass(
        "bounded", twin["plans"]["q11"][3].query_class.atoms, 2)


def test_plan_query_equals_repro(twin):
    expr = r_gen.TABLE2_QUERIES["q10"]
    want = r_plan.plan_query(expr, twin["rg"], twin["r_net"], n_rollouts=20, seed=2, model=twin["rm"],
                             quantiles=(0.5, 0.75, 0.9), decision_quantile=0.75)
    got = planner.plan_query(expr, twin["tg"], twin["t_net"], n_rollouts=20, seed=2, model=twin["tm"],
                             quantiles=(0.5, 0.75, 0.9), decision_quantile=0.75)
    _same_plan(want, got)


def test_plan_query_fits_its_own_model():
    rg, tg = _graphs("random")
    r_net = r_cost.NetworkParams(60, 180, 0.15)
    t_net = cost_model.NetworkParams(60, 180, 0.15)
    for kind in ("bayesian", "gilbert"):
        _same_plan(r_plan.plan_query("l0 l1* l2", rg, r_net, n_rollouts=100, seed=4, model_kind=kind),
                   planner.plan_query("l0 l1* l2", tg, t_net, n_rollouts=100, seed=4, model_kind=kind))


# ---------------------------------------------------------------------------
# query classes and their fast paths (tests/test_planner_adversarial.py)
# ---------------------------------------------------------------------------

CLASS_CASES = [
    "a", "a^-1", ".", "(a|b)", "a*", "(a|b)*", "(a^-1)*", "(.)*", "a b", "a . b",
    "a (b|c) a^-1", "a+", "a* b", "(a b)*", "(a*)*", "a|b*", "{a|b}*",
    # tests/test_planner_adversarial.py's alpha-renamings
    "(b|a)*", "(x|y)*", "c b a", "x y z", "q* r", "(a|b) c", "(p|q) r",
]


@pytest.mark.parametrize("expr", CLASS_CASES)
def test_classify_reduce_and_level_cap(expr):
    rg, tg = _graphs("example")
    rq, tq = r_plan.classify_query(expr), planner.classify_query(expr)
    assert dataclasses.astuple(tq) == dataclasses.astuple(rq)
    assert planner.classify_query(rx.parse(expr)) == tq
    assert planner.fast_path_max_levels(tq) == r_plan.fast_path_max_levels(rq)
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    rred, tred = r_plan.reduce_automaton(rca, rq), planner.reduce_automaton(tca, tq)
    assert (tred is tca) == (rred is rca)
    assert (tred.n_states, tred.start, tred.accepting, tred.n_labels) == (
        rred.n_states, rred.start, rred.accepting, rred.n_labels)
    assert [dataclasses.astuple(t) for t in tred.transitions] == [
        dataclasses.astuple(t) for t in rred.transitions]
    assert [dataclasses.astuple(t) for t in tred.nfa.transitions] == [
        dataclasses.astuple(t) for t in rred.nfa.transitions]


# ---------------------------------------------------------------------------
# the discriminant rule reused outside RPQs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows, dim, lookups, devices, budget", [
    (10_000, 128, 65536, 256, 2 << 30), (40_000_000, 128, 65536, 256, 2 << 30),
    (1_000_000, 64, 4096, 8, 2 << 30), (1_000_000, 64, 4096, 8, 1 << 20), (100, 8, 2, 1, 16),
])
def test_embedding_placement(rows, dim, lookups, devices, budget):
    want = r_plan.embedding_placement(rows, dim, lookups, devices, budget)
    got = planner.embedding_placement(rows, dim, lookups, devices, budget)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("layers, degree, batch, nodes, net", [
    (3, 15.0, 1024, 100_000, (100, 300, 0.2)), (1, 2.0, 8, 100_000, (100, 300, 0.2)),
    (2, 10.0, 512, 1_000, (50, 400, 0.9)), (1, 1.0, 1, 10, (10, 10, 0.1)),
])
def test_gnn_halo_strategy(layers, degree, batch, nodes, net):
    want = r_plan.gnn_halo_strategy(layers, degree, batch, nodes, r_cost.NetworkParams(*net))
    got = planner.gnn_halo_strategy(layers, degree, batch, nodes, cost_model.NetworkParams(*net))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
