"""The port's serving runtime against ``repro``'s: the same seeded stream
through both ``QueryService``s gives, request for request, the same
answers, strategy, plan-cache hit, executor batch size and observed
costs, the same calibration factors and the same summary (keys,
recursively, and counters); the workload generator, query normalization,
batcher and signatures agree; and the admission, failure and flush rules
of ``tests/test_serve.py`` hold in the port.  ``repro`` runs its fused
kernels in interpret mode on a (1, 1) mesh.  Everything compared is
exact, except latencies, which are compared by key only."""

import dataclasses
import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.core.cost_model import NetworkParams as RNet
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.graph import workloads as r_wl
from repro.serve import QueryService as RService
from repro.serve import ServeConfig as RConfig
from repro.serve import batcher as r_batcher
from repro.serve import feedback as r_feedback
from repro.serve import metrics as r_metrics
from repro.serve import plancache as r_plancache

from repro_torch.core import paa, planner, witness
from repro_torch.core.cost_model import NetworkParams
from repro_torch.graph import generators, partition, structure, workloads
from repro_torch.serve import (
    QueryService,
    ServeConfig,
    ServiceOverloaded,
    automaton_signature,
    batcher,
    canonical_key,
)
from repro_torch.serve import metrics, plancache

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NET = (150, 450, 0.2)
PAIRS = [
    ("frontier_kernel", "f32"),
    ("frontier_kernel", "uint32"),
    ("frontier_kernel_packed", "f32"),
    ("frontier_kernel_packed", "uint32"),
]


def _twins(n_nodes=100, n_edges=400, n_labels=4, seed=3):
    rg = r_gen.random_labeled_graph(n_nodes, n_edges, n_labels, seed=seed)
    tg = generators.random_labeled_graph(n_nodes, n_edges, n_labels, seed=seed)
    rp = r_part.distribute(rg, n_sites=4, replication_rate=0.3, seed=1)
    tp = partition.distribute(tg, n_sites=4, replication_rate=0.3, seed=1)
    return rg, tg, rp, tp


def _services(backend="frontier_kernel", tile_dtype="f32", twins=None, **kw):
    rg, tg, rp, tp = twins or _twins()
    cfg = dict(n_rollouts=40, seed=0, s2_backend=backend, s2_block_size=8, s2_tile_dtype=tile_dtype, **kw)
    r = RService(rp, compat.make_mesh((1, 1), ("data", "model")), RNet(*NET), config=RConfig(**cfg))
    t = QueryService(tp, NetworkParams(*NET), config=ServeConfig(**cfg), device="cpu")
    return r, t


@pytest.fixture(scope="module")
def setup():
    g = structure.example_graph()
    placement = partition.distribute(g, n_sites=4, replication_rate=0.4, seed=1)
    return g, placement


def _svc(setup, **kw):
    _, placement = setup
    cfg = dict(n_rollouts=50, s2_backend="frontier_kernel", s2_block_size=8, **kw)
    return QueryService(placement, NetworkParams(*NET), config=ServeConfig(**cfg), device="cpu")


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def _repro_schema():
    """``repro``'s summary of a service before any request, as keys."""
    return _keys(r_metrics.ServiceMetrics().summary(extra={
        "plan_cache": r_plancache.PlanCache().stats(),
        "calibration": r_feedback.Calibrator().summary(),
        "stats_epoch": 0,
    }))


# ---------------------------------------------------------------------------
# the stream, request for request
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wc", [
    dict(n_queries=40, seed=0),
    dict(n_queries=30, hot_pool=3, hot_fraction=0.5, wildcard_prob=0.3, closure_prob=0.4, seed=9),
    dict(n_queries=20, min_len=1, max_len=6, union_prob=0.6, min_starts=3, max_starts=3, seed=4),
])
def test_workload_stream_equals_repro(wc):
    rg, tg, _, _ = _twins(n_labels=6)
    want = r_wl.generate(rg, r_wl.WorkloadConfig(**wc))
    got = workloads.generate(tg, workloads.WorkloadConfig(**wc))
    assert len(got) == len(want) == wc["n_queries"]
    for a, b in zip(want, got, strict=True):
        assert (a.query, a.hot) == (b.query, b.hot)
        assert a.starts.dtype == b.starts.dtype and np.array_equal(a.starts, b.starts)


def _run_stream(svc, stream):
    """Half the stream planner-decided, then S2 and S1 forced by turns, in
    two windows; returns the tickets."""
    half = len(stream) // 2
    tickets = [svc.enqueue(q.query, q.starts) for q in stream[:half]]
    svc.flush()
    tickets += [
        svc.enqueue(q.query, q.starts, strategy=("S2", "S1")[i % 2])
        for i, q in enumerate(stream[half:])
    ]
    svc.flush()
    return tickets


@pytest.mark.parametrize("backend, tile_dtype", PAIRS)
def test_mixed_stream_equals_repro(backend, tile_dtype):
    twins = _twins()
    rg, tg = twins[0], twins[1]
    r_svc, t_svc = _services(backend, tile_dtype, twins)
    wc = dict(n_queries=24, hot_pool=4, max_starts=6, seed=0)
    r_tickets = _run_stream(r_svc, r_wl.generate(rg, r_wl.WorkloadConfig(**wc)))
    t_tickets = _run_stream(t_svc, workloads.generate(tg, workloads.WorkloadConfig(**wc)))
    dg = structure.to_device_graph(tg, "cpu")
    for rt, tt in zip(r_tickets, t_tickets, strict=True):
        a, b = rt.result(), tt.result()
        assert (b.query, b.strategy, b.plan_cache_hit, b.semantics) == (
            a.query, a.strategy, a.plan_cache_hit, a.semantics)
        assert b.answers == a.answers, b.query
        assert [dataclasses.astuple(c) for c in b.observed] == [
            dataclasses.astuple(c) for c in a.observed], b.query
        assert (b.plan.choice.strategy, b.plan.p_s2_optimal) == (a.plan.choice.strategy, a.plan.p_s2_optimal)
        assert tt.sig == plancache.Signature(*(
            f for i, f in enumerate(rt.sig) if i not in (5, 6, 7)))
        assert tt.forecast_symbols == rt.forecast_symbols
        ca = paa.compile_query(b.query, tg)
        for s, ans in zip(b.starts, b.answers):
            assert ans == set(np.nonzero(paa.answers_single_source(ca, dg, int(s)).numpy())[0].tolist())
    strategies_seen = {t.result().strategy for t in t_tickets}
    assert strategies_seen == {"S1", "S2"}
    rec = lambda svc: [  # noqa: E731
        (r.query, r.strategy, r.n_starts, r.broadcast_symbols, r.unicast_symbols,
         r.plan_cache_hit, r.exec_batch_size, r.semantics) for r in svc.metrics.records]
    assert rec(t_svc) == rec(r_svc)
    assert t_svc.calibrator.summary() == r_svc.calibrator.summary()
    want, got = r_svc.summary(), t_svc.summary()
    assert _keys(got) == _keys(want)
    for k in ("n_queries", "plan_cache_hit_rate", "total_broadcast_symbols",
              "total_unicast_symbols", "strategies", "exec_cache", "plan_store",
              "plan_pad_waste", "frontier_mem", "aio", "plan_cache", "calibration",
              "stats_epoch"):
        assert got[k] == want[k], k


def test_witness_stream_equals_repro_and_walks_back():
    """Witness requests on both strategies: levels bit-exact to ``repro``'s
    and every reconstructed path valid on the label store."""
    twins = _twins()
    tg = twins[1]
    r_svc, t_svc = _services("frontier_kernel_packed", "uint32", twins)
    reqs = [("l0 (l1|l2)* l3", [0, 4, 9], "S2"), ("(l2|l3)+", [1, 5], "S1"),
            ("l1 . l0", [2, 3, 7], "S2"), ("l0 (l1|l2)* l3", [8], None)]
    for q, starts, st in reqs:
        a = r_svc.submit(q, starts, strategy=st, semantics="witness")
        b = t_svc.submit(q, starts, strategy=st, semantics="witness")
        assert b.answers == a.answers and b.strategy == a.strategy
        assert b.levels.dtype == np.float32 and b.levels.tobytes() == np.asarray(a.levels).tobytes()
        for i, targets in enumerate(b.answers):
            for t in sorted(targets)[:3]:
                path = t_svc.witness_path(b, i, t)
                ok, why = witness.validate_witness(path, tg)
                assert ok, why
                assert witness.nfa_accepts_symbols(b.exec_ca, path.steps)
                assert (path.nodes[0], path.nodes[-1]) == (int(b.starts[i]), t)
    assert t_svc.summary()["exec_cache"] == r_svc.summary()["exec_cache"]
    pairs = t_svc.submit("l0 l1", [0])
    with pytest.raises(ValueError, match="witness"):
        t_svc.witness_path(pairs, 0, 1)


def test_refresh_stats_drops_executors_and_stage_a_like_repro():
    twins = _twins()
    rg, tg = twins[0], twins[1]
    r_svc, t_svc = _services(twins=twins)
    for svc, g in ((r_svc, rg), (t_svc, tg)):
        assert not svc.submit("l0 l1*", [0, 3], strategy="S2").plan_cache_hit
        assert svc.submit("l0 l1*", [5], strategy="S2").plan_cache_hit
        svc.refresh_stats(g)
        assert svc.stats_epoch == 1
        assert not svc.submit("l0 l1*", [0], strategy="S2").plan_cache_hit
    assert t_svc.exec_cache.stats() == r_svc.exec_cache.stats()
    assert t_svc.plan_store.stats() == r_svc.plan_store.stats()
    assert t_svc.exec_cache.releases == 1


# ---------------------------------------------------------------------------
# keys, batcher, signatures
# ---------------------------------------------------------------------------


QUERIES = ["(a|b)+", "(b|a)+", "{a,b}+", "{b|a}+", "a  b", "a b", "(a|a|b)", "{a,b}", "{a}",
           "a", "(a|b) c", "(a|b) d", "a^-1", "a*", "a+", "(a b|c)? .", "((a|b)|(c d))*",
           "a^-1 (b|c^-1)+ .", "(c|b|a) (a|c)", "{b,a,b}^-1"]


def test_canonical_key_equals_repro():
    for q in QUERIES:
        assert canonical_key(q) == r_plancache.canonical_key(q), q
    k = canonical_key
    assert k("(a|b)+") == k("(b|a)+") == k("{a,b}+") == k("{b|a}+")
    assert k("a*") != k("a+") and k("a^-1") != k("a")


class _Item:
    def __init__(self, mask):
        self.label_mask = np.array(mask, bool)


@pytest.mark.parametrize("weighted", [False, True])
def test_batcher_equals_repro_on_random_inputs(weighted):
    rng = np.random.default_rng(11 + weighted)
    for trial in range(60):
        n_labels = int(rng.integers(4, 24))
        budget = int(rng.integers(1, n_labels + 2))
        weights = rng.pareto(1.5, n_labels) + 0.1 if weighted else None
        items = [_Item(rng.random(n_labels) < rng.uniform(0.05, 0.6))
                 for _ in range(int(rng.integers(1, 14)))]
        pos = {id(it): i for i, it in enumerate(items)}
        ids = lambda groups: [[pos[id(it)] for it in g] for g in groups]  # noqa: E731
        for name in ("coalesce_s1", "_coalesce_ffd", "_coalesce_greedy"):
            assert ids(getattr(batcher, name)(items, budget, weights)) == ids(
                getattr(r_batcher, name)(items, budget, weights)), (trial, name)
        assert np.array_equal(batcher.union_mask(items), r_batcher.union_mask(items))
        n, m, cap = int(rng.integers(0, 600)), int(rng.choice([1, 3, 8, 256])), int(rng.integers(1, 300))
        assert batcher.bucket_size(n, m, cap) == r_batcher.bucket_size(n, m, cap)
        assert batcher.lane_fill_target(cap, m) == r_batcher.lane_fill_target(cap, m)
        starts = rng.integers(0, 50, int(rng.integers(0, 9))).astype(np.int32)
        size = int(rng.integers(1, 12))
        assert np.array_equal(batcher.pad_starts(starts, size), r_batcher.pad_starts(starts, size))


def test_run_s2_group_equals_repro():
    class Req:
        def __init__(self, starts):
            self.starts = np.asarray(starts, np.int32)

    def execute(starts, _):
        n = len(starts)
        return np.arange(n * 3).reshape(n, 3) % 2 == 0, [int(s) for s in starts], np.ones((n, 2, 3))

    group = [Req([1, 2, 3]), Req([]), Req([7] * 11), Req([4, 5])]
    got = batcher.run_s2_group(group, execute, max_batch=8, multiple=4)
    want = r_batcher.run_s2_group(group, execute, max_batch=8, multiple=4)
    for req in group:
        (a, ca, ba, la), (b, cb, bb, lb) = want[id(req)], got[id(req)]
        assert np.array_equal(a, b) and ca == cb and ba == bb and np.array_equal(la, lb)


def test_signature_tells_apart_every_field():
    g = structure.example_graph()
    ca = paa.compile_query("a* b", g)
    base = automaton_signature(ca, g.n_nodes, None, "frontier_kernel", 8, "pairs", "f32")
    assert base == automaton_signature(paa.compile_query("a* b", g), g.n_nodes, None,
                                       "frontier_kernel", 8, "pairs", "f32")
    reduced = planner.reduce_automaton(paa.compile_query("(a|b)*", g),
                                       planner.classify_query("(a|b)*"))
    variants = [
        automaton_signature(ca, g.n_nodes, None, "frontier_kernel", 8, "witness", "f32"),
        automaton_signature(ca, g.n_nodes, None, "frontier_kernel", 8, "pairs", "uint32"),
        automaton_signature(ca, g.n_nodes, None, "frontier_kernel", 16, "pairs", "f32"),
        automaton_signature(ca, g.n_nodes, None, "frontier_kernel_packed", 8, "pairs", "f32"),
        automaton_signature(ca, g.n_nodes, 3, "frontier_kernel", 8, "pairs", "f32"),
        automaton_signature(paa.compile_query("a* c", g), g.n_nodes, None, "frontier_kernel", 8,
                            "pairs", "f32"),
        automaton_signature(paa.compile_query("(a|b)*", g), g.n_nodes, None, "frontier_kernel",
                            8, "pairs", "f32"),
        automaton_signature(reduced, g.n_nodes, None, "frontier_kernel", 8, "pairs", "f32"),
    ]
    assert len({base, *variants}) == len(variants) + 1
    assert variants[0].semantics == "witness" and variants[-1].n_states == 1


def test_frontier_mem_stats_equals_repro():
    rg, tg = r_gen.random_labeled_graph(70, 260, 3, seed=2), generators.random_labeled_graph(70, 260, 3, seed=2)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    r_cache = r_plancache.ExecutorCache(8)
    t_cache = plancache.ExecutorCache(8, plan_store=plancache.plans_mod.GraphPlanStore(device="cpu"))
    for expr, backend, td in (("l0 l1", "frontier_kernel", "f32"),
                              ("l2+", "frontier_kernel_packed", "uint32"),
                              ("l0 . l2", "frontier_kernel", "uint32")):
        r_cache.get_or_build(r_paa.compile_query(expr, rg), rg.n_nodes, mesh, backend=backend,
                             graph=rg, block_size=16, tile_dtype=td)
        t_cache.get_or_build(paa.compile_query(expr, tg), tg.n_nodes, backend=backend, graph=tg,
                             block_size=16, tile_dtype=td)
    assert t_cache.frontier_mem_stats() == r_cache.frontier_mem_stats()
    assert t_cache.stats() == r_cache.stats()
    assert metrics._empty_frontier_mem_stats() == r_metrics._empty_frontier_mem_stats()


def test_evicted_executor_drops_its_closure():
    g = structure.example_graph()
    cache = plancache.ExecutorCache(1, plan_store=plancache.plans_mod.GraphPlanStore(device="cpu"))
    cache.get_or_build(paa.compile_query("a b", g), g.n_nodes, graph=g, block_size=8)
    entry = next(iter(cache._lru.values()))
    cache.get_or_build(paa.compile_query("a c", g), g.n_nodes, graph=g, block_size=8)
    assert entry.fn is None and cache.releases == 1 and len(cache) == 1


def test_summary_schema_equals_repro_before_any_request(setup):
    s = _svc(setup).summary()
    assert _keys(s) == _repro_schema()
    assert s["aio"] == r_metrics._empty_aio_stats() == metrics._empty_aio_stats()


def test_chip_smoke_summary_keys_equal_repro_schema():
    """``chip_smoke.py`` cannot import ``repro``; the summary key set it
    holds the serve phase to is written into it, and must stay
    ``repro``'s ``ServiceMetrics`` schema."""
    spec = importlib.util.spec_from_file_location("chip_smoke_keys", ROOT / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    assert chip.SUMMARY_KEYS == _repro_schema()


# ---------------------------------------------------------------------------
# admission, failures, flushes: the twins of tests/test_serve.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["reference", "frontier_kernel_sharded"])
def test_backend_not_ported_raises_naming_a12(setup, backend):
    _, placement = setup
    with pytest.raises(NotImplementedError, match="A12"):
        QueryService(placement, NetworkParams(*NET), config=ServeConfig(s2_backend=backend),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        QueryService(placement, NetworkParams(*NET), device="cpu")  # the default config


def test_admission_queue_bound(setup):
    svc = _svc(setup, max_pending=2)
    svc.enqueue("a b", [0])
    svc.enqueue("a b", [1])
    with pytest.raises(ServiceOverloaded):
        svc.enqueue("a b", [2])
    svc.flush()
    svc.enqueue("a b", [2])
    svc.flush()


def test_malformed_requests_rejected_at_admission(setup):
    g, _ = setup
    svc = _svc(setup)
    good = svc.enqueue("a b", [0])
    for bad in (("a (b", [0]), ("a b", [g.n_nodes + 7]), ("a b", [-1])):
        with pytest.raises(ValueError):
            svc.enqueue(*bad)
    with pytest.raises(ValueError):
        svc.enqueue("a b", [0], strategy="s2")
    with pytest.raises(ValueError):
        svc.enqueue("a b", [0], semantics="paths")
    assert svc.n_pending == 1
    svc.flush()
    assert good.result().answers is not None


def test_one_failed_request_does_not_drop_the_window(setup):
    svc = _svc(setup)
    good = svc.enqueue("a b", [0])
    bad = svc.enqueue("a b", [0])
    svc._queue[1].ast = object()  # sabotage planning for one request
    svc.flush()
    assert good.result().answers is not None
    with pytest.raises(TypeError):
        bad.result()


def test_failed_executor_fails_its_group_only(setup):
    """An S2 group whose executor raises fails its own tickets; the S1
    requests of the window still resolve."""
    svc = _svc(setup)
    s2 = svc.enqueue("a* b", [0, 1], strategy="S2")
    s1 = svc.enqueue("a b", [0], strategy="S1")

    def broken(*a, **k):
        raise RuntimeError("kernel build failed")

    svc.exec_cache.get_or_build = broken
    svc.flush()
    with pytest.raises(RuntimeError, match="kernel build failed"):
        s2.result()
    assert s1.result().answers is not None


def test_concurrent_flushes_serialize(setup):
    svc = _svc(setup)
    tickets, errs = [], []
    start = threading.Barrier(4)

    def worker(k):
        mine = [svc.enqueue("a b", [k]) for _ in range(5)]
        tickets.extend(mine)
        start.wait()
        try:
            svc.flush()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert all(t.done for t in tickets)
    assert len(svc.metrics.records) == 20
    assert svc.n_pending == 0


def test_reentrant_flush_defers_instead_of_deadlocking(setup):
    svc = _svc(setup)
    inner: list = []
    orig = svc._run_s1

    def reentrant_run(reqs):
        svc.enqueue("a b", [1])
        inner.append(svc.flush())
        orig(reqs)

    svc._run_s1 = reentrant_run
    first = svc.enqueue("a b", [0], strategy="S1")
    svc.flush()
    assert inner == [[]]
    assert first.done
    assert svc.n_pending == 1
    svc._run_s1 = orig
    svc.flush()
    assert svc.n_pending == 0


def test_unresolved_ticket_raises(setup):
    svc = _svc(setup)
    t = svc.enqueue("a b", [0])
    with pytest.raises(RuntimeError):
        t.result()
    svc.flush()
    t.result()


def test_plan_request_then_enqueue_planned(setup):
    svc = _svc(setup)
    t = svc.plan_request("(a|b)+", [0, 1], strategy="S2")
    assert t.strategy == "S2" and t.sig.backend == "frontier_kernel" and t.forecast_symbols > 0
    assert svc.n_pending == 0
    svc.enqueue_planned(t)
    with pytest.raises(ValueError):
        svc.enqueue_planned(svc.enqueue("a b", [0]))
    svc.flush()
    assert t.result().answers
    with pytest.raises(ValueError):
        svc.enqueue_planned(t)


def test_executor_cache_shared_across_requests(setup):
    svc = _svc(setup)
    svc.submit("a* b b", [0, 1], strategy="S2")
    builds = svc.exec_cache.builds
    svc.submit("a* b b", [2, 3], strategy="S2")
    assert svc.exec_cache.builds == builds
    svc.submit("a* b^-1", [0], strategy="S2")
    assert svc.exec_cache.builds == builds + 1
    # batches pad to the fused kernel's 8-row query stacking
    assert all(r.exec_batch_size % 8 == 0 for r in svc.metrics.records if r.strategy == "S2")
