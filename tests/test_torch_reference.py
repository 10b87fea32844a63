"""The port's ``reference`` S2 backend against ``repro``'s: plain torch on
the placement's padded site arrays, no kernel.  Answers, the three §4.2
meters (``q_bc``, ``n_bc`` and ``d_s2``, which sums every site's copies)
and the witness level planes bit-exact to ``repro``'s run on a (1, 1)
mesh, on graphs with replicated edges, through each way the site arrays
arrive (staged here, ``device_arrays=``, the plan store); the chunked
batch; a hub that 256 edges reach at once; and a ``QueryService`` on the
default ``ServeConfig``, whose backend this is, request for request.
Every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.core import strategies as r_st
from repro.core.cost_model import NetworkParams as RNet
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.graph import structure as r_struct
from repro.graph import workloads as r_wl
from repro.serve import QueryService as RService
from repro.serve import ServeConfig as RConfig

from repro_torch.core import paa, plans, strategies
from repro_torch.core.cost_model import NetworkParams
from repro_torch.graph import generators, partition, structure, workloads
from repro_torch.kernels.frontier import frontier, ops
from repro_torch.serve import QueryService, ServeConfig

torch.set_num_threads(1)

NET = (150, 450, 0.2)
QUERIES = ["(l0|l1)* l2 .^-1", "l0 (l1|l2)* l0", ". l1", "(l0|l2)+ l1?", "l3^-1 (l0|l1)+"]


@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


def _twins(n_sites, rate, seed, n_nodes=60, n_edges=260):
    rg = r_gen.random_labeled_graph(n_nodes, n_edges, 4, seed=seed)
    tg = generators.random_labeled_graph(n_nodes, n_edges, 4, seed=seed)
    return (rg, tg, r_part.distribute(rg, n_sites=n_sites, replication_rate=rate, seed=seed),
            partition.distribute(tg, n_sites=n_sites, replication_rate=rate, seed=seed))


def _same(want, got, semantics):
    assert got[0].dtype == bool and (got[0] == np.asarray(want[0])).all()
    assert [dataclasses.astuple(c) for c in got[1]] == [dataclasses.astuple(c) for c in want[1]]
    if semantics == "witness":
        assert got[2].dtype == np.float32 and got[2].tobytes() == np.asarray(want[2]).tobytes()


@pytest.mark.parametrize("semantics", ["pairs", "witness"])
@pytest.mark.parametrize("n_sites, rate, seed", [(1, 0.0, 1), (4, 0.5, 2), (7, 0.3, 5)])
def test_reference_executor_equals_repro(mesh, semantics, n_sites, rate, seed):
    """Every start of every query, the site arrays staged by
    ``s2_execute`` itself."""
    rg, tg, rp, tp = _twins(n_sites, rate, seed)
    assert (tp.replication_factor > 1.0) == (rate > 0)
    starts = np.arange(tg.n_nodes, dtype=np.int32)
    index = paa.HostIndex(tg)
    for q in QUERIES:
        rca, tca = r_paa.compile_query(q, rg), paa.compile_query(q, tg)
        want = r_st.s2_execute(mesh, rp, rca, starts, semantics=semantics)
        got = strategies.s2_execute(tp, tca, starts, backend="reference", semantics=semantics,
                                    device="cpu")
        _same(want, got, semantics)
        for s in starts.tolist()[::7]:
            host = paa.run_instrumented(tca, index, s)
            c = got[1][s]
            assert (c.broadcast_symbols, c.n_broadcasts) == (host.q_bc, host.n_broadcasts), (q, s)
            assert set(np.nonzero(got[0][s])[0].tolist()) == host.answers


def test_device_arrays_and_plan_store_paths_equal_repro(mesh):
    """The site arrays handed in (``device_arrays=``, as the service does),
    taken from a plan store, and a prebuilt executor fed them directly."""
    rg, tg, rp, tp = _twins(5, 0.6, 3)
    starts = np.array([0, 4, 9, 21, 33, 47], np.int32)
    store = plans.GraphPlanStore(device="cpu")
    arrays = strategies.stage_site_arrays(tp, "cpu")
    for q in QUERIES[:3]:
        rca, tca = r_paa.compile_query(q, rg), paa.compile_query(q, tg)
        want = r_st.s2_execute(mesh, rp, rca, starts, device_arrays=rp.padded_device_arrays(),
                               semantics="witness")
        _same(want, strategies.s2_execute(tp, tca, starts, device_arrays=arrays, backend="reference",
                                          semantics="witness"), "witness")
        _same(want, strategies.s2_execute(tp, tca, starts, backend="reference", plan_store=store,
                                          semantics="witness"), "witness")
        step = strategies.make_s2_step_fn(tca, tg.n_nodes, backend="reference", semantics="witness")
        assert step.backend == "reference"
        _same(want, strategies.s2_execute(tp, tca, starts, step_fn=step, device_arrays=arrays,
                                          semantics="witness"), "witness")
        with pytest.raises(ValueError, match="site arrays"):
            step(starts)
    assert store.stats()["misses"] == 1 and store.stats()["hits"] == 2


def test_chunked_batch_equals_one_batch(mesh, monkeypatch):
    """With the temporaries' budget cut to one start a chunk, the answers
    and meters are those of one batch, and of ``repro``."""
    rg, tg, rp, tp = _twins(4, 0.5, 2)
    starts = np.arange(0, tg.n_nodes, 2, dtype=np.int32)
    rca, tca = r_paa.compile_query(QUERIES[0], rg), paa.compile_query(QUERIES[0], tg)
    whole = strategies.s2_execute(tp, tca, starts, backend="reference", device="cpu")
    ops.FIXPOINT_COUNTERS.clear()
    monkeypatch.setattr(strategies, "REFERENCE_CHUNK_BYTES", 1)
    one = strategies.s2_execute(tp, tca, starts, backend="reference", device="cpu")
    assert ops.FIXPOINT_COUNTERS["host_syncs"] >= len(starts)  # a fixpoint per start
    _same(whole, one, "pairs")
    _same(r_st.s2_execute(mesh, rp, rca, starts), one, "pairs")


def test_a_hub_reached_by_256_edges_at_once(mesh):
    """256 frontier nodes reach one hub in the same level: the OR-scatter
    counts in int32, so the hub is reached (a uint8 count would wrap to
    0 and drop it), as in ``repro``; and no level kernel launches."""
    n = 260
    src = np.r_[np.zeros(256), np.arange(1, 257)].astype(np.int32)
    dst = np.r_[np.arange(1, 257), np.full(256, 257)].astype(np.int32)
    lbl = np.r_[np.zeros(256), np.ones(256)].astype(np.int32)
    rg = r_struct.LabeledGraph(n, src, lbl, dst, ["a", "b"])
    tg = structure.LabeledGraph(n, src, lbl, dst, ["a", "b"])
    rp = r_part.distribute(rg, n_sites=2, replication_rate=0.0, seed=0)
    tp = partition.distribute(tg, n_sites=2, replication_rate=0.0, seed=0)
    rca, tca = r_paa.compile_query("a b", rg), paa.compile_query("a b", tg)
    frontier.reset_launches()
    got = strategies.s2_execute(tp, tca, np.array([0]), backend="reference", device="cpu")
    assert set(np.nonzero(got[0][0])[0].tolist()) == {257}
    _same(r_st.s2_execute(mesh, rp, rca, np.array([0], np.int32)), got, "pairs")
    assert sum(frontier.launch_counts().values()) == 0


def _run_stream(svc, stream):
    """Planner-decided windows, then S2 and S1 forced by turns."""
    half = len(stream) // 2
    tickets = [svc.enqueue(q.query, q.starts) for q in stream[:half]]
    svc.flush()
    tickets += [svc.enqueue(q.query, q.starts, strategy=("S2", "S1")[i % 2])
                for i, q in enumerate(stream[half:])]
    svc.flush()
    return tickets


def test_default_config_service_equals_repro_request_for_request():
    """``QueryService(placement, net, device="cpu")`` on the default
    ``ServeConfig`` (the reference backend, batches of any size) serves a
    mixed stream as ``repro``'s does: answers, strategy, plan-cache hit,
    executor batch and observed costs, request for request, and the same
    summary counters."""
    rg, tg, rp, tp = _twins(4, 0.3, 3, n_nodes=100, n_edges=400)
    cfg = dict(n_rollouts=40, seed=0)
    r_svc = RService(rp, compat.make_mesh((1, 1), ("data", "model")), RNet(*NET), config=RConfig(**cfg))
    t_svc = QueryService(tp, NetworkParams(*NET), config=ServeConfig(**cfg), device="cpu")
    assert t_svc.config.s2_backend == r_svc.config.s2_backend == "reference"
    wc = dict(n_queries=24, hot_pool=4, max_starts=6, seed=0)
    r_tickets = _run_stream(r_svc, r_wl.generate(rg, r_wl.WorkloadConfig(**wc)))
    t_tickets = _run_stream(t_svc, workloads.generate(tg, workloads.WorkloadConfig(**wc)))
    for rt, tt in zip(r_tickets, t_tickets, strict=True):
        a, b = rt.result(), tt.result()
        assert (b.query, b.strategy, b.plan_cache_hit, b.answers) == (
            a.query, a.strategy, a.plan_cache_hit, a.answers)
        assert [dataclasses.astuple(c) for c in b.observed] == [
            dataclasses.astuple(c) for c in a.observed], b.query
    assert {t.result().strategy for t in t_tickets} == {"S1", "S2"}
    rec = lambda svc: [(r.query, r.strategy, r.exec_batch_size, r.broadcast_symbols,  # noqa: E731
                        r.unicast_symbols) for r in svc.metrics.records]
    assert rec(t_svc) == rec(r_svc)
    want, got = r_svc.summary(), t_svc.summary()
    for k in ("n_queries", "total_broadcast_symbols", "total_unicast_symbols", "strategies",
              "exec_cache", "plan_store", "frontier_mem", "calibration"):
        assert got[k] == want[k], k
