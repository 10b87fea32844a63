"""The port's S1 executor and the S1/S3/S4 meters against ``repro``'s.

The meters are the same host Python in both packages, so they are equal
field by field.  The padded per-site arrays are numpy in both, so they
are equal byte for byte.  The S1 gather compacts each site's matching
edges by a stable sort on ``~match``, ``repro``'s
``argsort(stable=True)``, so its buffers equal ``repro``'s byte for byte
before the dedup, at the default cap and at ``cap=1``, where every site
overflows and ``s1_collect`` doubles the cap until none does.  Answers
are node sets, equal to ``repro``'s and to the host PAA's.  Last, the
fast path: S2 at a query class's level cap, on its reduced automaton,
answers as uncapped S2 does."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.core import regex as r_rx
from repro.core import strategies as r_st
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.graph import structure as r_struct

from repro_torch import interop
from repro_torch.core import paa, planner, strategies
from repro_torch.core import regex as rx
from repro_torch.graph import generators, partition, structure

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


def _graphs(name):
    if name == "example":
        return r_struct.example_graph(), structure.example_graph()
    return (r_gen.random_labeled_graph(200, 700, 4, seed=9),
            generators.random_labeled_graph(200, 700, 4, seed=9))


# (graph, n_sites, replication rate, skew, seed); the example graph's
# placements are those of tests/test_cost_accounting.py
PLACEMENTS = [
    ("example", 4, 0.4, 0.0, 1),
    ("example", 3, 0.5, 0.0, 4),
    ("example", 1, 1.0, 0.0, 0),
    ("random", 6, 0.3, 0.0, 2),
    ("random", 5, 0.4, 2.0, 3),
]
EXAMPLE_QUERIES = ["a* b b", "(a|b)+", "a c (a|b)", "a* b^-1", ". b^-1 c", "a b"]
RANDOM_QUERIES = ["(l0|l1)+ l2", "l0 . l3^-1*", "l3", "l1 l2"]


def _placements(case):
    name, n_sites, rate, skew, seed = case
    rg, tg = _graphs(name)
    rpl = r_part.distribute(rg, n_sites, replication_rate=rate, skew=skew, seed=seed)
    tpl = partition.distribute(tg, n_sites, replication_rate=rate, skew=skew, seed=seed)
    return rg, tg, rpl, tpl, EXAMPLE_QUERIES if name == "example" else RANDOM_QUERIES


@pytest.mark.parametrize("case", PLACEMENTS)
def test_padded_arrays_and_local_graphs(case):
    rg, tg, rpl, tpl, _ = _placements(case)
    for pad in (8, 1, 5):
        want, got = rpl.padded_device_arrays(pad), tpl.padded_device_arrays(pad)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), (k, pad)
    for s in range(tpl.n_sites):
        rl, tl = rpl.local_graph(s), tpl.local_graph(s)
        assert (tl.n_nodes, tl.labels) == (rl.n_nodes, rl.labels)
        assert all(np.array_equal(getattr(tl, f), getattr(rl, f)) for f in ("src", "lbl", "dst"))
    staged = strategies.stage_site_arrays(tpl, "cpu")
    for k, a in tpl.padded_device_arrays().items():
        assert np.array_equal(staged[k].numpy(), a) and staged[k].device.type == "cpu"
    carried = interop.placement_from_numpy(tg, rpl.n_sites, rpl.site_edges, rpl.replication)
    assert carried.padded_device_arrays()["src"].tobytes() == rpl.padded_device_arrays()["src"].tobytes()
    assert carried.replication_factor == rpl.replication_factor


@pytest.mark.parametrize("case", PLACEMENTS)
def test_meters_equal_repro(case):
    rg, tg, rpl, tpl, queries = _placements(case)
    r_index, t_index = r_paa.HostIndex(rg), paa.HostIndex(tg)
    for expr in queries:
        r_ast, t_ast = r_rx.parse(expr), rx.parse(expr)
        assert np.array_equal(strategies.query_label_mask(t_ast, tg), r_st.query_label_mask(r_ast, rg))
        assert dataclasses.astuple(strategies.s1_costs(t_ast, tg)) == dataclasses.astuple(
            r_st.s1_costs(r_ast, rg))
        assert dataclasses.astuple(strategies.s4_costs(t_ast, tg, tpl)) == dataclasses.astuple(
            r_st.s4_costs(r_ast, rg, rpl))
        rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
        for s in range(0, tg.n_nodes, max(1, tg.n_nodes // 12)):
            assert dataclasses.astuple(strategies.s3_costs(tca, t_index, s)) == dataclasses.astuple(
                r_st.s3_costs(rca, r_index, s)), (expr, s)
            r_tr, t_tr = r_st._run_uncached(rca, r_index, s), strategies._run_uncached(tca, t_index, s)
            assert dataclasses.asdict(t_tr) == dataclasses.asdict(r_tr), (expr, s)


def test_label_mask_of_a_wildcard_and_an_absent_label():
    g = structure.example_graph()
    assert strategies.query_label_mask(rx.parse(". a"), g).all()
    mask = strategies.query_label_mask(rx.parse("a zz b"), g)
    assert mask.tolist() == [True, True, False]


def _gather_bytes(out):
    return tuple(np.asarray(a).tobytes() for a in out[:4]) + (int(out[4]),)


def _stable_gather(arrays, label_mask, cap):
    """numpy twin of repro's per-site compaction: numpy's stable argsort
    orders as ``jnp.argsort(stable=True)`` does."""
    match = arrays["mask"] & label_mask[arrays["lbl"]]
    take = np.argsort(~match, axis=1, kind="stable")[:, :cap]
    overflow = int(np.maximum(match.sum(1) - cap, 0).sum())
    return tuple(np.take_along_axis(a, take, 1) for a in (
        arrays["src"], arrays["lbl"], arrays["dst"], match)) + (overflow,)


def _key(h):
    return set(zip(h.src.tolist(), h.lbl.tolist(), h.dst.tolist()))


@pytest.mark.parametrize("cap", [None, 1, 3])
@pytest.mark.parametrize("case", PLACEMENTS)
def test_s1_gather_and_collect_on_every_query(case, cap):
    """Every placement and query: the gather equals its numpy twin byte
    for byte, and s1_collect holds every matching edge once."""
    rg, tg, rpl, tpl, queries = _placements(case)
    arrays = tpl.padded_device_arrays()
    t_arrays = strategies.stage_site_arrays(tpl, "cpu")
    max_e = arrays["src"].shape[1]
    for expr in queries:
        lmask = strategies.query_label_mask(rx.parse(expr), tg)
        c = max_e if cap is None else cap
        got = strategies.s1_gather(t_arrays, lmask, c)
        assert [a.dtype for a in got[:4]] == [torch.int32, torch.int32, torch.int32, torch.bool]
        assert _gather_bytes([a.numpy() for a in got[:4]] + [got[4]]) == _gather_bytes(
            _stable_gather(arrays, lmask, c)), (expr, c)
        sub = strategies.s1_collect(tpl, lmask, cap, device_arrays=t_arrays)
        truth = tg.dedup().subgraph_with_labels(set(np.nonzero(lmask)[0].tolist()))
        assert _key(sub) == _key(truth) and sub.n_edges == truth.n_edges, expr


# the cases run through repro's own S1 (each repro gather compiles anew,
# ~2 s on a CPU): both graphs, a skewed placement, an inverse and a wildcard
REPRO_CASES = [(0, "(a|b)+"), (0, ". b^-1 c"), (3, "(l0|l1)+ l2"), (4, "l0 . l3^-1*")]


@pytest.mark.parametrize("cap", [None, 1])
@pytest.mark.parametrize("case, expr", REPRO_CASES)
def test_s1_gather_equals_repro(mesh, case, expr, cap):
    rg, tg, rpl, tpl, _ = _placements(PLACEMENTS[case])
    r_arrays = rpl.padded_device_arrays()
    lmask = r_st.query_label_mask(r_rx.parse(expr), rg)
    c = r_arrays["src"].shape[1] if cap is None else cap
    want = r_st.s1_gather(mesh, r_arrays, lmask, c)
    got = strategies.s1_gather(strategies.stage_site_arrays(tpl, "cpu"), lmask, c)
    assert _gather_bytes([a.numpy() for a in got[:4]] + [got[4]]) == _gather_bytes(want)
    assert (got[4] > 0) == (cap == 1)


def _same_subgraph(a, b):
    assert (a.n_nodes, a.labels) == (b.n_nodes, b.labels)
    for f in ("src", "lbl", "dst"):
        assert getattr(a, f).dtype == getattr(b, f).dtype
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f


@pytest.mark.parametrize("case, expr", REPRO_CASES[1:])
def test_s1_collect_equals_repro(mesh, case, expr):
    """At the default cap; the port's retry from cap=1 ends in the same
    subgraph."""
    rg, tg, rpl, tpl, _ = _placements(PLACEMENTS[case])
    lmask = r_st.query_label_mask(r_rx.parse(expr), rg)
    want = r_st.s1_collect(mesh, rpl, lmask)
    arrays = strategies.stage_site_arrays(tpl, "cpu")
    _same_subgraph(strategies.s1_collect(tpl, lmask, device="cpu"), want)
    _same_subgraph(strategies.s1_collect(tpl, lmask, cap=1, device_arrays=arrays), want)


def test_s1_collect_retry_from_cap_one_equals_repro(mesh):
    """cap=1 overflows on every site holding two matches; both packages
    double the cap until no site overflows (1, 2, 4, 8 here)."""
    rg, tg, rpl, tpl, _ = _placements(PLACEMENTS[0])
    lmask = r_st.query_label_mask(r_rx.parse("(a|b)+"), rg)
    arrays = strategies.stage_site_arrays(tpl, "cpu")
    *_, overflow = strategies.s1_gather(arrays, lmask, 1)
    want = int(sum(max(int((tpl.graph.lbl[e] <= 1).sum()) - 1, 0) for e in tpl.site_edges))
    assert overflow == want > 0
    assert arrays["src"].shape[1] == 8
    _same_subgraph(strategies.s1_collect(tpl, lmask, cap=1, device_arrays=arrays),
                   r_st.s1_collect(mesh, rpl, lmask, cap=1))


@pytest.mark.parametrize("case, expr", REPRO_CASES[::2] + REPRO_CASES[3:])
def test_s1_execute_equals_repro(mesh, case, expr):
    rg, tg, rpl, tpl, _ = _placements(PLACEMENTS[case])
    r_ast, t_ast = r_rx.parse(expr), rx.parse(expr)
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    index = paa.HostIndex(tg)
    start = next(int(v) for v in paa.valid_start_nodes(tca, tg)
                 if paa.run_instrumented(tca, index, int(v)).answers)
    r_ans, r_cost = r_st.s1_execute(mesh, rpl, r_ast, rca, start)
    t_ans, t_cost = strategies.s1_execute(tpl, t_ast, tca, start, device="cpu")
    assert t_ans == r_ans and len(t_ans) > 0
    assert dataclasses.astuple(t_cost) == dataclasses.astuple(r_cost)


@pytest.mark.parametrize("case", PLACEMENTS)
def test_s1_execute_equals_host_paa(case):
    """Every query, a spread of starts, the default cap and cap=1."""
    rg, tg, rpl, tpl, queries = _placements(case)
    t_arrays = strategies.stage_site_arrays(tpl, "cpu")
    index = paa.HostIndex(tg)
    for expr in queries:
        t_ast, tca = rx.parse(expr), paa.compile_query(expr, tg)
        for s in range(0, tg.n_nodes, max(1, tg.n_nodes // 6)):
            for cap in (None, 1):
                ans, cost = strategies.s1_execute(tpl, t_ast, tca, s, cap=cap, device_arrays=t_arrays)
                assert ans == paa.run_instrumented(tca, index, s).answers, (expr, s, cap)
                assert cost == strategies.s1_costs(t_ast, tg)


# query-class fast paths: single-label and bounded queries run S2 at
# their level cap, closure queries on their one-state automaton
FAST_PATHS = [
    ("example", "a"), ("example", "(a|b)"), ("example", "a b"), ("example", "a . c"),
    ("example", "a*"), ("example", "(a|c)*"), ("example", "a (b|c) a^-1"),
    ("random", "l1 l2"), ("random", "(l0|l3)*"), ("random", "l0 . l3^-1"),
]


@pytest.mark.parametrize("graph, expr", FAST_PATHS)
def test_s2_under_the_fast_path_cap_equals_uncapped(graph, expr):
    _, tg = _graphs(graph)
    tpl = partition.distribute(tg, 3, replication_rate=0.4, seed=1)
    ca = paa.compile_query(expr, tg)
    qc = planner.classify_query(expr)
    assert qc.kind in ("single_label", "bounded", "closure")
    cap = planner.fast_path_max_levels(qc)
    starts = np.arange(tg.n_nodes, dtype=np.int32)
    block = 8 if tg.n_nodes < 100 else 32
    full, _ = strategies.s2_execute(tpl, ca, starts, block_size=block, device="cpu")
    fast, _ = strategies.s2_execute(
        tpl, planner.reduce_automaton(ca, qc), starts, max_levels=cap, block_size=block, device="cpu")
    assert np.array_equal(fast, full), expr
    index = paa.HostIndex(tg)
    for s in starts[:: max(1, len(starts) // 10)]:
        assert set(np.nonzero(fast[s])[0].tolist()) == paa.run_instrumented(ca, index, int(s)).answers
