"""Parity of the port's host modules with ``repro``: generators, placement,
query compilation and the §4.2 host meter.  These are numpy on both sides
and seeded, so every comparison is exact equality."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.graph import structure as r_struct

from repro_torch.core import paa
from repro_torch.graph import generators, partition, structure

torch.set_num_threads(1)

SWEEP_QUERIES = [
    "a* b b", "a c (a|b)", "(a|b)+", "a* b^-1",
    "l0 (l1|l2)* l0", ". l1", "l0* .^-1", "(l0|l2)+ l1?",
    "l0 l2 l1", "l2* l0", ". l3^-1", "l0 .* l3",
]


def _same_graph(a, b):
    assert a.n_nodes == b.n_nodes and a.labels == b.labels
    for f in ("src", "lbl", "dst"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.fixture(scope="module")
def twins():
    return r_gen.alibaba_like(), generators.alibaba_like()


def test_alibaba_twin_byte_identical(twins):
    _same_graph(*twins)


def test_random_and_example_graphs_byte_identical():
    _same_graph(r_gen.random_labeled_graph(50, 220, 3, seed=7),
                generators.random_labeled_graph(50, 220, 3, seed=7))
    _same_graph(r_struct.example_graph(), structure.example_graph())


@pytest.mark.parametrize("skew", [0.0, 2.0])
def test_distribute_byte_identical(skew):
    rg = r_gen.random_labeled_graph(60, 300, 4, seed=3)
    tg = generators.random_labeled_graph(60, 300, 4, seed=3)
    a = r_part.distribute(rg, n_sites=8, replication_rate=0.3, skew=skew, seed=5)
    b = partition.distribute(tg, n_sites=8, replication_rate=0.3, skew=skew, seed=5)
    assert a.n_sites == b.n_sites and a.replication_factor == b.replication_factor
    assert a.replication.tobytes() == b.replication.tobytes()
    for x, y in zip(a.site_edges, b.site_edges, strict=True):
        assert x.tobytes() == y.tobytes()


def _same_automaton(a, b):
    assert (a.n_states, a.start, a.accepting, a.n_labels) == (
        b.n_states, b.start, b.accepting, b.n_labels
    )
    assert [dataclasses.astuple(t) for t in a.transitions] == [
        dataclasses.astuple(t) for t in b.transitions
    ]


def test_compile_table2_queries_equal(twins):
    rg, tg = twins
    for name, expr in r_gen.TABLE2_QUERIES.items():
        assert generators.TABLE2_QUERIES[name] == expr
        _same_automaton(r_paa.compile_query(expr, rg), paa.compile_query(expr, tg))
    assert generators.TABLE2_PAPER == r_gen.TABLE2_PAPER


@pytest.mark.parametrize("expr", SWEEP_QUERIES)
def test_compile_sweep_queries_equal(expr):
    labels = ["a", "b", "c", "l0", "l1", "l2", "l3"]
    rg = r_struct.LabeledGraph(4, [0], [0], [1], labels)
    tg = structure.LabeledGraph(4, [0], [0], [1], labels)
    _same_automaton(r_paa.compile_query(expr, rg), paa.compile_query(expr, tg))


def test_valid_starts_and_host_meter_equal_on_twin(twins):
    """The host meter on sampled starts of three Table-2 queries of the
    twin: every S2Trace field equal (integer counts and answer sets)."""
    rg, tg = twins
    r_index, t_index = r_paa.HostIndex(rg), paa.HostIndex(tg)
    rng = np.random.default_rng(0)
    for name in ("q1", "q9", "q12"):
        expr = r_gen.TABLE2_QUERIES[name]
        rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
        starts = paa.valid_start_nodes(tca, tg)
        assert starts.tobytes() == r_paa.valid_start_nodes(rca, rg).tobytes()
        for s in rng.choice(starts, size=4, replace=False):
            assert dataclasses.asdict(r_paa.run_instrumented(rca, r_index, int(s))) == (
                dataclasses.asdict(paa.run_instrumented(tca, t_index, int(s)))
            )


@pytest.mark.parametrize("expr", ["a* b b", "a c (a|b)", "(a|b)+", "a* b^-1"])
def test_host_meter_equal_on_example_graph(expr):
    rg, tg = r_struct.example_graph(), structure.example_graph()
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    r_index, t_index = r_paa.HostIndex(rg), paa.HostIndex(tg)
    for s in range(tg.n_nodes):
        for cap in (None, 3):
            assert dataclasses.asdict(r_paa.run_instrumented(rca, r_index, s, cap)) == (
                dataclasses.asdict(paa.run_instrumented(tca, t_index, s, cap))
            )


@pytest.mark.parametrize("expr", ["a* b b", "(a|b)+", "a* b^-1", ". c"])
def test_device_bfs_oracle_matches_repro(expr):
    """The port's device BFS (gather + scatter_reduce(amax)) answers every
    start exactly as ``repro``'s jitted BFS: boolean sets, no arithmetic
    to round."""
    rg, tg = r_struct.example_graph(), structure.example_graph()
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    rdg, tdg = r_struct.to_device_graph(rg), structure.to_device_graph(tg, "cpu")
    for s in range(tg.n_nodes):
        want = np.asarray(r_paa.answers_single_source(rca, rdg, s))
        assert (paa.answers_single_source(tca, tdg, s).numpy() == want).all(), s
    a_src, a_dst = r_paa.answers_multi_source(rca, rdg, chunk=4)
    b_src, b_dst = paa.answers_multi_source(tca, tdg, chunk=4)
    assert sorted(zip(a_src.tolist(), a_dst.tolist())) == sorted(zip(b_src.tolist(), b_dst.tolist()))
