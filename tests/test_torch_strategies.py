"""The port's S2 ``frontier_kernel`` executor against ``repro``'s and the
host meter.  Answers are boolean sets; the meters are sums of integers
below 2^24 in f32, exact in any order, and the unicast symbols then take
the same f32 ×K and float64 ÷K steps on both sides — so every field is
compared for exact equality with ``repro``.  Against the host meter the
unicast symbols are compared after rounding, because the ×K ÷K round
trip (K > 1) may leave them off the integer count by far less than one."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.core import strategies as r_st
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.graph import structure as r_struct

from repro_torch.core import paa, strategies
from repro_torch.graph import generators, partition, structure

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


def _compare(mesh, rg, tg, expr, n_sites, rate, seed, block, starts):
    rpl = r_part.distribute(rg, n_sites=n_sites, replication_rate=rate, seed=seed)
    tpl = partition.distribute(tg, n_sites=n_sites, replication_rate=rate, seed=seed)
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    r_ans, r_costs = r_st.s2_execute(
        mesh, rpl, rca, starts, backend="frontier_kernel", block_size=block
    )
    t_ans, t_costs = strategies.s2_execute(
        tpl, tca, starts, backend="frontier_kernel", block_size=block, device="cpu"
    )
    assert t_ans.dtype == bool and (t_ans == np.asarray(r_ans)).all(), expr
    index = paa.HostIndex(tg)
    for i, (s, rc, tc) in enumerate(zip(starts.tolist(), r_costs, t_costs, strict=True)):
        assert dataclasses.astuple(rc) == dataclasses.astuple(tc), (expr, s)
        host = paa.run_instrumented(tca, index, s)
        assert set(np.nonzero(t_ans[i])[0].tolist()) == host.answers, (expr, s)
        assert tc.broadcast_symbols == host.q_bc, (expr, s)
        assert tc.n_broadcasts == host.n_broadcasts, (expr, s)
        assert round(tc.unicast_symbols) == host.d_s2, (expr, s)
        if tpl.replication_factor == 1.0:
            assert tc.unicast_symbols == host.d_s2, (expr, s)
    return tpl


@pytest.mark.parametrize("expr", ["a c (a|b)", "(a|b)+", "a* b^-1"])
def test_s2_execute_matches_repro_and_host_meter_at_k1(mesh, expr):
    """The queries of tests/test_cost_accounting.py:180, one site (K=1),
    block 8, every start."""
    starts = np.arange(9, dtype=np.int32)
    _compare(mesh, r_struct.example_graph(), structure.example_graph(), expr, 1, 1.0, 0, 8, starts)


@pytest.mark.parametrize("expr", ["(l0|l1)+ l2", "l0 .^-1 l3*"])
def test_s2_execute_matches_repro_on_random_graph_k_above_1(mesh, expr):
    rg = r_gen.random_labeled_graph(200, 700, 4, seed=9)
    tg = generators.random_labeled_graph(200, 700, 4, seed=9)
    starts = np.random.default_rng(1).choice(200, size=24, replace=False).astype(np.int32)
    tpl = _compare(mesh, rg, tg, expr, 4, 0.5, 2, 16, starts)
    assert tpl.replication_factor > 1.0


def test_executor_structure_equals_repro():
    rg, tg = r_struct.example_graph(), structure.example_graph()
    for expr in ["a c (a|b)", "(a|b)+", "a* b^-1", ". b^-1 c"]:
        rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
        assert strategies.transition_runs(tca) == r_st.transition_runs(rca)
        assert strategies.symbol_set_groups(tca) == r_st.symbol_set_groups(rca)
        sg = strategies.symbol_set_groups(tca)
        for a, b in zip(
            strategies._site_symbol_degrees(sg, [tg], 16),
            r_st._site_symbol_degrees(r_st.symbol_set_groups(rca), [rg], 16),
        ):
            assert a.tobytes() == b.tobytes()
        t_index, r_index = paa.HostIndex(tg), r_paa.HostIndex(rg)
        for s in range(tg.n_nodes):
            assert dataclasses.astuple(strategies.s2_costs(tca, t_index, s)) == (
                dataclasses.astuple(r_st.s2_costs(rca, r_index, s))
            )


@pytest.mark.parametrize(
    "kw, item",
    [
        ({"backend": "reference"}, "A12"),
        ({"backend": "reference", "semantics": "witness"}, "A12"),
        ({"backend": "frontier_kernel_sharded"}, "A12"),
        ({"backend": "frontier_kernel_sharded", "semantics": "witness"}, "A12"),
        ({"backend": "frontier_kernel_sharded", "tile_dtype": "uint32"}, "A12"),
    ],
)
def test_paths_not_ported_yet_raise(mesh, kw, item):
    """The backends that raised naming ROADMAP ``item`` until it ported
    them: each builds now, and on a replicated 3-site placement its
    answers, meters and witness levels equal ``repro``'s bit for bit."""
    rg, tg = r_struct.example_graph(), structure.example_graph()
    rpl = r_part.distribute(rg, n_sites=3, replication_rate=0.5, seed=2)
    tpl = partition.distribute(tg, n_sites=3, replication_rate=0.5, seed=2)
    rca, tca = r_paa.compile_query("(a|b)+ c?", rg), paa.compile_query("(a|b)+ c?", tg)
    starts = np.arange(tg.n_nodes, dtype=np.int32)
    want = r_st.s2_execute(mesh, rpl, rca, starts, block_size=8, **kw)
    got = strategies.s2_execute(tpl, tca, starts, block_size=8, device="cpu", **kw)
    assert len(got) == len(want) == (3 if kw.get("semantics") == "witness" else 2), item
    assert (got[0] == np.asarray(want[0])).all()
    assert [dataclasses.astuple(c) for c in got[1]] == [dataclasses.astuple(c) for c in want[1]]
    if len(got) == 3:
        assert got[2].tobytes() == np.asarray(want[2]).tobytes()


def test_unknown_backend_is_a_value_error():
    g = structure.example_graph()
    with pytest.raises(ValueError, match="unknown backend"):
        strategies.make_s2_step_fn(paa.compile_query("a", g), g.n_nodes, backend="nope")
