"""The port's witness semantics and bounded path counting against
``repro``'s and the host oracles, on the CPU: the discovery-level
fixpoints, ``extend_frontier_sum``, ``count_paths_bounded``, the S2
executors under ``semantics="witness"`` and the host half
(``core/witness.py``).  ``repro``'s Pallas calls run in interpret mode,
as its own tests run them.

Level planes hold small integers and ``INF_LEVEL``, so they are compared
bit for bit.  Counts are compared exactly wherever every count is below
2^24: every partial sum is then an integer that f32 adds exactly in any
order.  Above that bound the fused level's sums round, and the port's
sums (``bmm`` then ``index_add_`` on the CPU, atomics on the card) may
round in another order than ``repro``'s in-order walk: there both are
held to the host's float64 counts, and to each other, at a relative
tolerance derived from the number of f32 adds (see
:func:`test_count_paths_above_the_bound`)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.core import strategies as r_st
from repro.core import witness as r_w
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.graph import structure as r_struct
from repro.kernels.frontier import frontier as r_fk
from repro.kernels.frontier import ops as r_ops

from repro_torch.core import paa, strategies, witness
from repro_torch.graph import generators, partition, structure
from repro_torch.kernels.frontier import frontier as fk
from repro_torch.kernels.frontier import ops

torch.set_num_threads(1)

# the graph and starts of tests/test_property.py::test_level_fixpoints_match_host_product_bfs;
# its expressions name labels a, b, c that the graph (l0, l1, l2) lacks, so
# here they come once as written and once on the graph's own labels
PROPERTY_GRAPH = (14, 40, 3, 5)
PROPERTY_STARTS = np.array([0, 3, 7, 11], np.int32)
EXPRS = ["a*", "l0*", "(l0|l1) l2*", "l0.l1", "(l0^-1|l1)* l2"]
F32_BOUND = 2**24


@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


def _graphs(n_nodes, n_edges, n_labels, seed):
    return (
        r_gen.random_labeled_graph(n_nodes, n_edges, n_labels, seed=seed),
        generators.random_labeled_graph(n_nodes, n_edges, n_labels, seed=seed),
    )


def _plans(rg, tg, expr, block):
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    rplan = r_ops.build_level_plan(rca, r_ops.make_blocked_graph(rg, block_size=block))
    tplan = ops.build_level_plan(tca, tg, block_size=block, device="cpu")
    return rca, tca, rplan, tplan


def _masks(n_nodes, starts):
    masks = np.zeros((len(starts), n_nodes), np.float32)
    masks[np.arange(len(starts)), starts] = 1.0
    return masks


def _dense_graphs(n_nodes, density, seed):
    """One label on a dense simple digraph (self-loops allowed, no
    parallel edges: the tile store keeps one 0/1 entry per edge, the
    host count one term per edge), in both packages."""
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(rng.random((n_nodes, n_nodes)) < density)
    args = (src.astype(np.int32), np.zeros(len(src), np.int32), dst.astype(np.int32), ["l0"])
    return r_struct.LabeledGraph(n_nodes, *args), structure.LabeledGraph(n_nodes, *args)


@pytest.mark.parametrize("expr", EXPRS)
def test_level_fixpoints_equal_repro_and_host_levels(expr):
    """reach_fixpoint_levels and reach_fixpoint_packed_levels: visited
    sets and level planes bit-equal to ``repro``'s, and each start's
    levels equal to the port's and ``repro``'s host product BFS."""
    rg, tg = _graphs(*PROPERTY_GRAPH)
    rca, tca, rplan, tplan = _plans(rg, tg, expr, 8)
    masks = _masks(tg.n_nodes, PROPERTY_STARTS)
    f0 = ops.stack_start_masks(tplan, tca.start, masks)
    r_vis, r_lev = r_ops.reach_fixpoint_levels(rplan, jnp.asarray(f0), interpret=True)
    t_vis, t_lev = ops.reach_fixpoint_levels(tplan, torch.from_numpy(f0))
    assert np.array_equal(t_vis.numpy(), np.asarray(r_vis))
    assert np.array_equal(t_lev.numpy(), np.asarray(r_lev))
    f0p = ops.stack_start_masks_packed(tplan, tca.start, masks)
    r_visp, r_levp = r_ops.reach_fixpoint_packed_levels(rplan, jnp.asarray(f0p), interpret=True)
    t_visp, t_levp = ops.reach_fixpoint_packed_levels(tplan, torch.from_numpy(f0p.view(np.int32)))
    assert np.array_equal(t_visp.numpy().view(np.uint32), np.asarray(r_visp))
    assert np.array_equal(t_levp.numpy(), np.asarray(r_levp))
    assert t_levp.shape == (tplan.n_states, ops.QPACK, tplan.v_pad)
    lev3 = t_lev.numpy().reshape(tplan.n_states, tplan.q_pad, -1)
    index, r_index = paa.HostIndex(tg), r_paa.HostIndex(rg)
    for i, s in enumerate(PROPERTY_STARTS.tolist()):
        host = witness.host_levels(tca, index, s)
        assert np.array_equal(host, r_w.host_levels(rca, r_index, s))
        assert np.array_equal(lev3[:, i, : tg.n_nodes], host), s
        assert np.array_equal(t_levp.numpy()[:, i, : tg.n_nodes], host), s
    # lanes past the stacked starts stay unreached
    assert (t_levp.numpy()[:, len(PROPERTY_STARTS) :] == witness.INF_LEVEL).all()


def test_level_fixpoints_stop_at_max_levels():
    """Both level fixpoints stop after ``max_levels`` expansions exactly,
    as ``repro``'s do: nothing past level max_levels + 1 is stamped."""
    rg, tg = _graphs(*PROPERTY_GRAPH)
    rca, tca, rplan, tplan = _plans(rg, tg, "(l0|l1|l2)+", 8)
    masks = _masks(tg.n_nodes, PROPERTY_STARTS)
    f0 = ops.stack_start_masks(tplan, tca.start, masks)
    f0p = ops.stack_start_masks_packed(tplan, tca.start, masks)
    for max_levels in (1, 2):
        ops.FIXPOINT_COUNTERS.clear()
        _, lev = ops.reach_fixpoint_levels(tplan, torch.from_numpy(f0), max_levels)
        _, levp = ops.reach_fixpoint_packed_levels(tplan, torch.from_numpy(f0p.view(np.int32)), max_levels)
        assert ops.FIXPOINT_COUNTERS["levels"] == 2 * max_levels
        _, r_lev = r_ops.reach_fixpoint_levels(rplan, jnp.asarray(f0), max_levels, interpret=True)
        _, r_levp = r_ops.reach_fixpoint_packed_levels(rplan, jnp.asarray(f0p), max_levels, interpret=True)
        assert np.array_equal(lev.numpy(), np.asarray(r_lev))
        assert np.array_equal(levp.numpy(), np.asarray(r_levp))
        finite = lev.numpy()[lev.numpy() < witness.INF_LEVEL]
        assert finite.max() == max_levels + 1


def test_extend_frontier_sum_equals_repro():
    """Fan-in union rows are the sum of their members' count rows,
    byte-equal to ``repro``'s, where ``extend_frontier`` takes the max."""
    rng = np.random.default_rng(3)
    n_states, q_pad, v_pad = 4, 8, 32
    counts = rng.integers(0, 1000, (n_states * q_pad, v_pad)).astype(np.float32)
    members = ((0, 1), (1, 2, 3), (0, 3))
    got = ops.extend_frontier_sum(torch.from_numpy(counts), members, n_states, q_pad).numpy()
    want = np.asarray(r_ops.extend_frontier_sum(jnp.asarray(counts), members, n_states, q_pad))
    assert got.shape == ((n_states + len(members)) * q_pad, v_pad)
    assert np.array_equal(got, want)
    c3 = counts.reshape(n_states, q_pad, v_pad)
    assert np.array_equal(got.reshape(-1, q_pad, v_pad)[5], c3[1] + c3[2] + c3[3])
    plain = torch.from_numpy(counts)
    assert ops.extend_frontier_sum(plain, (), n_states, q_pad) is plain


@pytest.mark.parametrize("expr", ["a*", "l0*", "(l0|l1) l2*", "l0.l1", "l0 l1", "(l0^-1|l1)* l2"])
def test_count_paths_bounded_equals_repro_and_host(expr):
    """Counts over the property graph (5 levels) equal ``repro``'s
    exactly, and the host DP's on wildcard-free automata.  The tile store
    holds an edge once, so the host counts on the graph without its
    repeated (src, label, dst) triples; a wildcard hop rides the
    any-label union store, which also holds parallel edges of different
    labels once (``repro``'s caveat, so ``l0.l1`` is held to ``repro``
    only)."""
    rg, tg = _graphs(*PROPERTY_GRAPH)
    rca, tca, rplan, tplan = _plans(rg, tg, expr, 8)
    f0 = ops.stack_start_masks(tplan, tca.start, _masks(tg.n_nodes, PROPERTY_STARTS))
    ops.FIXPOINT_COUNTERS.clear()
    got = ops.count_paths_bounded(tplan, torch.from_numpy(f0), tca.accepting, 5).numpy()
    assert ops.FIXPOINT_COUNTERS["levels"] == 5 and ops.FIXPOINT_COUNTERS["host_syncs"] == 0
    want = np.asarray(r_ops.count_paths_bounded(rplan, jnp.asarray(f0), rca.accepting, 5, interpret=True))
    assert np.array_equal(got, want)
    if "." in expr:
        return
    index = paa.HostIndex(tg.dedup())
    for i, s in enumerate(PROPERTY_STARTS.tolist()):
        assert np.array_equal(got[i, : tg.n_nodes], witness.count_paths(tca, index, s, 5)), s


def _count_both(rg, tg, expr, block, start, n_levels):
    rca, tca, rplan, tplan = _plans(rg, tg, expr, block)
    f0 = ops.stack_start_masks(tplan, tca.start, _masks(tg.n_nodes, [start]))
    got = ops.count_paths_bounded(tplan, torch.from_numpy(f0), tca.accepting, n_levels).numpy()
    want = np.asarray(r_ops.count_paths_bounded(rplan, jnp.asarray(f0), rca.accepting, n_levels, interpret=True))
    host = witness.count_paths(tca, paa.HostIndex(tg), start, n_levels)
    return got[0, : tg.n_nodes], want[0, : tg.n_nodes], host, tplan


def test_count_paths_exact_at_two_to_the_24_minus_1():
    """``l0+`` on the complete digraph of two nodes with self-loops has
    2^(l-1) runs of length l to each node, so 24 levels total exactly
    2^24 - 1 at both: the largest count the contract covers.  The fan-in
    union row (both states read l0 into the accepting one) carries the
    sums; every partial sum is an integer below 2^24, so port, ``repro``
    and the host agree exactly."""
    args = (np.array([0, 0, 1, 1], np.int32), np.zeros(4, np.int32), np.array([0, 1, 0, 1], np.int32), ["l0"])
    rg, tg = r_struct.LabeledGraph(2, *args), structure.LabeledGraph(2, *args)
    got, want, host, plan = _count_both(rg, tg, "l0+", 8, 0, 24)
    assert plan.union_members  # the sums pass through extend_frontier_sum
    assert (host == F32_BOUND - 1).all()
    assert np.array_equal(got, want) and np.array_equal(got, host.astype(np.float32))


def _dense_levels():
    """A dense 40-node digraph (density 0.5, block 8: runs of 5 steps per
    output block) and the largest ``l0+`` length whose counts stay below
    2^24, from the host DP."""
    rg, tg = _dense_graphs(40, 0.5, seed=21)
    tca = paa.compile_query("l0+", tg)
    index = paa.HostIndex(tg)
    n = 1
    while witness.count_paths(tca, index, 0, n + 1).max() < F32_BOUND:
        n += 1
    return rg, tg, n


def test_count_paths_exact_below_the_bound_on_a_dense_graph():
    """At the largest length whose counts stay below 2^24 (about half of
    it) the counts are exact and equal ``repro``'s."""
    rg, tg, n = _dense_levels()
    got, want, host, _ = _count_both(rg, tg, "l0+", 8, 0, n)
    assert F32_BOUND / 64 < host.max() < F32_BOUND
    assert np.array_equal(got, want) and np.array_equal(got, host.astype(np.float32))


def test_count_paths_above_the_bound():
    """Two levels past the bound (counts near 2^30) the f32 sums round.
    Each count of a level sums at most (in-degree) terms and each total
    (levels + 1) terms; sequential f32 summation of k terms errs by at
    most (k - 1)·2^-24 relative, and a level's error carries into the
    next, so after L levels the relative error is below
    L·(max in-degree + 2)·2^-24.  Port and ``repro`` are held to the host
    DP and to each other at that tolerance; where they differ is listed
    in ROADMAP.md §C as by design."""
    rg, tg, n = _dense_levels()
    n += 2
    got, want, host, _ = _count_both(rg, tg, "l0+", 8, 0, n)
    assert host.max() > 32 * F32_BOUND
    max_in = int(np.bincount(tg.dst, minlength=tg.n_nodes).max())
    rtol = n * (max_in + 2) * 2.0**-24
    np.testing.assert_allclose(got, host, rtol=rtol, atol=0)
    np.testing.assert_allclose(want, host, rtol=rtol, atol=0)
    np.testing.assert_allclose(got, want, rtol=2 * rtol, atol=0)


def test_fused_level_on_counts_reaches_two_to_the_24_minus_1():
    """The fused level on a count frontier (no clamp): a complete 64-node
    digraph at block 16 gives every output block a run of 4 steps, and
    the frontier's first query row sums to 2^24 - 1, which every output
    of that row then holds.  Equal to ``repro``'s level bit for bit; the
    card test holds the CUDA kernel, whose atomics add the 4 steps in no
    fixed order, to this plain version."""
    rg, tg = _dense_graphs(64, 1.1, seed=0)
    rca, tca, rplan, tplan = _plans(rg, tg, "l0", 16)
    rng = np.random.default_rng(4)
    rows = (tplan.n_states + len(tplan.union_members)) * tplan.q_pad
    f = np.zeros((rows, tplan.v_pad), np.float32)
    f[: tplan.q_pad, :64] = rng.integers(0, 2**17, (tplan.q_pad, 64))
    f[0, :64] = rng.multinomial(F32_BOUND - 1, np.full(64, 1 / 64))
    args = (tplan.firsts, tplan.valids, tplan.tile_ids, tplan.f_rows, tplan.f_cols, tplan.o_rows, tplan.o_cols)
    got = fk.fused_level_blocks(
        torch.from_numpy(f), tplan.tiles, *args, tplan.block_size, tplan.q_pad,
        n_out_rows=tplan.n_states * tplan.q_pad, run_ptr=tplan.run_ptr,
    ).numpy()
    want = np.asarray(r_fk.fused_level_blocks(
        jnp.asarray(f), rplan.tiles, rplan.firsts, rplan.valids, rplan.tile_ids, rplan.f_rows,
        rplan.f_cols, rplan.o_rows, rplan.o_cols, rplan.block_size, rplan.q_pad,
        interpret=True, n_out_rows=rplan.n_states * rplan.q_pad,
    ))
    assert np.array_equal(got, want)
    out = got.reshape(tplan.n_states, tplan.q_pad, -1)[1]
    assert (out[0, :64] == F32_BOUND - 1).all() and got.max() == F32_BOUND - 1


@pytest.mark.parametrize(
    "fixpoint", ["reach_fixpoint_levels", "reach_fixpoint_packed_levels", "count_paths_bounded"]
)
def test_fixpoints_refuse_a_uint32_plan(fixpoint):
    g = structure.example_graph()
    ca = paa.compile_query("(a|b)+", g)
    plan = ops.build_level_schedule(ca, ops.stage_graph(g, 8, tile_dtype="uint32", device="cpu"))
    f0 = torch.zeros((plan.n_states * plan.q_pad, plan.v_pad))
    args = (ca.accepting, 2) if fixpoint == "count_paths_bounded" else ()
    with pytest.raises(ValueError, match=f"{fixpoint} requires the f32 tile store"):
        getattr(ops, fixpoint)(plan, f0, *args)


def _witness_both(mesh, rg, tg, expr, starts, backend, block, **kw):
    rpl = r_part.distribute(rg, n_sites=2, replication_rate=0.3, seed=1)
    tpl = partition.distribute(tg, n_sites=2, replication_rate=0.3, seed=1)
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    r_ans, r_costs, r_lev = r_st.s2_execute(
        mesh, rpl, rca, starts, backend=backend, block_size=block, semantics="witness", **kw
    )
    out = strategies.s2_execute(
        tpl, tca, starts, backend=backend, block_size=block, semantics="witness", device="cpu", **kw
    )
    return tca, out, (np.asarray(r_ans), r_costs, np.asarray(r_lev))


@pytest.mark.parametrize(
    "backend, tile_dtype",
    [("frontier_kernel", "f32"), ("frontier_kernel", "uint32"),
     ("frontier_kernel_packed", "f32"), ("frontier_kernel_packed", "uint32")],
)
def test_s2_execute_witness_equals_repro(mesh, backend, tile_dtype):
    """Answers, meters and level planes equal ``repro``'s on 11 starts
    (a short last chunk of 3 on the f32 backend, one short chunk of 11
    lanes on the packed one); a uint32 request restages f32, as
    ``repro``'s does, and levels equal the host BFS."""
    rg, tg = _graphs(60, 200, 3, 9)
    starts = np.random.default_rng(2).choice(60, size=11, replace=False).astype(np.int32)
    ops.BUILD_COUNTERS.clear()
    tca, (acc, costs, lev), (r_acc, r_costs, r_lev) = _witness_both(
        mesh, rg, tg, "l0 (l1|l2^-1)* l0", starts, backend, 16, tile_dtype=tile_dtype
    )
    assert ops.BUILD_COUNTERS["stage_graph"] == 1
    assert acc.dtype == bool and np.array_equal(acc, r_acc)
    assert [dataclasses.astuple(c) for c in costs] == [dataclasses.astuple(c) for c in r_costs]
    assert lev.dtype == np.float32 and lev.shape == (len(starts), tca.n_states, tg.n_nodes)
    assert np.array_equal(lev, r_lev)
    index = paa.HostIndex(tg)
    for i, s in enumerate(starts.tolist()):
        assert np.array_equal(lev[i], witness.host_levels(tca, index, s)), s
        answers = np.zeros(tg.n_nodes, bool)
        for qf in tca.accepting:
            answers |= witness.reached(lev[i, qf])
        assert np.array_equal(answers, acc[i]), s


def test_packed_witness_chunks_past_qpack():
    """More than 256 starts: two packed fixpoints, the second short; its
    levels equal the f32 executor's across the seam (held to ``repro``
    by the test above) and the pairs run's answers and meters are
    unchanged."""
    g = structure.example_graph()
    placement = partition.distribute(g, n_sites=1, replication_rate=0.0, seed=0)
    ca = paa.compile_query("(a|b)+ c^-1", g)
    starts = (np.arange(ops.QPACK + 5) % g.n_nodes).astype(np.int32)
    run = {
        b: strategies.s2_execute(placement, ca, starts, backend=b, block_size=8, semantics="witness",
                                 device="cpu")
        for b in ("frontier_kernel", "frontier_kernel_packed")
    }
    (acc, costs, lev), (f_acc, f_costs, f_lev) = run["frontier_kernel_packed"], run["frontier_kernel"]
    assert (acc == f_acc).all() and costs == f_costs and np.array_equal(lev, f_lev)
    p_acc, p_costs = strategies.s2_execute(
        placement, ca, starts, backend="frontier_kernel_packed", block_size=8, device="cpu"
    )
    assert (p_acc == acc).all() and p_costs == costs


def test_witness_refuses_a_staged_uint32_store_and_a_pairs_step_fn():
    g = structure.example_graph()
    ca = paa.compile_query("(a|b)+", g)
    staged = ops.stage_graph(g, 8, tile_dtype="uint32", device="cpu")
    with pytest.raises(ValueError, match="needs the f32 tile store"):
        strategies.make_s2_step_fn(ca, g.n_nodes, graph=g, block_size=8, semantics="witness",
                                   tile_dtype="uint32", staged=staged, device="cpu")
    placement = partition.distribute(g, n_sites=1, replication_rate=0.0, seed=0)
    pairs = strategies.make_s2_step_fn(ca, g.n_nodes, graph=g, block_size=8, device="cpu")
    with pytest.raises(ValueError, match="step_fn built with it"):
        strategies.s2_execute(placement, ca, np.arange(3), step_fn=pairs, semantics="witness")


@pytest.mark.parametrize("expr", ["l0 (l1|l2^-1)* l0", "(l0|l1)+ l2", "l1^-1 l0+"])
def test_reconstructed_witnesses_equal_repro(expr):
    """Paths walked back from the executor's levels equal ``repro``'s
    walk on its own host levels, pass the label-store check and the
    automaton re-match; a non-answer raises ``ValueError`` in both."""
    rg, tg = _graphs(60, 200, 3, 9)
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    placement = partition.distribute(tg, n_sites=1, replication_rate=0.0, seed=0)
    rng = np.random.default_rng(7)
    starts = rng.choice(60, size=16, replace=False).astype(np.int32)
    acc, _, lev = strategies.s2_execute(placement, tca, starts, block_size=16, semantics="witness",
                                        device="cpu")
    index, r_index = paa.HostIndex(tg), r_paa.HostIndex(rg)
    checked = 0
    for i, s in enumerate(starts.tolist()):
        r_lev = r_w.host_levels(rca, r_index, s)
        for t in np.nonzero(acc[i])[0][:3].tolist():
            path = witness.reconstruct_path(tca, index, lev[i], s, t)
            r_path = r_w.reconstruct_path(rca, r_index, r_lev, s, t)
            assert dataclasses.astuple(path) == dataclasses.astuple(r_path)
            assert path.nodes[0] == s and path.nodes[-1] == t
            assert witness.validate_witness(path, tg) == r_w.validate_witness(r_path, rg) == (True, "")
            assert witness.nfa_accepts_symbols(tca, path.steps)
            assert r_w.nfa_accepts_symbols(rca, r_path.steps)
            checked += 1
        non = np.nonzero(~acc[i])[0]
        if len(non):
            with pytest.raises(ValueError):
                witness.reconstruct_path(tca, index, lev[i], s, int(non[0]))
            with pytest.raises(ValueError):
                r_w.reconstruct_path(rca, r_index, r_lev, s, int(non[0]))
    assert checked >= 8


def test_witness_checks_reject_what_repro_rejects():
    """A path with a hop off the label store, or a label sequence the
    automaton does not accept, fails as ``repro``'s checks fail it; and
    ``repro``'s own non-answer case (tests/test_property.py) raises."""
    rg, tg = _graphs(12, 30, 2, 9)
    rca, tca = r_paa.compile_query("l0 l1", rg), paa.compile_query("l0 l1", tg)
    bad_hop = witness.WitnessPath(nodes=[0, 5], steps=[(1, 0)], states=[0, 1])
    r_bad_hop = r_w.WitnessPath(nodes=[0, 5], steps=[(1, 0)], states=[0, 1])
    assert witness.validate_witness(bad_hop, tg) == r_w.validate_witness(r_bad_hop, rg)
    for steps in ([], [(0, 0)], [(1, 0), (0, 0)], [(0, 0), (1, 0)], [(0, 1), (1, 0)]):
        assert witness.nfa_accepts_symbols(tca, steps) == r_w.nfa_accepts_symbols(rca, steps), steps
    index = paa.HostIndex(tg)
    levels = witness.host_levels(tca, index, 0)
    answers = np.zeros(tg.n_nodes, bool)
    for qf in tca.accepting:
        answers |= witness.reached(levels[qf])
    non = np.nonzero(~answers)[0]
    assert len(non)
    with pytest.raises(ValueError):
        witness.reconstruct_path(tca, index, levels, 0, int(non[0]))
