"""The uint32 bit-plane tile store of the port against ``repro``'s: the
staged words are byte-identical through ``.view(np.uint32)`` (one-shot,
chunked, and the any-label union store when edges repeat), unpack to the
f32 store's tiles, feed the plain f32 level the same counts as
``repro``'s ``_fused_level_kernel_u32`` (interpret mode), and carry the
``frontier_kernel`` executor to the same answers and meters as
``repro``'s on the same store.  Every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import paa as r_paa
from repro.core import strategies as r_st
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.graph import structure as r_struct
from repro.kernels.frontier import frontier as r_frontier
from repro.kernels.frontier import ops as r_ops

from repro_torch import interop
from repro_torch.core import paa, strategies
from repro_torch.graph import generators, partition, structure
from repro_torch.kernels.frontier import frontier, ops, ref

torch.set_num_threads(1)


def _dup_edge_graph(mod):
    """60 nodes whose edge list repeats every edge (some three times)
    under one label and across labels, so the bit-plane scatter and the
    any-label union meet the same (src, dst) bit more than once."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, 60, 150).astype(np.int32)
    dst = rng.integers(0, 60, 150).astype(np.int32)
    lbl = rng.integers(0, 3, 150).astype(np.int32)
    src = np.concatenate([src, src, src[:40]])
    dst = np.concatenate([dst, dst, dst[:40]])
    lbl = np.concatenate([lbl, (lbl + 1) % 3, lbl[:40]])
    return mod.LabeledGraph(60, src, lbl, dst, ["l0", "l1", "l2"])


# (graph factory taking the structure/generators modules, block sizes)
GRAPHS = [
    (lambda s, g: s.example_graph(), (8, 16)),
    (lambda s, g: g.random_labeled_graph(50, 220, 3, seed=7), (8, 16, 32)),
    (lambda s, g: _dup_edge_graph(s), (8, 16, 32)),
]
CASES = [(c, b) for c, (_, blocks) in enumerate(GRAPHS) for b in blocks]


def _graphs(case):
    factory = GRAPHS[case][0]
    return factory(r_struct, r_gen), factory(structure, generators)


def _same_u32_staging(r_staged, t_staged):
    words = np.asarray(r_staged.tiles)
    assert words.dtype == np.uint32 and t_staged.tiles.dtype == torch.int32
    assert words.tobytes() == t_staged.tiles.numpy().view(np.uint32).tobytes()
    assert t_staged.tile_dtype == r_staged.tile_dtype == "uint32"
    assert list(r_staged.offsets) == list(t_staged.offsets)
    for key, (base, rows, cols) in r_staged.offsets.items():
        t_base, t_rows, t_cols = t_staged.offsets[key]
        assert base == t_base and rows.tobytes() == t_rows.tobytes(), key
        assert cols.tobytes() == t_cols.tobytes(), key
    assert r_staged.tile_store_bytes == t_staged.tile_store_bytes
    assert r_staged.slab_bytes() == t_staged.slab_bytes()
    assert r_staged.staging_chunks == t_staged.staging_chunks


@pytest.mark.parametrize("case, block", CASES)
def test_stage_graph_uint32_byte_identical(case, block):
    rg, tg = _graphs(case)
    _same_u32_staging(
        r_ops.stage_graph(rg, block, tile_dtype="uint32"),
        ops.stage_graph(tg, block, tile_dtype="uint32", device="cpu"),
    )


@pytest.mark.parametrize("case", range(len(GRAPHS)))
def test_stage_graph_uint32_chunked_byte_identical(case):
    rg, tg = _graphs(case)
    _same_u32_staging(
        r_ops.stage_graph(rg, 16, chunk_edges=29, tile_dtype="uint32"),
        ops.stage_graph(tg, 16, chunk_edges=29, tile_dtype="uint32", device="cpu"),
    )


@pytest.mark.parametrize("block", [8, 16, 32])
def test_union_store_ors_repeated_edges(block):
    """Every edge of ``_dup_edge_graph`` repeats: the port's union store,
    packed from all edges at once, equals ``repro``'s OR of the label
    stores word for word, and each set bit is an edge."""
    rg, tg = _graphs(2)
    rs = r_ops.stage_graph(rg, block, tile_dtype="uint32")
    ts = ops.stage_graph(tg, block, tile_dtype="uint32", device="cpu")
    words = ts.tiles.numpy().view(np.uint32)
    for direction in (ops.FWD, ops.INV):
        base, rows, cols = ts.offsets[(direction, ops.ANY_LABEL)]
        r_base, _, _ = rs.offsets[(direction, r_ops.ANY_LABEL)]
        got = words[base : base + len(rows)]
        assert got.tobytes() == np.asarray(rs.tiles)[r_base : r_base + len(rows)].tobytes()
        dense = ref.unpack_tiles(got, block)
        s, d = (tg.src, tg.dst) if direction == ops.FWD else (tg.dst, tg.src)
        want = np.zeros_like(dense)
        idx = {(int(r), int(c)): i for i, (r, c) in enumerate(zip(rows, cols))}
        for a, b in zip(s, d):
            want[idx[(a // block, b // block)], a % block, b % block] = 1.0
        assert dense.tobytes() == want.tobytes(), direction


@pytest.mark.parametrize("case, block", CASES)
def test_uint32_store_unpacks_to_the_f32_store(case, block):
    _, tg = _graphs(case)
    s32 = ops.stage_graph(tg, block, device="cpu")
    su = ops.stage_graph(tg, block, tile_dtype="uint32", device="cpu")
    assert list(s32.offsets) == list(su.offsets)
    for key, (base, rows, cols) in s32.offsets.items():
        assert (base, rows.tobytes(), cols.tobytes()) == (
            su.offsets[key][0], su.offsets[key][1].tobytes(), su.offsets[key][2].tobytes()
        )
    assert torch.equal(frontier.unpack_tile_bits(su.tiles, block), s32.tiles)
    # B x ceil(B/32) words against B x B floats per tile
    assert su.tile_store_bytes == s32.tile_store_bytes * ref.tile_words(block) // block


@pytest.mark.parametrize("case, block", [(1, 8), (1, 16), (2, 32)])
def test_plain_level_on_uint32_tiles_equals_pallas_kernel(case, block):
    """fused_level_blocks_plain on the bit-plane store == repro's
    fused_level_blocks(interpret=True), which dispatches to
    ``_fused_level_kernel_u32``, on the same frontier and schedule."""
    rg, tg = _graphs(case)
    rs = r_ops.stage_graph(rg, block, tile_dtype="uint32")
    ts = interop.staged_from_numpy(rg.n_nodes, block, np.asarray(rs.tiles), rs.offsets, "cpu")
    assert ts.tile_dtype == "uint32" and ts.tiles.dtype == torch.int32
    rng = np.random.default_rng(block)
    for expr in ("l0 (l1|l2)* l0", "l0* .^-1"):
        rca = r_paa.compile_query(expr, rg)
        rp = r_ops.build_level_schedule(rca, rs)
        tp = ops.build_level_schedule(paa.compile_query(expr, tg), ts)
        assert tp.tile_dtype == rp.tile_dtype == "uint32"
        n_rows = rca.n_states + len(rp.union_members)
        f = (rng.random((n_rows * 8, rp.v_pad)) < 0.3).astype(np.float32)
        f[:, rg.n_nodes :] = 0.0
        n_out = rca.n_states * 8
        want = np.asarray(r_frontier.fused_level_blocks(
            jnp.asarray(f), rp.tiles, rp.firsts, rp.valids, rp.tile_ids, rp.f_rows,
            rp.f_cols, rp.o_rows, rp.o_cols, block, 8, interpret=True, n_out_rows=n_out,
        ))
        got = frontier.fused_level_blocks_plain(
            torch.from_numpy(f), tp.tiles, tp.firsts, tp.valids, tp.tile_ids, tp.f_rows,
            tp.f_cols, tp.o_rows, tp.o_cols, block, 8, n_out_rows=n_out,
        )
        assert got.numpy().tobytes() == want.tobytes(), expr


@pytest.mark.parametrize("case, block", [(0, 8), (1, 16)])
def test_f32_fixpoint_on_uint32_store_bit_exact(case, block):
    rg, tg = _graphs(case)
    rs = r_ops.stage_graph(rg, block, tile_dtype="uint32")
    ts = ops.stage_graph(tg, block, tile_dtype="uint32", device="cpu")
    expr = "(a|b)+" if case == 0 else "l0 (l1|l2)* l0"
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    rp, tp = r_ops.build_level_schedule(rca, rs), ops.build_level_schedule(tca, ts)
    f0 = np.zeros((rca.n_states, 8, rp.v_pad), np.float32)
    f0[rca.start, np.arange(8), np.arange(8) * 5 % rg.n_nodes] = 1.0
    f0 = f0.reshape(-1, rp.v_pad)
    want = np.asarray(r_ops.reach_fixpoint(rp, jnp.asarray(f0), interpret=True))
    got = ops.reach_fixpoint(tp, torch.from_numpy(f0))
    assert got.numpy().tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("expr", ["a c (a|b)", "(a|b)+", "a* b^-1"])
def test_f32_executor_on_uint32_store_equals_repro(mesh, expr):
    """``frontier_kernel`` at ``tile_dtype="uint32"``: answers and the
    three §4.2 meters equal ``repro``'s executor on its uint32 store and
    the port's own on the f32 store."""
    rg = r_gen.random_labeled_graph(120, 420, 3, seed=4)
    rg = r_struct.LabeledGraph(rg.n_nodes, rg.src, rg.lbl, rg.dst, ["a", "b", "c"])
    tg = structure.LabeledGraph(rg.n_nodes, rg.src, rg.lbl, rg.dst, ["a", "b", "c"])
    rpl = r_part.distribute(rg, n_sites=4, replication_rate=0.5, seed=2)
    tpl = partition.distribute(tg, n_sites=4, replication_rate=0.5, seed=2)
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    starts = np.random.default_rng(6).choice(rg.n_nodes, size=19, replace=False).astype(np.int32)
    r_ans, r_costs = r_st.s2_execute(
        mesh, rpl, rca, starts, backend="frontier_kernel", block_size=16, tile_dtype="uint32"
    )
    t_ans, t_costs = strategies.s2_execute(
        tpl, tca, starts, backend="frontier_kernel", block_size=16, tile_dtype="uint32",
        device="cpu",
    )
    f_ans, f_costs = strategies.s2_execute(
        tpl, tca, starts, backend="frontier_kernel", block_size=16, device="cpu"
    )
    assert (t_ans == np.asarray(r_ans)).all() and (t_ans == f_ans).all(), expr
    for rc, tc, fc in zip(r_costs, t_costs, f_costs, strict=True):
        assert dataclasses.astuple(rc) == dataclasses.astuple(tc) == dataclasses.astuple(fc)


def test_executor_refuses_a_staged_store_of_another_dtype():
    g = structure.example_graph()
    ca = paa.compile_query("a b", g)
    staged = ops.stage_graph(g, 8, device="cpu")
    with pytest.raises(ValueError, match="tile_dtype"):
        strategies.make_s2_step_fn(
            ca, g.n_nodes, graph=g, block_size=8, tile_dtype="uint32", staged=staged
        )
    with pytest.raises(ValueError, match="tile_dtype"):
        ops.stage_graph(g, 8, tile_dtype="u8", device="cpu")
    with pytest.raises(ValueError, match="unknown tile_dtype"):
        strategies.make_s2_step_fn(ca, g.n_nodes, graph=g, tile_dtype="u8", device="cpu")
