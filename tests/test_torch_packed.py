"""The lane-packed path of the port against ``repro``'s: lane packing,
the packed level's plain version against ``repro``'s
``packed_level_blocks`` in interpret mode on both tile stores, the packed
level and fixpoint for Q ∈ {1, 8, 33, 250, 256} with the unused lanes
zero, ``multi_query_reach_packed`` across the 256 → 257 seam, and the
``frontier_kernel_packed`` executor on both stores, answers and all three
§4.2 meters.  Lane words are int32 in the port and uint32 in ``repro``,
compared through ``.view(np.uint32)``; every comparison is exact."""

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
from repro_torch.kernels.frontier import frontier, ops

torch.set_num_threads(1)

# (graph factory taking the structure/generators modules, block, query)
CASES = [
    (lambda s, g: s.example_graph(), 8, "(a|b)+ .^-1"),
    (lambda s, g: g.random_labeled_graph(50, 220, 3, seed=7), 16, "l0 (l1|l2)* l0"),
    (lambda s, g: g.random_labeled_graph(70, 300, 3, seed=8), 32, "l0* .^-1"),
]


def _carried(case, tile_dtype):
    """``repro``'s graph, staging and plan, and the same objects carried
    into the port through ``interop``."""
    factory, block, expr = CASES[case]
    rg = factory(r_struct, r_gen)
    tg = interop.graph_from_numpy(rg.n_nodes, rg.src, rg.lbl, rg.dst, rg.labels)
    rs = r_ops.stage_graph(rg, block, tile_dtype=tile_dtype)
    ts = interop.staged_from_numpy(rg.n_nodes, block, np.asarray(rs.tiles), rs.offsets, "cpu")
    rca = r_paa.compile_query(expr, rg)
    rp = r_ops.build_level_schedule(rca, rs)
    tp = interop.plan_from_numpy(
        ts, rca.n_states,
        *(np.asarray(getattr(rp, f)) for f in
          ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols")),
        union_members=rp.union_members,
    )
    return rg, tg, rca, paa.compile_query(expr, tg), rs, ts, rp, tp


def _random_words(rng, n_rows, v_pad, n_nodes):
    """Random lane words over all 32 bits (bit 31, int32's sign bit,
    included), padded node columns zeroed: (n_rows, v_pad) uint32."""
    w = rng.integers(0, 2**32, size=(n_rows, v_pad), dtype=np.uint64).astype(np.uint32)
    w &= rng.integers(0, 2**32, size=w.shape, dtype=np.uint64).astype(np.uint32)  # ~1/4 set
    w[:, n_nodes:] = 0
    return w


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n_lanes", [1, 8, 33, 250, 256])
def test_lane_packing_equals_repro(n_lanes):
    rng = np.random.default_rng(n_lanes)
    masks = (rng.random((n_lanes, 45)) < 0.3).astype(np.float32)
    words = ops.pack_lane_masks(masks)
    assert words.dtype == np.uint32 and words.tobytes() == r_ops.pack_lane_masks(masks).tobytes()
    assert (ops.unpack_lane_words(words, n_lanes) == r_ops.unpack_lane_words(words, n_lanes)).all()
    assert (ops.unpack_lane_words(words.view(np.int32), n_lanes) == (masks != 0)).all()
    lanes = frontier.unpack_lane_rows(torch.from_numpy(words.view(np.int32)))
    assert (lanes[:n_lanes].numpy() == (masks != 0)).all() and not lanes[n_lanes:].any()
    assert _u32(frontier.pack_lane_rows(lanes)).tobytes() == words.tobytes()
    plan = ops.build_level_schedule(
        paa.compile_query("a b", structure.example_graph()),
        ops.stage_graph(structure.example_graph(), 16, device="cpu"),
    )
    starts = (rng.random((n_lanes, 9)) < 0.3).astype(np.float32)
    got = ops.stack_start_masks_packed(plan, 1, starts)
    assert got.tobytes() == r_ops.stack_start_masks_packed(plan, 1, starts).tobytes()
    nodes = rng.integers(0, 9, n_lanes)  # repeats put several lanes on one node
    one_hot = np.zeros((n_lanes, 9), np.float32)
    one_hot[np.arange(n_lanes), nodes] = 1.0
    got = ops.stack_start_nodes_packed(plan, 2, nodes)
    assert got.tobytes() == r_ops.stack_start_masks_packed(plan, 2, one_hot).tobytes()
    with pytest.raises(ValueError, match="QPACK"):
        ops.pack_lane_masks(np.zeros((257, 4)))
    with pytest.raises(ValueError, match="QPACK"):
        ops.stack_start_nodes_packed(plan, 0, np.zeros(257, np.int64))


@pytest.mark.parametrize("tile_dtype", ["f32", "uint32"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_packed_level_equals_pallas_kernel(case, tile_dtype):
    """packed_level_blocks_plain == repro's packed_level_blocks(
    interpret=True) (``_packed_level_kernel``, or ``_u32`` on bit-plane
    tiles) on random words over all 32 bits, union rows included."""
    rg, _, rca, _, _, _, rp, tp = _carried(case, tile_dtype)
    rng = np.random.default_rng(10 + case)
    n_rows = (rca.n_states + len(rp.union_members)) * rp.q_pad
    f = _random_words(rng, n_rows, rp.v_pad, rg.n_nodes)
    n_out = rca.n_states * rp.q_pad
    want = np.asarray(r_frontier.packed_level_blocks(
        jnp.asarray(f), rp.tiles, rp.firsts, rp.valids, rp.tile_ids, rp.f_rows, rp.f_cols,
        rp.o_rows, rp.o_cols, rp.block_size, rp.q_pad, interpret=True, n_out_rows=n_out,
    ))
    args = (
        torch.from_numpy(f.view(np.int32)), tp.tiles, tp.firsts, tp.valids, tp.tile_ids,
        tp.f_rows, tp.f_cols, tp.o_rows, tp.o_cols, tp.block_size, tp.q_pad,
    )
    got = frontier.packed_level_blocks_plain(*args, n_out_rows=n_out)
    assert want.dtype == np.uint32 and _u32(got).tobytes() == want.tobytes()
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    before = frontier.launch_counts()
    same = frontier.packed_level_blocks(*args, n_out_rows=n_out, run_ptr=tp.run_ptr)
    assert torch.equal(same, got) and frontier.launch_counts() == before


@pytest.mark.parametrize("case", range(len(CASES)))
def test_extend_frontier_packed_equals_repro(case):
    rg, _, rca, _, _, _, rp, _ = _carried(case, "f32")
    f = _random_words(np.random.default_rng(case), rca.n_states * 8, rp.v_pad, rg.n_nodes)
    want = np.asarray(r_ops.extend_frontier_packed(jnp.asarray(f), rp.union_members, rca.n_states, 8))
    got = ops.extend_frontier_packed(
        torch.from_numpy(f.view(np.int32)), rp.union_members, rca.n_states, 8
    )
    assert _u32(got).tobytes() == want.tobytes()


def _start_words(rng, plan, start, n_lanes, n_nodes):
    masks = (rng.random((n_lanes, n_nodes)) < 0.1).astype(np.float32)
    return masks, ops.stack_start_masks_packed(plan, start, masks)


@pytest.mark.parametrize("n_lanes", [1, 8, 33, 250, 256])
@pytest.mark.parametrize("tile_dtype", ["f32", "uint32"])
def test_packed_level_and_fixpoint_bit_exact(tile_dtype, n_lanes):
    """One packed level and the whole packed fixpoint equal ``repro``'s
    word for word, and lanes ≥ Q stay zero in every state throughout:
    whole word rows past ⌈Q/32⌉, and bits ≥ Q mod 32 of the last one."""
    rg, _, rca, _, _, _, rp, tp = _carried(1, tile_dtype)
    rng = np.random.default_rng(n_lanes)
    masks = rng.random((rca.n_states, n_lanes, rp.v_pad)) < 0.3
    masks[:, :, rg.n_nodes :] = False  # padded node columns stay empty
    f = np.stack([ops.pack_lane_masks(m) for m in masks]).reshape(-1, rp.v_pad)
    want = np.asarray(r_ops.expand_level_packed(rp, jnp.asarray(f), interpret=True))
    got = ops.expand_level_packed(tp, torch.from_numpy(f.view(np.int32)))
    assert _u32(got).tobytes() == want.tobytes()

    _, f0 = _start_words(rng, tp, rca.start, n_lanes, rg.n_nodes)
    want = np.asarray(r_ops.reach_fixpoint_packed(rp, jnp.asarray(f0), interpret=True))
    got = _u32(ops.reach_fixpoint_packed(tp, torch.from_numpy(f0.view(np.int32))))
    assert got.tobytes() == want.tobytes()
    visited = got.reshape(rca.n_states, 8, rp.v_pad)
    full_rows = -(-n_lanes // 32)
    assert (visited[:, full_rows:] == 0).all()
    if n_lanes % 32:
        assert (visited[:, full_rows - 1] >> np.uint32(n_lanes % 32) == 0).all()


@pytest.mark.parametrize("tile_dtype", ["f32", "uint32"])
def test_multi_query_reach_packed_across_the_seam(tile_dtype):
    """257 queries take two chunks of 256 lanes: answers equal ``repro``'s
    packed reach, the port's f32 reach and the host PAA's."""
    rg, tg, rca, tca, rs, ts, rp, tp = _carried(1, tile_dtype)
    n_q = ops.QPACK + 1
    starts = np.random.default_rng(2).integers(0, rg.n_nodes, n_q)
    masks = np.zeros((n_q, rg.n_nodes), np.float32)
    masks[np.arange(n_q), starts] = 1.0
    got = ops.multi_query_reach_packed(tca, ts, masks, plan=tp)
    want = r_ops.multi_query_reach_packed(rca, rs, masks, interpret=True, plan=rp)
    assert got.dtype == bool and got.shape == (n_q, rg.n_nodes) and (got == want).all()
    assert (got == ops.multi_query_reach(tca, ts, masks, plan=tp)).all()
    index = r_paa.HostIndex(rg)
    for s in np.unique(starts[[0, 255, 256]]):
        answers = r_paa.run_instrumented(rca, index, int(s)).answers
        for i in np.nonzero(starts == s)[0]:
            assert set(np.nonzero(got[i])[0].tolist()) == answers


def test_packed_fixpoint_counts_one_level_and_sync_per_expansion():
    rg, _, rca, _, _, _, _, tp = _carried(0, "f32")
    _, f0 = _start_words(np.random.default_rng(0), tp, rca.start, 40, rg.n_nodes)
    ops.FIXPOINT_COUNTERS.clear()
    ops.reach_fixpoint_packed(tp, torch.from_numpy(f0.view(np.int32)), max_levels=3)
    assert 1 <= ops.FIXPOINT_COUNTERS["levels"] <= 3
    assert ops.FIXPOINT_COUNTERS["host_syncs"] in (
        ops.FIXPOINT_COUNTERS["levels"], ops.FIXPOINT_COUNTERS["levels"] + 1
    )


def test_a_frontier_holding_only_bit_31_is_not_empty():
    f = torch.zeros((8, 16), dtype=torch.int32)
    f[3, 5] = -(2**31)  # lane 127 of node 5: the sign bit alone
    assert ops.frontier_nonempty(f)
    assert not ops.frontier_nonempty(torch.zeros_like(f))


@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("tile_dtype", ["f32", "uint32"])
@pytest.mark.parametrize("expr", ["(l0|l1)* l2 .^-1", "l0 (l1|l2)* l0", ". l1"])
def test_packed_executor_equals_repro(mesh, expr, tile_dtype):
    """``frontier_kernel_packed`` through ``s2_execute`` at K > 1: answers
    and every §4.2 meter equal ``repro``'s packed executor on the same
    store and the port's f32 executor, start for start, and the host
    meter after rounding the ×K ÷K unicast symbols."""
    rg = r_gen.random_labeled_graph(40, 170, 4, seed=3)
    tg = generators.random_labeled_graph(40, 170, 4, seed=3)
    rpl = r_part.distribute(rg, n_sites=4, replication_rate=0.5, seed=2)
    tpl = partition.distribute(tg, n_sites=4, replication_rate=0.5, seed=2)
    assert tpl.replication_factor > 1.0
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    starts = np.arange(0, rg.n_nodes, 3, dtype=np.int32)
    kw = {"block_size": 8, "tile_dtype": tile_dtype}
    r_ans, r_costs = r_st.s2_execute(mesh, rpl, rca, starts, backend="frontier_kernel_packed", **kw)
    t_ans, t_costs = strategies.s2_execute(
        tpl, tca, starts, backend="frontier_kernel_packed", device="cpu", **kw
    )
    f_ans, f_costs = strategies.s2_execute(tpl, tca, starts, backend="frontier_kernel", device="cpu", **kw)
    assert t_ans.dtype == bool and (t_ans == np.asarray(r_ans)).all() and (t_ans == f_ans).all()
    index = paa.HostIndex(tg)
    for s, rc, tc, fc in zip(starts.tolist(), r_costs, t_costs, f_costs, strict=True):
        assert dataclasses.astuple(rc) == dataclasses.astuple(tc) == dataclasses.astuple(fc), s
        host = paa.run_instrumented(tca, index, s)
        assert (tc.broadcast_symbols, tc.n_broadcasts) == (host.q_bc, host.n_broadcasts), s
        assert round(tc.unicast_symbols) == host.d_s2, s


def test_packed_executor_chunks_past_qpack():
    """More than 256 starts split into two packed fixpoints; the short
    last chunk's unused lanes stay empty and its answers and meters equal
    the f32 executor's across the seam."""
    g = structure.example_graph()
    placement = partition.distribute(g, n_sites=1, replication_rate=0.0, seed=0)
    ca = paa.compile_query("(a|b)+", g)
    starts = (np.arange(ops.QPACK + 5) % g.n_nodes).astype(np.int32)
    ops.FIXPOINT_COUNTERS.clear()
    acc, costs = strategies.s2_execute(
        placement, ca, starts, backend="frontier_kernel_packed", block_size=8, device="cpu"
    )
    packed_levels = ops.FIXPOINT_COUNTERS["levels"]
    f_acc, f_costs = strategies.s2_execute(placement, ca, starts, block_size=8, device="cpu")
    assert len(costs) == len(starts) and (acc == f_acc).all() and costs == f_costs
    # two fixpoints for 261 starts against 33 chunks of 8 on the f32 path
    assert 0 < packed_levels < ops.FIXPOINT_COUNTERS["levels"] - packed_levels
