"""The fused level and the fixpoints of the port against ``repro``'s,
on the tiles and schedules ``repro`` built (carried over with
``repro_torch.interop``).  ``repro``'s Pallas kernel runs in interpret
mode, as its own tests run it.  Every comparison is exact: operands are
{0,1} and every sum is an integer below 2^24, so f32 is exact in any
order on both sides."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import paa as r_paa
from repro.graph import generators as r_gen
from repro.graph import structure as r_struct
from repro.kernels.frontier import frontier as r_frontier
from repro.kernels.frontier import ops as r_ops
from repro.kernels.frontier import ref as r_ref

from repro_torch import interop
from repro_torch.core import paa
from repro_torch.graph import generators, structure
from repro_torch.kernels.frontier import frontier, ops, ref

torch.set_num_threads(1)

CASES = [
    # (graph factory taking the structure/generators modules, block, queries)
    (lambda s, g: s.example_graph(), 8, ["(a|b)+", "a* b^-1"]),
    (lambda s, g: g.random_labeled_graph(50, 220, 3, seed=7), 16, ["l0 (l1|l2)* l0", "l0* .^-1"]),
]


def _carried(case):
    """``repro``'s graph, staging and plans, and the same objects carried
    into the port through ``interop``."""
    factory, block, queries = CASES[case]
    rg = factory(r_struct, r_gen)
    tg = interop.graph_from_numpy(rg.n_nodes, rg.src, rg.lbl, rg.dst, rg.labels)
    rs = r_ops.stage_graph(rg, block)
    ts = interop.staged_from_numpy(rg.n_nodes, block, np.asarray(rs.tiles), rs.offsets, "cpu")
    out = []
    for expr in queries:
        rca = r_paa.compile_query(expr, rg)
        rp = r_ops.build_level_schedule(rca, rs)
        tp = interop.plan_from_numpy(
            ts, rca.n_states,
            *(np.asarray(getattr(rp, f)) for f in
              ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols")),
            union_members=rp.union_members,
        )
        out.append((expr, rca, paa.compile_query(expr, tg), rp, tp))
    return rg, tg, rs, ts, out


def _random_frontier(rng, n_rows, q_pad, v_pad, n_nodes):
    f = (rng.random((n_rows, q_pad, v_pad)) < 0.3).astype(np.float32)
    f[:, :, n_nodes:] = 0.0
    return f.reshape(n_rows * q_pad, v_pad)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_level_equals_pallas_kernel(case):
    """fused_level_blocks_plain == repro's fused_level_blocks(interpret=True)
    on the same frontier (union rows included), tiles and schedule."""
    rg, _, rs, ts, plans = _carried(case)
    rng = np.random.default_rng(case)
    for expr, rca, _, rp, tp in plans:
        n_rows = rca.n_states + len(rp.union_members)
        f = _random_frontier(rng, n_rows, rp.q_pad, rp.v_pad, rg.n_nodes)
        want = np.asarray(r_frontier.fused_level_blocks(
            jnp.asarray(f), rp.tiles, rp.firsts, rp.valids, rp.tile_ids, rp.f_rows,
            rp.f_cols, rp.o_rows, rp.o_cols, rp.block_size, rp.q_pad,
            interpret=True, n_out_rows=rca.n_states * rp.q_pad,
        ))
        got = frontier.fused_level_blocks_plain(
            torch.from_numpy(f), tp.tiles, tp.firsts, tp.valids, tp.tile_ids, tp.f_rows,
            tp.f_cols, tp.o_rows, tp.o_cols, tp.block_size, tp.q_pad,
            n_out_rows=rca.n_states * tp.q_pad,
        )
        assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes(), expr


@pytest.mark.parametrize("case", range(len(CASES)))
def test_expand_level_and_fixpoint_bit_exact(case):
    rg, _, _, _, plans = _carried(case)
    rng = np.random.default_rng(10 + case)
    for expr, rca, _, rp, tp in plans:
        f = _random_frontier(rng, rca.n_states, rp.q_pad, rp.v_pad, rg.n_nodes)
        want = np.asarray(r_ops.expand_level_fused(rp, jnp.asarray(f), interpret=True))
        got = ops.expand_level_fused(tp, torch.from_numpy(f))
        assert got.numpy().tobytes() == want.tobytes(), expr
        starts = (rng.random((1, rp.q_pad, rp.v_pad)) < 0.05).astype(np.float32)
        f0 = np.zeros((rca.n_states, rp.q_pad, rp.v_pad), np.float32)
        f0[rca.start] = starts[0]
        f0[:, :, rg.n_nodes:] = 0.0
        f0 = f0.reshape(-1, rp.v_pad)
        want = np.asarray(r_ops.reach_fixpoint(rp, jnp.asarray(f0), interpret=True))
        got = ops.reach_fixpoint(tp, torch.from_numpy(f0))
        assert got.numpy().tobytes() == want.tobytes(), expr


@pytest.mark.parametrize("case", range(len(CASES)))
def test_expand_level_equals_dense_oracle(case):
    """The port's fused level on its own staging equals the dense numpy
    oracle ``fused_level_ref``, the port's and ``repro``'s alike."""
    factory, block, queries = CASES[case]
    rg, tg = factory(r_struct, r_gen), factory(structure, generators)
    ts = ops.stage_graph(tg, block, device="cpu")
    rng = np.random.default_rng(20 + case)
    for expr in queries:
        tca = paa.compile_query(expr, tg)
        plan = ops.build_level_schedule(tca, ts)
        f = _random_frontier(rng, tca.n_states, plan.q_pad, plan.v_pad, tg.n_nodes)
        f3 = f.reshape(tca.n_states, plan.q_pad, plan.v_pad)
        want = ref.fused_level_ref(tca, tg, f3)
        assert want.tobytes() == r_ref.fused_level_ref(r_paa.compile_query(expr, rg), rg, f3).tobytes()
        got = ops.expand_level_fused(plan, torch.from_numpy(f)).numpy()
        assert got.tobytes() == want.reshape(f.shape).tobytes(), expr


@pytest.mark.parametrize("n_queries", [1, 3, 8, 11])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_multi_query_reach_bit_exact(case, n_queries):
    """Q stacked queries (11 spans two chunks of 8) on the port's own
    staging and schedule: answers equal repro's and the host PAA's."""
    factory, block, queries = CASES[case]
    rg, tg = factory(r_struct, r_gen), factory(structure, generators)
    rs, ts = r_ops.stage_graph(rg, block), ops.stage_graph(tg, block, device="cpu")
    rng = np.random.default_rng(100 * case + n_queries)
    starts = rng.choice(rg.n_nodes, size=n_queries, replace=n_queries > rg.n_nodes)
    masks = np.zeros((n_queries, rg.n_nodes), np.float32)
    masks[np.arange(n_queries), starts] = 1.0
    index = r_paa.HostIndex(rg)
    expr = queries[0]
    rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
    r_plan = r_ops.build_level_schedule(rca, rs)
    want = r_ops.multi_query_reach(rca, rs, masks, interpret=True, plan=r_plan)
    got = ops.multi_query_reach(tca, ts, masks)
    assert got.dtype == bool and (got == want).all()
    for i, s in enumerate(starts):
        assert set(np.nonzero(got[i])[0].tolist()) == r_paa.run_instrumented(rca, index, int(s)).answers
    one = ops.multi_source_reach(tca, ts, masks[0])
    assert (one == want[0]).all()


def test_cpu_calls_leave_launches_unchanged():
    _, _, _, _, plans = _carried(0)
    _, rca, _, rp, tp = plans[0]
    before = frontier.LAUNCHES
    f0 = torch.zeros((rca.n_states * tp.q_pad, tp.v_pad))
    f0[rca.start * tp.q_pad, 0] = 1.0
    ops.reach_fixpoint(tp, f0)
    frontier.fused_level_blocks(
        torch.zeros(((rca.n_states + len(rp.union_members)) * tp.q_pad, tp.v_pad)),
        tp.tiles, tp.firsts, tp.valids, tp.tile_ids, tp.f_rows, tp.f_cols, tp.o_rows,
        tp.o_cols, tp.block_size, tp.q_pad, run_ptr=tp.run_ptr,
        n_out_rows=rca.n_states * tp.q_pad,
    )
    assert frontier.LAUNCHES == before


def test_fixpoint_counts_one_level_and_sync_per_expansion():
    _, _, _, _, plans = _carried(0)
    _, rca, _, _, tp = plans[0]
    f0 = torch.zeros((rca.n_states * tp.q_pad, tp.v_pad))
    f0[rca.start * tp.q_pad, 0] = 1.0
    ops.FIXPOINT_COUNTERS.clear()
    ops.reach_fixpoint(tp, f0, max_levels=3)
    assert ops.FIXPOINT_COUNTERS["levels"] <= 3
    # one sync per loop test: each level's, plus the one that ends the loop
    assert ops.FIXPOINT_COUNTERS["host_syncs"] in (
        ops.FIXPOINT_COUNTERS["levels"], ops.FIXPOINT_COUNTERS["levels"] + 1
    )


def test_entry_points_without_device_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = structure.example_graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        structure.to_device_graph(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.staged_from_numpy(9, 8, np.zeros((1, 8, 8), np.float32), {})


def test_wrapper_refuses_other_devices():
    f = torch.zeros((8, 8), device="meta")
    ids = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        frontier.fused_level_blocks(
            f, torch.zeros((1, 8, 8), device="meta"), ids, ids, ids, ids, ids, ids, ids, 8, 8,
            run_ptr=ids,
        )
