"""Kernel B3's work list (``FusedLevelPlan.work``, ``ops.level_work``)
against the Stage-B schedule it cuts, and the level it drives against
``repro``'s.  The chunks must partition the valid steps of each run, in
step order, none crossing a run or holding more than ``WORK_CHUNK``
steps, and cover steps get none.  The plain level summed chunk by chunk
into a zeroed output, as B3 adds its chunks on the card, must equal
``fused_level_blocks_plain`` and ``repro``'s ``fused_level_blocks`` on
uint32 tiles (interpret mode) bit for bit: {0,1} operands and integer
sums below 2^24 are exact in f32 in any order.  Graphs: the SWEEP of
``tests/test_torch_stage.py`` and a 5,000-node Alibaba twin at block
128, whose q1, q9 and q12 plans have runs of up to 24 valid steps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import paa as r_paa
from repro.graph import generators as r_gen
from repro.graph import structure as r_struct
from repro.kernels.frontier import frontier as r_frontier
from repro.kernels.frontier import ops as r_ops

from repro_torch import interop
from repro_torch.core import paa
from repro_torch.graph import generators, structure
from repro_torch.kernels.frontier import frontier, ops

from test_torch_stage import SWEEP

torch.set_num_threads(1)

TWIN_QUERIES = ("q1", "q9", "q12")
SCHEDULE_FIELDS = ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols")
# (case, query, block): every SWEEP query at its block, and the twin's
PLANS = [(c, e, SWEEP[c][1]) for c in range(len(SWEEP)) for e in SWEEP[c][2]] + [
    ("twin", q, 128) for q in TWIN_QUERIES
]


def _twin(mod):
    return mod.alibaba_like(n_nodes=5000, n_edges=34000)


_STAGED: dict = {}


def _plans(case, expr, block):
    """repro's uint32 store and plan, and the port's plan over the same
    store carried in (``staged_from_numpy``) and built by Stage B."""
    if (case, block) not in _STAGED:
        if case == "twin":
            rg, tg = _twin(r_gen), _twin(generators)
        else:
            rg, tg = SWEEP[case][0](r_struct, r_gen), SWEEP[case][0](structure, generators)
        rs = r_ops.stage_graph(rg, block, tile_dtype="uint32")
        ts = interop.staged_from_numpy(rg.n_nodes, block, np.asarray(rs.tiles), rs.offsets, "cpu")
        _STAGED[case, block] = (rg, tg, rs, ts)
    rg, tg, rs, ts = _STAGED[case, block]
    if case == "twin":
        expr = generators.TABLE2_QUERIES[expr]
    rca = r_paa.compile_query(expr, rg)
    return rca, r_ops.build_level_schedule(rca, rs), ops.build_level_schedule(paa.compile_query(expr, tg), ts)


def _level_by_chunks(plan, f: torch.Tensor, n_out: int) -> torch.Tensor:
    """The plain level as B3 runs it: each chunk's steps summed into an
    8 × B block, added into a zeroed output."""
    b, v_pad = plan.block_size, plan.v_pad
    out = torch.zeros((n_out, v_pad))
    ids = {k: getattr(plan, k).numpy() for k in SCHEDULE_FIELDS[2:]}
    for row in plan.work.numpy():
        steps = row[row >= 0]
        acc = torch.zeros((8, b))
        for i in steps:
            fr, fc = ids["f_rows"][i], ids["f_cols"][i]
            tile = frontier.unpack_tile_bits(plan.tiles[ids["tile_ids"][i] : ids["tile_ids"][i] + 1], b)[0]
            acc += f[fr * 8 : fr * 8 + 8, fc * b : fc * b + b] @ tile
        o_r, o_c = ids["o_rows"][steps[0]], ids["o_cols"][steps[0]]
        out[o_r * 8 : o_r * 8 + 8, o_c * b : o_c * b + b] += acc
    return out


@pytest.mark.parametrize("case, expr, block", PLANS)
def test_work_list_partitions_the_valid_steps_of_each_run(case, expr, block):
    _, _, plan = _plans(case, expr, block)
    work = plan.work.numpy()
    c = ops.WORK_CHUNK
    assert plan.work.dtype == torch.int32 and work.shape[1] == c
    valids, ptr = plan.valids.numpy(), plan.run_ptr.numpy()
    run_of = np.searchsorted(ptr, np.arange(len(valids)), side="right") - 1
    filled = work >= 0
    # each chunk is nonempty and filled from its start
    assert filled[:, 0].all() and (np.diff(filled.astype(np.int8), axis=1) <= 0).all()
    # the chunks, in order, are exactly the valid steps, in step order
    assert np.array_equal(work[filled], np.nonzero(valids)[0])
    # no chunk crosses a run, and a run's chunks are all full but its last
    runs = [set(run_of[row[row >= 0]].tolist()) for row in work]
    assert all(len(r) == 1 for r in runs)
    chunk_run = np.array([r.pop() for r in runs])
    for k in np.unique(chunk_run):
        n_valid = int(valids[ptr[k] : ptr[k + 1]].sum())
        sizes = filled[chunk_run == k].sum(axis=1)
        assert len(sizes) == -(-n_valid // c) and (sizes[:-1] == c).all()
    # cover-only output blocks have no chunk
    cover_only = {k for k in range(len(ptr) - 1) if valids[ptr[k] : ptr[k + 1]].sum() == 0}
    assert not cover_only & set(chunk_run.tolist())
    if case == "twin":
        assert np.diff(ptr).max() > 2 * c  # runs longer than two chunks


@pytest.mark.parametrize("case, expr, block", PLANS)
def test_level_summed_by_chunks_equals_plain_and_repro(case, expr, block):
    rca, rp, tp = _plans(case, expr, block)
    n_rows = rca.n_states + len(rp.union_members)
    f = (np.random.default_rng(block).random((n_rows * 8, rp.v_pad)) < 0.3).astype(np.float32)
    f[:, tp.n_nodes :] = 0.0
    n_out = rca.n_states * 8
    want = np.asarray(r_frontier.fused_level_blocks(
        jnp.asarray(f), rp.tiles, rp.firsts, rp.valids, rp.tile_ids, rp.f_rows,
        rp.f_cols, rp.o_rows, rp.o_cols, block, 8, interpret=True, n_out_rows=n_out,
    ))
    ft = torch.from_numpy(f)
    plain = frontier.fused_level_blocks_plain(
        ft, tp.tiles, tp.firsts, tp.valids, tp.tile_ids, tp.f_rows, tp.f_cols, tp.o_rows,
        tp.o_cols, block, 8, n_out_rows=n_out,
    )
    got = _level_by_chunks(tp, ft, n_out)
    assert got.numpy().tobytes() == plain.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("case, expr, block", PLANS)
def test_plan_from_numpy_builds_the_same_work_list(case, expr, block):
    _, rp, tp = _plans(case, expr, block)
    arrays = (np.asarray(getattr(rp, k)) for k in SCHEDULE_FIELDS)
    carried = interop.plan_from_numpy(_STAGED[case, block][3], rp.n_states, *arrays, rp.union_members)
    assert carried.work.dtype == torch.int32 and torch.equal(carried.work, tp.work)


def test_level_work_skips_cover_steps_inside_a_run():
    """Cover steps between valid steps of one run (what a hand-built
    schedule may hold) get no entry, and chunks still stop at runs."""
    valids = np.array([1, 1, 1, 0, 1, 1, 0, 1, 1, 1, 1, 1], np.int32)
    run_ptr = np.array([0, 6, 7, 12], np.int32)
    want = [[0, 1], [2, 4], [5, -1], [7, 8], [9, 10], [11, -1]]
    assert ops.level_work(valids, run_ptr).tolist() == want
    assert ops.level_work(valids, run_ptr, chunk=3).tolist() == [[0, 1, 2], [4, 5, -1], [7, 8, 9], [10, 11, -1]]
    assert ops.level_work(np.zeros(3, np.int32), np.arange(4)).shape == (0, ops.WORK_CHUNK)


def test_cpu_level_on_bitplane_tiles_needs_no_work_list():
    """The work list is B3's: on CPU tensors fused_level_blocks runs the
    plain version, with or without it, and launches nothing."""
    rca, _, tp = _plans(1, SWEEP[1][2][0], SWEEP[1][1])
    f = torch.zeros(((rca.n_states + len(tp.union_members)) * 8, tp.v_pad))
    f[::3, : tp.n_nodes] = 1.0
    args = (f, tp.tiles, tp.firsts, tp.valids, tp.tile_ids, tp.f_rows, tp.f_cols, tp.o_rows,
            tp.o_cols, tp.block_size, tp.q_pad)
    kw = {"run_ptr": tp.run_ptr, "n_out_rows": rca.n_states * 8}
    before = frontier.launch_counts()
    without = frontier.fused_level_blocks(*args, **kw)
    with_work = frontier.fused_level_blocks(*args, **kw, work=tp.work)
    assert frontier.launch_counts() == before
    assert torch.equal(without, with_work) and torch.equal(without, _level_by_chunks(tp, f, rca.n_states * 8))


# ---------------------------------------------------------------------------
# Kernel B1's work list: f32 tiles, chunks of WORK_CHUNK_F32
# ---------------------------------------------------------------------------

# (case, query, block) on f32 tiles: every SWEEP query, and a dense graph
# at block 16 whose runs are far longer than two chunks
F32_GRAPHS = {"dense": (lambda s, g: g.random_labeled_graph(200, 3000, 2, seed=3), 16)}
F32_PLANS = [(c, e, b) for c, e, b in PLANS if c != "twin"] + [("dense", "(l0|l1)+ .^-1", 16)]

_STAGED_F32: dict = {}


def _plans_f32(case, expr, block):
    """repro's f32 store and plan, and the port's plan over the same store
    carried in and built by Stage B."""
    if (case, block) not in _STAGED_F32:
        factory = F32_GRAPHS[case][0] if case in F32_GRAPHS else SWEEP[case][0]
        rg, tg = factory(r_struct, r_gen), factory(structure, generators)
        rs = r_ops.stage_graph(rg, block)
        ts = interop.staged_from_numpy(rg.n_nodes, block, np.asarray(rs.tiles), rs.offsets, "cpu")
        _STAGED_F32[case, block] = (rg, tg, rs, ts)
    rg, tg, rs, ts = _STAGED_F32[case, block]
    rca = r_paa.compile_query(expr, rg)
    return rca, r_ops.build_level_schedule(rca, rs), ops.build_level_schedule(paa.compile_query(expr, tg), ts)


def _f32_level_by_chunks(plan, f: torch.Tensor, n_out: int) -> torch.Tensor:
    """The plain level as B1 runs it: each chunk's steps summed into an
    8 × B block, added into a zeroed output."""
    b = plan.block_size
    out = torch.zeros((n_out, plan.v_pad))
    ids = {k: getattr(plan, k).numpy() for k in SCHEDULE_FIELDS[2:]}
    for row in plan.work.numpy():
        steps = row[row >= 0]
        acc = torch.zeros((8, b))
        for i in steps:
            fr, fc = ids["f_rows"][i], ids["f_cols"][i]
            acc += f[fr * 8 : fr * 8 + 8, fc * b : fc * b + b] @ plan.tiles[ids["tile_ids"][i]]
        o_r, o_c = ids["o_rows"][steps[0]], ids["o_cols"][steps[0]]
        out[o_r * 8 : o_r * 8 + 8, o_c * b : o_c * b + b] += acc
    return out


@pytest.mark.parametrize("case, expr, block", F32_PLANS)
def test_f32_work_list_partitions_the_valid_steps_of_each_run(case, expr, block):
    """On f32 tiles the work list has chunks of WORK_CHUNK_F32: every valid
    step its own chunk, in step order, cover steps none."""
    _, _, plan = _plans_f32(case, expr, block)
    assert plan.tile_dtype == "f32" and ops.work_chunk("f32") == ops.WORK_CHUNK_F32
    work = plan.work.numpy()
    valids, ptr = plan.valids.numpy(), plan.run_ptr.numpy()
    assert plan.work.dtype == torch.int32 and work.shape[1] == ops.WORK_CHUNK_F32
    assert np.array_equal(work, ops.level_work(valids, ptr, ops.WORK_CHUNK_F32))
    filled = work >= 0
    assert filled[:, 0].all() and np.array_equal(work[filled], np.nonzero(valids)[0])
    run_of = np.searchsorted(ptr, np.arange(len(valids)), side="right") - 1
    assert all(len(set(run_of[row[row >= 0]].tolist())) == 1 for row in work)
    if case == "dense":
        assert np.add.reduceat(valids, ptr[:-1]).max() > 2 * ops.WORK_CHUNK_F32


@pytest.mark.parametrize("case, expr, block", F32_PLANS)
def test_f32_level_summed_by_chunks_equals_plain_and_repro(case, expr, block):
    rca, rp, tp = _plans_f32(case, expr, block)
    n_rows = rca.n_states + len(rp.union_members)
    f = (np.random.default_rng(block + 1).random((n_rows * 8, rp.v_pad)) < 0.3).astype(np.float32)
    f[:, tp.n_nodes :] = 0.0
    n_out = rca.n_states * 8
    want = np.asarray(r_frontier.fused_level_blocks(
        jnp.asarray(f), rp.tiles, rp.firsts, rp.valids, rp.tile_ids, rp.f_rows,
        rp.f_cols, rp.o_rows, rp.o_cols, block, 8, interpret=True, n_out_rows=n_out,
    ))
    ft = torch.from_numpy(f)
    plain = frontier.fused_level_blocks_plain(
        ft, tp.tiles, tp.firsts, tp.valids, tp.tile_ids, tp.f_rows, tp.f_cols, tp.o_rows,
        tp.o_cols, block, 8, n_out_rows=n_out,
    )
    got = _f32_level_by_chunks(tp, ft, n_out)
    assert got.numpy().tobytes() == plain.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("case, expr, block", F32_PLANS)
def test_plan_from_numpy_builds_the_f32_work_list(case, expr, block):
    _, rp, tp = _plans_f32(case, expr, block)
    arrays = (np.asarray(getattr(rp, k)) for k in SCHEDULE_FIELDS)
    carried = interop.plan_from_numpy(_STAGED_F32[case, block][3], rp.n_states, *arrays, rp.union_members)
    assert carried.work.shape[1] == ops.WORK_CHUNK_F32 and torch.equal(carried.work, tp.work)


def test_work_list_is_built_once_per_plan():
    """Stage B builds the work list with the plan; a level reads it and
    builds nothing."""
    rca, _, tp = _plans_f32(0, SWEEP[0][2][0], SWEEP[0][1])
    ops.BUILD_COUNTERS.clear()
    f = torch.zeros(((rca.n_states + len(tp.union_members)) * 8, tp.v_pad))
    f[:, : tp.n_nodes] = 1.0
    work = tp.work.clone()
    ops.expand_level_fused(tp, f[: rca.n_states * 8])
    assert not ops.BUILD_COUNTERS and torch.equal(tp.work, work)
