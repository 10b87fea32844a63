"""The level kernels' work list (``FusedLevelPlan.work``,
``ops.level_work``) against the Stage-B schedule it cuts, and the levels
it drives against ``repro``'s.  The chunks must partition the valid steps
of each run, in step order, none crossing a run or holding more than
``work_chunk(tile_dtype)`` steps, and cover steps get none.  The plain
level summed chunk by chunk into a zeroed output, as B1 and B3 add their
chunks on the card, must equal ``fused_level_blocks_plain`` and
``repro``'s ``fused_level_blocks`` (interpret mode) bit for bit: {0,1}
operands and integer sums below 2^24 are exact in f32 in any order.  The
packed level ORed chunk by chunk into a zeroed output, as B2 and B4 OR
their chunks on the card, must equal ``packed_level_blocks_plain`` and
``repro``'s ``packed_level_blocks`` byte for byte on both tile stores.
Graphs: the SWEEP of ``tests/test_torch_stage.py`` and a 5,000-node
Alibaba twin at block 128, whose q1, q9 and q12 plans have runs of up to
24 valid steps."""

import dataclasses

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
    carried in and built by Stage B.  The twin's f32 store would be 1 GB,
    so its plans are the uint32 plans on f32 tiles: the tiles they use
    unpacked (:func:`_twin_on_f32_tiles`)."""
    if case == "twin":
        return _twin_on_f32_tiles(expr)
    if (case, block) not in _STAGED_F32:
        factory = F32_GRAPHS[case][0] if case in F32_GRAPHS else SWEEP[case][0]
        rg, tg = factory(r_struct, r_gen), factory(structure, generators)
        rs = r_ops.stage_graph(rg, block)
        ts = interop.staged_from_numpy(rg.n_nodes, block, np.asarray(rs.tiles), rs.offsets, "cpu")
        _STAGED_F32[case, block] = (rg, tg, rs, ts)
    rg, tg, rs, ts = _STAGED_F32[case, block]
    rca = r_paa.compile_query(expr, rg)
    return rca, r_ops.build_level_schedule(rca, rs), ops.build_level_schedule(paa.compile_query(expr, tg), ts)


def _unpack_bits(words: np.ndarray, block: int) -> np.ndarray:
    """Bit-plane tiles (n, B, ⌈B/32⌉) as (n, B, B) f32 0/1, in numpy."""
    bits = (words.view(np.uint32)[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :block].astype(np.float32)


def _twin_on_f32_tiles(expr):
    """The twin's Stage-B plan for ``expr`` on f32 tiles: repro's uint32
    plan with the tiles it uses (the zero cover tile first) unpacked to
    f32 and ``tile_ids`` renumbered into them, and the port's plan over
    the same tiles carried in by ``plan_from_numpy``, which cuts the f32
    work list (chunks of ``WORK_CHUNK_F32``) as Stage B does."""
    rca, rp, _ = _plans("twin", expr, 128)
    used, ids = np.unique(np.asarray(rp.tile_ids), return_inverse=True)
    tiles = _unpack_bits(np.asarray(rp.tiles)[used], 128)
    ids = ids.astype(np.int32)
    rp32 = dataclasses.replace(rp, tiles=jnp.asarray(tiles), tile_ids=jnp.asarray(ids),
                               tile_dtype="f32")
    ts = interop.staged_from_numpy(rp.n_nodes, 128, tiles, {}, "cpu")
    arrays = [np.asarray(getattr(rp32, k)) for k in SCHEDULE_FIELDS]
    return rca, rp32, interop.plan_from_numpy(ts, rp.n_states, *arrays, rp.union_members)


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


# ---------------------------------------------------------------------------
# Kernels B2 and B4: the packed level on the same work lists
# ---------------------------------------------------------------------------


def _packed_level_by_chunks(plan, f: np.ndarray, n_out: int) -> np.ndarray:
    """The packed level as B2 and B4 run it, in numpy uint32: each
    chunk's steps ORed into an 8 × B block of words, ``acc[r, j] |=
    f[r, v]`` for every tile entry ``a[v, j] != 0``, and the block ORed
    into a zeroed output."""
    b = plan.block_size
    out = np.zeros((n_out, plan.v_pad), np.uint32)
    ids = {k: getattr(plan, k).numpy() for k in SCHEDULE_FIELDS[2:]}
    tiles = plan.tiles.numpy()
    for row in plan.work.numpy():
        steps = row[row >= 0]
        acc = np.zeros((8, b), np.uint32)
        for i in steps:
            fr, fc, t = ids["f_rows"][i], ids["f_cols"][i], ids["tile_ids"][i]
            a = (_unpack_bits(tiles[t : t + 1], b)[0] if tiles.dtype == np.int32 else tiles[t]) != 0
            blk = f[fr * 8 : fr * 8 + 8, fc * b : fc * b + b]
            acc |= np.bitwise_or.reduce(np.where(a[None], blk[:, :, None], np.uint32(0)), axis=1)
        o_r, o_c = ids["o_rows"][steps[0]], ids["o_cols"][steps[0]]
        out[o_r * 8 : o_r * 8 + 8, o_c * b : o_c * b + b] |= acc
    return out


def _lane_words(plan, n_rows: int, seed: int) -> np.ndarray:
    """Seeded lane words over all 32 bits (bit 31 included), padded
    columns empty."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(n_rows, plan.v_pad), dtype=np.uint64).astype(np.uint32)
    w[:, plan.n_nodes :] = 0
    return w


@pytest.mark.parametrize("case, expr, block", PLANS)
@pytest.mark.parametrize("tile_dtype", ["f32", "uint32"])
def test_packed_level_ored_by_chunks_equals_plain_and_repro(tile_dtype, case, expr, block):
    """B2 (f32 tiles, chunks of 1) and B4 (bit-planes, chunks of 2): the
    chunks ORed into a zeroed output == ``packed_level_blocks_plain`` ==
    ``repro``'s ``packed_level_blocks`` in interpret mode, byte for byte."""
    rca, rp, tp = (_plans_f32 if tile_dtype == "f32" else _plans)(case, expr, block)
    assert tp.tile_dtype == tile_dtype and tp.work.shape[1] == ops.work_chunk(tile_dtype)
    n_rows = (rca.n_states + len(rp.union_members)) * 8
    f = _lane_words(tp, n_rows, block + 2)
    n_out = rca.n_states * 8
    want = np.asarray(r_frontier.packed_level_blocks(
        jnp.asarray(f), rp.tiles, rp.firsts, rp.valids, rp.tile_ids, rp.f_rows,
        rp.f_cols, rp.o_rows, rp.o_cols, block, 8, interpret=True, n_out_rows=n_out,
    ))
    plain = frontier.packed_level_blocks_plain(
        torch.from_numpy(f.view(np.int32)), tp.tiles, tp.firsts, tp.valids, tp.tile_ids,
        tp.f_rows, tp.f_cols, tp.o_rows, tp.o_cols, block, 8, n_out_rows=n_out,
    )
    got = _packed_level_by_chunks(tp, f, n_out)
    assert want.dtype == np.uint32 and (got >> 31).any()
    assert got.tobytes() == plain.numpy().view(np.uint32).tobytes() == want.tobytes()


def test_cpu_packed_level_needs_no_work_list():
    """The work list is B2's and B4's: on CPU tensors packed_level_blocks
    runs the plain version, with or without it, and launches nothing."""
    for tile_dtype, plans in (("f32", _plans_f32), ("uint32", _plans)):
        rca, _, tp = plans(1, SWEEP[1][2][0], SWEEP[1][1])
        n_rows = (rca.n_states + len(tp.union_members)) * 8
        f = _lane_words(tp, n_rows, 5)
        args = (torch.from_numpy(f.view(np.int32)), tp.tiles, tp.firsts, tp.valids, tp.tile_ids,
                tp.f_rows, tp.f_cols, tp.o_rows, tp.o_cols, tp.block_size, tp.q_pad)
        kw = {"run_ptr": tp.run_ptr, "n_out_rows": rca.n_states * 8}
        before = frontier.launch_counts()
        without = frontier.packed_level_blocks(*args, **kw)
        with_work = frontier.packed_level_blocks(*args, **kw, work=tp.work)
        assert frontier.launch_counts() == before
        assert torch.equal(without, with_work), tile_dtype
        assert without.numpy().view(np.uint32).tobytes() == _packed_level_by_chunks(
            tp, f, rca.n_states * 8).tobytes()
