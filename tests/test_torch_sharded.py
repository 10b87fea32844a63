"""The port's site-sharded backend (``frontier_kernel_sharded``) against
``repro``'s: per-site staging, group merges, shape buckets and the seven
step arrays of every bucket byte for byte on both tile stores; the
bucket's one work list against the sum of its members' levels; and the
executor's answers, meters, per-site meters and witness levels against
``repro``'s run on a (1, 1) mesh, on ``tests/test_frontier_sharded.py``'s
graph, partitions and queries.  ``repro`` runs its fused kernel in
interpret mode.

On one device the port merges every site's discoveries each level where
``repro`` forwards them around a ring, so the port's answers and
per-site meters do not depend on ``axis_size``: they are held to
``repro``'s axis-size-1 run at 1 and 3.  Witness levels are bit-exact at
1 and BFS levels at 3, where the test walks witnesses back instead.
Every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.core import strategies as r_st
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.kernels.frontier import ops as r_ops

from repro_torch.core import paa, plans, strategies, witness
from repro_torch.graph import generators, partition
from repro_torch.kernels.frontier import frontier, ops
from repro_torch.serve import plancache

torch.set_num_threads(1)

QUERIES = ["(l0|l1)* l2 .^-1", "l0 (l1|l2)* l0", ". l1", "(l0|l2)+ l1?"]
DTYPES = ["f32", "uint32"]
SEVEN = ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols")


def _partition(g, placement_cls, n_sites: int, seed: int = 0):
    """``tests/test_frontier_sharded.py``'s disjoint partition (K = 1)."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n_sites, g.n_edges)
    site_edges = [np.nonzero(assign == s)[0].astype(np.int64) for s in range(n_sites)]
    return placement_cls(g, n_sites, site_edges, np.ones(g.n_edges, np.int32))


@pytest.fixture(scope="module")
def twins():
    return (r_gen.random_labeled_graph(40, 170, 4, seed=3),
            generators.random_labeled_graph(40, 170, 4, seed=3),
            compat.make_mesh((1, 1), ("data", "model")))


def _placements(twins, kind: str):
    rg, tg, _ = twins
    if kind == "disjoint":
        return _partition(rg, r_part.Placement, 3), _partition(tg, partition.Placement, 3)
    return (r_part.distribute(rg, n_sites=6, replication_rate=0.5, seed=4),
            partition.distribute(tg, n_sites=6, replication_rate=0.5, seed=4))


def _words(a) -> bytes:
    """The bytes of a tile array or tensor: int32 bit-planes hold
    ``repro``'s uint32 words bit for bit."""
    return np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor) else a).tobytes()


def _same_staging(want, got) -> None:
    assert (want.n_sites, want.n_nodes, want.v_pad, want.block_size, want.tile_dtype) == (
        got.n_sites, got.n_nodes, got.v_pad, got.block_size, got.tile_dtype)
    assert want.tile_store_bytes == got.tile_store_bytes
    for a, b in zip(want.site_tiles, got.site_tiles, strict=True):
        assert _words(b) == np.ascontiguousarray(a).tobytes()
    for a, b in zip(want.site_offsets, got.site_offsets, strict=True):
        assert list(a) == list(b)
        for key, (base, rows, cols) in a.items():
            assert (base, rows.tobytes(), cols.tobytes()) == (
                b[key][0], b[key][1].tobytes(), b[key][2].tobytes()), key


def _staged(twins, kind, tile_dtype):
    rp, tp = _placements(twins, kind)
    return (r_ops.stage_sharded_graph([rp.local_graph(s) for s in range(rp.n_sites)], 8, tile_dtype),
            ops.stage_sharded_graph([tp.local_graph(s) for s in range(tp.n_sites)], 8, tile_dtype))


# ---------------------------------------------------------------------------
# Stage A and Stage B, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile_dtype", DTYPES)
@pytest.mark.parametrize("n_groups", [1, 2, 3, 6])
def test_staging_merges_and_buckets_equal_repro(twins, tile_dtype, n_groups):
    """Per-site slabs, the merge into ``n_groups`` groups (the port's
    vectorised fold against ``repro``'s tile loop), and the merged
    slabs' shape buckets at axis size 1 and ``n_groups``."""
    r_staged, t_staged = _staged(twins, "replicated", tile_dtype)
    _same_staging(r_staged, t_staged)
    r_merged = r_ops.merge_staged_sites(r_staged, n_groups)
    t_merged = ops.merge_staged_sites(t_staged, n_groups)
    _same_staging(r_merged, t_merged)
    assert (t_merged is t_staged) == (n_groups == 6)
    for axis_size in sorted({1, n_groups}):
        want = r_ops.bucket_staged_sites(r_merged, axis_size)
        got = ops.bucket_staged_sites(t_merged, axis_size, device="cpu")
        assert got.bucket_id == want.bucket_id
        for a, b in zip(want.buckets, got.buckets, strict=True):
            assert (a.n_tiles, a.slots, a.sites) == (b.n_tiles, b.slots, b.sites)
            assert _words(b.tiles) == np.asarray(a.tiles).tobytes()


@pytest.mark.parametrize("tile_dtype", DTYPES)
def test_unmerged_buckets_of_several_classes_equal_repro(twins, tile_dtype):
    """Bucketing per-site slabs of very different sizes straight (sites
    holding 2% to 60% of the edges: several classes, a singleton at its
    natural size, and a floor that folds them into one) as ``repro`` does."""
    rg, tg, _ = twins
    assign = np.random.default_rng(7).choice(4, rg.n_edges, p=[0.02, 0.08, 0.3, 0.6])
    site_edges = [np.nonzero(assign == s)[0].astype(np.int64) for s in range(4)]
    ones = np.ones(rg.n_edges, np.int32)
    rp, tp = r_part.Placement(rg, 4, site_edges, ones), partition.Placement(tg, 4, site_edges, ones)
    r_staged = r_ops.stage_sharded_graph([rp.local_graph(s) for s in range(4)], 8, tile_dtype)
    t_staged = ops.stage_sharded_graph([tp.local_graph(s) for s in range(4)], 8, tile_dtype)
    _same_staging(r_staged, t_staged)
    classes = set()
    for axis_size, floor in ((1, 8), (2, 8), (1, 256)):
        want = r_ops.bucket_staged_sites(r_staged, axis_size, floor)
        got = ops.bucket_staged_sites(t_staged, axis_size, floor, device="cpu")
        assert got.bucket_id == want.bucket_id
        for a, b in zip(want.buckets, got.buckets, strict=True):
            assert _words(b.tiles) == np.asarray(a.tiles).tobytes()
        classes.add(len(got.buckets))
    assert classes == {1, 2, 4}


@pytest.mark.parametrize("tile_dtype", DTYPES)
@pytest.mark.parametrize("axis_size", [1, 2, 3, 6])
def test_sharded_schedules_equal_repro(twins, tile_dtype, axis_size):
    """The seven (rows, n_steps) arrays of every bucket, padding tail
    included, and the plan's step accounting."""
    r_staged, t_staged = _staged(twins, "replicated", tile_dtype)
    r_merged = r_ops.merge_staged_sites(r_staged, axis_size)
    t_merged = ops.merge_staged_sites(t_staged, axis_size)
    r_tb = r_ops.bucket_staged_sites(r_merged, axis_size)
    t_tb = ops.bucket_staged_sites(t_merged, axis_size, device="cpu")
    rg, tg, _ = twins
    for q in QUERIES:
        want = r_ops.build_sharded_level_schedule(
            r_paa.compile_query(q, rg), r_merged, r_tb, axis_size=axis_size)
        got = ops.build_sharded_level_schedule(
            paa.compile_query(q, tg), t_merged, t_tb, axis_size=axis_size)
        assert (got.n_real_steps, got.useful_steps, got.padded_steps, got.bucket_shapes,
                got.union_members, got.axis_size, got.tile_dtype) == (
            want.n_real_steps, want.useful_steps, want.padded_steps, want.bucket_shapes,
            want.union_members, want.axis_size, want.tile_dtype)
        for a, b, tb in zip(want.buckets, got.buckets, t_tb.buckets, strict=True):
            assert b.tiles is tb.tiles
            for name in SEVEN:
                assert getattr(b, name).numpy().tobytes() == np.asarray(getattr(a, name)).tobytes(), (q, name)


# ---------------------------------------------------------------------------
# the bucket's work list: one launch for every member
# ---------------------------------------------------------------------------


def _bucket_plan(twins, tile_dtype, q="(l0|l1)* l2 .^-1"):
    """A plan of one bucket of six member rows (every site its own group)."""
    _, t_staged = _staged(twins, "replicated", tile_dtype)
    plan = ops.build_sharded_level_schedule(paa.compile_query(q, twins[1]), t_staged, axis_size=6,
                                            device="cpu")
    (bucket,) = plan.buckets
    assert len(bucket.sites) == 6
    return plan, bucket


def _walk_work_list(plan, b, fre) -> torch.Tensor:
    """The kernels' walk of a bucket launch, step by step in plain torch:
    every chunk of the work list adds its steps' products into the output
    block of its first step, on the flattened tiles and step arrays."""
    n_out, v_pad = plan.n_states * plan.q_pad, plan.v_pad
    bs, q = plan.block_size, plan.q_pad
    tiles = b.tiles.reshape(-1, *b.tiles.shape[2:])
    if tiles.dtype == torch.int32:
        tiles = frontier.unpack_tile_bits(tiles, bs)
    flat = {n: getattr(b, n).reshape(-1) for n in ("f_rows", "f_cols", "o_rows", "o_cols")}
    out = torch.zeros((n_out, v_pad))
    for chunk in b.work.tolist():
        steps = [i for i in chunk if i >= 0]
        o_r, o_c = int(flat["o_rows"][steps[0]]), int(flat["o_cols"][steps[0]])
        for i in steps:
            assert (int(flat["o_rows"][i]), int(flat["o_cols"][i])) == (o_r, o_c)
            f_r, f_c = int(flat["f_rows"][i]), int(flat["f_cols"][i])
            block = fre[f_r * q : (f_r + 1) * q, f_c * bs : (f_c + 1) * bs]
            out[o_r * q : (o_r + 1) * q, o_c * bs : (o_c + 1) * bs] += block @ tiles[int(b.flat_tile_ids[i])]
    return out


@pytest.mark.parametrize("tile_dtype", DTYPES)
def test_bucket_work_list_is_the_sum_of_its_members(twins, tile_dtype):
    """The bucket's work list holds exactly every member's valid steps,
    offset by ``row · n_steps`` (no padding step), with tile ids offset
    by ``row · n_tiles``; walking it as the kernels do gives the sum of
    the members' plain levels, and so does the wrapper on the CPU."""
    plan, b = _bucket_plan(twins, tile_dtype)
    rows, n_steps = b.valids.shape
    want_steps = {r * n_steps + i for r in range(rows) for i in range(n_steps) if b.valids[r, i]}
    listed = [i for i in b.work.reshape(-1).tolist() if i >= 0]
    assert sorted(listed) == sorted(want_steps) and len(listed) == len(want_steps)
    assert b.work.shape[1] == ops.work_chunk(tile_dtype)
    assert torch.equal(b.flat_tile_ids,
                       (b.tile_ids + torch.arange(rows, dtype=torch.int32)[:, None] * b.n_tiles).reshape(-1))
    assert any(not b.valids[r, -1] for r in range(rows))  # a padding tail exists
    gen = torch.Generator().manual_seed(0)
    f = (torch.rand((plan.n_states * plan.q_pad, plan.v_pad), generator=gen) < 0.3).float()
    fre = ops.extend_frontier(f, plan.union_members, plan.n_states, plan.q_pad)
    members = sum(
        frontier.fused_level_blocks_plain(
            fre, b.tiles[r], *(getattr(b, n)[r] for n in SEVEN), plan.block_size, plan.q_pad,
            n_out_rows=plan.n_states * plan.q_pad)
        for r in range(rows)
    )
    assert members.max() > 1  # several members reach one output entry
    got = frontier.bucket_level_blocks(
        fre, b.tiles, *(getattr(b, n) for n in SEVEN), plan.block_size, plan.q_pad,
        run_ptr=b.run_ptr, work=b.work, flat_tile_ids=b.flat_tile_ids,
        n_out_rows=plan.n_states * plan.q_pad)
    assert torch.equal(got, members)
    assert torch.equal(_walk_work_list(plan, b, fre), members)


def test_run_ptr_is_per_member_and_the_global_check_is_unchanged(twins):
    """Each member row holds one run per output block (its padding tail
    inside the last run); the concatenation of two rows holds two, which
    ``run_offsets`` — the global plans' check — still refuses."""
    plan, b = _bucket_plan(twins, "f32")
    n_blocks = plan.n_states * (plan.v_pad // plan.block_size)
    assert tuple(b.run_ptr.shape) == (6, n_blocks + 1)
    assert (b.run_ptr[:, -1] == b.valids.shape[1]).all()
    two = np.concatenate([np.stack([b.o_rows[r].numpy(), b.o_cols[r].numpy()], axis=1) for r in (0, 1)])
    firsts = np.concatenate([b.firsts[r].numpy() for r in (0, 1)])
    with pytest.raises(ValueError, match="exactly one run per output block"):
        ops.run_offsets(two, firsts, plan.n_states, plan.v_pad // plan.block_size)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["disjoint", "replicated"])
@pytest.mark.parametrize("axis_size", [1, 3])
@pytest.mark.parametrize("tile_dtype", DTYPES)
def test_sharded_executor_equals_repro(twins, kind, axis_size, tile_dtype):
    """Answers and every cost field — ``q_bc``, ``n_bc``, ``d_s2`` and the
    per-site ``site_unicast_symbols`` — bit-exact to ``repro``'s run on a
    (1, 1) mesh, whatever ``axis_size``; on the disjoint partition the
    per-site sums are the host meter's ``d_s2``."""
    rg, tg, mesh = twins
    rp, tp = _placements(twins, kind)
    starts = np.arange(0, tg.n_nodes, 3, dtype=np.int32)
    index = paa.HostIndex(tg)
    for q in QUERIES:
        rca, tca = r_paa.compile_query(q, rg), paa.compile_query(q, tg)
        r_acc, r_costs = r_st.s2_execute(mesh, rp, rca, starts, backend="frontier_kernel_sharded",
                                         block_size=8, tile_dtype=tile_dtype)
        t_acc, t_costs = strategies.s2_execute(tp, tca, starts, backend="frontier_kernel_sharded",
                                               block_size=8, tile_dtype=tile_dtype, device="cpu",
                                               axis_size=axis_size)
        assert t_acc.dtype == bool and (t_acc == np.asarray(r_acc)).all(), q
        assert [dataclasses.astuple(c) for c in t_costs] == [dataclasses.astuple(c) for c in r_costs], q
        assert all(len(c.site_unicast_symbols) == tp.n_sites for c in t_costs)
        if kind == "disjoint":
            for s, c in zip(starts.tolist(), t_costs):
                assert sum(c.site_unicast_symbols) == paa.run_instrumented(tca, index, s).d_s2


@pytest.mark.parametrize("axis_size", [1, 3])
def test_sharded_witness_levels(twins, axis_size):
    """Witness levels bit-exact to ``repro``'s axis-size-1 run at 1, and at
    3 too: the port's synchronous merge keeps them BFS levels (``repro``'s
    ring stamps ring iterations there).  Witnesses walked back from them
    are valid paths that the automaton accepts."""
    rg, tg, mesh = twins
    rp, tp = _placements(twins, "replicated")
    starts = np.array([0, 5, 11, 17, 23, 31], np.int32)
    index = paa.HostIndex(tg)
    for q in QUERIES:
        rca, tca = r_paa.compile_query(q, rg), paa.compile_query(q, tg)
        t_acc, t_costs, lev = strategies.s2_execute(
            tp, tca, starts, backend="frontier_kernel_sharded", block_size=8, semantics="witness",
            tile_dtype="uint32", device="cpu", axis_size=axis_size)
        r_acc, r_costs, r_lev = r_st.s2_execute(
            mesh, rp, rca, starts, backend="frontier_kernel_sharded", block_size=8, semantics="witness")
        assert (t_acc == np.asarray(r_acc)).all() and lev.tobytes() == np.asarray(r_lev).tobytes(), q
        assert [dataclasses.astuple(c) for c in t_costs] == [dataclasses.astuple(c) for c in r_costs]
        for i, s in enumerate(starts.tolist()):
            for t in np.nonzero(t_acc[i])[0][:4].tolist():
                path = witness.reconstruct_path(tca, index, lev[i], s, t)
                ok, why = witness.validate_witness(path, tg)
                assert ok, why
                assert witness.nfa_accepts_symbols(tca, path.steps)
                assert (path.nodes[0], path.nodes[-1]) == (s, t)


@pytest.mark.parametrize("axis_size", [1, 3])
def test_max_levels_bounds_bfs_levels_at_every_axis_size(twins, axis_size):
    """``max_levels = L`` stops after L BFS levels at every axis size
    (``repro``'s ring would grant L · axis_size iterations above 1): the
    answers equal ``repro``'s axis-1 run and the global fused backend's
    at the same bound, and each fixpoint runs at most L levels."""
    rg, tg, mesh = twins
    rp, tp = _placements(twins, "replicated")
    starts = np.arange(0, tg.n_nodes, 5, dtype=np.int32)
    cut = 0
    for q in ("(l0|l1)* l2 .^-1", "(l0|l2)+ l1?"):
        rca, tca = r_paa.compile_query(q, rg), paa.compile_query(q, tg)
        full = strategies.s2_execute(tp, tca, starts, backend="frontier_kernel_sharded", block_size=8,
                                     device="cpu", axis_size=axis_size)[0]
        r_acc, _ = r_st.s2_execute(mesh, rp, rca, starts, max_levels=2,
                                   backend="frontier_kernel_sharded", block_size=8)
        global_acc, _ = strategies.s2_execute(tp, tca, starts, max_levels=2, block_size=8, device="cpu")
        ops.FIXPOINT_COUNTERS.clear()
        t_acc, _ = strategies.s2_execute(tp, tca, starts, max_levels=2,
                                         backend="frontier_kernel_sharded", block_size=8,
                                         device="cpu", axis_size=axis_size)
        n_fixpoints = -(-len(starts) // ops.QPAD)
        assert 0 < ops.FIXPOINT_COUNTERS["levels"] <= 2 * n_fixpoints
        assert (t_acc == np.asarray(r_acc)).all() and (t_acc == global_acc).all(), q
        assert (t_acc <= full).all(), q
        cut += int((t_acc != full).sum())
    assert cut > 0  # the bound cuts answers short


def test_executor_cache_keys_on_the_bucket_descriptor(twins):
    """The executor signature is the same at every axis size; the shape
    buckets' descriptor in the graph key tells the executors apart, and a
    repeated build hits."""
    _, tp = _placements(twins, "replicated")
    ca = paa.compile_query("l0 (l1|l2)* l0", twins[1])
    cache = plancache.ExecutorCache(plan_store=plans.GraphPlanStore(device="cpu"))
    kw = dict(backend="frontier_kernel_sharded", graph=tp.graph, block_size=8, placement=tp)
    sig1, fn1 = cache.get_or_build(ca, tp.graph.n_nodes, axis_size=1, **kw)
    sig3, fn3 = cache.get_or_build(ca, tp.graph.n_nodes, axis_size=3, **kw)
    sig3b, fn3b = cache.get_or_build(ca, tp.graph.n_nodes, axis_size=3, **kw)
    assert sig1 == sig3 == sig3b and fn1 is not fn3 and fn3 is fn3b
    assert (cache.builds, cache.hits, cache.stats()["graphs"]) == (2, 1, 2)
    ids = {gk[-1] for gk, _ in cache._lru}
    assert ids == {cache.plan_store.tile_buckets(tp, 8, a).bucket_id for a in (1, 3)}
    assert len(ids) == 2


def test_warm_sharded_builds_pack_nothing_and_record_pad_waste_like_repro(twins):
    """Through the plan store a second signature stages nothing (zero
    tiles packed, nothing merged or bucketed), and the store's pad
    accounting equals ``repro``'s after the same two builds."""
    rg, tg, mesh = twins
    rp, tp = _placements(twins, "replicated")
    from repro.core import plans as r_plans

    r_store, t_store = r_plans.GraphPlanStore(), plans.GraphPlanStore(device="cpu")
    for i, q in enumerate(("l0 (l1|l2)* l0", ". l1")):
        ops.reset_build_counters()
        r_st.make_s2_step_fn(r_paa.compile_query(q, rg), rg.n_nodes, mesh,
                             backend="frontier_kernel_sharded", placement=rp, block_size=8,
                             plan_store=r_store)
        strategies.make_s2_step_fn(paa.compile_query(q, tg), tg.n_nodes,
                                   backend="frontier_kernel_sharded", placement=tp, block_size=8,
                                   plan_store=t_store, device="cpu")
        staging = {k: ops.BUILD_COUNTERS[k] for k in
                   ("pack_blocks", "stage_sharded_graph", "bucket_staged_sites")}
        assert (sum(staging.values()) == 0) == (i == 1), staging
        assert ops.BUILD_COUNTERS["sharded_level_schedule"] == 1
    assert t_store.pad_stats() == r_store.pad_stats()
    assert t_store.stats() == r_store.stats()
