"""The port's mesh programs over ``gloo`` ranks on the CPU: S1's gather
and the ``reference`` and ``frontier_kernel_sharded`` S2 executors run
per rank (``mesh=``), against the port's one-card run (``mesh=None``) at
the same ``axis_size``, bit for bit, and against ``repro``'s ``shard_map``
programs on 8 forced host devices.

Each topology, a (data, model) mesh of (2, 1), (4, 1) or (2, 2), is one
spawn of ``gloo`` ranks (``launch.ranks.run_ranks``, rendezvous on a
``FileStore``), whose every case runs in :func:`_mesh_cases` on every
rank and is written to a file; the tests read the files and compare.
Every rank returns the whole gathered result, so every rank's result is
compared.  Sites are blocked over ``data`` and starts over ``model``.

The input is ``repro``'s: ``tests/test_frontier_sharded.py``'s graph
(``random_labeled_graph(40, 170, 4, seed=9)``) and its 4-site disjoint
partition, one replicated placement (8 sites, rate 0.2), and a skewed
one whose edges all sit on the last two sites, so that ranks discover
different nodes (none at all on most) in every level and must still
leave the level loop together.  The §6 workflow plans on every rank from
the same seed on the 8,000-node twin and executes its choice over ranks.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import paa, planner, plans, strategies
from repro_torch.core import regex as rx
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.graph import generators, partition
from repro_torch.kernels.frontier import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import ranks

torch.set_num_threads(1)

SHAPES = [(2, 1), (4, 1), (2, 2)]
SPAWN_TIMEOUT_S = 150  # per spawn, inside the per-test SIGALRM of 300 s
QUERIES = ["(l0|l1)* l2 .^-1", "l0 (l1|l2)* l0", ". l1", "(l0|l2)+ l1?"]
STARTS = np.arange(0, 40, 5, dtype=np.int32)  # repro's 8-device test's starts
UNEVEN = np.arange(1, 40, 3, dtype=np.int32)  # 13: blocks of 7 and 6 over 2 batch ranks
MASKS = [(0, 2), (1,), (0, 1, 2, 3)]
DTYPES = ["f32", "uint32"]
SEVEN = ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols")
MAX_LEVELS = 2
PLAN_QUERIES = ["q1", "q6", "q10", "q11"]  # S1 and S2 choices, a bounded class (q11)
PLAN_STARTS = 3


def _graph():
    return generators.random_labeled_graph(40, 170, 4, seed=9)


def _placements(g) -> dict:
    rng = np.random.default_rng(0)
    assign = rng.integers(0, 4, g.n_edges)
    skew = rng.integers(6, 8, g.n_edges)
    return {
        "replicated": partition.distribute(g, n_sites=8, replication_rate=0.2, seed=9),
        "disjoint": partition.Placement(
            g, 4, [np.nonzero(assign == s)[0].astype(np.int64) for s in range(4)],
            np.ones(g.n_edges, np.int32)),
        "skewed": partition.Placement(
            g, 8, [np.nonzero(skew == s)[0].astype(np.int64) for s in range(8)],
            np.ones(g.n_edges, np.int32)),
    }


def _plan_setup():
    g = generators.alibaba_like(n_nodes=8000, n_edges=40000, seed=0)
    pl = partition.distribute(g, 8, replication_rate=0.2, seed=0)
    net = planner.probe_network(partition.random_overlay(8, 3.0, seed=6), pl, seed=6)
    return g, pl, net, planner.fit_model(g)


def _np(out) -> tuple:
    """An ``s2_execute`` result with its costs as field tuples."""
    return (out[0], [dataclasses.astuple(c) for c in out[1]]) + tuple(out[2:])


def _exec_cases(pls, n_data, mesh) -> dict:
    """Every executor case, keyed; on a ``mesh`` per rank, else on one
    device at ``axis_size`` ``n_data``."""
    kw = {"mesh": mesh} if mesh is not None else {"axis_size": n_data}
    ref_kw = {"mesh": mesh} if mesh is not None else {}
    res = {}
    for name, pl in pls.items():
        for q in QUERIES:
            ca = paa.compile_query(q, pl.graph)
            for sem in ("pairs", "witness"):
                res["reference", name, q, sem] = _np(strategies.s2_execute(
                    pl, ca, STARTS, backend="reference", semantics=sem, device="cpu", **ref_kw))
                for td in DTYPES if sem == "pairs" else ["f32"]:
                    res["sharded", name, q, sem, td] = _np(strategies.s2_execute(
                        pl, ca, STARTS, backend="frontier_kernel_sharded", block_size=8,
                        tile_dtype=td, semantics=sem, device="cpu", **kw))
    pl = pls["replicated"]
    for q in QUERIES[:2]:
        ca = paa.compile_query(q, pl.graph)
        res["uneven", "reference", q] = _np(strategies.s2_execute(
            pl, ca, UNEVEN, backend="reference", semantics="witness", device="cpu", **ref_kw))
        res["uneven", "sharded", q] = _np(strategies.s2_execute(
            pl, ca, UNEVEN, backend="frontier_kernel_sharded", block_size=8,
            semantics="witness", device="cpu", **kw))
        for backend in ("reference", "frontier_kernel_sharded"):
            ops.FIXPOINT_COUNTERS.clear()
            out = strategies.s2_execute(
                pl, ca, STARTS, max_levels=MAX_LEVELS, backend=backend, block_size=8, device="cpu",
                **(kw if "sharded" in backend else ref_kw))
            res["max_levels", backend, q] = _np(out) + (ops.FIXPOINT_COUNTERS["levels"],)
    return res


def _s1_cases(pl, mesh) -> dict:
    arrays = strategies.stage_site_arrays(pl, "cpu", mesh)
    res = {}
    for lbls in MASKS:
        mask = np.zeros(pl.graph.n_labels, bool)
        mask[list(lbls)] = True
        for cap in (pl.padded_width(), 7):
            out = strategies.s1_gather(arrays, mask, cap, mesh)
            res["s1", lbls, cap] = tuple(t.numpy() for t in out[:4]) + (out[4],)
        sub = strategies.s1_collect(pl, mask, 3, device="cpu", mesh=mesh)
        res["s1_collect", lbls] = (sub.src, sub.lbl, sub.dst)
    return res


def _plan_cases(setup, mesh) -> dict:
    """The §6 workflow: plan each query on the host from the same seed,
    then execute its choice on sampled starts (S2 under the class's fast
    path on both rank backends, the sharded one over the bit-plane store
    through a plan store)."""
    g, pl, net, model = setup
    store = plans.GraphPlanStore(device="cpu")
    res = {}
    for q in PLAN_QUERIES:
        expr = generators.TABLE2_QUERIES[q]
        est = planner.estimate_query(expr, g, model=model, n_rollouts=20, seed=6)
        choice = planner.decide_strategy(est, net).choice
        ca = paa.compile_query(expr, g)
        valid = paa.valid_start_nodes(ca, g)
        sample = np.sort(np.random.default_rng(6).choice(valid, min(PLAN_STARTS, len(valid)), replace=False))
        if choice.strategy == "S1":
            out = [strategies.s1_execute(pl, rx.parse(expr), ca, int(s), device="cpu", mesh=mesh)
                   for s in sample]
            res[q] = (choice.strategy, choice.reason, [(sorted(a), c) for a, c in out])
        else:
            exec_ca = planner.reduce_automaton(ca, est.query_class)
            cap = planner.fast_path_max_levels(est.query_class)
            res[q] = (choice.strategy, choice.reason, [_np(strategies.s2_execute(
                pl, exec_ca, sample, max_levels=cap, backend=b, tile_dtype="uint32", device="cpu",
                plan_store=store, mesh=mesh)) for b in ("reference", "frontier_kernel_sharded")])
    return res


def _rank_plans(pls, mesh) -> dict:
    """Each rank's Stage A and bucket arrays for every (placement, tile
    dtype, query), through a plan store keyed by its share."""
    n = collectives.axis_size(mesh, ("data",))
    res = {}
    for name, pl in pls.items():
        for td in DTYPES:
            store = plans.GraphPlanStore(device="cpu")
            group = store.staged_merged(pl, 8, n, 0, td, mesh)
            tb = store.tile_buckets(pl, 8, n, 0, ops.BUCKET_FLOOR, td, mesh)
            res["group", name, td] = (group.site_tiles[0], group.site_offsets[0], tb.bucket_id)
            for q in QUERIES:
                plan = ops.build_rank_level_schedule(paa.compile_query(q, pl.graph), group, tb, mesh)
                (b,) = plan.buckets
                arrays = (*SEVEN, "run_ptr", "tiles", "work", "flat_tile_ids")
                res["plan", name, td, q] = {"n_steps": b.n_steps, "n_tiles": b.n_tiles, "sites": b.sites,
                                            **{k: getattr(b, k).numpy() for k in arrays}}
    return res


def _collective_cases(mesh) -> dict:
    """The collectives themselves, and the mesh helpers on a DeviceMesh."""
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    n_data, n_model = (collectives.axis_size(mesh, a) for a in ("data", "model"))
    rank = torch.tensor([[dist.get_rank(), d, m]], dtype=torch.int32)
    res = {
        "coord": (dist.get_rank(), d, m),
        "index": [collectives.axis_index(mesh, a) for a in ("data", "model", ("data", "model"))],
        "gather_data": collectives.gather_rows(rank, "data", n_data, mesh).numpy(),
        "gather_all": collectives.gather_rows(rank, ("data", "model"), n_data * n_model, mesh).numpy(),
        "gather_bool": collectives.gather_rows(torch.tensor([[d % 2 == 1, True]]), "data", n_data,
                                               mesh).numpy(),
        "psum_model": collectives.psum(torch.tensor([float(d), 1.0]), "model", mesh).numpy(),
        "pmax_all": collectives.pmax(rank, ("data", "model"), mesh).numpy(),
        "site_block": collectives.site_block(8, ("data",), mesh),
        "uneven_block": collectives.block_of(13, ("model",), mesh),
    }
    with shd.use_mesh(mesh):
        res["installed"] = shd.get_mesh() is mesh
        res["psum_installed"] = collectives.psum(torch.ones(1), "data").item()
    res["outside"] = shd.get_mesh() is None
    res["rules"] = shd.Rules.from_mesh(mesh).fit(("data", "model"), (4, 6))
    try:
        strategies.make_s2_step_fn(paa.compile_query("l0", _graph()), 40, backend="reference",
                                   mesh=mesh, axis_size=n_data + 1)
        res["axis_size_raises"] = False
    except ValueError:
        res["axis_size_raises"] = True
    return res


def _mesh_cases(mesh) -> dict:
    g = _graph()
    pls = _placements(g)
    res = _collective_cases(mesh)
    collectives.WIRE_COUNTERS.clear()
    res.update(_exec_cases(pls, None, mesh))
    res["wire"] = dict(collectives.WIRE_COUNTERS)
    res.update(_s1_cases(pls["replicated"], mesh))
    res.update(_rank_plans(pls, mesh))
    res["plan_cases"] = _plan_cases(_plan_setup(), mesh)
    return res


def _rank_program(rank: int, world: int, store: str, shape: tuple, out_dir: str) -> None:
    torch.set_num_threads(1)
    ranks.init_rank(rank, world, store, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    try:
        res = _mesh_cases(lmesh.make_test_mesh(*shape, device="cpu"))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures: one spawn per topology, one one-card run per axis size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, repro_8_devices):
    """``spawned(shape)``: every rank's results for that topology, from
    one spawn made on first use (inside the test's timeout).  ``repro``'s
    8-device run starts first and runs beside the spawns."""
    cache = {}

    def get(shape):
        if shape not in cache:
            d = tmp_path_factory.mktemp(f"mesh_{shape[0]}x{shape[1]}")
            world = shape[0] * shape[1]
            ranks.run_ranks(_rank_program, world, (world, str(d / "store"), shape, str(d)),
                            timeout_s=SPAWN_TIMEOUT_S, device="cpu")
            cache[shape] = []
            for r in range(world):
                with open(d / f"rank{r}.pkl", "rb") as f:
                    cache[shape].append(pickle.load(f))
        return cache[shape]

    return get


@pytest.fixture(scope="module")
def one_card():
    """``one_card(n_data)``: the same cases with ``mesh=None`` at
    ``axis_size`` ``n_data``."""
    g = _graph()
    pls = _placements(g)
    cache = {}

    def get(n_data):
        if n_data not in cache:
            cache[n_data] = {**_exec_cases(pls, n_data, None), **_s1_cases(pls["replicated"], None)}
        return cache[n_data]

    return get


def _same(a, b, what) -> None:
    """Exact equality of nested results: arrays by dtype, shape and bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), what
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, (what, i))
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _same(a[k], b[k], (what, k))
    else:
        assert a == b, (what, a, b)


def _keys(res, kind):
    return [k for k in res if isinstance(k, tuple) and k[0] == kind]


# ---------------------------------------------------------------------------
# against the one-card run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_collectives_and_mesh_helpers(spawned, shape):
    """Coordinates, gathers as a zeroed SUM (bools as uint8), psum, pmax
    and the blocks over the (data, model) mesh; ``use_mesh`` installs the
    ``DeviceMesh`` and ``Rules`` fit on it; an ``axis_size`` that disagrees
    with the mesh raises."""
    n_data, n_model = shape
    results = spawned(shape)
    coords = {r["coord"][0]: r["coord"][1:] for r in results}
    assert coords == {d * n_model + m: (d, m) for d in range(n_data) for m in range(n_model)}
    for r in results:
        rank, d, m = r["coord"]
        assert r["index"] == [d, m, d * n_model + m]
        assert r["gather_data"].tolist() == [[k * n_model + m, k, m] for k in range(n_data)]
        assert r["gather_all"].tolist() == [[k, k // n_model, k % n_model]
                                            for k in range(n_data * n_model)]
        assert r["gather_bool"].dtype == np.bool_
        assert r["gather_bool"].tolist() == [[k % 2 == 1, True] for k in range(n_data)]
        assert r["psum_model"].tolist() == [float(d * n_model), float(n_model)]
        assert r["pmax_all"].tolist() == [[n_data * n_model - 1, n_data - 1, n_model - 1]]
        assert r["site_block"] == (d * 8 // n_data, (d + 1) * 8 // n_data)
        k = -(-13 // n_model)
        assert r["uneven_block"] == (min(m * k, 13), min((m + 1) * k, 13))
        assert r["installed"] and r["outside"] and r["psum_installed"] == n_data
        assert r["rules"] == shd.Rules.from_mesh(lmesh.MeshLayout(("data", "model"), shape)).fit(
            ("data", "model"), (4, 6))
        assert r["axis_size_raises"]


@pytest.mark.parametrize("shape", SHAPES)
def test_s1_gather_equals_one_card(spawned, one_card, shape):
    """S1's buffers and overflow, at the placement's width and at a cap
    of 7 that overflows, and the gathered, deduplicated subgraph after
    ``s1_collect`` grows its cap from 3."""
    want = one_card(shape[0])
    keys = _keys(want, "s1") + _keys(want, "s1_collect")
    assert len(keys) == 3 * len(MASKS) and any(want[k][4] > 0 for k in _keys(want, "s1"))
    for r in spawned(shape):
        for k in keys:
            _same(r[k], want[k], k)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_executor_equals_one_card(spawned, one_card, shape):
    """The reference backend on every placement and query: answers,
    q_bc, d_s2, n_bc and witness levels."""
    want = one_card(shape[0])
    keys = _keys(want, "reference")
    assert len(keys) == 3 * len(QUERIES) * 2
    for r in spawned(shape):
        for k in keys:
            _same(r[k], want[k], k)


@pytest.mark.parametrize("tile_dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_executor_equals_one_card(spawned, one_card, shape, tile_dtype):
    """The sharded backend on every placement and query, over either tile
    store: answers, meters, per-site meters and (f32) witness levels."""
    want = one_card(shape[0])
    keys = [k for k in _keys(want, "sharded") if k[4] == tile_dtype]
    assert len(keys) == 3 * len(QUERIES) * (2 if tile_dtype == "f32" else 1)
    for r in spawned(shape):
        for k in keys:
            _same(r[k], want[k], k)
            assert len(r[k][1][0][5]) == _placements(_graph())[k[1]].n_sites  # per-site meters


@pytest.mark.parametrize("shape", SHAPES)
def test_uneven_batch_blocks_equal_one_card(spawned, one_card, shape):
    """13 starts split over the batch axis in blocks of 7 and 6, both
    backends under witness semantics."""
    want = one_card(shape[0])
    for r in spawned(shape):
        for k in _keys(want, "uneven"):
            _same(r[k], want[k], k)


@pytest.mark.parametrize("shape", SHAPES)
def test_max_levels_bounds_bfs_levels_over_ranks(spawned, one_card, shape):
    """``max_levels`` counts BFS levels over ranks as on one card: the
    capped answers equal the one-card capped run's (and differ from the
    uncapped ones), and each fixpoint runs at most ``MAX_LEVELS``."""
    want = one_card(shape[0])
    keys = _keys(want, "max_levels")
    assert len(keys) == 4
    for r in spawned(shape):
        for k in keys:  # STARTS fill one fixpoint on every rank and on one card
            _same(r[k][:2], want[k][:2], k)
            assert 0 < r[k][2] <= MAX_LEVELS and 0 < want[k][2] <= MAX_LEVELS, k
        assert any(not np.array_equal(r[k][0], r[("reference", "replicated", k[2], "pairs")][0])
                   for k in keys)


@pytest.mark.parametrize("shape", SHAPES)
def test_ranks_that_discover_nothing_stay_in_the_level_loop(spawned, one_card, shape):
    """On the skewed placement every edge sits on the last data rank's
    sites: the other ranks expand nothing at any level, yet take every
    merged level with it (the run ends, with the one-card answers), and
    each level puts one frontier on the wire."""
    want = one_card(shape[0])
    for r in spawned(shape):
        for k in _keys(want, "sharded") + _keys(want, "reference"):
            if k[1] == "skewed":
                _same(r[k], want[k], k)
        assert r["wire"]["all_reduces"] > 0 and r["wire"]["bytes"] > 0
    wires = {(res["coord"][2], res["wire"]["all_reduces"]) for res in spawned(shape)}
    assert len({m for m, _ in wires}) == len(wires)  # one count per batch rank: site groups agree


@pytest.mark.parametrize("shape", SHAPES)
def test_rank_buckets_are_rows_of_the_one_card_plan(spawned, shape):
    """Each rank's merged group slab and bucket arrays, byte for byte,
    are its rows of the one-card Stage A and Stage B at the same axis
    size: the seven step arrays, run offsets, tiles, and the work list
    and flat tile ids offset back to row 0."""
    n_data = shape[0]
    pls = _placements(_graph())
    for r in spawned(shape):
        d = r["coord"][1]
        for name, pl in pls.items():
            for td in DTYPES:
                staged = ops.stage_sharded_graph([pl.local_graph(s) for s in range(pl.n_sites)], 8, td)
                merged = ops.merge_staged_sites(staged, n_data)
                tb = ops.bucket_staged_sites(merged, n_data, device="cpu")
                tiles, offsets, bucket_id = r["group", name, td]
                assert tiles.tobytes() == merged.site_tiles[d].tobytes()
                _same(offsets, merged.site_offsets[d], (name, td))
                assert bucket_id == tb.bucket_id
                for q in QUERIES:
                    (b,) = ops.build_sharded_level_schedule(
                        paa.compile_query(q, pl.graph), merged, tb, axis_size=n_data).buckets
                    got = r["plan", name, td, q]
                    assert (got["n_steps"], got["n_tiles"], got["sites"]) == (b.n_steps, b.n_tiles, (d,))
                    for k in (*SEVEN, "run_ptr", "tiles"):
                        _same(got[k][0], getattr(b, k)[d].numpy(), (name, td, q, k))
                    work = b.work.numpy()
                    rows = np.where(work >= 0, work // b.n_steps, -1).max(axis=1)
                    mine = work[rows == d]
                    _same(got["work"], np.where(mine >= 0, mine - d * b.n_steps, -1), (name, td, q))
                    flat = b.flat_tile_ids.numpy().reshape(n_data, -1)[d] - d * b.n_tiles
                    _same(got["flat_tile_ids"], flat.astype(np.int32), (name, td, q))


@pytest.fixture(scope="module")
def one_card_plans():
    return _plan_cases(_plan_setup(), None)


@pytest.mark.parametrize("shape", SHAPES)
def test_planned_workflow_over_ranks(spawned, one_card_plans, shape):
    """§6: every rank plans each query on the host from the same seed and
    picks what the one-card planner picks; S1 (gather over ranks) and S2
    under the class's fast path (reference and sharded over ranks) answer
    and meter as on one card."""
    want = one_card_plans
    assert {s for s, _, _ in want.values()} == {"S1", "S2"}
    for r in spawned(shape):
        _same(r["plan_cases"], want, "plan")


def test_one_rank_mesh_equals_no_mesh(tmp_path):
    """A (1, 1) mesh of one ``gloo`` rank in this process equals
    ``mesh=None`` on every case; the group is torn down after."""
    ranks.init_rank(0, 1, str(tmp_path / "store"), device="cpu", timeout_s=60)
    try:
        mesh = lmesh.make_test_mesh(1, 1, device="cpu")
        assert shd.is_device_mesh(mesh) and collectives.axis_size(mesh, ("data",)) == 1
        pls = _placements(_graph())
        got = {**_exec_cases(pls, None, mesh), **_s1_cases(pls["replicated"], mesh)}
    finally:
        dist.destroy_process_group()
    want = {**_exec_cases(pls, 1, None), **_s1_cases(pls["replicated"], None)}
    _same(got, want, "(1, 1)")
    assert isinstance(lmesh.make_test_mesh(2, 4), lmesh.MeshLayout)


# ---------------------------------------------------------------------------
# against repro's shard_map programs on 8 forced host devices
# ---------------------------------------------------------------------------

REPRO_QUERIES = QUERIES[:2]
REPRO_SCRIPT = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    from repro.core import paa, strategies
    from repro.dist import compat
    from repro.graph.generators import random_labeled_graph
    from repro.graph.partition import Placement, distribute

    assert len(jax.devices()) == 8
    mesh = compat.make_mesh((4, 2), ("data", "model"))
    g = random_labeled_graph(40, 170, 4, seed=9)
    rng = np.random.default_rng(0)
    assign = rng.integers(0, 4, g.n_edges)
    pls = {
        "replicated": distribute(g, n_sites=8, replication_rate=0.2, seed=9),
        "disjoint": Placement(g, 4, [np.nonzero(assign == s)[0].astype(np.int64) for s in range(4)],
                              np.ones(g.n_edges, np.int32)),
    }
    starts = np.asarray(STARTS, np.int32)
    out = {}
    for name, pl in pls.items():
        for q in QUERIES:
            ca = paa.compile_query(q, g)
            acc, costs, lev = strategies.s2_execute(mesh, pl, ca, starts, backend="reference",
                                                    semantics="witness")
            out["reference", name, q] = (acc, [(c.broadcast_symbols, c.unicast_symbols,
                                                c.n_broadcasts) for c in costs], lev)
            acc, costs = strategies.s2_execute(mesh, pl, ca, starts, backend="frontier_kernel_sharded",
                                               block_size=8)
            out["sharded", name, q] = (acc, [c.site_unicast_symbols for c in costs])
    pl = pls["replicated"]
    arrays = pl.padded_device_arrays()
    for lbls in MASKS[:1]:
        mask = np.zeros(g.n_labels, bool)
        mask[list(lbls)] = True
        for cap in (arrays["src"].shape[1], 7):
            out["s1", lbls, cap] = strategies.s1_gather(mesh, arrays, mask, cap)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    """
).replace("STARTS", repr(STARTS.tolist())).replace("QUERIES", repr(REPRO_QUERIES)).replace(
    "MASKS", repr(MASKS))
REPRO_TIMEOUT_S = 240
CHILD_ENV = {**{k: os.environ[k] for k in ("HOME", "PATH", "TMPDIR") if k in os.environ},
             "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def repro_8_devices(tmp_path_factory):
    """``repro_8_devices()``: ``repro``'s results on a (4, 2) mesh of 8
    forced host devices, from a subprocess started when the fixture is
    made and waited for (at most ``REPRO_TIMEOUT_S``) on first use."""
    d = tmp_path_factory.mktemp("repro8")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(d / "log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", REPRO_SCRIPT, str(d / "out.pkl")],
                                stdout=log, stderr=subprocess.STDOUT, env=CHILD_ENV, cwd=cwd)
    cache = []

    def get():
        if not cache:
            try:
                rc = proc.wait(timeout=REPRO_TIMEOUT_S)
            finally:
                proc.kill()
            assert rc == 0, f"repro's 8-device run failed:\n{(d / 'log').read_text()}"
            with open(d / "out.pkl", "rb") as f:
                cache.append(pickle.load(f))
        return cache[0]

    yield get
    proc.kill()
    proc.wait()


@pytest.mark.parametrize("shape", SHAPES)
def test_ranks_equal_repro_on_8_devices(repro_8_devices, spawned, shape):
    """``repro`` on a (4, 2) mesh of forced host devices: its reference
    backend (answers, meters, witness levels) and S1 buffers equal every
    rank's bit for bit, and its sharded backend's answers and per-site
    meters too (its witness levels are ring iterations above axis size 1,
    ROADMAP §C, so they are not compared)."""
    want = repro_8_devices()
    for r in spawned(shape):
        for name in ("replicated", "disjoint"):
            for q in REPRO_QUERIES:
                acc, costs, lev = want["reference", name, q]
                got = r["reference", name, q, "witness"]
                _same(got[0], np.asarray(acc), ("reference", name, q))
                assert [c[1:4] for c in got[1]] == [tuple(c) for c in costs], ("reference", name, q)
                _same(got[2], np.asarray(lev), ("reference levels", name, q))
                acc, sites = want["sharded", name, q]
                got = r["sharded", name, q, "pairs", "f32"]
                _same(got[0], np.asarray(acc), ("sharded", name, q))
                assert [c[5] for c in got[1]] == [tuple(float(x) for x in s) for s in sites]
        for k, buffers in want.items():
            if k[0] == "s1":
                got = r[k]
                for a, b in zip(got[:4], buffers[:4]):
                    _same(a, np.asarray(b), k)
                assert got[4] == buffers[4], k
