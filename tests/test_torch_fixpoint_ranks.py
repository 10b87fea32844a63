"""The per-rank S2 fixpoints and S1's BFS on ``ops.LevelLoop``, on the
CPU: ``repro``'s ``lax.while_loop`` inside ``shard_map``, and its
``paa._reach_fixpoint``.

* One spawn of ``gloo`` ranks per (data, model) mesh of (2, 1), (4, 1)
  and (2, 2) (``launch.ranks.run_ranks``), made once for the module.  On
  every rank the reference and sharded executors (f32 and bit-plane
  tiles), pairs and witness, at ``max_levels`` None and 2, run their
  fixpoints on the gated loop at k = 1 and k = 3 levels a host check
  (``ops.LEVELS_PER_CHECK_GLOO``, set inside the rank).  Each case equals
  the one-card run (``mesh=None``) and ``repro``'s (1, 1)-mesh run bit
  for bit (answers, meters, per-site meters, witness planes); each
  fixpoint reads the host once a body, max(1, ⌈L / k⌉) times for its L
  BFS levels, and makes one ``pmax`` a level, k a body; the ranks of a
  site group run the same bodies, on the skewed placement too, where all
  but one discover nothing.
* A one-rank mesh in this process equals ``mesh=None``.
* The PAA (``paa._accepted``, ``paa.reachable``) at k ∈ {1, 3, 8} against
  ``repro``'s ``answers_multi_source`` and ``reachable`` and the host PAA
  (``run_instrumented``), one host sync a body.
"""

import dataclasses
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import paa as r_paa
from repro.core import strategies as r_st
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.graph import structure as r_structure

from repro_torch.core import paa, strategies
from repro_torch.dist import sharding as shd
from repro_torch.graph import generators, partition, structure
from repro_torch.kernels.frontier import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import ranks

torch.set_num_threads(1)

SHAPES = [(2, 1), (4, 1), (2, 2)]
KS = [1, 3]
SPAWN_TIMEOUT_S = 150  # per spawn, inside the per-test SIGALRM of 300 s
GRAPH = (40, 170, 4, 9)  # nodes, edges, labels, seed: tests/test_torch_mesh.py's
QUERIES = ["(l0|l1)* l2 .^-1", "l0 (l1|l2)* l0"]
STARTS = np.arange(0, 40, 5, dtype=np.int32)
CUT = 2  # max_levels below the converged depth
# (backend, tile dtype, semantics)
PATHS = [("reference", "f32", "pairs"), ("reference", "f32", "witness"),
         ("frontier_kernel_sharded", "f32", "pairs"), ("frontier_kernel_sharded", "uint32", "pairs"),
         ("frontier_kernel_sharded", "f32", "witness")]
PLACEMENTS = ["replicated", "skewed"]
CASES = [(pl, q, path, cut) for pl in PLACEMENTS for q in QUERIES for path in PATHS for cut in (None, CUT)]


def _placements(g, lib) -> dict:
    """A replicated placement, and a skewed one whose edges all sit on the
    last two of 8 sites (so on the last data rank at every shape)."""
    rng = np.random.default_rng(0)
    skew = rng.integers(6, 8, g.n_edges)
    return {
        "replicated": lib.distribute(g, n_sites=8, replication_rate=0.2, seed=9),
        "skewed": lib.Placement(g, 8, [np.nonzero(skew == s)[0].astype(np.int64) for s in range(8)],
                                np.ones(g.n_edges, np.int32)),
    }


def _port_inputs():
    g = generators.random_labeled_graph(*GRAPH[:3], seed=GRAPH[3])
    return g, _placements(g, partition)


def _np(out) -> tuple:
    return (out[0], [dataclasses.astuple(c) for c in out[1]]) + tuple(out[2:])


class _Fixpoints:
    """Each ``LevelLoop.run``'s mode and counts, in call order."""

    KEYS = ("levels", "host_syncs", "bodies", "all_reduces")

    def __init__(self):
        self.runs: list[dict] = []
        real = ops.LevelLoop.run

        def run(loop, state):
            before = {k: loop.counters[k] for k in self.KEYS}
            out = real(loop, state)
            self.runs.append({"mode": loop.mode, **{k: loop.counters[k] - before[k] for k in self.KEYS}})
            return out

        ops.LevelLoop.run = run


def _run_case(pls, case, mesh, n_data=None) -> tuple:
    name, q, (backend, tile_dtype, sem), cut = case
    pl = pls[name]
    kw = {"mesh": mesh} if mesh is not None else (
        {"axis_size": n_data} if backend == "frontier_kernel_sharded" else {})
    return _np(strategies.s2_execute(pl, paa.compile_query(q, pl.graph), STARTS, max_levels=cut, backend=backend,
                                     block_size=8, tile_dtype=tile_dtype, semantics=sem, device="cpu", **kw))


def _rank_cases(mesh) -> dict:
    """Every case at each k, with its fixpoints' counts."""
    _, pls = _port_inputs()
    fixpoints = _Fixpoints()
    res = {"coord": (dist.get_rank(), mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    for k in KS:
        ops.LEVELS_PER_CHECK_GLOO = k
        for case in CASES:
            fixpoints.runs.clear()
            res[k, case] = (_run_case(pls, case, mesh), list(fixpoints.runs))
    return res


def _rank_program(rank: int, world: int, store: str, shape: tuple, out_dir: str) -> None:
    torch.set_num_threads(1)
    ranks.init_rank(rank, world, store, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    try:
        res = _rank_cases(lmesh.make_test_mesh(*shape, device="cpu"))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(shape)``: every rank's results for that mesh, from one
    spawn made on first use."""
    cache = {}

    def get(shape):
        if shape not in cache:
            d = tmp_path_factory.mktemp(f"fixpoint_{shape[0]}x{shape[1]}")
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
    """``one_card(n_data)``: every case with ``mesh=None`` (the sharded
    backend at ``axis_size`` ``n_data``), one-card loop at its own k."""
    _, pls = _port_inputs()
    cache = {}

    def get(n_data):
        if n_data not in cache:
            cache[n_data] = {case: _run_case(pls, case, None, n_data) for case in CASES}
        return cache[n_data]

    return get


_REPRO: dict = {}


def _repro(case):
    """``repro``'s run of the case on a (1, 1) mesh (its kernels in interpret
    mode): answers, costs and witness levels."""
    if case not in _REPRO:
        name, q, (backend, tile_dtype, sem), cut = case
        g = r_gen.random_labeled_graph(*GRAPH[:3], seed=GRAPH[3])
        pl = _placements(g, r_part)[name]
        out = r_st.s2_execute(compat.make_mesh((1, 1), ("data", "model")), pl, r_paa.compile_query(q, g), STARTS,
                              max_levels=cut, backend=backend, block_size=8, semantics=sem, tile_dtype=tile_dtype)
        _REPRO[case] = (np.asarray(out[0]), [dataclasses.astuple(c) for c in out[1]]) + tuple(
            np.asarray(x) for x in out[2:])
    return _REPRO[case]


def _same(a, b, what) -> None:
    """Exact equality of nested results: arrays by dtype, shape and bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), what
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, (what, i))
    else:
        assert a == b, (what, a, b)


def _check_loops(runs: list[dict], k: int, cut, what) -> None:
    """Every fixpoint ran on the gloo loop: one host sync a body, max(1,
    ⌈L / k⌉) bodies for L levels, one pmax a level (k a body), at most
    ``cut`` levels."""
    assert runs, what
    for r in runs:
        assert r["mode"] == "gloo", what
        assert r["host_syncs"] == r["bodies"] == max(1, -(-r["levels"] // k)), (what, r)
        assert r["all_reduces"] == r["bodies"] * k, (what, r)
        if cut is not None:
            assert r["levels"] <= cut, (what, r)


@pytest.mark.parametrize("path", PATHS, ids=["-".join(p) for p in PATHS])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", SHAPES)
def test_rank_fixpoints_equal_one_card_and_repro(spawned, one_card, shape, k, path):
    """On every rank, each case at k levels a check: the one-card run's and
    ``repro``'s answers, meters, per-site meters and witness planes bit for
    bit, and one host sync a body, max(1, ⌈L / k⌉) bodies a fixpoint."""
    want = one_card(shape[0])
    for r in spawned(shape):
        for case in CASES:
            if case[2] != path:
                continue
            got, runs = r[k, case]
            _same(got, want[case], (shape, k, case, "one card"))
            _same(got, _repro(case), (shape, k, case, "repro"))
            _check_loops(runs, k, case[3], (shape, k, case))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", SHAPES)
def test_site_group_ranks_run_the_same_bodies(spawned, shape, k):
    """The ranks of a site group (one model coordinate) run the same
    fixpoints with the same levels and bodies and leave after the same
    body, the skewed placement's ranks that discover nothing included;
    ``max_levels`` cuts a deeper fixpoint, and k = 3 runs fewer bodies than
    levels somewhere."""
    results = spawned(shape)
    for m in range(shape[1]):
        group = [r for r in results if r["coord"][2] == m]
        assert len(group) == shape[0]
        for case in CASES:
            counts = [[(x["levels"], x["bodies"]) for x in r[k, case][1]] for r in group]
            assert all(c == counts[0] for c in counts), (shape, k, case, counts)
            if case[3] is not None:
                assert max(lev for lev, _ in counts[0]) == case[3], (shape, k, case)
    deepest = max(x["levels"] for r in results for case in CASES for x in r[k, case][1])
    bodies = max(x["bodies"] for r in results for case in CASES for x in r[k, case][1])
    assert deepest > CUT and (bodies < deepest if k > 1 else bodies == deepest)


@pytest.mark.parametrize("shape", SHAPES)
def test_k_does_not_change_the_levels(spawned, shape):
    """Each fixpoint's BFS levels are the same at k = 1 and k = 3."""
    for r in spawned(shape):
        for case in CASES:
            levels = [[x["levels"] for x in r[k, case][1]] for k in KS]
            assert levels[0] == levels[1], (shape, case)


def test_one_rank_mesh_equals_no_mesh(tmp_path, one_card):
    """A (1, 1) mesh of one ``gloo`` rank in this process, at k = 3: every
    case equals ``mesh=None``, on the gated gloo loop, one sync a body."""
    ranks.init_rank(0, 1, str(tmp_path / "store"), device="cpu", timeout_s=60)
    real = ops.LevelLoop.run
    try:
        mesh = lmesh.make_test_mesh(1, 1, device="cpu")
        assert shd.is_device_mesh(mesh)
        ops.LEVELS_PER_CHECK_GLOO = 3
        _, pls = _port_inputs()
        fixpoints = _Fixpoints()
        for case in CASES:
            want = one_card(1)[case]
            fixpoints.runs.clear()
            _same(_run_case(pls, case, mesh), want, case)
            _check_loops(fixpoints.runs, 3, case[3], case)
    finally:
        ops.LevelLoop.run = real
        ops.LEVELS_PER_CHECK_GLOO = 1
        dist.destroy_process_group()


def test_backend_picks_the_loop_mode(tmp_path):
    """A per-rank executor picks its loop's mode from its site group's
    backend when it is built: ``gloo`` runs the eager gated body."""
    ranks.init_rank(0, 1, str(tmp_path / "store"), device="cpu", timeout_s=60)
    try:
        mesh = lmesh.make_test_mesh(1, 1, device="cpu")
        axes = strategies._RankAxes.of(mesh, ("data",), "model")
        assert axes.loop_mode() == "gloo"
    finally:
        dist.destroy_process_group()


def test_host_loop_takes_only_a_shape_only_frontier():
    """``ops.host_loop`` runs one level of a meta frontier and refuses a
    frontier with values."""
    calls = []

    def level(state, lev):
        calls.append(lev)
        return state

    state = (torch.empty((2, 3), device="meta"),)
    assert ops.host_loop(level, state, 5) is state and calls == [0]
    assert ops.host_loop(level, state, 0) is state and calls == [0]
    with pytest.raises(ValueError, match="meta"):
        ops.host_loop(level, (torch.zeros(2, 3),), 5)


# ---------------------------------------------------------------------------
# the PAA: S1's BFS and the oracle
# ---------------------------------------------------------------------------

PAA_KS = [1, 3, 8]
PAA_QUERIES = ["(l0|l1)* l2 .^-1", "l0 (l1|l2)* l0", "(l0|l2)+ l1?", ". l1"]


def _bfs_runs(monkeypatch, k) -> list[dict]:
    monkeypatch.setattr(ops, "LEVELS_PER_CHECK", k)
    runs: list[dict] = []
    real = ops.LevelLoop.run

    def run(loop, state):
        assert loop.counters is paa.BFS_COUNTERS and loop.mode == "eager"
        before = {key: paa.BFS_COUNTERS[key] for key in ("levels", "host_syncs", "bodies")}
        out = real(loop, state)
        runs.append({key: paa.BFS_COUNTERS[key] - before[key] for key in before})
        return out

    monkeypatch.setattr(ops.LevelLoop, "run", run)
    return runs


def _device_graphs():
    rg = r_gen.random_labeled_graph(*GRAPH[:3], seed=GRAPH[3])
    tg = generators.random_labeled_graph(*GRAPH[:3], seed=GRAPH[3])
    return rg, tg, r_structure.to_device_graph(rg), structure.to_device_graph(tg, "cpu")


@pytest.mark.parametrize("query", PAA_QUERIES)
@pytest.mark.parametrize("k", PAA_KS)
def test_paa_answers_equal_repro_and_host_one_sync_a_body(monkeypatch, k, query):
    """``answers_multi_source`` (``_accepted`` on the gated loop) at k
    levels a check: ``repro``'s pairs and the host PAA's answers, every
    fixpoint's BFS levels those of k = 1, one host sync a body, max(1,
    ⌈L / k⌉) bodies."""
    rg, tg, rdg, tdg = _device_graphs()
    rca, tca = r_paa.compile_query(query, rg), paa.compile_query(query, tg)
    base = _bfs_runs(monkeypatch, 1)
    paa.answers_multi_source(tca, tdg, chunk=8)
    base_levels = [r["levels"] for r in base]
    runs = _bfs_runs(monkeypatch, k)
    got = paa.answers_multi_source(tca, tdg, chunk=8)
    want = r_paa.answers_multi_source(rca, rdg, chunk=8)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want)), (query, k)
    index = paa.HostIndex(tg)
    for s in range(0, tg.n_nodes, 7):
        host = paa.run_instrumented(tca, index, s).answers
        assert set(got[1][got[0] == s].tolist()) == host, (query, k, s)
    assert [r["levels"] for r in runs] == base_levels and max(base_levels) > 1
    for r in runs:
        assert r["host_syncs"] == r["bodies"] == max(1, -(-r["levels"] // k)), (query, k, r)


@pytest.mark.parametrize("k", PAA_KS)
def test_paa_reachable_equals_repro(monkeypatch, k):
    """``paa.reachable`` from node masks: ``repro``'s visited product
    states, bit for bit, in one fixpoint, one sync a body."""
    rg, tg, rdg, tdg = _device_graphs()
    runs = _bfs_runs(monkeypatch, k)
    rng = np.random.default_rng(3)
    for query in PAA_QUERIES:
        rca, tca = r_paa.compile_query(query, rg), paa.compile_query(query, tg)
        for mask in (np.eye(tg.n_nodes, dtype=bool)[5], rng.random(tg.n_nodes) < 0.2,
                     np.zeros(tg.n_nodes, bool)):
            runs.clear()
            got = paa.reachable(tca, tdg, mask)
            want = np.asarray(r_paa.reachable(rca, rdg, jnp.asarray(mask)))
            assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), (query, k)
            (r,) = runs
            assert r["host_syncs"] == r["bodies"] == max(1, -(-r["levels"] // k)), (query, k, r)


@pytest.mark.parametrize("k", PAA_KS)
def test_paa_max_levels_cuts_the_bfs(monkeypatch, k):
    """``_accepted`` under ``max_levels`` = 2: ``repro``'s
    ``_reach_fixpoint`` at the same bound, and at most 2 levels."""
    rg, tg, rdg, tdg = _device_graphs()
    runs = _bfs_runs(monkeypatch, k)
    query = PAA_QUERIES[0]
    rca, tca = r_paa.compile_query(query, rg), paa.compile_query(query, tg)
    got = paa._accepted(tca, tdg, torch.from_numpy(STARTS.astype(np.int64)), max_levels=CUT).numpy()
    for i, s in enumerate(STARTS):
        visited = np.asarray(r_paa._reach_fixpoint(rca, rdg, jnp.zeros(tg.n_nodes, bool).at[s].set(True),
                                                   max_levels=CUT))
        assert np.array_equal(got[i], visited[list(rca.accepting)].any(axis=0)), (k, s)
    (r,) = runs
    assert r["levels"] == CUT and r["host_syncs"] == r["bodies"] == -(-CUT // k)
