"""The per-transition baseline path of the port against ``repro``'s:
``make_blocked_graph``, the B5 step ``frontier_step_blocks`` (its plain
version on the CPU; ``repro``'s Pallas kernel in interpret mode),
``expand_level``, ``multi_source_reach_baseline``, and Stage A and the
fused fixpoint from a ``BlockedGraph``.  Every comparison is exact:
operands are {0,1} and every sum is an integer below 2^24, so f32 is
exact in any order on both sides."""

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

torch.set_num_threads(1)


def _sparse_label_graph(mod):
    """Label l2 has no edges, so it has no store and launches nothing."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 45, 200).astype(np.int32)
    dst = rng.integers(0, 45, 200).astype(np.int32)
    lbl = rng.choice([0, 1, 3], 200).astype(np.int32)
    return mod.LabeledGraph(45, src, lbl, dst, ["l0", "l1", "l2", "l3"])


# (graph factory taking the structure/generators modules, block, query):
# the CASES of tests/test_torch_cuda.py — a wildcard with an inverse; a
# random graph; a sparse query whose column blocks are mostly unvisited —
# and a graph with an empty label store
CASES = [
    (lambda s, g: s.example_graph(), 8, "(a|b)+ .^-1"),
    (lambda s, g: g.random_labeled_graph(50, 220, 3, seed=7), 16, "l0 (l1|l2)* l0"),
    (lambda s, g: g.random_labeled_graph(300, 500, 3, seed=11), 32, "l0 l1"),
    (lambda s, g: _sparse_label_graph(s), 8, "(l0|l2)+ .^-1 l3^-1"),
]


def _both(case):
    """``repro``'s graph, BlockedGraph and automaton, and the port's."""
    factory, block, expr = CASES[case]
    rg, tg = factory(r_struct, r_gen), factory(structure, generators)
    rbg = r_ops.make_blocked_graph(rg, block)
    tbg = ops.make_blocked_graph(tg, block, device="cpu")
    return rg, tg, rbg, tbg, r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)


def _stores(bg):
    return {(d, lid): e for d, st in (("fwd", bg.fwd), ("inv", bg.inv)) for lid, e in st.items()}


@pytest.mark.parametrize("case", range(len(CASES)))
def test_make_blocked_graph_byte_identical(case):
    rg, _, rbg, tbg, _, _ = _both(case)
    assert (tbg.n_nodes, tbg.v_pad, tbg.block_size) == (rbg.n_nodes, rbg.v_pad, rbg.block_size)
    r_stores, t_stores = _stores(rbg), _stores(tbg)
    assert list(t_stores) == list(r_stores)
    carried = interop.blocked_graph_from_numpy(
        rbg.n_nodes, rbg.block_size,
        {lid: tuple(np.asarray(a) for a in e) for lid, e in rbg.fwd.items()},
        {lid: tuple(np.asarray(a) for a in e) for lid, e in rbg.inv.items()},
        device="cpu",
    )
    for key, (tiles, rows, cols) in r_stores.items():
        t, r, c, work = t_stores[key]
        assert t.dtype == torch.float32 and t.numpy().tobytes() == np.asarray(tiles).tobytes()
        assert r.numpy().tobytes() == np.asarray(rows).tobytes()
        assert c.numpy().tobytes() == np.asarray(cols).tobytes()
        want = ops.level_work(np.ones(len(cols), np.int32), ops.column_runs(np.asarray(cols)),
                              ops.WORK_CHUNK_F32)
        assert work.numpy().tobytes() == want.tobytes()
        for a, b in zip(_stores(carried)[key], t_stores[key]):
            assert a.numpy().tobytes() == b.numpy().tobytes()
    if case == 3:
        assert 2 not in tbg.fwd and 2 not in tbg.inv  # l2: no edges, no store


def test_make_blocked_graph_counts_builds():
    ops.BUILD_COUNTERS.clear()
    g = _sparse_label_graph(structure)
    ops.make_blocked_graph(g, 8, device="cpu")
    assert ops.BUILD_COUNTERS == {"make_blocked_graph": 1, "pack_blocks": 6, "store_work": 6}


def test_column_runs():
    assert ops.column_runs(np.array([0, 0, 2, 3, 3, 3])).tolist() == [0, 2, 3, 6]
    assert ops.column_runs(np.array([4])).tolist() == [0, 1]
    with pytest.raises(ValueError, match="non-decreasing"):
        ops.column_runs(np.array([1, 0]))


@pytest.mark.parametrize("m_pad", [8, 16])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_step_plain_equals_pallas_kernel(case, m_pad):
    """frontier_step_blocks (the plain version, on CPU tensors) equals
    repro's frontier_step_blocks(interpret=True) on every column block a
    tile visits; the port's unvisited blocks are zero."""
    _, _, rbg, tbg, _, _ = _both(case)
    rng = np.random.default_rng(m_pad + case)
    b = tbg.block_size
    for key, (tiles, rows, cols, work) in _stores(tbg).items():
        f = (rng.random((m_pad, tbg.v_pad)) < 0.3).astype(np.float32)
        want = np.asarray(r_frontier.frontier_step_blocks(
            jnp.asarray(f), *(jnp.asarray(a.numpy()) for a in (tiles, rows, cols)), b, interpret=True,
        ))
        got = frontier.frontier_step_blocks(
            torch.from_numpy(f), tiles, rows, cols, b, work=work
        ).numpy()
        visited = np.zeros(tbg.v_pad // b, bool)
        visited[cols.numpy()] = True
        got3, want3 = (x.reshape(m_pad, -1, b) for x in (got, want))
        assert got3[:, visited].tobytes() == want3[:, visited].tobytes(), key
        assert not got3[:, ~visited].any(), key


@pytest.mark.parametrize("case", range(len(CASES)))
def test_expand_level_bit_exact(case):
    """expand_level equals repro's fused level (row 0 of each state's 8
    query rows) and the port's, bit for bit.  Against repro's own
    expand_level it is exact wherever that is defined: repro's Pallas step
    leaves unvisited column blocks unwritten (NaN in interpret mode), and
    its amax merge lets such a NaN overwrite another store's 1; the port
    zero-fills them (ROADMAP §C).  So the port reaches every node repro's
    baseline reaches, and any node beyond lies in a column block that one
    of the destination's stores leaves unvisited."""
    rg, _, rbg, tbg, rca, tca = _both(case)
    rng = np.random.default_rng(30 + case)
    f = (rng.random((tca.n_states, tbg.v_pad)) < 0.2).astype(np.float32)
    f[:, rg.n_nodes :] = 0.0
    got = ops.expand_level(tca, tbg, torch.from_numpy(f)).numpy()
    plan = ops.build_level_plan(tca, tbg)
    r_plan = r_ops.build_level_plan(rca, rbg)
    f8 = np.zeros((tca.n_states, plan.q_pad, plan.v_pad), np.float32)
    f8[:, 0] = f
    f8 = f8.reshape(-1, plan.v_pad)
    want = np.asarray(r_ops.expand_level_fused(r_plan, jnp.asarray(f8), interpret=True))
    want = want.reshape(tca.n_states, plan.q_pad, -1)[:, 0]
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    fused = ops.expand_level_fused(plan, torch.from_numpy(f8)).numpy()
    assert fused.reshape(tca.n_states, plan.q_pad, -1)[:, 0].tobytes() == want.tobytes()
    baseline = np.asarray(r_ops.expand_level(rca, rbg, jnp.asarray(f), interpret=True))
    assert (baseline <= got).all()
    b = tbg.block_size
    for dst, node in zip(*np.nonzero(got != baseline)):
        unvisited = [
            node // b not in set(entry[2].tolist())
            for t, entry in ops.baseline_entries(tca, tbg) if t.dst == dst
        ]
        assert any(unvisited), (dst, node)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_multi_source_reach_baseline_bit_exact(case):
    """Baseline answers equal repro's baseline, the port's fused fixpoint
    on the same BlockedGraph, and the host PAA; one level and one host
    sync per expand_level, one step launch per (transition, store)."""
    rg, _, rbg, tbg, rca, tca = _both(case)
    index = r_paa.HostIndex(rg)
    for start in range(0, rg.n_nodes, max(1, rg.n_nodes // 6)):
        mask = np.zeros(rg.n_nodes, np.float32)
        mask[start] = 1.0
        want = r_ops.multi_source_reach_baseline(rca, rbg, mask, interpret=True)
        ops.FIXPOINT_COUNTERS.clear()
        got = ops.multi_source_reach_baseline(tca, tbg, mask)
        levels = ops.FIXPOINT_COUNTERS["levels"]
        assert got.dtype == bool and (got == want).all(), start
        assert levels >= 1 and ops.FIXPOINT_COUNTERS["host_syncs"] == levels
        assert (ops.multi_source_reach(tca, tbg, mask) == want).all(), start
        assert set(np.nonzero(got)[0].tolist()) == r_paa.run_instrumented(rca, index, start).answers


def test_baseline_on_cpu_launches_no_kernel():
    _, _, _, tbg, _, tca = _both(0)
    before = frontier.launch_counts()
    mask = np.zeros(tbg.n_nodes, np.float32)
    mask[0] = 1.0
    ops.multi_source_reach_baseline(tca, tbg, mask)
    assert frontier.launch_counts() == before


@pytest.mark.parametrize("case", range(len(CASES)))
def test_stage_graph_from_blocked_byte_identical(case):
    """Stage A from a BlockedGraph equals Stage A from the graph, the
    port's and repro's, union stores included."""
    rg, tg, rbg, tbg, rca, tca = _both(case)
    block = tbg.block_size
    from_blocked = ops.stage_graph(tbg)
    from_graph = ops.stage_graph(tg, block, device="cpu")
    r_staged = r_ops.stage_graph(rbg, block)
    for other in (from_graph, r_staged):
        assert from_blocked.tiles.numpy().tobytes() == np.asarray(other.tiles).tobytes()
        assert list(from_blocked.offsets) == list(other.offsets)
        for key, (base, rows, cols) in from_blocked.offsets.items():
            o_base, o_rows, o_cols = other.offsets[key]
            assert (base, rows.tobytes(), cols.tobytes()) == (
                o_base, np.asarray(o_rows).tobytes(), np.asarray(o_cols).tobytes()
            ), key
    plan = ops.build_level_plan(tca, tbg)
    want = ops.build_level_schedule(tca, from_graph)
    for name in ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols", "run_ptr"):
        assert torch.equal(getattr(plan, name), getattr(want, name)), name


def test_stage_graph_from_blocked_refuses_uint32():
    _, _, _, tbg, _, _ = _both(0)
    with pytest.raises(ValueError, match="pre-packed f32 tiles"):
        ops.stage_graph(tbg, tile_dtype="uint32")


def test_make_blocked_graph_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.make_blocked_graph(structure.example_graph(), 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.blocked_graph_from_numpy(9, 8, {}, {})


# ---------------------------------------------------------------------------
# Kernel B5's work list: each store's tiles in chunks inside column runs
# ---------------------------------------------------------------------------


def _hub_graph(mod):
    """Every node has an l0 edge into node 3, so at block 8 the column
    block of node 3 holds a run of 25 tiles in the l0 store (and a row of
    25 in its inverse), beside random l1 edges."""
    rng = np.random.default_rng(21)
    n = 200
    src = np.concatenate([np.arange(n), rng.integers(0, n, 300)]).astype(np.int32)
    dst = np.concatenate([np.full(n, 3), rng.integers(0, n, 300)]).astype(np.int32)
    lbl = np.concatenate([np.zeros(n), np.ones(300)]).astype(np.int32)
    return mod.LabeledGraph(n, src, lbl, dst, ["l0", "l1"])


# the CASES, then the hub graph (block 8, query "l0 l1^-1")
WORK_CASES = list(range(len(CASES))) + ["hub"]


def _blocked_pair(case):
    if case == "hub":
        rg, tg = _hub_graph(r_struct), _hub_graph(structure)
        return rg, r_ops.make_blocked_graph(rg, 8), ops.make_blocked_graph(tg, 8, device="cpu")
    rg, _, rbg, tbg, _, _ = _both(case)
    return rg, rbg, tbg


@pytest.mark.parametrize("case", WORK_CASES)
def test_store_work_covers_every_tile_once_in_runs(case):
    """Each store's work list holds every tile exactly once, in order, in
    chunks of at most WORK_CHUNK_F32 that each stay inside one column's
    run and fill from their start."""
    _, _, tbg = _blocked_pair(case)
    longest = 0
    for key, (tiles, rows, cols, work) in _stores(tbg).items():
        w, c = work.numpy(), cols.numpy()
        assert work.dtype == torch.int32 and w.ndim == 2 and w.shape[1] == ops.WORK_CHUNK_F32, key
        filled = w >= 0
        assert filled[:, 0].all() and (np.diff(filled.astype(np.int8), axis=1) <= 0).all(), key
        assert np.array_equal(w[filled], np.arange(tiles.shape[0])), key
        assert all(len(set(c[row[row >= 0]].tolist())) == 1 for row in w), key
        longest = max(longest, int(np.diff(ops.column_runs(c)).max()))
    if case == "hub":
        assert longest > 2 * ops.WORK_CHUNK_F32


def test_store_work_chunks_inside_column_runs():
    cols = np.array([0, 0, 0, 0, 0, 2, 3, 3], np.int32)
    assert ops.store_work(cols).tolist() == [[i] for i in range(8)]
    runs = ops.column_runs(cols)
    assert ops.level_work(np.ones(8, np.int32), runs, 2).tolist() == [
        [0, 1], [2, 3], [4, -1], [5, -1], [6, 7]]


def test_baseline_builds_no_work_list():
    """make_blocked_graph builds each store's work list once; the levels
    of the baseline fixpoint read it and build nothing."""
    _, _, tbg = _blocked_pair("hub")
    ca = paa.compile_query("l0 l1^-1", _hub_graph(structure))
    ops.BUILD_COUNTERS.clear()
    mask = np.zeros(tbg.n_nodes, np.float32)
    mask[7] = 1.0
    ops.FIXPOINT_COUNTERS.clear()
    ops.multi_source_reach_baseline(ca, tbg, mask)
    assert ops.FIXPOINT_COUNTERS["levels"] >= 2 and not ops.BUILD_COUNTERS


def _step_by_chunks(f, tiles, rows, cols, work, b):
    """frontier_step_blocks as B5 runs it: for each 8-row block of the
    frontier and each chunk of the work list, the chunk's products summed
    into an 8 × B block, added into a zeroed output."""
    out = torch.zeros(f.shape)
    r_, c_ = rows.numpy(), cols.numpy()
    for rb in range(f.shape[0] // 8):
        fr = f[rb * 8 : rb * 8 + 8]
        for row in work.numpy():
            steps = row[row >= 0]
            acc = torch.zeros((8, b))
            for i in steps:
                acc += fr[:, r_[i] * b : r_[i] * b + b] @ tiles[i]
            col = c_[steps[0]]
            out[rb * 8 : rb * 8 + 8, col * b : col * b + b] += acc
    return out


@pytest.mark.parametrize("chunk", [ops.WORK_CHUNK_F32, 3])
@pytest.mark.parametrize("m_pad", [8, 24])
@pytest.mark.parametrize("case", WORK_CASES)
def test_step_summed_by_chunks_equals_plain_and_repro(case, m_pad, chunk):
    """The chunk-by-chunk twin of B5, on each store's own work list and on
    one of chunks of 3, equals frontier_step_blocks_plain bit for bit and
    repro's frontier_step_blocks (interpret mode) on every visited column
    block; unvisited blocks are zero."""
    _, _, tbg = _blocked_pair(case)
    rng = np.random.default_rng(m_pad + chunk)
    b = tbg.block_size
    for key, (tiles, rows, cols, work) in _stores(tbg).items():
        if chunk != ops.WORK_CHUNK_F32:
            work = torch.from_numpy(ops.level_work(
                np.ones(tiles.shape[0], np.int32), ops.column_runs(cols.numpy()), chunk))
        f = (rng.random((m_pad, tbg.v_pad)) < 0.3).astype(np.float32)
        f[:, tbg.n_nodes :] = 0.0
        ft = torch.from_numpy(f)
        got = _step_by_chunks(ft, tiles, rows, cols, work, b)
        plain = frontier.frontier_step_blocks_plain(ft, tiles, rows, cols, b)
        assert got.numpy().tobytes() == plain.numpy().tobytes(), key
        want = np.asarray(r_frontier.frontier_step_blocks(
            jnp.asarray(f), *(jnp.asarray(a.numpy()) for a in (tiles, rows, cols)), b, interpret=True,
        ))
        visited = np.zeros(tbg.v_pad // b, bool)
        visited[cols.numpy()] = True
        got3, want3 = (x.reshape(m_pad, -1, b) for x in (got.numpy(), want))
        assert got3[:, visited].tobytes() == want3[:, visited].tobytes(), key
        assert not got3[:, ~visited].any(), key
