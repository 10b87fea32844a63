"""The port's plan store against ``repro``'s: the out-of-core build units
(``pack_label_store``, ``assemble_staged``) byte for byte, the slab
cache's spill and reload, warm executor builds that pack no tile, a
budgeted stream bit-exact to the unbudgeted one and to ``repro``'s with
the same spill and reload counts, and the store's accounting.  Every
comparison is exact."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.core import plans as r_plans
from repro.core.cost_model import NetworkParams as RNet
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.kernels.frontier import ops as r_ops
from repro.serve import QueryService as RService
from repro.serve import ServeConfig as RConfig

from repro_torch.core import paa, plans, strategies
from repro_torch.core.cost_model import NetworkParams
from repro_torch.graph import generators, partition
from repro_torch.kernels.frontier import ops
from repro_torch.serve import QueryService, ServeConfig

torch.set_num_threads(1)

NET = (150, 450, 0.2)
DTYPES = ["f32", "uint32"]
KEYS = [(d, lid) for d in (ops.FWD, ops.INV) for lid in (0, 1, 2, 3, ops.ANY_LABEL)]


@pytest.fixture(scope="module")
def graphs():
    return r_gen.random_labeled_graph(90, 380, 4, seed=5), generators.random_labeled_graph(90, 380, 4, seed=5)


def _words(t: np.ndarray) -> bytes:
    return np.ascontiguousarray(t).tobytes()


def _same_staged(r_staged, t_staged):
    want = np.asarray(r_staged.tiles)
    got = t_staged.tiles.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert list(r_staged.offsets) == list(t_staged.offsets)
    for key, (base, rows, cols) in r_staged.offsets.items():
        t_base, t_rows, t_cols = t_staged.offsets[key]
        assert (base, rows.tobytes(), cols.tobytes()) == (t_base, t_rows.tobytes(), t_cols.tobytes())
    assert (r_staged.n_nodes, r_staged.v_pad, r_staged.block_size, r_staged.tile_dtype) == (
        t_staged.n_nodes, t_staged.v_pad, t_staged.block_size, t_staged.tile_dtype)
    assert r_staged.tile_store_bytes == t_staged.tile_store_bytes


@pytest.mark.parametrize("chunk", [None, 37])
@pytest.mark.parametrize("tile_dtype", DTYPES)
def test_pack_label_store_byte_identical(graphs, tile_dtype, chunk):
    rg, tg = graphs
    for key in KEYS + [(ops.FWD, 9)]:  # label 9: no edges, no slab
        (r_slab, r_nc), (t_slab, t_nc) = (
            r_ops.pack_label_store(rg, *key, 8, chunk, tile_dtype),
            ops.pack_label_store(tg, *key, 8, chunk, tile_dtype),
        )
        assert r_nc == t_nc, key
        if r_slab is None:
            assert t_slab is None, key
            continue
        for a, b in zip(r_slab, t_slab, strict=True):
            assert a.dtype == b.dtype and _words(a) == _words(b), key


@pytest.mark.parametrize("tile_dtype", DTYPES)
def test_any_label_slab_is_the_union_store(graphs, tile_dtype):
    """``pack_label_store(ANY_LABEL)`` == the port's staged union store."""
    _, tg = graphs
    staged = ops.stage_graph(tg, 8, tile_dtype=tile_dtype, device="cpu")
    for d in (ops.FWD, ops.INV):
        (t, r, c), _ = ops.pack_label_store(tg, d, ops.ANY_LABEL, 8, tile_dtype=tile_dtype)
        base, rows, cols = staged.offsets[(d, ops.ANY_LABEL)]
        held = staged.tiles[base : base + len(rows)].numpy()
        assert _words(held) == _words(t.view(held.dtype))
        assert rows.tobytes() == r.tobytes() and cols.tobytes() == c.tobytes()


@pytest.mark.parametrize("tile_dtype", DTYPES)
def test_assemble_staged_byte_identical(graphs, tile_dtype):
    rg, tg = graphs
    for keys in (KEYS, [(ops.FWD, 1), (ops.INV, ops.ANY_LABEL), (ops.INV, 3)]):
        r_stores = {k: r_ops.pack_label_store(rg, *k, 8, None, tile_dtype)[0] for k in keys}
        t_stores = {k: ops.pack_label_store(tg, *k, 8, None, tile_dtype)[0] for k in keys}
        _same_staged(
            r_ops.assemble_staged(r_stores, rg.n_nodes, 8, tile_dtype),
            ops.assemble_staged(t_stores, tg.n_nodes, 8, tile_dtype, device="cpu"),
        )
    # the whole set of slabs assembles to the full staging
    _same_staged(
        r_ops.stage_graph(rg, 8, tile_dtype=tile_dtype),
        plans._SlabCache(tg, 8, tile_dtype, device="cpu").assemble(),
    )


def test_label_degree_shortcut_equals_the_edge_scan(graphs):
    rg, tg = graphs
    v_pad = 96
    want = r_plans.label_degree_vectors([rg], rg.n_labels, v_pad)
    got = plans.label_degree_vectors([tg], tg.n_labels, v_pad)
    assert got.tobytes() == want.tobytes()
    for expr in ("l0 (l1|l2)* l3^-1", ". l1+", "(l2|l3)^-1 ."):
        sgroups = strategies.symbol_set_groups(paa.compile_query(expr, tg))
        deg, pay = strategies._site_symbol_degrees(sgroups, [tg], v_pad)
        deg2, pay2 = strategies._site_symbol_degrees(sgroups, [tg], v_pad, got)
        assert deg.tobytes() == deg2.tobytes() and pay.tobytes() == pay2.tobytes(), expr


@pytest.mark.parametrize("backend", ["frontier_kernel", "frontier_kernel_packed"])
def test_warm_build_packs_zero_tiles(graphs, backend):
    """The second signature on a hot store builds Stage B only, full and
    budgeted; answers equal the executor that stages its own."""
    _, tg = graphs
    store = plans.GraphPlanStore(device="cpu")
    starts = np.arange(0, 90, 7)
    for budget in (None, 10**9):
        kw = dict(graph=tg, block_size=8, backend=backend, plan_store=store,
                  tile_store_budget_bytes=budget)
        strategies.make_s2_step_fn(paa.compile_query("l0 l1*", tg), tg.n_nodes, **kw)
        ops.reset_build_counters()
        ca = paa.compile_query("(l1|l0)+ l0", tg)
        fn = strategies.make_s2_step_fn(ca, tg.n_nodes, **kw)
        assert ops.BUILD_COUNTERS["pack_blocks"] == 0 and ops.BUILD_COUNTERS["stage_graph"] == 0
        assert ops.BUILD_COUNTERS["level_schedule"] == 1
        cold = strategies.make_s2_step_fn(ca, tg.n_nodes, graph=tg, block_size=8, backend=backend,
                                          device="cpu")
        for a, b in zip(fn(starts), cold(starts), strict=True):
            assert torch.equal(a, b)
    assert store.stats()["hits"] >= 2


def test_spilled_slab_reloads_byte_identical(graphs):
    _, tg = graphs
    cache = plans._SlabCache(tg, 8, "uint32", device="cpu")
    fresh = {k: ops.pack_label_store(tg, *k, 8, tile_dtype="uint32")[0] for k in KEYS}
    cache.budget_bytes = 1  # keeps only the slabs of the current assembly
    first = cache.assemble(((ops.FWD, 0), (ops.FWD, 1)))
    cache.assemble(((ops.INV, 2),))
    assert cache.spills == 2 and cache.spilled_slabs() == 2 and cache.reloads == 0
    again = cache.assemble(((ops.FWD, 0), (ops.FWD, 1)))
    assert cache.reloads == 2 and ops.BUILD_COUNTERS["reloads"] >= 2
    assert torch.equal(first.tiles, again.tiles)
    for k in ((ops.FWD, 0), (ops.FWD, 1)):
        for a, b in zip(cache._slabs[k], fresh[k], strict=True):
            assert a.dtype == b.dtype and _words(a) == _words(b)
    # a vanished spill file rebuilds from the edge stream
    os.remove(cache._spilled[(ops.INV, 2)])
    before = cache.reloads
    cache.assemble(((ops.INV, 2),))
    assert cache.reloads == before
    for a, b in zip(cache._slabs[(ops.INV, 2)], fresh[(ops.INV, 2)], strict=True):
        assert _words(a) == _words(b)
    spill_dir = cache._dir
    del cache, first, again
    import gc

    gc.collect()
    assert not os.path.exists(spill_dir)


def _services(budget, backend, tile_dtype):
    rg = r_gen.random_labeled_graph(90, 380, 4, seed=5)
    tg = generators.random_labeled_graph(90, 380, 4, seed=5)
    rp = r_part.distribute(rg, n_sites=4, replication_rate=0.3, seed=1)
    tp = partition.distribute(tg, n_sites=4, replication_rate=0.3, seed=1)
    kw = dict(n_rollouts=30, seed=0, s2_backend=backend, s2_block_size=8, s2_tile_dtype=tile_dtype,
              tile_store_budget_bytes=budget)
    r = RService(rp, compat.make_mesh((1, 1), ("data", "model")), RNet(*NET), config=RConfig(**kw))
    t = QueryService(tp, NetworkParams(*NET), config=ServeConfig(**kw), device="cpu")
    return r, t


# every label, both directions and the union stores, in turn
ALL_LABELS = ["l0 l1", "l2^-1 l3", "(l1|l3)+", ". l0^-1", "l3 l2 l1 l0", "l0* l2", "l1^-1 (l0|l2)"]


@pytest.mark.parametrize("backend, tile_dtype", [("frontier_kernel", "f32"),
                                                 ("frontier_kernel_packed", "uint32")])
def test_budgeted_stream_bit_exact_with_repro_spill_counts(backend, tile_dtype):
    stream, starts = ALL_LABELS + ALL_LABELS[::-1], [0, 11, 23, 47, 88]
    _, full = _services(None, backend, tile_dtype)
    unbudgeted = [full.submit(q, starts, strategy="S2").answers for q in stream]
    r_svc, t_svc = _services(3000 if tile_dtype == "f32" else 100, backend, tile_dtype)
    r_ops.reset_build_counters()
    ops.reset_build_counters()
    for q, answers in zip(stream, unbudgeted):
        want = r_svc.submit(q, starts, strategy="S2")
        got = t_svc.submit(q, starts, strategy="S2")
        assert got.answers == want.answers == answers, q
        assert [dataclasses.astuple(c) for c in got.observed] == [
            dataclasses.astuple(c) for c in want.observed]
    stats = t_svc.plan_store.tile_store_stats()
    assert stats == r_svc.plan_store.tile_store_stats()
    assert stats["spills"] > 0 and stats["reloads"] > 0
    for k in ("spills", "reloads", "pack_blocks"):
        assert ops.BUILD_COUNTERS[k] == r_ops.BUILD_COUNTERS[k], k
    assert t_svc.plan_store.stats() == r_svc.plan_store.stats()
    assert t_svc.summary()["frontier_mem"] == r_svc.summary()["frontier_mem"]


def test_store_accounting_equals_repro(graphs):
    rg, tg = graphs
    rp = r_part.distribute(rg, n_sites=3, replication_rate=0.4, seed=2)
    tp = partition.distribute(tg, n_sites=3, replication_rate=0.4, seed=2)
    r_store, t_store = r_plans.GraphPlanStore(maxsize=4), plans.GraphPlanStore(maxsize=4, device="cpu")
    for store, g, p in ((r_store, rg, rp), (t_store, tg, tp)):
        for td in DTYPES:
            store.staged_graph(g, 8, epoch=0, tile_dtype=td)
        store.staged_graph(g, 8, epoch=0, tile_dtype="f32")
        store.staged_graph(g, 8, epoch=0, tile_dtype="f32", budget_bytes=2000,
                           keys=((ops.FWD, 0), (ops.INV, ops.ANY_LABEL)))
        store.staged_graph(g, 8, epoch=0, tile_dtype="f32", budget_bytes=2000, keys=((ops.FWD, 1),))
        store.local_graphs(p, epoch=0)
        store.label_degrees(g, [g], g.n_labels, 96, epoch=1)
        store.site_device_arrays(p, epoch=1)
    assert t_store.stats() == r_store.stats()
    assert t_store.tile_store_stats() == r_store.tile_store_stats()
    assert t_store.pad_stats() == r_store.pad_stats()
    assert t_store.staging_chunks == r_store.staging_chunks and t_store.hit_rate == r_store.hit_rate
    assert [k for k, _, _ in t_store.export_entries(tg)] == [k for k, _, _ in r_store.export_entries(rg)]
    assert t_store.invalidate_epoch(1) == r_store.invalidate_epoch(1)
    assert t_store.stats() == r_store.stats()
    arrays = t_store.site_device_arrays(tp, epoch=1)
    want = r_store.site_device_arrays(rp, epoch=1)
    assert all(np.array_equal(arrays[k].numpy(), want[k]) for k in want)
    t_store.clear()
    r_store.clear()
    assert t_store.stats() == r_store.stats() and len(t_store) == 0


def test_budget_without_a_store_raises(graphs):
    _, tg = graphs
    ca = paa.compile_query("l0", tg)
    with pytest.raises(ValueError, match="plan_store"):
        strategies.make_s2_step_fn(ca, tg.n_nodes, graph=tg, block_size=8, device="cpu",
                                   tile_store_budget_bytes=1)
    store = plans.GraphPlanStore(device="cpu")
    with pytest.raises(ValueError, match="not both"):
        strategies.make_s2_step_fn(ca, tg.n_nodes, graph=tg, block_size=8, plan_store=store,
                                   staged=ops.stage_graph(tg, 8, device="cpu"))


def test_witness_executor_stages_f32_from_the_store(graphs):
    """A witness executor asking for bit-planes fetches the f32 store."""
    _, tg = graphs
    store = plans.GraphPlanStore(device="cpu")
    ca = paa.compile_query("l0 l1*", tg)
    fn = strategies.make_s2_step_fn(ca, tg.n_nodes, graph=tg, block_size=8, plan_store=store,
                                    tile_dtype="uint32", semantics="witness")
    assert len(fn(np.arange(4))) == 5
    assert store.tile_store_stats()["bytes_by_dtype"]["uint32"] == 0
    assert store.tile_store_stats()["bytes_by_dtype"]["f32"] > 0


@pytest.mark.parametrize("method", ["staged_sharded", "staged_merged", "tile_buckets"])
def test_sharded_artifacts_raise_naming_a12(graphs, method):
    store = plans.GraphPlanStore(device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        getattr(store, method)(None, 8)


def test_pad_accounting_equals_repro():
    class Bucket:
        def __init__(self, n_steps, n_tiles, sites):
            self.n_steps, self.n_tiles, self.sites = n_steps, n_tiles, sites

    class Plan:
        useful_steps, padded_steps = 17, 24
        buckets = (Bucket(8, 16, (0, 1)), Bucket(16, 32, (2,)))

    r_store, t_store = r_plans.GraphPlanStore(), plans.GraphPlanStore(device="cpu")
    for store in (r_store, t_store):
        store.record_plan_pad_waste(Plan())
        store.record_plan_pad_waste(Plan())
    assert t_store.pad_stats() == r_store.pad_stats()


def test_staged_graph_parity_through_the_store(graphs):
    rg, tg = graphs
    for td in DTYPES:
        _same_staged(
            r_plans.GraphPlanStore().staged_graph(rg, 8, tile_dtype=td, chunk_edges=41),
            plans.GraphPlanStore(device="cpu").staged_graph(tg, 8, tile_dtype=td, chunk_edges=41),
        )
    r_ca, t_ca = r_paa.compile_query("l0 .", rg), paa.compile_query("l0 .", tg)
    assert r_ops.required_offset_keys(r_ca) == ops.required_offset_keys(t_ca)
