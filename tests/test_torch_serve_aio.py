"""The port's async runtime and Stage-A persistence against ``repro``'s:
async answers bit-exact to the synchronous path, ``TokenBucket`` and the
admission decisions under a fake clock equal to ``repro``'s, the ``aio``
block's schema, cancellation and timeouts as in
``tests/test_serve_aio.py``, and snapshots that restore across the two
packages packing zero tiles.  Also the kernel loader's first load from
two threads, which the flush worker makes real."""

import asyncio
import dataclasses
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.cost_model import NetworkParams as RNet
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.kernels.frontier import ops as r_ops
from repro.serve import aio as r_aio
from repro.serve import metrics as r_metrics
from repro.serve import persist as r_persist
from repro.serve import QueryService as RService
from repro.serve import ServeConfig as RConfig

from repro_torch.core.cost_model import NetworkParams
from repro_torch.graph import generators, partition
from repro_torch.kernels import _build
from repro_torch.kernels.frontier import ops
from repro_torch.serve import metrics, persist
from repro_torch.serve.aio import AdmissionRejected, AioConfig, AsyncQueryService, TokenBucket
from repro_torch.serve.metrics import SLO_CLASSES
from repro_torch.serve.service import QueryService, ServeConfig

torch.set_num_threads(1)

NET = (150, 450, 0.2)

STREAM = [
    ("(l0|l1)+", [0, 5, 9], None),
    ("l0 l2* l3", [1, 2], "S2"),
    ("(l0|l1)+", [3], "S1"),
    ("l1 l2", [4, 0], "S1"),
    ("l0 l2* l3", [7], None),
    ("(l0|l1)+", [8, 1], "S2"),
]


@pytest.fixture(scope="module")
def twins():
    rg = r_gen.random_labeled_graph(60, 240, 4, seed=2)
    tg = generators.random_labeled_graph(60, 240, 4, seed=2)
    rp = r_part.distribute(rg, n_sites=4, replication_rate=0.3, seed=1)
    tp = partition.distribute(tg, n_sites=4, replication_rate=0.3, seed=1)
    return rg, tg, rp, tp


def make_service(twins, backend="frontier_kernel", tile_dtype="f32", **kw):
    cfg = ServeConfig(n_rollouts=30, seed=0, s2_backend=backend, s2_block_size=8,
                      s2_tile_dtype=tile_dtype, **kw)
    return QueryService(twins[3], NetworkParams(*NET), config=cfg, device="cpu")


def make_repro(twins, backend="frontier_kernel", tile_dtype="f32", **kw):
    cfg = RConfig(n_rollouts=30, seed=0, s2_backend=backend, s2_block_size=8,
                  s2_tile_dtype=tile_dtype, **kw)
    return RService(twins[2], compat.make_mesh((1, 1), ("data", "model")), RNet(*NET), config=cfg)


def run_async(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# async answers are the sync answers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend, tile_dtype", [("frontier_kernel", "f32"),
                                                 ("frontier_kernel_packed", "uint32")])
def test_async_matches_sync_bit_exact(twins, backend, tile_dtype):
    sync_svc = make_service(twins, backend, tile_dtype)
    tickets = [sync_svc.enqueue(q, s, strategy=st) for q, s, st in STREAM]
    sync_svc.flush()
    expected = [t.result() for t in tickets]
    async_svc = make_service(twins, backend, tile_dtype)

    async def drive():
        async with AsyncQueryService(async_svc) as aio:
            slos = ["latency", "throughput"]
            return await asyncio.gather(*[
                aio.submit(q, s, slo=slos[i % 2], strategy=st)
                for i, (q, s, st) in enumerate(STREAM)
            ])

    got = run_async(drive())
    for want, ans in zip(expected, got, strict=True):
        assert ans.answers == want.answers and ans.strategy == want.strategy
        assert [dataclasses.astuple(c) for c in ans.observed] == [
            dataclasses.astuple(c) for c in want.observed]
    block = async_svc.summary()["aio"]
    assert sum(block["admission"][c]["completed"] for c in SLO_CLASSES) == len(STREAM)


def test_async_witness_levels_equal_sync(twins):
    sync_svc = make_service(twins, "frontier_kernel_packed", "f32")
    want = sync_svc.submit("l0 l2* l3", [1, 2, 7], strategy="S2", semantics="witness")
    svc = make_service(twins, "frontier_kernel_packed", "f32")

    async def drive():
        async with AsyncQueryService(svc) as aio:
            return await aio.submit("l0 l2* l3", [1, 2, 7], strategy="S2", semantics="witness")

    got = run_async(drive())
    assert got.answers == want.answers and got.levels.tobytes() == want.levels.tobytes()


# ---------------------------------------------------------------------------
# admission under a fake clock, against repro
# ---------------------------------------------------------------------------


def test_token_bucket_equals_repro():
    rng = np.random.default_rng(5)
    for rate, burst in ((2.0, 1.0), (0.0, 3.0), (7.5, 2.5), (100.0, 10.0)):
        t = [0.0]
        mine, theirs = TokenBucket(rate, burst, lambda: t[0]), r_aio.TokenBucket(rate, burst, lambda: t[0])
        for _ in range(40):
            t[0] += float(rng.exponential(0.2))
            assert mine.try_take() == theirs.try_take()
            assert mine.level == theirs.level


def _admissions(svc, aio_cls, rejected_cls):
    """A fixed schedule of submits under a frozen-then-stepped fake clock:
    which were admitted, which rejected for what and with what hint."""
    t = [0.0]
    cfg_kw = dict(
        tenant_rates={"greedy": (2.0, 1.0)}, queue_depth={"latency": 3, "throughput": 2},
        min_window_s=1e6, max_window_s={"latency": 1e6, "throughput": 1e6},
    )
    cfg = (r_aio.AioConfig if aio_cls is r_aio.AsyncQueryService else AioConfig)(**cfg_kw)
    schedule = [("greedy", "latency"), ("greedy", "latency"), ("greedy", "latency"),
                ("polite", "latency"), ("polite", "latency"), ("polite", "throughput"),
                ("polite", "throughput"), ("polite", "throughput"), ("greedy", "throughput")]

    async def drive():
        out, pending = [], []
        async with aio_cls(svc, cfg, clock=lambda: t[0]) as aio:
            for i, (tenant, slo) in enumerate(schedule):
                t[0] += 0.25
                task = asyncio.ensure_future(aio.submit("l1 l2", [i], tenant=tenant, slo=slo))
                await asyncio.sleep(0)
                if task.done() and task.exception() is not None:
                    e = task.exception()
                    assert isinstance(e, rejected_cls)
                    out.append((e.reason, round(e.retry_after_s, 12)))
                else:
                    out.append("admitted")
                    pending.append(task)
            stats = aio.aio_stats()
        answers = [p.result().answers for p in pending]
        return out, stats, answers

    return run_async(drive())


def test_admission_decisions_equal_repro(twins):
    mine, mine_stats, mine_ans = _admissions(make_service(twins), AsyncQueryService, AdmissionRejected)
    theirs, their_stats, their_ans = _admissions(make_repro(twins), r_aio.AsyncQueryService,
                                                 r_aio.AdmissionRejected)
    assert mine == theirs
    assert {"admitted", ("rate_limited", 0.25)} <= set(mine)
    assert any(d != "admitted" and d[0] == "queue_full" for d in mine)
    assert mine_stats["admission"] == their_stats["admission"]
    assert mine_stats["queue_depth"] == their_stats["queue_depth"]
    assert mine_ans == their_ans


# ---------------------------------------------------------------------------
# the aio block
# ---------------------------------------------------------------------------


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else type(v).__name__ for k, v in sorted(d.items())}


def test_aio_block_has_repro_keys(twins):
    svc = make_service(twins)
    assert svc.summary()["aio"] == metrics._empty_aio_stats() == r_metrics._empty_aio_stats()

    async def drive():
        async with AsyncQueryService(svc) as aio:
            await aio.submit("l1 l2", [0])
            return aio.aio_stats()

    live = run_async(drive())
    assert _keys(live) == _keys(r_metrics._empty_aio_stats())
    assert live["latency_hist"]["latency"]["n"] == 1
    assert metrics.LATENCY_BUCKET_EDGES_MS == r_metrics.LATENCY_BUCKET_EDGES_MS
    h, rh = metrics.LatencyHistogram(), r_metrics.LatencyHistogram()
    for x in np.random.default_rng(1).lognormal(-4, 2, 300):
        h.observe(float(x))
        rh.observe(float(x))
    assert h.to_dict() == rh.to_dict()


def test_concurrent_submitters_batch_together(twins):
    svc = make_service(twins)

    async def drive():
        cfg = AioConfig(min_window_s=0.05, max_window_s={"latency": 0.1, "throughput": 0.2})
        async with AsyncQueryService(svc, cfg) as aio:
            outs = await asyncio.gather(*[
                aio.submit("(l0|l1)+", [i], strategy="S2") for i in range(12)
            ])
            return outs, aio.aio_stats()

    outs, stats = run_async(drive())
    ref = make_service(twins)
    for i, ans in enumerate(outs):
        assert ans.answers == ref.submit("(l0|l1)+", [i], strategy="S2").answers
    assert stats["batch_window"]["flushes"] < 12
    assert stats["admission"]["latency"]["completed"] == 12


def test_deadline_vs_fill_flush_triggers(twins):
    svc = make_service(twins, max_batch=8)

    async def drive():
        cfg = AioConfig(min_window_s=10.0, max_window_s={"latency": 10.0, "throughput": 10.0})
        async with AsyncQueryService(svc, cfg) as aio:
            outs = await asyncio.gather(*[
                aio.submit("(l0|l1)+", [i], strategy="S2") for i in range(8)
            ])
            return outs, aio.aio_stats()

    outs, stats = run_async(drive())
    assert all(o.answers for o in outs)
    assert stats["batch_window"]["fill_flushes"] >= 1
    assert stats["batch_window"]["deadline_flushes"] == 0


# ---------------------------------------------------------------------------
# cancellation and timeouts
# ---------------------------------------------------------------------------


def test_cancel_before_batch_drops_the_work(twins):
    svc = make_service(twins)

    async def drive():
        cfg = AioConfig(min_window_s=0.25, max_window_s={"latency": 0.25, "throughput": 0.25})
        async with AsyncQueryService(svc, cfg) as aio:
            task = asyncio.ensure_future(aio.submit("l1 l2", [0]))
            await asyncio.sleep(0.01)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
        return aio.aio_stats()

    stats = run_async(drive())
    assert stats["admission"]["latency"]["cancelled_before_batch"] == 1
    assert stats["admission"]["latency"]["completed"] == 0
    assert len(svc.metrics.records) == 0


def test_timeout_drops_queued_work(twins):
    svc = make_service(twins)

    async def drive():
        cfg = AioConfig(min_window_s=0.3, max_window_s={"latency": 0.3, "throughput": 0.3})
        async with AsyncQueryService(svc, cfg) as aio:
            with pytest.raises(asyncio.TimeoutError):
                await aio.submit("l1 l2", [0], timeout_s=0.02)
        return aio.aio_stats()

    stats = run_async(drive())
    assert stats["admission"]["latency"]["timed_out"] == 1
    assert stats["admission"]["latency"]["cancelled_before_batch"] == 1
    assert len(svc.metrics.records) == 0


def test_cancel_mid_batch_discards_the_answer(twins):
    svc = make_service(twins)
    orig_flush = svc.flush

    def slow_flush():
        time.sleep(0.25)
        return orig_flush()

    svc.flush = slow_flush

    async def drive():
        async with AsyncQueryService(svc, AioConfig(min_window_s=0.001)) as aio:
            victim = asyncio.ensure_future(aio.submit("l1 l2", [0]))
            keeper = asyncio.ensure_future(aio.submit("l1 l2", [1]))
            await asyncio.sleep(0.1)
            victim.cancel()
            with pytest.raises(asyncio.CancelledError):
                await victim
            return await keeper, aio.aio_stats()

    out, stats = run_async(drive())
    assert out.answers
    assert stats["admission"]["latency"]["cancelled_mid_batch"] == 1
    assert stats["admission"]["latency"]["completed"] == 1
    assert len(svc.metrics.records) == 2


def test_failed_flush_fails_its_batch_and_keeps_serving(twins):
    """A flush that raises on the worker thread (a kernel that fails to
    build) fails the batch's futures; the next batch is served."""
    svc = make_service(twins)
    orig_flush = svc.flush
    calls = []

    def failing_once():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("nvcc failed")
        return orig_flush()

    svc.flush = failing_once

    async def drive():
        async with AsyncQueryService(svc) as aio:
            with pytest.raises(RuntimeError, match="nvcc failed"):
                await aio.submit("l1 l2", [0])
            return await aio.submit("l1 l2", [1]), aio.aio_stats()

    out, stats = run_async(drive())
    assert out.answers is not None
    assert stats["admission"]["latency"]["failed"] == 1
    assert stats["admission"]["latency"]["completed"] == 1


# ---------------------------------------------------------------------------
# Stage-A snapshots across the two packages
# ---------------------------------------------------------------------------


QUERIES = [("(l0|l1)+", [0, 3]), ("l0 l2* l3", [1]), ("l3^-1 .", [2, 9])]


@pytest.mark.parametrize("tile_dtype", ["f32", "uint32"])
def test_repro_snapshot_restores_into_the_port(twins, tmp_path, tile_dtype):
    path = str(tmp_path / "stage_a.pkl")
    svc_r = make_repro(twins, "frontier_kernel_packed", tile_dtype)
    want = [svc_r.submit(q, s, strategy="S2").answers for q, s in QUERIES]
    manifest = svc_r.save_plan_store(path)
    assert manifest["n_entries"] == 1
    assert manifest["fingerprint"] == persist.placement_fingerprint(twins[3])
    assert persist.graph_fingerprint(twins[1]) == r_persist.graph_fingerprint(twins[0])

    svc = make_service(twins, "frontier_kernel_packed", tile_dtype)
    assert svc.restore_plan_store(path)
    staged = next(v for _, v, _ in svc.plan_store.export_entries(twins[1]))
    assert staged.tiles.dtype == (torch.int32 if tile_dtype == "uint32" else torch.float32)
    ops.reset_build_counters()
    got = [svc.submit(q, s, strategy="S2").answers for q, s in QUERIES]
    assert got == want
    assert ops.BUILD_COUNTERS["pack_blocks"] == 0 and ops.BUILD_COUNTERS["stage_graph"] == 0
    assert ops.BUILD_COUNTERS["level_schedule"] == len(QUERIES)


@pytest.mark.parametrize("tile_dtype", ["f32", "uint32"])
def test_port_snapshot_restores_into_repro(twins, tmp_path, tile_dtype):
    path = str(tmp_path / "stage_a.pkl")
    svc = make_service(twins, "frontier_kernel", tile_dtype)
    want = [svc.submit(q, s, strategy="S2").answers for q, s in QUERIES]
    manifest = svc.save_plan_store(path)
    assert manifest["fingerprint"] == r_persist.placement_fingerprint(twins[2])
    with open(path, "rb") as f:
        blob = pickle.load(f)
    (_, key, payload), = blob["entries"]
    assert key == ("staged_graph", 8, tile_dtype)
    assert payload["tiles"].dtype == (np.uint32 if tile_dtype == "uint32" else np.float32)

    svc_r = make_repro(twins, "frontier_kernel", tile_dtype)
    assert svc_r.restore_plan_store(path)
    r_ops.reset_build_counters()
    got = [svc_r.submit(q, s, strategy="S2").answers for q, s in QUERIES]
    assert got == want
    assert r_ops.BUILD_COUNTERS["pack_blocks"] == 0 and r_ops.BUILD_COUNTERS["stage_graph"] == 0


def test_snapshot_round_trip_in_the_port_is_byte_identical(twins, tmp_path):
    path = str(tmp_path / "stage_a.pkl")
    svc = make_service(twins, "frontier_kernel", "uint32")
    svc.submit("(l0|l1)+", [0], strategy="S2")
    svc.save_plan_store(path)
    fresh = make_service(twins, "frontier_kernel", "uint32")
    assert fresh.restore_plan_store(path)
    (a,), (b,) = ([v for k, v, _ in s.plan_store.export_entries(twins[1]) if k[0] == "staged_graph"]
                  for s in (svc, fresh))
    assert torch.equal(a.tiles, b.tiles) and list(a.offsets) == list(b.offsets)
    assert all(x[1].tobytes() == y[1].tobytes() and x[2].tobytes() == y[2].tobytes()
               for x, y in zip(a.offsets.values(), b.offsets.values()))


def test_sharded_entries_are_skipped_and_counted(twins, tmp_path):
    """A ``repro`` snapshot holding per-site staging (the sharded backend)
    restores its global entries; the sharded one waits for A12."""
    path = str(tmp_path / "stage_a.pkl")
    svc_r = make_repro(twins, "frontier_kernel_sharded")
    svc_r.submit("(l0|l1)+", [0], strategy="S2")
    svc_r.plan_store.staged_graph(twins[0], 8, tile_dtype="f32")
    assert svc_r.save_plan_store(path)["n_entries"] == 2
    svc = make_service(twins)
    assert svc.restore_plan_store(path)
    assert svc.plan_store.skipped_on_restore == {"staged_sharded": 1}
    assert [k for k, _, _ in svc.plan_store.export_entries(twins[1])] == [("staged_graph", 8, "f32")]


def test_restore_rejects_wrong_placement_garbage_and_version_skew(twins, tmp_path):
    path = str(tmp_path / "stage_a.pkl")
    svc = make_service(twins)
    svc.submit("(l0|l1)+", [0], strategy="S2")
    svc.save_plan_store(path)
    other = partition.distribute(twins[1], n_sites=4, replication_rate=0.3, seed=99)
    svc_c = QueryService(other, NetworkParams(*NET), config=svc.config, device="cpu")
    size0 = svc_c.plan_store.stats()["size"]
    assert not svc_c.restore_plan_store(path)
    assert svc_c.plan_store.stats()["size"] == size0
    assert not svc.restore_plan_store(str(tmp_path / "nope.pkl"))
    garbage = tmp_path / "garbage.pkl"
    garbage.write_bytes(b"not a pickle")
    assert not svc.restore_plan_store(str(garbage))
    skew = tmp_path / "skew.pkl"
    with open(skew, "wb") as f:
        pickle.dump({"format_version": persist.FORMAT_VERSION + 1,
                     "fingerprint": persist.placement_fingerprint(twins[3]),
                     "stats_epoch": 0, "entries": []}, f)
    assert not svc.restore_plan_store(str(skew))
    assert persist.FORMAT_VERSION == r_persist.FORMAT_VERSION


def test_save_is_atomic(twins, tmp_path):
    svc = make_service(twins)
    svc.submit("(l0|l1)+", [0], strategy="S2")
    path = tmp_path / "stage_a.pkl"
    svc.save_plan_store(str(path))
    assert [p.name for p in tmp_path.iterdir()] == ["stage_a.pkl"]
    with open(path, "rb") as f:
        assert pickle.load(f)["format_version"] == persist.FORMAT_VERSION


# ---------------------------------------------------------------------------
# the kernel loader from two threads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("names", [("fused_level",) * 2, ("fused_level", "embedbag") * 8])
def test_kernel_load_from_two_threads_builds_once(monkeypatch, tmp_path, names):
    """Threads that ask for the same kernels first: each kernel compiles
    once and every thread gets its one library (the flush worker beside
    the caller); two kernels still build at once."""
    n_threads, kinds = len(names), sorted(set(names))
    compiled, opened, spans = [], [], []
    start = threading.Barrier(n_threads)

    def fake_compile(name, out):
        compiled.append(name)
        t0 = time.perf_counter()
        time.sleep(0.5)  # a slow nvcc: the other threads arrive meanwhile
        spans.append((t0, time.perf_counter()))
        out.write_bytes(b"")

    monkeypatch.setattr(_build, "_lib_path", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: opened.append(path) or object())
    monkeypatch.setattr(_build, "_LIBS", {})
    libs = []

    def worker(i):
        start.wait()
        libs.append(_build.load(names[i]))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert sorted(compiled) == kinds and len(opened) == len(kinds)
    assert len(libs) == n_threads and len({id(lib) for lib in libs}) == len(kinds)
    if len(kinds) == 2:
        (a0, a1), (b0, b1) = sorted(spans)
        assert b0 < a1  # the two kernels built at once
