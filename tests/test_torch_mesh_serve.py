"""The serving runtime over ``gloo`` ranks on the CPU: ``QueryService``
with ``mesh=`` (rank 0 leads, the others follow its flush orders) and
``AsyncQueryService`` led by rank 0, against the port's one-card service
(``mesh=None``) at the same ``axis_size``, and against ``repro``'s
``QueryService`` on a (4, 2) mesh of 8 forced host devices.

One spawn of 4 ``gloo`` ranks (``launch.ranks.run_ranks``, rendezvous on
a ``FileStore``) runs every case on a (2, 1) mesh (ranks 0 and 1), a
(4, 1) and a (2, 2) mesh, in turn, and writes each rank's results to a
file.  The input is ``repro``'s 8-device test's graph
(``random_labeled_graph(48, 200, 4, seed=9)`` on 8 sites) and a seeded
16-request stream, in four windows: S1 forced, the planner deciding, S2
witness requests, S1 witness requests.
"""

import asyncio
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
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import paa, plans, strategies
from repro_torch.core.cost_model import NetworkParams
from repro_torch.dist import collectives
from repro_torch.graph import generators, partition, workloads
from repro_torch.kernels.frontier import ops
from repro_torch.launch import ranks
from repro_torch.launch.mesh import MeshLayout
from repro_torch.serve import ExecutorCache, QueryService, ServeConfig, automaton_signature, persist
from repro_torch.serve.aio import AioConfig, AsyncQueryService
from repro_torch.serve.service import batch_multiple

torch.set_num_threads(1)

SHAPES = [(2, 1), (4, 1), (2, 2)]
WORLD = 4
SPAWN_TIMEOUT_S = 200  # inside the per-test SIGALRM of 300 s
NET = (150, 450, 0.2)
CONFIGS = {
    "sharded_f32": dict(s2_backend="frontier_kernel_sharded", s2_tile_dtype="f32"),
    "sharded_uint32": dict(s2_backend="frontier_kernel_sharded", s2_tile_dtype="uint32"),
    "reference": dict(),
    "packed": dict(s2_backend="frontier_kernel_packed", s2_tile_dtype="uint32"),
}
WINDOWS = [  # (requests of the stream, their keywords)
    (slice(0, 5), {"strategy": "S1"}),
    (slice(5, 12), {}),
    (slice(12, 16), {"strategy": "S2", "semantics": "witness"}),
    (slice(0, 2), {"strategy": "S1", "semantics": "witness"}),
]
ASYNC_WINDOWS = [0, 2, 3]  # the windows whose strategy is forced: batching cannot change them
AIO = dict(max_window_s={"latency": 0.02, "throughput": 0.05}, min_window_s=0.001)


def _setup():
    g = generators.random_labeled_graph(48, 200, 4, seed=9)
    pl = partition.distribute(g, n_sites=8, replication_rate=0.3, seed=9)
    stream = workloads.generate(g, workloads.WorkloadConfig(n_queries=16, hot_pool=4, max_starts=6, seed=0))
    return g, pl, stream


def _service(pl, name, mesh, axis_size):
    cfg = ServeConfig(n_rollouts=40, seed=0, s2_block_size=8, **CONFIGS[name])
    return QueryService(pl, NetworkParams(*NET), config=cfg, device="cpu", mesh=mesh,
                        axis_size=axis_size if mesh is None else None)


def _answer(a) -> tuple:
    """An ``Answers``' query, strategy, semantics, answers, costs and
    witness levels (a list)."""
    levels = None if a.levels is None else a.levels.tolist()
    return (a.query, a.strategy, a.semantics, [sorted(s) for s in a.answers],
            [dataclasses.astuple(c) for c in a.observed], levels)


def _ticket(t) -> tuple:
    """What a ticket resolved to (:func:`_answer`), or its error's type,
    message and raising rank."""
    if t.error is not None:
        return ("error", type(t.error).__name__, str(t.error), getattr(t.error, "rank", None))
    return _answer(t.result())


def _windows(svc, stream, windows=WINDOWS):
    """The stream through ``svc`` window by window (the leader enqueues
    and flushes; a follower follows until the leader's stop order)."""
    if not svc.leader:
        return svc.follow()
    tickets = []
    for sl, kw in windows:
        tickets += [svc.enqueue(w.query, w.starts, **kw) for w in stream[sl]]
        svc.flush()
    svc.stop_followers()
    return tickets


def _run(pl, stream, name, mesh, axis_size):
    """The stream's windows on a fresh service: the service, its tickets
    and its records' (strategy, exec batch) in execution order."""
    svc = _service(pl, name, mesh, axis_size)
    tickets = _windows(svc, stream)
    return svc, [_ticket(t) for t in tickets], [(r.strategy, r.exec_batch_size) for r in svc.metrics.records]


def _async(pl, stream, mesh, axis_size):
    """The forced windows' requests through ``AsyncQueryService`` on the
    leader (at once, one task each), the followers following; each
    rank's tickets as a sorted list (flushes may group them otherwise)."""
    svc = _service(pl, "sharded_f32", mesh, axis_size)
    if not svc.leader:
        return sorted(map(repr, (_ticket(t) for t in svc.follow())))

    async def drive():
        async with AsyncQueryService(svc, AioConfig(**AIO)) as aio:
            return await asyncio.gather(*[
                aio.submit(w.query, w.starts, slo=("latency", "throughput")[i % 2], **WINDOWS[k][1])
                for k in ASYNC_WINDOWS for i, w in enumerate(stream[WINDOWS[k][0]])])

    return sorted(repr(_answer(a)) for a in asyncio.run(drive()))


class _Once:
    """``fn`` that raises ``RuntimeError(message)`` on the ``nth`` call
    for which ``when(*args, **kwargs)`` holds (after running, with
    ``after``), once."""

    def __init__(self, fn, message: str, when=lambda *a, **k: True, nth: int = 1, after: bool = False):
        self.fn, self.message, self.when, self.nth, self.after, self.seen = fn, message, when, nth, after, 0

    def __call__(self, *args, **kwargs):
        fire = False
        if self.when(*args, **kwargs):
            self.seen += 1
            fire = self.seen == self.nth
        if fire and not self.after:
            raise RuntimeError(self.message)
        out = self.fn(*args, **kwargs)
        if fire:
            raise RuntimeError(self.message)
        return out


FAILURE_WINDOWS = [  # rank 1 fails a build, an S1 request, then a witness executor call
    (slice(5, 12), {"strategy": "S2"}),
    (slice(0, 5), {"strategy": "S1"}),
    (slice(12, 16), {"strategy": "S2", "semantics": "witness"}),
    (slice(5, 12), {"strategy": "S2"}),
]
FAILURES = ("injected build failure", "injected S1 failure", "injected execute failure", None)


def _failures(pl, stream, mesh, axis_size):
    """:data:`FAILURE_WINDOWS` on the reference backend; on a mesh, rank
    1 raises once in its first executor build, in its second S1 answer,
    and after its first witness executor call."""
    svc = _service(pl, "reference", mesh, axis_size)
    real = strategies.s2_execute
    if mesh is not None and collectives.mesh_rank(mesh) == 1:
        svc.exec_cache.get_or_build = _Once(svc.exec_cache.get_or_build, FAILURES[0])
        svc._s1_answer = _Once(svc._s1_answer, FAILURES[1], nth=2)
        strategies.s2_execute = _Once(real, FAILURES[2], lambda *a, **k: k.get("semantics") == "witness",
                                      after=True)
    try:
        tickets = _windows(svc, stream, FAILURE_WINDOWS)
    finally:
        strategies.s2_execute = real
    return [_ticket(t) for t in tickets]


def _snapshots(svc, pl, stream, mesh, axis_size, tmp):
    """The sharded uint32 service's per-rank Stage-A snapshot, restored
    into a fresh service whose first S2 request packs no tile; snapshots
    of other shares refused."""
    path = os.path.join(tmp, f"stage_a_{'x'.join(map(str, mesh.shape))}.pkl")
    manifest = svc.save_plan_store(path)
    one_card = path + ".one_card"
    if svc.leader:
        whole = plans.GraphPlanStore(device="cpu")
        whole.staged_sharded(pl, 8, 0, "uint32")
        persist.save_stage_a(whole, pl, one_card)
    collectives.agree([False], mesh)  # every rank's files are written
    fresh = _service(pl, "sharded_uint32", mesh, axis_size)
    restored = fresh.restore_plan_store(path)
    ops.reset_build_counters()
    first = _windows(fresh, stream, [(slice(5, 6), {"strategy": "S2"})])
    packed = {k: ops.BUILD_COUNTERS[k] for k in ("pack_blocks", "stage_sharded_graph")}
    n_model = mesh.shape[1]
    me = collectives.mesh_rank(mesh)
    other = next(r for r in range(mesh.size()) if r // n_model != me // n_model)  # another block of sites
    probe = plans.GraphPlanStore(device="cpu")
    refused = {
        "other_rank": persist.load_stage_a(probe, pl, f"{path}.rank{other}", 0, mesh),
        "one_card": persist.load_stage_a(probe, pl, one_card, 0, mesh),
        "rank_on_one_card": persist.load_stage_a(probe, pl, persist.rank_path(path, mesh)),
    }
    return {"manifest": manifest, "restored": restored, "first": [_ticket(t) for t in first],
            "packed": packed, "refused": refused, "probe_entries": len(probe)}


def _signatures(pl, meshes):
    """Signatures on each mesh and one card; one executor cache asked on
    two meshes of the same ranks builds twice."""
    ca = paa.compile_query("l0 (l1|l2)* l3", pl.graph)
    sigs = {shape: automaton_signature(ca, pl.graph.n_nodes, None, "reference", 8, mesh=m)
            for shape, m in meshes.items()}
    sigs[None] = automaton_signature(ca, pl.graph.n_nodes, None, "reference", 8)
    cache = ExecutorCache(plan_store=plans.GraphPlanStore(device="cpu"))
    fns = [cache.get_or_build(ca, pl.graph.n_nodes, backend="reference", placement=pl, mesh=meshes[s],
                              axis_size=collectives.axis_size(meshes[s], ("data",)))[1]
           for s in ((4, 1), (2, 2), (4, 1))]
    return {"sigs": sigs, "builds": cache.builds, "hits": cache.hits,
            "same_fn": (fns[0] is fns[2], fns[0] is fns[1])}


def _rank_program(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    ranks.init_rank(rank, world, store, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    try:
        # every rank builds every mesh and its groups; the (2, 1) mesh is ranks 0 and 1
        meshes = {s: DeviceMesh("cpu", torch.arange(s[0] * s[1]).reshape(s), mesh_dim_names=("data", "model"))
                  for s in SHAPES}
        g, pl, stream = _setup()
        res = {}
        for shape, mesh in meshes.items():
            if mesh.get_coordinate() is None:
                continue
            axis = shape[0]
            out = res[shape] = {"runs": {}, "batches": {}, "rank": collectives.mesh_rank(mesh)}
            for name in CONFIGS:
                svc, out["runs"][name], out["batches"][name] = _run(pl, stream, name, mesh, axis)
                if name == "sharded_uint32":
                    out["snapshots"] = _snapshots(svc, pl, stream, mesh, axis, out_dir)
            out["async"] = _async(pl, stream, mesh, axis)
            out["failures"] = _failures(pl, stream, mesh, axis)
        res["signatures"] = _signatures(pl, meshes)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures: one spawn of every topology, the one-card runs, repro's run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, repro_8_devices):
    """Every rank's results, from one spawn made on first use (``repro``'s
    8-device run starts first and runs beside it)."""
    cache = []
    if not cache:
        d = tmp_path_factory.mktemp("mesh_serve")
        ranks.run_ranks(_rank_program, WORLD, (WORLD, str(d / "store"), str(d)),
                        timeout_s=SPAWN_TIMEOUT_S, device="cpu")
        for r in range(WORLD):
            with open(d / f"rank{r}.pkl", "rb") as f:
                cache.append(pickle.load(f))
    return cache


@pytest.fixture(scope="module")
def one_card():
    """``one_card(kind, axis_size)``: the one-card service's tickets and
    records on a config's windows (``kind`` a config name) or on the
    failure windows (``"failures"``)."""
    g, pl, stream = _setup()
    cache = {}

    def get(kind, axis_size):
        if (kind, axis_size) not in cache:
            cache[kind, axis_size] = (_failures(pl, stream, None, axis_size) if kind == "failures"
                                      else _run(pl, stream, kind, None, axis_size)[1:])
        return cache[kind, axis_size]

    return get


def _same(a, b, what) -> None:
    """Exact equality of nested results: arrays by dtype, shape and bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), what
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), (what, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, (what, i))
    else:
        assert a == b, (what, a, b)


def _ranks_of(spawned, shape):
    return [r[shape] for r in spawned if shape in r]


# ---------------------------------------------------------------------------
# against the one-card service
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", SHAPES)
def test_tickets_equal_one_card(spawned, one_card, shape, name):
    """Every rank's tickets — answers, strategy, semantics, costs (per-site
    meters included) and witness levels — equal the one-card service's at
    the same ``axis_size``, on each backend, S1 windows and witness
    requests included."""
    want, _ = one_card(name, shape[0])
    got = _ranks_of(spawned, shape)
    assert len(got) == shape[0] * shape[1]
    assert {t[1] for t in want} == {"S1", "S2"} and {t[2] for t in want} == {"pairs", "witness"}
    for r in got:
        _same(r["runs"][name], want, (shape, name))


def _layout(shape):
    return MeshLayout(("data", "model"), shape)


def _window_slice(windows, k):
    """The tickets of window ``k`` of ``windows`` in a run's ticket list."""
    lo = sum(len(range(16)[sl]) for sl, _ in windows[:k])
    return slice(lo, lo + len(range(16)[windows[k][0]]))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", SHAPES)
def test_exec_batches_follow_the_mesh_multiple(spawned, one_card, shape, name):
    """S2 batches are padded to ``repro``'s multiple for the mesh: the
    batch axis's size on the reference backend (1 on one card), at least
    QPAD or QPACK on the kernel backends; S1 batches are the coalesced
    group.  With a batch axis of size 1 they are the one-card batches."""
    _, want = one_card(name, shape[0])
    multiple = batch_multiple(CONFIGS[name].get("s2_backend", "reference"), _layout(shape))
    assert multiple == (shape[1] if name == "reference" else max(shape[1], 8 if "sharded" in name else 256))
    assert batch_multiple("reference") == 1
    for r in _ranks_of(spawned, shape):
        got = r["batches"][name]
        assert [s for s, _ in got] == [s for s, _ in want]
        if shape[1] == 1:
            assert got == want
        s2 = [b for s, b in got if s == "S2"]
        assert s2 and all(b % multiple == 0 for b in s2)


@pytest.mark.parametrize("shape", SHAPES)
def test_async_front_end_led_by_rank_0(spawned, one_card, shape):
    """``AsyncQueryService`` on the leader, the followers following its
    flush orders until its stop: every rank resolves the same requests to
    the one-card service's answers, strategy, costs and levels."""
    want, _ = one_card("sharded_f32", shape[0])
    want_set = sorted(repr(t) for k in ASYNC_WINDOWS for t in want[_window_slice(WINDOWS, k)])
    for r in _ranks_of(spawned, shape):
        assert r["async"] == want_set


@pytest.mark.parametrize("shape", SHAPES)
def test_a_failure_on_one_rank_fails_the_group_everywhere(spawned, one_card, shape):
    """Rank 1 raises in its first executor build, in its second S1 answer
    and after its first witness executor call: the group (the S1 request)
    fails on every rank — rank 1 with its own error, the others with a
    ``RankFailure`` naming rank 1 and its message — nothing hangs, every
    other ticket equals the one-card service's, and the last window
    serves whole."""
    want = one_card("failures", shape[0])
    for r in _ranks_of(spawned, shape):
        got = r["failures"]
        assert len(got) == len(want)
        for k, message in enumerate(FAILURES):
            sl = _window_slice(FAILURE_WINDOWS, k)
            failed = 0
            for t, w in zip(got[sl], want[sl]):
                if t[0] != "error":
                    _same(t, w, (shape, k))
                    continue
                failed += 1
                if r["rank"] == 1:
                    assert t[1:] == ("RuntimeError", message, None)
                else:
                    assert t[1] == "RankFailure" and t[3] == 1 and f"RuntimeError: {message}" in t[2]
            if message is None:
                assert failed == 0
            elif k == 1:
                assert failed == 1  # one S1 request of its group
            else:
                assert failed > 0, (shape, k)  # the group of the failed build or call


@pytest.mark.parametrize("shape", SHAPES)
def test_per_rank_snapshots_restore_and_refuse_other_shares(spawned, one_card, shape):
    """Each rank saves its share of the sharded uint32 Stage A to its own
    file; a fresh service restores it and its first S2 request packs no
    tile, with the one-card answers; a rank refuses another block's file
    and a one-card snapshot, and one card refuses a rank's."""
    want, _ = one_card("sharded_uint32", shape[0])
    k = 8 // shape[0]
    for r in _ranks_of(spawned, shape):
        s = r["snapshots"]
        d = r["rank"] // shape[1]
        assert s["manifest"]["share"] == ((("data",), d * k, (d + 1) * k),)
        assert s["manifest"]["n_entries"] >= 1
        assert s["restored"] and s["packed"] == {"pack_blocks": 0, "stage_sharded_graph": 0}
        (first,) = s["first"]
        assert first[:2] == (want[5][0], "S2") and first[3] == want[5][3]
        assert s["refused"] == {"other_rank": False, "one_card": False, "rank_on_one_card": False}
        assert s["probe_entries"] == 0


def test_signatures_differ_between_meshes(spawned):
    """The signature carries the mesh's shape and axes: the three meshes'
    and one card's differ only there, and one executor cache asked for
    one automaton on two meshes of the same ranks builds twice and hands
    back the first mesh's executor again."""
    for r in spawned:
        s = r["signatures"]
        sigs = s["sigs"]
        assert len(set(sigs.values())) == len(SHAPES) + 1
        assert sigs[None].mesh_key == () and sigs[(2, 2)].mesh_key == (("data", 2), ("model", 2))
        for shape in SHAPES:
            assert sigs[shape]._replace(mesh_key=()) == sigs[None]
        assert (s["builds"], s["hits"], s["same_fn"]) == (2, 1, (True, False))


# ---------------------------------------------------------------------------
# against repro's QueryService on 8 forced host devices
# ---------------------------------------------------------------------------

REPRO_SCRIPT = textwrap.dedent(
    """
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.core.cost_model import NetworkParams
    from repro.dist import compat
    from repro.graph.generators import random_labeled_graph
    from repro.graph.partition import distribute
    from repro.graph.workloads import WorkloadConfig, generate
    from repro.serve import QueryService, ServeConfig

    assert len(jax.devices()) == 8
    g = random_labeled_graph(48, 200, 4, seed=9)
    pl = distribute(g, n_sites=8, replication_rate=0.3, seed=9)
    stream = generate(g, WorkloadConfig(n_queries=16, hot_pool=4, max_starts=6, seed=0))
    mesh = compat.make_mesh((4, 2), ("data", "model"))
    out = {}
    for name in NAMES:
        svc = QueryService(pl, mesh, NetworkParams(*NET),
                           config=ServeConfig(n_rollouts=40, seed=0, s2_block_size=8, **CONFIGS[name]))
        tickets = []
        for lo, hi, kw in WINDOWS:
            tickets += [svc.enqueue(w.query, w.starts, **kw) for w in stream[lo:hi]]
            svc.flush()
        out[name] = [(t.result().query, t.result().strategy, [sorted(a) for a in t.result().answers],
                      [dataclasses.astuple(c) for c in t.result().observed]) for t in tickets]
        out[name, "batches"] = [r.exec_batch_size for r in svc.metrics.records]
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    """
).replace("NAMES", repr(["reference", "sharded_f32"])).replace("NET", repr(NET)).replace(
    "CONFIGS", repr(CONFIGS)).replace("WINDOWS", repr([(sl.start, sl.stop, kw) for sl, kw in WINDOWS[:3]]))
REPRO_TIMEOUT_S = 240
CHILD_ENV = {**{k: os.environ[k] for k in ("HOME", "PATH", "TMPDIR") if k in os.environ},
             "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def repro_8_devices(tmp_path_factory):
    """``repro_8_devices()``: ``repro``'s service on a (4, 2) mesh of 8
    forced host devices, from a subprocess started when the fixture is
    made and waited for (at most ``REPRO_TIMEOUT_S``) on first use."""
    d = tmp_path_factory.mktemp("repro8_serve")
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


@pytest.mark.parametrize("name", ["reference", "sharded_f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ranks_equal_repro_on_8_devices(repro_8_devices, spawned, shape, name):
    """``repro``'s service on a (4, 2) mesh picks every strategy and
    answer that every rank does; its meters equal the ranks' (the
    reference backend's q_bc, d_s2 and n_bc, the sharded backend's
    per-site meters); and where the batch axes agree in size (2 on
    (2, 2)) its exec batches too."""
    want = repro_8_devices()[name]
    n = len(want)
    for r in _ranks_of(spawned, shape):
        got = r["runs"][name][:n]
        assert [(t[0], t[1], t[3]) for t in got] == [(w[0], w[1], w[2]) for w in want]
        for t, w in zip(got, want):
            if t[1] == "S1":
                assert [c[:4] for c in t[4]] == [tuple(c[:4]) for c in w[3]]
            elif name == "reference":
                assert [c[1:4] for c in t[4]] == [tuple(c[1:4]) for c in w[3]]
            else:
                assert [c[5] for c in t[4]] == [tuple(float(x) for x in c[5]) for c in w[3]]
        if shape[1] == 2:
            got = [b for _, b in r["batches"][name]]
            assert got[:len(repro_8_devices()[name, "batches"])] == repro_8_devices()[name, "batches"]
