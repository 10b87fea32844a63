"""The S2 fixpoints with their loop on the device (``ops.LevelLoop``)
against ``repro``'s ``lax.while_loop`` and against the same loop read on
the host every level, on the CPU.

Each fixpoint runs ``LEVELS_PER_CHECK`` = k levels per host check, each
level gated by the device's "active" flag.  For k in {1, 3, 8}, the four
one-card S2 executors (``reference``, ``frontier_kernel``,
``frontier_kernel_packed``, ``frontier_kernel_sharded``) and the four
``ops.reach_fixpoint*`` are held bit for bit to ``repro`` (its Pallas
kernels in interpret mode, as its own tests run them) and to k = 1:
answers, ``q_bc``, ``d_s2``, ``n_broadcasts``, the per-site meters and the
witness planes, also under a ``max_levels`` below the converged depth.
Each fixpoint's BFS levels equal k = 1's, and its host syncs are
max(1, ⌈levels / k⌉) ≤ ⌈levels / k⌉ + 1."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.core import strategies as r_st
from repro.dist import compat
from repro.graph import generators as r_gen
from repro.graph import partition as r_part
from repro.kernels.frontier import ops as r_ops

from repro_torch.core import paa, strategies
from repro_torch.graph import generators, partition
from repro_torch.kernels.frontier import ops
from repro_torch.serve import plancache

torch.set_num_threads(1)

KS = [1, 3, 8]
BACKENDS = ["reference", "frontier_kernel", "frontier_kernel_packed", "frontier_kernel_sharded"]
GRAPH = (48, 170, 3, 4)  # nodes, edges, labels, seed
QUERY = "(l0|l1)* l2"
BLOCK = 8
CUT = 2  # max_levels below the converged depth
STARTS = np.arange(0, 48, 2, dtype=np.int32)  # 24 starts: three f32 chunks of 8


@pytest.fixture(scope="module")
def twins():
    rg, tg = r_gen.random_labeled_graph(*GRAPH[:3], seed=GRAPH[3]), generators.random_labeled_graph(
        *GRAPH[:3], seed=GRAPH[3])
    rp = r_part.distribute(rg, n_sites=4, replication_rate=0.5, seed=2)
    tp = partition.distribute(tg, n_sites=4, replication_rate=0.5, seed=2)
    return rg, tg, rp, tp, compat.make_mesh((1, 1), ("data", "model"))


class _Fixpoints:
    """Each ``LevelLoop.run``'s BFS levels and host syncs, in call order."""

    def __init__(self, monkeypatch):
        self.runs: list[tuple[int, int]] = []
        real = ops.LevelLoop.run

        def run(loop, state):
            lev0, sync0 = ops.FIXPOINT_COUNTERS["levels"], ops.FIXPOINT_COUNTERS["host_syncs"]
            out = real(loop, state)
            self.runs.append((ops.FIXPOINT_COUNTERS["levels"] - lev0,
                              ops.FIXPOINT_COUNTERS["host_syncs"] - sync0))
            return out

        monkeypatch.setattr(ops.LevelLoop, "run", run)

    def levels(self) -> list[int]:
        return [lev for lev, _ in self.runs]

    def check_syncs(self, k: int) -> None:
        assert self.runs
        for lev, syncs in self.runs:
            assert syncs == max(1, -(-lev // k)) <= -(-lev // k) + 1, (k, lev, syncs)


def _port(tp, tca, backend, semantics, max_levels, k, monkeypatch):
    monkeypatch.setattr(ops, "LEVELS_PER_CHECK", k)
    kw = {"axis_size": 2} if backend == "frontier_kernel_sharded" else {}
    tile_dtype = "f32" if semantics == "witness" or backend == "reference" else "uint32"
    return strategies.s2_execute(tp, tca, STARTS, max_levels=max_levels, backend=backend,
                                 block_size=BLOCK, semantics=semantics, tile_dtype=tile_dtype,
                                 device="cpu", **kw)


_REPRO: dict = {}


def _repro(twins, backend, semantics, max_levels):
    key = (backend, semantics, max_levels)
    if key not in _REPRO:
        rg, _, rp, _, mesh = twins
        tile_dtype = "f32" if semantics == "witness" or backend == "reference" else "uint32"
        _REPRO[key] = r_st.s2_execute(mesh, rp, r_paa.compile_query(QUERY, rg), STARTS, max_levels=max_levels,
                                      backend=backend, block_size=BLOCK, semantics=semantics,
                                      tile_dtype=tile_dtype)
    return _REPRO[key]


def _same(got, want, what) -> None:
    assert (np.asarray(got[0]) == np.asarray(want[0])).all(), what
    assert [dataclasses.astuple(c) for c in got[1]] == [dataclasses.astuple(c) for c in want[1]], what
    if len(want) == 3:
        assert np.asarray(got[2]).tobytes() == np.asarray(want[2]).tobytes(), what


@pytest.mark.parametrize("max_levels", [None, CUT])
@pytest.mark.parametrize("semantics", ["pairs", "witness"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", KS)
def test_executor_equals_repro_and_one_level_per_check(twins, monkeypatch, k, backend, semantics, max_levels):
    """An S2 executor at k levels per check: ``repro``'s answers, meters
    (the sharded backend's per-site ones too) and witness planes bit for
    bit, the k = 1 loop's likewise, each fixpoint's BFS levels those of
    k = 1, and max(1, ⌈levels / k⌉) host syncs a fixpoint."""
    rg, tg, _, tp, _ = twins
    tca = paa.compile_query(QUERY, tg)
    fixpoints = _Fixpoints(monkeypatch)
    base = _port(tp, tca, backend, semantics, max_levels, 1, monkeypatch)
    base_levels = fixpoints.levels()
    fixpoints.runs.clear()
    got = _port(tp, tca, backend, semantics, max_levels, k, monkeypatch)
    _same(got, base, (backend, semantics, k, "k=1"))
    _same(got, _repro(twins, backend, semantics, max_levels), (backend, semantics, k, "repro"))
    assert fixpoints.levels() == base_levels
    fixpoints.check_syncs(k)
    if max_levels is not None:
        assert max(fixpoints.levels()) == max_levels  # the bound cut a deeper fixpoint


def test_the_cut_is_below_the_converged_depth(twins, monkeypatch):
    """The query's fixpoints converge past CUT levels, so the bounded runs
    above stop early."""
    _, tg, _, tp, _ = twins
    fixpoints = _Fixpoints(monkeypatch)
    _port(tp, paa.compile_query(QUERY, tg), "frontier_kernel", "pairs", None, 8, monkeypatch)
    assert max(fixpoints.levels()) > CUT


def _plans(twins):
    rg, tg, *_ = twins
    rca, tca = r_paa.compile_query(QUERY, rg), paa.compile_query(QUERY, tg)
    rplan = r_ops.build_level_plan(rca, r_ops.make_blocked_graph(rg, block_size=BLOCK))
    tplan = ops.build_level_plan(tca, tg, block_size=BLOCK, device="cpu")
    masks = np.zeros((len(STARTS[:8]), tg.n_nodes), np.float32)
    masks[np.arange(8), STARTS[:8]] = 1.0
    return tca, rplan, tplan, masks


FIXPOINTS = ["reach_fixpoint", "reach_fixpoint_levels", "reach_fixpoint_packed", "reach_fixpoint_packed_levels"]


@pytest.mark.parametrize("max_levels", [64, CUT])
@pytest.mark.parametrize("name", FIXPOINTS)
@pytest.mark.parametrize("k", KS)
def test_reach_fixpoint_equals_repro_and_one_level_per_check(twins, monkeypatch, k, name, max_levels):
    """``ops.reach_fixpoint*`` at k levels per check: visited sets (lane
    words as ``repro``'s uint32) and level planes bit for bit against
    ``repro``'s and the k = 1 loop's, the same BFS levels, and max(1,
    ⌈levels / k⌉) host syncs."""
    tca, rplan, tplan, masks = _plans(twins)
    packed = "packed" in name
    f0 = (ops.stack_start_masks_packed(tplan, tca.start, masks) if packed
          else ops.stack_start_masks(tplan, tca.start, masks))
    t0 = torch.from_numpy(f0.view(np.int32) if packed else f0)

    def port(k_):
        monkeypatch.setattr(ops, "LEVELS_PER_CHECK", k_)
        out = getattr(ops, name)(tplan, t0, max_levels)
        return [t.numpy().tobytes() for t in (out if isinstance(out, tuple) else (out,))]

    fixpoints = _Fixpoints(monkeypatch)
    base = port(1)
    base_levels = fixpoints.levels()
    fixpoints.runs.clear()
    got = port(k)
    want = getattr(r_ops, name)(rplan, jnp.asarray(f0), max_levels, interpret=True)
    want = [np.asarray(w).tobytes() for w in (want if isinstance(want, tuple) else (want,))]
    assert got == base == want, (name, k)
    assert fixpoints.levels() == base_levels
    fixpoints.check_syncs(k)


def test_reference_executor_restages_edges_for_new_site_arrays(twins):
    """The reference executor keeps its edge sets for the site arrays it
    was last called on: a call on another placement's arrays, or on the
    same arrays changed in place, answers as a fresh executor does."""
    _, tg, _, tp, _ = twins
    tca = paa.compile_query(QUERY, tg)
    other = partition.distribute(tg, n_sites=2, replication_rate=1.0, seed=5)
    step = strategies.make_s2_step_fn(tca, tg.n_nodes, backend="reference")
    for pl in (tp, other, tp):
        arrays = strategies.stage_site_arrays(pl, "cpu")
        got = strategies.s2_execute(pl, tca, STARTS, step_fn=step, device_arrays=arrays)
        fresh = strategies.s2_execute(pl, tca, STARTS, backend="reference", device_arrays=arrays)
        _same(got, fresh, "new arrays")
    arrays["mask"].zero_()  # no valid edge left: only the starts remain
    got = strategies.s2_execute(tp, tca, STARTS, step_fn=step, device_arrays=arrays)
    _same(got, strategies.s2_execute(tp, tca, STARTS, backend="reference", device_arrays=arrays), "in place")
    assert not got[0][:, np.setdiff1d(np.arange(tg.n_nodes), STARTS)].any()


@pytest.mark.parametrize("backend", BACKENDS)
def test_an_executor_runs_again_after_release(twins, backend):
    """``fn.release()`` frees an executor's loops (their graphs, on a card);
    the executor then builds them again at its next call."""
    _, tg, _, tp, _ = twins
    tca = paa.compile_query(QUERY, tg)
    kw = {"placement": tp, "axis_size": 2} if backend == "frontier_kernel_sharded" else {}
    step = strategies.make_s2_step_fn(tca, tg.n_nodes, backend=backend, graph=tg, block_size=BLOCK,
                                      replication_factor=tp.replication_factor, device="cpu", **kw)
    arrays = {"device_arrays": strategies.stage_site_arrays(tp, "cpu")} if backend == "reference" else {}
    first = strategies.s2_execute(tp, tca, STARTS, step_fn=step, **arrays)
    step.release()
    _same(strategies.s2_execute(tp, tca, STARTS, step_fn=step, **arrays), first, backend)


def test_an_evicted_executor_is_released(monkeypatch):
    """The executor cache's eviction calls the executor's ``release`` (its
    graphs and static state) before dropping it."""
    released = []

    def fn():
        pass

    fn.release = lambda: released.append(True)
    entry = plancache._ExecEntry(graph_key=(), sig=None, fn=fn)
    entry.release()
    assert released == [True] and entry.fn is None
