#!/usr/bin/env python3
"""Drive every path of the port end to end on one NVIDIA GPU, through
each of its seven hand-written CUDA kernels.

    python3 chip_smoke.py [--out FILE]

Four S2 frontier paths, one per (backend, tile store) pair, each carried
by one kernel:

=========================  ========  =================================
backend                    tiles     kernel
=========================  ========  =================================
``frontier_kernel``        f32       B1 ``fused_level_blocks``
``frontier_kernel``        uint32    B3 ``fused_level_blocks_u32``
``frontier_kernel_packed`` f32       B2 ``packed_level_blocks``
``frontier_kernel_packed`` uint32    B4 ``packed_level_blocks_u32``
=========================  ========  =================================

Phases, each of which raises on failure (the run then exits non-zero):

* env      — the card's name and power limit, torch and CUDA versions;
* build    — every CUDA source, built from ``src/`` with one nvcc each,
             all started together;
* setup    — the Alibaba twin (``alibaba_like(seed=0)``: 50,000 nodes,
             327,848 edges, 216 labels), its 256-site placement at
             replication rate 0.2 (``configs/alibaba_rpq.py``), and the
             whole Stage-A tile store on the device twice: f32 and the
             uint32 bit-planes, whose offsets must equal the f32 store's
             and whose unpacked q1 tiles must equal the f32 tiles;
* kernels  — each kernel against its plain PyTorch version on the card,
             exactly equal (``torch.equal``: {0,1} operands and integer
             sums below 2^24 are exact in f32 in any order, OR is exact
             in any order) on (a) the q1 plan at full scale, (b) a
             block-16 plan with an empty label store, a wildcard and an
             inverse transition, (c) a plan with output blocks made only
             of cover steps, (d) the q1 plan with a cover step after
             every second valid step of each run (runs of more than
             2 x ``WORK_CHUNK`` valid steps with cover steps between
             them); the packed kernels on random lane words over all 32
             bits.  Each plan's work-list size (the CTAs of B1-B4) and
             longest run are logged.  Then the time of one level of each
             query's plan for each kernel, the plain version's, and the
             bound; each kernel again equal to plain at every timed
             level, with its chunks and the time of its output's zero
             fill alone;
* path     — ``s2_execute`` on Table-2 queries q1, q9 and q12 over all
             their valid starts, for each of the four paths, with the
             launch counts set to 0 just before each path and read just
             after; answers must equal the device-BFS oracle for every
             start, the §4.2 meters must equal the host meter on 32
             sampled starts, the path's kernel launches must equal its
             BFS levels and be nonzero, and no other kernel may launch;
* trace    — each query again on each path, its per-call set-up
             (``make_s2_step_fn``: Stage B and the meters' degree
             vectors) timed apart from a warm run, and the run traced
             with ``torch.profiler``: device busy time, idle share,
             device time per kernel, and the path's level kernel looked
             up by pieces of its device symbol, which must match exactly
             one kernel, launched as often as in the path phase;
* plan     — the paper's §6 workflow on the same twin: a 256-peer overlay
             of mean degree 3 (``random_overlay``) probed for N_p, N_c and
             k, the Bayesian model fitted once, each of the 12 Table-2
             queries estimated (300 rollouts) and decided; then on 8
             sampled valid starts of each, S1 (``s1_execute`` on the
             padded site arrays staged once, its gather, dedup and device
             BFS also timed apart) and S2 (``s2_execute`` on B1 under the
             query class's fast path: reduced automaton, level cap).
             Answers of both must equal the device-BFS oracle, S1's
             deduped subgraph must be the graph's edges of the query's
             labels and its cost ``s1_costs``, B1's launches must equal
             the S2 levels, and no other kernel may launch; each
             strategy's observed ``cost_of`` is logged beside the plan's
             forecast (whether the choice was the cheaper one is not
             checked: the plan is an estimate);
* witness  — witness semantics and bounded counting on the same twin:
             every valid start of q1, q9 and q12 through ``s2_execute(
             semantics="witness")`` on B1 and on B2 over the f32 store,
             each beside the pairs run of the same executor (wall times
             logged side by side) and a third run taken apart (set-up,
             executor, the levels' copy to pageable and to pinned host
             memory).  Answers and meters must equal the
             pairs run and the device BFS, the packed levels the f32
             ones, the levels of 4 sampled starts with answers the host
             product BFS (``witness.host_levels``), and 8 witnesses per
             query walked back from the levels must pass the label-store
             check and the automaton re-match; each run must launch its
             kernel once a level and nothing else.  q1 again asks for the
             uint32 store without a Stage A: it must restage f32 and
             launch B1, not B3.  ``count_paths_bounded`` on q1 (8 levels,
             4 starts) must equal the host DP exactly, and B1 on a count
             frontier whose sums reach 2^24 - 1 (runs of 8 full tiles)
             must be ``torch.equal`` to its plain version;
* serve    — the serving runtime on the same twin and placement (the plan
             phase's overlay; ``ServeConfig(n_rollouts=150, seed=0)``, the
             planner deciding): a 144-request ``workloads.generate``
             stream (8 hot classes, 80% hot, 1-8 starts) through
             ``QueryService`` in windows of 16 (enqueue, flush): (a) on
             ``frontier_kernel_packed`` over the uint32 store (B4), cold
             then warm; (d) its first 8 as witness requests, forced to S2,
             which restage f32 and run B2, 3 sampled pairs of each walked
             back and validated; (e) ``AsyncQueryService`` on the warm
             service, open loop (Poisson arrivals, serve_async.py's
             tenants, SLO mix and knobs) at 1x and 2x (a)'s warm q/s over
             the first 48, accepted answers == the sync ones; (b) the
             first 48 on ``frontier_kernel`` over the f32 store (B1) in a
             fresh service; (f) (b)'s Stage A saved and restored into a
             fresh service, whose first S2 request must pack no tile; (c)
             (b) again under a 1 GiB out-of-core budget, answers == (b)'s,
             spills and reloads nonzero.  Every answer == the device BFS;
             each run's level kernel launches once a level and no other
             kernel; the summary's keys == ``repro``'s schema
             (``SUMMARY_KEYS``).  Each run logs q/s, latency p50 and p99
             and the host ms of the service's layers;
* baseline — the per-transition baseline path, carried by B5
             ``frontier_step_blocks``: the twin as per-label tile lists
             (``make_blocked_graph``) and Stage A again from them (equal
             to the graph's f32 store); B5 against its plain version on
             cases a to c as tile lists; 32 sampled starts of q1, q9 and
             q12, one ``multi_source_reach_baseline`` each, whose answers
             must equal the fused path on the same BlockedGraph (B1) and
             the device BFS, and whose B5 launches must equal levels x
             (transition, store) entries with no other kernel launched;
             one ``expand_level`` timed beside one ``expand_level_fused``,
             and each of its B5 launches, at the path's own operands,
             equal to the plain version; the tiles, chunks (CTAs) and
             longest column run of each launch of the q1 level;
* embedbag — B6 ``embedding_bag_sorted`` through ``embedding_bag`` at
             dlrm-mlperf's largest table (39,979,771 x 128 bf16) and
             through ``gnn_aggregate`` at ogb_products (2,449,029 nodes,
             61,859,140 uniform edges, 100 f32 features), each
             ``torch.equal`` to its plain version, with its launch
             geometry (lane groups, lanes, load width, lookups a group),
             bounds by distinct rows, by gathered rows and by gathered
             32-byte sectors, and ``F.embedding_bag``;
* decode   — B7 ``flash_decode_gqa`` through ``decode_attention`` at
             qwen3-14b's attention widths at decode_32k and long_500k,
             against its plain version (max |diff| at most 2e-2 of the
             largest |output|, which an all-zero output and the kernel on
             half the cache must both miss) and SDPA; each shape's
             kv split (n_split, split length, partials' bytes) is logged.

Each phase logs its seconds and peak device memory and frees its tensors
before the next.  B5, B6 and B7 are timed as B1-B4 are (CUDA graph, L2
flushed and warm; one call between events) beside their plain versions,
their bounds and, where one PyTorch call computes the same function, that
call.  The last two lines are a JSON object with one entry per kernel,
then ``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
when no GPU is present or when run without the repository's ``src/``.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import interop  # noqa: E402
from repro_torch.core import cost_model, paa, planner, strategies, witness  # noqa: E402
from repro_torch.core import regex as rx  # noqa: E402
from repro_torch.graph.generators import (  # noqa: E402
    TABLE2_PAPER, TABLE2_QUERIES, alibaba_like, random_labeled_graph,
)
from repro_torch.graph.partition import distribute, random_overlay  # noqa: E402
from repro_torch.graph.structure import LabeledGraph, to_device_graph  # noqa: E402
from repro_torch.graph.workloads import WorkloadConfig, generate  # noqa: E402
from repro_torch.serve import QueryService, ServeConfig, batcher  # noqa: E402
from repro_torch.serve.aio import AdmissionRejected, AioConfig, AsyncQueryService  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attn import ops as da_ops  # noqa: E402
from repro_torch.kernels.embedbag import embedbag  # noqa: E402
from repro_torch.kernels.embedbag import ops as eb_ops  # noqa: E402
from repro_torch.kernels.frontier import frontier as fkernel  # noqa: E402
from repro_torch.kernels.frontier import ops as fops  # noqa: E402
from repro_torch.kernels.frontier.ref import tile_words  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, and dense bf16 FLOP/s on the
# tensor cores; INT32 lanes are half the FP32 lanes of an SM (64 against
# 128), so int32 operations run at half the float32 rate
INT32_OPS = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
QUERIES = ("q1", "q9", "q12")
N_METER_SAMPLES = 32
SEED = 0
CSRC = "src/repro_torch/kernels/frontier/csrc"
FRONTIER_PY = "src/repro/kernels/frontier/frontier.py"
N_BASELINE_STARTS = 32
# the plan phase (§6): a 256-peer overlay of mean degree d = 3, as the
# paper's worked example; rollouts per estimate; starts per query
PLAN_SEED, PLAN_DEGREE, PLAN_ROLLOUTS, N_PLAN_STARTS = 6, 3.0, 300, 8
# the witness phase: witnesses walked back per query and backend; the
# count_paths_bounded length on q1; nodes of the complete digraph on which
# B1 sums counts to 2^24 - 1 (8 blocks of 128: runs of 8 full tiles)
N_WITNESSES, COUNT_LEVELS, COUNT_NODES = 8, 8, 1024
# the serve phase: the stream of benchmarks/serve_async.py's default size
# (144 requests, 8 hot classes, 1-8 starts); requests per sync window; the
# prefix of the f32, budgeted and async runs; witness requests and the
# pairs walked back from each; the out-of-core budget, about a tenth of the
# f32 store's 10.551 GB; the async mix and knobs of serve_async.py
SERVE_QUERIES, SERVE_WINDOW, SERVE_PREFIX, SERVE_WITNESS, SERVE_WALKS = 144, 16, 48, 8, 3
SERVE_ROLLOUTS, SERVE_BUDGET = 150, 2**30
SERVE_TENANTS, SERVE_LATENCY_SHARE = ("tenant-a", "tenant-b", "tenant-c"), 0.7
SERVE_AIO = {"max_window_s": {"latency": 0.25, "throughput": 1.0}, "window_gain": 2.0,
             "min_window_s": 0.01, "queue_depth": {"latency": 48, "throughput": 96}}
# dlrm-mlperf's largest Criteo table (src/repro/models/dlrm.py:30),
# embed_dim 128, table_dtype bf16 (dlrm.py:52); serve_bulk batch 262,144
# x multi_hot 1 (configs/registry.py:110)
DLRM_ROWS, DLRM_DIM, DLRM_LOOKUPS = 39_979_771, 128, 262_144
# ogb_products (configs/registry.py:99)
OGB_NODES, OGB_EDGES, OGB_FEAT = 2_449_029, 61_859_140, 100
# qwen3-14b attention (configs/qwen3_14b.py): 40 q-heads, 8 kv heads,
# head dim 128, bf16; decode_32k and long_500k (configs/registry.py:83)
QWEN_HEADS, QWEN_KV_HEADS, QWEN_DH = 40, 8, 128
DECODE_SHAPES = {"decode_32k": (128, 32_768), "long_500k": (1, 524_288)}
# B7 against its plain version: max |diff| at most BF16_TOL (the bf16
# tolerance of tests/test_kernels.py:140) times the largest |output|.  The
# outputs average ~kv_len V rows, so their size falls as 1/sqrt(kv_len)
# (largest ~4e-2 at decode_32k, ~1e-2 at long_500k): an absolute 2e-2
# would pass an all-zero output.  Relative to the largest output it is a
# few bf16 ulps there, the most by which the two roundings of p and of
# the output to bf16 may part.  Two controls on the same inputs must fail
# it: an all-zero output, and the kernel run on half the cache.
BF16_TOL = 2e-2

# the serve phase's summary schema: repro's ServiceMetrics summary with the
# service's extras, key for key (a None leaf is any value, {} any keys).
# This script cannot import repro; tests/test_torch_serve.py holds this
# literal to repro's schema.
def _leaves(*names: str) -> dict:
    return dict.fromkeys(names)


_ADMISSION = _leaves("accepted", "rejected_rate_limited", "rejected_queue_full", "completed",
                     "failed", "cancelled_before_batch", "cancelled_mid_batch", "timed_out")
_HIST = _leaves("bucket_upper_ms", "counts", "n", "p50_ms", "p99_ms", "p999_ms")
_BY_FRONTIER = _leaves("f32", "packed")
SUMMARY_KEYS = {
    **_leaves("n_queries", "wall_s", "queries_per_sec", "p50_latency_s", "p95_latency_s",
              "plan_cache_hit_rate", "total_broadcast_symbols", "total_unicast_symbols",
              "stats_epoch"),
    "strategies": {},
    "exec_cache": _leaves("size", "graphs", "hits", "misses", "hit_rate", "builds", "releases"),
    "plan_store": _leaves("size", "hits", "misses", "hit_rate", "evictions"),
    "plan_pad_waste": {**_leaves("useful_steps", "padded_steps", "pad_waste_ratio"),
                       "bucket_grid_steps": {}},
    "frontier_mem": {
        "executors": _BY_FRONTIER, "frontier_bytes": _BY_FRONTIER, "lane_capacity": _BY_FRONTIER,
        "bytes_per_lane": _BY_FRONTIER, "staging_chunks": None,
        "tile_store": {"bytes_by_dtype": _leaves("f32", "uint32"),
                       **_leaves("slabs_resident", "slabs_spilled", "spills", "reloads")},
    },
    "aio": {
        "queue_depth": _leaves("latency", "throughput"),
        "admission": {"latency": _ADMISSION, "throughput": _ADMISSION},
        "batch_window": _leaves("flushes", "lanes_flushed", "fill_ratio", "deadline_flushes",
                                "fill_flushes", "window_s_p50"),
        "latency_hist": {"latency": _HIST, "throughput": _HIST},
    },
    "plan_cache": _leaves("size", "hits", "misses", "hit_rate"),
    "calibration": {**_leaves("n_observations", "n_label_classes"), "factors": {}},
}

# kernel name -> what drives and describes it; "lanes" marks the packed
# kernels, whose frontier is int32 lane words; "symbol" holds the pieces
# of the kernel's device symbol that the trace phase looks it up by, which
# together match its symbol only (B1 and B2 are instantiations of one
# body, as are B3 and B4; B5 is B1's body on another schedule)
KERNELS = {
    "fused_level_blocks": {
        "wrapper": fkernel.fused_level_blocks, "plain": fkernel.fused_level_blocks_plain,
        "tile_dtype": "f32", "lanes": False, "backend": "frontier_kernel",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:209",
        "symbol": ("f32_chunk_kernel<", "LevelSchedule", "AddF32"),
    },
    "fused_level_blocks_u32": {
        "wrapper": fkernel.fused_level_blocks, "plain": fkernel.fused_level_blocks_plain,
        "tile_dtype": "uint32", "lanes": False, "backend": "frontier_kernel",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:188",
        "symbol": ("bitplane_level_kernel<", "AddF32"),
    },
    "packed_level_blocks": {
        "wrapper": fkernel.packed_level_blocks, "plain": fkernel.packed_level_blocks_plain,
        "tile_dtype": "f32", "lanes": True, "backend": "frontier_kernel_packed",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:337",
        "symbol": ("f32_chunk_kernel<", "LevelSchedule", "OrLanes"),
    },
    "packed_level_blocks_u32": {
        "wrapper": fkernel.packed_level_blocks, "plain": fkernel.packed_level_blocks_plain,
        "tile_dtype": "uint32", "lanes": True, "backend": "frontier_kernel_packed",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:311",
        "symbol": ("bitplane_level_kernel<", "OrLanes"),
    },
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def sparse_label_graph() -> LabeledGraph:
    """45 nodes, 200 edges over labels l0, l1, l3 — label l2 has no edges,
    so a plan over it meets an empty label store (the graph of
    ``tests/test_frontier_fused.py``)."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 45, 200).astype(np.int32)
    dst = rng.integers(0, 45, 200).astype(np.int32)
    lbl = rng.choice([0, 1, 3], 200).astype(np.int32)
    return LabeledGraph(45, src, lbl, dst, ["l0", "l1", "l2", "l3"])


def level_args(plan, frontier):
    """The positional arguments of one level on ``plan``."""
    return (
        frontier, plan.tiles, plan.firsts, plan.valids, plan.tile_ids,
        plan.f_rows, plan.f_cols, plan.o_rows, plan.o_cols,
        plan.block_size, plan.q_pad,
    )


def level_kw(plan) -> dict:
    """The keywords of one kernel level on ``plan``: run_ptr and the work
    list, which B1-B4 all walk."""
    return {"n_out_rows": plan.n_states * plan.q_pad, "run_ptr": plan.run_ptr, "work": plan.work}


SCHEDULE = ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols")


def with_cover_steps(staged, plan):
    """``plan`` with a cover step (valids 0, tile 0) after every second
    valid step of each run, carried in through ``interop.plan_from_numpy``,
    which derives run_ptr and the work list anew."""
    cols = {k: getattr(plan, k).cpu().numpy() for k in SCHEDULE}
    ptr = plan.run_ptr.cpu().numpy()
    keep = []
    for lo, hi in zip(ptr[:-1], ptr[1:]):
        for n, i in enumerate(range(lo, hi)):
            keep.append(i)
            if n % 2 == 1 and i + 1 < hi and cols["valids"][i]:
                keep.append(-1 - i)  # a cover step in the output block of step i
    idx = np.array(keep)
    arrays = {k: a[np.where(idx >= 0, idx, -1 - idx)].copy() for k, a in cols.items()}
    for k in ("firsts", "valids", "tile_ids", "f_rows", "f_cols"):
        arrays[k][idx < 0] = 0
    return interop.plan_from_numpy(staged, plan.n_states, *(arrays[k] for k in SCHEDULE),
                                   plan.union_members)


def runs_of(plan) -> np.ndarray:
    """The valid steps of each output block's run."""
    return np.add.reduceat(plan.valids.cpu().numpy(), plan.run_ptr.cpu().numpy()[:-1])


def random_frontier(plan, gen, lanes: bool) -> torch.Tensor:
    """A seeded frontier with its union rows, padded columns empty: {0,1}
    f32 rows, or int32 lane words over all 32 bits."""
    shape = ((plan.n_states + len(plan.union_members)) * plan.q_pad, plan.v_pad)
    dev = plan.tiles.device
    if lanes:
        f = torch.randint(0, 2**32, shape, generator=gen, device=dev, dtype=torch.int64)
        f = f.to(torch.int32)  # wraps: bit 31 becomes the sign bit
    else:
        f = (torch.rand(shape, generator=gen, device=dev) < 0.3).float()
    f[:, plan.n_nodes :] = 0
    return f


def level_bound(plan, lanes: bool) -> tuple[float, str, int, int]:
    """The least time one level could take on the card: each distinct
    real tile (B·B·4 bytes f32, B·⌈B/32⌉·4 bit-planes), each distinct
    frontier block and the schedule read once, the output written once
    (bytes), against 2·8·B² operations per valid step, f32 FMAs for the
    fused kernels and int32 AND/OR for the packed ones; returns (ms, the
    binding resource, bytes, operations)."""
    valids = plan.valids.cpu().numpy().astype(bool)
    tids = plan.tile_ids.cpu().numpy()[valids]
    fblocks = set(zip(plan.f_rows.cpu().numpy()[valids].tolist(), plan.f_cols.cpu().numpy()[valids].tolist()))
    b = plan.block_size
    tile_bytes = b * (tile_words(b) if plan.tile_dtype == "uint32" else b) * 4
    n_steps = int(plan.valids.shape[0])
    nbytes = (
        len(set(tids.tolist())) * tile_bytes
        + len(fblocks) * plan.q_pad * b * 4
        + plan.n_states * plan.q_pad * plan.v_pad * 4
        + (6 * n_steps + plan.run_ptr.shape[0]) * 4
    )
    ops = 2 * plan.q_pad * b * b * int(valids.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / (INT32_OPS if lanes else FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def graph_ms(fn, iters: int, flush: torch.Tensor | None) -> float:
    """Device ms of ``fn`` per call: ``iters`` calls captured in one CUDA
    graph and replayed, so host launch overhead is not timed.  With
    ``flush``, each call is preceded by a 64 MB write that evicts the L2
    cache, and the time of the flushes alone is subtracted."""

    def replay_ms(body) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the capture
            body()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                body()
        g.replay()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    if flush is None:
        return replay_ms(fn)

    def flushed():
        flush.zero_()
        fn()

    return replay_ms(flushed) - replay_ms(flush.zero_)


def events_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean ms of ``fn`` between CUDA events, L2 flushed before each call,
    with the host's launch work and syncs inside the window: the one
    footing on which the plain version, whose nonzero() syncs rule out a
    graph, and the kernel compare."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / iters


def trace_query(placement, ca, starts, staged, dev, backend: str, symbol: tuple[str, ...]) -> dict:
    """One query's per-call set-up timed apart from its run, and the run
    traced with ``torch.profiler``: device busy time (the union of the
    device events' intervals), its share of the traced wall time, the
    device time and count of each kernel, and those of the path's level
    kernel, found by the pieces of its device symbol (``symbol``), which
    must match exactly one kernel name, and of every fill kernel (the
    level kernels' zeroed outputs among them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = strategies.make_s2_step_fn(
        ca, placement.graph.n_nodes, backend=backend, graph=placement.graph,
        replication_factor=placement.replication_factor, tile_dtype=staged.tile_dtype,
        staged=staged, device=dev,
    )
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    strategies.s2_execute(placement, ca, starts, step_fn=step)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        strategies.s2_execute(placement, ca, starts, step_fn=step)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    spans, per_kernel = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = per_kernel.setdefault(e.name, {"count": 0, "us": 0.0})
        k["count"] += 1
        k["us"] += e.time_range.end - e.time_range.start
    if not spans:
        raise AssertionError("the trace holds no device event")
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi

    def total(match) -> dict:
        hits = [kt for name, kt in per_kernel.items() if match(name)]
        return {"ms": sum(kt["us"] for kt in hits) / 1e3, "count": sum(kt["count"] for kt in hits)}

    names = [name for name in per_kernel if all(piece in name for piece in symbol)]
    if len(names) != 1:
        raise AssertionError(f"the pieces {symbol} match {len(names)} kernel names: {names}")
    return {
        "level_kernel": {**total(lambda name: name == names[0]), "name": names[0]},
        "fills": total(lambda name: "FillFunctor" in name),
        "setup_ms": setup_ms, "run_ms": run_ms, "traced_ms": traced_ms,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / traced_ms,
        "idle_share_of_untraced_run": 1.0 - busy_us / 1e3 / run_ms,
        "kernels": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1]["us"])),
    }


def check_kernels(stores, cas, dev, gen) -> dict[str, float]:
    """Each kernel against its plain version on cases a to d; returns
    each kernel's max |kernel − plain| (0 when equal, else it raises)."""
    case_b_graph = sparse_label_graph()
    case_c_graph = random_labeled_graph(300, 500, 3, seed=11)
    small = {
        "b: block 16, empty store, wildcard, inverse": (
            case_b_graph, "(l0|l2)+ .^-1 l3^-1", 16),
        "c: cover-only output blocks": (case_c_graph, "l0 l1", 32),
    }
    max_err = dict.fromkeys(KERNELS, 0.0)
    for name, k in KERNELS.items():
        td = k["tile_dtype"]
        cases = {"a: q1, full scale": fops.build_level_schedule(cas["q1"], stores[td])}
        for label, (g, expr, block) in small.items():
            staged = fops.stage_graph(g, block, tile_dtype=td, device=dev)
            cases[label] = fops.build_level_schedule(paa.compile_query(expr, g), staged)
        cases["d: q1 with cover steps inside its runs"] = with_cover_steps(
            stores[td], cases["a: q1, full scale"])
        for label, plan in cases.items():
            valids = plan.valids.cpu().numpy()
            runs = runs_of(plan)
            f = random_frontier(plan, gen, k["lanes"])
            n_out = plan.n_states * plan.q_pad
            got = k["wrapper"](*level_args(plan, f), **level_kw(plan))
            want = k["plain"](*level_args(plan, f), n_out_rows=n_out)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            max_err[name] = max(max_err[name], err)
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{name} != plain on case {label}: max |diff| {err}")
            log("kernels", f"{name} == plain on case {label}: {plan.n_states} states, "
                f"B={plan.block_size}, {td} tiles, {len(valids)} steps ({int(valids.sum())} with a "
                f"tile), {int((runs == 0).sum())} of {len(runs)} output blocks cover-only, longest "
                f"run {int(runs.max())} valid steps, work list {plan.work.shape[0]} chunks of <= "
                f"{plan.work.shape[1]}")
        if not (runs_of(cases["c: cover-only output blocks"]) == 0).any():
            raise AssertionError("case c has no cover-only output block")
        d = cases["d: q1 with cover steps inside its runs"]
        runs, steps = runs_of(d), np.diff(d.run_ptr.cpu().numpy())
        if not ((runs > 2 * fops.WORK_CHUNK) & (steps > runs)).any():
            raise AssertionError("case d has no run of more than two chunks with cover steps inside")
    return max_err


def time_levels(stores, cas, gen, flush) -> dict:
    """One level of each query's plan, for each kernel: CUDA graph with L2
    flushed and warm, one call between events, the plain version between
    events, and the bound."""
    times: dict = {}
    for q in QUERIES:
        plans = {td: fops.build_level_schedule(cas[q], s) for td, s in stores.items()}
        for name, k in KERNELS.items():
            plan = plans[k["tile_dtype"]]
            f = random_frontier(plan, gen, k["lanes"])
            kw = level_kw(plan)

            def kernel_level(k=k, plan=plan, f=f, kw=kw):
                return k["wrapper"](*level_args(plan, f), **kw)

            def plain_level(k=k, plan=plan, f=f):
                return k["plain"](*level_args(plan, f), n_out_rows=plan.n_states * plan.q_pad)

            bound_ms, bound_by, nbytes, ops = level_bound(plan, k["lanes"])
            t = times.setdefault(name, {})[q] = {
                "ms": graph_ms(kernel_level, 50, flush),
                "warm_ms": graph_ms(kernel_level, 50, None),
                "events_ms": events_ms(kernel_level, 20, flush),
                "plain_ms": events_ms(plain_level, 10, flush),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops,
            }
            if not torch.equal(kernel_level(), plain_level()):
                raise AssertionError(f"{name} != plain at the timed {q} level")
            t["chunks"], t["longest_run"] = int(plan.work.shape[0]), int(runs_of(plan).max())
            shape = (plan.n_states * plan.q_pad, plan.v_pad)
            def fill(shape=shape, f=f):
                return torch.zeros(shape, dtype=f.dtype, device=f.device)

            t["fill_ms"] = graph_ms(fill, 50, flush)
            log("kernels", f"{name} {q} level == plain; {t['chunks']} chunks of <= "
                f"{plan.work.shape[1]} = CTAs, longest run {t['longest_run']} valid steps; the "
                f"output's zero fill alone {t['fill_ms'] * 1e3:.2f} us (L2 flushed), inside the "
                "kernel times below")
            log("kernels", f"{name} {q} level: kernel {t['ms'] * 1e3:.2f} us (L2 flushed; "
                f"{t['warm_ms'] * 1e3:.2f} us warm; {t['events_ms'] * 1e3:.2f} us one call between "
                f"events), plain {t['plain_ms'] * 1e3:.2f} us between events, bound "
                f"{bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M ops)")
    return times


def launch_counts() -> dict[str, int]:
    """Every kernel's launches so far, by the name the JSON line uses."""
    return {**fkernel.launch_counts(), "embedding_bag_sorted": embedbag.LAUNCHES,
            "flash_decode_gqa": decode_attn.LAUNCHES}


def reset_launches() -> None:
    fkernel.reset_launches()
    embedbag.LAUNCHES = decode_attn.LAUNCHES = 0


def only_launched(name: str, what: str) -> int:
    """The launches of kernel ``name`` since the last reset; raises if it
    launched none or another kernel launched."""
    counts = launch_counts()
    if counts[name] == 0:
        raise AssertionError(f"{what} launched no {name} kernel")
    if sum(counts.values()) != counts[name]:
        raise AssertionError(f"{what} launched other kernels: {counts}")
    return counts[name]


def free() -> None:
    """Return the card's cached blocks after the caller dropped its
    tensors (``del``), so the next phase starts from a clean pool."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def timed(fn, graph_iters: int, event_iters: int, flush) -> dict:
    """A kernel wrapper's times, as for the level kernels: a CUDA graph
    with L2 flushed, the same warm, and one call between events."""
    return {"ms": graph_ms(fn, graph_iters, flush), "warm_ms": graph_ms(fn, graph_iters, None),
            "events_ms": events_ms(fn, event_iters, flush)}


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """(ms, binding resource): the larger of bytes over HBM bandwidth and
    operations over ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def step_level(ca, bg, f: torch.Tensor):
    """The B5 launches of one baseline level on frontier ``f`` (n_states,
    v_pad): for each (transition, store), the path's own operand
    (``ops.expand_operand`` of the source state's row) and the store."""
    return [(fops.expand_operand(f[t.src]), entry) for t, entry in fops.baseline_entries(ca, bg)]


def check_step_calls(calls, block: int, q: str) -> float:
    """B5 against its plain version, ``torch.equal``, on each launch of a
    baseline level at the path's own operands; returns max |diff|."""
    max_err = 0.0
    for i, (rows, (tiles, r, c, w)) in enumerate(calls):
        got = fkernel.frontier_step_blocks(rows, tiles, r, c, block, work=w)
        want = fkernel.frontier_step_blocks_plain(rows, tiles, r, c, block)
        max_err = max(max_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"{q} level, launch {i}: frontier_step_blocks != plain")
    return max_err


def step_bound(calls, block: int) -> tuple[float, str, int, int]:
    """The least time of a level's B5 launches: each distinct store's
    tiles and index arrays read once, each launch's distinct frontier
    blocks read and its output written once (bytes), against 2·8·B²
    f32 FMAs per tile per launch (operations)."""
    stores = {id(e[0]): e for _, e in calls}
    nbytes = sum(sum(a.numel() * a.element_size() for a in e) for e in stores.values())
    ops = 0
    for rows, (tiles, r, _, _) in calls:
        nbytes += len(set(r.tolist())) * 8 * block * 4 + rows.numel() * 4
        ops += 2 * 8 * block * block * tiles.shape[0]
    return (*bound(nbytes, ops, FP32_FLOPS), nbytes, ops)


def check_step_kernel(bg, cas, dev, gen) -> float:
    """B5 against its plain version, ``torch.equal``, on every store of
    cases a, b and c rebuilt as per-label tile lists; returns max |diff|."""
    case_b = (sparse_label_graph(), "(l0|l2)+ .^-1 l3^-1", 16)
    case_c = (random_labeled_graph(300, 500, 3, seed=11), "l0 l1", 32)
    cases = {"a: q1, full scale, 16 rows": (bg, cas["q1"], 16)}
    for label, (graph, expr, block) in (("b: block 16, empty store, wildcard, inverse", case_b),
                                        ("c: the level kernels' cover-only case", case_c)):
        cases[label] = (fops.make_blocked_graph(graph, block, device=dev),
                        paa.compile_query(expr, graph), 8)
    max_err, all_unvisited = 0.0, 0
    for label, (b_g, ca, m_pad) in cases.items():
        stores = {id(e[0]): e for _, e in fops.baseline_entries(ca, b_g)}
        unvisited, longest = 0, 0
        for tiles, rows, cols, work in stores.values():
            f = (torch.rand((m_pad, b_g.v_pad), generator=gen, device=dev) < 0.3).float()
            f[:, b_g.n_nodes :] = 0
            got = fkernel.frontier_step_blocks(f, tiles, rows, cols, b_g.block_size, work=work)
            want = fkernel.frontier_step_blocks_plain(f, tiles, rows, cols, b_g.block_size)
            torch.cuda.synchronize()
            max_err = max(max_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"frontier_step_blocks != plain on case {label}")
            runs = np.diff(fops.column_runs(cols.cpu().numpy()))
            unvisited += b_g.v_pad // b_g.block_size - len(runs)
            longest = max(longest, int(runs.max()))
        n_tiles = sum(e[0].shape[0] for e in stores.values())
        log("baseline", f"frontier_step_blocks == plain on case {label}: {len(stores)} stores, "
            f"{n_tiles} tiles, B={b_g.block_size}, {m_pad} frontier rows, longest column run "
            f"{longest} tiles, {unvisited} column blocks unvisited (zero in both)")
        all_unvisited += unvisited
    if all_unvisited == 0:
        raise AssertionError("no case has an unvisited column block")
    return max_err


def phase_baseline(g, cas, dg, stores, dev, gen, flush, record) -> dict:
    """The per-transition baseline path (B5) on the full twin: its
    answers against the fused path (B1) on the same BlockedGraph and the
    device BFS, its launch count, and its times."""
    t0 = time.perf_counter()
    bg = fops.make_blocked_graph(g, block_size=128, device=dev)
    torch.cuda.synchronize()
    n_tiles = sum(e[0].shape[0] for st in (bg.fwd, bg.inv) for e in st.values())
    log("baseline", f"make_blocked_graph: {len(bg.fwd)} labels x 2 directions, {n_tiles} tiles, "
        f"{n_tiles * 128 * 128 * 4 / 1e9:.4f} GB ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    staged = fops.stage_graph(bg)
    torch.cuda.synchronize()
    same = torch.equal(staged.tiles, stores["f32"].tiles) and list(staged.offsets) == list(
        stores["f32"].offsets) and all(
        (a[0], a[1].tobytes(), a[2].tobytes()) == (b[0], b[1].tobytes(), b[2].tobytes())
        for a, b in zip(staged.offsets.values(), stores["f32"].offsets.values()))
    if not same:
        raise AssertionError("Stage A from the BlockedGraph differs from Stage A from the graph")
    log("baseline", f"stage_graph(BlockedGraph): {staged.tiles.shape[0]} tiles, equal to the "
        f"graph's f32 store byte for byte ({time.perf_counter() - t0:.1f} s)")
    rec = record["baseline"] = {"tiles": n_tiles}
    max_err = check_step_kernel(bg, cas, dev, gen)

    rng = np.random.default_rng(SEED + 1)
    launches, calls = 0, {}
    for q in QUERIES:
        ca = cas[q]
        starts = paa.valid_start_nodes(ca, g)
        sample = np.sort(rng.choice(starts, size=min(N_BASELINE_STARTS, len(starts)), replace=False))
        o_src, o_dst = paa.answers_multi_source(ca, dg, sample)
        plan = fops.build_level_plan(ca, staged)
        entries = len(list(fops.baseline_entries(ca, bg)))
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        answers, t_base = [], 0.0
        for s in sample:
            mask = np.zeros(g.n_nodes, np.float32)
            mask[s] = 1.0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            answers.append(fops.multi_source_reach_baseline(ca, bg, mask))
            t_base += time.perf_counter() - t1
        n = only_launched("frontier_step_blocks", f"the baseline path on {q}")
        levels = fops.FIXPOINT_COUNTERS["levels"]
        if n != levels * entries:
            raise AssertionError(f"{q}: {n} B5 launches for {levels} levels x {entries} entries")
        launches += n
        t_fused = 0.0
        for s, got in zip(sample, answers):
            mask = np.zeros(g.n_nodes, np.float32)
            mask[s] = 1.0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fused = fops.multi_source_reach(ca, staged, mask, plan=plan)
            t_fused += time.perf_counter() - t1
            want = np.zeros(g.n_nodes, bool)
            want[o_dst[o_src == s]] = True
            if not (np.array_equal(got, fused) and np.array_equal(got, want)):
                raise AssertionError(f"{q} start {s}: baseline, fused and device BFS answers differ")
        f = (torch.rand((ca.n_states, bg.v_pad), generator=gen, device=dev) < 0.3).float()
        f[:, g.n_nodes :] = 0
        f8 = torch.zeros((ca.n_states, plan.q_pad, plan.v_pad), device=dev)
        f8[:, 0] = f
        f8 = f8.reshape(-1, plan.v_pad)
        calls[q] = step_level(ca, bg, f)
        max_err = max(max_err, check_step_calls(calls[q], bg.block_size, q))
        r = rec[q] = {
            "starts": len(sample), "levels": levels, "entries": entries, "launches": n,
            "pairs": int(len(o_src)), "baseline_wall_ms": t_base * 1e3, "fused_wall_ms": t_fused * 1e3,
            "expand_level_ms": events_ms(lambda: fops.expand_level(ca, bg, f), 5, flush),
            "expand_level_fused_ms": events_ms(lambda: fops.expand_level_fused(plan, f8), 20, flush),
        }
        log("baseline", f"{q}: {len(sample)} starts, {r['pairs']} answer pairs; {levels} levels x "
            f"{entries} (transition, store) entries = {n} B5 launches, no other kernel; answers == "
            f"fused (B1, same BlockedGraph) == device BFS; {r['baseline_wall_ms']:.1f} ms baseline, "
            f"{r['fused_wall_ms']:.1f} ms fused; one level: expand_level {r['expand_level_ms']:.3f} ms "
            f"({entries} launches), expand_level_fused {r['expand_level_fused_ms']:.3f} ms (1 launch); "
            f"its {entries} B5 launches at the path's operands == plain")

    q1 = calls["q1"]
    rec["q1_launches"] = [
        {"tiles": int(tiles.shape[0]), "chunks": int(work.shape[0]),
         "longest_run": int(np.diff(fops.column_runs(cols.cpu().numpy())).max())}
        for _, (tiles, _, cols, work) in q1
    ]
    log("baseline", "B5, the q1 level's launches as (tiles, chunks = CTAs, longest column run): "
        + ", ".join(f"({x['tiles']}, {x['chunks']}, {x['longest_run']})" for x in rec["q1_launches"]))

    def kernel_level():
        for rows, (tiles, r_, c_, w) in q1:
            fkernel.frontier_step_blocks(rows, tiles, r_, c_, bg.block_size, work=w)

    def plain_level():
        for rows, (tiles, r_, c_, _) in q1:
            fkernel.frontier_step_blocks_plain(rows, tiles, r_, c_, bg.block_size)

    def fills():
        for rows, _ in q1:
            torch.zeros_like(rows)

    t = rec["q1_level"] = timed(kernel_level, 20, 10, flush)
    t["plain_ms"] = events_ms(plain_level, 5, flush)
    t["fill_ms"] = graph_ms(fills, 20, flush)
    t["bound_ms"], t["bound_by"], nbytes, ops = step_bound(q1, bg.block_size)
    log("baseline", f"B5, the {len(q1)} launches of one q1 level: {t['ms'] * 1e3:.2f} us (L2 "
        f"flushed; {t['warm_ms'] * 1e3:.2f} us warm; {t['events_ms'] * 1e3:.2f} us one call between "
        f"events), plain {t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us by "
        f"{t['bound_by']} ({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M ops); the {len(q1)} outputs' "
        f"zero fills alone {t['fill_ms'] * 1e3:.2f} us (L2 flushed), inside the kernel times")
    return {"name": "frontier_step_blocks", "route": "cuda", "source": f"{CSRC}/fused_level.cu",
            "replaces": f"{FRONTIER_PY}:121", "launches": launches, "max_abs_err": max_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None}


def plan_query_phase(q, g, placement, net, model, arrays, dg, staged, dev, rng) -> dict:
    """One Table-2 query through the planner, then on the same sampled
    starts through S1 (gather, dedup and device BFS timed apart, then
    ``s1_execute``) and through S2 on B1 under the query class's fast
    path; raises on any failed check."""
    expr = TABLE2_QUERIES[q]
    t0 = time.perf_counter()
    est = planner.estimate_query(expr, g, model=model, n_rollouts=PLAN_ROLLOUTS, seed=PLAN_SEED)
    plan = planner.decide_strategy(est, net)
    plan_ms = (time.perf_counter() - t0) * 1e3
    c, qc = plan.choice, est.query_class
    r = {"strategy": c.strategy, "reason": c.reason, "discr": c.discr, "k_over_d": c.k_over_d,
         "p_s2_optimal": plan.p_s2_optimal, "q_bc_p50_p90": [plan.q_bc_quantiles[x] for x in (0.5, 0.9)],
         "d_s2_p50_p90": [plan.d_s2_quantiles[x] for x in (0.5, 0.9)],
         "forecast": plan.forecast_symbols, "plan_ms": plan_ms, "query_class": [qc.kind, qc.length]}
    log("plan", f"{q}: {c.strategy} ({c.reason}); discr {c.discr:.6g}, k/d {c.k_over_d:.6g}, "
        f"p_s2_optimal {plan.p_s2_optimal:.4f}; Q_bc p50/p90 {r['q_bc_p50_p90']}, D_s2 p50/p90 "
        f"{r['d_s2_p50_p90']}; forecast S1 {plan.forecast_symbols['S1']:.1f}, S2 "
        f"{plan.forecast_symbols['S2']:.1f} symbols; class {qc.kind} (length {qc.length}); "
        f"{plan_ms:.1f} ms on the host ({PLAN_ROLLOUTS} rollouts)")
    ca = paa.compile_query(expr, g)
    starts = paa.valid_start_nodes(ca, g)
    if len(starts) == 0:
        log("plan", f"{q}: no valid start; executed on neither strategy")
        return r
    sample = np.sort(rng.choice(starts, size=min(N_PLAN_STARTS, len(starts)), replace=False))
    o_src, o_dst = paa.answers_multi_source(ca, dg, sample)
    oracle = [set(o_dst[o_src == s].tolist()) for s in sample]

    # S1: the pieces of s1_execute timed apart, then s1_execute itself
    ast = rx.parse(expr)
    lmask = strategies.query_label_mask(ast, g)
    want_cost = strategies.s1_costs(ast, g)
    truth = g.dedup().subgraph_with_labels(set(np.nonzero(lmask)[0].tolist()))
    truth_edges = set(zip(truth.src.tolist(), truth.lbl.tolist(), truth.dst.tolist()))
    max_e = arrays["src"].shape[1]
    gather_ms, dedup_ms, bfs_ms, exec_ms = [], [], [], []
    bfs_levels = bfs_syncs = 0
    for s, want in zip(sample.tolist(), oracle):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src, lbl, dst, valid, overflow = strategies.s1_gather(arrays, lmask, max_e)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sub = strategies.gathered_subgraph(g, src, lbl, dst, valid)
        t2 = time.perf_counter()
        lev0, sync0 = paa.BFS_COUNTERS["levels"], paa.BFS_COUNTERS["host_syncs"]
        acc = paa.answers_single_source(ca, paa.device_form(sub, dev), s).cpu().numpy()
        t3 = time.perf_counter()
        bfs_levels += paa.BFS_COUNTERS["levels"] - lev0
        bfs_syncs += paa.BFS_COUNTERS["host_syncs"] - sync0
        gather_ms.append((t1 - t0) * 1e3)
        dedup_ms.append((t2 - t1) * 1e3)
        bfs_ms.append((t3 - t2) * 1e3)
        gathered = int(valid.sum())
        if overflow or set(zip(sub.src.tolist(), sub.lbl.tolist(), sub.dst.tolist())) != truth_edges \
                or sub.n_edges != truth.n_edges or sub.n_edges != want_cost.edges_retrieved:
            raise AssertionError(f"{q}: S1's deduped subgraph ({sub.n_edges} edges, overflow {overflow}) "
                                 f"is not the graph's {truth.n_edges} edges of the query's labels")
        t0 = time.perf_counter()
        answers, cost = strategies.s1_execute(placement, ast, ca, s, device_arrays=arrays)
        exec_ms.append((time.perf_counter() - t0) * 1e3)
        if answers != want or set(np.nonzero(acc)[0].tolist()) != want:
            raise AssertionError(f"{q} start {s}: S1 answers differ from the device-BFS oracle")
        if cost != want_cost:
            raise AssertionError(f"{q}: S1 cost {cost} != s1_costs {want_cost}")
    r["s1"] = {"starts": len(sample), "gathered": gathered, "edges": sub.n_edges, "gather_ms": gather_ms,
               "dedup_ms": dedup_ms, "bfs_ms": bfs_ms, "execute_ms": exec_ms,
               "bfs_levels": bfs_levels, "bfs_host_syncs": bfs_syncs}
    log("plan", f"{q}: S1 on {len(sample)} starts: gather {np.median(gather_ms):.2f} ms (median; "
        f"{gathered} matching copies from {placement.n_sites} sites), dedup {np.median(dedup_ms):.2f} ms "
        f"(host, to {sub.n_edges} edges == the graph's edges of its labels == s1_costs), device form + "
        f"BFS {np.median(bfs_ms):.2f} ms ({r['s1']['bfs_levels']} levels, {r['s1']['bfs_host_syncs']} "
        f"host syncs over the starts); s1_execute {np.median(exec_ms):.2f} ms; answers == oracle")

    # S2 on B1, at the query class's fast path
    exec_ca, cap = planner.reduce_automaton(ca, qc), planner.fast_path_max_levels(qc)
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc2, costs = strategies.s2_execute(
        placement, exec_ca, sample, max_levels=cap, backend="frontier_kernel", tile_dtype="f32",
        staged=staged, device=dev)
    torch.cuda.synchronize()
    s2_ms = (time.perf_counter() - t0) * 1e3
    n = only_launched("fused_level_blocks", f"the plan phase's S2 leg of {q}")
    levels = fops.FIXPOINT_COUNTERS["levels"]
    if n != levels:
        raise AssertionError(f"{q}: {n} B1 launches for {levels} levels")
    for i, want in enumerate(oracle):
        if set(np.nonzero(acc2[i])[0].tolist()) != want:
            raise AssertionError(f"{q} start {sample[i]}: S2 answers differ from the oracle and S1")
    obs_s1 = cost_model.cost_of(net, want_cost)
    obs_s2 = [cost_model.cost_of(net, c2) for c2 in costs]
    cheaper = "S1" if obs_s1 < np.mean(obs_s2) else "S2"
    r["s2"] = {"levels": levels, "launches": n, "max_levels": cap, "states": exec_ca.n_states,
               "wall_ms": s2_ms}
    r["observed_cost"] = {"S1": obs_s1, "S2_mean": float(np.mean(obs_s2)), "S2_max": max(obs_s2),
                          "cheaper": cheaper, "choice_matches": cheaper == c.strategy}
    log("plan", f"{q}: S2 (frontier_kernel/f32, {exec_ca.n_states} states, max_levels {cap}) on the "
        f"same starts: {levels} levels = {n} B1 launches, no other kernel, {s2_ms:.1f} ms; answers == "
        f"oracle == S1; observed cost_of S1 {obs_s1:.1f}, S2 mean {np.mean(obs_s2):.1f} (max "
        f"{max(obs_s2):.1f}) against the forecast S1 {plan.forecast_symbols['S1']:.1f}, S2 "
        f"{plan.forecast_symbols['S2']:.1f}: cheaper observed {cheaper}, plan chose {c.strategy}")
    return r


def phase_plan(g, placement, dg, staged, dev, record) -> None:
    """The §6 workflow on the full twin: probe a 256-peer overlay, fit the
    Bayesian model once, plan each Table-2 query, and run both strategies
    on the card for 8 sampled starts of each."""
    rec = record["plan"] = {}
    t0 = time.perf_counter()
    overlay = random_overlay(placement.n_sites, PLAN_DEGREE, seed=PLAN_SEED)
    net = planner.probe_network(overlay, placement, seed=PLAN_SEED)
    model = planner.fit_model(g)
    fit_s = time.perf_counter() - t0
    arrays = strategies.stage_site_arrays(placement, dev)
    nbytes = sum(a.numel() * a.element_size() for a in arrays.values())
    rec["net"] = {"n_peers": net.n_peers, "n_connections": net.n_connections,
                  "replication_rate": net.replication_rate, "probe_and_fit_s": fit_s,
                  "site_array_bytes": nbytes}
    log("plan", f"overlay {net.n_peers} peers, {net.n_connections} connections (d = "
        f"{net.mean_degree:.3f}), probed k = {net.replication_rate:.6f}; probes and the Bayesian fit "
        f"{fit_s:.1f} s on the host; padded site arrays {tuple(arrays['src'].shape)} staged once: "
        f"{nbytes / 1e6:.1f} MB")
    rng = np.random.default_rng(PLAN_SEED)
    for q in TABLE2_QUERIES:
        rec[q] = plan_query_phase(q, g, placement, net, model, arrays, dg, staged, dev, rng)
    matches = sum(r["observed_cost"]["choice_matches"] for r in rec.values() if "observed_cost" in r)
    ran = sum("observed_cost" in r for r in rec.values())
    log("plan", f"{len(TABLE2_QUERIES)} queries planned, {ran} run on both strategies; the plan's "
        f"choice is the cheaper observed one on {matches} of {ran} (an estimate: not checked)")
    del arrays


def complete_graph(n: int) -> LabeledGraph:
    """Every ordered pair of n nodes joined by an l0 edge: every tile of
    the store is full."""
    s, d = np.meshgrid(np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32), indexing="ij")
    return LabeledGraph(n, s.ravel(), np.zeros(n * n, np.int32), d.ravel(), ["l0"])


def check_counts_at_bound(dev) -> float:
    """B1 on a count frontier at the edge of its contract: the complete
    digraph of COUNT_NODES nodes at block 128 gives every output block a
    run of 8 full tiles (8 chunks, added by atomics in no fixed order);
    the frontier's first query row sums to exactly 2^24 - 1, which every
    output of that row then holds, the other rows below it.  Must be
    ``torch.equal`` to the plain version; returns max |diff| (0)."""
    g = complete_graph(COUNT_NODES)
    plan = fops.build_level_schedule(paa.compile_query("l0", g), fops.stage_graph(g, 128, device=dev))
    rng = np.random.default_rng(SEED)
    rows = (plan.n_states + len(plan.union_members)) * plan.q_pad
    f = np.zeros((rows, plan.v_pad), np.float32)
    f[: plan.q_pad, :COUNT_NODES] = rng.integers(0, 2**24 // COUNT_NODES, (plan.q_pad, COUNT_NODES))
    f[0, :COUNT_NODES] = rng.multinomial(2**24 - 1, np.full(COUNT_NODES, 1 / COUNT_NODES))
    f = torch.from_numpy(f).to(dev)
    got = fkernel.fused_level_blocks(*level_args(plan, f), **level_kw(plan))
    want = fkernel.fused_level_blocks_plain(*level_args(plan, f), n_out_rows=plan.n_states * plan.q_pad)
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    top = float(got.max())
    if not torch.equal(got, want) or top != 2**24 - 1:
        raise AssertionError(f"B1 on counts: max |diff| {err} from plain, largest sum {top}")
    runs = runs_of(plan)
    log("witness", f"B1 on counts == plain: complete digraph of {COUNT_NODES} nodes, B=128, "
        f"{int((runs > 0).sum())} runs of {int(runs.max())} full tiles in {plan.work.shape[0]} chunks "
        f"(CTAs); largest output sum {top:.0f} = 2^24 - 1")
    return err


def witness_run(placement, ca, starts, dev, **kw) -> tuple:
    """One ``s2_execute`` of ``starts`` with its wall ms, levels and launches."""
    lev0, launch0 = fops.FIXPOINT_COUNTERS["levels"], launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = strategies.s2_execute(placement, ca, starts, device=dev, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    launched = {k: counts[k] - launch0[k] for k in counts if counts[k] != launch0[k]}
    return out, wall_ms, fops.FIXPOINT_COUNTERS["levels"] - lev0, launched


def witness_breakdown(placement, ca, starts, backend, staged, dev) -> dict[str, float]:
    """A witness run taken apart: the executor's set-up (Stage B, the
    meters' degree vectors), its run until the level plane is ready on
    the card, and that plane's copy to the host as ``s2_execute`` makes
    it (pageable memory) and into pinned memory."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = strategies.make_s2_step_fn(
        ca, placement.graph.n_nodes, backend=backend, graph=placement.graph,
        replication_factor=placement.replication_factor, staged=staged, device=dev,
        semantics="witness")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    levels = step(starts)[4]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    levels.cpu()
    t3 = time.perf_counter()
    pinned = torch.empty(levels.shape, dtype=levels.dtype, pin_memory=True)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    pinned.copy_(levels)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    return {"setup_ms": (t1 - t0) * 1e3, "executor_ms": (t2 - t1) * 1e3, "copy_ms": (t3 - t2) * 1e3,
            "pinned_copy_ms": (t5 - t4) * 1e3}


def check_witness_levels(q, ca, g, index, starts, answers, levels, rng, what) -> int:
    """A witness run's levels: answers must be the pairs reached in an
    accepting state; 4 sampled starts with answers must have the host
    product BFS's levels; 8 sampled (start, answer) pairs must walk back
    to witnesses that pass the label-store check and the automaton
    re-match.  Returns the total witness length."""
    reached = np.zeros_like(answers)
    for qf in ca.accepting:
        reached |= witness.reached(levels[:, qf])
    if not np.array_equal(reached, answers):
        raise AssertionError(f"{what} {q}: the levels' accepting pairs differ from the answers")
    with_answers = np.nonzero(answers.any(axis=1))[0]
    for i in rng.choice(with_answers, size=min(4, len(with_answers)), replace=False):
        if not np.array_equal(levels[i], witness.host_levels(ca, index, int(starts[i]))):
            raise AssertionError(f"{what} {q} start {starts[i]}: levels differ from host_levels")
    bs, vs = np.nonzero(answers)
    length = 0
    for j in rng.choice(len(bs), size=min(N_WITNESSES, len(bs)), replace=False):
        s, t = int(starts[bs[j]]), int(vs[j])
        path = witness.reconstruct_path(ca, index, levels[bs[j]], s, t)
        ok, why = witness.validate_witness(path, g)
        if not ok or not witness.nfa_accepts_symbols(ca, path.steps) or path.nodes[0] != s \
                or path.nodes[-1] != t:
            raise AssertionError(f"{what} {q}: the witness {path} of ({s}, {t}) fails: {why}")
        length += len(path)
    return length


def phase_witness(g, placement, cas, truth, staged, dev, record) -> dict[str, int]:
    """Witness semantics and bounded counting on the full twin: every
    valid start of q1, q9 and q12 through ``s2_execute(semantics=
    "witness")`` on B1 and on B2 over the f32 store, beside the pairs run
    of the same executor; q1 again asking for the uint32 store without a
    Stage A, which must restage f32 and launch B1; ``count_paths_bounded``
    on q1 against the host DP; B1 on counts at 2^24 - 1.  Returns each
    level kernel's launches on the path."""
    rec = record["witness"] = {}
    index = paa.HostIndex(g)
    rng = np.random.default_rng(SEED + 2)
    launches, f32_levels = {}, {}
    for name in ("fused_level_blocks", "packed_level_blocks"):
        backend = KERNELS[name]["backend"]
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        for q in QUERIES:
            ca, t = cas[q], truth[q]
            kw = {"backend": backend, "tile_dtype": "f32", "staged": staged}
            (p_ans, p_costs), pairs_ms, _, _ = witness_run(placement, ca, t["starts"], dev, **kw)
            (ans, costs, levels), wit_ms, levels_run, launched = witness_run(
                placement, ca, t["starts"], dev, semantics="witness", **kw)
            bs, vs = np.nonzero(ans)
            got = np.unique(np.stack([t["starts"][bs], vs]).T, axis=0)
            if not np.array_equal(got, t["pairs"]) or not np.array_equal(ans, p_ans) or costs != p_costs:
                raise AssertionError(f"{backend} {q}: witness answers or meters differ from the pairs "
                                     "run or the device BFS")
            if launched != {name: levels_run}:
                raise AssertionError(f"{backend} {q}: the witness run launched {launched} in "
                                     f"{levels_run} levels")
            if levels.shape != (len(t["starts"]), ca.n_states, g.n_nodes) or levels.dtype != np.float32:
                raise AssertionError(f"{backend} {q}: levels of shape {levels.shape} {levels.dtype}")
            if name == "fused_level_blocks":
                f32_levels[q] = levels
            elif not np.array_equal(levels, f32_levels[q]):
                raise AssertionError(f"{q}: the packed levels differ from the f32 executor's")
            length = check_witness_levels(q, ca, g, index, t["starts"], ans, levels, rng, backend)
            finite = levels[witness.reached(levels)]
            r = rec[f"{backend}/{q}"] = {
                "starts": len(t["starts"]), "levels": levels_run, "launches": launched[name],
                "pairs_ms": pairs_ms, "witness_ms": wit_ms, "level_bytes": levels.nbytes,
                "deepest_level": float(finite.max()), "witness_hops": length,
                **witness_breakdown(placement, ca, t["starts"], backend, staged, dev),
            }
            log("witness", f"{backend}/f32 {q}: {r['starts']} starts; witness run {wit_ms:.1f} ms against "
                f"{pairs_ms:.1f} ms for pairs ({r['levels']} levels = {r['launches']} {name} launches, no "
                f"other kernel); answers and meters == pairs run == device BFS; levels "
                f"{levels.shape} ({levels.nbytes / 1e6:.1f} MB, deepest {r['deepest_level']:.0f})"
                f"{' == the f32 executor' if name != 'fused_level_blocks' else ''} == host_levels on 4 "
                f"starts with answers; {min(N_WITNESSES, len(bs))} witnesses ({length} hops) valid and "
                "accepted")
            log("witness", f"{backend}/f32 {q}, a third run taken apart: set-up {r['setup_ms']:.1f} ms, "
                f"executor to levels on the card {r['executor_ms']:.1f} ms, levels to pageable host "
                f"memory {r['copy_ms']:.1f} ms ({levels.nbytes / r['copy_ms'] / 1e6:.2f} GB/s), to pinned "
                f"host memory {r['pinned_copy_ms']:.1f} ms")
        launches[name] = only_launched(name, f"the witness phase on {backend}")
        if launches[name] != fops.FIXPOINT_COUNTERS["levels"]:
            raise AssertionError(f"{launches[name]} {name} launches for "
                                 f"{fops.FIXPOINT_COUNTERS['levels']} levels")

    # a uint32 request without a Stage A restages f32 and launches B1, not B3
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    (ans, _, levels), ms, levels_run, launched = witness_run(
        placement, cas["q1"], truth["q1"]["starts"], dev, backend="frontier_kernel",
        tile_dtype="uint32", semantics="witness")
    if launched != {"fused_level_blocks": levels_run} or not np.array_equal(levels, f32_levels["q1"]):
        raise AssertionError(f"q1 asking for uint32 tiles: launched {launched} in {levels_run} levels, "
                             "or levels differ from the f32 store's")
    launches["fused_level_blocks"] += launched["fused_level_blocks"]
    rec["restaged_q1"] = {"ms": ms, "levels": levels_run}
    log("witness", f"frontier_kernel q1 asking for tile_dtype='uint32', no Stage A: restaged f32 and ran "
        f"{levels_run} levels = B1 launches, no B3, in {ms:.1f} ms (Stage A of the f32 store inside); "
        "levels == the f32 run's")
    del ans, levels, f32_levels
    free()

    # bounded counting on q1 (8 levels) against the host DP
    ca = cas["q1"]
    with_answers = np.unique(truth["q1"]["pairs"][:, 0])
    sample = np.sort(rng.choice(with_answers, size=min(4, len(with_answers)), replace=False))
    plan = fops.build_level_schedule(ca, staged)
    masks = np.zeros((len(sample), g.n_nodes), np.float32)
    masks[np.arange(len(sample)), sample] = 1.0
    f0 = torch.from_numpy(fops.stack_start_masks(plan, ca.start, masks))
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = fops.count_paths_bounded(plan, f0.to(dev), ca.accepting, COUNT_LEVELS).cpu().numpy()
    count_ms = (time.perf_counter() - t0) * 1e3
    n = only_launched("fused_level_blocks", "count_paths_bounded")
    if n != COUNT_LEVELS:
        raise AssertionError(f"count_paths_bounded launched B1 {n} times for {COUNT_LEVELS} levels")
    launches["fused_level_blocks"] += n
    dedup = paa.HostIndex(g.dedup())  # the tile store holds each (src, label, dst) once
    for i, s in enumerate(sample.tolist()):
        host = witness.count_paths(ca, dedup, s, COUNT_LEVELS)
        if host.max() >= 2**24 or not np.array_equal(counts[i, : g.n_nodes], host.astype(np.float32)):
            raise AssertionError(f"q1 start {s}: count_paths_bounded differs from the host DP")
    top = float(counts[: len(sample)].max())
    rec["count_q1"] = {"starts": sample.tolist(), "levels": COUNT_LEVELS, "ms": count_ms, "largest": top}
    log("witness", f"count_paths_bounded q1, {COUNT_LEVELS} levels = {n} B1 launches, starts "
        f"{sample.tolist()}: == the host DP exactly; largest count {top:.0f}; {count_ms:.1f} ms")
    rec["b1_counts_at_bound_max_abs_err"] = check_counts_at_bound(dev)
    return launches


def check_schema(d: dict, schema: dict, path: str = "summary") -> None:
    """``d`` has exactly the keys of ``schema``, recursively where the
    schema holds keys (a None leaf is any value, {} any keys)."""
    if set(d) != set(schema):
        raise AssertionError(f"{path}: keys {sorted(d)} != repro's {sorted(schema)}")
    for k, sub in schema.items():
        if sub:
            check_schema(d[k], sub, f"{path}.{k}")


def serve_oracle(g, dg, stream) -> dict:
    """The device BFS's answer set of every (query, start) of ``stream``."""
    starts_of: dict[str, set] = {}
    for wq in stream:
        starts_of.setdefault(wq.query, set()).update(wq.starts.tolist())
    out = {}
    for q, starts in starts_of.items():
        s = np.array(sorted(starts), np.int32)
        src, dst = paa.answers_multi_source(paa.compile_query(q, g), dg, s)
        out.update({(q, v): set() for v in s.tolist()})
        for a, b in zip(src.tolist(), dst.tolist()):
            out[(q, a)].add(b)
    return out


def check_serve_answers(answers, stream, oracle, what: str) -> None:
    for wq, ans in zip(stream, answers, strict=True):
        for s, got in zip(wq.starts.tolist(), ans.answers, strict=True):
            if got != oracle[(wq.query, s)]:
                raise AssertionError(f"{what}: {wq.query!r} from {s} differs from the device BFS")


class ServeTimers:
    """Host ms of the service's layers over one run, by wrapping its
    calls: plan (``_plan``), Stage A (the plan store's ``staged_graph``,
    and the bytes of the distinct staged graphs it returned: the full
    store once, or each out-of-core assembly), S2 batching
    (``run_s2_group`` less the executions inside it), S2 execution
    (``s2_execute``), the S1 gather (``s1_collect``) and feedback
    (``calibrator.observe``)."""

    def __init__(self, svc):
        self.ms = collections.Counter()
        self.staged: dict[int, int] = {}
        self._undo = []
        self._wrap(svc, "_plan", "plan")
        self._wrap(svc.calibrator, "observe", "feedback")
        self._wrap(svc.plan_store, "staged_graph", "stage_a")
        self._wrap(strategies, "s2_execute", "s2_execute")
        self._wrap(strategies, "s1_collect", "s1_gather")
        self._wrap(batcher, "run_s2_group", "s2_group")

    def _wrap(self, obj, attr: str, key: str) -> None:
        fn = getattr(obj, attr)

        def timed_fn(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                self.ms[key] += (time.perf_counter() - t0) * 1e3
            if key == "stage_a":
                self.staged[id(out)] = out.tile_store_bytes
            return out

        self._undo.append((obj, attr, obj.__dict__.get(attr)))  # a module's own, or None
        setattr(obj, attr, timed_fn)

    def stop(self) -> dict:
        for obj, attr, own in self._undo:
            if own is None:
                delattr(obj, attr)  # the instance's method again
            else:
                setattr(obj, attr, own)
        out = {k: self.ms[k] for k in ("plan", "stage_a", "s2_execute", "s1_gather", "feedback")}
        out["s2_batch"] = self.ms["s2_group"] - self.ms["s2_execute"]
        out["staged_bytes"] = sum(self.staged.values())
        return out


def serve_stats(answers, wall_s: float) -> dict:
    lat = np.array([a.latency_s for a in answers]) * 1e3
    return {"requests": len(answers), "wall_s": wall_s, "queries_per_s": len(answers) / wall_s,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "strategies": dict(collections.Counter(a.strategy for a in answers)),
            "plan_cache_hits": sum(a.plan_cache_hit for a in answers)}


def serve_sync(svc, stream, **kw) -> tuple[list, dict]:
    """``stream`` through ``svc`` in windows of SERVE_WINDOW requests
    (enqueue the window, flush), timed and with its layers timed apart;
    the launch counts are set to 0 just before."""
    timers = ServeTimers(svc)
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = []
    for lo in range(0, len(stream), SERVE_WINDOW):
        tickets = [svc.enqueue(wq.query, wq.starts, **kw) for wq in stream[lo : lo + SERVE_WINDOW]]
        svc.flush()
        answers += [t.result() for t in tickets]
    torch.cuda.synchronize()
    r = serve_stats(answers, time.perf_counter() - t0)
    r["layers_ms"] = timers.stop()
    return answers, r


def serve_launched(name: str, what: str) -> dict:
    """The run's launches of level kernel ``name``: nonzero, one per
    fixpoint level, and no other kernel."""
    n = only_launched(name, what)
    levels = fops.FIXPOINT_COUNTERS["levels"]
    if n != levels:
        raise AssertionError(f"{what}: {n} {name} launches for {levels} levels")
    return {"kernel": name, "launches": n, "levels": levels}


def log_serve(run: str, r: dict) -> None:
    lay = r.get("layers_ms", {})
    log("serve", f"({run}): {r['requests']} requests in {r['wall_s']:.2f} s = {r['queries_per_s']:.2f} q/s, "
        f"latency p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms; strategies {r['strategies']}, "
        f"{r['plan_cache_hits']} plan-cache hits; {r.get('launches', 0)} {r.get('kernel', '-')} launches = "
        f"levels; host ms: plan {lay.get('plan', 0):.1f}, Stage A {lay.get('stage_a', 0):.1f} "
        f"({lay.get('staged_bytes', 0) / 1e9:.3f} GB staged), S2 batch {lay.get('s2_batch', 0):.1f}, "
        f"S2 execute {lay.get('s2_execute', 0):.1f}, S1 gather {lay.get('s1_gather', 0):.1f}, "
        f"feedback {lay.get('feedback', 0):.1f}")


async def serve_open_loop(svc, stream, rate_qps: float, seed: int) -> tuple:
    """``stream`` at Poisson arrivals of ``rate_qps`` through an
    ``AsyncQueryService`` (serve_async.py's tenants, SLO mix and knobs);
    the generator never waits for the server."""
    rng = np.random.default_rng(seed)
    answers, rejected = [None] * len(stream), collections.Counter()
    async with AsyncQueryService(svc, AioConfig(**SERVE_AIO)) as aio:

        async def one(i, wq, tenant, slo):
            try:
                answers[i] = await aio.submit(wq.query, wq.starts, tenant=tenant, slo=slo)
            except AdmissionRejected as e:
                rejected[e.reason] += 1

        tasks = []
        t0 = time.perf_counter()
        for i, wq in enumerate(stream):
            await asyncio.sleep(float(rng.exponential(1.0 / rate_qps)))
            slo = "latency" if rng.random() < SERVE_LATENCY_SHARE else "throughput"
            tasks.append(asyncio.ensure_future(one(i, wq, SERVE_TENANTS[i % len(SERVE_TENANTS)], slo)))
        await asyncio.gather(*tasks)
        wall = time.perf_counter() - t0
        stats = aio.aio_stats()
    return answers, rejected, wall, stats


def phase_serve(g, placement, dg, dev, record) -> dict[str, int]:
    """The serving runtime on the full twin (ROADMAP A10, A11): a 144-request
    stream through ``QueryService`` on B4, its first 48 on B1 with the
    whole f32 store and again under a 1 GiB out-of-core budget, 8 witness
    requests on B2, the async front end at 1x and 2x the sync rate, and a
    warm restart from a Stage-A snapshot.  Returns each level kernel's
    launches on the path."""
    rec = record["serve"] = {}
    overlay = random_overlay(placement.n_sites, PLAN_DEGREE, seed=PLAN_SEED)
    net = planner.probe_network(overlay, placement, seed=PLAN_SEED)
    stream = generate(g, WorkloadConfig(n_queries=SERVE_QUERIES, hot_pool=8, hot_fraction=0.8,
                                        min_starts=1, max_starts=8, seed=SEED))
    prefix = stream[:SERVE_PREFIX]
    t0 = time.perf_counter()
    oracle = serve_oracle(g, dg, stream)
    log("serve", f"stream: {len(stream)} requests, {len({w.query for w in stream})} distinct queries, "
        f"{sum(len(w.starts) for w in stream)} starts, {sum(w.hot for w in stream)} hot; device-BFS "
        f"answers of its {len(oracle)} (query, start) pairs in {time.perf_counter() - t0:.1f} s")
    launches = collections.Counter()

    def config(**kw) -> ServeConfig:
        return ServeConfig(n_rollouts=SERVE_ROLLOUTS, seed=SEED, **kw)

    # (a) the whole stream on the packed backend over the bit-plane store: B4
    svc = QueryService(placement, net, config=config(s2_backend="frontier_kernel_packed",
                                                    s2_tile_dtype="uint32"), device=dev)
    cold, r = serve_sync(svc, stream)
    r.update(serve_launched("packed_level_blocks_u32", "serve run (a)"))
    check_serve_answers(cold, stream, oracle, "serve run (a)")
    check_schema(svc.summary(), SUMMARY_KEYS)
    rec["a_cold"] = r
    log_serve("a, packed/uint32, cold", r)
    warm, r = serve_sync(svc, stream)
    r.update(serve_launched("packed_level_blocks_u32", "serve run (a), warm"))
    check_serve_answers(warm, stream, oracle, "serve run (a), warm")
    rec["a_warm"] = r
    launches[r["kernel"]] += r["launches"] + rec["a_cold"]["launches"]
    log_serve("a, packed/uint32, warm", r)

    # (d) witness requests on the packed backend: they restage f32 and run B2
    witness_stream = stream[:SERVE_WITNESS]
    wit, r = serve_sync(svc, witness_stream, strategy="S2", semantics="witness")
    r.update(serve_launched("packed_level_blocks", "serve run (d)"))
    check_serve_answers(wit, witness_stream, oracle, "serve run (d)")
    rng = np.random.default_rng(SEED + 3)
    walked = hops = 0
    for ans in wit:
        pairs = [(i, t) for i, ts in enumerate(ans.answers) for t in sorted(ts)]
        for j in rng.choice(len(pairs), size=min(SERVE_WALKS, len(pairs)), replace=False):
            i, t = pairs[j]
            path = svc.witness_path(ans, i, t)
            ok, why = witness.validate_witness(path, g)
            if not ok or not witness.nfa_accepts_symbols(ans.exec_ca, path.steps) \
                    or (path.nodes[0], path.nodes[-1]) != (int(ans.starts[i]), t):
                raise AssertionError(f"serve run (d): the witness {path} of {ans.query!r} fails: {why}")
            walked += 1
            hops += len(path)
    bytes_by_dtype = svc.plan_store.tile_store_stats()["bytes_by_dtype"]
    if bytes_by_dtype["f32"] == 0:
        raise AssertionError("serve run (d): the witness requests did not restage f32")
    r.update({"walked": walked, "hops": hops, "store_bytes": bytes_by_dtype})
    rec["d_witness"] = r
    launches[r["kernel"]] += r["launches"]
    log_serve("d, witness on packed", r)
    log("serve", f"(d): {walked} witnesses ({hops} hops) walked back, valid on the label store and "
        f"accepted; the store holds {bytes_by_dtype} bytes (f32 restaged for witness)")

    # (e) the async front end, open loop, at 1x and 2x run (a)'s warm rate
    sync_rate = rec["a_warm"]["queries_per_s"]
    for mult in (1, 2):
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        got, rejected, wall, stats = asyncio.run(serve_open_loop(svc, prefix, mult * sync_rate, SEED + mult))
        accepted = [(wq, a) for wq, a in zip(prefix, got) if a is not None]
        for wq, a, want in zip(prefix, got, warm):
            if a is not None and a.answers != want.answers:
                raise AssertionError(f"serve run (e) {mult}x: async answers of {wq.query!r} differ from sync")
        check_serve_answers([a for _, a in accepted], [wq for wq, _ in accepted], oracle,
                            f"serve run (e) {mult}x")
        r = {"offered_qps": mult * sync_rate, "offered": len(prefix), "completed": len(accepted),
             "goodput_qps": len(accepted) / wall, "reject_rate": sum(rejected.values()) / len(prefix),
             "rejected": dict(rejected), "wall_s": wall,
             "latency": {c: {k: stats["latency_hist"][c][k] for k in ("n", "p50_ms", "p99_ms", "p999_ms")}
                         for c in stats["latency_hist"]},
             "batch_window": stats["batch_window"]}
        if accepted and any(a.strategy == "S2" for _, a in accepted):
            r.update(serve_launched("packed_level_blocks_u32", f"serve run (e) {mult}x"))
            launches[r["kernel"]] += r["launches"]
        rec[f"e_async_{mult}x"] = r
        lat = r["latency"]
        log("serve", f"(e, async {mult}x = {r['offered_qps']:.2f} q/s offered): {r['completed']} of "
            f"{r['offered']} completed in {wall:.2f} s, goodput {r['goodput_qps']:.2f} q/s, reject rate "
            f"{r['reject_rate']:.4f} {r['rejected']}; latency class p50/p99/p999 ms "
            f"{lat['latency']['p50_ms']:.1f}/{lat['latency']['p99_ms']:.1f}/{lat['latency']['p999_ms']:.1f} "
            f"(n {lat['latency']['n']}), throughput class {lat['throughput']['p50_ms']:.1f}/"
            f"{lat['throughput']['p99_ms']:.1f}/{lat['throughput']['p999_ms']:.1f} (n {lat['throughput']['n']}); "
            f"{r.get('launches', 0)} B4 launches = levels; {stats['batch_window']['flushes']} flushes; "
            "answers == sync == device BFS")
    check_schema(svc.summary(), SUMMARY_KEYS)
    rec["summary_a"] = svc.summary()
    del svc, cold, warm, wit
    free()

    # (b) the first 48 on the f32 backend over the whole f32 store: B1
    svc = QueryService(placement, net, config=config(s2_backend="frontier_kernel"), device=dev)
    b_answers, r = serve_sync(svc, prefix)
    r.update(serve_launched("fused_level_blocks", "serve run (b)"))
    check_serve_answers(b_answers, prefix, oracle, "serve run (b)")
    check_schema(svc.summary(), SUMMARY_KEYS)
    rec["b_f32"] = r
    launches[r["kernel"]] += r["launches"]
    log_serve("b, f32/f32", r)

    # (f) a warm restart from (b)'s Stage-A snapshot: zero tiles packed
    with tempfile.TemporaryDirectory(prefix="repro-stage-a-") as tmp:
        path = os.path.join(tmp, "stage_a.pkl")
        t0 = time.perf_counter()
        manifest = svc.save_plan_store(path)
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        del svc
        free()
        svc = QueryService(placement, net, config=config(s2_backend="frontier_kernel"), device=dev)
        t0 = time.perf_counter()
        if not svc.restore_plan_store(path):
            raise AssertionError("serve run (f): the snapshot of run (b) did not restore")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    fops.reset_build_counters()
    first, r = serve_sync(svc, stream[:1], strategy="S2")
    r.update(serve_launched("fused_level_blocks", "serve run (f)"))
    check_serve_answers(first, stream[:1], oracle, "serve run (f)")
    packed = {k: fops.BUILD_COUNTERS[k] for k in ("pack_blocks", "stage_graph")}
    if any(packed.values()):
        raise AssertionError(f"serve run (f): the restored service packed tiles: {packed}")
    r.update({"manifest": manifest, "snapshot_bytes": size, "save_s": save_s, "restore_s": restore_s,
              "build_counters": dict(fops.BUILD_COUNTERS)})
    rec["f_restore"] = r
    launches[r["kernel"]] += r["launches"]
    log("serve", f"(f): run (b)'s Stage A saved ({manifest['n_entries']} entries, {size / 1e9:.3f} GB) in "
        f"{save_s:.1f} s, restored into a fresh service in {restore_s:.1f} s; its first S2 request "
        f"packed 0 tiles ({dict(fops.BUILD_COUNTERS)}), {r['launches']} B1 launches = levels, "
        f"{r['wall_s'] * 1e3:.1f} ms; answers == device BFS")
    del svc, first
    free()

    # (c) run (b) again under a 1 GiB out-of-core budget
    svc = QueryService(placement, net, config=config(s2_backend="frontier_kernel",
                                                    tile_store_budget_bytes=SERVE_BUDGET), device=dev)
    c_answers, r = serve_sync(svc, prefix)
    r.update(serve_launched("fused_level_blocks", "serve run (c)"))
    check_serve_answers(c_answers, prefix, oracle, "serve run (c)")
    if [a.answers for a in c_answers] != [a.answers for a in b_answers]:
        raise AssertionError("serve run (c): budgeted answers differ from run (b)'s")
    ts = svc.plan_store.tile_store_stats()
    if not (ts["spills"] and ts["reloads"]):
        raise AssertionError(f"serve run (c): the budgeted store did not spill and reload: {ts}")
    r["tile_store"] = ts
    rec["c_budget"] = r
    launches[r["kernel"]] += r["launches"]
    log_serve("c, f32/f32 under a 1 GiB budget", r)
    log("serve", f"(c): answers == run (b)'s; {ts['spills']} spills, {ts['reloads']} reloads, "
        f"{ts['slabs_resident']} slabs resident ({ts['bytes_by_dtype']['f32'] / 1e9:.3f} GB of host "
        f"slabs), {ts['slabs_spilled']} spilled")
    check_schema(svc.summary(), SUMMARY_KEYS)
    del svc, b_answers, c_answers
    free()
    return dict(launches)


def gathered_sectors(idx: torch.Tensor, row_bytes: int) -> int:
    """The 32-byte sectors that the gathered rows span: row ``i`` lies at
    bytes ``i·row_bytes .. (i + 1)·row_bytes - 1`` of the table."""
    start = idx.long() * row_bytes
    return int(((start + row_bytes - 1) // 32 - start // 32 + 1).sum())


def embedbag_case(name, table, idx, bags, n_bags, entry, flush) -> dict:
    """One EmbeddingBag workload: the entry point once with the counts at
    0 (B6 must launch, nothing else), the kernel against its plain version
    on the same sorted lookups (``torch.equal``: the same adds in the same
    order), the launch geometry, the times, the bounds and
    F.embedding_bag."""
    reset_launches()
    out = entry(table, idx, bags, n_bags)
    torch.cuda.synchronize()
    launches = only_launched("embedding_bag_sorted", f"{entry.__name__} ({name})")
    sorted_bags, order = torch.sort(bags, stable=True)
    s_idx = idx[order]
    want = embedbag.embedding_bag_sorted_plain(table, s_idx, sorted_bags, n_bags)
    visited = torch.zeros(n_bags, dtype=torch.bool, device=table.device)
    visited[bags.long()] = True
    got = embedbag.embedding_bag_sorted(table, s_idx, sorted_bags, n_bags)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not torch.equal(out[~visited], torch.zeros_like(out[~visited])) or not torch.equal(
            out[visited], got[visited]):
        raise AssertionError(f"{name}: {entry.__name__} differs from the kernel on the sorted lookups")
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: B6 != plain, max |diff| {err} (largest |sum| {scale})")
    del out, got, want
    d, esize = table.shape[1], table.element_size()
    geo = embedbag.launch_geometry(d, esize, table.data_ptr(), idx.numel())
    t = timed(lambda: embedbag.embedding_bag_sorted(table, s_idx, sorted_bags, n_bags), 10, 5, flush)
    t["plain_ms"] = events_ms(lambda: embedbag.embedding_bag_sorted_plain(table, s_idx, sorted_bags, n_bags), 3, flush)
    offsets = embedbag.bag_offsets(sorted_bags, n_bags)[:-1]
    t["library_ms"] = events_ms(lambda: F.embedding_bag(s_idx, table, offsets, mode="sum"), 5, flush)
    rows = int(torch.unique(idx).numel())
    side = 2 * idx.numel() * 4 + n_bags * d * esize  # index arrays and the output
    nbytes = rows * d * esize + side
    t["bound_ms"], t["bound_by"] = bound(nbytes, idx.numel() * d, FP32_FLOPS)
    t["gathered_bound_ms"] = (idx.numel() * d * esize + side) / HBM_BYTES_PER_S * 1e3
    sectors = gathered_sectors(idx, d * esize)
    t["sector_bound_ms"] = (sectors * 32 + side) / HBM_BYTES_PER_S * 1e3
    units = idx.numel() // geo["per_unit"] + 1
    t.update({"launches": launches, "max_abs_err": err, "largest_abs_sum": scale,
              "distinct_rows": rows, "bytes": nbytes, "gathered_sectors": sectors, "geometry": geo,
              "lane_groups": units * geo["n_chunks"]})
    log("embedbag", f"{name}: table {tuple(table.shape)} {table.dtype} ({table.numel() * esize / 1e9:.2f} GB), "
        f"{idx.numel()} lookups into {n_bags} bags; {launches} B6 launch, no other kernel, no offsets "
        f"pass; kernel == plain (largest |sum| {scale:.3f}); schedule: table rows, {units} lane groups of "
        f"{geo['lanes']} lanes x {geo['n_chunks']} column chunk(s), {geo['vec_bytes']}-byte loads, "
        f"{geo['per_unit']} lookups a group; {t['ms']:.4f} ms (L2 flushed; {t['warm_ms']:.4f} warm; "
        f"{t['events_ms']:.4f} one call), plain {t['plain_ms']:.4f} ms, F.embedding_bag "
        f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({rows} distinct "
        f"rows once, {nbytes / 1e9:.3f} GB); every gathered row from HBM: {t['gathered_bound_ms']:.4f} "
        f"ms; at 32-byte sectors ({sectors} sectors, {sectors * 32 / 1e9:.3f} GB): "
        f"{t['sector_bound_ms']:.4f} ms")
    return t


def phase_embedbag(dev, gen, flush, record) -> dict:
    """B6 through ``embedding_bag`` at dlrm-mlperf's largest table and
    through ``gnn_aggregate`` at ogb_products."""
    rec = record["embedbag"] = {}
    table = torch.randn((DLRM_ROWS, DLRM_DIM), generator=gen, device=dev, dtype=torch.bfloat16)
    idx = torch.randint(0, DLRM_ROWS, (DLRM_LOOKUPS,), generator=gen, device=dev, dtype=torch.int32)
    bags = torch.randperm(DLRM_LOOKUPS, generator=gen, device=dev).to(torch.int32)
    rec["dlrm"] = embedbag_case("dlrm-mlperf table 20, serve_bulk", table, idx, bags, DLRM_LOOKUPS,
                                eb_ops.embedding_bag, flush)
    del table, idx, bags
    free()
    feats = torch.randn((OGB_NODES, OGB_FEAT), generator=gen, device=dev)
    src = torch.randint(0, OGB_NODES, (OGB_EDGES,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, OGB_NODES, (OGB_EDGES,), generator=gen, device=dev, dtype=torch.int32)
    rec["ogb"] = embedbag_case("ogb_products, uniform edges", feats, src, dst, OGB_NODES,
                               eb_ops.gnn_aggregate, flush)
    del feats, src, dst
    free()
    t = rec["ogb"]
    return {"name": "embedding_bag_sorted", "route": "cuda",
            "source": "src/repro_torch/kernels/embedbag/csrc/embedbag.cu",
            "replaces": "src/repro/kernels/embedbag/embedbag.py:34",
            "launches": rec["dlrm"]["launches"] + t["launches"],
            "max_abs_err": max(rec["dlrm"]["max_abs_err"], t["max_abs_err"]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def phase_decode(dev, gen, flush, record) -> dict:
    """B7 through ``decode_attention`` at qwen3-14b's attention widths, at
    decode_32k and long_500k: kernel against plain version, times, bound,
    and F.scaled_dot_product_attention on the kv_len prefix."""
    rec = record["decode"] = {}
    for name, (batch, seq) in DECODE_SHAPES.items():
        kv = seq - 17
        q = torch.randn((batch, QWEN_HEADS, QWEN_DH), generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn((batch, seq, QWEN_KV_HEADS, QWEN_DH), generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn((batch, seq, QWEN_KV_HEADS, QWEN_DH), generator=gen, device=dev, dtype=torch.bfloat16)
        kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
        n_split, split_len = decode_attn.decode_splits(batch, QWEN_KV_HEADS, seq)
        part_bytes = 0 if n_split == 1 else batch * QWEN_HEADS * n_split * (QWEN_DH + 2) * 4
        log("decode", f"{name}: {n_split} kv split(s) of {split_len} positions: a grid of "
            f"{batch * QWEN_KV_HEADS} x {n_split} CTAs, {part_bytes} bytes of f32 partials")
        reset_launches()
        out = da_ops.decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        launches = only_launched("flash_decode_gqa", f"decode_attention ({name})")
        want = decode_attn.flash_decode_gqa_plain(q, k, v, kv_len)
        scale = float(want.float().abs().max())
        limit = BF16_TOL * scale

        def diff(got: torch.Tensor) -> float:
            return float((got.float() - want.float()).abs().max())

        err = diff(out)
        if out.dtype != torch.bfloat16 or not torch.isfinite(out.float()).all() or err > limit:
            raise AssertionError(f"{name}: B7 != plain: max |diff| {err} > {limit} "
                                 f"({BF16_TOL} of the largest |output| {scale})")
        half = decode_attn.flash_decode_gqa(q, k, v, torch.tensor(kv // 2, dtype=torch.int32, device=dev))
        controls = {"zeros": diff(torch.zeros_like(out)), "half_cache": diff(half)}
        del half
        if min(controls.values()) <= limit:
            raise AssertionError(f"{name}: a wrong output passes the B7 check: {controls} <= {limit}")
        t = rec[name] = timed(lambda: decode_attn.flash_decode_gqa(q, k, v, kv_len), 3, 3, flush)
        t["plain_ms"] = events_ms(lambda: decode_attn.flash_decode_gqa_plain(q, k, v, kv_len), 2, flush)
        nbytes = 2 * batch * kv * QWEN_KV_HEADS * QWEN_DH * 2 + 2 * q.numel() * 2
        ops = 4 * batch * QWEN_HEADS * kv * QWEN_DH
        t["bound_ms"], t["bound_by"] = bound(nbytes, ops, BF16_FLOPS)
        t.update({"n_split": n_split, "split_len": split_len, "partial_bytes": part_bytes,
                  "launches": launches, "max_abs_err": err, "limit": limit, "largest_abs_out": scale,
                  "rms_out": float(want.float().square().mean().sqrt()), "controls": controls,
                  "bytes": nbytes, "ops": ops})
        del want, out
        # the library call on its own layout: (B, G, kv_len, Dh) contiguous
        kt = k[:, :kv].transpose(1, 2).contiguous()
        del k
        vt = v[:, :kv].transpose(1, 2).contiguous()
        del v
        q4 = q.unsqueeze(2)
        t["library_ms"] = events_ms(
            lambda: F.scaled_dot_product_attention(q4, kt, vt, enable_gqa=True), 3, flush)
        del q, q4, kt, vt, kv_len
        free()
        log("decode", f"{name}: B={batch}, S={seq}, kv_len={kv}, H={QWEN_HEADS}, G={QWEN_KV_HEADS}, "
            f"Dh={QWEN_DH} bf16 (K and V {nbytes / 1e9:.2f} GB); {launches} B7 launch, no other kernel; "
            f"kernel ~= plain (max |diff| {err} <= {limit} = {BF16_TOL} x largest |output| {scale}; "
            f"rms output {t['rms_out']}; controls miss it: all-zero {controls['zeros']}, half the "
            f"cache {controls['half_cache']}); {t['ms']:.4f} ms (L2 flushed; "
            f"{t['warm_ms']:.4f} warm; {t['events_ms']:.4f} one call), plain {t['plain_ms']:.4f} ms, "
            f"SDPA {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms by {t['bound_by']}")
    t = rec["decode_32k"]
    return {"name": "flash_decode_gqa", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
            "replaces": "src/repro/kernels/decode_attn/decode_attn.py:61",
            "launches": sum(r["launches"] for r in rec.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rec.values()), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full record as JSON to this file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' bmm in full f32
    record: dict = {"seconds": {}}
    t_start = t_phase = time.perf_counter()

    def phase_end(name: str) -> None:
        nonlocal t_phase
        torch.cuda.synchronize()
        now = time.perf_counter()
        record["seconds"][name] = now - t_phase
        log(name, f"phase took {now - t_phase:.1f} s; {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            "peak allocated in it")
        torch.cuda.reset_peak_memory_stats()
        t_phase = now

    # ---- env -------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    total_mem = torch.cuda.get_device_properties(0).total_memory
    log("env", f"device {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s); {total_mem / 1e9:.2f} GB")
    record["env"] = {"kind": kind, "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    phase_end("env")

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log("build", f"{len(_build.SOURCES)} sources in {time.perf_counter() - t0:.2f} s wall")
    for name in _build.SOURCES:
        info = _build.BUILD_LOG[name]
        took = "cached" if info["seconds"] is None else f"nvcc {info['seconds']:.2f} s"
        log("build", f"{name}: {took}")
        for line in info["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log("build", f"  {line.strip()}")
    record["build"] = _build.BUILD_LOG
    phase_end("build")

    # ---- setup: the twin, its placement, both Stage-A stores -------------
    t0 = time.perf_counter()
    g = alibaba_like(seed=SEED)
    placement = distribute(g, n_sites=256, replication_rate=0.2, seed=SEED)
    log("setup", f"twin: {g.n_nodes} nodes, {g.n_edges} edges, {g.n_labels} labels; "
        f"256 sites, K = {placement.replication_factor:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    stores, record["setup"] = {}, {"device_bytes": total_mem}
    for td in ("f32", "uint32"):
        t0 = time.perf_counter()
        stores[td] = fops.stage_graph(g, block_size=128, tile_dtype=td, device=dev)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        s = stores[td]
        log("setup", f"Stage A {td}: {s.tiles.shape[0]} tiles of {tuple(s.tiles.shape[1:])} "
            f"{s.tiles.dtype}, {s.tile_store_bytes / 1e9:.4f} GB = "
            f"{100 * s.tile_store_bytes / total_mem:.3f}% of device memory ({stage_s:.1f} s)")
        record["setup"][td] = {"tiles": int(s.tiles.shape[0]), "bytes": s.tile_store_bytes,
                               "stage_s": stage_s}
    s32, su = stores["f32"], stores["uint32"]
    if list(s32.offsets) != list(su.offsets) or any(
        (a[0], a[1].tobytes(), a[2].tobytes()) != (b[0], b[1].tobytes(), b[2].tobytes())
        for a, b in zip(s32.offsets.values(), su.offsets.values())
    ):
        raise AssertionError("the uint32 store's offsets differ from the f32 store's")
    cas = {q: paa.compile_query(TABLE2_QUERIES[q], g) for q in QUERIES}
    q1_tids = torch.unique(fops.build_level_schedule(cas["q1"], su).tile_ids).long()
    if not torch.equal(fkernel.unpack_tile_bits(su.tiles[q1_tids], 128), s32.tiles[q1_tids]):
        raise AssertionError("q1's uint32 tiles do not unpack to its f32 tiles")
    log("setup", f"uint32 offsets == f32 offsets; q1's {len(q1_tids)} tiles unpack to the f32 tiles")
    phase_end("setup")

    # ---- kernels: each CUDA level kernel against its plain version ---------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)  # 64 MB > L2
    max_err = check_kernels(stores, cas, dev, gen)
    level_times = record["level_times"] = time_levels(stores, cas, gen, flush)
    phase_end("kernels")

    # ---- path: s2_execute on q1, q9, q12 for each (backend, tiles) -------
    dg = to_device_graph(g, dev)
    index = paa.HostIndex(g)
    rng = np.random.default_rng(SEED)
    truth = {}
    for q in QUERIES:
        starts = paa.valid_start_nodes(cas[q], g)
        o_src, o_dst = paa.answers_multi_source(cas[q], dg, starts)
        sample = rng.choice(len(starts), size=min(N_METER_SAMPLES, len(starts)), replace=False)
        truth[q] = {
            "starts": starts,
            "pairs": np.unique(np.stack([o_src, o_dst]).T, axis=0),
            "meters": {int(i): paa.run_instrumented(cas[q], index, int(starts[i])) for i in sample},
        }
    record["path"], launches = {}, {}
    for name, k in KERNELS.items():
        backend, td = k["backend"], k["tile_dtype"]
        per_query = record["path"][f"{backend}/{td}"] = {}
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        for q in QUERIES:
            ca, t = cas[q], truth[q]
            lev0, sync0 = fops.FIXPOINT_COUNTERS["levels"], fops.FIXPOINT_COUNTERS["host_syncs"]
            launch0 = launch_counts()[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers, costs = strategies.s2_execute(
                placement, ca, t["starts"], backend=backend, tile_dtype=td,
                staged=stores[td], device=dev,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r = per_query[q] = {
                "starts": len(t["starts"]),
                "levels": fops.FIXPOINT_COUNTERS["levels"] - lev0,
                "launches": launch_counts()[name] - launch0,
                "host_syncs": fops.FIXPOINT_COUNTERS["host_syncs"] - sync0,
                "wall_ms": wall * 1e3,
                "queries_per_s": len(t["starts"]) / wall,
            }
            bs, vs = np.nonzero(answers)
            got = np.unique(np.stack([t["starts"][bs], vs]).T, axis=0)
            if not np.array_equal(got, t["pairs"]):
                raise AssertionError(f"{backend}/{td} {q}: answers differ from the device-BFS oracle")
            for i, tr in t["meters"].items():
                c = costs[i]
                # unicast symbols went through f32 x K and float64 / K: exact after rounding
                if (c.broadcast_symbols, round(c.unicast_symbols), c.n_broadcasts) != (
                    tr.q_bc, tr.d_s2, tr.n_broadcasts
                ):
                    raise AssertionError(f"{backend}/{td} {q} start {t['starts'][i]}: meters {c} != host {tr}")
            r["pairs"] = int(len(got))
            paper_pairs, paper_starts = TABLE2_PAPER[q]
            log("path", f"{backend}/{td} {q}: {r['starts']} starts (paper {paper_starts}), {r['pairs']} "
                f"answer pairs (paper {paper_pairs}, for information); {r['levels']} levels, "
                f"{r['launches']} launches, {r['host_syncs']} host syncs, {r['wall_ms']:.1f} ms, "
                f"{r['queries_per_s']:.1f} queries/s; answers == oracle, meters == host meter on "
                f"{len(t['meters'])} starts")
        n = only_launched(name, f"the {backend}/{td} path")
        levels = fops.FIXPOINT_COUNTERS["levels"]
        if n != levels:
            raise AssertionError(f"{n} {name} launches for {levels} BFS levels")
        launches[name] = n
    phase_end("path")

    record["trace"] = {}
    for k in KERNELS.values():
        backend, td = k["backend"], k["tile_dtype"]
        for q in QUERIES:
            query_args = (placement, cas[q], truth[q]["starts"], stores[td], dev, backend, k["symbol"])
            tr, path_q = trace_query(*query_args), record["path"][f"{backend}/{td}"][q]
            if tr["level_kernel"]["count"] != path_q["launches"]:
                # the tracer may drop a few of a run's ~10^4 device records (a
                # chip run has traced 1,085 of q9's 1,088 B1 launches, which the
                # wrapper counted exactly): trace a second run, which must match
                lost = tr["level_kernel"]["count"]
                log("trace", f"{backend}/{td} {q}: the trace holds {lost} of {path_q['launches']} "
                    "level-kernel launches; tracing another run")
                tr = trace_query(*query_args)
                tr["first_trace_count"] = lost
            record["trace"][f"{backend}/{td}/{q}"] = tr
            lk = tr["level_kernel"]
            if not lk["count"] == path_q["launches"] == path_q["levels"]:
                raise AssertionError(f"{backend}/{td} {q}: the trace holds {lk['count']} launches of "
                                     f"the level kernel {lk['name']}, the path phase "
                                     f"{path_q['launches']} in {path_q['levels']} levels")
            log("trace", f"{backend}/{td} {q}: set-up {tr['setup_ms']:.1f} ms, run {tr['run_ms']:.1f} ms "
                f"= {len(truth[q]['starts']) / tr['run_ms'] * 1e3:.1f} queries/s "
                f"({tr['traced_ms']:.1f} ms traced); device busy {tr['device_busy_ms']:.1f} ms, "
                f"idle share {tr['idle_share']:.4f} of the traced run, "
                f"{tr['idle_share_of_untraced_run']:.4f} of the untraced one; level kernel "
                f"{lk['ms']:.3f} ms device time in {lk['count']} launches; fills "
                f"{tr['fills']['ms']:.3f} ms in {tr['fills']['count']}")
            for kname, kt in list(tr["kernels"].items())[:8]:
                log("trace", f"  {kt['us'] / 1e3:9.3f} ms {kt['count']:6d}x  {kname[:90]}")

    phase_end("trace")

    phase_plan(g, placement, dg, stores["f32"], dev, record)
    phase_end("plan")

    for name, n in phase_witness(g, placement, cas, truth, stores["f32"], dev, record).items():
        launches[name] += n
    max_err["fused_level_blocks"] = max(max_err["fused_level_blocks"],
                                        record["witness"]["b1_counts_at_bound_max_abs_err"])
    phase_end("witness")

    for name, n in phase_serve(g, placement, dg, dev, record).items():
        launches[name] += n
    phase_end("serve")

    new_kernels = [phase_baseline(g, cas, dg, stores, dev, gen, flush, record)]
    del stores, dg
    free()
    phase_end("baseline")
    new_kernels.append(phase_embedbag(dev, gen, flush, record))
    phase_end("embedbag")
    new_kernels.append(phase_decode(dev, gen, flush, record))
    phase_end("decode")

    kernels = [{
        "name": name,
        "route": "cuda",
        "source": k["source"],
        "replaces": k["replaces"],
        "launches": launches[name],
        "max_abs_err": max_err[name],
        "ms": level_times[name]["q1"]["ms"],
        "plain_ms": level_times[name]["q1"]["plain_ms"],
        "bound_ms": level_times[name]["q1"]["bound_ms"],
        "bound_by": level_times[name]["q1"]["bound_by"],
        "library_ms": None,
    } for name, k in KERNELS.items()] + new_kernels
    record["kernels"] = kernels
    log("end", f"phases (s): {record['seconds']}; total {time.perf_counter() - t_start:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
