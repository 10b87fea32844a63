#!/usr/bin/env python3
"""Drive the port's S2 frontier paths end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE]

Four paths, one per (backend, tile store) pair, each carried by one
hand-written CUDA kernel:

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
             of cover steps; the packed kernels on random lane words over
             all 32 bits.  Then the time of one level of each query's
             plan for each kernel, the plain version's, and the bound;
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
             with ``torch.profiler``: device busy time, idle share, and
             device time per kernel.

The last two lines are a JSON object with one entry per kernel, then
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
when no GPU is present or when run without the repository's ``src/``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.core import paa, strategies  # noqa: E402
from repro_torch.graph.generators import (  # noqa: E402
    TABLE2_PAPER, TABLE2_QUERIES, alibaba_like, random_labeled_graph,
)
from repro_torch.graph.partition import distribute  # noqa: E402
from repro_torch.graph.structure import LabeledGraph, to_device_graph  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.frontier import frontier as fkernel  # noqa: E402
from repro_torch.kernels.frontier import ops as fops  # noqa: E402
from repro_torch.kernels.frontier.ref import tile_words  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and
# float32 FLOP/s outside the tensor cores; INT32 lanes are half the FP32
# lanes of an SM (64 against 128), so int32 operations run at half that
INT32_OPS = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
QUERIES = ("q1", "q9", "q12")
N_METER_SAMPLES = 32
SEED = 0
CSRC = "src/repro_torch/kernels/frontier/csrc"
FRONTIER_PY = "src/repro/kernels/frontier/frontier.py"

# kernel name -> what drives and describes it; "lanes" marks the packed
# kernels, whose frontier is int32 lane words
KERNELS = {
    "fused_level_blocks": {
        "wrapper": fkernel.fused_level_blocks, "plain": fkernel.fused_level_blocks_plain,
        "tile_dtype": "f32", "lanes": False, "backend": "frontier_kernel",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:209",
    },
    "fused_level_blocks_u32": {
        "wrapper": fkernel.fused_level_blocks, "plain": fkernel.fused_level_blocks_plain,
        "tile_dtype": "uint32", "lanes": False, "backend": "frontier_kernel",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:188",
    },
    "packed_level_blocks": {
        "wrapper": fkernel.packed_level_blocks, "plain": fkernel.packed_level_blocks_plain,
        "tile_dtype": "f32", "lanes": True, "backend": "frontier_kernel_packed",
        "source": f"{CSRC}/packed_level.cu", "replaces": f"{FRONTIER_PY}:337",
    },
    "packed_level_blocks_u32": {
        "wrapper": fkernel.packed_level_blocks, "plain": fkernel.packed_level_blocks_plain,
        "tile_dtype": "uint32", "lanes": True, "backend": "frontier_kernel_packed",
        "source": f"{CSRC}/packed_level.cu", "replaces": f"{FRONTIER_PY}:311",
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


def trace_query(placement, ca, starts, staged, dev, backend: str) -> dict:
    """One query's per-call set-up timed apart from its run, and the run
    traced with ``torch.profiler``: device busy time (the union of the
    device events' intervals), its share of the traced wall time, and the
    device time and count of each kernel."""
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
    return {
        "setup_ms": setup_ms, "run_ms": run_ms, "traced_ms": traced_ms,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / traced_ms,
        "idle_share_of_untraced_run": 1.0 - busy_us / 1e3 / run_ms,
        "kernels": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1]["us"])),
    }


def check_kernels(stores, cas, dev, gen) -> dict[str, float]:
    """Each kernel against its plain version on cases a, b and c; returns
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
        for label, plan in cases.items():
            valids = plan.valids.cpu().numpy()
            ptr = plan.run_ptr.cpu().numpy()
            cover_only = int(sum(valids[lo:hi].sum() == 0 for lo, hi in zip(ptr[:-1], ptr[1:])))
            f = random_frontier(plan, gen, k["lanes"])
            n_out = plan.n_states * plan.q_pad
            got = k["wrapper"](*level_args(plan, f), n_out_rows=n_out, run_ptr=plan.run_ptr)
            want = k["plain"](*level_args(plan, f), n_out_rows=n_out)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            max_err[name] = max(max_err[name], err)
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{name} != plain on case {label}: max |diff| {err}")
            log("kernels", f"{name} == plain on case {label}: {plan.n_states} states, "
                f"B={plan.block_size}, {td} tiles, {len(valids)} steps ({int(valids.sum())} with a "
                f"tile), {cover_only} of {len(ptr) - 1} output blocks cover-only")
        if cover_only == 0:
            raise AssertionError("case c has no cover-only output block")
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
            kw = {"n_out_rows": plan.n_states * plan.q_pad}

            def kernel_level(k=k, plan=plan, f=f, kw=kw):
                return k["wrapper"](*level_args(plan, f), **kw, run_ptr=plan.run_ptr)

            def plain_level(k=k, plan=plan, f=f, kw=kw):
                return k["plain"](*level_args(plan, f), **kw)

            bound_ms, bound_by, nbytes, ops = level_bound(plan, k["lanes"])
            t = times.setdefault(name, {})[q] = {
                "ms": graph_ms(kernel_level, 50, flush),
                "warm_ms": graph_ms(kernel_level, 50, None),
                "events_ms": events_ms(kernel_level, 20, flush),
                "plain_ms": events_ms(plain_level, 10, flush),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops,
            }
            log("kernels", f"{name} {q} level: kernel {t['ms'] * 1e3:.2f} us (L2 flushed; "
                f"{t['warm_ms'] * 1e3:.2f} us warm; {t['events_ms'] * 1e3:.2f} us one call between "
                f"events), plain {t['plain_ms'] * 1e3:.2f} us between events, bound "
                f"{bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M ops)")
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full record as JSON to this file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' bmm in full f32
    record: dict = {}

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

    # ---- kernels: each CUDA level kernel against its plain version ---------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)  # 64 MB > L2
    max_err = check_kernels(stores, cas, dev, gen)
    level_times = record["level_times"] = time_levels(stores, cas, gen, flush)

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
        fkernel.reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        for q in QUERIES:
            ca, t = cas[q], truth[q]
            lev0, sync0 = fops.FIXPOINT_COUNTERS["levels"], fops.FIXPOINT_COUNTERS["host_syncs"]
            launch0 = fkernel.launch_counts()[name]
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
                "launches": fkernel.launch_counts()[name] - launch0,
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
        counts = fkernel.launch_counts()
        levels = fops.FIXPOINT_COUNTERS["levels"]
        if counts[name] == 0:
            raise AssertionError(f"the {backend}/{td} path launched no {name} kernel")
        if counts[name] != levels:
            raise AssertionError(f"{counts[name]} {name} launches for {levels} BFS levels")
        if sum(counts.values()) != counts[name]:
            raise AssertionError(f"the {backend}/{td} path launched other kernels: {counts}")
        launches[name] = counts[name]

    record["trace"] = {}
    for k in KERNELS.values():
        backend, td = k["backend"], k["tile_dtype"]
        for q in QUERIES:
            tr = record["trace"][f"{backend}/{td}/{q}"] = trace_query(
                placement, cas[q], truth[q]["starts"], stores[td], dev, backend
            )
            log("trace", f"{backend}/{td} {q}: set-up {tr['setup_ms']:.1f} ms, run {tr['run_ms']:.1f} ms "
                f"= {len(truth[q]['starts']) / tr['run_ms'] * 1e3:.1f} queries/s "
                f"({tr['traced_ms']:.1f} ms traced); device busy {tr['device_busy_ms']:.1f} ms, "
                f"idle share {tr['idle_share']:.4f} of the traced run, "
                f"{tr['idle_share_of_untraced_run']:.4f} of the untraced one")
            for kname, kt in list(tr["kernels"].items())[:8]:
                log("trace", f"  {kt['us'] / 1e3:9.3f} ms {kt['count']:6d}x  {kname[:90]}")

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
    } for name, k in KERNELS.items()]
    record["kernels"] = kernels
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
