#!/usr/bin/env python3
"""Drive the port's S2 frontier path end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE]

Phases, each of which raises on failure (the run then exits non-zero):

* env      — the card's name and power limit, torch and CUDA versions;
* build    — every CUDA kernel of the path, built from ``src/`` with nvcc;
* setup    — the Alibaba twin (``alibaba_like(seed=0)``: 50,000 nodes,
             327,848 edges, 216 labels), its 256-site placement at
             replication rate 0.2 (``configs/alibaba_rpq.py``), and the
             whole f32 Stage-A tile store on the device;
* kernels  — each kernel against its plain PyTorch version on the card,
             exactly equal (``torch.equal``: {0,1} operands and integer
             sums below 2^24 are exact in f32 in any order) on (a) the
             q1 plan at full scale, (b) a block-16 plan with an empty
             label store, a wildcard and an inverse transition, (c) a
             plan with output blocks made only of cover steps; then the
             time of one level of each query's plan, the plain
             version's, and the bound;
* path     — ``s2_execute(backend="frontier_kernel")`` on Table-2
             queries q1, q9 and q12 over all their valid starts, with
             the launch counts set to 0 just before and read just after;
             answers must equal the device-BFS oracle for every start,
             the §4.2 meters must equal the host meter on 32 sampled
             starts, and the kernel launches must equal the BFS levels;
* trace    — each query again, its per-call set-up
             (``make_s2_step_fn``: Stage B and the meters' degree
             vectors) timed apart from its run, and the run traced with
             ``torch.profiler``: device busy time, idle share, and device
             time per kernel.

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

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
QUERIES = ("q1", "q9", "q12")
N_METER_SAMPLES = 32
SEED = 0


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
    """The positional arguments of one fused level on ``plan``."""
    return (
        frontier, plan.tiles, plan.firsts, plan.valids, plan.tile_ids,
        plan.f_rows, plan.f_cols, plan.o_rows, plan.o_cols,
        plan.block_size, plan.q_pad,
    )


def random_frontier(plan, gen) -> torch.Tensor:
    """A seeded {0,1} frontier with its union rows, padded columns empty."""
    rows = (plan.n_states + len(plan.union_members)) * plan.q_pad
    f = (torch.rand((rows, plan.v_pad), generator=gen, device=plan.tiles.device) < 0.3).float()
    f[:, plan.n_nodes :] = 0.0
    return f


def level_bound(plan) -> tuple[float, str, int, int]:
    """The least time one level could take on the card: each real tile,
    frontier block and schedule entry read once, the output written once
    (bytes), against 2·8·B² flops per valid step; returns (ms, the
    binding resource, bytes, flops)."""
    valids = plan.valids.cpu().numpy().astype(bool)
    tids = plan.tile_ids.cpu().numpy()[valids]
    fblocks = set(zip(plan.f_rows.cpu().numpy()[valids].tolist(), plan.f_cols.cpu().numpy()[valids].tolist()))
    b = plan.block_size
    n_steps = int(plan.valids.shape[0])
    nbytes = (
        len(set(tids.tolist())) * b * b * 4
        + len(fblocks) * plan.q_pad * b * 4
        + plan.n_states * plan.q_pad * plan.v_pad * 4
        + (6 * n_steps + plan.run_ptr.shape[0]) * 4
    )
    flops = 2 * plan.q_pad * b * b * int(valids.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


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


def trace_query(placement, ca, starts, staged, dev) -> dict:
    """One query's per-call set-up timed apart from its run, and the run
    traced with ``torch.profiler``: device busy time (the union of the
    device events' intervals), its share of the traced wall time, and the
    device time and count of each kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = strategies.make_s2_step_fn(
        ca, placement.graph.n_nodes, backend="frontier_kernel", graph=placement.graph,
        replication_factor=placement.replication_factor, staged=staged, device=dev,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full record as JSON to this file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's bmm in full f32
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
    for name in _build.SOURCES:
        _build.load(name)
        info = _build.BUILD_LOG[name]
        took = "cached" if info["seconds"] is None else f"nvcc {info['seconds']:.2f} s"
        log("build", f"{name}: {took}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"  {line.strip()}")
    record["build"] = _build.BUILD_LOG

    # ---- setup: the twin, its placement, the whole Stage-A store ----------
    t0 = time.perf_counter()
    g = alibaba_like(seed=SEED)
    placement = distribute(g, n_sites=256, replication_rate=0.2, seed=SEED)
    log("setup", f"twin: {g.n_nodes} nodes, {g.n_edges} edges, {g.n_labels} labels; "
        f"256 sites, K = {placement.replication_factor:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    staged = fops.stage_graph(g, block_size=128, device=dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    n_tiles = int(staged.tiles.shape[0])
    log("setup", f"Stage A: {n_tiles} f32 tiles of 128x128, {staged.tile_store_bytes / 1e9:.3f} GB "
        f"= {100 * staged.tile_store_bytes / total_mem:.2f}% of device memory ({stage_s:.1f} s)")
    record["setup"] = {"tiles": n_tiles, "bytes": staged.tile_store_bytes, "device_bytes": total_mem,
                       "stage_s": stage_s}
    cas = {q: paa.compile_query(TABLE2_QUERIES[q], g) for q in QUERIES}

    # ---- kernels: the CUDA fused level against its plain version ----------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)  # 64 MB > L2
    case_b_graph = sparse_label_graph()
    case_c_graph = random_labeled_graph(300, 500, 3, seed=11)
    cases = {
        "a: q1, full scale": fops.build_level_schedule(cas["q1"], staged),
        "b: block 16, empty store, wildcard, inverse": fops.build_level_plan(
            paa.compile_query("(l0|l2)+ .^-1 l3^-1", case_b_graph), case_b_graph,
            block_size=16, device=dev,
        ),
        "c: cover-only output blocks": fops.build_level_plan(
            paa.compile_query("l0 l1", case_c_graph), case_c_graph, block_size=32, device=dev,
        ),
    }
    max_err = 0.0
    for label, plan in cases.items():
        valids = plan.valids.cpu().numpy()
        ptr = plan.run_ptr.cpu().numpy()
        cover_only = int(sum(valids[lo:hi].sum() == 0 for lo, hi in zip(ptr[:-1], ptr[1:])))
        f = random_frontier(plan, gen)
        got = fkernel.fused_level_blocks(
            *level_args(plan, f), n_out_rows=plan.n_states * plan.q_pad, run_ptr=plan.run_ptr
        )
        want = fkernel.fused_level_blocks_plain(
            *level_args(plan, f), n_out_rows=plan.n_states * plan.q_pad
        )
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"fused_level_blocks != plain on case {label}: max |diff| {err}")
        log("kernels", f"fused_level_blocks == plain on case {label}: {plan.n_states} states, "
            f"B={plan.block_size}, {len(valids)} steps ({int(valids.sum())} with a tile), "
            f"{cover_only} of {len(ptr) - 1} output blocks cover-only")
    if cover_only == 0:
        raise AssertionError("case c has no cover-only output block")

    # time one level of each query's plan; the kernel line reports q1's
    level_times = {}
    for q in QUERIES:
        plan = cases["a: q1, full scale"] if q == "q1" else fops.build_level_schedule(cas[q], staged)
        f = random_frontier(plan, gen)
        kw = {"n_out_rows": plan.n_states * plan.q_pad}

        def kernel_level(plan=plan, f=f, kw=kw):
            return fkernel.fused_level_blocks(*level_args(plan, f), **kw, run_ptr=plan.run_ptr)

        def plain_level(plan=plan, f=f, kw=kw):
            return fkernel.fused_level_blocks_plain(*level_args(plan, f), **kw)

        bound_ms, bound_by, nbytes, flops = level_bound(plan)
        t = level_times[q] = {
            "ms": graph_ms(kernel_level, 50, flush),
            "warm_ms": graph_ms(kernel_level, 50, None),
            "events_ms": events_ms(kernel_level, 20, flush),
            "plain_ms": events_ms(plain_level, 20, flush),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        }
        log("kernels", f"{q} level: kernel {t['ms'] * 1e3:.2f} us (L2 flushed; {t['warm_ms'] * 1e3:.2f} us warm; "
            f"{t['events_ms'] * 1e3:.2f} us one call between events), "
            f"plain {t['plain_ms'] * 1e3:.2f} us between events, bound {bound_ms * 1e3:.2f} us by {bound_by} "
            f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
    record["level_times"] = level_times

    # ---- path: s2_execute on q1, q9, q12 over all valid starts -------------
    per_query = {}
    fkernel.LAUNCHES = 0
    fops.FIXPOINT_COUNTERS.clear()
    for q in QUERIES:
        ca = cas[q]
        starts = paa.valid_start_nodes(ca, g)
        lev0, sync0, launch0 = (fops.FIXPOINT_COUNTERS["levels"], fops.FIXPOINT_COUNTERS["host_syncs"],
                                fkernel.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers, costs = strategies.s2_execute(
            placement, ca, starts, backend="frontier_kernel", staged=staged, device=dev
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_query[q] = {
            "starts": len(starts),
            "levels": fops.FIXPOINT_COUNTERS["levels"] - lev0,
            "launches": fkernel.LAUNCHES - launch0,
            "host_syncs": fops.FIXPOINT_COUNTERS["host_syncs"] - sync0,
            "wall_ms": wall * 1e3,
            "queries_per_s": len(starts) / wall,
            "answers": answers,
            "costs": costs,
        }
    launches = fkernel.LAUNCHES
    levels = fops.FIXPOINT_COUNTERS["levels"]
    if launches == 0:
        raise AssertionError("the main path launched no fused_level_blocks kernel")
    if launches != levels:
        raise AssertionError(f"{launches} kernel launches for {levels} BFS levels")

    dg = to_device_graph(g, dev)
    index = paa.HostIndex(g)
    rng = np.random.default_rng(SEED)
    for q in QUERIES:
        r = per_query[q]
        ca = cas[q]
        starts = paa.valid_start_nodes(ca, g)
        o_src, o_dst = paa.answers_multi_source(ca, dg, starts)
        bs, vs = np.nonzero(r.pop("answers"))
        got = np.stack([starts[bs], vs]).T
        want = np.stack([o_src, o_dst]).T
        if not np.array_equal(np.unique(got, axis=0), np.unique(want, axis=0)):
            raise AssertionError(f"{q}: answers differ from the device-BFS oracle")
        costs = r.pop("costs")
        for i in rng.choice(len(starts), size=min(N_METER_SAMPLES, len(starts)), replace=False):
            tr = paa.run_instrumented(ca, index, int(starts[i]))
            c = costs[i]
            # unicast symbols went through f32 x K and float64 / K: exact after rounding
            if (c.broadcast_symbols, round(c.unicast_symbols), c.n_broadcasts) != (tr.q_bc, tr.d_s2, tr.n_broadcasts):
                raise AssertionError(f"{q} start {starts[i]}: meters {c} != host {tr}")
        r["pairs"] = int(len(got))
        paper_pairs, paper_starts = TABLE2_PAPER[q]
        log("path", f"{q}: {r['starts']} starts (paper {paper_starts}), {r['pairs']} answer pairs "
            f"(paper {paper_pairs}, for information); {r['levels']} levels, {r['launches']} launches, "
            f"{r['host_syncs']} host syncs, {r['wall_ms']:.1f} ms, {r['queries_per_s']:.1f} queries/s; "
            f"answers == oracle, meters == host meter on {min(N_METER_SAMPLES, len(starts))} starts")
    record["path"] = per_query

    record["trace"] = {}
    for q in QUERIES:
        tr = record["trace"][q] = trace_query(placement, cas[q], paa.valid_start_nodes(cas[q], g),
                                              staged, dev)
        log("trace", f"{q}: set-up {tr['setup_ms']:.1f} ms, run {tr['run_ms']:.1f} ms "
            f"({tr['traced_ms']:.1f} ms traced); device busy {tr['device_busy_ms']:.1f} ms, "
            f"idle share {tr['idle_share']:.4f} of the traced run, "
            f"{tr['idle_share_of_untraced_run']:.4f} of the untraced one")
        for name, k in list(tr["kernels"].items())[:8]:
            log("trace", f"  {k['us'] / 1e3:9.3f} ms {k['count']:6d}x  {name[:90]}")

    kernels = [{
        "name": "fused_level_blocks",
        "route": "cuda",
        "source": "src/repro_torch/kernels/frontier/csrc/fused_level.cu",
        "replaces": "src/repro/kernels/frontier/frontier.py:209",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": level_times["q1"]["ms"],
        "plain_ms": level_times["q1"]["plain_ms"],
        "bound_ms": level_times["q1"]["bound_ms"],
        "bound_by": level_times["q1"]["bound_by"],
        "library_ms": None,
    }]
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
