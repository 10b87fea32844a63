"""One run of one cell: set-up, the measured window, the check.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``rpqbench/configs/<config>.json``, named by its entry in
``configs``) under a traffic mix (``rpqbench/traffic/<traffic>.json``),
whose request source and client loop are ``rpqbench/sources/<source>.py``
and ``rpqbench/clients/<client>.py`` (:mod:`rpqbench.traffic`).  Its
metrics are the entries of ``end_to_end`` and ``per_layer`` that list it
(``workloads``; a per-layer metric without that key goes to every cell
that reports the end-to-end metric it ``moves``); each per-layer metric
is read by ``rpqbench/metrics/<name>.py``.  Every one of these is found
by its name; nothing here names a cell, a configuration, a mix, a source
or a client.

A run: the inputs from the frozen generators (:mod:`rpqbench.data`); the
port's ``QueryService`` on them through its public constructors; the
mix's warm-up through the client; then the client's measured window of
``seconds``; then the device's peak memory, the program's state freed,
and every answer and meter of the window held to the reference
(:mod:`rpqbench.check`).  The reference's own seconds before the window
(its index, a source's valid starts) are not counted in ``setup_s``.
With ``trace`` the window runs under ``torch.profiler`` with the spans of
:mod:`rpqbench.spans`, and the result carries the per-layer metrics.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from rpqbench import check, trace as tracing, traffic
from rpqbench.data import generators, partition
from rpqbench.data.graph import Graph
from rpqbench.reference import bfs
from rpqbench.spans import Spans

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    source: object  # rpqbench/sources/<source>.py
    client: object  # rpqbench/clients/<client>.py
    end_to_end: list[dict]
    per_layer: list[tuple[dict, object]]  # (entry, its reader module)


def load_module(root: Path, kind: str, name: str):
    """``rpqbench/<kind>/<name>.py`` as a module."""
    path = root / "rpqbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"rpqbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(entry: dict, cell: str, end_to_end: list[dict]) -> bool:
    """Whether metric ``entry`` is reported in ``cell``."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    if "moves" in entry:
        return any(m["name"] == entry["moves"] and reports(m, cell, end_to_end) for m in end_to_end)
    return True


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = found[0]
    (conf,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    e2e = bench["end_to_end"]
    mix = json.loads((root / "rpqbench" / "traffic" / f"{w['traffic']}.json").read_text())
    client = load_module(root, "clients", mix["client"])
    client.check(mix)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        mix=mix,
        source=load_module(root, "sources", mix["source"]),
        client=client,
        end_to_end=[m for m in e2e if reports(m, name, e2e)],
        per_layer=[(m, load_module(root, "metrics", m["name"])) for m in bench["per_layer"] if reports(m, name, e2e)],
    )


class Inputs:
    """The inputs that the benchmark makes from a configuration, handed
    alike to the port and to the reference.  ``index`` and
    ``valid_starts`` are the reference's work, their seconds summed in
    ``reference_s``."""

    def __init__(self, graph: Graph, site_edges: list, replication: np.ndarray,
                 overlay: tuple[np.ndarray, np.ndarray]):
        self.graph, self.site_edges, self.replication, self.overlay = graph, site_edges, replication, overlay
        self.reference_s = 0.0
        self._index: bfs.Index | None = None

    @property
    def index(self) -> bfs.Index:
        if self._index is None:
            t = time.perf_counter()
            g = self.graph
            self._index = bfs.Index(g.n_nodes, g.src, g.lbl, g.dst, g.labels)
            self.reference_s += time.perf_counter() - t
        return self._index

    def valid_starts(self, query: str) -> np.ndarray:
        """The starts from which the reference's BFS of ``query`` reaches
        an answer."""
        index = self.index
        t = time.perf_counter()
        starts = bfs.valid_starts(bfs.compile_query(query, index), index)
        self.reference_s += time.perf_counter() - t
        return starts


def make_inputs(config: dict) -> Inputs:
    g = getattr(generators, config["graph"]["generator"])(**config["graph"]["args"])
    site_edges, replication = partition.distribute(g.n_edges, **config["placement"])
    overlay = partition.random_overlay(config["placement"]["n_sites"], **config["overlay"])
    return Inputs(g, site_edges, replication, overlay)


def start_service(config: dict, inputs: Inputs, device):
    """The port's service on the inputs, through its public constructors."""
    from repro_torch.core import planner
    from repro_torch.graph.partition import OverlayNetwork, Placement
    from repro_torch.graph.structure import LabeledGraph
    from repro_torch.serve import QueryService, ServeConfig

    g = inputs.graph
    placement = Placement(LabeledGraph(g.n_nodes, g.src, g.lbl, g.dst, g.labels),
                          config["placement"]["n_sites"], inputs.site_edges, inputs.replication)
    net = planner.probe_network(OverlayNetwork(placement.n_sites, *inputs.overlay), placement,
                                seed=config["probe_seed"])
    return QueryService(placement, net, config=ServeConfig(**config["serve"]), device=device)


@dataclasses.dataclass
class RunData:
    """What a per-layer metric's reader reads."""

    config: dict
    index: bfs.Index
    seed: int
    device_kind: str
    resolved: int
    latencies_ms: list[float]
    spans: Spans | None = None
    host_syncs: int = 0
    staged_bytes: int = 0
    trace: dict | None = None


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class GcPauses:
    """Seconds the garbage collector held the process, by generation,
    while installed (``gc.callbacks``)."""

    def __init__(self):
        self.s = [0.0, 0.0, 0.0]
        self._t = 0.0
        gc.callbacks.append(self._note)

    def _note(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.s[info["generation"]] += time.perf_counter() - self._t

    def stop(self) -> None:
        gc.callbacks.remove(self._note)


def host_steal_s() -> float:
    """Seconds of all the machine's cores taken by its hypervisor
    (``steal`` in ``/proc/stat``), 0 where that cannot be read."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float) -> tuple[dict, dict]:
    """One run; returns (result line, checks)."""
    import torch

    from repro_torch.core import strategies
    from repro_torch.kernels.frontier import ops as fops
    from repro_torch.serve import batcher

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    parts = {"imports": time.perf_counter() - t_process}
    t = time.perf_counter()
    inputs = make_inputs(cell.config)
    warmup, stream = traffic.requests(cell.mix, cell.source, inputs, seed)
    parts["inputs"], t = time.perf_counter() - t - inputs.reference_s, time.perf_counter()
    svc = start_service(cell.config, inputs, device)
    parts["service"], t = time.perf_counter() - t, time.perf_counter()
    cell.client.warmup(svc, warmup, cell.mix)
    sync()
    parts["warmup"] = time.perf_counter() - t
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; the reference's {inputs.reference_s:.3f} not counted", file=sys.stderr, flush=True)
    staged = sum(svc.plan_store.tile_store_stats()["bytes_by_dtype"].values())
    syncs0 = fops.FIXPOINT_COUNTERS["host_syncs"]
    spans = Spans(svc, strategies, batcher) if trace else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    pauses = GcPauses()
    steal0 = host_steal_s()
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    with torch.profiler.record_function("rpqbench.window"):
        done, flushes = cell.client.drive(svc, stream, cell.mix, seconds, time.perf_counter)
        sync()
    t1 = time.perf_counter()
    cpu_s = time.process_time() - cpu0
    steal_s = host_steal_s() - steal0
    pauses.stop()
    if prof is not None:
        prof.__exit__(None, None, None)
        print(f"profiler stopped in {time.perf_counter() - t1:.1f} s", file=sys.stderr, flush=True)
    if spans is not None:
        spans.stop()
    host_syncs = fops.FIXPOINT_COUNTERS["host_syncs"] - syncs0
    served, latencies, failed, misses = [], [], 0, set()
    for i, (q, s, ticket) in enumerate(done):
        if ticket.error is not None:
            failed += 1
            continue
        a = ticket.result()
        latencies.append(a.latency_s * 1e3)
        if not a.plan_cache_hit:
            misses.add(i)
        served.append(check.from_answers(q, s, a))
    slow_s, lo, n = max(flushes)
    slow = [done[i] for i in range(lo, lo + n)]
    print(f"window: {len(done)} requests in {len(flushes)} flushes, {t1 - t0:.3f} s, "
          f"flush s median {np.median([f[0] for f in flushes]):.3f}; "
          f"strategies {dict(collections.Counter(r.strategy for r in served))}, {len(misses)} plan misses; "
          f"process CPU {cpu_s:.3f} s, steal {steal_s:.2f} s of all cores; "
          f"gc paused {sum(pauses.s):.3f} s (by generation {[round(x, 3) for x in pauses.s]}); "
          f"slowest flush {slow_s:.3f} s: {sum(lo <= i < lo + n for i in misses)} plan misses, "
          f"strategies {dict(collections.Counter(t.strategy for _, _, t in slow))}, "
          f"queries {sorted({q[:60] for q, _, _ in slow})}", file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    del svc, done, slow
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checks = check.judge(served, inputs.index, cell.config["limits"])
    print(f"check: {len(served)} requests against the reference in {time.perf_counter() - t:.1f} s",
          file=sys.stderr, flush=True)
    window_s = t1 - t0
    values = {
        "rpq_per_s": len(served) / window_s,
        "latency_p95_ms": float(np.percentile(latencies, 95)) if latencies else None,
        "setup_s": t0 - t_process - inputs.reference_s,
    }
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": len(served) + failed, "failed": failed}
    if not trace:
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if values.get(m["name"]) is not None}
    else:
        t = time.perf_counter()
        tr = tracing.reduce(prof, spans.intervals, t0) if on_card else None
        shift = f", profiler clock - host clock {tr['clock_shift_s']:.6f} s" if tr else ""
        print(f"trace read in {time.perf_counter() - t:.1f} s{shift}", file=sys.stderr, flush=True)
        data = RunData(cell.config, inputs.index, seed, kind, len(served), latencies, spans,
                       host_syncs, staged, tr)
        metrics = {}
        for entry, reader in cell.per_layer:
            v = reader.read(data)
            if v is not None:
                metrics[entry["name"]] = {"value": float(v), "unit": entry["unit"]}
        result["metrics"] = metrics
        if tr is not None:
            device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            result["breakdown"] = tracing.breakdown(tr)
    result["device"] = device_info
    lat_path = Path(tempfile.gettempdir()) / f"rpqbench-{cell.name}-{seed}-{int(trace)}-latencies.json"
    lat_path.write_text(json.dumps({"window_s": window_s, "latency_ms": latencies}))
    result["correct"] = bool(check.passed(checks) and failed == 0 and served)
    return result, checks
