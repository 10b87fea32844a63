"""Service-level metrics: per-query latency/symbol counters + summary.

Port of ``repro/serve/metrics.py``, verbatim (pure Python and numpy), so
the summary's schema — every key, recursively — is ``repro``'s.

Dumb by design — the service records one :class:`QueryRecord` per request
and :meth:`ServiceMetrics.summary` reduces them into the stable schema
(queries/sec, p50/p95 latency, cache hit rates, per-strategy counts,
symbol totals, plus the two-stage-compilation counters: executor-cache
and plan-store hit/miss rates, the sharded plans' grid-step padding
accounting ``plan_pad_waste``, and the frontier memory-roofline block
``frontier_mem``), pushed by the service via
:meth:`ServiceMetrics.set_cache_stats` each flush; all four are zeroed
placeholders with the full key sets before the first flush.

The async runtime adds one more stable block, ``aio`` (queue depth and
admission accept/reject counters per SLO class, batch-window fill
accounting, and a fixed-bucket :class:`LatencyHistogram` per class so
p50/p99/p999 derive from counts without post-processing), pushed via
:meth:`ServiceMetrics.set_aio_stats` and zero-initialized with the full
key set for sync-only services.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class QueryRecord:
    query: str
    strategy: str
    latency_s: float
    n_starts: int
    broadcast_symbols: float
    unicast_symbols: float
    plan_cache_hit: bool
    exec_batch_size: int  # padded batch the request rode in (S2), or 1
    semantics: str = "pairs"  # "pairs" | "witness" (answers_with_witness)


# the async runtime's SLO classes (see repro_torch.serve.aio): latency-
# sensitive requests ride a short-window, shallow queue; throughput
# requests amortize in bigger batches behind a deeper one
SLO_CLASSES = ("latency", "throughput")

# fixed upper bucket edges (ms) of the latency histogram — log-spaced so
# p50/p99/p999 derive from the counts alone, stable so dashboards
# never see a schema change when traffic does
LATENCY_BUCKET_EDGES_MS = (
    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
    500.0, 1000.0, 2000.0, 5000.0, 10000.0,
)


class LatencyHistogram:
    """Fixed-bucket latency histogram: O(1) per observation, percentiles
    by cumulative-count walk with linear interpolation inside the bucket
    — no per-request sample list to post-process.  The last bucket is an
    unbounded overflow; its percentile reports the last finite edge."""

    def __init__(self, edges_ms: tuple[float, ...] = LATENCY_BUCKET_EDGES_MS):
        self.edges_ms = tuple(float(e) for e in edges_ms)
        self.counts = np.zeros(len(self.edges_ms) + 1, np.int64)

    def observe(self, latency_s: float) -> None:
        ms = latency_s * 1e3
        idx = int(np.searchsorted(self.edges_ms, ms, side="left"))
        self.counts[idx] += 1

    @property
    def n(self) -> int:
        return int(self.counts.sum())

    def percentile(self, q: float) -> float:
        """The q-quantile in ms, interpolated within its bucket."""
        n = self.n
        if n == 0:
            return 0.0
        rank = q * n
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.edges_ms[i - 1] if i > 0 else 0.0
                hi = self.edges_ms[i] if i < len(self.edges_ms) else self.edges_ms[-1]
                frac = (rank - cum) / c
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            cum += c
        return float(self.edges_ms[-1])

    def to_dict(self) -> dict:
        return {
            "bucket_upper_ms": list(self.edges_ms),
            "counts": self.counts.tolist(),
            "n": self.n,
            "p50_ms": self.percentile(0.50),
            "p99_ms": self.percentile(0.99),
            "p999_ms": self.percentile(0.999),
        }


def _empty_admission_stats() -> dict:
    return {
        "accepted": 0,
        "rejected_rate_limited": 0,
        "rejected_queue_full": 0,
        "completed": 0,
        "failed": 0,
        "cancelled_before_batch": 0,
        "cancelled_mid_batch": 0,
        "timed_out": 0,
    }


def _empty_aio_stats() -> dict:
    # the async runtime's STABLE summary block (zero-initialized before
    # the first event, pushed live by AsyncQueryService): queue depth
    # per SLO class, admission accept/reject counters per class, the
    # batching-window accounting, and the fixed-bucket latency
    # histograms p50/p99/p999 derive from
    return {
        "queue_depth": {c: 0 for c in SLO_CLASSES},
        "admission": {c: _empty_admission_stats() for c in SLO_CLASSES},
        "batch_window": {
            "flushes": 0,
            "lanes_flushed": 0,
            "fill_ratio": 0.0,
            "deadline_flushes": 0,
            "fill_flushes": 0,
            "window_s_p50": 0.0,
        },
        "latency_hist": {c: LatencyHistogram().to_dict() for c in SLO_CLASSES},
    }


def _empty_exec_cache_stats() -> dict:
    return {"size": 0, "graphs": 0, "hits": 0, "misses": 0, "hit_rate": 0.0,
            "builds": 0, "releases": 0}


def _empty_plan_store_stats() -> dict:
    return {"size": 0, "hits": 0, "misses": 0, "hit_rate": 0.0, "evictions": 0}


def _empty_pad_waste_stats() -> dict:
    # GraphPlanStore.pad_stats() key set: grid-step padding accounting
    # over every sharded plan built against the store, plus per-bucket
    # executed-step counters keyed "<n_steps>x<n_tiles>"
    return {"useful_steps": 0, "padded_steps": 0, "pad_waste_ratio": 0.0,
            "bucket_grid_steps": {}}


def _empty_frontier_mem_stats() -> dict:
    # frontier memory roofline block (ExecutorCache.frontier_mem_stats()
    # + the plan store's chunked Stage-A counter): per-dtype executor
    # counts, frontier bytes one fixpoint chunk carries per cached
    # executor ("f32" = frontier_kernel/_sharded rows, "packed" =
    # frontier_kernel_packed lane words — same bytes, 32x the lanes),
    # query-lane capacity per chunk, how many edge slices chunked
    # Stage-A staging has consumed, and the staged *tile-store* block
    # (GraphPlanStore.tile_store_stats(): bytes per tile dtype across
    # every live Stage-A entry — the dominant tensor — plus the
    # out-of-core slab counters: resident/spilled slab counts and the
    # cumulative spill/reload events)
    return {
        "executors": {"f32": 0, "packed": 0},
        "frontier_bytes": {"f32": 0, "packed": 0},
        "lane_capacity": {"f32": 0, "packed": 0},
        "bytes_per_lane": {"f32": 0.0, "packed": 0.0},
        "staging_chunks": 0,
        "tile_store": {
            "bytes_by_dtype": {"f32": 0, "uint32": 0},
            "slabs_resident": 0,
            "slabs_spilled": 0,
            "spills": 0,
            "reloads": 0,
        },
    }


class ServiceMetrics:
    def __init__(self) -> None:
        self.records: list[QueryRecord] = []
        self._t0: float | None = None
        self._t_last: float | None = None
        # executor-cache / plan-store counters: part of the STABLE summary
        # schema — the zeroed placeholders carry the full key sets of
        # ExecutorCache.stats() / GraphPlanStore.stats(), so consumers see
        # one schema whether or not the service has pushed real numbers
        # via set_cache_stats yet
        self._cache_stats: dict[str, dict] = {
            "exec_cache": _empty_exec_cache_stats(),
            "plan_store": _empty_plan_store_stats(),
            "plan_pad_waste": _empty_pad_waste_stats(),
            "frontier_mem": _empty_frontier_mem_stats(),
        }
        # async-runtime block: zeroed full-schema placeholder until an
        # AsyncQueryService pushes live numbers via set_aio_stats
        self._aio_stats: dict = _empty_aio_stats()

    def set_aio_stats(self, aio: dict) -> None:
        """Install the async runtime's admission/window/histogram block
        (pushed by ``AsyncQueryService`` after every flush cycle, same
        stable schema as the zeroed placeholder)."""
        self._aio_stats = dict(aio)

    def set_cache_stats(
        self,
        exec_cache: dict | None = None,
        plan_store: dict | None = None,
        plan_pad_waste: dict | None = None,
        frontier_mem: dict | None = None,
    ) -> None:
        """Install the current executor-cache / plan-store hit/miss
        counters, the sharded plans' grid-step padding accounting, and
        the frontier memory-roofline block (the service pushes these
        every flush, so summaries and the throughput benchmark see live
        two-stage-compilation rates)."""
        if exec_cache is not None:
            self._cache_stats["exec_cache"] = dict(exec_cache)
        if plan_store is not None:
            self._cache_stats["plan_store"] = dict(plan_store)
        if plan_pad_waste is not None:
            self._cache_stats["plan_pad_waste"] = dict(plan_pad_waste)
        if frontier_mem is not None:
            self._cache_stats["frontier_mem"] = dict(frontier_mem)

    def record(self, rec: QueryRecord) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now - rec.latency_s  # include the first query's service time
        self._t_last = now
        self.records.append(rec)

    @property
    def wall_s(self) -> float:
        if self._t0 is None or self._t_last is None:
            return 0.0
        return max(self._t_last - self._t0, 1e-9)

    def summary(self, extra: dict | None = None) -> dict:
        lat = np.array([r.latency_s for r in self.records], float)
        strategies: dict[str, int] = {}
        for r in self.records:
            strategies[r.strategy] = strategies.get(r.strategy, 0) + 1
        n = len(self.records)
        out = {
            "n_queries": n,
            "wall_s": self.wall_s,
            "queries_per_sec": n / self.wall_s if n else 0.0,
            "p50_latency_s": float(np.percentile(lat, 50)) if n else 0.0,
            "p95_latency_s": float(np.percentile(lat, 95)) if n else 0.0,
            "plan_cache_hit_rate": (
                sum(r.plan_cache_hit for r in self.records) / n if n else 0.0
            ),
            "total_broadcast_symbols": float(sum(r.broadcast_symbols for r in self.records)),
            "total_unicast_symbols": float(sum(r.unicast_symbols for r in self.records)),
            "strategies": strategies,
            "exec_cache": dict(self._cache_stats["exec_cache"]),
            "plan_store": dict(self._cache_stats["plan_store"]),
            "plan_pad_waste": dict(self._cache_stats["plan_pad_waste"]),
            "frontier_mem": dict(self._cache_stats["frontier_mem"]),
            "aio": dict(self._aio_stats),
        }
        if extra:
            out.update(extra)
        return out

    def to_json(self, path: str, extra: dict | None = None) -> dict:
        s = self.summary(extra)
        with open(path, "w") as f:
            json.dump(s, f, indent=2, sort_keys=True)
        return s
