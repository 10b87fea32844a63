"""`repro_torch.serve.aio` — the async multi-tenant serving runtime.

Port of ``repro/serve/aio.py``.  The flush worker thread runs the CUDA
work: the kernels' first load is thread-safe
(:func:`repro_torch.kernels._build.load`), and the process-wide launch
and fixpoint counters are read only after a flush has ended.

The sync :class:`~repro_torch.serve.service.QueryService` is one caller, one
flush loop: whoever calls ``flush()`` decides when batches form, and an
overloaded queue is the caller's problem.  The paper's setting —
autonomous sites serving RPQs to many independent clients — needs the
opposite: arrivals are open-loop, tenants are mutually untrusted, and
tail latency under sustained offered load (not single-query cost) is
what admission and batching must manage.  This module wraps one
``QueryService`` in an asyncio runtime with three mechanisms:

**SLO-aware admission.**  Every request names a tenant and an SLO class
(``"latency"`` or ``"throughput"``).  Tenants pass a token bucket
(refill rate + burst, per tenant); classes map to separate admission
queues with bounded depth.  Both bounds reject *explicitly* — an
:class:`AdmissionRejected` carrying ``retry_after_s`` — instead of
queueing unboundedly, so overload shows up as a rising rejection rate
while the latency of accepted work stays bounded by the window.  A
request can carry a timeout and can be cancelled: work not yet
transferred to a batch is dropped before it costs anything; work
already riding a batch completes but its answer is discarded.

**Adaptive batching windows.**  Admitted requests are planned
immediately (:meth:`QueryService.plan_request` — plan-cache-hit cheap
for hot query classes) and routed to a *lane* keyed by (SLO class,
strategy, automaton signature).  A lane flushes on whichever trigger
fires first: its **fill** target (enough starts to fill one padded
executor call — waiting longer buys no amortization) or its **window
deadline**, set when the lane opens to ``window_gain ×`` the lane's
predicted execution time, clamped to per-class bounds.  The prediction
chains the §4 cost-model forecast (``Ticket.forecast_symbols``, already
EWMA-calibrated per label class by the serve feedback loop) through an
observed seconds-per-symbol EWMA, then an EWMA of the lane's own
measured batch times takes over.  Cheap S1 streams therefore flush
almost immediately while S2 fixpoints hold their window open long
enough to batch — per signature, not one global knob.

**One flush worker.**  Execution runs ``QueryService.flush()`` on a
single worker thread (``run_in_executor``), so the event loop keeps
admitting, cancelling, and timing requests while the device executes; the
service's flush lock makes the worker/loop interleaving safe.  Answers
are bit-identical to the sync path — the async layer only decides
*when* the same flush pipeline runs.

Metrics land in the stable ``aio`` block of the service summary
(:mod:`repro_torch.serve.metrics`): per-class queue depth, admission
accept/reject counters, window fill accounting, and fixed-bucket
latency histograms that p50/p99/p999 derive from without keeping
samples.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.serve import batcher
from repro_torch.serve import metrics as metrics_mod
from repro_torch.serve.metrics import SLO_CLASSES, LatencyHistogram
from repro_torch.serve.service import (
    Answers,
    QueryService,
    ServiceOverloaded,
    Ticket,
    batch_multiple,
)


class AdmissionRejected(ServiceOverloaded):
    """Explicit backpressure: the request was NOT admitted.

    ``reason`` is ``"rate_limited"`` (tenant token bucket empty) or
    ``"queue_full"`` (the SLO class's admission queue is at depth);
    ``retry_after_s`` is the server's estimate of when capacity frees.
    """

    def __init__(self, reason: str, retry_after_s: float, detail: str = ""):
        super().__init__(detail or f"{reason} (retry after {retry_after_s:.3f}s)")
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class AioConfig:
    """Knobs of the async runtime (the underlying batch/executor config
    stays on :class:`~repro_torch.serve.service.ServeConfig`)."""

    # -- admission ----------------------------------------------------------
    # per-SLO-class admission queue depth (requests queued in lanes,
    # not yet handed to a flush); latency-sensitive work keeps a
    # shallow queue so its wait is bounded, throughput work queues deeper
    queue_depth: dict[str, int] = dataclasses.field(
        default_factory=lambda: {"latency": 64, "throughput": 256}
    )
    # default per-tenant token bucket (qps refill, burst capacity);
    # tenant_rates overrides per tenant name
    tenant_rate_qps: float = 1000.0
    tenant_burst: float = 100.0
    tenant_rates: dict[str, tuple[float, float]] = dataclasses.field(default_factory=dict)
    # floor for retry-after hints when no lane deadline informs one
    min_retry_after_s: float = 0.01

    # -- batching windows ---------------------------------------------------
    # window ≈ window_gain × predicted lane execution seconds, clamped
    # to [min_window_s, max_window_s[slo]]
    window_gain: float = 0.5
    min_window_s: float = 0.001
    max_window_s: dict[str, float] = dataclasses.field(
        default_factory=lambda: {"latency": 0.025, "throughput": 0.25}
    )
    # EWMA steps for the observed secs-per-symbol and per-lane batch
    # execution time (0 = frozen, 1 = last observation wins)
    ewma_decay: float = 0.3
    # bootstrap cost scale before the first observed flush
    default_secs_per_symbol: float = 1e-6
    # S1 lanes fill by request count (S2 lanes by executor batch fill)
    s1_lane_fill: int = 16

    # -- timeouts -----------------------------------------------------------
    default_timeout_s: float | None = None


class TokenBucket:
    """Classic token bucket; ``try_take`` returns (admitted, retry_after_s)."""

    def __init__(self, rate_qps: float, burst: float, clock: Callable[[], float]):
        self.rate = float(rate_qps)
        self.burst = float(burst)
        self.level = float(burst)
        self._clock = clock
        self._t = clock()

    def try_take(self) -> tuple[bool, float]:
        now = self._clock()
        self.level = min(self.burst, self.level + (now - self._t) * self.rate)
        self._t = now
        if self.level >= 1.0:
            self.level -= 1.0
            return True, 0.0
        if self.rate <= 0:
            return False, float("inf")
        return False, (1.0 - self.level) / self.rate


@dataclasses.dataclass
class _Pending:
    """One admitted request waiting in (or riding out of) a lane."""

    ticket: Ticket
    tenant: str
    slo: str
    future: asyncio.Future
    t_admit: float
    lane_key: tuple
    in_batch: bool = False


@dataclasses.dataclass
class _Lane:
    """A per-(SLO, strategy, signature) batching lane."""

    key: tuple
    slo: str
    reqs: list[_Pending]
    opened_at: float
    deadline: float
    window_s: float
    fill_target: int
    n_starts: int = 0
    forecast_symbols: float = 0.0

    @property
    def fill_ready(self) -> bool:
        return self.n_starts >= self.fill_target


class AsyncQueryService:
    """Asyncio front end over one :class:`QueryService` (see the module
    docstring for the admission → window → flush dataflow).

    Use as an async context manager, or call :meth:`start` / await
    :meth:`stop` explicitly.  ``clock`` is injectable for tests."""

    def __init__(
        self,
        service: QueryService,
        config: AioConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.service = service
        self.config = config or AioConfig()
        self._clock = clock
        self._lanes: dict[tuple, _Lane] = {}
        self._depth: dict[str, int] = {c: 0 for c in SLO_CLASSES}
        self._buckets: dict[str, TokenBucket] = {}
        # cost chain: lane-key → EWMA of measured batch exec seconds;
        # bootstrap via forecast_symbols × secs-per-symbol EWMA
        self._lane_exec_s: dict[tuple, float] = {}
        self._secs_per_symbol = self.config.default_secs_per_symbol
        # S2 lanes fill one padded executor call: the service's batch multiple
        cfg = service.config
        self._s2_fill = batcher.lane_fill_target(cfg.max_batch, batch_multiple(cfg.s2_backend))
        # metrics state (exported as the stable `aio` summary block)
        self._admission = {c: metrics_mod._empty_admission_stats() for c in SLO_CLASSES}
        self._hists = {c: LatencyHistogram() for c in SLO_CLASSES}
        self._flushes = 0
        self._lanes_flushed = 0
        self._deadline_flushes = 0
        self._fill_flushes = 0
        self._fill_num = 0.0
        self._fill_den = 0.0
        self._recent_windows: list[float] = []
        # runtime plumbing
        self._wake: asyncio.Event | None = None
        self._flusher: asyncio.Task | None = None
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None
        self._stopping = False

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        if self._flusher is not None:
            raise RuntimeError("AsyncQueryService already started")
        self._stopping = False
        self._wake = asyncio.Event()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-serve-flush"
        )
        self._flusher = asyncio.get_running_loop().create_task(self._flush_loop())

    async def stop(self) -> None:
        """Drain every open lane, then stop the flusher and worker."""
        if self._flusher is None:
            return
        self._stopping = True
        self._wake.set()
        await self._flusher
        self._flusher = None
        self._executor.shutdown(wait=True)
        self._executor = None
        self._push_metrics()

    async def __aenter__(self) -> "AsyncQueryService":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- admission -----------------------------------------------------------

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            rate, burst = self.config.tenant_rates.get(
                tenant, (self.config.tenant_rate_qps, self.config.tenant_burst)
            )
            b = self._buckets[tenant] = TokenBucket(rate, burst, self._clock)
        return b

    def _retry_after(self, now: float) -> float:
        """How long until queued work plausibly drains: the earliest
        lane deadline, floored at the configured minimum."""
        if self._lanes:
            soonest = min(l.deadline for l in self._lanes.values())
            return max(soonest - now, self.config.min_retry_after_s)
        return self.config.min_retry_after_s

    async def submit(
        self,
        query: str,
        start_nodes,
        tenant: str = "default",
        slo: str = "latency",
        strategy: str | None = None,
        timeout_s: float | None = None,
        semantics: str | None = None,
    ) -> Answers:
        """Admit one request and await its answers.

        ``semantics="witness"`` makes this an ``answers_with_witness``
        request: the resolved :class:`Answers` carries discovery-level
        planes for :meth:`QueryService.witness_path`.  Witness requests
        ride their own batching lanes — the semantics folds into the
        automaton signature, so pairs batches never pay the witness
        carry.

        Raises :class:`AdmissionRejected` when the tenant's token bucket
        or the SLO class's queue bound rejects it, ``ValueError`` on
        malformed queries (checked before any queueing), and
        ``asyncio.TimeoutError`` after ``timeout_s`` (the request is
        dropped before batching if still queued)."""
        if self._flusher is None or self._stopping:
            raise RuntimeError("AsyncQueryService is not running — call start()")
        if slo not in SLO_CLASSES:
            raise ValueError(f"slo must be one of {SLO_CLASSES}, got {slo!r}")
        now = self._clock()
        ok, retry = self._bucket(tenant).try_take()
        if not ok:
            self._admission[slo]["rejected_rate_limited"] += 1
            raise AdmissionRejected("rate_limited", retry)
        if self._depth[slo] >= self.config.queue_depth[slo]:
            self._admission[slo]["rejected_queue_full"] += 1
            raise AdmissionRejected("queue_full", self._retry_after(now))
        # plan at admission: hot classes are a plan-cache hit; the
        # signature + cost forecast route and size the lane
        ticket = self.service.plan_request(query, start_nodes, strategy, semantics)
        pending = _Pending(
            ticket=ticket,
            tenant=tenant,
            slo=slo,
            future=asyncio.get_running_loop().create_future(),
            t_admit=now,
            lane_key=self._lane_key(ticket, slo),
        )
        self._admission[slo]["accepted"] += 1
        self._depth[slo] += 1
        self._route(pending, now)
        timeout_s = timeout_s if timeout_s is not None else self.config.default_timeout_s
        try:
            if timeout_s is not None:
                return await asyncio.wait_for(pending.future, timeout_s)
            return await pending.future
        except asyncio.TimeoutError:
            self._admission[slo]["timed_out"] += 1
            raise

    def _lane_key(self, ticket: Ticket, slo: str) -> tuple:
        if ticket.strategy == "S2":
            return (slo, "S2", ticket.sig)
        return (slo, "S1")  # S1 requests coalesce by union mask at flush

    def _route(self, pending: _Pending, now: float) -> None:
        lane = self._lanes.get(pending.lane_key)
        if lane is None:
            window = self._window_s(pending)
            lane = _Lane(
                key=pending.lane_key,
                slo=pending.slo,
                reqs=[],
                opened_at=now,
                deadline=now + window,
                window_s=window,
                fill_target=(
                    self._s2_fill
                    if pending.ticket.strategy == "S2"
                    else self.config.s1_lane_fill
                ),
            )
            self._lanes[pending.lane_key] = lane
            self._recent_windows.append(window)
            if len(self._recent_windows) > 256:
                del self._recent_windows[:128]
        lane.reqs.append(pending)
        lane.n_starts += (
            len(pending.ticket.starts) if pending.ticket.strategy == "S2" else 1
        )
        lane.forecast_symbols += pending.ticket.forecast_symbols
        # wake the flusher: the lane may have just filled, and even a
        # partial arrival can carry an earlier deadline than the one the
        # flusher is currently sleeping toward
        self._wake.set()

    def _window_s(self, pending: _Pending) -> float:
        """Latency-bounded window for the lane this request opens: a
        fraction of the predicted execution time, so batching never
        costs more than it amortizes."""
        est = self._lane_exec_s.get(pending.lane_key)
        if est is None:
            est = pending.ticket.forecast_symbols * self._secs_per_symbol
        w = self.config.window_gain * est
        return float(
            np.clip(w, self.config.min_window_s, self.config.max_window_s[pending.slo])
        )

    # -- the flush loop ------------------------------------------------------

    async def _flush_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            now = self._clock()
            due = [
                lane
                for lane in self._lanes.values()
                if self._stopping or lane.fill_ready or lane.deadline <= now
            ]
            if due:
                for lane in due:
                    del self._lanes[lane.key]
                    if lane.fill_ready:
                        self._fill_flushes += 1
                    else:
                        self._deadline_flushes += 1
                await self._execute(loop, due)
                continue
            if self._stopping:
                break
            self._wake.clear()
            # woken by arrivals/stop, or timed out at the next deadline
            timeout = None
            if self._lanes:
                timeout = max(
                    min(l.deadline for l in self._lanes.values()) - self._clock(),
                    0.0,
                )
            try:
                await asyncio.wait_for(self._wake.wait(), timeout)
            except asyncio.TimeoutError:
                pass

    async def _execute(self, loop: asyncio.AbstractEventLoop, lanes: list[_Lane]) -> None:
        """Transfer the due lanes' live requests into the service queue,
        run one flush on the worker thread, resolve futures."""
        batch: list[_Pending] = []
        forecast = 0.0
        for lane in lanes:
            self._lanes_flushed += 1
            self._fill_num += min(lane.n_starts, lane.fill_target)
            self._fill_den += lane.fill_target
            for p in lane.reqs:
                if p.future.done():  # cancelled/timed out while queued:
                    # dropped before it ever reaches a batch
                    self._admission[p.slo]["cancelled_before_batch"] += 1
                    self._depth[p.slo] -= 1
                    continue
                try:
                    self.service.enqueue_planned(p.ticket)
                except ServiceOverloaded as e:
                    # the service's own max_pending bound (normally far
                    # deeper than the SLO queues): reject late, honestly
                    self._depth[p.slo] -= 1
                    self._admission[p.slo]["rejected_queue_full"] += 1
                    p.future.set_exception(
                        AdmissionRejected("queue_full", self.config.min_retry_after_s, str(e))
                    )
                    continue
                p.in_batch = True
                forecast += p.ticket.forecast_symbols
                batch.append(p)
        if not batch:
            return
        self._flushes += 1
        t0 = self._clock()
        try:
            await loop.run_in_executor(self._executor, self.service.flush)
            flush_err: Exception | None = None
        except Exception as e:  # noqa: BLE001 — fail this batch, keep serving
            flush_err = e
        exec_s = self._clock() - t0
        self._observe_exec(lanes, forecast, exec_s)
        now = self._clock()
        for p in batch:
            self._depth[p.slo] -= 1
            if p.future.done():  # cancelled while the batch executed:
                # the work completed but the answer is discarded
                self._admission[p.slo]["cancelled_mid_batch"] += 1
                continue
            t = p.ticket
            if flush_err is not None and not t.done:
                p.future.set_exception(flush_err)
                self._admission[p.slo]["failed"] += 1
            elif t.error is not None or not t.done:
                p.future.set_exception(
                    t.error if t.error is not None else RuntimeError("ticket unresolved")
                )
                self._admission[p.slo]["failed"] += 1
            else:
                p.future.set_result(t.result())
                self._admission[p.slo]["completed"] += 1
                self._hists[p.slo].observe(now - p.t_admit)
        self._push_metrics()

    def _observe_exec(self, lanes: list[_Lane], forecast: float, exec_s: float) -> None:
        """Fold one measured flush back into the window-sizing EWMAs:
        global secs-per-symbol, and each lane's own batch time
        (attributed by its share of the forecast)."""
        a = self.config.ewma_decay
        if forecast > 0:
            sps = exec_s / forecast
            self._secs_per_symbol = (1 - a) * self._secs_per_symbol + a * sps
        live = [l for l in lanes if l.forecast_symbols > 0]
        total = sum(l.forecast_symbols for l in live)
        for lane in live:
            share = lane.forecast_symbols / total if total > 0 else 1.0 / len(live)
            obs = exec_s * share
            prev = self._lane_exec_s.get(lane.key)
            self._lane_exec_s[lane.key] = (
                obs if prev is None else (1 - a) * prev + a * obs
            )

    # -- reporting -----------------------------------------------------------

    def aio_stats(self) -> dict:
        """The stable ``aio`` metrics block (same schema as the zeroed
        placeholder in :mod:`repro_torch.serve.metrics`)."""
        return {
            "queue_depth": dict(self._depth),
            "admission": {c: dict(v) for c, v in self._admission.items()},
            "batch_window": {
                "flushes": self._flushes,
                "lanes_flushed": self._lanes_flushed,
                "fill_ratio": self._fill_num / self._fill_den if self._fill_den else 0.0,
                "deadline_flushes": self._deadline_flushes,
                "fill_flushes": self._fill_flushes,
                "window_s_p50": (
                    float(np.median(self._recent_windows)) if self._recent_windows else 0.0
                ),
            },
            "latency_hist": {c: h.to_dict() for c, h in self._hists.items()},
        }

    def _push_metrics(self) -> None:
        self.service.metrics.set_aio_stats(self.aio_stats())

    def summary(self) -> dict:
        self._push_metrics()
        return self.service.summary()
