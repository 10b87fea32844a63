"""`QueryService` — the continuous-batching RPQ serving runtime.

Port of ``repro/serve/service.py``.  The constructor takes ``device``
(``None``: the GPU) and, as ``repro``'s does, a ``mesh``: ``None`` is
one card, where ``axis_size`` (the sharded backend's site groups, the
product of ``repro``'s site-axis sizes) stands in for the mesh; a
``torch.distributed`` ``DeviceMesh`` of ranks runs the service as one
process per rank (below).  ``ServeConfig`` keeps ``repro``'s fields and
defaults.  Every S2 backend of ``repro`` serves: the default
``"reference"`` (plain torch on the padded site arrays, no kernel),
``frontier_kernel`` (kernel B1 on f32 tiles, B3 on uint32),
``frontier_kernel_packed`` (B2, B4) and ``frontier_kernel_sharded`` (B1
or B3 once per shape bucket and level).  On a CUDA device every level
launches its kernel or raises: a failed build fails the tickets of its
group, with no fallback to the plain versions.

**Over ranks.**  ``repro`` is one controller driving every device; the
port runs one process per rank, and every rank must enter the same
collectives in the same order.  Rank 0 of the mesh leads: it alone
admits, plans and batches, and each flush first broadcasts a *flush
order* (:func:`~repro_torch.dist.collectives.broadcast_bytes`): every
planned request's query, starts, semantics, strategy, executed level cap
and signature digest, in queue order.  The other ranks follow
(:meth:`QueryService.follow`, or one :meth:`~QueryService.flush` per
order): they plan the same requests with the strategy forced, check the
level cap and signature, and run the same flush, so they form the same
signature groups and S1 windows and call the same collectives.  The
leader does not let followers plan for themselves because the §5
rollouts are estimates: a near tie rounded otherwise on one rank would
send it to S1 while the others enter S2's collectives.  The calibrator
observes the gathered costs, the same on every rank.  Each group's
build, each executor call and each S1 gather ends in an
:func:`~repro_torch.dist.collectives.agree` on an error flag, so a group
that raised on any rank fails on every rank (:class:`RankFailure`
carries the raising rank's message elsewhere) and serving goes on; a
rank that raised inside a collective of its own leaves the others
waiting, which the process group's timeout ends.  Each rank stages and
snapshots only its share of the per-site artifacts
(:meth:`~QueryService.save_plan_store`).

One request's life (all in :meth:`QueryService.flush`):

1. **admit** — :meth:`enqueue` appends to a bounded admission queue
   (:class:`ServiceOverloaded` when full) and hands back a
   :class:`Ticket`.
2. **plan** — the query is normalized (α-equivalent forms share a key)
   and looked up in the plan cache; on a miss the §5 rollout estimation
   runs once and is cached for the (query class, stats epoch).  The §6
   decision itself — discriminant at the decision quantile — is re-run
   per request with the calibrator's current per-label-class factors, so
   cached estimates still see fresh feedback.
3. **batch + execute** — S2 requests sharing an automaton signature ride
   one batched executor call, padded to whole query stacks (8 f32 rows
   or 256 packed lanes); S1 requests coalesce under a union label mask
   into a single gather.
4. **feed back** — each execution's observed
   :class:`~repro_torch.core.strategies.StrategyCost` updates the
   calibrator, and a :class:`~repro_torch.serve.metrics.QueryRecord`
   lands in the metrics.

:meth:`submit` is the one-call convenience (enqueue + flush); throughput
callers enqueue a window of requests and flush once.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import contextlib
import hashlib
import json

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core import paa, planner, plans, strategies, witness
from repro_torch.core import regex as rx
from repro_torch.core.cost_model import NetworkParams
from repro_torch.core.strategies import StrategyCost
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.graph.partition import Placement
from repro_torch.graph.structure import LabeledGraph
from repro_torch.kernels.frontier import ops as fops
from repro_torch.serve import batcher, feedback
from repro_torch.serve import metrics as metrics_mod
from repro_torch.serve import persist, plancache


class ServiceOverloaded(RuntimeError):
    """Admission queue is full; shed load upstream."""


class RankFailure(RuntimeError):
    """Another rank of the mesh raised while this one did not: the group
    fails here too, with that rank's message."""

    def __init__(self, rank: int, message: str):
        super().__init__(f"rank {rank} raised {message}")
        self.rank = rank


@dataclasses.dataclass
class ServeConfig:
    model_kind: str = "bayesian"
    n_rollouts: int = 600
    quantiles: tuple[float, ...] = (0.5, 0.9)
    decision_quantile: float = 0.9
    total_edges: int | None = None  # |E| from the count probe; None = sample size
    plan_cache_size: int = 256
    exec_cache_size: int = 64
    plan_store_size: int = 16  # Stage-A artifacts (see repro_torch.core.plans)
    max_batch: int = 128  # S2 starts per executor call (before bucketing)
    max_pending: int = 1024  # admission queue bound
    s1_coalesce_labels: int = 48  # union-label budget per coalesced S1 gather
    site_axes: tuple[str, ...] = ("data",)
    batch_axis: str | None = "model"
    max_levels: int | None = None
    # default answer semantics: "pairs" (the paper's node-pair answers)
    # or "witness" (answers + per-start discovery-level planes so
    # QueryService.witness_path can reconstruct an accepting run — see
    # repro_torch.core.witness); per-request override on submit/enqueue
    semantics: str = "pairs"
    # S2 executor backend: "reference" (plain torch gather/scatter on the
    # padded site arrays, no kernel), "frontier_kernel" (the fused level
    # kernel on the global tiles, 8 queries per row tile),
    # "frontier_kernel_packed" (same staged tiles with the frontier packed
    # into lane words — 256 query lanes per fixpoint at 1/32 the frontier
    # bytes), or "frontier_kernel_sharded" (the fused level per site
    # partition, one launch per shape bucket, per-site cost meters); the
    # fused backends' tile block size below
    s2_backend: str = "reference"
    s2_block_size: int = 128
    # staged adjacency tile-store dtype for the fused backends: "f32"
    # (dense 0/1 tiles, every semiring) or "uint32" (dst axis bitpacked
    # into word planes — 1/32 the Stage-A bytes, boolean answers only;
    # witness requests transparently restage f32).  With
    # tile_store_budget_bytes set, Stage A goes out-of-core on the
    # global fused backends: only each automaton's required
    # (direction, label) slabs are assembled on device, and cold slabs
    # beyond the resident-byte budget spill to disk (reloaded — or
    # rebuilt from the edge stream — on next touch); see
    # repro_torch.core.plans.GraphPlanStore.staged_graph (the budget bounds
    # the host slabs; each executor holds its assembled subset on the device)
    s2_tile_dtype: str = "f32"
    tile_store_budget_bytes: int | None = None
    # smallest power-of-two shape class for the sharded backend's
    # bucketed grids (see repro_torch.kernels.frontier.ops.BUCKET_FLOOR)
    s2_bucket_floor: int = 8
    # S1 coalescing: weight FFD bins by the estimated per-label D_s1
    # (sample label counts) instead of raw label popcount
    s1_cost_weighted: bool = True
    calibration_decay: float = 0.3
    seed: int = 0


@dataclasses.dataclass
class Answers:
    """What :meth:`QueryService.submit` resolves to."""

    query: str
    strategy: str
    starts: np.ndarray
    answers: list[set[int]]  # one answer set per start node
    plan: planner.QueryPlan
    observed: list[StrategyCost]  # per start (S2) or one per request (S1)
    latency_s: float
    plan_cache_hit: bool
    semantics: str = "pairs"
    # witness semantics only: per-start (n_states, n_nodes) discovery
    # levels over the *executed* automaton (exec_ca — the planner's
    # reduced form for closure queries), the state
    # QueryService.witness_path reconstructs runs from
    levels: np.ndarray | None = None
    exec_ca: paa.CompiledAutomaton | None = None


class Ticket:
    """Handle for an admitted request; resolved by :meth:`QueryService.flush`.

    After the request is *planned* (eagerly via
    :meth:`QueryService.plan_request`, or inside ``flush``), ``sig``,
    ``strategy``, and ``forecast_symbols`` carry the automaton
    signature, the effective strategy, and the §4 cost-model traffic
    forecast — the per-request signal the async layer's batching
    windows and admission control size themselves from."""

    def __init__(self, query: str, starts: np.ndarray):
        self.query = query
        self.starts = starts
        self.done = False
        self.error: Exception | None = None
        self._answers: Answers | None = None
        # filled at plan time (None/0 until the request is planned)
        self.sig: tuple | None = None
        self.strategy: str | None = None
        self.forecast_symbols: float = 0.0
        self._request = None  # set by QueryService.plan_request

    def result(self) -> Answers:
        if self.error is not None:
            raise self.error
        if not self.done or self._answers is None:
            raise RuntimeError("ticket not resolved yet — call QueryService.flush()")
        return self._answers


@dataclasses.dataclass
class _Request:
    query: str
    ast: rx.Node
    starts: np.ndarray
    ticket: Ticket
    t_enqueue: float
    strategy_override: str | None = None
    semantics: str = "pairs"
    # filled by the plan phase
    entry: plancache.PlanEntry | None = None
    plan: planner.QueryPlan | None = None
    strategy: str = ""
    plan_cache_hit: bool = False
    fkey: tuple = ()
    label_mask: np.ndarray | None = None
    sig: tuple = ()  # automaton signature (S2 batching key)

    @property
    def ca(self):
        return self.entry.ca

    @property
    def exec_ca(self):
        """The automaton the executors actually run — the planner's
        reduced form when the query class admits one (closure queries
        collapse to a 1-state automaton), the compiled original
        otherwise."""
        return self.entry.exec_ca if self.entry.exec_ca is not None else self.entry.ca

    @property
    def exec_max_levels(self):
        return self.entry.exec_max_levels


def batch_multiple(backend: str, mesh=None, batch_axis: str | None = "model") -> int:
    """The S2 batch multiple, ``repro``'s rule: the size of the mesh's
    ``batch_axis`` (1 without one, or on one card), raised to the fused
    kernels' query stack, ``QPAD`` f32 rows or ``QPACK`` packed lanes;
    the reference backend keeps the axis size."""
    multiple = 1
    if mesh is not None and batch_axis and batch_axis in shd.axis_names(mesh):
        multiple = shd.mesh_sizes(mesh)[batch_axis]
    if backend == "frontier_kernel_packed":
        return max(multiple, fops.QPACK)
    return multiple if backend == "reference" else max(multiple, fops.QPAD)


def _signature_digest(sig: tuple) -> str:
    """A short digest of a signature, by which a follower checks that it
    planned the leader's executor."""
    return hashlib.sha256(repr(sig).encode()).hexdigest()[:16]


class QueryService:
    """Serve a stream of RPQs over one arbitrarily distributed placement,
    on ``device`` (``None``: the GPU; ``"cpu"`` runs the kernels' plain
    versions).

    ``sample`` is the planner's local data (Alice's own subset in §6);
    it defaults to the full placement graph and must share the
    placement's label vocabulary.  ``strategy`` on submit/enqueue forces
    S1 or S2, bypassing the planner's decision (useful for tests and
    A/B measurement); None lets the §6 workflow decide.

    On a ``mesh`` (a ``DeviceMesh`` of ranks, one process each) every rank
    makes its service from the same arguments: rank 0 leads (admission,
    planning, batching: :meth:`enqueue`, :meth:`flush`, then
    :meth:`stop_followers`), the others :meth:`follow` its flush orders
    (see the module docstring).  The sites are blocked over
    ``config.site_axes``, whose size is the sharded backend's
    ``axis_size``, and the starts over ``config.batch_axis``.
    """

    def __init__(
        self,
        placement: Placement,
        net_params: NetworkParams,
        sample: LabeledGraph | None = None,
        config: ServeConfig | None = None,
        device: str | torch.device | None = None,
        axis_size: int | None = None,
        mesh=None,
    ):
        self.config = config or ServeConfig()
        strategies._require_ported(
            self.config.s2_backend, self.config.semantics, self.config.s2_tile_dtype
        )
        if mesh is not None:
            if axis_size is not None:
                raise ValueError("axis_size is the mesh's: the size of config.site_axes")
            axis_size = collectives.axis_size(mesh, self.config.site_axes)
        axis_size = 1 if axis_size is None else axis_size
        if placement.n_sites % axis_size:
            raise ValueError(f"n_sites={placement.n_sites} must be divisible by axis_size={axis_size}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.leader = mesh is None or collectives.mesh_rank(mesh) == 0
        # what every signature and executor of this service is built for
        self._mesh_kw = {"mesh": mesh, "site_axes": self.config.site_axes,
                         "batch_axis": self.config.batch_axis}
        self.axis_size = axis_size
        self.placement = placement
        self.net = net_params
        self.sample = sample if sample is not None else placement.graph
        if self.sample.labels != placement.graph.labels:
            raise ValueError("sample must share the placement's label vocabulary")

        self.stats_epoch = 0
        # per-label D_s1 estimate (3 symbols × sample edge count) — the
        # cost-weighted S1 coalescing bins by gather payload, not label count
        self._label_weights = strategies.EDGE_SYMBOLS * self.sample.label_counts().astype(float)
        self.model = planner.fit_model(self.sample, self.config.model_kind)
        self.plan_cache = plancache.PlanCache(self.config.plan_cache_size)
        # two-stage compilation: one Stage-A store shared by every
        # automaton signature, backend, and site of this placement
        self.plan_store = plans.GraphPlanStore(self.config.plan_store_size, self.device)
        self.exec_cache = plancache.ExecutorCache(
            self.config.exec_cache_size, plan_store=self.plan_store
        )
        self.calibrator = feedback.Calibrator(decay=self.config.calibration_decay)
        self.metrics = metrics_mod.ServiceMetrics()
        self._host_index: paa.HostIndex | None = None  # lazy, for witness_path
        self._queue: list[_Request] = []
        # flush serialization: one drain owns the admission queue at a
        # time (see flush()); enqueues stay lock-free — list.append and
        # the swap inside the lock are each atomic under the GIL
        self._flush_lock = threading.Lock()
        self._flush_owner: int | None = None
        # stage the padded site arrays once per epoch; static per placement
        # (on a mesh, the rank's rows)
        self._device_arrays = self.plan_store.site_device_arrays(
            placement, self.stats_epoch, mesh, self.config.site_axes
        )
        self._stopped = False  # a follower's last order was the stop order

    # -- stats epoch --------------------------------------------------------

    def refresh_stats(self, sample: LabeledGraph) -> None:
        """Install fresh sample statistics: refit the model and bump the
        epoch — which implicitly invalidates every cached plan, and
        invalidates Stage A exactly once (executors and staged artifacts
        of the old epoch are dropped from the caches; anything already
        handed out keeps its own references and completes normally).  On
        a mesh, call it on every rank with the same sample between the
        same two flushes."""
        if sample.labels != self.placement.graph.labels:
            raise ValueError("sample must share the placement's label vocabulary")
        self.sample = sample
        self._label_weights = strategies.EDGE_SYMBOLS * sample.label_counts().astype(float)
        self.model = planner.fit_model(sample, self.config.model_kind)
        self.stats_epoch += 1
        self.exec_cache.drop_epoch(self.stats_epoch)  # also sweeps the plan store
        self._device_arrays = self.plan_store.site_device_arrays(
            self.placement, self.stats_epoch, self.mesh, self.config.site_axes
        )

    # -- admission ----------------------------------------------------------

    def _validated_request(
        self, query: str, start_nodes, strategy: str | None,
        semantics: str | None = None,
    ) -> _Request:
        if strategy not in (None, "S1", "S2"):
            raise ValueError(f"strategy must be None, 'S1', or 'S2', got {strategy!r}")
        if semantics not in (None, "pairs", "witness"):
            raise ValueError(
                f"semantics must be None, 'pairs', or 'witness', got {semantics!r}"
            )
        ast = rx.parse(query)  # reject malformed queries at admission
        starts = np.atleast_1d(np.asarray(start_nodes, np.int32))
        n_nodes = self.placement.graph.n_nodes
        if starts.size and (starts.min() < 0 or starts.max() >= n_nodes):
            raise ValueError(
                f"start nodes must be in [0, {n_nodes}); got range "
                f"[{starts.min()}, {starts.max()}]"
            )
        return _Request(
            query=query,
            ast=ast,
            starts=starts,
            ticket=Ticket(query, starts),
            t_enqueue=time.perf_counter(),
            strategy_override=strategy,
            semantics=semantics or self.config.semantics,
        )

    def enqueue(
        self,
        query: str,
        start_nodes,
        strategy: str | None = None,
        semantics: str | None = None,
    ) -> Ticket:
        self._require_leader()
        if len(self._queue) >= self.config.max_pending:
            raise ServiceOverloaded(
                f"admission queue full ({self.config.max_pending} pending)"
            )
        req = self._validated_request(query, start_nodes, strategy, semantics)
        self._queue.append(req)
        return req.ticket

    def plan_request(
        self,
        query: str,
        start_nodes,
        strategy: str | None = None,
        semantics: str | None = None,
    ) -> Ticket:
        """Validate and *plan* a request without queueing it.

        The returned ticket carries ``sig`` / ``strategy`` /
        ``forecast_symbols`` immediately — the async serving layer plans
        at admission so it can route the request to a per-signature
        batching lane and size the lane's window from the cost forecast
        *before* any execution happens.  Hand the ticket to
        :meth:`enqueue_planned` when (and if) it should actually run;
        planning a request and then dropping it costs only the plan-
        cache lookup (a §5 rollout estimation on the first miss of its
        query class)."""
        self._require_leader()
        req = self._validated_request(query, start_nodes, strategy, semantics)
        self._plan(req)
        req.ticket._request = req
        return req.ticket

    def enqueue_planned(self, ticket: Ticket) -> Ticket:
        """Admit a ticket produced by :meth:`plan_request` into the
        flush queue (same bound as :meth:`enqueue`)."""
        self._require_leader()
        req = getattr(ticket, "_request", None)
        if req is None or req.plan is None:
            raise ValueError("ticket was not produced by plan_request")
        if ticket.done:
            raise ValueError("ticket already resolved")
        if len(self._queue) >= self.config.max_pending:
            raise ServiceOverloaded(
                f"admission queue full ({self.config.max_pending} pending)"
            )
        self._queue.append(req)
        return ticket

    def submit(
        self,
        query: str,
        start_nodes,
        strategy: str | None = None,
        semantics: str | None = None,
    ) -> Answers:
        """Admit one query and drain the queue; returns its answers.

        Anything else already enqueued is flushed (and batched) with it.
        ``semantics="witness"`` makes the resolved :class:`Answers`
        carry discovery-level planes for :meth:`witness_path`.
        """
        ticket = self.enqueue(query, start_nodes, strategy, semantics)
        self.flush()
        return ticket.result()

    @property
    def n_pending(self) -> int:
        return len(self._queue)

    def _require_leader(self) -> None:
        if not self.leader:
            raise RuntimeError("a follower rank runs its leader's flush orders (follow()), not requests")

    # -- planning -----------------------------------------------------------

    def _plan(self, req: _Request) -> None:
        cfg = self.config
        key = plancache.canonical_key(req.ast)
        entry = self.plan_cache.get(key, self.stats_epoch)
        req.plan_cache_hit = entry is not None
        if entry is None:
            est = planner.estimate_query(
                req.query,
                self.sample,
                total_edges=cfg.total_edges,
                model=self.model,
                n_rollouts=cfg.n_rollouts,
                seed=cfg.seed,
            )
            ca = paa.compile_query(req.query, self.placement.graph)
            # query-class fast paths: closure queries run a reduced
            # 1-state automaton (no automaton product), single-label /
            # bounded-concatenation queries cap the fixpoint's level
            # budget — both fold into the signature, so fast-path and
            # general executors never collide in the executor cache
            qc = est.query_class or planner.classify_query(req.ast)
            exec_ca = planner.reduce_automaton(ca, qc)
            fp_levels = planner.fast_path_max_levels(qc)
            if fp_levels is None:
                exec_levels = cfg.max_levels
            elif cfg.max_levels is None:
                exec_levels = fp_levels
            else:
                exec_levels = min(fp_levels, cfg.max_levels)
            sig_args = (
                exec_ca, self.placement.graph.n_nodes, exec_levels,
                cfg.s2_backend, cfg.s2_block_size,
            )
            entry = plancache.PlanEntry(
                key=key, ast=req.ast, ca=ca, estimates=est,
                fkey=feedback.label_class_key(req.ast),
                label_mask=strategies.query_label_mask(req.ast, self.placement.graph),
                sig=plancache.automaton_signature(
                    *sig_args, semantics="pairs", tile_dtype=cfg.s2_tile_dtype, **self._mesh_kw
                ),
                exec_ca=exec_ca,
                exec_max_levels=exec_levels,
                query_class=qc,
                # witness executors restage f32 whatever the configured
                # tile dtype (the bitpacked store is boolean-only), so
                # their signature carries the dtype they actually bake
                sig_witness=plancache.automaton_signature(
                    *sig_args, semantics="witness", tile_dtype="f32", **self._mesh_kw
                ),
            )
            self.plan_cache.put(key, self.stats_epoch, entry)
        req.entry = entry
        req.fkey = entry.fkey
        req.label_mask = entry.label_mask
        # pairs and witness requests resolve distinct signatures (the
        # witness executor's carry is one f32 plane wider), so they batch
        # into separate lanes and executor-cache slots
        req.sig = entry.sig_witness if req.semantics == "witness" else entry.sig
        f = self.calibrator.factors(req.fkey)
        plan = planner.decide_strategy(
            entry.estimates,
            self.net,
            quantiles=cfg.quantiles,
            decision_quantile=cfg.decision_quantile,
            d_s1_scale=f.d_s1,
            q_bc_scale=f.q_bc,
            d_s2_scale=f.d_s2,
        )
        # a cache hit may come from an α-equivalent string; report the
        # request's own query, not the first-seen one
        req.plan = dataclasses.replace(plan, query=req.query)
        req.strategy = req.strategy_override or req.plan.choice.strategy
        # surface the batching-window signals on the ticket; the S2
        # forecast is per source node (one BFS per start rides the
        # batch), S1 retrieves its label-matched set once per request
        req.ticket.sig = req.sig
        req.ticket.strategy = req.strategy
        per_start = max(len(req.starts), 1) if req.strategy == "S2" else 1
        req.ticket.forecast_symbols = (
            planner.forecast_cost(req.plan, req.strategy) * per_start
        )

    # -- execution ----------------------------------------------------------

    def _run_s2(self, reqs: list[_Request]) -> None:
        cfg = self.config
        # fill the fused kernel's query stack (8 rows, 256 lanes) and the
        # mesh's batch axis before growing
        multiple = batch_multiple(cfg.s2_backend, self.mesh, cfg.batch_axis)

        for group in batcher.group_by_signature(reqs, lambda r: r.sig):
            # the group's signature encodes the *executed* automaton (the
            # planner's reduced form on closure queries), the fast-path
            # level cap, and the answer semantics — build the executor
            # from exactly those
            g_sem = group[0].semantics
            g_levels = group[0].exec_max_levels

            def build():
                return self.exec_cache.get_or_build(
                    group[0].exec_ca, self.placement.graph.n_nodes, g_levels,
                    signature=group[0].sig,
                    backend=cfg.s2_backend, graph=self.placement.graph,
                    replication_factor=self.placement.replication_factor,
                    block_size=cfg.s2_block_size, placement=self.placement,
                    stats_epoch=self.stats_epoch,
                    semantics=g_sem,
                    tile_dtype=cfg.s2_tile_dtype,
                    tile_store_budget_bytes=cfg.tile_store_budget_bytes,
                    axis_size=self.axis_size,
                    bucket_floor=cfg.s2_bucket_floor,
                    **self._mesh_kw,
                )[1]

            def execute(starts, exemplar):
                return self._agreed(lambda: strategies.s2_execute(
                    self.placement, exemplar.exec_ca, starts, g_levels,
                    step_fn=step_fn, device_arrays=self._device_arrays, semantics=g_sem, **self._mesh_kw,
                ))

            try:
                step_fn = self._agreed(build)
                results = batcher.run_s2_group(
                    group, execute, max_batch=cfg.max_batch, multiple=multiple
                )
            except Exception as e:  # noqa: BLE001 — fail the group, keep serving
                for req in group:
                    self._fail(req, e)
                continue
            for req in group:
                rows, costs, batch, levels = results[id(req)]
                answers = [set(np.nonzero(rows[i])[0].tolist()) for i in range(len(req.starts))]
                for c in costs:
                    self.calibrator.observe(req.fkey, req.entry.estimates, req.plan, c)
                self._finish(req, answers, costs, exec_batch=batch, levels=levels)

    def _run_s1(self, reqs: list[_Request]) -> None:
        cfg = self.config
        graph = self.placement.graph
        weights = self._label_weights if cfg.s1_cost_weighted else None
        for group in batcher.coalesce_s1(reqs, cfg.s1_coalesce_labels, weights):
            try:
                sub = self._agreed(lambda: strategies.s1_collect(
                    self.placement, batcher.union_mask(group), device_arrays=self._device_arrays,
                    mesh=self.mesh, site_axes=cfg.site_axes,
                ))
            except Exception as e:  # noqa: BLE001
                for req in group:
                    self._fail(req, e)
                continue
            outs, errors = [], []
            for req in group:
                try:
                    outs.append(self._s1_answer(req, sub))
                    errors.append(None)
                except Exception as e:  # noqa: BLE001
                    outs.append(None)
                    errors.append(e)
            for req, out, err in zip(group, outs, self._agree_errors(errors)):
                if err is not None:
                    self._fail(req, err)
                    continue
                cost = strategies.s1_costs(req.entry.ast, graph)
                self.calibrator.observe(req.fkey, req.entry.estimates, req.plan, cost)
                self._finish(req, out[0], [cost], exec_batch=len(group), levels=out[1])

    def _s1_answer(self, req: _Request, sub: LabeledGraph) -> tuple[list[set[int]], np.ndarray | None]:
        """One S1 request's answers (and witness levels) on the gathered
        subgraph ``sub``, at the querying site."""
        graph = self.placement.graph
        ids = set(np.nonzero(req.label_mask)[0].tolist())
        own = sub if len(ids) == graph.n_labels else sub.subgraph_with_labels(ids)
        dg = paa.device_form(own, self.device)
        answers = [
            set(np.nonzero(paa.answers_single_source(req.ca, dg, int(s)).cpu().numpy())[0].tolist())
            for s in req.starts
        ]
        if req.semantics != "witness":
            return answers, None
        # S1 answers locally: the collected subgraph holds every edge the
        # query can traverse, so its BFS levels are valid against the
        # global label store (subgraph edges ⊆ global edges)
        idx = paa.HostIndex(own)
        if not len(req.starts):
            return answers, np.zeros((0, req.exec_ca.n_states, graph.n_nodes), np.float32)
        return answers, np.stack([
            witness.host_levels(req.exec_ca, idx, int(s), max_levels=req.exec_max_levels)
            for s in req.starts
        ])

    # -- agreement over ranks -------------------------------------------------

    def _agree_errors(self, errors: list) -> list:
        """On a mesh, each entry of ``errors`` (an exception or ``None``)
        agreed over every rank: one that raised anywhere is an exception
        on every rank, the rank's own or a :class:`RankFailure` with the
        first raising rank's message.  One ``all_reduce`` when none
        raised; the identity on one card."""
        if self.mesh is None or not errors:
            return errors
        flags = [e is not None for e in errors]
        if not any(collectives.agree(flags, self.mesh, self.device)):
            return errors
        axes = collectives.mesh_axes(self.mesh)
        table = collectives.gather_rows(
            torch.tensor([flags], device=self.device), axes, collectives.axis_size(self.mesh, axes), self.mesh
        ).cpu().numpy()
        me = collectives.mesh_rank(self.mesh)
        out = []
        for i, err in enumerate(errors):
            raised = np.nonzero(table[:, i])[0]
            if not len(raised):
                out.append(err)
                continue
            root = int(raised[0])
            note = f"{type(err).__name__}: {err}".encode() if me == root else None
            msg = collectives.broadcast_bytes(note, self.mesh, root, self.device).decode()
            out.append(err if err is not None else RankFailure(root, msg))
        return out

    def _agreed(self, fn):
        """``fn()``, whose exception, or another rank's, raises on every
        rank of the mesh after it (:meth:`_agree_errors`)."""
        try:
            out, err = fn(), None
        except Exception as e:  # noqa: BLE001 — agreed below
            out, err = None, e
        (err,) = self._agree_errors([err])
        if err is not None:
            raise err
        return out

    def _fail(self, req: _Request, err: Exception) -> None:
        req.ticket.error = err
        req.ticket.done = True

    def _finish(
        self,
        req: _Request,
        answers: list[set[int]],
        observed: list[StrategyCost],
        exec_batch: int,
        levels: np.ndarray | None = None,
    ) -> None:
        latency = time.perf_counter() - req.t_enqueue
        req.ticket._answers = Answers(
            query=req.query,
            strategy=req.strategy,
            starts=req.starts,
            answers=answers,
            plan=req.plan,
            observed=observed,
            latency_s=latency,
            plan_cache_hit=req.plan_cache_hit,
            semantics=req.semantics,
            levels=levels,
            exec_ca=req.exec_ca if levels is not None else None,
        )
        req.ticket.done = True
        self.metrics.record(
            metrics_mod.QueryRecord(
                query=req.query,
                strategy=req.strategy,
                latency_s=latency,
                n_starts=len(req.starts),
                broadcast_symbols=float(sum(c.broadcast_symbols for c in observed)),
                unicast_symbols=float(sum(c.unicast_symbols for c in observed)),
                plan_cache_hit=req.plan_cache_hit,
                exec_batch_size=exec_batch,
                semantics=req.semantics,
            )
        )

    def witness_path(
        self, answers: Answers, start_index: int, target: int
    ) -> witness.WitnessPath:
        """Reconstruct one accepting run for ``target`` from a
        witness-mode :class:`Answers` (``answers.starts[start_index]``
        is the run's source).  The walk runs against the placement's
        global label store; see :func:`repro_torch.core.witness.reconstruct_path`
        for the level-walk contract and error cases."""
        if answers.levels is None or answers.exec_ca is None:
            raise ValueError(
                "answers carry no witness levels — submit with semantics='witness'"
            )
        if self._host_index is None:
            self._host_index = paa.HostIndex(self.placement.graph)
        return witness.reconstruct_path(
            answers.exec_ca,
            self._host_index,
            answers.levels[start_index],
            int(answers.starts[start_index]),
            int(target),
        )

    # -- the drain loop ------------------------------------------------------

    def flush(self) -> list[Ticket]:
        """Plan, batch, execute, and resolve every pending request.

        One request failing (bad query class, executor error) fails only
        its own ticket — the rest of the window still resolves.

        Flushes are serialized: exactly one drain owns the admission
        queue at a time.  A flush from another thread blocks until the
        active one finishes, then drains whatever arrived since — under
        the sync API this was merely latent, but the async runtime
        (:mod:`repro_torch.serve.aio`) runs flushes on a worker thread while
        the event-loop thread keeps admitting, and two interleaved
        drains would resolve tickets out of two half-consistent queue
        snapshots.  A *re-entrant* call from inside the executing flush
        (same thread, e.g. a ticket callback submitting a follow-up
        query) returns ``[]`` without draining — its requests stay
        queued for the next flush instead of deadlocking.

        On a mesh the leader's flush first sends its flush order; a
        follower's flush waits for the next order and runs it (returning
        ``[]`` on the stop order)."""
        if self._flush_owner == threading.get_ident():
            return []
        on_card = torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()
        with self._flush_lock, on_card:  # a worker thread's flush launches on the service's card
            self._flush_owner = threading.get_ident()
            try:
                return self._flush_locked()
            finally:
                self._flush_owner = None

    def follow(self) -> list[Ticket]:
        """On a follower rank: run the leader's flush orders until its stop
        order (:meth:`stop_followers`); returns their tickets in order."""
        if self.leader:
            raise RuntimeError("the leader sends flush orders; follow() runs on the other ranks")
        tickets: list[Ticket] = []
        self._stopped = False
        while not self._stopped:
            tickets += self.flush()
        return tickets

    def stop_followers(self) -> None:
        """On the leader of a mesh: send the stop order that ends the
        followers' :meth:`follow` (nothing on one card)."""
        self._require_leader()
        if self.mesh is not None:
            with self._flush_lock:
                self._broadcast_order({"stop": True})

    def _broadcast_order(self, order: dict | None) -> dict:
        """The leader's flush order (JSON), on every rank."""
        payload = json.dumps(order).encode() if order is not None else None
        return json.loads(collectives.broadcast_bytes(payload, self.mesh, 0, self.device))

    @staticmethod
    def _order_of(req: _Request) -> dict:
        """What a follower needs to run ``req`` as the leader planned it."""
        return {"query": req.query, "starts": req.starts.tolist(), "semantics": req.semantics,
                "strategy": req.strategy, "levels": req.exec_max_levels,
                "sig": _signature_digest(req.sig)}

    def _follow_order(self, entries: list[dict]) -> tuple[list[_Request], list]:
        """A follower's requests of one flush order, planned with the
        leader's strategy; a plan that raised, or that built another
        executor than the leader's, is an error of its request."""
        reqs, errors = [], []
        for e in entries:
            req = self._validated_request(e["query"], e["starts"], e["strategy"], e["semantics"])
            reqs.append(req)
            try:
                self._plan(req)
                if (req.exec_max_levels, _signature_digest(req.sig)) != (e["levels"], e["sig"]):
                    raise RuntimeError(f"{req.query!r}: this rank planned another executor than the leader")
                errors.append(None)
            except Exception as err:  # noqa: BLE001 — agreed by the caller
                errors.append(err)
        return reqs, errors

    def _flush_locked(self) -> list[Ticket]:
        if self.leader:
            pending, self._queue = self._queue, []
            planned: list[_Request] = []
            for req in pending:
                try:
                    if req.plan is None:  # plan_request() tickets arrive planned
                        self._plan(req)
                    planned.append(req)
                except Exception as e:  # noqa: BLE001
                    self._fail(req, e)
            errors = [None] * len(planned)
            if self.mesh is not None:
                self._broadcast_order({"requests": [self._order_of(r) for r in planned]})
        else:
            order = self._broadcast_order(None)
            if order.get("stop"):
                self._stopped = True
                return []
            pending, errors = self._follow_order(order["requests"])
            planned = pending
        if self.mesh is not None:  # a request a follower could not plan fails everywhere
            agreed = self._agree_errors(errors)
            for req, err in zip(planned, agreed):
                if err is not None:
                    self._fail(req, err)
            planned = [r for r, err in zip(planned, agreed) if err is None]
        s2 = [r for r in planned if r.strategy == "S2"]
        s1 = [r for r in planned if r.strategy != "S2"]
        if s2:
            self._run_s2(s2)
        if s1:
            self._run_s1(s1)
        # surface the two-stage-compilation counters in the flush stats
        self.metrics.set_cache_stats(
            exec_cache=self.exec_cache.stats(),
            plan_store=self.plan_store.stats(),
            plan_pad_waste=self.plan_store.pad_stats(),
            frontier_mem=self.exec_cache.frontier_mem_stats(),
        )
        return [r.ticket for r in pending]

    # -- Stage-A persistence (warm restarts) ---------------------------------

    def save_plan_store(self, path: str) -> dict:
        """Snapshot the plan store's packed Stage-A artifacts for this
        placement to ``path`` (see :mod:`repro_torch.serve.persist`); returns
        the manifest.  Call after the executors a deployment cares about
        have been built at least once — the snapshot holds whatever is
        currently staged.  On a mesh every rank writes its own share to
        its own file, ``persist.rank_path(path, mesh)``."""
        return persist.save_stage_a(
            self.plan_store, self.placement, persist.rank_path(path, self.mesh), self.stats_epoch,
            self.mesh, self.config.site_axes,
        )

    def restore_plan_store(self, path: str) -> bool:
        """Warm-restore a Stage-A snapshot saved by another process for
        a content-identical placement, by either package.  Returns ``True``
        when the snapshot's fingerprint matched and its staged tensors were
        installed on the service's device (executor builds then skip tile
        packing entirely);
        ``False`` falls back to the cold build path with the store
        untouched.  On a mesh each rank reads its own file and refuses a
        snapshot of another share."""
        return persist.load_stage_a(
            self.plan_store, self.placement, persist.rank_path(path, self.mesh), self.stats_epoch,
            self.mesh, self.config.site_axes,
        )

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        self.metrics.set_cache_stats(
            exec_cache=self.exec_cache.stats(),
            plan_store=self.plan_store.stats(),
            plan_pad_waste=self.plan_store.pad_stats(),
            frontier_mem=self.exec_cache.frontier_mem_stats(),
        )
        return self.metrics.summary(
            extra={
                "plan_cache": self.plan_cache.stats(),
                "calibration": self.calibrator.summary(),
                "stats_epoch": self.stats_epoch,
            }
        )
