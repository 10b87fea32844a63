"""The collectives of ``repro``'s mesh programs, per rank, on
``torch.distributed``.

``repro``'s mesh programs are ``shard_map`` bodies: each device runs the
body on its local shard and the bodies meet in ``lax`` collectives over
named mesh axes.  The port runs one process per rank, each rank the
body on its own shard, and this module stands for the collectives the
bodies call:

* ``lax.axis_index`` over a tuple of axes — :func:`axis_index`, the
  rank's coordinate, row-major over the axes as ``PartitionSpec``'s
  tuple entries block a dimension (the first axis major);
* ``lax.pmax`` — :func:`pmax`, an ``all_reduce(MAX)`` on the group of
  ranks that differ only along the axes;
* ``lax.psum`` — :func:`psum`, an ``all_reduce(SUM)`` on that group;
* the all-gather a ``shard_map`` makes of an output sharded over axes
  (``out_specs`` ``P(axes)``) — :func:`gather_rows`: each rank writes
  its rows into a zeroed global buffer and the buffer is summed;
* the blocking of ``P(site_axes)`` over the sites — :func:`block_of`:
  coordinate ``d`` of ``n`` holds rows ``[d·k, (d+1)·k)``,
  ``k = ⌈rows / n⌉`` (``rows / n`` for the sites, which must divide);
  :func:`batch_block`, a batch's rows under ``P(rules.batch)``;
  :func:`fitted_block`, a dimension of a leaf under a fitted placement
  (the LMs' tensor-parallel blocks); :func:`flat_block`, rows over every
  axis as ``repro`` fits them (retrieval's candidates);
* ``lax.all_gather(x, axes, axis=dim, tiled=True)`` — :func:`all_gather`;
* ``lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)`` —
  :func:`psum_scatter`: the ``psum``, of which a rank keeps its block;
* ``lax.all_to_all(x, axes, 0, 0, tiled=True)`` — :func:`all_to_all`:
  dim 0 in ``n`` blocks, block ``j`` to coordinate ``j``, the blocks a
  rank receives concatenated in source order.

Two more serve a program that ``repro`` drives from one controller and
the port from every rank (the serving runtime's leader and followers):
:func:`broadcast_bytes`, one rank's host payload to every rank (a
length, then the bytes as uint8), and :func:`agree`, a ``pmax`` of 0/1
flags over the whole mesh.

``all_reduce`` with MAX or SUM is the one collective that NCCL and
``gloo`` both carry for CPU and CUDA tensors alike (``gloo`` takes CUDA
tensors only for ``broadcast`` and ``all_reduce``), so one code path
serves CPU ranks, a one-rank NCCL group and ``gloo`` ranks that share a
card.  Booleans travel as uint8 and ids as their integer type, so a sum
of one value and zeros is exact.  A group whose backend cannot carry a
tensor raises from ``torch.distributed``; nothing is copied to the host
on the side.

That one path costs bytes where the native collective would move fewer.
:func:`all_gather` and :func:`gather_rows` reduce a buffer ``n`` times a
rank's block; :func:`psum_scatter` reduces the whole tensor and keeps a
``1/n`` block (a reduce-scatter would reduce each block once);
:func:`all_to_all` reduces a zeroed ``(n_src, ...)`` buffer that holds
every rank's ``n`` send blocks, ``n`` times the tensor, where NCCL's
``all_to_all_single`` moves each block once.  Native NCCL collectives
are speed work for a multi-card cell.

Under autograd each collective is a ``torch.autograd.Function`` whose
backward is the transpose ``repro``'s ``shard_map`` gives it when a value
is either the same on every rank of an axis (invariant) or the rank's own
(varying):

* :func:`psum` turns varying values into an invariant one; every rank
  that holds the sum runs the work downstream again, so its cotangent is
  already the same on each of them and the backward is the identity;
* :func:`gather_rows` (a ``shard_map`` output gathered over axes): the
  rank's own block of the cotangent, no bytes moved;
* :func:`all_gather` (whose result each rank uses on its own data):
  :func:`psum_scatter` of the cotangents, as JAX transposes it;
* :func:`psum_scatter`: :func:`all_gather`; :func:`all_to_all` (tiled,
  equal blocks): :func:`all_to_all` again;
* :func:`pmax`: no gradient (``repro``'s ``stop_gradient``);
* :func:`enter`: the identity forward, a :func:`psum` backward, where an
  invariant value is used on varying data (the transpose of a
  ``shard_map`` input that is not mapped over the axes: a replicated
  parameter or node state on the rank's block of a batch or of edges).

A backward over axes of size 1 moves nothing.  Every rank must build
the same graph around each collective, so no rank may add or drop one on
its data: the collectives here never branch on values.

:data:`WIRE_COUNTERS` counts the ``all_reduce`` calls and the bytes of
the tensors they carry, per process, and the calls of each collective
above by its name, the backward calls under ``<name>_backward``.  An
``all_reduce`` recorded into a CUDA graph (a fixpoint body on an NCCL
rank, ``kernels/frontier/ops.py``'s ``LevelLoop``) counts at each replay
of the graph, not at its capture (:func:`recording_wire`,
:func:`add_wire`).

Each ``all_reduce`` also notes itself, under the kind of ``repro``'s HLO
collective it stands for (``all-reduce`` for :func:`psum`, :func:`pmax`
and :func:`agree`, ``all-gather``, ``reduce-scatter``, ``all-to-all``;
``broadcast`` for :func:`broadcast_bytes`, which ``repro``'s single
controller has no need of), with the bytes of that collective's result,
to any counter on the dispatch-mode stack that takes notes
(``launch/analysis.py``'s ``count_step``): so a count sees both what the
port's program moves and what a native collective of the kind would.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.dist import sharding as shd

Axes = tuple[str, ...]

# all_reduce calls and the bytes of the tensors they reduced, this process
WIRE_COUNTERS: collections.Counter = collections.Counter()

# (id(mesh), axes) -> (mesh, group): the mesh is held so its id is not reused
_GROUPS: dict[tuple[int, Axes], tuple[object, object]] = {}


def _axes(axes) -> Axes:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _mesh(mesh):
    mesh = shd.get_mesh() if mesh is None else mesh
    if not shd.is_device_mesh(mesh):
        raise ValueError("a collective needs a DeviceMesh: pass mesh= or install one with use_mesh")
    return mesh


def axis_size(mesh, axes) -> int:
    """The product of ``axes``' sizes on ``mesh`` (1 for no axis)."""
    sizes = shd.mesh_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(axes))


def axis_index(mesh, axes) -> int:
    """This rank's coordinate over ``axes``, row-major (``lax.axis_index``
    of a tuple of axes)."""
    sizes = shd.mesh_sizes(mesh)
    index = 0
    for a in _axes(axes):
        index = index * sizes[a] + int(mesh.get_local_rank(a))
    return index


def group(mesh, axes):
    """The process group of the ranks that differ from this one only
    along ``axes``.  Axes of size 1 add no rank and are dropped; one axis
    left is the mesh's own group; several are made once per (mesh, axes)
    by every rank, in the same order, and cached."""
    sizes = shd.mesh_sizes(mesh)
    axes = tuple(a for a in _axes(axes) if sizes[a] > 1) or _axes(axes)[:1]
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = shd.axis_names(mesh)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, axis_size(mesh, axes))
        mine = None
        for row in ranks.tolist():  # every rank makes every group, in one order
            g = dist.new_group(ranks=row)
            if dist.get_rank() in row:
                mine = g
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


def backend(mesh, axes) -> str:
    """The backend of this rank's groups over ``axes`` (``dist.get_backend``
    of the mesh's group of the first axis; a mesh's groups share one
    backend): ``"nccl"``, whose collectives a CUDA graph captures, or
    ``"gloo"``, whose ``all_reduce`` waits on the host."""
    return dist.get_backend(_mesh(mesh).get_group(_axes(axes)[0]))


def _note(kind: str, nbytes: int, wire_bytes: int, n_ranks: int) -> None:
    """Tell every counter on the dispatch-mode stack that takes notes of
    one collective of ``repro``'s ``kind``."""
    for mode in _get_current_dispatch_mode_stack():
        note = getattr(mode, "note_collective", None)
        if note is not None:
            note(kind, nbytes, wire_bytes, n_ranks)


@dataclasses.dataclass
class Recorded:
    """The ``all_reduce`` calls that a CUDA graph capture recorded: their
    :data:`WIRE_COUNTERS` counts and their notes, added at each replay
    (:func:`add_wire`)."""

    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    notes: list = dataclasses.field(default_factory=list)


# per thread: the record of the graph capture recording_wire() opened
_RECORDING = threading.local()


@contextlib.contextmanager
def recording_wire():
    """The collectives that the calls in this block record into a CUDA
    graph capture: a :class:`Recorded` that the graph's owner hands
    :func:`add_wire` at each replay.  A captured call only enqueues its
    ``all_reduce`` into the graph, so it counts there and not at the
    capture."""
    prev = getattr(_RECORDING, "record", None)
    _RECORDING.record = record = Recorded()
    try:
        yield record
    finally:
        _RECORDING.record = prev


def add_wire(record: Recorded) -> None:
    """Count ``record``'s collectives (a replayed graph's) once more."""
    WIRE_COUNTERS.update(record.counts)
    for note in record.notes:
        _note(*note)


def _reduce_(buf: torch.Tensor, op, axes, mesh, kind: str = "all-reduce", result_bytes: int | None = None) -> None:
    """``all_reduce`` ``buf`` in place with ``op`` over ``axes``, counted;
    it stands for a collective of ``repro``'s ``kind`` whose result holds
    ``result_bytes`` (default: ``buf``'s).  Under a CUDA graph capture the
    count and the note go to the capturing thread's record
    (:func:`recording_wire`)."""
    axes = _axes(axes)
    if axes:
        nbytes = buf.numel() * buf.element_size()
        note = (kind, nbytes if result_bytes is None else result_bytes, nbytes, axis_size(mesh, axes))
        record = getattr(_RECORDING, "record", None) if buf.is_cuda and torch.cuda.is_current_stream_capturing() \
            else None
        counts, notes = (record.counts, record.notes) if record is not None else (WIRE_COUNTERS, None)
        counts["all_reduces"] += 1
        counts["bytes"] += nbytes
        if notes is None:
            _note(*note)
        else:
            notes.append(note)
        dist.all_reduce(buf, op=op, group=group(mesh, axes))


def _all_reduce(x: torch.Tensor, op, axes, mesh, kind: str = "all-reduce",
                result_bytes: int | None = None) -> torch.Tensor:
    """``x`` reduced with ``op`` over ``axes``, in a new tensor; bool
    travels as uint8."""
    out = x.to(torch.uint8) if x.dtype == torch.bool else x.clone()
    _reduce_(out, op, axes, _mesh(mesh), kind, result_bytes)
    return out.bool() if x.dtype == torch.bool else out


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``lax.pmax(x, axes)``: the elementwise max over the ranks along
    ``axes`` (``mesh``: the installed one when ``None``); cut from the
    gradient."""
    return _all_reduce(x.detach(), dist.ReduceOp.MAX, axes, mesh)


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``lax.psum(x, axes)``: the sum over the ranks along ``axes``.
    Floating sums are in the backend's order: exact for integers in f32
    below 2^24.  Its backward is the identity (the sum is invariant)."""
    if _records(x):
        return _PSum.apply(x, _axes(axes), mesh)
    return _all_reduce(x, dist.ReduceOp.SUM, axes, mesh)


def block_of(n_rows: int, axes, mesh=None, even: bool = False) -> tuple[int, int]:
    """The rows ``[lo, hi)`` of ``n_rows`` that this rank holds when they
    are blocked over ``axes``: coordinate ``d`` holds ``[d·k, (d+1)·k)``
    with ``k = ⌈n_rows / n⌉``, the last block cut at ``n_rows``.  With
    ``even`` the axes' size must divide ``n_rows`` (sites, as ``repro``
    blocks them over its site axes)."""
    mesh = _mesh(mesh)
    n = axis_size(mesh, axes)
    if even and n_rows % n:
        raise ValueError(f"{n_rows} rows must be divisible by the size {n} of axes {_axes(axes)}")
    k = -(-n_rows // n)
    d = axis_index(mesh, axes)
    return min(d * k, n_rows), min((d + 1) * k, n_rows)


def site_block(n_sites: int, site_axes, mesh=None) -> tuple[int, int]:
    """The sites ``[d·k, (d+1)·k)``, ``k = n_sites / axis_size``, that this
    rank holds (``d`` its coordinate over ``site_axes``), as ``repro``'s
    ``shard_map`` blocks them."""
    return block_of(n_sites, site_axes, mesh, even=True)


def gather_rows(local: torch.Tensor, axes, n_total: int, mesh=None, dim: int = 0) -> torch.Tensor:
    """The ``(n_total, ...)`` tensor whose rows along ``dim`` are blocked
    over ``axes`` (:func:`block_of`), from each rank's ``local`` block, on
    every rank: each rank writes its rows into a zeroed global buffer and
    the buffers are summed (``all_reduce(SUM)``).  One value plus zeros
    is exact in any dtype; booleans travel as uint8.  The backward is the
    rank's own rows of the (invariant) cotangent."""
    mesh = _mesh(mesh)
    lo, hi = block_of(n_total, axes, mesh)
    if local.shape[dim] != hi - lo:
        raise ValueError(f"this rank holds rows [{lo}, {hi}) of {n_total}, got {local.shape[dim]}")
    if _records(local):
        return _GatherRows.apply(local, _axes(axes), n_total, mesh, dim)
    return _gather_rows(local, axes, n_total, mesh, dim, lo, hi)


def _gather_rows(local, axes, n_total: int, mesh, dim: int, lo: int, hi: int) -> torch.Tensor:
    src = local.to(torch.uint8) if local.dtype == torch.bool else local
    shape = list(src.shape)
    shape[dim] = n_total
    buf = torch.zeros(shape, dtype=src.dtype, device=src.device)
    buf.narrow(dim, lo, hi - lo).copy_(src)
    _reduce_(buf, dist.ReduceOp.SUM, axes, mesh, "all-gather")
    return buf.bool() if local.dtype == torch.bool else buf


def batch_block(rules: shd.Rules, n: int) -> tuple[int, int, Axes]:
    """The rows ``[lo, hi)`` of a batch of ``n`` that this rank runs on the
    installed mesh, and the axes they are blocked over: ``repro``'s
    ``rules.fit(P(rules.batch, None), (n, ...))``, which leaves a batch
    the batch axes do not divide whole on every rank.  ``(0, n, ())``
    off-mesh."""
    mesh = shd.get_mesh()
    if mesh is None:
        return 0, n, ()
    axes = entry_axes(rules.fit((rules.batch, None), (n, 1))[0])
    return (*block_of(n, axes, mesh), axes)


def fitted_block(placement, shape, dim: int, mesh=None) -> tuple[int, int, Axes]:
    """The rows ``[lo, hi)`` of dimension ``dim`` that this rank holds of a
    leaf of global ``shape`` under ``placement`` fitted as ``repro`` fits
    it (:func:`sharding.fit_spec`: a dimension the axes do not divide
    stays whole), and the axes they are blocked over: :func:`leaf_block`'s
    cut of that dimension.  ``(0, shape[dim], ())`` off-mesh or where the
    fit leaves the dimension whole."""
    mesh = shd.get_mesh() if mesh is None else mesh
    if mesh is None:
        return 0, shape[dim], ()
    axes = entry_axes(shd.fit_spec(mesh, placement, tuple(shape))[dim])
    if not axes:
        return 0, shape[dim], ()
    return (*block_of(shape[dim], axes, mesh, even=True), axes)


def flat_block(rules: shd.Rules, n: int) -> tuple[int, int, Axes]:
    """The rows ``[lo, hi)`` of ``n`` that this rank holds when they lie
    over every axis of the installed mesh (the batch axes, then the model
    axis), fitted as ``repro`` fits ``P((batch axes…, model))``: axes
    dropped innermost first until their size divides ``n`` (1,000,000
    retrieval candidates lie over ``data`` at (16, 16) and over ``(pod,
    data)`` at (2, 16, 16)), and the axes kept.  ``(0, n, ())``
    off-mesh."""
    flat = tuple(rules.batch_axes) + ((rules.model_axis,) if rules.model_axis else ())
    return fitted_block((flat,), (n,), 0)


def entry_axes(entry) -> Axes:
    """A fitted placement entry's axes: () for ``None``."""
    return () if entry is None else _axes(entry)


def _block(x: torch.Tensor, axes, mesh, dim: int) -> tuple[int, int]:
    """(n, k): the size of ``axes`` and the block each rank holds of
    ``x.shape[dim]``, which ``n`` must divide."""
    n = axis_size(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over the {n} ranks of {_axes(axes)}")
    return n, x.shape[dim] // n


def all_gather(x: torch.Tensor, axes, dim: int = 0, mesh=None) -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``: every rank's
    ``x`` concatenated along ``dim`` in coordinate order over ``axes``
    (:func:`axis_index`), on every rank.  Each rank writes its block into
    a zeroed buffer ``n`` times as long along ``dim``, which is summed:
    exact in any dtype, ``n`` times ``x``'s bytes on the wire.  Over axes
    of size 1 it is ``x`` itself: no copy (kimi-k2's experts gathered over
    a one-rank data axis would be a second 33.8 GB).  Its backward is
    :func:`psum_scatter` of the cotangents: each rank used the gathered
    tensor on its own data."""
    mesh = _mesh(mesh)
    WIRE_COUNTERS["all_gather"] += 1
    n, me = axis_size(mesh, axes), axis_index(mesh, axes)
    if n == 1:
        return x
    if _records(x):
        return _AllGather.apply(x, _axes(axes), dim, mesh)
    return _all_gather(x, axes, dim, mesh, n, me)


def _all_gather(x, axes, dim: int, mesh, n: int, me: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] *= n
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, me * x.shape[dim], x.shape[dim]).copy_(x)
    _reduce_(buf, dist.ReduceOp.SUM, axes, mesh, "all-gather")
    return buf


def psum_scatter(x: torch.Tensor, axes, dim: int = 0, mesh=None) -> torch.Tensor:
    """``lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``:
    the sum of ``x`` over the ranks along ``axes``, of which this rank
    keeps block :func:`axis_index` of ``n`` along ``dim`` (which ``n``
    must divide).  One ``all_reduce(SUM)`` of the whole of ``x``, then
    the block: the sums of :func:`psum`, ``n`` times the bytes a
    reduce-scatter would reduce.  Its backward is :func:`all_gather`."""
    mesh = _mesh(mesh)
    WIRE_COUNTERS["psum_scatter"] += 1
    _, k = _block(x, axes, mesh, dim)
    if _records(x):
        return _PSumScatter.apply(x, _axes(axes), dim, mesh)
    return _psum_scatter(x, axes, dim, mesh, k)


def _psum_scatter(x, axes, dim: int, mesh, k: int) -> torch.Tensor:
    block_bytes = x.numel() // x.shape[dim] * k * x.element_size()
    summed = _all_reduce(x, dist.ReduceOp.SUM, axes, mesh, "reduce-scatter", block_bytes)
    return summed.narrow(dim, axis_index(mesh, axes) * k, k).contiguous()


def all_to_all(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``lax.all_to_all(x, axes, 0, 0, tiled=True)``: ``x``'s dim 0 cut in
    ``n`` blocks, block ``j`` sent to coordinate ``j``; the ``n`` blocks
    this rank receives, concatenated from coordinate 0 to ``n - 1``, in
    ``x``'s shape.  Each rank writes its ``x`` at its source row of a
    zeroed ``(n_src, ...)`` buffer, the buffer is summed, and the rank
    reads its own block of every row: exact in any dtype (one value plus
    zeros), ``n`` times ``x``'s bytes on the wire where NCCL's
    ``all_to_all_single`` moves ``x`` once.  Over axes of size 1 it is
    ``x`` itself.  Its backward is :func:`all_to_all` of the cotangent
    (block ``i`` of rank ``j``'s output came from block ``j`` of rank
    ``i``'s input)."""
    mesh = _mesh(mesh)
    WIRE_COUNTERS["all_to_all"] += 1
    n, k = _block(x, axes, mesh, 0)
    if n == 1:
        return x
    if _records(x):
        return _AllToAll.apply(x, _axes(axes), mesh)
    return _all_to_all(x, axes, mesh, n, k)


def _all_to_all(x, axes, mesh, n: int, k: int) -> torch.Tensor:
    me = axis_index(mesh, axes)
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[me].copy_(x)
    _reduce_(buf, dist.ReduceOp.SUM, axes, mesh, "all-to-all", x.numel() * x.element_size())
    return buf[:, me * k : (me + 1) * k].reshape(x.shape)


def enter(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``x``, an invariant value about to be used on data that varies
    over ``axes`` (a replicated parameter or node state on the rank's
    block of a batch or of edges): the identity forward, whose backward
    sums the ranks' cotangents over ``axes`` (:func:`psum`).  The
    transpose of a ``shard_map`` input that is not mapped over
    ``axes``.  ``x`` itself when autograd does not record it, off a mesh
    or over no axes."""
    axes = _axes(axes)
    if not axes or not _records(x) or (mesh is None and shd.get_mesh() is None):
        return x
    return _Enter.apply(x, axes, _mesh(mesh))


def enter_tree(tree, axes, mesh=None):
    """:func:`enter` on every tensor leaf of a tree of dictionaries and
    lists."""
    if isinstance(tree, dict):
        return {k: enter_tree(v, axes, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(enter_tree(v, axes, mesh) for v in tree)
    return enter(tree, axes, mesh) if isinstance(tree, torch.Tensor) else tree


def _records(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def _moves(mesh, axes) -> bool:
    """Whether a collective over ``axes`` involves more than this rank."""
    return axis_size(mesh, axes) > 1


def _counted(name: str) -> None:
    WIRE_COUNTERS[f"{name}_backward"] += 1


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _all_reduce(x, dist.ReduceOp.SUM, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        _counted("psum")
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _counted("enter")
        if not _moves(ctx.mesh, ctx.axes):
            return g, None, None
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.axes, ctx.mesh), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, axes, n_total, mesh, dim):
        lo, hi = block_of(n_total, axes, mesh)
        ctx.lo, ctx.hi, ctx.dim = lo, hi, dim
        return _gather_rows(local, axes, n_total, mesh, dim, lo, hi)

    @staticmethod
    def backward(ctx, g):
        _counted("gather_rows")
        return g.narrow(ctx.dim, ctx.lo, ctx.hi - ctx.lo), None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, mesh
        return _all_gather(x, axes, dim, mesh, axis_size(mesh, axes), axis_index(mesh, axes))

    @staticmethod
    def backward(ctx, g):
        _counted("all_gather")
        return psum_scatter(g.contiguous(), ctx.axes, ctx.dim, ctx.mesh), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, mesh
        _, k = _block(x, axes, mesh, dim)
        return _psum_scatter(x, axes, dim, mesh, k)

    @staticmethod
    def backward(ctx, g):
        _counted("psum_scatter")
        return all_gather(g.contiguous(), ctx.axes, ctx.dim, ctx.mesh), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        n, k = _block(x, axes, mesh, 0)
        return _all_to_all(x, axes, mesh, n, k)

    @staticmethod
    def backward(ctx, g):
        _counted("all_to_all")
        return all_to_all(g.contiguous(), ctx.axes, ctx.mesh), None, None


def leaf_block(x: torch.Tensor, placement, mesh=None) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under ``placement`` (one
    entry a dimension: ``None``, an axis or a tuple of axes), fitted on
    ``x``'s shape (:func:`sharding.fit_spec`): each placed dimension cut
    to the rank's block over its axes (:func:`block_of`, which the axes'
    size must divide).  A view of ``x``."""
    mesh = _mesh(mesh)
    for dim, entry in enumerate(shd.fit_spec(mesh, placement, tuple(x.shape))):
        if entry is not None:
            lo, hi = block_of(x.shape[dim], entry_axes(entry), mesh, even=True)
            x = x.narrow(dim, lo, hi - lo)
    return x


def _whole_shape(block_shape, placement, mesh) -> tuple[int, ...]:
    """The shape of the leaf whose blocks under ``placement`` (taken as it
    is, not fitted) have ``block_shape``."""
    entries = tuple(placement) + (None,) * (len(block_shape) - len(tuple(placement)))
    return tuple(int(d) * axis_size(mesh, entry_axes(e)) for d, e in zip(block_shape, entries))


def assemble_leaf(block: torch.Tensor, placement, mesh=None) -> torch.Tensor:
    """The inverse of :func:`leaf_block`: the whole leaf, on every rank,
    from each rank's ``block`` under ``placement`` (taken as it is: each
    placed dimension's blocks equal), one :func:`gather_rows` a placed
    dimension."""
    mesh = _mesh(mesh)
    shape = _whole_shape(block.shape, placement, mesh)
    for dim, entry in enumerate(tuple(placement)):
        if entry is not None and shape[dim] != block.shape[dim]:
            block = gather_rows(block.contiguous(), entry_axes(entry), shape[dim], mesh, dim)
    return block


def mesh_axes(mesh) -> Axes:
    """Every axis of ``mesh``, in its order: the whole mesh as one group."""
    return shd.axis_names(mesh)


def mesh_rank(mesh) -> int:
    """This rank's coordinate over the whole mesh, row-major."""
    return axis_index(mesh, mesh_axes(mesh))


def _device(mesh, device) -> torch.device:
    """Where a host value goes to be reduced: ``device``, else the mesh's
    device type (the current card on CUDA)."""
    if device is not None:
        return torch.device(device)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def broadcast_bytes(payload: bytes | None, mesh=None, root: int = 0, device=None) -> bytes:
    """``payload`` of the rank at whole-mesh coordinate ``root``
    (:func:`mesh_rank`), on every rank: its length, then its bytes as
    uint8, each written by ``root`` into a zeroed buffer that is summed
    over the mesh, as :func:`gather_rows` does.  The other ranks pass
    ``None`` (their payload is ignored)."""
    mesh = _mesh(mesh)
    axes, dev = mesh_axes(mesh), _device(mesh, device)
    mine = mesh_rank(mesh) == root
    n = torch.tensor([len(payload) if mine else 0], dtype=torch.int64, device=dev)
    _reduce_(n, dist.ReduceOp.SUM, axes, mesh, "broadcast")
    buf = torch.zeros(int(n[0]), dtype=torch.uint8, device=dev)
    if mine and len(payload):
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    _reduce_(buf, dist.ReduceOp.SUM, axes, mesh, "broadcast")
    return buf.cpu().numpy().tobytes()


def agree(flags, mesh=None, device=None) -> list[bool]:
    """Whether any rank raised each of ``flags`` (a sequence of bools):
    one ``pmax`` of 0/1 over the whole mesh.  Every rank gets the same
    answers, so every rank takes the same branch after it."""
    mesh = _mesh(mesh)
    x = torch.tensor(list(flags), dtype=torch.uint8, device=_device(mesh, device))
    if x.numel():
        _reduce_(x, dist.ReduceOp.MAX, mesh_axes(mesh), mesh)
    return [bool(v) for v in x.cpu().tolist()]


__all__ = ["WIRE_COUNTERS", "agree", "all_gather", "all_to_all", "assemble_leaf", "axis_index", "axis_size",
           "batch_block", "block_of", "broadcast_bytes", "enter", "enter_tree", "entry_axes", "fitted_block",
           "flat_block", "gather_rows", "group",
           "leaf_block", "mesh_axes", "mesh_rank", "pmax", "psum", "psum_scatter", "site_block"]
