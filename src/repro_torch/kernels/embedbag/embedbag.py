"""The fused EmbeddingBag: a gather plus a segment sum over lookups
sorted by bag.

Port of ``repro/kernels/embedbag/embedbag.py::embedding_bag_sorted``
(kernel B6).  ``repro``'s Pallas grid takes one lookup per step, DMAs
the table row in and adds it into the output row of its bag, zeroing a
bag at its first lookup and accumulating in the table's dtype: a bag
sums its rows in sorted order, and a bf16 sum is rounded to bf16 after
every lookup.  The port computes the same: f32 sums in f32, bf16 sums
rounded to bf16 (round to nearest even) after every lookup, so both
dtypes equal ``repro`` bit for bit.  Every bag is written, and one no
lookup visits is zero.

On a CUDA tensor :func:`embedding_bag_sorted` launches the hand-written
kernel of ``csrc/embedbag.cu``.  Its work is split by lookups, not bags:
a group of lanes owns a range of sorted lookups, sums the bags that
start there (reading past the range to finish its last one) and zeroes
the empty bag ids before each of them, so no offsets are computed and
no atomics are needed.  :func:`launch_geometry` picks the vector width
of a lane's load, the lanes of a row and the lookups of a range from the
shapes.  The gathered rows bound its time where the table is many times
the L2, as at ogb_products.  On a CPU tensor it runs
:func:`embedding_bag_sorted_plain`; there is no fallback from the one to
the other.

:func:`embedding_bag_sorted` calls the custom operator
``torch.ops.repro_torch.embedding_bag_sorted``, defined with
``torch.library``: its CUDA kernel is the launch (:func:`_launch`), its
CPU kernel the plain version, and its fake (the meta device, a
shape-only run of ``launch/``) checks the inputs and gives the kernel's
output shape and dtype, launching nothing and adding nothing to
:data:`LAUNCHES`.  A dispatch mode sees one call a launch.  Its FLOPs
are registered with ``torch.utils.flop_counter`` (:func:`bag_work`: N·D
adds over N lookups of D columns), and ``launch/analysis.py`` charges
its bytes by the same formula, the gathered rows and the output.  The
operator is defined with ``Library.define`` and ``impl``, not the
``custom_op`` decorator, whose kernels run under a wrapper that imports
``torch._dynamo`` at a process's first call (~2 s in every spawned rank)
and adds host time to every launch.

The op is differentiable in the table (``register_autograd``).
``repro`` gets that gradient from XLA (the transpose of ``jnp.take`` +
``segment_sum``: a scatter-add of the cotangent's bag rows into a zero
table); here it is B6 itself on the transposed lookups, sorted by row
(:func:`transpose_lookups`), so the backward launches the same kernel,
writes the dense gradient (zeros where no lookup reads) and uses no
atomics.  :func:`embedding_bag_sorted_grad` lets a caller give the
backward's lookups itself.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.kernels import _build

LAUNCHES = 0  # B6: embedding_bag_sorted

# lookups gathered at once by the plain version: bounds its transient
# (chunk, D) rows
PLAIN_CHUNK = 1 << 22

# a range of lookups per lane group: enough groups to fill the card
# (~32K), at most MAX_PER_UNIT lookups each
UNITS = 1 << 15
MAX_PER_UNIT = 256
MAX_LOOKUPS = 2**31 - 2 * MAX_PER_UNIT  # positions stay in int32 inside the kernel

_DTYPES = {torch.float32: "embedding_bag_f32", torch.bfloat16: "embedding_bag_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def bag_offsets(bags: torch.Tensor, n_bags: int) -> torch.Tensor:
    """(n_bags + 1,) int32: lookups ``offsets[b] .. offsets[b+1]`` of a
    non-decreasing ``bags`` are bag ``b``'s, found on the device."""
    values = torch.arange(n_bags + 1, dtype=bags.dtype, device=bags.device)
    return torch.searchsorted(bags, values, out_int32=True)


def embedding_bag_sorted_plain(
    table: torch.Tensor, idx: torch.Tensor, bags: torch.Tensor, n_bags: int
) -> torch.Tensor:
    """:func:`embedding_bag_sorted` in plain PyTorch: the lookups are taken
    rank by rank (rank = position inside the bag), so each step adds at
    most one row to a bag, and every bag sums its rows in sorted order in
    f32 (float64 in float64), rounding to the table's dtype after every
    lookup, as the kernel and ``repro`` do.  Gathers at most
    :data:`PLAIN_CHUNK` rows at once."""
    n, d = idx.shape[0], table.shape[1]
    wide = torch.promote_types(table.dtype, torch.float32)  # float64 stays float64
    acc = torch.zeros((n_bags, d), dtype=table.dtype, device=table.device)
    if n:
        bags64 = bags.long()
        rank = torch.arange(n, device=bags.device) - bag_offsets(bags, n_bags)[bags64]
        order = torch.argsort(rank, stable=True)
        lo = 0
        for count in torch.bincount(rank).tolist():
            for start in range(lo, lo + count, PLAIN_CHUNK):
                sel = order[start : min(start + PLAIN_CHUNK, lo + count)]
                rows = bags64[sel]  # distinct: one lookup per bag at a rank
                acc[rows] = (acc[rows].to(wide) + table[idx[sel].long()].to(wide)).to(table.dtype)
            lo += count
    return acc


def launch_geometry(d: int, itemsize: int, align: int, n: int) -> dict:
    """How B6 walks a table of ``d`` columns of ``itemsize`` bytes at an
    address aligned to ``align`` bytes, over ``n`` lookups: ``vec_bytes``,
    the widest load (16, 8, 4, or 2 for bf16) that divides a row and the
    alignment; ``lanes``, a power of two from 2 to 32 that covers a row in
    such loads, else 32 lanes per column chunk; ``n_chunks``; and
    ``per_unit``, the lookups a lane group owns."""
    row_bytes = d * itemsize
    vec = next(v for v in (16, 8, 4, 2) if v >= itemsize and row_bytes % v == 0 and align % v == 0)
    lanes_needed = row_bytes // vec
    lanes = min(32, max(2, 1 << (lanes_needed - 1).bit_length()))
    per_unit = min(MAX_PER_UNIT, max(lanes, 1 << (-(-n // UNITS) - 1).bit_length()))
    return {"vec_bytes": vec, "lanes": lanes, "n_chunks": -(-lanes_needed // lanes),
            "per_unit": per_unit}


def _check(table, idx, bags) -> None:
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if table.dim() != 2:
        raise ValueError(f"table must be (rows, D), got {tuple(table.shape)}")
    for name, t in (("table", table), ("idx", idx), ("bags", bags)):
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("idx", idx), ("bags", bags)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    if idx.shape != bags.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and bags {tuple(bags.shape)} differ")
    if idx.shape[0] > MAX_LOOKUPS:
        raise ValueError(f"{idx.shape[0]} lookups exceed the kernel's {MAX_LOOKUPS}")


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("embedding_bag_sorted(Tensor table, Tensor idx, Tensor bags, SymInt n_bags) -> Tensor")


def embedding_bag_sorted(
    table: Tensor,  # (R, D) float32 or bfloat16
    idx: Tensor,  # (N,) int32 — row per lookup, lookups sorted by bag
    bags: Tensor,  # (N,) int32 — non-decreasing bag ids in [0, n_bags)
    n_bags: int,
) -> Tensor:
    """(n_bags, D) bag sums in the table's dtype.  Bags no lookup visits
    are zero, where ``repro``'s kernel leaves them unwritten.  On CPU
    tensors this is :func:`embedding_bag_sorted_plain`; on CUDA tensors
    it launches B6 or raises; on meta tensors it returns an empty meta
    output.  Differentiable in ``table``.  A call that records no
    gradient (a serve step, a backward) dispatches below autograd, past
    the op's Python autograd kernel and its host time."""
    op = torch.ops.repro_torch.embedding_bag_sorted.default
    if torch.is_grad_enabled() and table.requires_grad:
        return op(table, idx, bags, n_bags)
    with torch._C._AutoDispatchBelowAutograd():
        return op(table, idx, bags, n_bags)


def bag_work(table: Tensor, idx: Tensor, bags: Tensor, n_bags: int) -> tuple[float, float, int, bool]:
    """B6's work by formula, from the op's arguments: (N·D adds, bytes of
    the N gathered rows and the (n_bags, D) output, N, False: the adds
    run on the CUDA cores)."""
    n, d = idx.shape[0], table.shape[1]
    return float(n * d), float((n + n_bags) * d * table.element_size()), n, False


if torch.ops.repro_torch.embedding_bag_sorted not in flop_registry:
    @register_flop_formula(torch.ops.repro_torch.embedding_bag_sorted, get_raw=True)
    def _bag_flops(table, idx, bags, n_bags, *args, out_val=None, **kwargs) -> float:
        return bag_work(table, idx, bags, n_bags)[0]


@torch.library.register_fake("repro_torch::embedding_bag_sorted")
def _(table, idx, bags, n_bags):
    _check(table, idx, bags)
    return table.new_empty((n_bags, table.shape[1]))


@torch.library.impl(_LIB, "embedding_bag_sorted", "CPU")
def _(table, idx, bags, n_bags):
    return embedding_bag_sorted_plain(table, idx, bags, n_bags)


@torch.library.impl(_LIB, "embedding_bag_sorted", "CUDA")
def _launch(table, idx, bags, n_bags):
    """The op's CUDA kernel: the ctypes launch of B6."""
    global LAUNCHES
    _check(table, idx, bags)
    d = table.shape[1]
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    if n_bags == 0 or d == 0:
        return out
    n = idx.shape[0]
    geo = launch_geometry(d, table.element_size(), table.data_ptr(), n)
    fn = getattr(_build.load("embedbag"), _DTYPES[table.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(table.device):
        err = fn(
            table.data_ptr(), idx.data_ptr(), bags.data_ptr(), out.data_ptr(), n, n_bags, d,
            geo["n_chunks"], geo["vec_bytes"], geo["lanes"], geo["per_unit"],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{_DTYPES[table.dtype]} launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# The gradient: B6 on the transposed lookups
# ---------------------------------------------------------------------------


def transpose_lookups(idx: torch.Tensor, bags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The lookups sorted stably by table row: (``idx_T``, ``bags_T``),
    each lookup's bag in that order and its row.  B6 over ``bags_T`` as
    bags and ``idx_T`` as rows of the cotangent sums each table row's
    lookups in their order in ``idx``, as the scatter-add that transposes
    ``jnp.take`` does."""
    rows, order = torch.sort(idx, stable=True)
    return bags[order].contiguous(), rows.contiguous()


def _setup_backward(ctx, inputs, output) -> None:
    table, idx, bags, _ = inputs
    ctx.n_rows = table.shape[0]
    # the lookups held as they are, not saved for backward: under
    # torch.utils.checkpoint a saved tensor would make the backward's
    # recomputation run on to this launch again
    ctx.lookups = (idx, bags)
    ctx.transpose = None  # embedding_bag_sorted_grad may set it on the output's grad_fn


def _backward(ctx, grad_out):
    """B6 again on the transposed lookups, ``grad_table[r] = Σ
    grad_out[bags[i]]`` over the lookups ``i`` of row ``r``, in the
    table's dtype; rows no lookup visits get exact zeros, the dense
    gradient that ``repro``'s ``take`` transposes to."""
    if ctx.transpose is None:
        idx_t, bags_t = transpose_lookups(*ctx.lookups)
    else:
        idx_t, bags_t = ctx.transpose()
    return embedding_bag_sorted(grad_out.contiguous(), idx_t, bags_t, ctx.n_rows), None, None, None


torch.library.register_autograd("repro_torch::embedding_bag_sorted", _backward, setup_context=_setup_backward)


def embedding_bag_sorted_grad(
    table: torch.Tensor, idx: torch.Tensor, bags: torch.Tensor, n_bags: int, transpose=None
) -> torch.Tensor:
    """:func:`embedding_bag_sorted`, whose backward takes its lookups from
    ``transpose``, a callable giving (``idx_T``, ``bags_T``) called in the
    backward, so that a caller can share one sort between calls or know
    the transpose without one (default: :func:`transpose_lookups` of
    ``idx`` and ``bags``).  A table that needs no gradient, or a call
    under ``no_grad``, records nothing: a serve step launches what it
    launched before."""
    out = embedding_bag_sorted(table, idx, bags, n_bags)
    if transpose is not None and out.grad_fn is not None:
        out.grad_fn.transpose = transpose
    return out
