"""The fused EmbeddingBag: a gather plus a segment sum over lookups
sorted by bag.

Port of ``repro/kernels/embedbag/embedbag.py::embedding_bag_sorted``
(kernel B6).  ``repro``'s Pallas grid takes one lookup per step, DMAs
the table row in and adds it into the output row of its bag, zeroing a
bag at its first lookup and accumulating in the table's dtype.  Here, on
a CUDA tensor, :func:`embedding_bag_sorted` launches the hand-written
kernel of ``csrc/embedbag.cu``: one warp per (bag, 128-column chunk),
which finds its run of lookups from bag offsets computed on the device
(``torch.searchsorted``, no host sync), sums the rows in sorted order in
f32 and rounds once to the table's dtype.  Every bag is written, empty
ones as zeros.  On a CPU tensor it runs :func:`embedding_bag_sorted_plain`,
which adds the rows in the same order in f32; there is no fallback from
the one to the other.

f32 tables equal the plain version bit for bit (the same f32 additions
in the same order), and so do bags of one lookup in any dtype.  On bf16
tables the port rounds once where ``repro`` rounds after every lookup.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # B6: embedding_bag_sorted

# lookups gathered at once by the plain version: bounds its transient
# (chunk, D) rows
PLAIN_CHUNK = 1 << 22

_DTYPES = {torch.float32: "embedding_bag_f32", torch.bfloat16: "embedding_bag_bf16"}


def bag_offsets(bags: torch.Tensor, n_bags: int) -> torch.Tensor:
    """(n_bags + 1,) int32: lookups ``offsets[b] .. offsets[b+1]`` of a
    non-decreasing ``bags`` are bag ``b``'s, found on the device."""
    values = torch.arange(n_bags + 1, dtype=bags.dtype, device=bags.device)
    return torch.searchsorted(bags, values, out_int32=True)


def embedding_bag_sorted_plain(
    table: torch.Tensor, idx: torch.Tensor, bags: torch.Tensor, n_bags: int
) -> torch.Tensor:
    """:func:`embedding_bag_sorted` in plain PyTorch: the lookups are taken
    rank by rank (rank = position inside the bag), so each ``index_add_``
    adds at most one row to a bag and every bag sums its rows in sorted
    order in f32, as the kernel does; then one rounding to the table's
    dtype.  Gathers at most :data:`PLAIN_CHUNK` rows at once."""
    n, d = idx.shape[0], table.shape[1]
    acc = torch.zeros((n_bags, d), dtype=torch.float32, device=table.device)
    if n:
        bags64 = bags.long()
        rank = torch.arange(n, device=bags.device) - bag_offsets(bags, n_bags)[bags64]
        order = torch.argsort(rank, stable=True)
        lo = 0
        for count in torch.bincount(rank).tolist():
            for start in range(lo, lo + count, PLAIN_CHUNK):
                sel = order[start : min(start + PLAIN_CHUNK, lo + count)]
                acc.index_add_(0, bags64[sel], table[idx[sel].long()].float())
            lo += count
    return acc.to(table.dtype)


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


def embedding_bag_sorted(
    table: torch.Tensor,  # (R, D) float32 or bfloat16
    idx: torch.Tensor,  # (N,) int32 — row per lookup, lookups sorted by bag
    bags: torch.Tensor,  # (N,) int32 — non-decreasing bag ids in [0, n_bags)
    n_bags: int,
) -> torch.Tensor:
    """(n_bags, D) bag sums in the table's dtype.  Bags no lookup visits
    are zero, where ``repro``'s kernel leaves them unwritten.  On CPU
    tensors this is :func:`embedding_bag_sorted_plain`; on CUDA tensors
    it launches B6 or raises."""
    global LAUNCHES
    if table.device.type == "cpu":
        return embedding_bag_sorted_plain(table, idx, bags, n_bags)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag_sorted runs on cuda or cpu tensors, got {table.device}")
    _check(table, idx, bags)
    d = table.shape[1]
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    if n_bags == 0 or d == 0:
        return out
    offsets = bag_offsets(bags, n_bags)
    fn = getattr(_build.load("embedbag"), _DTYPES[table.dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(table.device):
        err = fn(
            table.data_ptr(), idx.data_ptr(), offsets.data_ptr(), out.data_ptr(), n_bags, d,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{_DTYPES[table.dtype]} launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out
