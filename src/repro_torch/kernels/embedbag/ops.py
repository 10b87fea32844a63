"""EmbeddingBag and the GNN scatter on the fused kernel.

Port of ``repro/kernels/embedbag/ops.py``.  Each wrapper sorts its
lookups by bag (destination) with a stable sort on the tensors' device,
runs :func:`~repro_torch.kernels.embedbag.embedbag.embedding_bag_sorted`
(kernel B6 on the GPU, its plain version on the CPU) and zeroes the bags
no lookup visits, as ``repro`` does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedbag.embedbag import embedding_bag_sorted


def _visited_only(out: torch.Tensor, bags: torch.Tensor, n_bags: int) -> torch.Tensor:
    visited = torch.zeros(n_bags, dtype=torch.bool, device=out.device)
    visited[bags.long()] = True
    return torch.where(visited[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def embedding_bag(
    table: torch.Tensor, idx: torch.Tensor, bags: torch.Tensor, n_bags: int
) -> torch.Tensor:
    """EmbeddingBag (sum) over possibly unsorted lookups: (n_bags, D) in
    the table's dtype, empty bags zero.  ``idx`` and ``bags`` are (N,)
    int32 on the table's device."""
    sorted_bags, order = torch.sort(bags, stable=True)
    out = embedding_bag_sorted(table, idx[order], sorted_bags, n_bags)
    return _visited_only(out, bags, n_bags)


def gnn_aggregate(
    messages_table: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor, n_nodes: int
) -> torch.Tensor:
    """GNN scatter: ``out[v] = Σ messages_table[u]`` over the edges
    (u, v), one fused pass over the edges sorted by destination."""
    sorted_dst, order = torch.sort(edge_dst, stable=True)
    out = embedding_bag_sorted(messages_table, edge_src[order], sorted_dst, n_nodes)
    return _visited_only(out, edge_dst, n_nodes)
