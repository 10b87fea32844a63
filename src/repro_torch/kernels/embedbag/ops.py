"""EmbeddingBag and the GNN scatter on the fused kernel.

Port of ``repro/kernels/embedbag/ops.py``.  Each wrapper sorts its
lookups by bag (destination) with a stable sort on the tensors' device
and runs :func:`~repro_torch.kernels.embedbag.embedbag.embedding_bag_sorted`
(kernel B6 on the GPU, its plain version on the CPU), which sums each
bag in that order in the table's dtype, rounding a bf16 sum after every
lookup as ``repro`` does, and writes zeros to the bags no lookup visits,
which ``repro``'s wrappers zero.  Both are differentiable in the table
(``embedding_bag_sorted_grad``): the backward is B6 over the lookups
sorted stably by row, from one more sort of the unsorted rows, so each
row adds its cotangents in lookup order, as the transpose of
``jnp.take`` does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedbag.embedbag import embedding_bag_sorted_grad, transpose_lookups


def embedding_bag(
    table: torch.Tensor, idx: torch.Tensor, bags: torch.Tensor, n_bags: int
) -> torch.Tensor:
    """EmbeddingBag (sum) over possibly unsorted lookups: (n_bags, D) in
    the table's dtype, empty bags zero.  ``idx`` and ``bags`` are (N,)
    int32 on the table's device."""
    sorted_bags, order = torch.sort(bags, stable=True)
    return embedding_bag_sorted_grad(
        table, idx[order], sorted_bags, n_bags, lambda: transpose_lookups(idx, bags)
    )


def gnn_aggregate(
    messages_table: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor, n_nodes: int
) -> torch.Tensor:
    """GNN scatter: ``out[v] = Σ messages_table[u]`` over the edges
    (u, v), one fused pass over the edges sorted by destination: the
    EmbeddingBag with the sources as rows and the destinations as bags."""
    return embedding_bag(messages_table, edge_src, edge_dst, n_nodes)
