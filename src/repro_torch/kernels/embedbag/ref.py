"""Plain oracle for the EmbeddingBag kernel.

Port of ``repro/kernels/embedbag/ref.py``: gather, then a segment sum
(``index_add_``) in the table's dtype.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(
    table: torch.Tensor, idx: torch.Tensor, bags: torch.Tensor, n_bags: int
) -> torch.Tensor:
    """``out[b] = Σ table[idx[i]]`` over the lookups ``i`` of bag ``b``:
    (n_bags, D) in the table's dtype, empty bags zero."""
    rows = table[idx.long()]
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype, device=table.device)
    return out.index_add_(0, bags.long(), rows)
