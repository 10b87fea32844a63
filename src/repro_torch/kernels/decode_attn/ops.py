"""Decode attention on the flash-decode kernel.

Port of ``repro/kernels/decode_attn/ops.py``: the entry point over
:func:`~repro_torch.kernels.decode_attn.decode_attn.flash_decode_gqa`
(kernel B7 on the GPU, its plain version on the CPU).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn.decode_attn import flash_decode_gqa


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor, block_kv: int = 512
) -> torch.Tensor:
    """GQA decode attention: q (B, H, Dh) against the cache k, v (B, S, G,
    Dh) up to ``kv_len`` (a () int32 tensor on q's device); (B, H, Dh)."""
    return flash_decode_gqa(q, k, v, kv_len, block_kv=block_kv)
