"""Plain oracle for flash-decode GQA attention.

Port of ``repro/kernels/decode_attn/ref.py``: one softmax over the whole
masked score row, in the inputs' dtype where ``repro``'s is.
"""

from __future__ import annotations

import math

import torch


def decode_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int | torch.Tensor
) -> torch.Tensor:
    """q: (B, H, Dh); k, v: (B, S, G, Dh); returns (B, H, Dh).  Positions
    at or past ``kv_len`` score -1e30."""
    b, h, dh = q.shape
    _, s, g, _ = k.shape
    qr = q.reshape(b, g, h // g, dh)
    scores = torch.einsum("bgrd,bsgd->bgrs", qr, k).float() * (1.0 / math.sqrt(dh))
    mask = torch.arange(s, device=q.device) < torch.as_tensor(kv_len, device=q.device)
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p.to(v.dtype), v)
    return out.reshape(b, h, dh)
