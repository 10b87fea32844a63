"""Gradient compression for the data-parallel all-reduce.

Port of ``repro/training/compression.py``: per-tensor symmetric int8
quantization with *error feedback* (the residual carried across steps,
Seide et al. '14 / Karimireddy et al. '19).  ``compress`` and
``decompress`` serve the checkpoint-size and unit-test paths;
``compressed_psum`` is the error-feedback mean over an axis of ranks
(``torch.distributed``, on the installed mesh).
"""

from __future__ import annotations

import torch

from repro_torch.dist import collectives
from repro_torch.training.tree import tree_map


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: (q, scale), scale a ()
    f32 tensor."""
    scale = torch.clamp(torch.max(torch.abs(g)).float(), min=1e-12) / 127.0
    q = torch.clip(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, axis, mesh=None):
    """``repro``'s error-feedback int8 psum over the mesh axis ``axis``,
    run by each rank of the installed mesh (or ``mesh``): the rank's
    gradient plus its residual quantized (:func:`compress`), the
    dequantized tensor's bf16 payload summed over the axis
    (``collectives.psum``) and divided by the axis's size.  Returns (the
    f32 mean, the rank's new residual: what quantization lost)."""
    g_fb = g.float() + residual
    q, scale = compress(g_fb)
    new_residual = g_fb - decompress(q, scale)
    summed = collectives.psum(decompress(q, scale).to(torch.bfloat16), axis, mesh)
    n = collectives.psum(torch.ones((), dtype=torch.float32, device=g.device), axis, mesh)
    return summed.float() / n, new_residual


def init_residuals(params):
    """A zero f32 residual for each parameter leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
