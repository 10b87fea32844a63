"""Gradient compression for the data-parallel all-reduce.

Port of ``repro/training/compression.py``: per-tensor symmetric int8
quantization with *error feedback* (the residual carried across steps,
Seide et al. '14 / Karimireddy et al. '19).  ``compress`` and
``decompress`` serve the checkpoint-size and unit-test paths;
``compressed_psum`` sums over an axis of devices and waits for the
multi-GPU item.
"""

from __future__ import annotations

import torch

from repro_torch.training.tree import tree_map


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: (q, scale), scale a ()
    f32 tensor."""
    scale = torch.clamp(torch.max(torch.abs(g)).float(), min=1e-12) / 127.0
    q = torch.clip(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, axis: str):
    """``repro``'s error-feedback int8 psum over a mesh axis.  It needs an
    axis of devices: ROADMAP's multi-GPU item ports it over
    ``torch.distributed``; here it raises."""
    raise NotImplementedError(
        f"compressed_psum sums over the device axis {axis!r}: ROADMAP's multi-GPU item; "
        "the port trains on one card"
    )


def init_residuals(params):
    """A zero f32 residual for each parameter leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
