"""PyTorch and CUDA port of ``repro`` for an NVIDIA H100.

The package mirrors ``src/repro/`` file for file; each module's docstring
names the ``repro`` file it ports.  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``: where it needs one of ``repro``'s
numpy modules it keeps its own copy.

Entry points take ``device=None``, which means the GPU.  Without a GPU
they raise unless the caller passes ``device="cpu"``; they never carry on
quietly on the CPU.  On a CPU tensor every kernel wrapper runs its plain
PyTorch version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``, and
    raises when no GPU is present (pass ``device="cpu"`` to run on the
    CPU on purpose)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
