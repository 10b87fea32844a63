"""The production layouts, described, and the test mesh of ranks.

Port of ``repro/launch/mesh.py``.  ``repro`` builds a ``jax`` mesh of
forced host devices.  The production layouts stay descriptions here: a
:class:`MeshLayout` holds axis names and a ``shape`` mapping of axis
sizes, which is all ``dist/sharding.py``'s ``Rules.from_mesh`` and
``fit_spec`` read.  :func:`make_test_mesh` builds a ``torch.distributed``
``DeviceMesh`` of ranks when a process group is up (one process per
rank, :mod:`repro_torch.launch.ranks`), which ``use_mesh`` installs and
the mesh programs run on; without one it describes the layout.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A device layout with no devices: ``axis_names`` in order and
    ``shape``, the size of each axis by name (as ``jax``'s ``Mesh``)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The layout's device count."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """Single-pod (16, 16) = 256 devices, or 2-pod (2, 16, 16) = 512.

    ``pod`` is the outer data-parallel axis; ``data`` carries batch, site
    and ZeRO sharding; ``model`` carries tensor, expert and KV-sequence
    parallelism."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def make_test_mesh(n_data: int = 1, n_model: int = 1, device: str | torch.device | None = None):
    """A small (data, model) mesh: with a process group up, the
    ``DeviceMesh`` of its ``n_data · n_model`` ranks (rank ``d · n_model +
    m`` at (d, m)) on ``device``'s type (``None``: the GPU); otherwise the
    :class:`MeshLayout` that describes it."""
    if not (dist.is_available() and dist.is_initialized()):
        return MeshLayout(("data", "model"), (n_data, n_model))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))
