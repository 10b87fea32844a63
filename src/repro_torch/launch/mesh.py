"""The production layouts, described, and the test mesh of ranks.

Port of ``repro/launch/mesh.py``.  ``repro`` builds a ``jax`` mesh of
forced host devices.  The production layouts stay descriptions here: a
:class:`MeshLayout` holds axis names and a ``shape`` mapping of axis
sizes, which is all ``dist/sharding.py``'s ``Rules.from_mesh`` and
``fit_spec`` read.  :func:`make_test_mesh` builds a ``torch.distributed``
``DeviceMesh`` of ranks when a process group is up (one process per
rank, :mod:`repro_torch.launch.ranks`), which ``use_mesh`` installs and
the mesh programs run on; without one it describes the layout.
:func:`fake_mesh` builds a layout's ``DeviceMesh`` in one process over
a ``fake`` process group of all its ranks, whose collectives return at
once and move nothing: the dry run counts rank 0's program on it.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fake_mesh(layout: MeshLayout, rank: int = 0):
    """The ``DeviceMesh`` of ``layout`` (on the CPU device type) over a
    ``fake`` process group of ``layout.size`` ranks in this process, as
    ``rank``: collectives on it, meta tensors' included, return without
    moving anything.  The group is destroyed when the block ends.  Raises
    when a process group is already up, or when ``torch.distributed``
    cannot register the ``fake`` backend."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available: the dry run needs its fake backend")
    if dist.is_initialized():
        raise RuntimeError("a process group is already up: the dry run's fake group needs a process of its own")
    # registers the "fake" c10d backend; torch ships it with its tests
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=layout.size)
    try:
        yield init_device_mesh("cpu", layout.sizes, mesh_dim_names=layout.axis_names)
    finally:
        dist.destroy_process_group()
