"""The production layouts, described.

Port of ``repro/launch/mesh.py``.  ``repro`` builds a ``jax`` mesh of
forced host devices; the port runs on one card and has no devices to
place, so a layout is a :class:`MeshLayout`: axis names and a ``shape``
mapping of axis sizes, which is all ``dist/sharding.py``'s
``Rules.from_mesh`` and ``fit_spec`` read.  ``use_mesh`` still refuses
one: placing tensors on several cards is ROADMAP's multi-GPU item.
"""

from __future__ import annotations

import dataclasses
import math


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


def make_test_mesh(n_data: int = 1, n_model: int = 1) -> MeshLayout:
    """A small (data, model) layout."""
    return MeshLayout(("data", "model"), (n_data, n_model))
