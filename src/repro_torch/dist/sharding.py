"""Declarative sharding rules and the active-mesh context.

Port of ``repro/dist/sharding.py``.  :class:`Rules` is plain data: a
table of ``name pattern -> placement`` rules (fnmatch wildcards, first
match wins, ``"*"`` the replicated fallback) derived from a layout's axis
names and sizes, with the named accessors (``act_btd()``,
``p_attn_in()``, ``kv_cache()``, ...) as thin lookups into it.  A
placement is a tuple with one entry per dimension: ``None``
(replicated), an axis name, or a tuple of axis names; ``repro``'s
``PartitionSpec`` entries, as a plain tuple.

``None`` is the one-card mesh: :func:`get_mesh` returns it until
:func:`use_mesh` installs a ``torch.distributed`` ``DeviceMesh`` of
ranks (``repro_torch.launch.mesh.make_test_mesh`` under a process
group), and ``Rules.from_mesh(None)`` is the one-card rule set, every
placement replicated once fitted.  :func:`constrain` stays the
identity, as ``repro``'s is off-mesh: the port's mesh programs run per
rank on local shards with explicit collectives
(:mod:`repro_torch.dist.collectives`), and nothing places a tensor by
its rule.  ``Rules.from_mesh`` and :func:`fit_spec` read a
``DeviceMesh`` (``mesh_dim_names`` and sizes) or a described layout
(anything with ``axis_names`` and a ``shape`` mapping, as ``repro``'s
``Mesh`` has, such as ``launch.mesh.MeshLayout``) alike, so placements
are resolved and fitted as ``repro`` resolves them.  ``repro``'s
``dist/compat.py`` is JAX version shims and has no twin.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import fnmatch
from typing import Mapping

_BATCH_AXIS_NAMES = ("pod", "data")
_MODEL_AXIS_NAME = "model"

Placement = tuple  # one entry per dimension: None, an axis name, or a tuple of names


# --------------------------------------------------------------------------
# Active mesh context
# --------------------------------------------------------------------------


_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` of ranks (it names its axes
    in ``mesh_dim_names``), not ``None`` or a described layout."""
    return mesh is not None and hasattr(mesh, "mesh_dim_names")


def get_mesh():
    """The active mesh: the ``DeviceMesh`` :func:`use_mesh` installed, or
    ``None`` (one card)."""
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` (a ``DeviceMesh``, or ``None`` for one card) as
    the ambient mesh for the block.  A described layout holds no devices
    and raises."""
    if mesh is not None and not is_device_mesh(mesh):
        raise NotImplementedError(
            f"{type(mesh).__name__} describes a layout and holds no devices: the multi-GPU "
            "programs run on a DeviceMesh of ranks (launch.mesh.make_test_mesh under a "
            "process group)"
        )
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


# --------------------------------------------------------------------------
# Spec fitting
# --------------------------------------------------------------------------


def _entry_names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _fit_entry(axis_sizes: Mapping[str, int], entry, dim: int):
    """Fit one entry to one dimension: drop axes the layout lacks, then
    degrade (innermost first) until the shard count divides the
    dimension; a fully non-divisible entry degrades to replicated."""
    names = [n for n in _entry_names(entry) if n in axis_sizes]
    while names:
        size = 1
        for n in names:
            size *= axis_sizes[n]
        if size <= max(dim, 0) and dim % size == 0:
            break
        names.pop()
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def _fit(axis_sizes: Mapping[str, int], spec, shape) -> Placement:
    entries = list(tuple(spec)) if spec is not None else []
    entries = entries[: len(shape)] + [None] * (len(shape) - len(entries))
    return tuple(_fit_entry(axis_sizes, e, d) for e, d in zip(entries, shape))


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of a described layout."""
    if is_device_mesh(mesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or of a described layout."""
    if is_device_mesh(mesh):
        return {n: int(k) for n, k in zip(mesh.mesh_dim_names, mesh.shape)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def fit_spec(mesh, spec, shape) -> Placement:
    """Fit ``spec`` to a concrete ``shape`` on ``mesh``: pad or truncate
    to the rank and degrade non-divisible dims to replicated."""
    if mesh is None:
        return (None,) * len(shape)
    return _fit(mesh_sizes(mesh), spec, shape)


def is_placement(x) -> bool:
    """Whether ``x`` is one placement (a tuple of ``None``, axis names and
    tuples of names), not a container of them."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def placement_leaves(tree) -> list:
    """A tree of placements' leaves (placements, or ``None``) in ``jax``'s
    leaf order: a dictionary's keys sorted, a list's or a container
    tuple's items in order."""
    if tree is None or is_placement(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in placement_leaves(tree[k])]
    return [x for v in tree for x in placement_leaves(v)]


def constrain(x, rule):
    """A sharding constraint: the identity.  ``repro``'s is a GSPMD hint
    (the identity off-mesh); the port's mesh programs hold local shards
    and place nothing by rule."""
    return x


# --------------------------------------------------------------------------
# Rules
# --------------------------------------------------------------------------


def _default_table(batch, model, flat) -> tuple[tuple[str, Placement], ...]:
    """The built-in name -> placement table of ``repro``, entry for entry.

    ``batch`` is the batch entry (axis name, tuple of names, or None),
    ``model`` the tensor-parallel axis (or None), ``flat`` every axis
    flattened (edge and site sharding).  First match wins; ``"*"`` is the
    replicated fallback.
    """
    return (
        # -- activations ----------------------------------------------------
        ("act/btd", (batch, None, None)),
        ("act/bthd", (batch, None, model, None)),
        ("act/ffn", (batch, None, model)),
        ("act/logits", (batch, None, model)),
        # -- stacked per-layer LM params (leading layer dim) ----------------
        ("params/*/attn/w[qkv]", (None, None, model)),
        ("params/*/attn/wo", (None, model, None)),
        ("params/*/mlp/w_gate", (None, None, model)),
        ("params/*/mlp/w_up", (None, None, model)),
        ("params/*/mlp/w_down", (None, model, None)),
        ("params/*/moe/router", (None, None, None)),
        ("params/*/moe/w*", (None, model, None, None)),
        ("params/embed", (model, None)),
        ("params/lm_head", (None, model)),
        # -- embedding tables (DLRM row sharding) ---------------------------
        ("params/table_rows", (model, None)),
        # -- KV cache (leading layer dim) -----------------------------------
        ("cache/kv", (None, batch, None, None, None)),
        ("cache/kv_seq", (None, batch, model, None, None)),
        # -- graph edges: sites = every axis, flattened ---------------------
        ("edges", (flat,)),
        # -- fallback -------------------------------------------------------
        ("*", ()),
    )


@dataclasses.dataclass(frozen=True)
class Rules:
    """Sharding rules for one layout.

    ``batch_axes`` are the data-parallel axes (``pod``/``data``, the
    paper's sites); ``model_axis`` is the tensor- and expert-parallel
    axis.  ``table`` maps name patterns to placements; :meth:`spec`
    resolves a name through it with wildcard matching and the ``"*"``
    fallback.
    """

    batch_axes: tuple[str, ...]
    model_axis: str | None
    axis_sizes: Mapping[str, int]
    table: tuple[tuple[str, Placement], ...]

    @classmethod
    def from_mesh(cls, mesh, overrides: Mapping[str, Placement] | None = None) -> "Rules":
        """Rules from a layout's axis names (``None``: one card, every
        placement replicated once fitted).  ``overrides`` prepends
        ``pattern -> placement`` rules that win over the built-in table."""
        if mesh is None:
            batch_axes: tuple[str, ...] = ()
            model_axis = None
            axis_sizes: dict[str, int] = {}
        else:
            names = axis_names(mesh)
            batch_axes = tuple(n for n in names if n in _BATCH_AXIS_NAMES)
            model_axis = _MODEL_AXIS_NAME if _MODEL_AXIS_NAME in names else None
            axis_sizes = mesh_sizes(mesh)
        # one axis is its name, as a PartitionSpec normalises a 1-tuple
        flat = _entry(tuple(batch_axes) + ((model_axis,) if model_axis else ()))
        table = _default_table(_entry(batch_axes), model_axis, flat)
        if overrides:
            table = tuple(overrides.items()) + table
        return cls(batch_axes, model_axis, axis_sizes, table)

    # -- core lookup -------------------------------------------------------

    def spec(self, name: str, shape=None) -> Placement:
        """Resolve ``name`` through the table (first fnmatch wins); with
        ``shape``, fit the result to it."""
        for pattern, spec in self.table:
            if fnmatch.fnmatchcase(name, pattern):
                return self.fit(spec, shape) if shape is not None else spec
        return ()

    def fit(self, spec, shape) -> Placement:
        """Fit a placement to a shape (degrade non-divisible dims; pad rank)."""
        return _fit(self.axis_sizes, spec, shape)

    def spec_divisor(self, spec, dim: int) -> int:
        """Shard count of dimension ``dim`` under ``spec`` (1 if unsharded)."""
        entries = tuple(spec)
        entry = entries[dim] if dim < len(entries) else None
        size = 1
        for n in _entry_names(entry):
            size *= self.axis_sizes.get(n, 1)
        return size

    # -- derived axis facts --------------------------------------------------

    @property
    def batch(self):
        """The batch-dim entry: one axis name, a tuple, or None."""
        return _entry(self.batch_axes)

    @property
    def model_size(self) -> int:
        """Shard count of the model axis (0 without one)."""
        if self.model_axis is None:
            return 0
        return self.axis_sizes.get(self.model_axis, 0)

    # -- named accessors (thin table lookups) --------------------------------

    def act_btd(self) -> Placement:
        return self.spec("act/btd")

    def act_bthd(self) -> Placement:
        return self.spec("act/bthd")

    def act_ffn(self) -> Placement:
        return self.spec("act/ffn")

    def logits(self) -> Placement:
        return self.spec("act/logits")

    def p_attn_in(self) -> Placement:
        return self.spec("params/layers/attn/wq")

    def p_attn_out(self) -> Placement:
        return self.spec("params/layers/attn/wo")

    def p_mlp_in(self) -> Placement:
        return self.spec("params/layers/mlp/w_gate")

    def p_mlp_out(self) -> Placement:
        return self.spec("params/layers/mlp/w_down")

    def p_moe_experts(self) -> Placement:
        return self.spec("params/layers/moe/w_gate")

    def p_router(self) -> Placement:
        return self.spec("params/layers/moe/router")

    def p_embed(self) -> Placement:
        return self.spec("params/embed")

    def p_lm_head(self) -> Placement:
        return self.spec("params/lm_head")

    def p_table_rows(self) -> Placement:
        return self.spec("params/table_rows")

    def kv_cache(self) -> Placement:
        return self.spec("cache/kv")

    def kv_cache_seq_sharded(self) -> Placement:
        return self.spec("cache/kv_seq")

    def edges(self) -> Placement:
        return self.spec("edges")


def _entry(axes: tuple[str, ...]):
    """A placement entry over ``axes``: None, one name, or a tuple."""
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)
