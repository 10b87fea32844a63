"""Declarative sharding rules and the active-mesh context.

Port of ``repro/dist/sharding.py``.  :class:`Rules` is plain data: a
table of ``name pattern -> placement`` rules (fnmatch wildcards, first
match wins, ``"*"`` the replicated fallback) derived from a layout's axis
names and sizes, with the named accessors (``act_btd()``,
``p_attn_in()``, ``kv_cache()``, ...) as thin lookups into it.  A
placement is a tuple with one entry per dimension: ``None``
(replicated), an axis name, or a tuple of axis names; ``repro``'s
``PartitionSpec`` entries, as a plain tuple.

The port runs on one card.  :func:`get_mesh` is ``None`` there,
:func:`constrain` is the identity (as ``repro``'s is off-mesh), and
``Rules.from_mesh(None)`` is the one-card rule set, every placement
replicated once fitted.  A layout of several devices is only described:
``Rules.from_mesh`` takes anything with ``axis_names`` and a ``shape``
mapping of axis sizes (as ``repro``'s ``Mesh`` has), so placements can
be resolved and fitted as ``repro`` resolves them, but
:func:`use_mesh` refuses one: placing tensors on several cards is
ROADMAP's multi-GPU item.  ``repro``'s ``dist/compat.py`` is JAX version
shims and has no twin.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
from typing import Mapping

_BATCH_AXIS_NAMES = ("pod", "data")
_MODEL_AXIS_NAME = "model"

Placement = tuple  # one entry per dimension: None, an axis name, or a tuple of names


# --------------------------------------------------------------------------
# Active mesh context
# --------------------------------------------------------------------------


def get_mesh():
    """The active mesh: always None, since :func:`use_mesh` installs none
    but the one-card ``None``."""
    return None


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the ambient mesh.  ``None`` (one card) is the
    only one the port runs on; any other raises."""
    if mesh is not None:
        raise NotImplementedError(
            "the port runs on one card: placing tensors on a mesh of several is "
            "ROADMAP's multi-GPU item"
        )
    yield mesh


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


def _sizes(mesh) -> dict[str, int]:
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def fit_spec(mesh, spec, shape) -> Placement:
    """Fit ``spec`` to a concrete ``shape`` on ``mesh``: pad or truncate
    to the rank and degrade non-divisible dims to replicated."""
    if mesh is None:
        return (None,) * len(shape)
    return _fit(_sizes(mesh), spec, shape)


def constrain(x, rule):
    """A sharding constraint: the identity off-mesh, as ``repro``'s, and
    the port is always off-mesh."""
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
            names = tuple(mesh.axis_names)
            batch_axes = tuple(n for n in names if n in _BATCH_AXIS_NAMES)
            model_axis = _MODEL_AXIS_NAME if _MODEL_AXIS_NAME in names else None
            axis_sizes = _sizes(mesh)
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
