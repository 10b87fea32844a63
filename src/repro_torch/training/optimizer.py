"""Optimizers in plain PyTorch.

Port of ``repro/training/optimizer.py``:

* :func:`adamw` — AdamW with decoupled weight decay and f32 moments;
  the default for the dense LMs, the GNNs and DLRM.
* :func:`adafactor` — factored second moments (Shazeer & Stern, 2018)
  over the last two dimensions of each leaf of rank 2 or more, with
  update clipping; kimi-k2's optimizer.
* :func:`state_spec_for` and :func:`zero_sharding` — the placements of
  the optimizer state, as the port's placement tuples
  (``dist/sharding.py``); plain data, equal to ``repro``'s specs.
* :func:`on_ranks` — either optimizer as a rank of the installed mesh
  runs it (:class:`RankOptimizer`): the gradients reduced over the axes
  on which the rank's work differs; AdamW with ZeRO-1 (each rank holds
  its block of ``m`` and ``v`` over the data axis where
  :func:`zero_sharding` places one, reduces the gradient onto that block
  with a ``psum_scatter``, updates its block of the parameter and
  ``all_gather``-s the blocks back: element by element, so bit for bit
  the replicated update); Adafactor's means and its RMS clip summed over
  the ranks a leaf is sharded on.  ``repro`` gets there from the train
  cells' shardings (``launch/cells.py:59–71``) and GSPMD.

API as ``repro``'s: ``opt = adamw(lr=...); state = opt.init(params);
new_params, new_state = opt.update(params, grads, state)``.  The state
mirrors ``repro``'s tree (``{"m", "v", "step"}``, ``{"f", "step"}``),
``step`` a () int32 tensor.  The update follows the PyTorch idiom: it
runs under ``torch.no_grad()`` and writes the parameters and the moments
in place (the returned trees hold the same tensors), so a step needs no
second copy of the state; ``repro``'s is functional.  The arithmetic is
``repro``'s, in f32, each leaf cast back to its dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.training.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]
    state_spec: Callable[[Any], Any]  # param placement tree -> state placement tree


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    first = leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def map_specs(fn, specs, *others):
    """``fn`` over a placement tree whose leaves are tuples (or None),
    with the matching leaves of ``others``; dictionaries and lists are
    its containers."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(o[k] for o in others)) for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(o[i] for o in others)) for i, v in enumerate(specs)]
    return fn(specs, *others)


def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params), "v": tree_map(_zeros_f32, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"] + 1
        t = step.float()
        bc1 = 1.0 - torch.pow(_f32(b1, t), t)
        bc2 = 1.0 - torch.pow(_f32(b2, t), t)
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]), leaves(state["v"])):
            g32 = g.float()
            m.copy_(b1 * m + (1.0 - b1) * g32)
            v.copy_(b2 * v + (1.0 - b2) * torch.square(g32))
            p32 = p.float()
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
            p.copy_((p32 - lr * upd).to(p.dtype))
        return params, {"m": state["m"], "v": state["v"], "step": step}

    def state_spec(param_specs):
        return {"m": param_specs, "v": map_specs(lambda s: s, param_specs), "step": ()}

    return Optimizer(init, update, state_spec)


def adafactor(
    lr: float = 1e-3,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
) -> Optimizer:
    """Factored AdaFactor: leaves of rank 2 or more keep per-row and
    per-column second-moment vectors (factored over the last two
    dimensions); leaves of lower rank keep the full v."""

    def _factored(p) -> bool:
        return p.dim() >= 2

    def init(params):
        def leaf_state(p):
            if _factored(p):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),  # row stats
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device),
                }
            return {"v": _zeros_f32(p)}

        return {"f": tree_map(leaf_state, params), "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state, placements=None, mesh=None):
        """``placements``: on a mesh, the placement of each leaf's block in
        leaf order (:class:`RankOptimizer`), whose sharded dimensions the
        means and the RMS sum over; ``None``: whole leaves."""
        step = state["step"] + 1
        t = step.float()
        beta2t = 1.0 - torch.pow(t, -decay)
        places = placements or [()] * len(leaves(params))
        for p, g, s, place in zip(leaves(params), leaves(grads), _param_states(params, state["f"]), places):
            ent = tuple(place) + (None,) * (p.dim() - len(tuple(place)))
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if _factored(p):
                s["vr"].copy_(beta2t * s["vr"] + (1 - beta2t) * _mean(g2, -1, ent[-1], mesh))
                s["vc"].copy_(beta2t * s["vc"] + (1 - beta2t) * _mean(g2, -2, ent[-2], mesh))
                denom = _mean(s["vr"], -1, ent[-2], mesh, keepdim=True)
                rhat = (s["vr"] / torch.clamp(denom, min=eps))[..., None]
                u = g32 / (torch.sqrt(rhat * s["vc"][..., None, :]) + eps)
            else:
                s["v"].copy_(beta2t * s["v"] + (1 - beta2t) * g2)
                u = g32 / (torch.sqrt(s["v"]) + eps)
            # update clipping (RMS <= clip_threshold), over the whole leaf
            rms = torch.sqrt(_mean_all(torch.square(u), ent, mesh) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p.copy_((p.float() - lr * u).to(p.dtype))
        return params, {"f": state["f"], "step": step}

    def state_spec(param_specs):
        def leaf_spec(spec):
            spec = spec if isinstance(spec, tuple) else ()
            row = spec[:-1] if len(spec) >= 1 else ()
            col = spec[:-2] + spec[-1:] if len(spec) >= 2 else ()
            return {"vr": row, "vc": col, "v_maybe": None}

        # shape-dependent: callers resolve it with state_spec_for(params)
        return {"f": map_specs(leaf_spec, param_specs), "step": ()}

    return Optimizer(init, update, state_spec)


def _sharded_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _mean(x: torch.Tensor, dim: int, entry, mesh, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` of a leaf whose dimension ``dim`` is the rank's
    block over the axes of ``entry`` (``None``: whole): the rank's sum,
    ``psum``-ed over those axes, over the whole length."""
    axes = _sharded_axes(entry)
    if not axes:
        return x.mean(dim=dim, keepdim=keepdim)
    n = x.shape[dim] * collectives.axis_size(mesh, axes)
    return collectives.psum(x.sum(dim=dim, keepdim=keepdim), axes, mesh) / n


def _mean_all(x: torch.Tensor, entries, mesh) -> torch.Tensor:
    """The mean of every element of a leaf held as the rank's block under
    ``entries``."""
    axes = tuple(dict.fromkeys(a for e in entries for a in _sharded_axes(e)))
    if not axes:
        return torch.mean(x)
    n = x.numel() * collectives.axis_size(mesh, axes)
    return collectives.psum(torch.sum(x), axes, mesh) / n


def _param_states(params, f) -> list[dict]:
    """The per-leaf state dictionaries of ``f`` in the parameters' leaf
    order: ``f`` is ``params``' tree with a dictionary at each leaf."""
    out = []

    def walk(p, s):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], s[k])
        elif isinstance(p, (list, tuple)):
            for a, b in zip(p, s):
                walk(a, b)
        else:
            out.append(s)

    walk(params, f)
    return out


def state_spec_for(opt_name: str, param_shapes, param_specs):
    """Resolve the optimizer state's placements given the parameters'
    shapes (tensors, meta tensors, or anything with ``shape``) and
    placements; adafactor's state structure depends on the shapes."""
    if opt_name == "adamw":
        return {"m": param_specs, "v": map_specs(lambda s: s, param_specs), "step": ()}
    if opt_name == "adafactor":
        def leaf(spec, shape_leaf):
            spec = spec if isinstance(spec, tuple) else ()
            ndim = len(shape_leaf.shape)
            padded = tuple(spec) + (None,) * (ndim - len(spec))
            if ndim >= 2:
                return {"vr": padded[:-1], "vc": padded[:-2] + padded[-1:]}
            return {"v": padded}

        return {"f": map_specs(leaf, param_specs, param_shapes), "step": ()}
    raise ValueError(opt_name)


def get(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise ValueError(name)


def zero_sharding(spec: tuple, shape: tuple[int, ...], data_axis: str = "data", data_size: int = 16) -> tuple:
    """ZeRO-1: additionally place a moment tensor over the data axis on
    its first dimension that is (a) unplaced and (b) divisible by the
    axis.  Falls back to the original placement when nothing divides."""
    entries = list(spec) + [None] * (len(shape) - len(tuple(spec)))
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and dim % data_size == 0 and dim > 0:
            entries[i] = data_axis
            return tuple(entries)
    return spec


# ---------------------------------------------------------------------------
# Over ranks
# ---------------------------------------------------------------------------


ZERO_AXIS = "data"  # the axis ZeRO-1 places the moments over, as repro's train cells


@dataclasses.dataclass(frozen=True)
class RankOptimizer:
    """An optimizer as one rank of the installed mesh runs it.

    ``placements``: each parameter leaf's placement as this rank holds it
    (leaf order; one entry a dimension: ``None`` or the axes it is
    blocked over, as ``models.*.held_placements`` give them).
    ``zero_dims``: for AdamW, each leaf's dimension whose block over
    ``data_axis`` (:data:`ZERO_AXIS`) this rank holds of ``m`` and ``v``
    (``None``: whole), where ``repro``'s :func:`zero_sharding` places the
    axis on the leaf as held.  :meth:`update` takes ``reduce``, each
    leaf's axes over which its gradient is still this rank's part."""

    name: str
    inner: Optimizer
    placements: list
    zero_dims: list
    data_axis: str
    mesh: Any

    def _zero_block(self, x: torch.Tensor, z: int | None) -> torch.Tensor:
        if z is None:
            return x
        lo, hi = collectives.block_of(x.shape[z], self.data_axis, self.mesh, even=True)
        return x.narrow(z, lo, hi - lo)

    def init(self, params):
        """The state of this rank: AdamW's ``m`` and ``v`` as the blocks of
        ``zero_dims``, Adafactor's factors of the leaves as held."""
        if self.name != "adamw":
            return self.inner.init(params)
        ls = leaves(params)
        blocks = [_zeros_f32(self._zero_block(p, z)) for p, z in zip(ls, self.zero_dims)]
        return {"m": unflatten(params, blocks), "v": unflatten(params, [torch.zeros_like(b) for b in blocks]),
                "step": _step0(params)}

    def state_placements(self, state):
        """The placement of each leaf of this rank's ``state`` (a tree of
        its structure): the parameter's, with ``data_axis`` on a ZeRO
        dimension; ``()`` for ``step``."""
        if self.name == "adamw":
            def moment(place, z, p):
                place = tuple(place) + (None,) * (p.dim() - len(tuple(place)))
                return place if z is None else place[:z] + (self.data_axis,) + place[z + 1:]

            ms = [moment(pl, z, m) for pl, z, m in zip(self.placements, self.zero_dims, leaves(state["m"]))]
            return {"m": unflatten(state["m"], ms), "v": unflatten(state["v"], ms), "step": ()}
        fs = []
        for place, st in zip(self.placements, _param_states_list(state["f"], len(self.placements))):
            ent = tuple(place)
            fs.append({k: (ent[:-1] if k == "vr" else ent[:-2] + ent[-1:]) if k != "v" else ent
                       for k in st})
        return {"f": _restate(state["f"], fs), "step": ()}

    @torch.no_grad()
    def update(self, params, grads, state, reduce):
        mesh, data = self.mesh, self.data_axis
        ps, gs = leaves(params), leaves(grads)
        p_use, g_use = [], []
        for p, g, red, z in zip(ps, gs, reduce, self.zero_dims):
            red = tuple(a for a in red if collectives.axis_size(mesh, a) > 1)
            rest = tuple(a for a in red if a != data or z is None)
            if rest:
                g = collectives.psum(g, rest, mesh)
            if z is not None:
                if data in red:
                    g = collectives.psum_scatter(g, data, z, mesh)
                else:
                    g = self._zero_block(g, z)
                p = self._zero_block(p, z)
            p_use.append(p)
            g_use.append(g)
        if self.name == "adamw":
            _, new = self.inner.update(p_use, g_use, state)
        else:  # no ZeRO: the leaves as held
            _, new = self.inner.update(params, unflatten(params, g_use), state, placements=self.placements,
                                       mesh=mesh)
        for p, blk, z in zip(ps, p_use, self.zero_dims):
            if z is not None and blk.shape != p.shape:
                p.copy_(collectives.all_gather(blk.contiguous(), data, z, mesh))
        return params, new


def _param_states_list(f, n: int) -> list[dict]:
    """The per-leaf state dictionaries of Adafactor's ``f``, in leaf
    order (a dictionary holding ``vr``/``vc`` or ``v`` is one leaf's)."""
    out = []

    def walk(t):
        if isinstance(t, dict) and (set(t) <= {"vr", "vc", "v"}) and t:
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(f)
    assert len(out) == n, (len(out), n)
    return out


def _restate(f, per_leaf: list[dict]):
    it = iter(per_leaf)

    def build(t):
        if isinstance(t, dict) and (set(t) <= {"vr", "vc", "v"}) and t:
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}  # leaf order
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return t

    return build(f)


def on_ranks(name: str, params, placements, mesh=None) -> RankOptimizer:
    """The optimizer ``name`` (:func:`get`) as this rank runs it on the
    installed mesh (or ``mesh``), for the rank's ``params`` held under
    ``placements`` (a tree of ``params``' structure, or a list in leaf
    order).  AdamW's ``m`` and ``v`` are placed by :func:`zero_sharding`
    over the data axis (its size from the mesh), as ``launch/cells.py``'s
    ``_zero_opt_specs``; Adafactor's state stays as derived, as there."""
    mesh = shd.get_mesh() if mesh is None else mesh
    sizes = shd.mesh_sizes(mesh)
    ps = leaves(params)
    places = shd.placement_leaves(placements)
    places = [tuple(pl) + (None,) * (p.dim() - len(tuple(pl))) for pl, p in zip(places, ps)]
    zero_dims = []
    for place, p in zip(places, ps):
        z = None
        if name == "adamw" and ZERO_AXIS in sizes:
            placed = zero_sharding(place, tuple(p.shape), ZERO_AXIS, sizes[ZERO_AXIS])
            z = next((i for i, (a, b) in enumerate(zip(place, placed)) if a != b), None)
        zero_dims.append(z)
    return RankOptimizer(name, get(name), places, zero_dims, ZERO_AXIS, mesh)
