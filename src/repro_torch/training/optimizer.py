"""Optimizers in plain PyTorch.

Port of ``repro/training/optimizer.py``:

* :func:`adamw` — AdamW with decoupled weight decay and f32 moments;
  the default for the dense LMs, the GNNs and DLRM.
* :func:`adafactor` — factored second moments (Shazeer & Stern, 2018)
  over the last two dimensions of each leaf of rank 2 or more, with
  update clipping; kimi-k2's optimizer.
* :func:`state_spec_for` and :func:`zero_sharding` — the placements of
  the optimizer state, as the port's placement tuples
  (``dist/sharding.py``); plain data, equal to ``repro``'s specs.  ZeRO
  placement itself waits for the multi-GPU item.

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

from repro_torch.training.tree import leaves, tree_map


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
    def update(params, grads, state):
        step = state["step"] + 1
        t = step.float()
        beta2t = 1.0 - torch.pow(t, -decay)
        for p, g, s in zip(leaves(params), leaves(grads), _param_states(params, state["f"])):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if _factored(p):
                s["vr"].copy_(beta2t * s["vr"] + (1 - beta2t) * g2.mean(dim=-1))
                s["vc"].copy_(beta2t * s["vc"] + (1 - beta2t) * g2.mean(dim=-2))
                denom = s["vr"].mean(dim=-1, keepdim=True)
                rhat = (s["vr"] / torch.clamp(denom, min=eps))[..., None]
                u = g32 / (torch.sqrt(rhat * s["vc"][..., None, :]) + eps)
            else:
                s["v"].copy_(beta2t * s["v"] + (1 - beta2t) * g2)
                u = g32 / (torch.sqrt(s["v"]) + eps)
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
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
