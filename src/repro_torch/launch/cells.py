"""Per-cell plans for the dry run: (arch × shape) → a step function, its
inputs as meta tensors and their placements on a layout.

Port of ``repro/launch/cells.py``.  ``repro``'s plan is lowered and
compiled by XLA on the layout's mesh; the port's is evaluated on the
meta device by ``launch/analysis.py``.  Placements are built as
``repro`` builds them (``_named`` with ``fit_spec``, ZeRO-1 over
``data`` for AdamW's moments, edges on ``rules.edges()``, the batch
specs), as fitted tuples.  ``fn`` is the port's one-card program
(``Rules.from_mesh(None)``) on the cell's global shapes: at a layout
``repro`` runs its mesh programs (the expert-parallel MoE, the
sequence-sharded decode, ``equiformer_energy_big``, the row-sharded
``embedding_bag_sharded``, the site-sharded ring).  The port runs those
per rank over ``torch.distributed`` (all but the ring, a design
difference); the dry run counts the one-card program, and the layout's
``Rules`` give the placements only, until it counts the per-rank
programs with their collectives (ROADMAP item 4.5).

Where a step reads device data on the host, a meta run takes a static
stand-in (the balanced MoE routing, every padded GCN edge, every padded
site slot and one fixpoint level of the reference executor); a decode
step's cache ``len`` is a real CPU scalar, ``seq - 1``: the fullest cache
a step can still write into.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Callable

import torch

from repro_torch.configs import dlrm_mlperf as dlrm_cfg
from repro_torch.configs import gnn_common, lm_common, registry
from repro_torch.dist import sharding as shd
from repro_torch.models import dlrm, gnn
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, tree_map


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    fn: Callable
    args: tuple  # trees of meta tensors (a decode step's cache len on the CPU)
    in_placements: tuple  # the same trees with a fitted placement tuple at each leaf
    n_params: int
    n_active: int
    tokens: int  # work units for MODEL_FLOPS
    kind: str


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _named(layout, spec_tree, shape_tree):
    """Each leaf's placement fitted to its shape on ``layout``
    (non-divisible dims degrade to replicated, e.g. granite's vocab
    49,155 on a 16-way model axis)."""
    return opt_lib.map_specs(lambda spec, leaf: shd.fit_spec(layout, spec, tuple(leaf.shape)),
                             spec_tree, shape_tree)


def _zero_opt_specs(layout, opt_name: str, pshapes, pspecs):
    """Optimizer state placements, AdamW's moments with ZeRO-1 over the
    data axis."""
    specs = opt_lib.state_spec_for(opt_name, pshapes, pspecs)
    data_size = layout.shape.get("data", 1)

    def zero(spec, leaf):
        return opt_lib.zero_sharding(spec, tuple(leaf.shape), "data", data_size)

    if opt_name == "adamw":
        return {"m": opt_lib.map_specs(zero, specs["m"], pshapes),
                "v": opt_lib.map_specs(zero, specs["v"], pshapes), "step": ()}
    return specs  # adafactor's statistics are small: left as derived


def _opt_state_shapes(opt_name: str, pshapes):
    """The optimizer's state for ``pshapes`` as meta tensors."""
    return opt_lib.get(opt_name).init(pshapes)


def _numel(tree) -> int:
    return sum(leaf.numel() for leaf in leaves(tree))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def lm_cell(arch: str, shape_name: str, layout) -> CellPlan:
    spec = registry.get_arch(arch)
    cfg: tr.LMConfig = spec.full()
    shape = spec.shapes[shape_name]
    rules = tr.rules_for(cfg, layout)  # arch overrides (e.g. kimi's FSDP experts)
    one_card = tr.rules_for(cfg)
    pshapes = tr.param_shapes(cfg)
    pspecs = tr.param_specs(cfg, rules)
    psh = _named(layout, pspecs, pshapes)
    inputs = lm_common.lm_input_specs(cfg, shape)
    counts = (cfg.param_count(), cfg.active_param_count())

    if shape.kind == "train":
        oshapes = _opt_state_shapes(cfg.optimizer, pshapes)
        osh = _named(layout, _zero_opt_specs(layout, cfg.optimizer, pshapes, pspecs), oshapes)
        bsh = {k: rules.fit((rules.batch, None), inputs[k].shape) for k in ("tokens", "labels")}
        tokens = math.prod(inputs["tokens"].shape)
        return CellPlan(arch, shape_name, tr.make_train_step(cfg, one_card), (pshapes, oshapes, inputs),
                        (psh, osh, bsh), *counts, tokens, "train")

    if shape.kind == "prefill":
        tok_sh = rules.fit((rules.batch, None), inputs["tokens"].shape)
        tokens = math.prod(inputs["tokens"].shape)
        return CellPlan(arch, shape_name, tr.make_prefill(cfg, one_card), (pshapes, inputs["tokens"]),
                        (psh, tok_sh), *counts, tokens, "prefill")

    # decode
    seq_sharded = shape.dims["seq"] >= 200_000
    cache = dict(inputs["cache"], len=torch.tensor(shape.dims["seq"] - 1, dtype=torch.int32))
    kv = tuple(cache["k"].shape)
    cspec = tr.cache_specs(cfg, rules, seq_sharded)
    csh = {"k": rules.fit(cspec["k"], kv), "v": rules.fit(cspec["v"], kv), "len": ()}
    tok_sh = rules.fit((rules.batch,), inputs["tokens"].shape)
    fn = tr.make_decode_step(cfg, one_card)
    return CellPlan(arch, shape_name, fn, (pshapes, cache, inputs["tokens"]), (psh, csh, tok_sh),
                    *counts, shape.dims["batch"], "decode")


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _gnn_param_shapes(cfg):
    """A GNN's parameters as meta tensors: initialised on the CPU (they
    are small) and moved to the meta device."""
    return tree_map(lambda t: t.to("meta"), gnn.INIT_FNS[cfg.name](cfg, 0, device="cpu"))


def gnn_cell(arch: str, shape_name: str, layout) -> CellPlan:
    spec = registry.get_arch(arch)
    shape = spec.shapes[shape_name]
    rules = shd.Rules.from_mesh(layout)
    cfg = spec.full()
    needs_feat = arch == "gcn-cora"
    if needs_feat:
        cfg = gnn_common.gcn_for_shape(cfg, shape)
    inputs = gnn_common.gnn_input_specs(cfg, shape, needs_feat)
    pshapes = _gnn_param_shapes(cfg)
    psh = _named(layout, tree_map(lambda _: (), pshapes), pshapes)  # small: replicated
    espec = rules.edges()
    bsh = {k: rules.fit(espec, v.shape) if k.startswith("edge_") else (None,) * v.dim()
           for k, v in inputs.items()}
    oshapes = _opt_state_shapes(cfg.optimizer, pshapes)
    osh = _named(layout, tree_map(lambda _: (), oshapes), oshapes)
    fn = gnn.make_gnn_train_step(cfg, shd.Rules.from_mesh(None))
    n_params = _numel(pshapes)
    _, n_edges, _ = gnn_common.shape_counts(shape)
    return CellPlan(arch, shape_name, fn, (pshapes, oshapes, inputs), (psh, osh, bsh),
                    n_params, n_params, n_edges, "train")


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def dlrm_cell(arch: str, shape_name: str, layout) -> CellPlan:
    spec = registry.get_arch(arch)
    cfg: dlrm.DLRMConfig = spec.full()
    shape = spec.shapes[shape_name]
    rules = shd.Rules.from_mesh(layout)
    one_card = shd.Rules.from_mesh(None)
    pshapes = dlrm.param_shapes(cfg)
    pspecs = dlrm.param_specs(cfg, rules)
    psh = _named(layout, pspecs, pshapes)
    inputs = dlrm_cfg.input_specs(cfg, shape)
    bsh = {k: rules.fit((rules.batch,), (v.shape[0],)) + (None,) * (v.dim() - 1)
           for k, v in inputs.items()}
    if shape.kind == "retrieval":
        flat = tuple(rules.batch_axes) + ((rules.model_axis,) if rules.model_axis else ())
        bsh["candidates"] = rules.fit((flat, None), inputs["candidates"].shape)
        bsh["dense"] = (None, None)
        bsh["sparse"] = (None, None, None)
    n_params = _numel(pshapes)

    if shape.kind == "train":
        oshapes = _opt_state_shapes(cfg.optimizer, pshapes)
        osh = _named(layout, _zero_opt_specs(layout, cfg.optimizer, pshapes, pspecs), oshapes)
        return CellPlan(arch, shape_name, dlrm.make_train_step(cfg, one_card), (pshapes, oshapes, inputs),
                        (psh, osh, bsh), n_params, n_params, shape.dims["batch"], "train")
    if shape.kind == "retrieval":
        return CellPlan(arch, shape_name, dlrm.make_retrieval_step(cfg, one_card), (pshapes, inputs),
                        (psh, bsh), n_params, n_params, shape.dims["n_candidates"], "retrieval")
    return CellPlan(arch, shape_name, dlrm.make_serve_step(cfg, one_card), (pshapes, inputs), (psh, bsh),
                    n_params, n_params, shape.dims["batch"], "serve")


# ---------------------------------------------------------------------------
# RPQ (the paper's own system)
# ---------------------------------------------------------------------------


def _estimate_fn(n_states: int):
    """``repro``'s inline rollout cell in torch: every rollout a row (its
    ``vmap``), the branching process from state 0 with Poisson children
    of mean ``counts · M`` per level, summing broadcast symbols (``B``)
    and unicast symbols (3 a child).  Drawn from the default generator;
    ``keys`` (one int64 per rollout, a ``jax`` key's 8 bytes) give the
    rollout count.  ``repro``'s ``while_loop`` (at most 64 levels, until
    no count is left) is one level here, as XLA's cost analysis counts a
    ``while`` body once."""

    def fn(M: torch.Tensor, B: torch.Tensor, keys: torch.Tensor):
        counts = torch.zeros((keys.shape[0], n_states), dtype=torch.float32, device=M.device)
        counts[:, 0] = 1.0
        children = torch.poisson(counts[:, :, None] * M)
        q_bc = (counts * B).sum(dim=1)
        d_s2 = 3.0 * children.sum(dim=(1, 2))
        return q_bc, d_s2

    return fn


def rpq_cell(arch: str, shape_name: str, layout) -> CellPlan:
    from repro_torch.configs import alibaba_rpq as rq
    from repro_torch.core import automaton as am
    from repro_torch.core import regex as rx
    from repro_torch.core import strategies
    from repro_torch.graph import generators

    spec = registry.get_arch(arch)
    cfg: rq.RPQConfig = spec.full()
    shape = spec.shapes[shape_name]
    site_axes = tuple(a for a in layout.axis_names if a in ("pod", "data"))
    labels = (
        generators.C_LABELS + generators.A_LABELS + generators.I_LABELS
        + [l for l in generators.E_LABELS if l not in generators.A_LABELS]
        + generators.P_LABELS + generators.RARE_LABELS
        + [f"cooc_{i}" for i in range(180)]
    )
    lmap = {n: i for i, n in enumerate(labels)}
    ca = am.ground(am.build_nfa(rx.parse(generators.TABLE2_QUERIES[cfg.query])), lmap)

    if shape_name == "estimate":
        n_roll, n = shape.dims["n_rollouts"], ca.n_states
        args = (_meta((n, n), torch.float32), _meta((n,), torch.float32), _meta((n_roll,), torch.int64))
        flat = site_axes + (("model",) if "model" in layout.axis_names else ())
        placements = ((None, None), (None,), shd.fit_spec(layout, (flat,), (n_roll,)))
        return CellPlan(arch, shape_name, _estimate_fn(n), args, placements, 0, 0, n_roll, "serve")

    # serve_queries: the batched S2 reference executor over the sites' padded edges
    e_per_site = int(shape.dims["n_edges"] * cfg.replication_rate * 1.25)
    e_per_site = -(-e_per_site // 128) * 128
    inputs = rq.input_specs(cfg, shape, e_per_site)
    s2 = strategies.make_s2_step_fn(ca, shape.dims["n_nodes"], cfg.max_levels, backend="reference")

    def fn(src, lbl, dst, mask, starts):
        return s2(starts, {"src": src, "lbl": lbl, "dst": dst, "mask": mask})

    args = tuple(inputs[k] for k in ("src", "lbl", "dst", "mask", "starts"))
    espec = shd.fit_spec(layout, (site_axes, None), tuple(inputs["src"].shape))
    placements = (espec,) * 4 + (shd.fit_spec(layout, ("model",), tuple(inputs["starts"].shape)),)
    return CellPlan(arch, shape_name, fn, args, placements, 0, 0,
                    shape.dims["batch"] * shape.dims["n_edges"], "serve")


def build_cell(arch: str, shape_name: str, layout) -> CellPlan:
    family = registry.get_arch(arch).family
    builder = {"lm": lm_cell, "gnn": gnn_cell, "recsys": dlrm_cell, "rpq": rpq_cell}[family]
    return builder(arch, shape_name, layout)
