"""Per-cell plans for the dry run: (arch × shape) → a step function, its
inputs as meta tensors and their placements on a layout, and the program
one rank runs there.

Port of ``repro/launch/cells.py``.  ``repro``'s plan is lowered and
compiled by XLA on the layout's mesh; the port's is evaluated on the
meta device by ``launch/analysis.py``.  Placements are built as
``repro`` builds them (``_named`` with ``fit_spec``, ZeRO-1 over
``data`` for AdamW's moments, edges on ``rules.edges()``, the batch
specs), as fitted tuples, on the layout's description.  ``fn`` and
``args`` are the port's one-card program (``Rules.from_mesh(None)``) on
the cell's global shapes.

Given the layout's ``DeviceMesh`` (``launch/mesh.py``'s ``fake_mesh``),
a plan also holds ``rank`` (:class:`RankPlan`): the program that rank 0
runs there, ``repro``'s mesh programs per rank over ``torch.distributed``
(PRs 26-29: the LMs' batch blocks, the expert-parallel MoE and the
sequence-sharded decode, and their dense layers tensor-parallel;
DLRM's row-sharded ``embedding_bag_sharded`` and retrieval's candidate
blocks;
the GNNs on their edge blocks and ``equiformer_energy_big``; the
``reference`` S2 executor on its sites; ``estimate``'s rollouts in its
block), its rank optimizer (ZeRO-1 AdamW) on a train step, run under
``shd.use_mesh``.  Its arguments are rank 0's blocks as meta tensors:
``collectives.leaf_block`` of each leaf under the placement the program
itself holds it by (its ``held_placements``: the LMs' dense layers'
tensor-parallel blocks, the MoE experts and DLRM's sharded tables cut,
the GNNs' parameters whole), the rank's optimizer state as its ``init``
makes it, the cache and sites as the program's ``cache_shard`` and site
blocks cut them, retrieval's candidates as its fitted block, and what
the program takes whole and blocks itself (the LM tokens, the DLRM
batch, the GNN edges, the starts).  Rank 0 holds the fullest block under
``block_of``'s ⌈n/k⌉.

Where a step reads device data on the host, a meta run takes a static
stand-in (the balanced MoE routing, every padded GCN edge, every padded
site slot and one fixpoint level of the reference executor, an even
share of a sharded DLRM table's lookups on each rank, the reference
executor's widest run taken as its own where ranks agree on it by a
``pmax``); a decode step's cache ``len`` is a real CPU scalar, ``seq -
1``: the fullest cache a step can still write into.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Callable

import torch

from repro_torch.configs import dlrm_mlperf as dlrm_cfg
from repro_torch.configs import gnn_common, lm_common, registry
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.models import dlrm, gnn
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, tree_map


@dataclasses.dataclass
class RankPlan:
    """The program rank 0 runs at a layout: ``fn(*args)`` installs the
    layout's ``DeviceMesh`` and runs the rank's step; ``args`` are trees
    of meta tensors, the rank's blocks (a decode step's cache len on the
    CPU)."""

    fn: Callable
    args: tuple


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
    rank: RankPlan | None = None  # built when the layout's DeviceMesh is given


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


def _blocks(placements, tree, mesh):
    """Rank 0's block of each leaf of ``tree`` under ``placements`` (a
    tree of the same structure) on ``mesh``, as new meta tensors."""

    def block(place, t):
        b = collectives.leaf_block(t, place, mesh)
        return torch.empty(tuple(b.shape), dtype=b.dtype, device="meta")

    return opt_lib.map_specs(block, placements, tree)


def on_mesh(mesh, step) -> Callable:
    """``step`` run with ``mesh`` installed."""

    def fn(*args):
        with shd.use_mesh(mesh):
            return step(*args)

    return fn


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def lm_cell(arch: str, shape_name: str, layout, mesh=None) -> CellPlan:
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
                        (psh, osh, bsh), *counts, tokens, "train", _lm_rank(cfg, shape, inputs, mesh))

    if shape.kind == "prefill":
        tok_sh = rules.fit((rules.batch, None), inputs["tokens"].shape)
        tokens = math.prod(inputs["tokens"].shape)
        return CellPlan(arch, shape_name, tr.make_prefill(cfg, one_card), (pshapes, inputs["tokens"]),
                        (psh, tok_sh), *counts, tokens, "prefill", _lm_rank(cfg, shape, inputs, mesh))

    # decode
    seq_sharded = shape.dims["seq"] >= 200_000
    cache = dict(inputs["cache"], len=torch.tensor(shape.dims["seq"] - 1, dtype=torch.int32))
    kv = tuple(cache["k"].shape)
    cspec = tr.cache_specs(cfg, rules, seq_sharded)
    csh = {"k": rules.fit(cspec["k"], kv), "v": rules.fit(cspec["v"], kv), "len": ()}
    tok_sh = rules.fit((rules.batch,), inputs["tokens"].shape)
    fn = tr.make_decode_step(cfg, one_card)
    return CellPlan(arch, shape_name, fn, (pshapes, cache, inputs["tokens"]), (psh, csh, tok_sh),
                    *counts, shape.dims["batch"], "decode",
                    _lm_rank(cfg, shape, dict(inputs, cache=cache), mesh, seq_sharded))


def _lm_rank(cfg: tr.LMConfig, shape, inputs: dict, mesh, seq_sharded: bool = False) -> RankPlan | None:
    """Rank 0's LM program: its held parameters (``tr.held_placements``:
    ``repro``'s placements fitted, the dense layers' tensor-parallel
    blocks and the experts cut), its rank optimizer's state, the tokens
    whole (the program runs its batch block), a decode step's cache share
    (``tr.cache_shard``)."""
    if mesh is None:
        return None
    rules = tr.rules_for(cfg, mesh)
    with shd.use_mesh(mesh):
        params = _blocks(tr.held_placements(cfg, rules), tr.param_shapes(cfg), mesh)
        if shape.kind == "train":
            state = tr.optimizer_for(cfg, rules, params).init(params)
            return RankPlan(on_mesh(mesh, tr.make_train_step(cfg, rules)), (params, state, inputs))
        if shape.kind == "prefill":
            return RankPlan(on_mesh(mesh, tr.make_prefill(cfg, rules)), (params, inputs["tokens"]))
        cache = tr.cache_shard(cfg, rules, inputs["cache"], seq_sharded)
    step = tr.make_decode_step(cfg, rules, seq_sharded=seq_sharded)
    return RankPlan(on_mesh(mesh, step), (params, cache, inputs["tokens"]))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _gnn_param_shapes(cfg):
    """A GNN's parameters as meta tensors: initialised on the CPU (they
    are small) and moved to the meta device."""
    return tree_map(lambda t: t.to("meta"), gnn.INIT_FNS[cfg.name](cfg, 0, device="cpu"))


def gnn_cell(arch: str, shape_name: str, layout, mesh=None) -> CellPlan:
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
    rank = None
    if mesh is not None:
        # the parameters whole on every rank, the edges whole: the program
        # runs its edge block
        mrules = shd.Rules.from_mesh(mesh)
        with shd.use_mesh(mesh):
            state = gnn.optimizer_for(cfg, mrules, pshapes).init(pshapes)
        rank = RankPlan(on_mesh(mesh, gnn.make_gnn_train_step(cfg, mrules)), (pshapes, state, inputs))
    return CellPlan(arch, shape_name, fn, (pshapes, oshapes, inputs), (psh, osh, bsh),
                    n_params, n_params, n_edges, "train", rank)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def dlrm_cell(arch: str, shape_name: str, layout, mesh=None) -> CellPlan:
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
    rank = None if mesh is None else _dlrm_rank(cfg, shape, pshapes, inputs, mesh)

    if shape.kind == "train":
        oshapes = _opt_state_shapes(cfg.optimizer, pshapes)
        osh = _named(layout, _zero_opt_specs(layout, cfg.optimizer, pshapes, pspecs), oshapes)
        return CellPlan(arch, shape_name, dlrm.make_train_step(cfg, one_card), (pshapes, oshapes, inputs),
                        (psh, osh, bsh), n_params, n_params, shape.dims["batch"], "train", rank)
    if shape.kind == "retrieval":
        return CellPlan(arch, shape_name, dlrm.make_retrieval_step(cfg, one_card), (pshapes, inputs),
                        (psh, bsh), n_params, n_params, shape.dims["n_candidates"], "retrieval", rank)
    return CellPlan(arch, shape_name, dlrm.make_serve_step(cfg, one_card), (pshapes, inputs), (psh, bsh),
                    n_params, n_params, shape.dims["batch"], "serve", rank)


def _dlrm_rank(cfg: dlrm.DLRMConfig, shape, pshapes: dict, inputs: dict, mesh) -> RankPlan:
    """Rank 0's DLRM program: its row shard of each table the rule shards
    at the step's batch (``dlrm.held_placements``), the MLPs and the other
    tables whole, its rank optimizer's state, the batch whole (the program
    runs its block); a retrieval step's block of the candidates."""
    rules = shd.Rules.from_mesh(mesh)
    batch = inputs["dense"].shape[0]
    with shd.use_mesh(mesh):
        params = _blocks(dlrm.held_placements(cfg, rules, batch), pshapes, mesh)
        if shape.kind == "train":
            state = dlrm.optimizer_for(cfg, rules, params, batch).init(params)
            return RankPlan(on_mesh(mesh, dlrm.make_train_step(cfg, rules)), (params, state, inputs))
        if shape.kind == "retrieval":  # the rank's block of the candidates, fitted as repro's
            n = inputs["candidates"].shape[0]
            lo, hi, _ = collectives.flat_block(rules, n)
            inputs = dict(inputs, candidates=_meta((hi - lo,) + tuple(inputs["candidates"].shape[1:]),
                                                   inputs["candidates"].dtype))
            return RankPlan(on_mesh(mesh, dlrm.make_retrieval_step(cfg, rules, n)), (params, inputs))
    return RankPlan(on_mesh(mesh, dlrm.make_serve_step(cfg, rules)), (params, inputs))


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


def rpq_automaton(cfg):
    """The cell's query automaton over the alibaba-like label set."""
    from repro_torch.core import automaton as am
    from repro_torch.core import regex as rx
    from repro_torch.graph import generators

    labels = (
        generators.C_LABELS + generators.A_LABELS + generators.I_LABELS
        + [l for l in generators.E_LABELS if l not in generators.A_LABELS]
        + generators.P_LABELS + generators.RARE_LABELS
        + [f"cooc_{i}" for i in range(180)]
    )
    lmap = {n: i for i, n in enumerate(labels)}
    return am.ground(am.build_nfa(rx.parse(generators.TABLE2_QUERIES[cfg.query])), lmap)


def rpq_cell(arch: str, shape_name: str, layout, mesh=None) -> CellPlan:
    from repro_torch.configs import alibaba_rpq as rq
    from repro_torch.core import strategies

    spec = registry.get_arch(arch)
    cfg: rq.RPQConfig = spec.full()
    shape = spec.shapes[shape_name]
    site_axes = tuple(a for a in layout.axis_names if a in ("pod", "data"))
    ca = rpq_automaton(cfg)

    if shape_name == "estimate":
        n_roll, n = shape.dims["n_rollouts"], ca.n_states
        args = (_meta((n, n), torch.float32), _meta((n,), torch.float32), _meta((n_roll,), torch.int64))
        flat = site_axes + (("model",) if "model" in layout.axis_names else ())
        placements = ((None, None), (None,), shd.fit_spec(layout, (flat,), (n_roll,)))
        rank = None
        if mesh is not None:  # the rollouts of the rank's block; no collective
            keys = collectives.leaf_block(args[2], placements[2], mesh)
            rank = RankPlan(_estimate_fn(n), (args[0], args[1], _meta(tuple(keys.shape), keys.dtype)))
        return CellPlan(arch, shape_name, _estimate_fn(n), args, placements, 0, 0, n_roll, "serve", rank)

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
    rank = None
    if mesh is not None:
        # the rank's sites (its block over the site axes), the starts whole:
        # the executor runs its block of them over the model axis
        s2_rank = strategies.make_s2_step_fn(ca, shape.dims["n_nodes"], cfg.max_levels, backend="reference",
                                             mesh=mesh, site_axes=site_axes, batch_axis="model")

        def rank_fn(src, lbl, dst, mask, starts):
            return s2_rank(starts, {"src": src, "lbl": lbl, "dst": dst, "mask": mask})

        sites = _blocks([espec] * 4, list(args[:4]), mesh)
        rank = RankPlan(rank_fn, (*sites, args[4]))
    return CellPlan(arch, shape_name, fn, args, placements, 0, 0,
                    shape.dims["batch"] * shape.dims["n_edges"], "serve", rank)


def build_cell(arch: str, shape_name: str, layout, mesh=None) -> CellPlan:
    """The cell's plan on ``layout`` (a ``MeshLayout``); with ``mesh``,
    the layout's ``DeviceMesh`` (``launch.mesh.fake_mesh``), its rank
    program too."""
    family = registry.get_arch(arch).family
    builder = {"lm": lm_cell, "gnn": gnn_cell, "recsys": dlrm_cell, "rpq": rpq_cell}[family]
    return builder(arch, shape_name, layout, mesh)
