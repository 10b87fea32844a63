"""Carry ``repro``'s artifacts into the port, as numpy arrays.

The port has no weights; what the reference builds — graphs, staged tile
tensors, level schedules, placements, overlays, fitted statistical models
and plan estimates — stands in for them.  Each function takes the numpy
form of a ``repro`` object (the caller converts, so this module imports
nothing of ``repro``) and returns the port's object, so the port's
fixpoint can run on the exact tiles and schedule ``repro`` built, and
its rollouts and strategy decisions on ``repro``'s fitted model and
estimates.
"""

from __future__ import annotations

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core.estimation import BayesianModel, GilbertModel
from repro_torch.core.planner import PlanEstimates, QueryClass
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.graph.partition import OverlayNetwork, Placement
from repro_torch.graph.structure import LabeledGraph
from repro_torch.kernels.frontier.ops import (
    QPAD,
    BlockedGraph,
    FusedLevelPlan,
    StagedGraph,
    blocked_entry,
    level_work,
    run_offsets,
    work_chunk,
)
from repro_torch.models import dlrm
from repro_torch.training.tree import leaves, unflatten


def graph_from_numpy(
    n_nodes: int, src: np.ndarray, lbl: np.ndarray, dst: np.ndarray, labels: list[str]
) -> LabeledGraph:
    """A ``repro`` ``LabeledGraph`` given by its fields."""
    return LabeledGraph(int(n_nodes), np.asarray(src), np.asarray(lbl), np.asarray(dst), list(labels))


def blocked_graph_from_numpy(
    n_nodes: int,
    block_size: int,
    fwd: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]],
    inv: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]],
    device: str | torch.device | None = None,
) -> BlockedGraph:
    """A ``repro`` ``BlockedGraph`` given by its per-label ``(tiles, rows,
    cols)`` stores, moved to ``device`` (``None``: the GPU), each with the
    port's work list (``ops.store_work``)."""
    device = resolve_device(device)

    def carry(store):
        return {
            int(lid): blocked_entry(np.asarray(t, np.float32), np.asarray(r), np.asarray(c), device)
            for lid, (t, r, c) in store.items()
        }

    v_pad = -(-int(n_nodes) // block_size) * block_size
    return BlockedGraph(int(n_nodes), v_pad, block_size, carry(fwd), carry(inv), device)


def staged_from_numpy(
    n_nodes: int,
    block_size: int,
    tiles: np.ndarray,
    offsets: dict[tuple[int, int], tuple[int, np.ndarray, np.ndarray]],
    device: str | torch.device | None = None,
) -> StagedGraph:
    """A ``repro`` ``StagedGraph`` given by its tile tensor and offset
    table, moved to ``device`` (``None``: the GPU).  A uint32 bit-plane
    store becomes the port's int32 store with the same bits."""
    tiles = np.asarray(tiles)
    if tiles.dtype == np.uint32:
        tile_dtype, tiles = "uint32", tiles.view(np.int32)
    elif tiles.dtype == np.float32:
        tile_dtype = "f32"
    else:
        raise TypeError(f"tiles must be float32 or uint32, got {tiles.dtype}")
    return StagedGraph(
        n_nodes=int(n_nodes),
        v_pad=-(-int(n_nodes) // block_size) * block_size,
        block_size=block_size,
        tiles=torch.from_numpy(tiles.copy()).to(resolve_device(device)),
        offsets={
            (int(d), int(l)): (int(base), np.asarray(r), np.asarray(c))
            for (d, l), (base, r, c) in offsets.items()
        },
        tile_dtype=tile_dtype,
    )


def plan_from_numpy(
    staged: StagedGraph,
    n_states: int,
    firsts: np.ndarray,
    valids: np.ndarray,
    tile_ids: np.ndarray,
    f_rows: np.ndarray,
    f_cols: np.ndarray,
    o_rows: np.ndarray,
    o_cols: np.ndarray,
    union_members: tuple[tuple[int, ...], ...],
    q_pad: int = QPAD,
) -> FusedLevelPlan:
    """A ``repro`` ``FusedLevelPlan`` given by its seven schedule arrays and
    ``union_members``, over ``staged`` (its device and tiles).  The port's
    ``run_ptr`` is derived and checked here, and its ``work`` list built
    from it as Stage B builds it, in chunks of the tile store's length."""
    cols = [np.asarray(a, np.int32) for a in (firsts, valids, tile_ids, f_rows, f_cols, o_rows, o_cols)]
    firsts, valids, tile_ids, f_rows, f_cols, o_rows, o_cols = cols
    nb = staged.v_pad // staged.block_size
    arr = np.stack([o_rows, o_cols, f_rows, f_cols, tile_ids], axis=1)
    run_ptr = run_offsets(arr, firsts, n_states, nb)
    dev = staged.tiles.device

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(dev)  # a writable copy

    return FusedLevelPlan(
        n_states=int(n_states),
        n_nodes=staged.n_nodes,
        v_pad=staged.v_pad,
        block_size=staged.block_size,
        q_pad=q_pad,
        n_real_steps=int(valids.sum()),
        union_members=tuple(tuple(int(s) for s in m) for m in union_members),
        tiles=staged.tiles,
        firsts=put(firsts),
        valids=put(valids),
        tile_ids=put(tile_ids),
        f_rows=put(f_rows),
        f_cols=put(f_cols),
        o_rows=put(o_rows),
        o_cols=put(o_cols),
        run_ptr=put(run_ptr),
        work=put(level_work(valids, run_ptr, work_chunk(staged.tile_dtype))),
        tile_dtype=staged.tile_dtype,
    )


def placement_from_numpy(
    graph: LabeledGraph, n_sites: int, site_edges: list[np.ndarray], replication: np.ndarray
) -> Placement:
    """A ``repro`` ``Placement`` given by its per-site edge id lists and
    its per-edge replication counts, over the port's ``graph``."""
    return Placement(
        graph, int(n_sites), [np.asarray(e) for e in site_edges], np.asarray(replication)
    )


def overlay_from_numpy(n_peers: int, adj_src: np.ndarray, adj_dst: np.ndarray) -> OverlayNetwork:
    """A ``repro`` ``OverlayNetwork`` given by its fields."""
    return OverlayNetwork(int(n_peers), np.asarray(adj_src), np.asarray(adj_dst))


def gilbert_from_numpy(n_nodes: int, lam: np.ndarray, lam_in: np.ndarray) -> GilbertModel:
    """A fitted ``repro`` ``GilbertModel`` given by its rate arrays."""
    return GilbertModel(int(n_nodes), np.asarray(lam), np.asarray(lam_in))


def bayesian_from_numpy(
    n_nodes: int,
    lam0: np.ndarray,
    lam_cond: np.ndarray,
    lam0_in: np.ndarray,
    lam_cond_in: np.ndarray,
) -> BayesianModel:
    """A fitted ``repro`` ``BayesianModel`` given by its rate arrays."""
    return BayesianModel(
        int(n_nodes), *(np.asarray(a) for a in (lam0, lam_cond, lam0_in, lam_cond_in))
    )


def estimates_from_numpy(
    query: str,
    q_lbl: float,
    d_s1: float,
    q_bc_samples: np.ndarray,
    d_s2_samples: np.ndarray,
    wildcard: bool,
    query_class: tuple[str, tuple, int] | None = None,
) -> PlanEstimates:
    """A ``repro`` ``PlanEstimates`` given by its fields; ``query_class``
    as its ``(kind, atoms, length)``."""
    return PlanEstimates(
        query=query,
        q_lbl=float(q_lbl),
        d_s1=float(d_s1),
        q_bc_samples=np.asarray(q_bc_samples),
        d_s2_samples=np.asarray(d_s2_samples),
        wildcard=bool(wildcard),
        query_class=None if query_class is None else QueryClass(*query_class),
    )


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One numpy leaf as a tensor with the same bytes; a bfloat16 array
    (``ml_dtypes``, as ``np.asarray`` gives a JAX bf16 array) goes
    through its 16-bit view."""
    a = np.array(a)  # a writable copy: JAX's arrays come back read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _carry_tree(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _carry_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_carry_tree(v, device) for v in tree]
    return _tensor(tree, device)


def _params_from_numpy(params: dict, keys: set[str], what: str, device) -> dict:
    if set(params) != keys:
        raise KeyError(f"{what} params have keys {sorted(params)}, expected {sorted(keys)}")
    return _carry_tree(params, resolve_device(device))


def lm_params_from_numpy(params: dict, device: str | torch.device | None = None) -> dict:
    """``repro``'s LM parameters (``models/transformer.py``
    ``init_params``: embed, lm_head, final_norm and the stacked layers,
    whose ``mlp`` or, in a MoE config, ``moe`` holds router, w_gate, w_up
    and w_down), each leaf a numpy array, as the port's tensors with the
    same bytes on ``device`` (``None``: the GPU)."""
    layer_keys = set(params.get("layers", {}))
    if layer_keys not in ({"attn", "ln1", "ln2", "mlp"}, {"attn", "ln1", "ln2", "moe"}):
        raise KeyError(f"LM layers have keys {sorted(layer_keys)}, expected attn, ln1, ln2 and mlp or moe")
    return _params_from_numpy(params, {"embed", "lm_head", "final_norm", "layers"}, "LM", device)


def dlrm_params_from_numpy(params: dict, device: str | torch.device | None = None) -> dict:
    """``repro``'s DLRM parameters (``models/dlrm.py`` ``init_params``:
    the bottom and top MLPs as lists of {w, b}, the tables t0..), each
    leaf a numpy array, as the port's tensors with the same bytes on
    ``device`` (``None``: the GPU)."""
    return _params_from_numpy(params, {"bot", "top", "tables"}, "DLRM", device)


def table_row_shard_from_numpy(
    table: np.ndarray, index: int, n_shards: int, device: str | torch.device | None = None
) -> torch.Tensor:
    """Shard ``index`` of ``n_shards`` of ``repro``'s numpy embedding table,
    as the port's tensor with the same bytes on ``device`` (``None``: the
    GPU): the rows ``repro``'s row-sharded bag hands that model shard
    (``models.dlrm.table_row_shard``)."""
    return dlrm.table_row_shard(_tensor(table, resolve_device(device)), index, n_shards)


def moe_expert_shard_from_numpy(
    params: dict, rules, fsdp: bool = False, device: str | torch.device | None = None
) -> dict:
    """This rank's share of ``repro``'s numpy MoE weights (``router``,
    ``w_gate``, ``w_up``, ``w_down``; expert leaves (..., E, D, F) /
    (..., E, F, D), with or without the stacked layer dim) on the
    installed mesh, as the port's tensors on ``device`` (``None``: the
    GPU): the rank's ``e_loc`` experts over the model axis and, with
    ``fsdp``, its d_ff block over the batch axes, the slices ``repro``'s
    ``shard_map`` hands that rank (``models.layers.moe_shard``).  Only
    the slices are copied to the device."""
    device = resolve_device(device)
    mesh = shd.get_mesh()
    if set(params) != {"router", "w_gate", "w_up", "w_down"}:
        raise KeyError(f"MoE params have keys {sorted(params)}, expected router, w_gate, w_up, w_down")
    if mesh is None or rules.model_axis is None:
        return _carry_tree(params, device)
    e_loc = np.shape(params["w_gate"])[-3] // rules.model_size
    e_lo = collectives.axis_index(mesh, rules.model_axis) * e_loc

    def cut(w: np.ndarray, ff_dim: int) -> torch.Tensor:
        w = np.asarray(w)
        w = w[(Ellipsis, slice(e_lo, e_lo + e_loc), slice(None), slice(None))]
        if fsdp and rules.batch_axes:
            f_lo, f_hi = collectives.block_of(w.shape[ff_dim], rules.batch_axes, mesh, even=True)
            w = np.take(w, np.arange(f_lo, f_hi), axis=ff_dim)
        return _tensor(w, device)

    return {"router": _tensor(params["router"], device), "w_gate": cut(params["w_gate"], -1),
            "w_up": cut(params["w_up"], -1), "w_down": cut(params["w_down"], -2)}


# the top-level keys of each GNN's parameters (``repro/models/gnn.py``'s
# ``*_init``): GCN's layers of {w, b}; SchNet's embedding, interaction
# blocks and readout; NequIP's and EquiformerV2's embedding, per-layer
# blocks and readout
GNN_PARAM_KEYS = ({"layers"}, {"embed", "inter", "readout"}, {"embed", "layers", "readout"})


def gnn_params_from_numpy(params: dict, device: str | torch.device | None = None) -> dict:
    """``repro``'s parameters of one of its four GNNs, nested lists and
    dictionaries of numpy arrays (lists of {w, b}, embeddings, NequIP's
    and EquiformerV2's per-layer blocks), as the port's tensors with the
    same bytes and the same nesting on ``device`` (``None``: the GPU)."""
    if set(params) not in GNN_PARAM_KEYS:
        raise KeyError(f"GNN params have keys {sorted(params)}, expected one of {GNN_PARAM_KEYS}")
    return _carry_tree(params, resolve_device(device))

def rank_shard_from_numpy(tree, placements, device: str | torch.device | None = None):
    """This rank's blocks of a tree of ``repro``'s numpy arrays (parameters
    or optimizer state) on the installed mesh, as the port's tensors on
    ``device`` (``None``: the GPU): each leaf cut by its placement in
    ``placements`` (a tree of ``tree``'s structure; ``collectives.leaf_block``,
    as ``checkpoint.restore(shardings=...)`` cuts a whole leaf).  Only the
    blocks are copied to the device."""
    device = resolve_device(device)
    mesh = shd.get_mesh()
    out = []
    for a, place in zip(leaves(tree), shd.placement_leaves(placements)):
        t = _tensor(a, torch.device("cpu"))
        if mesh is not None and place:
            t = collectives.leaf_block(t, place, mesh).contiguous()
        out.append(t.to(device))
    return unflatten(tree, out)


def opt_state_from_numpy(state: dict, device: str | torch.device | None = None) -> dict:
    """``repro``'s optimizer state (``training/optimizer.py``: AdamW's
    ``{"m", "v", "step"}`` or AdaFactor's ``{"f", "step"}``, with
    ``step`` an int32 scalar), each leaf a numpy array, as the port's
    tensors with the same bytes and nesting on ``device`` (``None``: the
    GPU); ``step`` becomes a () int32 tensor."""
    if set(state) not in ({"m", "v", "step"}, {"f", "step"}):
        raise KeyError(f"optimizer state has keys {sorted(state)}, expected m, v, step or f, step")
    out = _carry_tree(state, resolve_device(device))
    if out["step"].dtype != torch.int32 or out["step"].dim() != 0:
        raise TypeError(f"step must be an int32 scalar, got {out['step'].dtype} {tuple(out['step'].shape)}")
    return out
