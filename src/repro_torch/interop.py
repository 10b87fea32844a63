"""Carry ``repro``'s artifacts into the port, as numpy arrays.

The port has no weights; what the reference builds — graphs, staged tile
tensors, level schedules — stands in for them.  Each function takes the
numpy form of a ``repro`` object (the caller converts, so this module
imports nothing of ``repro``) and returns the port's object, so the
port's fixpoint can run on the exact tiles and schedule ``repro`` built.
"""

from __future__ import annotations

import numpy as np

import torch

from repro_torch import resolve_device
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
