"""Host-side block packing and a dense numpy oracle for the frontier kernel.

Port of ``repro/kernels/frontier/ref.py``: the numpy functions verbatim
(the two ``jnp`` oracles of the per-transition baseline wait for its
slice, B5).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.automaton import FWD

# Tile-store dtypes a Stage-A staging may carry.  ``"f32"`` is the dense
# 0/1 tensor every semiring can run (boolean, witness levels, counting);
# ``"uint32"`` packs the dst axis into bit-planes — ``tile_words(B)``
# uint32 words per row, dst ``d`` at word ``d // 32`` bit ``d % 32``,
# mirroring the frontier's ``pack_lane_masks`` layout — a 32× smaller
# store that only the boolean semiring can consume.
TILE_DTYPES = ("f32", "uint32")


def tile_words(block_size: int) -> int:
    """uint32 words per tile row at ``tile_dtype="uint32"``."""
    return -(-block_size // 32)


def unpack_tiles(tiles: np.ndarray, block_size: int) -> np.ndarray:
    """Expand a bitpacked (nnz, B, W) uint32 tile tensor back to the
    dense (nnz, B, B) f32 0/1 form — the inverse of the ``"uint32"``
    packing path, used by oracles and byte-identity tests.  A f32 tensor
    passes through unchanged."""
    tiles = np.asarray(tiles)
    if tiles.dtype != np.uint32:
        return tiles
    nnz, b, w = tiles.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = (tiles[:, :, :, None] >> shifts) & np.uint32(1)
    return bits.reshape(nnz, b, w * 32)[:, :, :block_size].astype(np.float32)


def _scatter_edges(
    tiles: np.ndarray, idx: np.ndarray, s: np.ndarray, d: np.ndarray, block_size: int
) -> None:
    """Scatter one edge slice into the tile tensor (dtype-dispatched):
    f32 tiles set the (src, dst) cell to 1, uint32 tiles OR the dst bit
    into its word plane (``bitwise_or.at`` — duplicate edges must not
    drop bits the way a fancy-indexed assignment would)."""
    if tiles.dtype == np.uint32:
        np.bitwise_or.at(
            tiles,
            (idx, s % block_size, (d % block_size) // 32),
            np.uint32(1) << ((d % block_size) % 32).astype(np.uint32),
        )
    else:
        tiles[idx, s % block_size, d % block_size] = 1.0


def _alloc_tiles(nnz: int, block_size: int, tile_dtype: str) -> np.ndarray:
    if tile_dtype not in TILE_DTYPES:
        raise ValueError(f"tile_dtype must be one of {TILE_DTYPES}, got {tile_dtype!r}")
    if tile_dtype == "uint32":
        return np.zeros((max(nnz, 1), block_size, tile_words(block_size)), np.uint32)
    return np.zeros((max(nnz, 1), block_size, block_size), np.float32)


def pack_blocks(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    block_size: int,
    tile_dtype: str = "f32",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pack one label's edge list into dense B×B tiles (block-sparse).

    Returns (tiles (nnz,B,B) f32, block_rows, block_cols sorted by col) and
    the padded node count.  ``tile_dtype="uint32"`` packs the dst axis
    into bit-planes instead — tiles become (nnz, B, ceil(B/32)) uint32
    with dst ``d`` at word ``d // 32`` bit ``d % 32`` — the same block
    layout (rows/cols/order byte-identical to the f32 path) at 1/32 the
    bytes; :func:`unpack_tiles` recovers the dense form exactly."""
    v_pad = -(-n_nodes // block_size) * block_size
    br = src // block_size
    bc = dst // block_size
    keys = bc.astype(np.int64) * (v_pad // block_size) + br
    uniq, inv = np.unique(keys, return_inverse=True)
    nnz = len(uniq)
    tiles = _alloc_tiles(nnz, block_size, tile_dtype)
    rows = (uniq % (v_pad // block_size)).astype(np.int32)
    cols = (uniq // (v_pad // block_size)).astype(np.int32)
    _scatter_edges(tiles, inv, src, dst, block_size)
    if nnz == 0:
        rows = np.zeros(1, np.int32)
        cols = np.zeros(1, np.int32)
    return tiles, rows, cols, v_pad


def pack_blocks_chunked(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    block_size: int,
    chunk_edges: int,
    tile_dtype: str = "f32",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Streaming :func:`pack_blocks`: byte-identical tiles, but the edge
    list is consumed in ``chunk_edges``-sized slices so peak host memory
    *beyond the output tensor* is bounded by the chunk size, not |E|.

    Two passes: pass 1 folds each chunk's distinct block keys into a
    sorted union (fixing the tile layout and total nnz without ever
    materializing the full per-edge key/inverse arrays the one-shot
    ``np.unique`` needs); pass 2 allocates the final tile tensor once
    and scatters each chunk's edges into it.  Key order is
    ``block_col · nb + block_row`` — the one-shot sort order — so rows,
    cols, and tile contents match :func:`pack_blocks` exactly (at either
    ``tile_dtype``).

    Returns ``(tiles, rows, cols, v_pad, n_chunks)``.
    """
    chunk_edges = max(int(chunk_edges), 1)
    v_pad = -(-n_nodes // block_size) * block_size
    nb = v_pad // block_size
    n_edges = len(src)
    n_chunks = max(-(-n_edges // chunk_edges), 1)

    uniq = np.zeros(0, np.int64)
    for lo in range(0, n_edges, chunk_edges):
        s, d = src[lo : lo + chunk_edges], dst[lo : lo + chunk_edges]
        keys = (d // block_size).astype(np.int64) * nb + s // block_size
        uniq = np.union1d(uniq, keys)  # stays sorted = pack_blocks order

    nnz = len(uniq)
    tiles = _alloc_tiles(nnz, block_size, tile_dtype)
    rows = (uniq % nb).astype(np.int32)
    cols = (uniq // nb).astype(np.int32)
    for lo in range(0, n_edges, chunk_edges):
        s, d = src[lo : lo + chunk_edges], dst[lo : lo + chunk_edges]
        keys = (d // block_size).astype(np.int64) * nb + s // block_size
        idx = np.searchsorted(uniq, keys)
        _scatter_edges(tiles, idx, s, d, block_size)
    if nnz == 0:
        rows = np.zeros(1, np.int32)
        cols = np.zeros(1, np.int32)
    return tiles, rows, cols, v_pad, n_chunks


def fused_level_ref(ca, graph, frontier: np.ndarray) -> np.ndarray:
    """Dense numpy oracle for one fused multi-query level.

    ``frontier`` is (n_states, Q, v_pad) 0/1; returns the same-shaped 0/1
    expansion: for every grounded transition (wildcards over all labels,
    INV over the transposed adjacency), out[dst] |= frontier[src] @ A.
    """
    _, _, v_pad = frontier.shape
    dense: dict[tuple[int, int], np.ndarray] = {}

    def adj_for(label_id: int, direction: int) -> np.ndarray:
        key = (label_id, direction)
        if key not in dense:
            a = np.zeros((v_pad, v_pad), np.float32)
            sel = slice(None) if label_id < 0 else graph.lbl == label_id
            src, dst = graph.src[sel], graph.dst[sel]
            if direction == FWD:
                a[src, dst] = 1.0
            else:
                a[dst, src] = 1.0
            dense[key] = a
        return dense[key]

    out = np.zeros_like(frontier)
    for t in ca.transitions:
        a = adj_for(t.label_id, t.direction)
        out[t.dst] = np.maximum(out[t.dst], np.minimum(frontier[t.src] @ a, 1.0))
    return (out > 0).astype(np.float32)
