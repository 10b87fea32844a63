"""The frontier level kernels: the fused level over all transitions, and
the per-transition step of the baseline path.

Port of ``repro/kernels/frontier/frontier.py::fused_level_blocks`` and
``packed_level_blocks`` with their four bodies, and of
``frontier_step_blocks`` (B5, at the end of this module).  The frontier operand is
``(n_rows · q_pad, v_pad)``: row-block s < n_states is automaton state s,
row-blocks past n_states are fan-in union rows (``ops.extend_frontier``),
and the q_pad (= 8) rows inside a block carry 8 stacked queries as f32
0/1 rows, or 256 query lanes as int32 lane words (lane q = bit q % 32 of
word row q // 32).  For each output block (dst state ``o``, block column
``c``) the kernels fold, over the steps of its run with ``valids == 1``::

    F[f_rows[i]·8 : +8, f_cols[i]·B : +B]  ⊗  tiles[tile_ids[i]]

where ⊗ is the f32 product (:func:`fused_level_blocks`, raw counts, the
callers threshold) or the OR of ANDs on lane words
(:func:`packed_level_blocks`, words already boolean per bit).  Either
takes either tile store: f32 (n_tiles, B, B) 0/1, or bit-plane
(n_tiles, B, ⌈B/32⌉) words with dst d at bit d % 32 of word d // 32.
Lane words and bit-plane words live in torch as int32 with ``repro``'s
uint32 bits; the kernels read them as ``uint32_t``.

=====================  ===========  ===========  =========================
wrapper                frontier     tiles        CUDA entry point
=====================  ===========  ===========  =========================
fused_level_blocks     f32          f32          B1 ``fused_level_f32``
fused_level_blocks     f32          int32 bits   B3 ``fused_level_f32_u32tiles``
packed_level_blocks    int32 lanes  f32          B2 ``packed_level_f32tiles``
packed_level_blocks    int32 lanes  int32 bits   B4 ``packed_level_u32tiles``
frontier_step_blocks   f32          f32          B5 ``frontier_step_f32``
=====================  ===========  ===========  =========================

For CUDA tensors the wrappers launch the hand-written kernels of
``csrc/fused_level.cu`` (B1, B3 and B5, one kernel body on two
schedules) and ``csrc/packed_level.cu`` (B2, B4) and raise on
anything they do not take; for CPU tensors they run the plain PyTorch
versions.  There is no fallback from the one to the other.  Each kernel
has its own launch count (:func:`launch_counts`).

Exact: operands are {0,1} and sums are integers below 2^24, so f32 sums
are exact in any order, and OR is exact in any order: each kernel equals
its plain version bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontier.ref import tile_words

# CUDA launches per kernel; each wrapper adds one where it launches
LAUNCHES = 0  # B1: fused_level_blocks on f32 tiles
LAUNCHES_U32 = 0  # B3: fused_level_blocks on bit-plane tiles
PACKED_LAUNCHES = 0  # B2: packed_level_blocks on f32 tiles
PACKED_LAUNCHES_U32 = 0  # B4: packed_level_blocks on bit-plane tiles
STEP_LAUNCHES = 0  # B5: frontier_step_blocks

_I32 = ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols")
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def launch_counts() -> dict[str, int]:
    """Each kernel's CUDA launches so far, by the name ``chip_smoke.py``
    reports it under."""
    return {
        "fused_level_blocks": LAUNCHES,
        "fused_level_blocks_u32": LAUNCHES_U32,
        "packed_level_blocks": PACKED_LAUNCHES,
        "packed_level_blocks_u32": PACKED_LAUNCHES_U32,
        "frontier_step_blocks": STEP_LAUNCHES,
    }


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    global LAUNCHES, LAUNCHES_U32, PACKED_LAUNCHES, PACKED_LAUNCHES_U32, STEP_LAUNCHES
    LAUNCHES = LAUNCHES_U32 = PACKED_LAUNCHES = PACKED_LAUNCHES_U32 = STEP_LAUNCHES = 0


def _shifts(device: torch.device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    return torch.arange(32, dtype=dtype, device=device)


def unpack_tile_bits(tiles: torch.Tensor, block_size: int) -> torch.Tensor:
    """Bit-plane tiles (n, B, ⌈B/32⌉) int32 as dense (n, B, B) f32 0/1:
    dst d is bit d % 32 of word d // 32 (the torch twin of
    ``ref.unpack_tiles``).  ``>>`` on int32 sign-extends, so every bit is
    taken with ``& 1``; the pad bits past column B are sliced off."""
    bits = (tiles.unsqueeze(-1) >> _shifts(tiles.device)) & 1
    return bits.reshape(*tiles.shape[:-1], -1)[..., :block_size].float()


def unpack_lane_rows(words: torch.Tensor) -> torch.Tensor:
    """Lane words (R, n) int32 as (32·R, n) f32 0/1 lanes: bit k of word
    row w becomes row 32·w + k, so a packed frontier (n_rows · 8, v_pad)
    unpacks to (n_rows · 256, v_pad) with lane q of row-block s at row
    256·s + q."""
    r, n = words.shape
    bits = (words.reshape(r, 1, n) >> _shifts(words.device).reshape(1, 32, 1)) & 1
    return bits.reshape(r * 32, n).float()


def pack_lane_rows(lanes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpack_lane_rows`: (32·R, n) 0/1 rows as (R, n)
    int32 words.  The 32 bits are summed in int64 and cast down, which
    keeps bit 31 as int32's sign bit."""
    r32, n = lanes.shape
    bits = lanes.reshape(r32 // 32, 32, n).to(torch.int64)
    words = (bits << _shifts(lanes.device, torch.int64).reshape(1, 32, 1)).sum(dim=1)
    return words.to(torch.int32)


def _plain_level(
    frontier, tiles, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
    block_size, q_pad, n_out_rows, boolean_tiles,
) -> torch.Tensor:
    """The f32 level in plain PyTorch: gather the frontier blocks and
    tiles of the valid steps (bit-plane tiles unpacked, and with
    ``boolean_tiles`` f32 tiles thresholded ``!= 0``), ``bmm``, then
    ``index_add_`` into the output blocks.  Only the gathered tiles are
    unpacked, never the whole store."""
    n_rows, v_pad = frontier.shape
    nb = v_pad // block_size
    sel = torch.nonzero(valids).flatten()
    # (n_rows, q_pad, nb, B) -> block (row, col) at [row * nb + col]
    fb = frontier.reshape(n_rows // q_pad, q_pad, nb, block_size).permute(0, 2, 1, 3)
    fb = fb.reshape(-1, q_pad, block_size)
    f_idx = f_rows[sel].long() * nb + f_cols[sel].long()
    a = tiles[tile_ids[sel].long()]
    if a.dtype == torch.int32:
        a = unpack_tile_bits(a, block_size)
    elif boolean_tiles:
        a = (a != 0).float()
    prods = torch.bmm(fb[f_idx], a)  # (n_valid, q_pad, B)
    out = torch.zeros(
        (n_out_rows // q_pad) * nb, q_pad, block_size,
        dtype=torch.float32, device=frontier.device,
    )
    out.index_add_(0, o_rows[sel].long() * nb + o_cols[sel].long(), prods)
    return (
        out.reshape(n_out_rows // q_pad, nb, q_pad, block_size)
        .permute(0, 2, 1, 3)
        .reshape(n_out_rows, v_pad)
    )


def fused_level_blocks_plain(
    frontier: torch.Tensor,
    tiles: torch.Tensor,
    firsts: torch.Tensor,
    valids: torch.Tensor,
    tile_ids: torch.Tensor,
    f_rows: torch.Tensor,
    f_cols: torch.Tensor,
    o_rows: torch.Tensor,
    o_cols: torch.Tensor,
    block_size: int,
    q_pad: int,
    *,
    n_out_rows: int | None = None,
) -> torch.Tensor:
    """:func:`fused_level_blocks` in plain PyTorch, on either tile store:
    gather, ``bmm``, ``index_add_``.  Output blocks that only cover steps
    reach stay zero (``firsts`` zero-init)."""
    del firsts  # every output block starts at zero here
    return _plain_level(
        frontier, tiles, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
        block_size, q_pad, n_out_rows or frontier.shape[0], boolean_tiles=False,
    )


def packed_level_blocks_plain(
    frontier: torch.Tensor,
    tiles: torch.Tensor,
    firsts: torch.Tensor,
    valids: torch.Tensor,
    tile_ids: torch.Tensor,
    f_rows: torch.Tensor,
    f_cols: torch.Tensor,
    o_rows: torch.Tensor,
    o_cols: torch.Tensor,
    block_size: int,
    q_pad: int,
    *,
    n_out_rows: int | None = None,
) -> torch.Tensor:
    """:func:`packed_level_blocks` in plain PyTorch: unpack the lane words
    to 32 · q_pad {0,1} f32 rows per row-block, run the f32 level on the
    boolean tiles, threshold ``> 0`` and repack the words."""
    del firsts
    n_out_rows = n_out_rows or frontier.shape[0]
    counts = _plain_level(
        unpack_lane_rows(frontier), tiles, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
        block_size, q_pad * 32, n_out_rows * 32, boolean_tiles=True,
    )
    return pack_lane_rows(counts > 0)


def _check(frontier, tiles, ints, block_size, q_pad, n_out_rows, run_ptr, frontier_dtype) -> None:
    if q_pad != 8:
        raise ValueError(f"the CUDA level kernels take q_pad=8, got {q_pad}")
    if block_size % 8 or not 8 <= block_size <= 1024:
        raise ValueError(f"block_size must be a multiple of 8 up to 1024, got {block_size}")
    n_rows, v_pad = frontier.shape
    if v_pad % block_size or n_rows % q_pad or n_out_rows % q_pad:
        raise ValueError(
            f"frontier {tuple(frontier.shape)} / n_out_rows={n_out_rows} do not tile "
            f"into ({q_pad}, {block_size}) blocks"
        )
    if frontier.dtype != frontier_dtype:
        raise TypeError(f"frontier must be {frontier_dtype}, got {frontier.dtype}")
    if tiles.dtype == torch.float32:
        row = block_size
    elif tiles.dtype == torch.int32:
        row = tile_words(block_size)
    else:
        raise TypeError(f"tiles must be float32 or int32 bit-planes, got {tiles.dtype}")
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (block_size, row):
        raise ValueError(
            f"{tiles.dtype} tiles must be (n_tiles, {block_size}, {row}), got {tuple(tiles.shape)}"
        )
    named = {"frontier": frontier, "tiles": tiles, "run_ptr": run_ptr, **ints}
    for name, t in named.items():
        if t.device != frontier.device:
            raise ValueError(f"{name} is on {t.device}, frontier on {frontier.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (*ints.items(), ("run_ptr", run_ptr)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    n_runs = run_ptr.shape[0] - 1
    if n_runs != (n_out_rows // q_pad) * (v_pad // block_size):
        raise ValueError(
            f"{n_runs} runs for {(n_out_rows // q_pad) * (v_pad // block_size)} output "
            "blocks: the schedule must hold exactly one run per output block"
        )


def _launch(lib_name, fn_name, out, frontier, tiles, valids, tile_ids, f_rows, f_cols,
            o_rows, o_cols, run_ptr, block_size) -> None:
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(frontier.device):
        err = fn(
            frontier.data_ptr(), tiles.data_ptr(), valids.data_ptr(), tile_ids.data_ptr(),
            f_rows.data_ptr(), f_cols.data_ptr(), o_rows.data_ptr(), o_cols.data_ptr(),
            run_ptr.data_ptr(), out.data_ptr(), run_ptr.shape[0] - 1, frontier.shape[1],
            block_size, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed with CUDA error {err}")


def fused_level_blocks(
    frontier: torch.Tensor,  # (n_rows * q_pad, v_pad) f32 0/1 (union rows appended)
    tiles: torch.Tensor,  # (n_tiles, B, B) f32 0/1 or (n_tiles, B, ⌈B/32⌉) int32 bits
    firsts: torch.Tensor,  # (n_steps,) int32 ∈ {0,1}: first step of an output block
    valids: torch.Tensor,  # (n_steps,) int32 ∈ {0,1}: 0 = cover step, no product
    tile_ids: torch.Tensor,  # (n_steps,) int32 into tiles
    f_rows: torch.Tensor,  # (n_steps,) int32: input row-block (state or union row)
    f_cols: torch.Tensor,  # (n_steps,) int32: input col-block = tile block row
    o_rows: torch.Tensor,  # (n_steps,) int32: output row-block = dst automaton state
    o_cols: torch.Tensor,  # (n_steps,) int32: output col-block = tile block col
    block_size: int,
    q_pad: int,
    *,
    run_ptr: torch.Tensor,  # (n_runs + 1,) int32 run offsets (FusedLevelPlan.run_ptr)
    n_out_rows: int | None = None,  # output height; default = frontier height
) -> torch.Tensor:
    """One BFS level over ALL transitions: raw f32 counts (n_out_rows, v_pad).

    Steps must be sorted by (o_rows, o_cols) and cover every output block
    (the plan builder adds zero-tile cover steps).  ``run_ptr`` are the
    CSR offsets of the output-block runs (``FusedLevelPlan.run_ptr``),
    which the kernel walks in place of ``firsts``; ``firsts`` stays in
    the signature for parity with ``repro``.  The tile store picks the
    kernel, as ``repro`` dispatches on ``tiles.dtype``: f32 tiles B1,
    int32 bit-planes B3.  On CPU tensors this is
    :func:`fused_level_blocks_plain`; on CUDA tensors it launches the
    kernel or raises."""
    global LAUNCHES, LAUNCHES_U32
    n_out_rows = n_out_rows or frontier.shape[0]
    if frontier.device.type == "cpu":
        return fused_level_blocks_plain(
            frontier, tiles, firsts, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
            block_size, q_pad, n_out_rows=n_out_rows,
        )
    if frontier.device.type != "cuda":
        raise ValueError(f"fused_level_blocks runs on cuda or cpu tensors, got {frontier.device}")
    ints = dict(zip(_I32, (firsts, valids, tile_ids, f_rows, f_cols, o_rows, o_cols)))
    _check(frontier, tiles, ints, block_size, q_pad, n_out_rows, run_ptr, torch.float32)
    bits = tiles.dtype == torch.int32
    out = torch.empty((n_out_rows, frontier.shape[1]), dtype=torch.float32, device=frontier.device)
    _launch(
        "fused_level", "fused_level_f32_u32tiles" if bits else "fused_level_f32", out,
        frontier, tiles, valids, tile_ids, f_rows, f_cols, o_rows, o_cols, run_ptr, block_size,
    )
    if bits:
        LAUNCHES_U32 += 1
    else:
        LAUNCHES += 1
    return out


def packed_level_blocks(
    frontier: torch.Tensor,  # (n_rows * q_pad, v_pad) int32 lane words
    tiles: torch.Tensor,  # (n_tiles, B, B) f32 0/1 or (n_tiles, B, ⌈B/32⌉) int32 bits
    firsts: torch.Tensor,  # (n_steps,) int32 ∈ {0,1}
    valids: torch.Tensor,  # (n_steps,) int32 ∈ {0,1}
    tile_ids: torch.Tensor,  # (n_steps,) int32 into tiles
    f_rows: torch.Tensor,  # (n_steps,) int32
    f_cols: torch.Tensor,  # (n_steps,) int32
    o_rows: torch.Tensor,  # (n_steps,) int32
    o_cols: torch.Tensor,  # (n_steps,) int32
    block_size: int,
    q_pad: int,
    *,
    run_ptr: torch.Tensor,  # (n_runs + 1,) int32 run offsets
    n_out_rows: int | None = None,
) -> torch.Tensor:
    """One lane-packed BFS level over ALL transitions: the OR-accumulated
    int32 words (n_out_rows, v_pad), ``out[r, j] |= f[r, v]`` for every
    tile entry ``a[v, j] != 0`` — :func:`fused_level_blocks` with 32
    query lanes per word.  Same schedule and checks as
    :func:`fused_level_blocks`; f32 tiles launch B2, int32 bit-planes B4.
    On CPU tensors this is :func:`packed_level_blocks_plain`; on CUDA
    tensors it launches the kernel or raises."""
    global PACKED_LAUNCHES, PACKED_LAUNCHES_U32
    n_out_rows = n_out_rows or frontier.shape[0]
    if frontier.device.type == "cpu":
        return packed_level_blocks_plain(
            frontier, tiles, firsts, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
            block_size, q_pad, n_out_rows=n_out_rows,
        )
    if frontier.device.type != "cuda":
        raise ValueError(f"packed_level_blocks runs on cuda or cpu tensors, got {frontier.device}")
    ints = dict(zip(_I32, (firsts, valids, tile_ids, f_rows, f_cols, o_rows, o_cols)))
    _check(frontier, tiles, ints, block_size, q_pad, n_out_rows, run_ptr, torch.int32)
    bits = tiles.dtype == torch.int32
    out = torch.empty((n_out_rows, frontier.shape[1]), dtype=torch.int32, device=frontier.device)
    _launch(
        "packed_level", "packed_level_u32tiles" if bits else "packed_level_f32tiles", out,
        frontier, tiles, valids, tile_ids, f_rows, f_cols, o_rows, o_cols, run_ptr, block_size,
    )
    if bits:
        PACKED_LAUNCHES_U32 += 1
    else:
        PACKED_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# B5: the per-transition step of the baseline path
# ---------------------------------------------------------------------------


def frontier_step_blocks_plain(
    frontier: torch.Tensor,
    tiles: torch.Tensor,
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    block_size: int,
) -> torch.Tensor:
    """:func:`frontier_step_blocks` in plain PyTorch: gather the frontier
    block of every tile, ``bmm``, ``index_add_`` into the output column
    blocks.  Column blocks no tile visits stay zero."""
    m_pad, v_pad = frontier.shape
    nb = v_pad // block_size
    fb = frontier.reshape(m_pad, nb, block_size).permute(1, 0, 2)  # (nb, m_pad, B)
    prods = torch.bmm(fb[block_rows.long()], tiles)  # (nnz, m_pad, B)
    out = torch.zeros((nb, m_pad, block_size), dtype=torch.float32, device=frontier.device)
    out.index_add_(0, block_cols.long(), prods)
    return out.permute(1, 0, 2).reshape(m_pad, v_pad)


def _check_step(frontier, tiles, block_rows, block_cols, block_size, run_ptr) -> None:
    if block_size % 8 or not 8 <= block_size <= 1024:
        raise ValueError(f"block_size must be a multiple of 8 up to 1024, got {block_size}")
    if frontier.dtype != torch.float32 or frontier.dim() != 2:
        raise TypeError(f"frontier must be a 2-D float32 tensor, got {frontier.dtype}")
    m_pad, v_pad = frontier.shape
    if m_pad % 8 or v_pad % block_size:
        raise ValueError(
            f"frontier {tuple(frontier.shape)} does not tile into (8, {block_size}) blocks"
        )
    if tiles.dtype != torch.float32:
        raise TypeError(f"tiles must be float32, got {tiles.dtype}")
    nnz = tiles.shape[0]
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (block_size, block_size):
        raise ValueError(f"tiles must be (nnz, {block_size}, {block_size}), got {tuple(tiles.shape)}")
    named = {"frontier": frontier, "tiles": tiles, "block_rows": block_rows,
             "block_cols": block_cols, "run_ptr": run_ptr}
    for name, t in named.items():
        if t.device != frontier.device:
            raise ValueError(f"{name} is on {t.device}, frontier on {frontier.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("block_rows", "block_cols", "run_ptr"):
        if named[name].dtype != torch.int32 or named[name].dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    if block_rows.shape[0] != nnz or block_cols.shape[0] != nnz:
        raise ValueError(f"block_rows and block_cols must hold one entry per tile ({nnz})")
    if nnz == 0:
        raise ValueError("an empty tile list: stores with no edges are not blocked")
    if not 2 <= run_ptr.shape[0] <= v_pad // block_size + 1:
        raise ValueError(
            f"run_ptr of {run_ptr.shape[0]} offsets for {v_pad // block_size} column blocks"
        )


def frontier_step_blocks(
    frontier: torch.Tensor,  # (m_pad, v_pad) f32 0/1, m_pad a multiple of 8
    tiles: torch.Tensor,  # (nnz, B, B) f32 0/1, sorted by block col
    block_rows: torch.Tensor,  # (nnz,) int32
    block_cols: torch.Tensor,  # (nnz,) int32, non-decreasing
    block_size: int,
    *,
    run_ptr: torch.Tensor,  # (n_runs + 1,) int32: offsets of each column's run
) -> torch.Tensor:
    """One (transition × label store) block product: the raw f32 counts
    (m_pad, v_pad), ``out[:, cols[i]] += F[:, rows[i]] @ tiles[i]``; the
    caller thresholds.  ``run_ptr[k] .. run_ptr[k+1]`` are the tiles of
    the k-th distinct column of ``block_cols`` (``ops.column_runs``,
    built once with the store), which the kernel gives one CTA each.
    Column blocks no tile visits are zero, where ``repro``'s Pallas
    kernel leaves them unwritten.  On CPU tensors this is
    :func:`frontier_step_blocks_plain`; on CUDA tensors it launches B5
    or raises."""
    global STEP_LAUNCHES
    if frontier.device.type == "cpu":
        return frontier_step_blocks_plain(frontier, tiles, block_rows, block_cols, block_size)
    if frontier.device.type != "cuda":
        raise ValueError(f"frontier_step_blocks runs on cuda or cpu tensors, got {frontier.device}")
    _check_step(frontier, tiles, block_rows, block_cols, block_size, run_ptr)
    m_pad, v_pad = frontier.shape
    out = torch.zeros((m_pad, v_pad), dtype=torch.float32, device=frontier.device)
    fn = _build.load("fused_level").frontier_step_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(frontier.device):
        err = fn(
            frontier.data_ptr(), tiles.data_ptr(), block_rows.data_ptr(), block_cols.data_ptr(),
            run_ptr.data_ptr(), out.data_ptr(), run_ptr.shape[0] - 1, m_pad, v_pad, block_size,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"frontier_step_f32 launch failed with CUDA error {err}")
    STEP_LAUNCHES += 1
    return out
