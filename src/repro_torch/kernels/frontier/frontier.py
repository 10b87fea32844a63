"""The fused frontier level: one BFS level over all transitions.

Port of ``repro/kernels/frontier/frontier.py::fused_level_blocks`` (the
f32 body ``_fused_level_kernel``).  The frontier operand is
``(n_rows · q_pad, v_pad)``: row-block s < n_states is automaton state s,
row-blocks past n_states are fan-in union rows (``ops.extend_frontier``),
and the q_pad (= 8) rows inside a block carry up to 8 stacked queries.
For each output block (dst state ``o``, block column ``c``) the kernel
sums, over the steps of its run with ``valids == 1``::

    F[f_rows[i]·8 : +8, f_cols[i]·B : +B] @ tiles[tile_ids[i]]

and returns the raw f32 counts ``(n_out_rows, v_pad)``; callers threshold.

:func:`fused_level_blocks` launches the hand-written CUDA kernel
``csrc/fused_level.cu`` for CUDA tensors and raises on anything it does
not take; for CPU tensors it runs :func:`fused_level_blocks_plain`, the
same function in plain PyTorch.  There is no fallback from the one to
the other.  :data:`LAUNCHES` counts kernel launches.

Exact: operands are {0,1} and sums are integers below 2^24, so f32 sums
are exact in any order and the kernel equals the plain version bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# CUDA launches of the fused level kernel; the wrapper adds one per launch
LAUNCHES = 0

_I32 = ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols")
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    """:func:`fused_level_blocks` in plain PyTorch: gather the frontier
    blocks and tiles of the valid steps, ``bmm``, then ``index_add_``
    into the output blocks.  Output blocks that only cover steps reach
    stay zero (``firsts`` zero-init)."""
    del firsts  # every output block starts at zero here
    n_rows, v_pad = frontier.shape
    if n_out_rows is None:
        n_out_rows = n_rows
    nb = v_pad // block_size
    sel = torch.nonzero(valids).flatten()
    # (n_rows, q_pad, nb, B) -> block (row, col) at [row * nb + col]
    fb = frontier.reshape(n_rows // q_pad, q_pad, nb, block_size).permute(0, 2, 1, 3)
    fb = fb.reshape(-1, q_pad, block_size)
    f_idx = f_rows[sel].long() * nb + f_cols[sel].long()
    prods = torch.bmm(fb[f_idx], tiles[tile_ids[sel].long()])  # (n_valid, q_pad, B)
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


def _check(frontier, tiles, ints, block_size, q_pad, n_out_rows, run_ptr) -> None:
    if q_pad != 8:
        raise ValueError(f"the CUDA fused level takes q_pad=8, got {q_pad}")
    if block_size % 8 or not 8 <= block_size <= 1024:
        raise ValueError(f"block_size must be a multiple of 8 up to 1024, got {block_size}")
    n_rows, v_pad = frontier.shape
    if v_pad % block_size or n_rows % q_pad or n_out_rows % q_pad:
        raise ValueError(
            f"frontier {tuple(frontier.shape)} / n_out_rows={n_out_rows} do not tile "
            f"into ({q_pad}, {block_size}) blocks"
        )
    if frontier.dtype != torch.float32 or tiles.dtype != torch.float32:
        raise TypeError("frontier and tiles must be float32")
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (block_size, block_size):
        raise ValueError(f"tiles must be (n_tiles, {block_size}, {block_size}), got {tuple(tiles.shape)}")
    named = {"frontier": frontier, "tiles": tiles, "run_ptr": run_ptr, **ints}
    for name, t in named.items():
        if t.device != frontier.device:
            raise ValueError(f"{name} is on {t.device}, frontier on {frontier.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (*ints.items(), ("run_ptr", run_ptr)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")


def fused_level_blocks(
    frontier: torch.Tensor,  # (n_rows * q_pad, v_pad) f32 0/1 (union rows appended)
    tiles: torch.Tensor,  # (n_tiles, B, B) f32 0/1; index 0 is the zero cover tile
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
    the signature for parity with ``repro``.  On CPU tensors this is
    :func:`fused_level_blocks_plain`; on CUDA tensors it launches the
    CUDA kernel or raises."""
    global LAUNCHES
    n_rows, v_pad = frontier.shape
    if n_out_rows is None:
        n_out_rows = n_rows
    if frontier.device.type == "cpu":
        return fused_level_blocks_plain(
            frontier, tiles, firsts, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
            block_size, q_pad, n_out_rows=n_out_rows,
        )
    if frontier.device.type != "cuda":
        raise ValueError(f"fused_level_blocks runs on cuda or cpu tensors, got {frontier.device}")
    ints = dict(zip(_I32, (firsts, valids, tile_ids, f_rows, f_cols, o_rows, o_cols)))
    _check(frontier, tiles, ints, block_size, q_pad, n_out_rows, run_ptr)
    n_runs = run_ptr.shape[0] - 1
    if n_runs != (n_out_rows // q_pad) * (v_pad // block_size):
        raise ValueError(
            f"{n_runs} runs for {(n_out_rows // q_pad) * (v_pad // block_size)} output "
            "blocks: the schedule must hold exactly one run per output block"
        )
    lib = _build.load("fused_level")
    fn = lib.fused_level_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((n_out_rows, v_pad), dtype=torch.float32, device=frontier.device)
    with torch.cuda.device(frontier.device):
        err = fn(
            frontier.data_ptr(), tiles.data_ptr(), valids.data_ptr(), tile_ids.data_ptr(),
            f_rows.data_ptr(), f_cols.data_ptr(), o_rows.data_ptr(), o_cols.data_ptr(),
            run_ptr.data_ptr(), out.data_ptr(), n_runs, v_pad, block_size,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_level_f32 launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out
