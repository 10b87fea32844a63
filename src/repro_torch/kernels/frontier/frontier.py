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
bucket_level_blocks    f32          f32          B1 ``fused_level_f32``
bucket_level_blocks    f32          int32 bits   B3 ``fused_level_f32_u32tiles``
frontier_step_blocks   f32          f32          B5 ``frontier_step_f32``
=====================  ===========  ===========  =========================

:func:`bucket_level_blocks` is the site-sharded backend's level: B1 or B3
launched once over all member sites of a shape bucket, on a work list
that concatenates the members' (``ops.bucket_work``).

All five kernels walk a work list: the valid steps of each run cut into
chunks (``ops.level_work``; chunks of 1 on f32 tiles, of 2 on
bit-planes), one CTA per chunk, built once per plan
(``FusedLevelPlan.work``, which the fused and the packed level share) or
per label store (``BlockedGraph`` entries).

For CUDA tensors the wrappers launch the hand-written kernels of
``csrc/fused_level.cu``, two bodies that prefetch their operands by
``cp.async``: B1, B2 and B5 on f32 tiles (one body on two schedules and
two combine policies), B3 and B4 on bit-planes (one body on the two
policies); they raise on anything the kernels do not take.  For CPU
tensors they run the plain PyTorch versions.  There is no fallback from
the one to the other.  Each kernel has its own launch count
(:func:`launch_counts`).

Exact: every kernel puts its chunks' results into a zeroed output with
atomics, in no fixed order.  B2 and B4 OR lane words, which is exact in
any order: they equal their plain versions bit for bit.  B1, B3 and B5
add sums, which gives the plain version's bits when every frontier and
tile entry is a non-negative integer and every output sum is below
2^24: every partial sum is then an integer below 2^24, which f32 adds
exactly in any order (``repro``'s caveat for counts,
``count_paths_bounded``).  The BFS levels pass {0,1};
``ops.count_paths_bounded`` passes run counts, exact while its length
bound keeps them below 2^24.
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
    taken with ``& 1``; the pad bits past column B are sliced off.  No
    tile (n = 0, a level with no valid step) unpacks to none."""
    bits = (tiles.unsqueeze(-1) >> _shifts(tiles.device)) & 1
    return bits.reshape(*tiles.shape[:-1], 32 * tiles.shape[-1])[..., :block_size].float()


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


def _check(frontier, tiles, ints, block_size, q_pad, n_out_rows, frontier_dtype) -> None:
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
    for name, t in {"frontier": frontier, "tiles": tiles, **ints}.items():
        if t.device != frontier.device:
            raise ValueError(f"{name} is on {t.device}, frontier on {frontier.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in ints.items():
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")


def _check_runs(run_ptr, frontier, block_size, q_pad, n_out_rows, rows: int | None = None) -> None:
    """``run_ptr`` holds exactly one run per output block: (n_blocks + 1,)
    for a plan, or (rows, n_blocks + 1), one row of offsets per member of
    a bucket."""
    n_blocks = (n_out_rows // q_pad) * (frontier.shape[1] // block_size)
    want = (n_blocks + 1,) if rows is None else (rows, n_blocks + 1)
    if run_ptr.device != frontier.device:
        raise ValueError(f"run_ptr is on {run_ptr.device}, frontier on {frontier.device}")
    if run_ptr.dtype != torch.int32 or tuple(run_ptr.shape) != want:
        raise ValueError(
            f"run_ptr {run_ptr.dtype} {tuple(run_ptr.shape)} for {n_blocks} output blocks: the "
            f"schedule must hold exactly one run per output block (int32 {want})"
        )


def _launch_level(entry, frontier_dtype, frontier, tiles, ints, block_size, q_pad, n_out_rows,
                  run_ptr, work, rows: int | None = None) -> tuple[torch.Tensor, bool]:
    """Checks one level's operands (a ``frontier_dtype`` frontier), zeroes
    its output and launches level kernel ``entry`` of
    ``csrc/fused_level.cu`` over the work list, one CTA per chunk; returns
    the output and whether it launched.  Every level kernel puts its
    chunks into the zeroed output with atomics: cover-only blocks have no
    chunk, and a plan with no valid step launches nothing.  ``run_ptr``
    is a plan's run offsets, or with ``rows`` a bucket's, one row per
    member (:func:`_check_runs`)."""
    _check(frontier, tiles, ints, block_size, q_pad, n_out_rows, frontier_dtype)
    _check_runs(run_ptr, frontier, block_size, q_pad, n_out_rows, rows)
    _check_work(work, frontier, tiles)
    out = torch.zeros((n_out_rows, frontier.shape[1]), dtype=frontier.dtype, device=frontier.device)
    if not work.shape[0]:
        return out, False
    fn = getattr(_build.load("fused_level"), entry)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(frontier.device):
        err = fn(
            frontier.data_ptr(), tiles.data_ptr(), ints["tile_ids"].data_ptr(),
            ints["f_rows"].data_ptr(), ints["f_cols"].data_ptr(), ints["o_rows"].data_ptr(),
            ints["o_cols"].data_ptr(), work.data_ptr(), out.data_ptr(), work.shape[0],
            work.shape[1], frontier.shape[1], block_size, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    return out, True


def _check_work(work: torch.Tensor | None, frontier: torch.Tensor, tiles: torch.Tensor) -> None:
    if work is None:
        raise ValueError("a kernel on CUDA needs its work list: work=plan.work, or a "
                         "BlockedGraph entry's")
    if work.dtype != torch.int32 or work.dim() != 2 or not 1 <= work.shape[1] <= 8:
        raise TypeError(f"work must be a 2-D int32 tensor of 1 to 8 columns, got {work.dtype} "
                        f"{tuple(work.shape)}")
    if work.device != frontier.device:
        raise ValueError(f"work is on {work.device}, frontier on {frontier.device}")
    if not work.is_contiguous():
        raise ValueError("work must be contiguous")
    if frontier.data_ptr() % 16 or tiles.data_ptr() % 16:
        raise ValueError("frontier and tiles must start on 16-byte boundaries (cp.async)")


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
    work: torch.Tensor | None = None,  # (n_chunks, C) int32 (FusedLevelPlan.work)
    n_out_rows: int | None = None,  # output height; default = frontier height
) -> torch.Tensor:
    """One BFS level over ALL transitions: raw f32 counts (n_out_rows, v_pad).

    Steps must be sorted by (o_rows, o_cols) and cover every output block
    (the plan builder adds zero-tile cover steps).  ``run_ptr`` are the
    CSR offsets of the output-block runs (``FusedLevelPlan.run_ptr``),
    checked to hold exactly one run per output block; ``firsts`` stays
    in the signature for parity with ``repro``.  ``work`` is the plan's
    work list (``FusedLevelPlan.work``, :func:`ops.level_work`), which B1
    and B3 walk: required on CUDA for both tile stores, unread on the
    CPU.  The tile store picks the kernel, as ``repro`` dispatches on
    ``tiles.dtype``: f32 tiles B1, int32 bit-planes B3.  On CPU tensors
    this is :func:`fused_level_blocks_plain`; on CUDA tensors it
    launches the kernel or raises.

    Exact, as the plain version is, while every frontier and tile entry
    is a non-negative integer and every output sum is below 2^24: the
    kernels add their chunks' sums with atomics, in no fixed order, and
    f32 adds integers below 2^24 exactly in any order."""
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
    bits = tiles.dtype == torch.int32
    out, launched = _launch_level(
        "fused_level_f32_u32tiles" if bits else "fused_level_f32", torch.float32, frontier,
        tiles, ints, block_size, q_pad, n_out_rows, run_ptr, work,
    )
    if launched and bits:
        LAUNCHES_U32 += 1
    elif launched:
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
    work: torch.Tensor | None = None,  # (n_chunks, C) int32 (FusedLevelPlan.work)
    n_out_rows: int | None = None,
) -> torch.Tensor:
    """One lane-packed BFS level over ALL transitions: the OR-accumulated
    int32 words (n_out_rows, v_pad), ``out[r, j] |= f[r, v]`` for every
    tile entry ``a[v, j] != 0`` — :func:`fused_level_blocks` with 32
    query lanes per word.  Same schedule, work list and checks as
    :func:`fused_level_blocks`: ``work`` (``FusedLevelPlan.work``) is
    required on CUDA for both tile stores and unread on the CPU; f32
    tiles launch B2, int32 bit-planes B4.  On CPU tensors this is
    :func:`packed_level_blocks_plain`; on CUDA tensors it launches the
    kernel or raises.  The kernels OR their chunks' words into a zeroed
    output with atomics: exact in any order."""
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
    bits = tiles.dtype == torch.int32
    out, launched = _launch_level(
        "packed_level_u32tiles" if bits else "packed_level_f32tiles", torch.int32, frontier,
        tiles, ints, block_size, q_pad, n_out_rows, run_ptr, work,
    )
    if launched and bits:
        PACKED_LAUNCHES_U32 += 1
    elif launched:
        PACKED_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# B1 and B3 on a shape bucket of the site-sharded backend
# ---------------------------------------------------------------------------


def bucket_level_blocks_plain(
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
    """:func:`bucket_level_blocks` in plain PyTorch:
    :func:`fused_level_blocks_plain` on each member row's tiles and
    schedule, summed over the rows."""
    out = None
    for r in range(tiles.shape[0]):
        counts = fused_level_blocks_plain(
            frontier, tiles[r], firsts[r], valids[r], tile_ids[r], f_rows[r], f_cols[r],
            o_rows[r], o_cols[r], block_size, q_pad, n_out_rows=n_out_rows,
        )
        out = counts if out is None else out + counts
    return out


def bucket_level_blocks(
    frontier: torch.Tensor,  # (n_rows * q_pad, v_pad) f32 0/1 (union rows appended)
    tiles: torch.Tensor,  # (rows, n_tiles, B, B) f32 or (rows, n_tiles, B, ⌈B/32⌉) int32 bits
    firsts: torch.Tensor,  # (rows, n_steps) int32: the bucket's seven step arrays,
    valids: torch.Tensor,  # each row a member site's schedule over its own tiles
    tile_ids: torch.Tensor,
    f_rows: torch.Tensor,
    f_cols: torch.Tensor,
    o_rows: torch.Tensor,
    o_cols: torch.Tensor,
    block_size: int,
    q_pad: int,
    *,
    run_ptr: torch.Tensor,  # (rows, n_blocks + 1) int32 per-row run offsets (PlanBucket.run_ptr)
    work: torch.Tensor | None = None,  # (n_chunks, C) int32 flattened steps (PlanBucket.work)
    flat_tile_ids: torch.Tensor | None = None,  # (rows * n_steps,) int32 (PlanBucket.flat_tile_ids)
    n_out_rows: int | None = None,
) -> torch.Tensor:
    """One BFS level over every member site of a shape bucket: the raw f32
    counts (n_out_rows, v_pad) summed over the members — ``repro``'s
    ``vmap`` of ``fused_level_blocks`` over the bucket's rows, merged.

    On CUDA tensors this is ONE launch of B1 (f32 tiles) or B3 (bit-plane
    tiles) on the bucket's flattened operands: the (rows · n_tiles, B, ·)
    tile stack, ``flat_tile_ids`` into it, the other step arrays
    flattened, and the bucket's ``work`` list, whose chunks of different
    members may write one output block.  The kernels add every chunk
    into a zeroed output with atomics, so the launch is the members'
    sum, with no change to their bodies; it counts as a B1 or B3 launch.
    ``run_ptr``, ``work`` and ``flat_tile_ids`` are required there and
    unread on the CPU, where this is :func:`bucket_level_blocks_plain`.

    Exact, as the plain version is, while every sum is an integer below
    2^24 (see :func:`fused_level_blocks`); the sharded executor passes
    {0,1} operands, so a sum is at most the member count."""
    global LAUNCHES, LAUNCHES_U32
    n_out_rows = n_out_rows or frontier.shape[0]
    if frontier.device.type == "cpu":
        return bucket_level_blocks_plain(
            frontier, tiles, firsts, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
            block_size, q_pad, n_out_rows=n_out_rows,
        )
    if frontier.device.type != "cuda":
        raise ValueError(f"bucket_level_blocks runs on cuda or cpu tensors, got {frontier.device}")
    if tiles.dim() != 4 or flat_tile_ids is None:
        raise ValueError("a bucket launch takes (rows, n_tiles, B, ·) tiles and flat_tile_ids=")
    rows, n_steps = tile_ids.shape
    if tuple(flat_tile_ids.shape) != (rows * n_steps,):
        raise ValueError(f"flat_tile_ids {tuple(flat_tile_ids.shape)} for {rows} x {n_steps} steps")
    flat = [firsts, valids, flat_tile_ids, f_rows, f_cols, o_rows, o_cols]
    ints = dict(zip(_I32, (t.reshape(-1) for t in flat)))
    bits = tiles.dtype == torch.int32
    out, launched = _launch_level(
        "fused_level_f32_u32tiles" if bits else "fused_level_f32", torch.float32, frontier,
        tiles.reshape(-1, *tiles.shape[2:]), ints, block_size, q_pad, n_out_rows, run_ptr, work,
        rows=rows,
    )
    if launched and bits:
        LAUNCHES_U32 += 1
    elif launched:
        LAUNCHES += 1
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


def _check_step(frontier, tiles, block_rows, block_cols, block_size, work) -> None:
    if block_size % 8 or not 8 <= block_size <= 1024:
        raise ValueError(f"block_size must be a multiple of 8 up to 1024, got {block_size}")
    if frontier.dtype != torch.float32 or frontier.dim() != 2:
        raise TypeError(f"frontier must be a 2-D float32 tensor, got {frontier.dtype}")
    m_pad, v_pad = frontier.shape
    if m_pad % 8 or v_pad % block_size or m_pad > 8 * 65535:
        raise ValueError(
            f"frontier {tuple(frontier.shape)} does not tile into (8, {block_size}) blocks"
        )
    if tiles.dtype != torch.float32:
        raise TypeError(f"tiles must be float32, got {tiles.dtype}")
    nnz = tiles.shape[0]
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (block_size, block_size):
        raise ValueError(f"tiles must be (nnz, {block_size}, {block_size}), got {tuple(tiles.shape)}")
    named = {"frontier": frontier, "tiles": tiles, "block_rows": block_rows,
             "block_cols": block_cols}
    for name, t in named.items():
        if t.device != frontier.device:
            raise ValueError(f"{name} is on {t.device}, frontier on {frontier.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("block_rows", "block_cols"):
        if named[name].dtype != torch.int32 or named[name].dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    if block_rows.shape[0] != nnz or block_cols.shape[0] != nnz:
        raise ValueError(f"block_rows and block_cols must hold one entry per tile ({nnz})")
    if nnz == 0:
        raise ValueError("an empty tile list: stores with no edges are not blocked")
    _check_work(work, frontier, tiles)
    if not 1 <= work.shape[0] <= nnz:
        raise ValueError(f"a work list of {work.shape[0]} chunks for {nnz} tiles")


def frontier_step_blocks(
    frontier: torch.Tensor,  # (m_pad, v_pad) f32 0/1, m_pad a multiple of 8
    tiles: torch.Tensor,  # (nnz, B, B) f32 0/1, sorted by block col
    block_rows: torch.Tensor,  # (nnz,) int32
    block_cols: torch.Tensor,  # (nnz,) int32, non-decreasing
    block_size: int,
    *,
    work: torch.Tensor,  # (n_chunks, C) int32: the store's work list
) -> torch.Tensor:
    """One (transition × label store) block product: the raw f32 counts
    (m_pad, v_pad), ``out[:, cols[i]] += F[:, rows[i]] @ tiles[i]``; the
    caller thresholds.  ``work`` is the store's work list, built once
    with the store (``ops.store_work``): its tiles in order, cut into
    chunks inside each column's run, which the kernel gives one CTA per
    8-row block each.  Column blocks no tile visits are zero, where
    ``repro``'s Pallas kernel leaves them unwritten.  On CPU tensors this
    is :func:`frontier_step_blocks_plain` and ``work`` is unread; on CUDA
    tensors it launches B5 or raises.

    Exact, as the plain version is, while every frontier and tile entry
    is a non-negative integer and every output sum is below 2^24: the
    kernel adds its chunks' sums with atomics, in no fixed order."""
    global STEP_LAUNCHES
    if frontier.device.type == "cpu":
        return frontier_step_blocks_plain(frontier, tiles, block_rows, block_cols, block_size)
    if frontier.device.type != "cuda":
        raise ValueError(f"frontier_step_blocks runs on cuda or cpu tensors, got {frontier.device}")
    _check_step(frontier, tiles, block_rows, block_cols, block_size, work)
    m_pad, v_pad = frontier.shape
    out = torch.zeros((m_pad, v_pad), dtype=torch.float32, device=frontier.device)
    fn = _build.load("fused_level").frontier_step_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(frontier.device):
        err = fn(
            frontier.data_ptr(), tiles.data_ptr(), block_rows.data_ptr(), block_cols.data_ptr(),
            work.data_ptr(), out.data_ptr(), work.shape[0], work.shape[1], m_pad, v_pad,
            block_size, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"frontier_step_f32 launch failed with CUDA error {err}")
    STEP_LAUNCHES += 1
    return out
