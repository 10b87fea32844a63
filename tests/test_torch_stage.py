"""Stage A and Stage B of the port against ``repro``: packed tiles, the
staged tile tensor and its offsets, and the seven schedule arrays are
byte-identical (both sides are the same numpy indexing on the same
seeded graphs), and the port's ``run_ptr`` holds one run per output
block."""

import numpy as np
import pytest
import torch

from repro.core import paa as r_paa
from repro.graph import generators as r_gen
from repro.graph import structure as r_struct
from repro.kernels.frontier import ops as r_ops
from repro.kernels.frontier import ref as r_ref

from repro_torch.core import paa
from repro_torch.graph import generators, structure
from repro_torch.kernels.frontier import ops, ref

torch.set_num_threads(1)


def _sparse_label_graph(mod):
    """A graph whose vocabulary has a label with zero edges (l2), as in
    ``tests/test_frontier_fused.py``."""
    rng = np.random.default_rng(5)
    n_nodes, n_edges = 45, 200
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    lbl = rng.choice([0, 1, 3], n_edges).astype(np.int32)
    return mod.LabeledGraph(n_nodes, src, lbl, dst, ["l0", "l1", "l2", "l3"])


# (graph factory taking the structure/generators modules, block, queries):
# the SWEEP of tests/test_frontier_fused.py
SWEEP = [
    (lambda s, g: s.example_graph(), 8, ["a* b b", "a c (a|b)", "(a|b)+", "a* b^-1"]),
    (
        lambda s, g: g.random_labeled_graph(50, 220, 3, seed=7),
        16,
        ["l0 (l1|l2)* l0", ". l1", "l0* .^-1", "(l0|l2)+ l1?"],
    ),
    (
        lambda s, g: _sparse_label_graph(s),
        8,
        ["l0 l2 l1", "l2* l0", "(l0|l2)+", ". l3^-1", "l0 .* l3"],
    ),
]


def _graphs(case):
    factory = SWEEP[case][0]
    return factory(r_struct, r_gen), factory(structure, generators)


def _same_staging(a, b):
    tiles = np.asarray(a.tiles)
    assert b.tiles.dtype == torch.float32 and tiles.tobytes() == b.tiles.numpy().tobytes()
    assert list(a.offsets) == list(b.offsets)
    for key, (base, rows, cols) in a.offsets.items():
        b_base, b_rows, b_cols = b.offsets[key]
        assert base == b_base, key
        assert rows.tobytes() == b_rows.tobytes() and cols.tobytes() == b_cols.tobytes(), key
    assert (a.n_nodes, a.v_pad, a.block_size, a.staging_chunks, a.tile_store_bytes) == (
        b.n_nodes, b.v_pad, b.block_size, b.staging_chunks, b.tile_store_bytes
    )


@pytest.mark.parametrize("tile_dtype", ["f32", "uint32"])
@pytest.mark.parametrize("block", [8, 16])
def test_pack_blocks_byte_identical(block, tile_dtype):
    rng = np.random.default_rng(block)
    src = rng.integers(0, 70, 400).astype(np.int32)
    dst = rng.integers(0, 70, 400).astype(np.int32)  # duplicates included
    packed = ref.pack_blocks(src, dst, 70, block, tile_dtype)
    for a, b in zip(r_ref.pack_blocks(src, dst, 70, block, tile_dtype), packed):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for a, b in zip(
        r_ref.pack_blocks_chunked(src, dst, 70, block, 37, tile_dtype),
        ref.pack_blocks_chunked(src, dst, 70, block, 37, tile_dtype),
    ):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the bit-plane store unpacks to the dense f32 store, tile for tile
    dense = ref.pack_blocks(src, dst, 70, block)[0]
    assert ref.unpack_tiles(packed[0], block).tobytes() == dense.tobytes()
    if tile_dtype == "uint32":
        assert packed[0].shape[-1] == ref.tile_words(block) == r_ref.tile_words(block)


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_stage_graph_byte_identical(case, block):
    rg, tg = _graphs(case)
    _same_staging(r_ops.stage_graph(rg, block), ops.stage_graph(tg, block, device="cpu"))


def test_stage_graph_chunked_byte_identical():
    rg = r_gen.random_labeled_graph(80, 500, 4, seed=2)
    tg = generators.random_labeled_graph(80, 500, 4, seed=2)
    _same_staging(
        r_ops.stage_graph(rg, 16, chunk_edges=23),
        ops.stage_graph(tg, 16, chunk_edges=23, device="cpu"),
    )


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_schedule_arrays_byte_identical(case):
    _, block, queries = SWEEP[case]
    rg, tg = _graphs(case)
    rs, ts = r_ops.stage_graph(rg, block), ops.stage_graph(tg, block, device="cpu")
    for expr in queries:
        rp = r_ops.build_level_schedule(r_paa.compile_query(expr, rg), rs)
        tp = ops.build_level_schedule(paa.compile_query(expr, tg), ts)
        for f in ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols"):
            a, b = np.asarray(getattr(rp, f)), getattr(tp, f).numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (expr, f)
        assert rp.union_members == tp.union_members, expr
        assert rp.n_real_steps == tp.n_real_steps, expr
        assert tp.tiles is ts.tiles  # the plan aliases the staged tiles
        # one run per output block, in (o_row, o_col) order
        nb = tp.v_pad // tp.block_size
        ptr = tp.run_ptr.numpy()
        assert len(ptr) == tp.n_states * nb + 1 and ptr[0] == 0 and ptr[-1] == len(tp.firsts)
        blocks = tp.o_rows.numpy()[ptr[:-1]].astype(np.int64) * nb + tp.o_cols.numpy()[ptr[:-1]]
        assert (blocks == np.arange(tp.n_states * nb)).all(), expr
        assert (np.diff(ptr) >= 1).all() and (tp.firsts.numpy()[ptr[:-1]] == 1).all(), expr


def test_run_offsets_rejects_split_runs():
    """Two runs for one output block (what an unsorted schedule gives)
    break the one-CTA-per-block contract: Stage B raises."""
    arr = np.array([[0, 0, 0, 0, 1], [0, 1, 0, 0, 2], [0, 0, 0, 0, 3]], np.int32)
    firsts = np.array([1, 1, 1], np.int32)
    with pytest.raises(ValueError, match="one run per output block"):
        ops.run_offsets(arr, firsts, n_states=1, nb=2)


def test_required_offset_keys_and_fanin_rows_equal():
    rg, tg = _graphs(1)
    for expr in SWEEP[1][2]:
        rca, tca = r_paa.compile_query(expr, rg), paa.compile_query(expr, tg)
        assert r_ops.required_offset_keys(rca) == ops.required_offset_keys(tca)
        assert r_ops.fanin_frontier_rows(rca) == ops.fanin_frontier_rows(tca)


def test_stage_graph_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.stage_graph(structure.example_graph(), 8)


def test_uint32_store_is_not_ported_yet():
    """The uint32 store stages: int32 words (B, ⌈B/32⌉) per tile with
    ``repro``'s uint32 bits, over the f32 store's offsets (byte for byte
    against ``repro`` in tests/test_torch_tile_store.py)."""
    g = structure.example_graph()
    staged = ops.stage_graph(g, 8, tile_dtype="uint32", device="cpu")
    f32 = ops.stage_graph(g, 8, device="cpu")
    assert staged.tile_dtype == "uint32" and staged.tiles.dtype == torch.int32
    assert staged.tiles.shape == (f32.tiles.shape[0], 8, ref.tile_words(8))
    assert staged.offsets.keys() == f32.offsets.keys()
