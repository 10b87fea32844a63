"""The port on the card: the four CUDA level kernels (B1 and B3 behind
``fused_level_blocks``, B2 and B4 behind ``packed_level_blocks``), the
baseline step B5 (``frontier_step_blocks``), EmbeddingBag B6 and flash
decode B7 against their plain PyTorch versions, the wrappers' refusals,
and the S2 executors and the baseline fixpoint on the GPU against the
same code on the CPU.  A CUDA kernel has no CPU mode, so every test here
is marked ``gpu`` and skips without a CUDA device; run them on a machine
with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The frontier comparisons are exact: operands are {0,1} and every sum is
an integer below 2^24, so f32 is exact in any order, and OR is exact in
any order.  B6 adds the same f32 values in the same order as its plain
version, so it is exact too.  B7 walks other kv tiles than its plain
version, so it is held to ``repro``'s own tolerances (2e-5 f32, 2e-2
bf16, ``tests/test_kernels.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.core import paa, strategies
from repro_torch.graph import generators, partition, structure
from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.embedbag import embedbag
from repro_torch.kernels.embedbag import ops as eb_ops
from repro_torch.kernels.frontier import frontier, ops

pytestmark = pytest.mark.gpu

# (graph, block, query): a wildcard with an inverse; a label store with
# no edges (l2); a sparse query whose output blocks are mostly cover-only
CASES = [
    (lambda: structure.example_graph(), 8, "(a|b)+ .^-1"),
    (lambda: generators.random_labeled_graph(50, 220, 3, seed=7), 16, "l0 (l1|l2)* l0"),
    (lambda: generators.random_labeled_graph(300, 500, 3, seed=11), 32, "l0 l1"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the level kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's bmm in full f32
    return torch.device("cuda")


def _plan(case, device, tile_dtype="f32"):
    factory, block, expr = CASES[case]
    g = factory()
    staged = ops.stage_graph(g, block, tile_dtype=tile_dtype, device=device)
    return ops.build_level_schedule(paa.compile_query(expr, g), staged)


def _args(plan, f):
    return (
        f, plan.tiles, plan.firsts, plan.valids, plan.tile_ids, plan.f_rows,
        plan.f_cols, plan.o_rows, plan.o_cols, plan.block_size, plan.q_pad,
    )


@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_equals_plain(cuda, case):
    plan = _plan(case, cuda)
    rows = (plan.n_states + len(plan.union_members)) * plan.q_pad
    f = (np.random.default_rng(case).random((rows, plan.v_pad)) < 0.3).astype(np.float32)
    f[:, plan.n_nodes :] = 0.0
    f = torch.from_numpy(f).to(cuda)
    n_out = plan.n_states * plan.q_pad
    before = frontier.LAUNCHES
    got = frontier.fused_level_blocks(*_args(plan, f), n_out_rows=n_out, run_ptr=plan.run_ptr)
    want = frontier.fused_level_blocks_plain(*_args(plan, f), n_out_rows=n_out)
    torch.cuda.synchronize()
    assert frontier.LAUNCHES == before + 1
    assert torch.equal(got, want)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    plan = _plan(0, cuda)
    f = torch.zeros(((plan.n_states + len(plan.union_members)) * 8, plan.v_pad), device=cuda)
    kw = {"n_out_rows": plan.n_states * 8, "run_ptr": plan.run_ptr}
    args = list(_args(plan, f))
    with pytest.raises(ValueError, match="q_pad=8"):
        frontier.fused_level_blocks(*args[:-1], 16, **kw)
    with pytest.raises(TypeError, match="int32"):
        frontier.fused_level_blocks(*args[:4], plan.tile_ids.long(), *args[5:], **kw)
    with pytest.raises(TypeError, match="float32"):
        frontier.fused_level_blocks(f.double(), *args[1:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        frontier.fused_level_blocks(f.t().contiguous().t(), *args[1:], **kw)
    with pytest.raises(ValueError, match="one run per output block"):
        frontier.fused_level_blocks(*args, n_out_rows=plan.n_states * 8, run_ptr=plan.run_ptr[:-1])


# kernel -> (wrapper, plain version, tile store, launch count name)
KERNELS = {
    "B3": (frontier.fused_level_blocks, frontier.fused_level_blocks_plain, "uint32",
           "fused_level_blocks_u32"),
    "B2": (frontier.packed_level_blocks, frontier.packed_level_blocks_plain, "f32",
           "packed_level_blocks"),
    "B4": (frontier.packed_level_blocks, frontier.packed_level_blocks_plain, "uint32",
           "packed_level_blocks_u32"),
}


def _frontier_operand(plan, wrapper, seed, device):
    """A seeded frontier with its union rows, padded columns empty: f32
    0/1 rows, or lane words over all 32 bits for the packed kernels."""
    rows = (plan.n_states + len(plan.union_members)) * plan.q_pad
    rng = np.random.default_rng(seed)
    if wrapper is frontier.fused_level_blocks:
        f = (rng.random((rows, plan.v_pad)) < 0.3).astype(np.float32)
        f[:, plan.n_nodes :] = 0.0
        return torch.from_numpy(f).to(device)
    w = rng.integers(0, 2**32, size=(rows, plan.v_pad), dtype=np.uint64).astype(np.uint32)
    w[:, plan.n_nodes :] = 0
    return torch.from_numpy(w.view(np.int32)).to(device)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_bitplane_and_packed_kernels_equal_plain(cuda, kernel, case):
    wrapper, plain, tile_dtype, count = KERNELS[kernel]
    plan = _plan(case, cuda, tile_dtype)
    f = _frontier_operand(plan, wrapper, case, cuda)
    n_out = plan.n_states * plan.q_pad
    before = frontier.launch_counts()
    got = wrapper(*_args(plan, f), n_out_rows=n_out, run_ptr=plan.run_ptr)
    want = plain(*_args(plan, f), n_out_rows=n_out)
    torch.cuda.synchronize()
    after = frontier.launch_counts()
    assert after == {**before, count: before[count] + 1}
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_bitplane_and_packed_wrappers_refuse(cuda, kernel):
    wrapper, _, tile_dtype, _ = KERNELS[kernel]
    plan = _plan(1, cuda, tile_dtype)
    f = _frontier_operand(plan, wrapper, 0, cuda)
    kw = {"n_out_rows": plan.n_states * 8, "run_ptr": plan.run_ptr}
    args = list(_args(plan, f))
    other = f.float() if f.dtype == torch.int32 else f.to(torch.int32)
    with pytest.raises(TypeError, match="frontier must be"):
        wrapper(other, *args[1:], **kw)
    with pytest.raises(TypeError, match="tiles must be"):
        wrapper(f, plan.tiles.to(torch.int16), *args[2:], **kw)
    wrong = plan.tiles[:, :, :1] if tile_dtype == "f32" else plan.tiles.repeat(1, 1, 2)
    with pytest.raises(ValueError, match="tiles must be"):
        wrapper(f, wrong.contiguous(), *args[2:], **kw)
    with pytest.raises(ValueError, match="q_pad=8"):
        wrapper(*args[:-1], 16, **kw)
    with pytest.raises(ValueError, match="one run per output block"):
        wrapper(*args, n_out_rows=plan.n_states * 8, run_ptr=plan.run_ptr[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(f.t().contiguous().t(), *args[1:], **kw)
    with pytest.raises(TypeError, match="int32"):
        wrapper(*args[:4], plan.tile_ids.long(), *args[5:], **kw)


@pytest.mark.parametrize(
    "backend, tile_dtype",
    [("frontier_kernel", "uint32"), ("frontier_kernel_packed", "f32"),
     ("frontier_kernel_packed", "uint32")],
)
def test_packed_and_bitplane_executors_on_gpu_equal_cpu(cuda, backend, tile_dtype):
    g = generators.random_labeled_graph(200, 700, 3, seed=9)
    g = structure.LabeledGraph(g.n_nodes, g.src, g.lbl, g.dst, ["a", "b", "c"])
    placement = partition.distribute(g, n_sites=4, replication_rate=0.5, seed=2)
    for expr in ("a c (a|b)", "(a|b)+", "a* b^-1"):
        ca = paa.compile_query(expr, g)
        starts = paa.valid_start_nodes(ca, g)
        run = {
            dev: strategies.s2_execute(
                placement, ca, starts, backend=backend, tile_dtype=tile_dtype, block_size=32,
                device=dev,
            )
            for dev in ("cpu", cuda)
        }
        (a_cpu, c_cpu), (a_gpu, c_gpu) = run["cpu"], run[cuda]
        assert (a_cpu == a_gpu).all() and c_cpu == c_gpu, expr


@pytest.mark.parametrize("expr", ["a c (a|b)", "(a|b)+", "a* b^-1"])
def test_s2_execute_on_gpu_equals_cpu(cuda, expr):
    g = generators.random_labeled_graph(200, 700, 3, seed=9)
    g = structure.LabeledGraph(g.n_nodes, g.src, g.lbl, g.dst, ["a", "b", "c"])
    placement = partition.distribute(g, n_sites=4, replication_rate=0.5, seed=2)
    ca = paa.compile_query(expr, g)
    starts = paa.valid_start_nodes(ca, g)
    run = {
        dev: strategies.s2_execute(
            placement, ca, starts, backend="frontier_kernel", block_size=32, device=dev
        )
        for dev in ("cpu", cuda)
    }
    (a_cpu, c_cpu), (a_gpu, c_gpu) = run["cpu"], run[cuda]
    assert (a_cpu == a_gpu).all()
    assert c_cpu == c_gpu
    oracle = paa.answers_multi_source(ca, structure.to_device_graph(g, cuda), starts)
    bs, vs = np.nonzero(a_gpu)
    assert sorted(zip(starts[bs].tolist(), vs.tolist())) == sorted(zip(*(o.tolist() for o in oracle)))


# ---------------------------------------------------------------------------
# B5: the baseline step
# ---------------------------------------------------------------------------


def _blocked(case, device):
    factory, block, expr = CASES[case]
    g = factory()
    return g, ops.make_blocked_graph(g, block, device=device), paa.compile_query(expr, g)


@pytest.mark.parametrize("m_pad", [8, 24])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_step_kernel_equals_plain(cuda, case, m_pad):
    _, bg, ca = _blocked(case, cuda)
    rng = np.random.default_rng(case)
    for t, (tiles, rows, cols, run_ptr) in ops.baseline_entries(ca, bg):
        f = (rng.random((m_pad, bg.v_pad)) < 0.3).astype(np.float32)
        f[:, bg.n_nodes :] = 0.0
        f = torch.from_numpy(f).to(cuda)
        before = frontier.launch_counts()
        got = frontier.frontier_step_blocks(f, tiles, rows, cols, bg.block_size, run_ptr=run_ptr)
        want = frontier.frontier_step_blocks_plain(f, tiles, rows, cols, bg.block_size)
        torch.cuda.synchronize()
        assert frontier.launch_counts() == {**before, "frontier_step_blocks": before["frontier_step_blocks"] + 1}
        assert torch.equal(got, want), t


def test_step_wrapper_refuses(cuda):
    _, bg, _ = _blocked(1, cuda)
    tiles, rows, cols, run_ptr = next(iter(bg.fwd.values()))
    f = torch.zeros((8, bg.v_pad), device=cuda)
    b = bg.block_size
    with pytest.raises(ValueError, match="tile into"):
        frontier.frontier_step_blocks(f[:4], tiles, rows, cols, b, run_ptr=run_ptr)
    with pytest.raises(TypeError, match="frontier must be"):
        frontier.frontier_step_blocks(f.double(), tiles, rows, cols, b, run_ptr=run_ptr)
    with pytest.raises(TypeError, match="tiles must be float32"):
        frontier.frontier_step_blocks(f, tiles.to(torch.int32), rows, cols, b, run_ptr=run_ptr)
    with pytest.raises(TypeError, match="int32"):
        frontier.frontier_step_blocks(f, tiles, rows.long(), cols, b, run_ptr=run_ptr)
    with pytest.raises(ValueError, match="one entry per tile"):
        frontier.frontier_step_blocks(f, tiles, rows[:-1], cols, b, run_ptr=run_ptr)
    with pytest.raises(ValueError, match="frontier on"):
        frontier.frontier_step_blocks(f, tiles.cpu(), rows, cols, b, run_ptr=run_ptr)
    with pytest.raises(ValueError, match="contiguous"):
        frontier.frontier_step_blocks(f.t().contiguous().t(), tiles, rows, cols, b, run_ptr=run_ptr)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_baseline_on_gpu_equals_cpu_and_fused(cuda, case):
    g, bg, ca = _blocked(case, cuda)
    _, bg_cpu, _ = _blocked(case, "cpu")
    entries = len(list(ops.baseline_entries(ca, bg)))
    for start in range(0, g.n_nodes, max(1, g.n_nodes // 8)):
        mask = np.zeros(g.n_nodes, np.float32)
        mask[start] = 1.0
        before = frontier.launch_counts()
        ops.FIXPOINT_COUNTERS.clear()
        got = ops.multi_source_reach_baseline(ca, bg, mask)
        after = frontier.launch_counts()
        launched = after["frontier_step_blocks"] - before["frontier_step_blocks"]
        assert launched == ops.FIXPOINT_COUNTERS["levels"] * entries
        assert (got == ops.multi_source_reach_baseline(ca, bg_cpu, mask)).all()
        assert (got == ops.multi_source_reach(ca, bg, mask)).all()


# ---------------------------------------------------------------------------
# B6: EmbeddingBag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, dim, n_lookup, n_bags", [(64, 8, 40, 10), (128, 128, 96, 16), (300, 300, 2000, 50)])
def test_embedding_bag_kernel_equals_plain(cuda, rows, dim, n_lookup, n_bags, dtype):
    rng = np.random.default_rng(rows)
    table = torch.from_numpy(rng.normal(size=(rows, dim)).astype(np.float32)).to(cuda, dtype)
    idx = torch.from_numpy(rng.integers(0, rows, n_lookup).astype(np.int32)).to(cuda)
    bags = torch.from_numpy(rng.integers(0, n_bags, n_lookup).astype(np.int32)).to(cuda)
    sorted_bags, order = torch.sort(bags, stable=True)
    before = embedbag.LAUNCHES
    got = embedbag.embedding_bag_sorted(table, idx[order].contiguous(), sorted_bags, n_bags)
    want = embedbag.embedding_bag_sorted_plain(table, idx[order], sorted_bags, n_bags)
    torch.cuda.synchronize()
    assert embedbag.LAUNCHES == before + 1
    assert got.dtype == dtype and torch.equal(got, want)
    cpu = eb_ops.embedding_bag(table.cpu(), idx.cpu(), bags.cpu(), n_bags)
    assert torch.equal(eb_ops.embedding_bag(table, idx, bags, n_bags).cpu(), cpu)


def test_embedding_bag_wrapper_refuses(cuda):
    table = torch.zeros((8, 4), device=cuda)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        embedbag.embedding_bag_sorted(table.double(), ids, ids, 2)
    with pytest.raises(TypeError, match="int32"):
        embedbag.embedding_bag_sorted(table, ids.long(), ids, 2)
    with pytest.raises(ValueError, match="table on"):
        embedbag.embedding_bag_sorted(table, ids.cpu(), ids, 2)
    with pytest.raises(ValueError, match="differ"):
        embedbag.embedding_bag_sorted(table, ids[:2], ids, 2)


# ---------------------------------------------------------------------------
# B7: flash decode
# ---------------------------------------------------------------------------


def _qkv(shape, dtype, device, seed):
    b, h, g, dh, s = shape
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.normal(size=sz).astype(np.float32)).to(device, dtype)
        for sz in ((b, h, dh), (b, s, g, dh), (b, s, g, dh))
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape, block, kv_len",
    [((2, 8, 4, 64, 512), 128, 495), ((1, 16, 8, 128, 1024), 256, 1007),
     ((3, 4, 1, 64, 256), 128, 5), ((2, 40, 8, 128, 512), 128, 0), ((1, 16, 2, 256, 256), 128, 200)],
)
def test_decode_kernel_equals_plain(cuda, shape, block, kv_len, dtype):
    q, k, v = _qkv(shape, dtype, cuda, sum(shape))
    n = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = decode_attn.LAUNCHES
    got = decode_attn.flash_decode_gqa(q, k, v, n, block_kv=block)
    want = decode_attn.flash_decode_gqa_plain(q, k, v, n, block_kv=block)
    torch.cuda.synchronize()
    assert decode_attn.LAUNCHES == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # and within tol of the largest |output|: outputs shrink as the cache
    # grows, so an absolute tol alone may not tell a wrong output
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.float().abs().max())


def test_decode_wrapper_refuses(cuda):
    q, k, v = _qkv((1, 8, 2, 64, 256), torch.float32, cuda, 0)
    n = torch.tensor(100, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of block_kv"):
        decode_attn.flash_decode_gqa(q, k, v, n, block_kv=96)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decode_attn.flash_decode_gqa(q.double(), k.double(), v.double(), n, block_kv=128)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decode_attn.flash_decode_gqa(q, k.bfloat16(), v, n, block_kv=128)
    with pytest.raises(TypeError, match="int32"):
        decode_attn.flash_decode_gqa(q, k, v, n.long(), block_kv=128)
    with pytest.raises(ValueError, match="q on"):
        decode_attn.flash_decode_gqa(q, k, v, n.cpu(), block_kv=128)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attn.flash_decode_gqa(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, n, block_kv=128)
    q32, k32, v32 = _qkv((1, 64, 2, 64, 256), torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="q-heads per kv group"):
        decode_attn.flash_decode_gqa(q32, k32, v32, n, block_kv=128)
