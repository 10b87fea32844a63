"""The port on the card: the four CUDA level kernels (B1 and B3 behind
``fused_level_blocks``, B2 and B4 behind ``packed_level_blocks``) against
their plain PyTorch versions, the wrappers' refusals, and both S2
executors on both tile stores on the GPU against the same executors on
the CPU.  A CUDA kernel has no CPU mode, so every test here is marked
``gpu`` and skips without a CUDA device; run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every comparison is exact: operands are {0,1} and every sum is an
integer below 2^24, so f32 is exact in any order, and OR is exact in
any order."""

import numpy as np
import pytest
import torch

from repro_torch.core import paa, strategies
from repro_torch.graph import generators, partition, structure
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
