"""The port on the card: the CUDA fused level against its plain PyTorch
version, the wrapper's refusals, and the S2 executor on the GPU against
the same executor on the CPU.  A CUDA kernel has no CPU mode, so every
test here is marked ``gpu`` and skips without a CUDA device; run them on
a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every comparison is exact: operands are {0,1} and every sum is an
integer below 2^24, so f32 is exact in any order."""

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
        pytest.skip("needs a CUDA device: the fused level kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's bmm in full f32
    return torch.device("cuda")


def _plan(case, device):
    factory, block, expr = CASES[case]
    g = factory()
    return ops.build_level_plan(paa.compile_query(expr, g), g, block_size=block, device=device)


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
