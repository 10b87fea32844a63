"""The port on the card: the four CUDA level kernels (B1 and B3 behind
``fused_level_blocks``, B2 and B4 behind ``packed_level_blocks``), the
baseline step B5 (``frontier_step_blocks``), EmbeddingBag B6 and flash
decode B7 against their plain PyTorch versions (B1 and B3 also on a
sharded shape bucket, ``bucket_level_blocks``), the wrappers' refusals,
and the S1 and S2 executors (the reference and sharded backends, witness
semantics and bounded counting too), their fixpoints replayed from CUDA
graphs against the eager loop, the branching estimator, the baseline fixpoint and the serving
runtime (``QueryService``, its plan store's device memory,
``AsyncQueryService``'s flush worker) on the GPU against the same code
on the CPU, and the mesh programs on a one-rank NCCL group against
``mesh=None``.  A CUDA kernel
has no CPU mode, so every test here is marked ``gpu`` and skips without
a CUDA device; run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The frontier comparisons are exact: operands are {0,1}, or counts, and
every sum is an integer below 2^24, so f32 is exact in any order (B1,
B3 and B5 add their chunks with atomics), and OR is exact in any order
(B2 and B4 OR theirs).  B6 adds the same values in the same order as its plain
version, rounding bf16 sums after every lookup as it does, so it is
exact too.  B7
walks other kv tiles than its plain version and merges kv splits, so it
is held to ``repro``'s own tolerances (2e-5 f32, 2e-2 bf16,
``tests/test_kernels.py``)."""

import asyncio
import dataclasses
import functools
import gc
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import dlrm_mlperf, gnn_common, lm_common, registry
from repro_torch.core import estimation, paa, regex, strategies
from repro_torch.dist import sharding as shd
from repro_torch.models import dlrm as dlrm_model
from repro_torch.models import gnn, layers, transformer
from repro_torch.core.cost_model import NetworkParams
from repro_torch.graph import generators, partition, structure, workloads
from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.embedbag import embedbag
from repro_torch.kernels.embedbag import ops as eb_ops
from repro_torch.kernels.frontier import frontier, ops
from repro_torch.serve import AsyncQueryService, QueryService, ServeConfig, plancache

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
    got = frontier.fused_level_blocks(*_args(plan, f), **_kw(plan, frontier.fused_level_blocks))
    want = frontier.fused_level_blocks_plain(*_args(plan, f), n_out_rows=n_out)
    torch.cuda.synchronize()
    assert frontier.LAUNCHES == before + 1
    assert torch.equal(got, want)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    plan = _plan(0, cuda)
    f = torch.zeros(((plan.n_states + len(plan.union_members)) * 8, plan.v_pad), device=cuda)
    kw = _kw(plan, frontier.fused_level_blocks)
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
        frontier.fused_level_blocks(*args, **{**kw, "run_ptr": plan.run_ptr[:-1]})


# kernel -> (wrapper, plain version, tile store, launch count name)
KERNELS = {
    "B3": (frontier.fused_level_blocks, frontier.fused_level_blocks_plain, "uint32",
           "fused_level_blocks_u32"),
    "B2": (frontier.packed_level_blocks, frontier.packed_level_blocks_plain, "f32",
           "packed_level_blocks"),
    "B4": (frontier.packed_level_blocks, frontier.packed_level_blocks_plain, "uint32",
           "packed_level_blocks_u32"),
}


# B1 beside them: every level kernel walks the plan's work list
LEVEL_KERNELS = {
    "B1": (frontier.fused_level_blocks, frontier.fused_level_blocks_plain, "f32",
           "fused_level_blocks"),
    **KERNELS,
}


def _kw(plan, wrapper):
    """The keywords of one level on the card: run_ptr and the plan's work
    list, which B1-B4 all walk."""
    return {"n_out_rows": plan.n_states * plan.q_pad, "run_ptr": plan.run_ptr, "work": plan.work}


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
    got = wrapper(*_args(plan, f), **_kw(plan, wrapper))
    want = plain(*_args(plan, f), n_out_rows=n_out)
    torch.cuda.synchronize()
    after = frontier.launch_counts()
    assert after == {**before, count: before[count] + 1}
    assert got.dtype == want.dtype and torch.equal(got, want)


# (graph, block, query) for B3's work list: runs of more than WORK_CHUNK
# valid steps beside output blocks made only of cover steps, at B = 16,
# 32 and 128 (the 5,000-node Alibaba twin's q1: runs of up to 24)
LONG_RUNS = [
    (lambda: generators.random_labeled_graph(200, 3000, 2, seed=3), 16, "(l0|l1)+ .^-1"),
    (lambda: generators.random_labeled_graph(300, 500, 3, seed=11), 32, "l0 l1"),
    (lambda: generators.alibaba_like(n_nodes=5000, n_edges=34000), 128,
     generators.TABLE2_QUERIES["q1"]),
]
@pytest.mark.parametrize("case", range(len(LONG_RUNS)))
@pytest.mark.parametrize("kernel", list(LEVEL_KERNELS))
def test_level_kernels_on_long_runs_equal_plain(cuda, kernel, case):
    """Each level kernel equals its plain version where runs outgrow two
    chunks and blocks hold only cover steps (``chip_smoke.py``'s case d
    adds cover steps inside the runs)."""
    wrapper, plain, tile_dtype, count = LEVEL_KERNELS[kernel]
    factory, block, expr = LONG_RUNS[case]
    g = factory()
    staged = ops.stage_graph(g, block, tile_dtype=tile_dtype, device=cuda)
    plan = ops.build_level_schedule(paa.compile_query(expr, g), staged)
    valids, ptr = plan.valids.cpu().numpy(), plan.run_ptr.cpu().numpy()
    runs = np.add.reduceat(valids, ptr[:-1])
    assert runs.max() > 2 * ops.WORK_CHUNK and (runs == 0).any()
    f = _frontier_operand(plan, wrapper, case, cuda)
    before = frontier.launch_counts()
    got = wrapper(*_args(plan, f), **_kw(plan, wrapper))
    want = plain(*_args(plan, f), n_out_rows=plan.n_states * plan.q_pad)
    torch.cuda.synchronize()
    assert frontier.launch_counts() == {**before, count: before[count] + 1}
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("kernel", list(LEVEL_KERNELS))
def test_level_wrapper_refuses_without_a_work_list(cuda, kernel):
    """B1-B4 on CUDA take only a well-formed work list, and frontier and
    tiles on 16-byte boundaries (cp.async), and launch nothing else."""
    wrapper, _, tile_dtype, _ = LEVEL_KERNELS[kernel]
    plan = _plan(1, cuda, tile_dtype)
    f = _frontier_operand(plan, wrapper, 0, cuda)
    kw = _kw(plan, wrapper)
    before = frontier.launch_counts()
    with pytest.raises(ValueError, match="work list"):
        wrapper(*_args(plan, f), **{**kw, "work": None})
    with pytest.raises(ValueError, match="work list"):
        wrapper(*_args(plan, f), n_out_rows=kw["n_out_rows"], run_ptr=plan.run_ptr)
    with pytest.raises(TypeError, match="work must be"):
        wrapper(*_args(plan, f), **{**kw, "work": plan.work.long()})
    with pytest.raises(TypeError, match="work must be"):
        wrapper(*_args(plan, f), **{**kw, "work": plan.work.flatten()})
    with pytest.raises(TypeError, match="work must be"):
        wrapper(*_args(plan, f), **{**kw, "work": plan.work.repeat(1, 9)})
    with pytest.raises(ValueError, match="work is on"):
        wrapper(*_args(plan, f), **{**kw, "work": plan.work.cpu()})
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(*_args(plan, f), **{**kw, "work": plan.work.repeat(1, 2)[:, ::2]})
    shifted = torch.zeros(f.numel() + 1, dtype=f.dtype, device=cuda)[1:].view(f.shape)  # 4 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        wrapper(shifted, *_args(plan, f)[1:], **kw)
    assert frontier.launch_counts() == before


# (kernel, chunk): work lists of other chunk lengths than Stage B's
# (1 on f32 tiles, 2 on bit-planes)
LONGER_CHUNKS = [("B1", 2), ("B1", 3), ("B1", 8), ("B2", 2), ("B2", 3), ("B2", 8),
                 ("B4", 1), ("B4", 3), ("B4", 8)]


@pytest.mark.parametrize("kernel, chunk", LONGER_CHUNKS)
@pytest.mark.parametrize("case", range(len(LONG_RUNS)))
def test_f32_level_kernel_on_longer_chunks_equals_plain(cuda, case, kernel, chunk):
    """B1 and B2 on work lists of longer chunks than Stage B's (a chunk's
    steps then pass through the ring one after another), and B4 on
    chunks of 1, 3 and 8: torch.equal to plain, and two calls give the
    same bits."""
    wrapper, plain, tile_dtype, _ = LEVEL_KERNELS[kernel]
    factory, block, expr = LONG_RUNS[case]
    g = factory()
    staged = ops.stage_graph(g, block, tile_dtype=tile_dtype, device=cuda)
    plan = ops.build_level_schedule(paa.compile_query(expr, g), staged)
    assert plan.work.shape[1] == ops.work_chunk(tile_dtype) != chunk
    work = torch.from_numpy(ops.level_work(
        plan.valids.cpu().numpy(), plan.run_ptr.cpu().numpy(), chunk)).to(cuda)
    f = _frontier_operand(plan, wrapper, case, cuda)
    kw = {**_kw(plan, wrapper), "work": work}
    got = wrapper(*_args(plan, f), **kw)
    again = wrapper(*_args(plan, f), **kw)
    want = plain(*_args(plan, f), n_out_rows=kw["n_out_rows"])
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)


def _complete_graph(n: int) -> structure.LabeledGraph:
    """Every ordered pair of n nodes joined by an l0 edge: every tile of
    the store is full."""
    s, d = np.meshgrid(np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32), indexing="ij")
    return structure.LabeledGraph(n, s.ravel(), np.zeros(n * n, np.int32), d.ravel(), ["l0"])


@pytest.mark.parametrize("kernel", ["B2", "B4"])
def test_packed_kernels_or_into_words_already_set(cuda, kernel):
    """B2 and B4 on runs of 8 full tiles (8 chunks of 1, or 4 of 2) from
    a frontier of all-ones words: every chunk after a block's first sets
    only bits an earlier chunk already set, and the atomicOrs leave every
    word of those blocks exactly all ones, as the plain version does."""
    wrapper, plain, tile_dtype, count = KERNELS[kernel]
    g = _complete_graph(128)
    staged = ops.stage_graph(g, 16, tile_dtype=tile_dtype, device=cuda)
    plan = ops.build_level_schedule(paa.compile_query("l0+", g), staged)
    runs = np.add.reduceat(plan.valids.cpu().numpy(), plan.run_ptr.cpu().numpy()[:-1])
    long_runs = np.nonzero(runs > 2 * plan.work.shape[1])[0]
    assert len(long_runs)
    rows = (plan.n_states + len(plan.union_members)) * plan.q_pad
    f = torch.full((rows, plan.v_pad), -1, dtype=torch.int32, device=cuda)
    before = frontier.launch_counts()
    got = wrapper(*_args(plan, f), **_kw(plan, wrapper))
    again = wrapper(*_args(plan, f), **_kw(plan, wrapper))
    want = plain(*_args(plan, f), n_out_rows=plan.n_states * plan.q_pad)
    torch.cuda.synchronize()
    assert frontier.launch_counts() == {**before, count: before[count] + 2}
    assert torch.equal(got, want) and torch.equal(got, again)
    nb, b = plan.v_pad // plan.block_size, plan.block_size
    for k in long_runs:
        o, c = divmod(int(k), nb)
        assert bool((got[o * 8 : o * 8 + 8, c * b : (c + 1) * b] == -1).all())


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_bitplane_and_packed_wrappers_refuse(cuda, kernel):
    wrapper, _, tile_dtype, _ = KERNELS[kernel]
    plan = _plan(1, cuda, tile_dtype)
    f = _frontier_operand(plan, wrapper, 0, cuda)
    kw = _kw(plan, wrapper)
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
        wrapper(*args, **{**kw, "run_ptr": plan.run_ptr[:-1]})
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


@pytest.mark.parametrize("n_nodes, block", [(64, 16), (1024, 128)])
def test_fused_level_on_counts_at_two_to_the_24_minus_1(cuda, n_nodes, block):
    """B1 on a count frontier, the contract ``count_paths_bounded`` relies
    on: every tile of the complete digraph is full, so each output block
    sums a run of n_nodes / block steps (chunks of 1, one CTA each, added
    by atomics in no fixed order), and the frontier's first row sums to
    exactly 2^24 - 1, which every output of that row then holds; the
    other rows sum below it.  torch.equal to the plain version, twice."""
    g = _complete_graph(n_nodes)
    staged = ops.stage_graph(g, block, device=cuda)
    plan = ops.build_level_schedule(paa.compile_query("l0", g), staged)
    rng = np.random.default_rng(4)
    rows = (plan.n_states + len(plan.union_members)) * plan.q_pad
    f = np.zeros((rows, plan.v_pad), np.float32)
    f[: plan.q_pad, :n_nodes] = rng.integers(0, 2**24 // n_nodes, (plan.q_pad, n_nodes))
    f[0, :n_nodes] = rng.multinomial(2**24 - 1, np.full(n_nodes, 1 / n_nodes))
    f = torch.from_numpy(f).to(cuda)
    wrapper = frontier.fused_level_blocks
    got = wrapper(*_args(plan, f), **_kw(plan, wrapper))
    again = wrapper(*_args(plan, f), **_kw(plan, wrapper))
    want = frontier.fused_level_blocks_plain(*_args(plan, f), n_out_rows=plan.n_states * plan.q_pad)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)
    out = got.reshape(plan.n_states, plan.q_pad, -1)[1]
    assert bool((out[0, :n_nodes] == 2**24 - 1).all()) and float(got.max()) == 2**24 - 1


@pytest.mark.parametrize("backend", ["frontier_kernel", "frontier_kernel_packed"])
def test_witness_executors_on_gpu_equal_cpu(cuda, backend):
    """Both witness step functions on the card equal their CPU run:
    answers, meters and level planes, on 20 starts (short last chunks)
    and on every valid start; a uint32 request restages f32 and launches
    B1 or B2, never B3 or B4."""
    g = generators.random_labeled_graph(200, 700, 3, seed=9)
    g = structure.LabeledGraph(g.n_nodes, g.src, g.lbl, g.dst, ["a", "b", "c"])
    placement = partition.distribute(g, n_sites=4, replication_rate=0.5, seed=2)
    count = "fused_level_blocks" if backend == "frontier_kernel" else "packed_level_blocks"
    for expr in ("a c (a|b)", "(a|b)+", "a* b^-1"):
        ca = paa.compile_query(expr, g)
        for starts in (paa.valid_start_nodes(ca, g)[:20], paa.valid_start_nodes(ca, g)):
            run = {}
            for dev in ("cpu", cuda):
                frontier.reset_launches()
                run[dev] = strategies.s2_execute(
                    placement, ca, starts, backend=backend, tile_dtype="uint32", block_size=32,
                    semantics="witness", device=dev,
                )
            launches = frontier.launch_counts()
            assert launches[count] > 0 and sum(launches.values()) == launches[count]
            (a_cpu, c_cpu, l_cpu), (a_gpu, c_gpu, l_gpu) = run["cpu"], run[cuda]
            assert (a_cpu == a_gpu).all() and c_cpu == c_gpu, expr
            assert l_gpu.shape == (len(starts), ca.n_states, g.n_nodes)
            assert np.array_equal(l_cpu, l_gpu), expr


def test_count_paths_bounded_on_gpu_equals_cpu(cuda):
    """count_paths_bounded on the card (B1 on counts through
    extend_frontier_sum) equals its CPU run exactly, counts below 2^24."""
    g = generators.random_labeled_graph(200, 1400, 3, seed=9)
    for expr in ("(l0|l1)+ l2", "l0 (l1|l2^-1)* l0"):
        ca = paa.compile_query(expr, g)
        starts = paa.valid_start_nodes(ca, g)[:8]
        out = {}
        for dev in ("cpu", cuda):
            plan = ops.build_level_schedule(ca, ops.stage_graph(g, 32, device=dev))
            f0 = ops.stack_start_masks(plan, ca.start, np.eye(g.n_nodes, dtype=np.float32)[starts])
            out[dev] = ops.count_paths_bounded(plan, torch.from_numpy(f0).to(dev), ca.accepting, 8)
        assert 1 < float(out["cpu"].max()) < 2**24
        assert torch.equal(out["cpu"], out[cuda].cpu()), expr


# ---------------------------------------------------------------------------
# S1 and the branching estimator: plain PyTorch on the card against the CPU
# ---------------------------------------------------------------------------

S1_CASES = [
    (lambda: structure.example_graph(), 4, 0.4, 1, "(a|b)+"),
    (lambda: generators.random_labeled_graph(200, 700, 4, seed=9), 6, 0.3, 2, "(l0|l1)+ l2"),
    (lambda: generators.random_labeled_graph(3000, 20000, 6, seed=3), 16, 0.25, 5, "l0 . l3^-1*"),
]


@pytest.mark.parametrize("cap", [None, 1, 5])
@pytest.mark.parametrize("case", range(len(S1_CASES)))
def test_s1_gather_and_collect_on_gpu_equal_cpu(cuda, case, cap):
    """The gather's buffers and overflow byte for byte (the stable sort on
    the card orders as on the CPU), and s1_collect's retry from a small
    cap to the same subgraph; then s1_execute's answers and cost."""
    factory, n_sites, rate, seed, expr = S1_CASES[case]
    g = factory()
    placement = partition.distribute(g, n_sites, replication_rate=rate, seed=seed)
    ast = regex.parse(expr)
    lmask = strategies.query_label_mask(ast, g)
    arrays = {dev: strategies.stage_site_arrays(placement, dev) for dev in ("cpu", cuda)}
    c = arrays["cpu"]["src"].shape[1] if cap is None else cap
    cpu, gpu = (strategies.s1_gather(arrays[dev], lmask, c) for dev in ("cpu", cuda))
    per_site = (arrays["cpu"]["mask"] & torch.as_tensor(lmask)[arrays["cpu"]["lbl"].long()]).sum(1)
    assert cpu[4] == gpu[4] == int((per_site - c).clamp_min(0).sum())
    assert (cpu[4] > 0) == (cap == 1 or (cap == 5 and case > 0))
    for a, b in zip(cpu[:4], gpu[:4]):
        assert b.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b.cpu())
    subs = [strategies.s1_collect(placement, lmask, cap, device_arrays=arrays[dev]) for dev in ("cpu", cuda)]
    for f in ("src", "lbl", "dst"):
        assert getattr(subs[0], f).tobytes() == getattr(subs[1], f).tobytes()
    ca = paa.compile_query(expr, g)
    for s in paa.valid_start_nodes(ca, g)[:4].tolist():
        want = strategies.s1_execute(placement, ast, ca, s, cap, device_arrays=arrays["cpu"])
        assert strategies.s1_execute(placement, ast, ca, s, cap, device_arrays=arrays[cuda]) == want


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("graph, expr", [
    (lambda: structure.example_graph(), "a b"),
    (lambda: generators.random_labeled_graph(300, 1500, 5, seed=4), "l0 l1* l2"),
])
def test_branching_tail_on_gpu_matches_cpu_in_distribution(cuda, graph, expr, seed):
    """The card's Poisson stream is not the CPU's: each mean within 5
    standard errors of the difference of the two means, over 4096
    rollouts, as tests/test_torch_planner.py holds the CPU to repro."""
    g = graph()
    ca = paa.compile_query(expr, g)
    gm = estimation.GilbertModel.fit(g)
    n = 4096
    cpu = estimation.branching_tail(ca, gm, n_rollouts=n, seed=seed, device="cpu")
    gpu = estimation.branching_tail(ca, gm, n_rollouts=n, seed=seed, device=cuda)
    for c, d in zip(cpu, gpu):
        assert d.shape == (n,) and d.dtype == np.float32
        se = float(np.sqrt(c.var() / n + d.var() / n))
        assert abs(float(d.mean()) - float(c.mean())) <= 5 * se + 1e-6


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
    for t, (tiles, rows, cols, work) in ops.baseline_entries(ca, bg):
        f = (rng.random((m_pad, bg.v_pad)) < 0.3).astype(np.float32)
        f[:, bg.n_nodes :] = 0.0
        f = torch.from_numpy(f).to(cuda)
        before = frontier.launch_counts()
        got = frontier.frontier_step_blocks(f, tiles, rows, cols, bg.block_size, work=work)
        want = frontier.frontier_step_blocks_plain(f, tiles, rows, cols, bg.block_size)
        torch.cuda.synchronize()
        assert frontier.launch_counts() == {**before, "frontier_step_blocks": before["frontier_step_blocks"] + 1}
        assert torch.equal(got, want), t


def test_step_wrapper_refuses(cuda):
    _, bg, _ = _blocked(1, cuda)
    tiles, rows, cols, work = next(iter(bg.fwd.values()))
    f = torch.zeros((8, bg.v_pad), device=cuda)
    b = bg.block_size
    with pytest.raises(ValueError, match="tile into"):
        frontier.frontier_step_blocks(f[:4], tiles, rows, cols, b, work=work)
    with pytest.raises(TypeError, match="frontier must be"):
        frontier.frontier_step_blocks(f.double(), tiles, rows, cols, b, work=work)
    with pytest.raises(TypeError, match="tiles must be float32"):
        frontier.frontier_step_blocks(f, tiles.to(torch.int32), rows, cols, b, work=work)
    with pytest.raises(TypeError, match="int32"):
        frontier.frontier_step_blocks(f, tiles, rows.long(), cols, b, work=work)
    with pytest.raises(ValueError, match="one entry per tile"):
        frontier.frontier_step_blocks(f, tiles, rows[:-1], cols, b, work=work)
    with pytest.raises(ValueError, match="frontier on"):
        frontier.frontier_step_blocks(f, tiles.cpu(), rows, cols, b, work=work)
    with pytest.raises(ValueError, match="contiguous"):
        frontier.frontier_step_blocks(f.t().contiguous().t(), tiles, rows, cols, b, work=work)
    before = frontier.launch_counts()
    with pytest.raises(ValueError, match="work list"):
        frontier.frontier_step_blocks(f, tiles, rows, cols, b, work=None)
    with pytest.raises(TypeError, match="work must be"):
        frontier.frontier_step_blocks(f, tiles, rows, cols, b, work=work.long())
    with pytest.raises(ValueError, match="work is on"):
        frontier.frontier_step_blocks(f, tiles, rows, cols, b, work=work.cpu())
    with pytest.raises(ValueError, match="chunks for"):
        frontier.frontier_step_blocks(f, tiles, rows, cols, b, work=torch.cat([work, work]))
    assert frontier.launch_counts() == before


def _hub_graph(n: int) -> structure.LabeledGraph:
    """Every node has an l0 edge into node 3, beside 300 random l1 edges:
    the l0 store's column block 0 is one run of every row block."""
    rng = np.random.default_rng(21)
    src = np.concatenate([np.arange(n), rng.integers(0, n, 300)]).astype(np.int32)
    dst = np.concatenate([np.full(n, 3), rng.integers(0, n, 300)]).astype(np.int32)
    lbl = np.concatenate([np.zeros(n), np.ones(300)]).astype(np.int32)
    return structure.LabeledGraph(n, src, lbl, dst, ["l0", "l1"])


@pytest.mark.parametrize("chunk", [None, 2, 3])
@pytest.mark.parametrize("m_pad", [8, 24])
@pytest.mark.parametrize("n_nodes, block", [(200, 8), (2000, 128)])
def test_step_kernel_on_long_runs_and_single_tiles(cuda, n_nodes, block, m_pad, chunk):
    """B5 on the hub graph's stores (a column run of 25 tiles at block 8,
    of 16 at block 128), on each store cut to a single tile, and on work
    lists of longer chunks than the store's own: torch.equal to plain,
    and two calls give the same bits."""
    bg = ops.make_blocked_graph(_hub_graph(n_nodes), block, device=cuda)
    runs = [np.diff(ops.column_runs(e[2].cpu().numpy())).max() for e in bg.fwd.values()]
    assert max(runs) > 2 * ops.WORK_CHUNK_F32
    rng = np.random.default_rng(block + m_pad)
    stores = list(bg.fwd.values()) + list(bg.inv.values())
    singles = [(t[i : i + 1], r[i : i + 1], c[i : i + 1], torch.zeros((1, 1), dtype=torch.int32,
                                                                     device=cuda))
               for t, r, c, _ in stores for i in (0, t.shape[0] - 1)]
    for tiles, rows, cols, work in stores + singles:
        if chunk is not None:
            work = torch.from_numpy(ops.level_work(
                np.ones(tiles.shape[0], np.int32), ops.column_runs(cols.cpu().numpy()), chunk)).to(cuda)
        f = (rng.random((m_pad, bg.v_pad)) < 0.3).astype(np.float32)
        f[:, bg.n_nodes :] = 0.0
        f = torch.from_numpy(f).to(cuda)
        before = frontier.STEP_LAUNCHES
        got = frontier.frontier_step_blocks(f, tiles.contiguous(), rows.contiguous(),
                                            cols.contiguous(), block, work=work)
        again = frontier.frontier_step_blocks(f, tiles.contiguous(), rows.contiguous(),
                                              cols.contiguous(), block, work=work)
        want = frontier.frontier_step_blocks_plain(f, tiles, rows, cols, block)
        torch.cuda.synchronize()
        assert frontier.STEP_LAUNCHES == before + 2
        assert torch.equal(got, want) and torch.equal(got, again)


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


# rows, D, lookups, bags, layout of the bag ids: D 1, 100, 128, 129 and
# 300 (column chunks); bags of one lookup; bags longer than a window and
# than 1,000 lookups, across many lane groups' ranges; leading, trailing
# and interior empty bags; N = 0; n_bags = 0
EB_CASES = [
    (64, 8, 40, 10, "random"), (128, 128, 96, 16, "random"), (300, 300, 2000, 50, "random"),
    (50, 1, 500, 20, "random"), (400, 100, 5000, 300, "random"), (1000, 128, 800, 800, "one"),
    (200, 129, 3000, 12, "long"), (100, 100, 1500, 240, "gaps"), (64, 100, 0, 7, "random"),
    (64, 100, 0, 0, "random"),
]


def _eb_bags(layout, n_lookup, n_bags, rng):
    if layout == "one":
        return rng.permutation(n_bags).astype(np.int32)
    if layout == "long":  # 1,200, 40 and 1,760 lookups; bags 0, 2, 3, 5-8, 10, 11 empty
        return rng.permutation(np.repeat(np.array([1, 4, 9], np.int32), [1200, 40, 1760]))
    if layout == "gaps":  # ids 0-2 and 230-239 empty, and ~half of those between
        return rng.choice(np.arange(3, n_bags - 10), n_lookup).astype(np.int32)
    return rng.integers(0, max(n_bags, 1), n_lookup).astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, dim, n_lookup, n_bags, layout", EB_CASES)
def test_embedding_bag_kernel_equals_plain(cuda, rows, dim, n_lookup, n_bags, layout, dtype):
    """B6 equals its plain version bit for bit: the same adds in the same
    order, bf16 rounded after every lookup."""
    rng = np.random.default_rng(rows + n_lookup)
    table = torch.from_numpy(rng.normal(size=(rows, dim)).astype(np.float32)).to(cuda, dtype)
    idx = torch.from_numpy(rng.integers(0, rows, n_lookup).astype(np.int32)).to(cuda)
    bags = torch.from_numpy(_eb_bags(layout, n_lookup, n_bags, rng)).to(cuda)
    sorted_bags, order = torch.sort(bags, stable=True)
    s_idx = idx[order].contiguous()
    before = embedbag.LAUNCHES
    got = embedbag.embedding_bag_sorted(table, s_idx, sorted_bags, n_bags)
    want = embedbag.embedding_bag_sorted_plain(table, s_idx, sorted_bags, n_bags)
    torch.cuda.synchronize()
    assert embedbag.LAUNCHES == before + (n_bags > 0)
    assert got.dtype == dtype and got.shape == (n_bags, dim)
    assert torch.equal(got, want)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh, n_q, offset, heads, s", [(128, 5, 3, 1, 16384), (128, 10, 2, 2, 1024),
                                                       (112, 4, 7, 1, 16384), (112, 8, 4, 4, 2048),
                                                       (64, 8, 0, 4, 16384), (64, 8, 4, 4, 2048)])
def test_decode_kernel_on_kv_head_offset_equals_plain(cuda, dh, n_q, offset, heads, s, dtype):
    """B7 and its split kernel on kv groups [offset, offset + heads) of a
    whole 8-group cache, read in place (a tensor-parallel rank's heads:
    qwen3-14b's 5 a group at Dh 128, kimi-k2's at 112, granite-moe's 2 at
    64 on half the groups, as at (2, 2)), equal their plain
    versions within B7's tolerances and the kernel on a contiguous copy
    of the groups bit for bit; one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(dh + offset)
    k = torch.randn((2, s, 8, dh), device=cuda, generator=gen).to(dtype)
    v = torch.randn((2, s, 8, dh), device=cuda, generator=gen).to(dtype)
    q = torch.randn((2, n_q, dh), device=cuda, generator=gen).to(dtype)
    ks, vs = k[:, :, offset : offset + heads].contiguous(), v[:, :, offset : offset + heads].contiguous()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for kv in (s, s - 77, 300):
        n = torch.tensor(kv, dtype=torch.int32, device=cuda)
        before = decode_attn.LAUNCHES
        got = decode_attn.flash_decode_gqa(q, k, v, n, 512, offset, heads)
        want = decode_attn.flash_decode_gqa_plain(q, k, v, n, 512, offset, heads)
        torch.cuda.synchronize()
        assert decode_attn.LAUNCHES == before + 1
        assert float((got.float() - want.float()).abs().max()) <= tol * float(want.float().abs().max()), kv
        assert torch.equal(got, decode_attn.flash_decode_gqa(q, ks, vs, n, 512)), kv
        part = decode_attn.flash_decode_gqa_partials(q, k, v, n, 0, 512, offset, heads)
        assert torch.equal(part.buf, decode_attn.flash_decode_gqa_partials(q, ks, vs, n, 0, 512).buf), kv


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


# kv_len at the edges of a split of length L, and of the cache
KV_EDGES = {
    "-1": lambda L, S: -1, "0": lambda L, S: 0, "1": lambda L, S: 1, "L-1": lambda L, S: L - 1,
    "L": lambda L, S: L, "L+1": lambda L, S: L + 1, "S-17": lambda L, S: S - 17, "S": lambda L, S: S,
}


@pytest.mark.parametrize("kv_name", list(KV_EDGES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape, block",
    # r = 5 over 128 splits of 128 positions (two bf16 tiles, four f32
    # tiles); r = 8 over 16 splits of 64 whose last holds 40 of 1,000
    [((1, 10, 2, 128, 16_384), 512), ((2, 16, 2, 64, 1_000), 8)],
)
def test_decode_kernel_splits_at_kv_len_edges(cuda, shape, block, dtype, kv_name):
    b, h, g, dh, s = shape
    n_split, split_len = decode_attn.decode_splits(b, g, s)
    assert n_split > 1
    q, k, v = _qkv(shape, dtype, cuda, s + h)
    n = torch.tensor(KV_EDGES[kv_name](split_len, s), dtype=torch.int32, device=cuda)
    before = decode_attn.LAUNCHES
    got = decode_attn.flash_decode_gqa(q, k, v, n, block_kv=block)
    want = decode_attn.flash_decode_gqa_plain(q, k, v, n, block_kv=block)
    torch.cuda.synchronize()
    assert decode_attn.LAUNCHES == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.float().abs().max())


def test_decode_wrapper_refuses_shapes_outside_the_kernel(cuda):
    n = torch.tensor(100, dtype=torch.int32, device=cuda)
    for shape in ((1, 8, 2, 32, 256), (1, 8, 2, 96, 256), (1, 34, 2, 64, 256)):
        q, k, v = _qkv(shape, torch.bfloat16, cuda, 0)
        with pytest.raises(ValueError, match="q-heads per kv group and Dh in"):
            decode_attn.flash_decode_gqa(q, k, v, n, block_kv=128)
    q, k, v = _qkv((1, 8, 2, 64, 256), torch.bfloat16, cuda, 0)
    shifted = torch.zeros(k.numel() + 4, dtype=k.dtype, device=cuda)[4:].view(k.shape)  # 8 bytes in
    with pytest.raises(ValueError, match="16-byte boundary"):
        decode_attn.flash_decode_gqa(q, shifted, v, n, block_kv=128)


# ---------------------------------------------------------------------------
# the serving runtime on the card
# ---------------------------------------------------------------------------

SERVE_NET = NetworkParams(n_peers=150, n_connections=450, replication_rate=0.2)
SERVE_KERNEL = {
    ("frontier_kernel", "f32"): "fused_level_blocks",
    ("frontier_kernel", "uint32"): "fused_level_blocks_u32",
    ("frontier_kernel_packed", "f32"): "packed_level_blocks",
    ("frontier_kernel_packed", "uint32"): "packed_level_blocks_u32",
}


def _serve_setup():
    g = generators.random_labeled_graph(300, 1400, 5, seed=4)
    return g, partition.distribute(g, n_sites=6, replication_rate=0.3, seed=1)


def _serve(placement, device, backend="frontier_kernel", tile_dtype="f32", **kw):
    cfg = ServeConfig(n_rollouts=40, seed=0, s2_backend=backend, s2_block_size=16,
                      s2_tile_dtype=tile_dtype, **kw)
    return QueryService(placement, SERVE_NET, config=cfg, device=device)


@pytest.mark.parametrize("backend, tile_dtype", list(SERVE_KERNEL))
def test_service_on_gpu_equals_cpu(cuda, backend, tile_dtype):
    """A mixed stream: every request's answers, strategy, plan-cache hit,
    batch size and observed costs equal on the card and on the CPU, and
    the path's level kernel launched once a level."""
    g, placement = _serve_setup()
    stream = workloads.generate(g, workloads.WorkloadConfig(n_queries=24, hot_pool=4, seed=1))
    out = {}
    for device in ("cpu", cuda):
        svc = _serve(placement, device, backend, tile_dtype)
        frontier.reset_launches()
        ops.FIXPOINT_COUNTERS.clear()
        tickets = [svc.enqueue(q.query, q.starts, strategy=("S2", None)[i % 2])
                   for i, q in enumerate(stream)]
        svc.flush()
        res = [t.result() for t in tickets]
        out[str(device)] = [(a.answers, a.strategy, a.plan_cache_hit,
                             [dataclasses.astuple(c) for c in a.observed]) for a in res]
        out[str(device) + "/batches"] = [r.exec_batch_size for r in svc.metrics.records]
        counts = frontier.launch_counts()
        if device == cuda:  # each body of LEVELS_PER_CHECK levels launches every one of them
            name = SERVE_KERNEL[(backend, tile_dtype)]
            assert counts[name] == ops.FIXPOINT_COUNTERS["bodies"] * ops.LEVELS_PER_CHECK > 0
            assert ops.FIXPOINT_COUNTERS["levels"] > 0
            assert sum(counts.values()) == counts[name]
    assert out["cpu"] == out["cuda"]
    assert out["cpu/batches"] == out["cuda/batches"]


def test_drop_epoch_frees_device_memory_to_the_stores_bytes(cuda):
    g, placement = _serve_setup()
    queries = ("l0 l1* l2", "(l3|l4)+", "l2 . l0")
    warm = _serve(placement, cuda)  # whatever the first run allocates for good
    for q in queries:
        warm.submit(q, [0, 5, 17], strategy="S2")
    del warm
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    svc = _serve(placement, cuda)
    for q in queries:
        svc.submit(q, [0, 5, 17], strategy="S2")
    held = sum(svc.plan_store.tile_store_stats()["bytes_by_dtype"].values())
    assert held > 0 and torch.cuda.memory_allocated() - base >= held
    svc.exec_cache.drop_epoch(1)
    gc.collect()
    torch.cuda.synchronize()
    # the caching allocator hands out blocks in multiples of 512 bytes
    site = sum(-(-t.numel() * t.element_size() // 512) * 512 for t in svc._device_arrays.values())
    left = sum(svc.plan_store.tile_store_stats()["bytes_by_dtype"].values())
    assert left == 0
    # the service itself still holds the placement's staged site arrays
    assert torch.cuda.memory_allocated() - base == site + left


@pytest.mark.parametrize("backend, tile_dtype", [("frontier_kernel", "f32"),
                                                 ("frontier_kernel_packed", "uint32")])
def test_async_flush_on_the_worker_thread_launches_the_kernel(cuda, backend, tile_dtype):
    g, placement = _serve_setup()
    svc = _serve(placement, cuda, backend, tile_dtype)
    want = _serve(placement, "cpu", backend, tile_dtype)
    queries = [("l0 l1* l2", [0, 5]), ("(l3|l4)+", [9]), ("l0 l1* l2", [17, 3, 40])]

    async def drive():
        async with AsyncQueryService(svc) as aio:
            return await asyncio.gather(*[aio.submit(q, s, strategy="S2") for q, s in queries])

    frontier.reset_launches()
    ops.FIXPOINT_COUNTERS.clear()
    got = asyncio.run(drive())
    counts = frontier.launch_counts()
    name = SERVE_KERNEL[(backend, tile_dtype)]
    assert counts[name] == ops.FIXPOINT_COUNTERS["bodies"] * ops.LEVELS_PER_CHECK > 0
    assert ops.FIXPOINT_COUNTERS["captures"] > 0  # on the flush worker's thread
    for (q, s), a in zip(queries, got):
        assert a.answers == want.submit(q, s, strategy="S2").answers


# ---------------------------------------------------------------------------
# the site-sharded backend (B1 and B3 on a bucket) and the reference backend
# ---------------------------------------------------------------------------


def _sharded_setup():
    g = generators.random_labeled_graph(300, 1400, 5, seed=4)
    return g, partition.distribute(g, n_sites=6, replication_rate=0.4, seed=3)


@pytest.mark.parametrize("tile_dtype", ["f32", "uint32"])
def test_bucket_launch_equals_plain(cuda, tile_dtype):
    """One B1 or B3 launch over a bucket of six member sites (their work
    lists concatenated, several chunks per output block) equals the sum
    of the members' plain levels; the wrapper refuses a bucket without
    its flattened tile ids or per-member run offsets."""
    g, placement = _sharded_setup()
    staged = ops.stage_sharded_graph([placement.local_graph(s) for s in range(6)], 32, tile_dtype)
    plan = ops.build_sharded_level_schedule(paa.compile_query("l0 (l1|l2)* . l3^-1", g), staged,
                                            axis_size=6, device=cuda)
    (b,) = plan.buckets
    assert len(b.sites) == 6
    rows = (plan.n_states + len(plan.union_members)) * plan.q_pad
    f = (torch.rand((rows, plan.v_pad), generator=torch.Generator().manual_seed(1)) < 0.3).float()
    f = f.to(cuda)
    seven = [getattr(b, n) for n in ("firsts", "valids", "tile_ids", "f_rows", "f_cols",
                                     "o_rows", "o_cols")]
    n_out = plan.n_states * plan.q_pad
    kw = dict(run_ptr=b.run_ptr, work=b.work, flat_tile_ids=b.flat_tile_ids, n_out_rows=n_out)
    name = "fused_level_blocks_u32" if tile_dtype == "uint32" else "fused_level_blocks"
    frontier.reset_launches()
    got = frontier.bucket_level_blocks(f, b.tiles, *seven, plan.block_size, plan.q_pad, **kw)
    want = frontier.bucket_level_blocks_plain(f, b.tiles, *seven, plan.block_size, plan.q_pad,
                                              n_out_rows=n_out)
    torch.cuda.synchronize()
    assert frontier.launch_counts()[name] == 1 == sum(frontier.launch_counts().values())
    assert want.max() > 1 and torch.equal(got, want)
    with pytest.raises(ValueError, match="flat_tile_ids"):
        frontier.bucket_level_blocks(f, b.tiles, *seven, plan.block_size, plan.q_pad,
                                     **{**kw, "flat_tile_ids": None})
    with pytest.raises(ValueError, match="one run per output block"):
        frontier.bucket_level_blocks(f, b.tiles, *seven, plan.block_size, plan.q_pad,
                                     **{**kw, "run_ptr": b.run_ptr[0]})


@pytest.mark.parametrize("backend, tile_dtype, axis_size", [
    ("reference", "f32", 1), ("frontier_kernel_sharded", "f32", 1),
    ("frontier_kernel_sharded", "uint32", 1), ("frontier_kernel_sharded", "uint32", 3),
])
def test_sharded_and_reference_executors_on_gpu_equal_cpu(cuda, backend, tile_dtype, axis_size):
    """Answers, meters, per-site meters and witness levels equal on the card
    and on the CPU; the sharded path launches its kernel once per bucket
    and level, the reference path no kernel."""
    g, placement = _sharded_setup()
    name = "fused_level_blocks_u32" if tile_dtype == "uint32" else "fused_level_blocks"
    for expr in ("l0 (l1|l2)* l3", "(l0|l4)+", "l1 . l3^-1"):
        ca = paa.compile_query(expr, g)
        starts = paa.valid_start_nodes(ca, g)[:40]
        run = {}
        for dev in ("cpu", cuda):
            frontier.reset_launches()
            ops.FIXPOINT_COUNTERS.clear()
            run[str(dev)] = strategies.s2_execute(
                placement, ca, starts, backend=backend, tile_dtype=tile_dtype, block_size=32,
                device=dev, axis_size=axis_size)
        counts = frontier.launch_counts()
        if backend == "reference":
            assert sum(counts.values()) == 0
        else:  # one bucket here: LEVELS_PER_CHECK launches a body
            assert counts[name] == ops.FIXPOINT_COUNTERS["bodies"] * ops.LEVELS_PER_CHECK > 0
            assert sum(counts.values()) == counts[name]
        (a_cpu, c_cpu), (a_gpu, c_gpu) = run["cpu"], run["cuda"]
        assert (a_cpu == a_gpu).all() and c_cpu == c_gpu, expr
        wit = {dev: strategies.s2_execute(placement, ca, starts[:9], backend=backend,
                                          semantics="witness", block_size=32, device=dev,
                                          axis_size=axis_size)[2] for dev in ("cpu", cuda)}
        assert wit["cpu"].tobytes() == wit[cuda].tobytes(), expr


def test_sharded_site_meter_is_exact_with_tf32_on(cuda):
    """A hub with 3,001 out-edges on one site: TF32 keeps 11 significant
    bits, so an f32 matmul of the degree vector would round 3,001 to
    3,000.  The per-site meter multiplies in f64, so with
    ``allow_tf32 = True`` it still counts 3 · 3,001 symbols, as the CPU
    does."""
    n = 3002
    src = np.zeros(n - 1, np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    g = structure.LabeledGraph(n, src, np.zeros(n - 1, np.int32), dst, ["a"])
    placement = partition.distribute(g, n_sites=2, replication_rate=0.0, seed=0)
    ca = paa.compile_query("a", g)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = strategies.s2_execute(placement, ca, np.array([0]), backend="frontier_kernel_sharded",
                                    block_size=128, device=cuda)[1][0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    want = strategies.s2_execute(placement, ca, np.array([0]), backend="frontier_kernel_sharded",
                                 block_size=128, device="cpu")[1][0]
    assert got == want and sum(got.site_unicast_symbols) == 3 * (n - 1)


# ---------------------------------------------------------------------------
# the fixpoints on the card: CUDA graphs replayed against the eager loop
# ---------------------------------------------------------------------------

LOOP_PATHS = [("reference", "f32", "pairs"), ("reference", "f32", "witness"),
              ("frontier_kernel", "f32", "witness"), ("frontier_kernel", "uint32", "pairs"),
              ("frontier_kernel_packed", "f32", "witness"), ("frontier_kernel_packed", "uint32", "pairs"),
              ("frontier_kernel_sharded", "uint32", "pairs"), ("frontier_kernel_sharded", "f32", "witness")]


def _loop_run(step, placement, ca, starts, arrays, semantics):
    frontier.reset_launches()
    ops.FIXPOINT_COUNTERS.clear()
    out = strategies.s2_execute(placement, ca, starts, step_fn=step, device_arrays=arrays, semantics=semantics)
    return (out[0].tobytes(), [dataclasses.astuple(c) for c in out[1]], *(x.tobytes() for x in out[2:])), \
        ops.FIXPOINT_COUNTERS.copy(), sum(frontier.launch_counts().values())


@pytest.mark.parametrize("max_levels", [None, 2])
@pytest.mark.parametrize("backend, tile_dtype, semantics", LOOP_PATHS)
def test_replayed_graph_equals_eager_loop(cuda, monkeypatch, backend, tile_dtype, semantics, max_levels):
    """Each one-card executor's fixpoints replayed from its captured CUDA
    graph (``LEVELS_PER_CHECK`` levels a replay) equal the eager loop of
    one level a check bit for bit: answers, meters, witness planes and BFS
    levels, at ``max_levels`` too; the first call captures once, a second
    replays only; the level kernel launches ``LEVELS_PER_CHECK`` times per
    body and bucket."""
    g, placement = _sharded_setup()
    arrays = strategies.stage_site_arrays(placement, cuda) if backend == "reference" else None
    kw = {"placement": placement, "axis_size": 3} if backend == "frontier_kernel_sharded" else {}
    for expr in ("l0 (l1|l2)* l3", "(l0|l4)+"):
        ca = paa.compile_query(expr, g)
        starts = paa.valid_start_nodes(ca, g)[:40]

        def step():
            return strategies.make_s2_step_fn(
                ca, g.n_nodes, max_levels, backend=backend, graph=g, tile_dtype=tile_dtype,
                semantics=semantics, block_size=32, replication_factor=placement.replication_factor,
                device=cuda, **kw)

        monkeypatch.setattr(ops, "EAGER", True)
        monkeypatch.setattr(ops, "LEVELS_PER_CHECK", 1)
        want, want_c, want_n = _loop_run(step(), placement, ca, starts, arrays, semantics)
        monkeypatch.setattr(ops, "EAGER", False)
        monkeypatch.setattr(ops, "LEVELS_PER_CHECK", 8)
        fn = step()
        for call in range(2):
            got, c, n = _loop_run(fn, placement, ca, starts, arrays, semantics)
            assert got == want, (expr, backend, call)
            assert c["levels"] == want_c["levels"] > 0 and c["host_syncs"] == c["bodies"] <= want_c["bodies"]
            assert c["captures"] == (1 if call == 0 else 0)
            assert c["replays"] == c["bodies"] - (1 if call == 0 else 0)  # the first body ran eagerly
            if backend == "reference":
                assert n == want_n == 0
            else:  # the eager loop: one launch a level and bucket
                assert n == c["bodies"] * 8 * (want_n // want_c["levels"]) > 0
        fn.release()


FIXPOINTS = ["reach_fixpoint", "reach_fixpoint_levels", "reach_fixpoint_packed", "reach_fixpoint_packed_levels"]


@pytest.mark.parametrize("name", FIXPOINTS)
def test_reach_fixpoints_replayed_equal_eager(cuda, monkeypatch, name):
    """``ops.reach_fixpoint*`` replayed from the plan's graphs equal the
    eager one-level loop bit for bit, and the same BFS levels."""
    plan = _plan(1, cuda)
    masks = np.zeros((8, plan.n_nodes), np.float32)
    masks[np.arange(8), np.arange(0, 48, 6)] = 1.0
    packed = "packed" in name
    f0 = (ops.stack_start_masks_packed(plan, 0, masks).view(np.int32) if packed
          else ops.stack_start_masks(plan, 0, masks))
    f0 = torch.from_numpy(f0).to(cuda)

    def run():
        ops.FIXPOINT_COUNTERS.clear()
        out = getattr(ops, name)(plan, f0)
        return [t.cpu().numpy().tobytes() for t in (out if isinstance(out, tuple) else (out,))], \
            ops.FIXPOINT_COUNTERS["levels"]

    monkeypatch.setattr(ops, "EAGER", True)
    monkeypatch.setattr(ops, "LEVELS_PER_CHECK", 1)
    want = run()
    monkeypatch.setattr(ops, "EAGER", False)
    monkeypatch.setattr(ops, "LEVELS_PER_CHECK", 8)
    assert run() == run() == want and want[1] > 0
    plan.release()


def test_an_evicted_executor_returns_its_graph_memory(cuda):
    """An executor evicted from the cache (``_ExecEntry.release``) frees its
    graphs, their static state and its plan: ``memory_allocated`` comes
    back to its level before the build."""
    g, placement = _sharded_setup()
    ca = paa.compile_query("l0 (l1|l2)* l3", g)
    starts = paa.valid_start_nodes(ca, g)[:40]
    staged = ops.stage_graph(g, 32, device=cuda)
    for i, backend in enumerate(("frontier_kernel", "frontier_kernel", "frontier_kernel_packed")):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        step = strategies.make_s2_step_fn(ca, g.n_nodes, backend=backend, graph=g, staged=staged,
                                          block_size=32, replication_factor=placement.replication_factor,
                                          device=cuda)
        ops.FIXPOINT_COUNTERS.clear()
        strategies.s2_execute(placement, ca, starts, step_fn=step)
        assert ops.FIXPOINT_COUNTERS["captures"] == 1 and torch.cuda.memory_allocated() > base
        entry = plancache._ExecEntry(graph_key=(), sig=None, fn=step)
        del step
        entry.release()
        gc.collect()
        torch.cuda.synchronize()
        if i:  # the first build is the warm-up: whatever it allocates for good
            assert torch.cuda.memory_allocated() == base, backend


# ---------------------------------------------------------------------------
# the models' serving path: DLRM on B6, the LM decode on B7
# ---------------------------------------------------------------------------


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_dlrm_steps_on_gpu_equal_cpu(cuda, multi_hot):
    """dlrm-mlperf's smoke config: the bags exact (B6 adds what its plain
    version adds, in the same order), one B6 launch a table and step;
    probabilities and retrieval scores within 1e-5 of the largest (f32
    products, TF32 off, summed in other orders), the top 64 indices equal
    up to ties."""
    cfg = dataclasses.replace(dlrm_mlperf.smoke(), multi_hot=multi_hot)
    rules = shd.Rules.from_mesh(None)
    params = dlrm_model.init_params(cfg, seed=0, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        serve = dlrm_mlperf.smoke_batch(cfg, "serve", device=dev)
        retrieval = dlrm_mlperf.smoke_batch(cfg, "retrieval", device=dev)
        before = embedbag.LAUNCHES
        out[str(dev)] = (
            [e.cpu() for e in dlrm_model.embedding_bags(cfg, rules, p, serve["sparse"])],
            dlrm_model.make_serve_step(cfg, rules)(p, serve).cpu(),
            [t.cpu() for t in dlrm_model.make_retrieval_step(cfg, rules)(p, retrieval)],
        )
        torch.cuda.synchronize()
        launches = embedbag.LAUNCHES - before
    assert launches == 3 * cfg.n_sparse  # the bags, the serve step, the retrieval step
    (e_cpu, p_cpu, r_cpu), (e_gpu, p_gpu, r_gpu) = out["cpu"], out[str(cuda)]
    for a, b in zip(e_cpu, e_gpu):
        assert torch.equal(a, b)
    assert float((p_gpu - p_cpu).abs().max()) <= 1e-5 * float(p_cpu.abs().max())
    assert float((r_gpu[0] - r_cpu[0]).abs().max()) <= 1e-5 * float(r_cpu[0].abs().max())
    differ = r_gpu[1] != r_cpu[1]  # a differing index is a tie within the tolerance
    assert float((r_gpu[0][differ] - r_cpu[0][differ]).abs().sum()) <= 1e-5 * float(r_cpu[0].abs().max()) * 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_prefill_and_decode_on_gpu_equal_cpu(cuda, dtype):
    """qwen3-14b's smoke config with d_head 64 (B7 takes 64, 112, 128 and 256):
    prefill, the cache copied into a 72-long buffer (not a multiple of
    B7's 64-position tile), then 5 decode steps fed the same tokens on
    both devices, B7 launching once a layer and step; logits within 2e-5
    (f32) and 2e-2 (bf16) of the largest, B7's tolerances."""
    cfg = dataclasses.replace(lm_common.lm_smoke("qwen3-14b"), d_head=64, dtype=dtype)
    rules = shd.Rules.from_mesh(None)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    params = transformer.init_params(cfg, seed=0, device="cpu")
    toks = lm_common.lm_smoke_batch(cfg, "prefill", device="cpu")["tokens"]
    fed = [torch.tensor([i, 3 * i + 1], dtype=torch.int32) for i in range(5)]
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        logits, pre = transformer.make_prefill(cfg, rules)(p, toks.to(dev))
        cache = transformer.init_cache(cfg, 2, 72, device=dev)
        cache["k"][:, :, :32], cache["v"][:, :, :32], cache["len"] = pre["k"], pre["v"], pre["len"]
        step = transformer.make_decode_step(cfg, rules)
        before = decode_attn.LAUNCHES
        seen = [logits.float().cpu()]
        for tok in fed:
            logits, cache = step(p, cache, tok.to(dev))
            seen.append(logits.float().cpu())
        torch.cuda.synchronize()
        launches = decode_attn.LAUNCHES - before
        out[str(dev)] = (seen, cache["k"].float().cpu())
    assert launches == cfg.n_layers * len(fed)
    for got, want in zip(out[str(cuda)][0], out["cpu"][0]):
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    k_gpu, k_cpu = out[str(cuda)][1], out["cpu"][1]
    assert float((k_gpu - k_cpu).abs().max()) <= tol * float(k_cpu.abs().max())


# ---------------------------------------------------------------------------
# B7 at kimi-k2's head width, the MoE layer and the GNN serve steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape, block, kv_len",
    # one split, kv_len inside the last tile; 8 q rows a group over 16
    # splits (kv_len inside a split's tile and at a split's end); r = 16
    [((2, 8, 4, 112, 512), 128, 495), ((1, 64, 8, 112, 4_096), 512, 3_003),
     ((2, 32, 2, 112, 1_000), 8, 640), ((3, 16, 1, 112, 256), 128, 200)],
)
def test_decode_kernel_at_dh_112_equals_plain(cuda, shape, block, kv_len, dtype):
    """Dh = 112: 14 16-byte chunks a bf16 row in 16 swizzled slots, f32
    K rows of 116 floats."""
    b, h, g, dh, s = shape
    q, k, v = _qkv(shape, dtype, cuda, sum(shape) + kv_len)
    n = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = decode_attn.LAUNCHES
    got = decode_attn.flash_decode_gqa(q, k, v, n, block_kv=block)
    want = decode_attn.flash_decode_gqa_plain(q, k, v, n, block_kv=block)
    torch.cuda.synchronize()
    assert decode_attn.LAUNCHES == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.float().abs().max())
    # a kernel that read the unloaded slots or a neighbour's row would miss
    # this: the output moves when only the last 16 dims of V change
    v2 = v.clone()
    v2[..., 96:] += 1.0
    moved = decode_attn.flash_decode_gqa(q, k, v2, n, block_kv=block)
    assert float((moved.float() - got.float())[..., :96].abs().max()) <= tol * float(got.float().abs().max())
    assert float((moved.float() - got.float())[..., 96:].abs().min()) > 0.5


@pytest.mark.parametrize("n_edges, n_nodes, width", [(8_192, 3_840, 128 * 49), (20_000, 500, 13 * 32),
                                                     (4_096, 9_000, 8)])
def test_scatter_sum_on_b6_equals_plain(cuda, n_edges, n_nodes, width):
    """``gnn.scatter_sum`` at EquiformerV2's row width (C 128 x 49
    coefficients), NequIP's (13 x 32) and a head count: one B6 launch,
    equal to the plain version on the same sorted lookups."""
    gen = torch.Generator(device=cuda).manual_seed(n_edges)
    msg = torch.randn((n_edges, width), generator=gen, device=cuda)
    dst = torch.randint(0, n_nodes, (n_edges,), generator=gen, device=cuda, dtype=torch.int32)
    edges = gnn.sort_edges(dst)
    before = embedbag.LAUNCHES
    got = gnn.scatter_sum(msg, edges, n_nodes)
    torch.cuda.synchronize()
    assert embedbag.LAUNCHES == before + 1
    want = embedbag.embedding_bag_sorted_plain(msg, edges.order, edges.sorted_dst, n_nodes)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), gnn.scatter_sum(msg.cpu(), gnn.sort_edges(dst.cpu()), n_nodes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routed_moe_equals_dense_twin_on_gpu(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = layers.init_moe(gen, 256, 128, 16, dtype)
    x = torch.randn((4, 64, 256), generator=gen, device=cuda).to(dtype)
    rules = shd.Rules.from_mesh(None)
    got = layers.apply_moe(p, x, n_experts=16, top_k=4, rules=rules)
    want = layers.moe_dense(p, x, n_experts=16, top_k=4)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.float().abs().max())
    cpu = layers.apply_moe({k: w.cpu() for k, w in p.items()}, x.cpu(), n_experts=16, top_k=4, rules=rules)
    assert float((got.float().cpu() - cpu.float()).abs().max()) <= tol * float(cpu.float().abs().max())


def test_moe_lm_prefill_and_decode_on_gpu_equal_cpu(cuda):
    """kimi-k2's smoke config at its own head width 112, f32: prefill, the
    cache copied into a 72-long buffer, 4 decode steps fed the same tokens
    on both devices, B7 launching once a layer and step; logits within
    B7's 2e-5 of the largest."""
    cfg = dataclasses.replace(registry.get_arch("kimi-k2-1t-a32b").smoke(), d_head=112)
    rules = shd.Rules.from_mesh(None)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    toks = lm_common.lm_smoke_batch(cfg, "prefill", device="cpu")["tokens"]
    fed = [torch.tensor([i, 5 * i + 2], dtype=torch.int32) for i in range(4)]
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        logits, pre = transformer.make_prefill(cfg, rules)(p, toks.to(dev))
        cache = transformer.init_cache(cfg, 2, 72, device=dev)
        cache["k"][:, :, :32], cache["v"][:, :, :32], cache["len"] = pre["k"], pre["v"], pre["len"]
        step = transformer.make_decode_step(cfg, rules)
        before = decode_attn.LAUNCHES
        seen = [logits.float().cpu()]
        for tok in fed:
            logits, cache = step(p, cache, tok.to(dev))
            seen.append(logits.float().cpu())
        torch.cuda.synchronize()
        launches = decode_attn.LAUNCHES - before
        out[str(dev)] = seen
    assert launches == cfg.n_layers * len(fed)
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["gcn-cora", "schnet", "nequip", "equiformer-v2"])
def test_gnn_serve_steps_on_gpu_equal_cpu(cuda, arch):
    """Each smoke GNN on ``gnn_smoke_batch`` with every third edge masked:
    B6 launches once a scatter (GCN 2 + layers; SchNet interactions + 1;
    NequIP layers + 1; EquiformerV2 2 x layers + 1), no decode kernel,
    and the output within 1e-5 of the CPU run's largest."""
    cfg = registry.get_arch(arch).smoke()
    rules = shd.Rules.from_mesh(None)
    params = gnn.INIT_FNS[arch](cfg, seed=0, device="cpu")
    batch = gnn_common.gnn_smoke_batch(arch == "gcn-cora", device="cpu")
    batch["edge_mask"] = torch.arange(batch["edge_mask"].shape[0]) % 3 != 0
    step = gnn.make_gnn_serve_step(cfg, rules)
    want = step(params, batch)
    before = (embedbag.LAUNCHES, decode_attn.LAUNCHES)
    got = step(_to(params, cuda), {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    scatters = {"gcn-cora": 2 + 2, "schnet": 2 + 1, "nequip": 2 + 1, "equiformer-v2": 2 * 2 + 1}[arch]
    assert (embedbag.LAUNCHES - before[0], decode_attn.LAUNCHES - before[1]) == (scatters, 0)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---------------------------------------------------------------------------
# training: B6's backward, a GCN train step, a resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, dim", [(torch.float32, 47), (torch.bfloat16, 128)])
def test_embedding_bag_backward_equals_plain(cuda, dtype, dim):
    """The table's gradient of ``embedding_bag`` on the card: one B6 launch
    forward and one backward, the gradient ``torch.equal`` to the plain
    version on the same transposed lookups and to the CPU's gradient, zero
    on the 100 rows no lookup reads, and a row that a third of the lookups
    hit summed in lookup order."""
    gen = torch.Generator(device=cuda).manual_seed(dim)
    rows, n, n_bags = 5_000, 20_000, 3_000
    idx = torch.randint(0, rows - 100, (n,), generator=gen, device=cuda, dtype=torch.int32)
    idx[torch.rand(n, generator=gen, device=cuda) < 0.33] = 7
    bags = torch.randint(0, n_bags, (n,), generator=gen, device=cuda, dtype=torch.int32)
    table = torch.randn((rows, dim), generator=gen, device=cuda).to(dtype).requires_grad_()
    before = embedbag.LAUNCHES
    out = eb_ops.embedding_bag(table, idx, bags, n_bags)
    g = torch.randn(out.shape, generator=gen, device=cuda).to(dtype)
    out.backward(g)
    torch.cuda.synchronize()
    assert embedbag.LAUNCHES == before + 2 and table.grad.dtype == dtype
    idx_t, bags_t = embedbag.transpose_lookups(idx, bags)
    assert torch.equal(table.grad, embedbag.embedding_bag_sorted_plain(g, idx_t, bags_t, rows))
    assert not table.grad[rows - 100 :].any()
    t = table.detach().cpu().requires_grad_()
    eb_ops.embedding_bag(t, idx.cpu(), bags.cpu(), n_bags).backward(g.cpu())
    assert torch.equal(table.grad.cpu(), t.grad)


def test_gcn_train_step_on_gpu_equals_cpu(cuda):
    """GCN's smoke loss and gradients on the card within 1e-5 of the CPU
    run's largest: B6 launches 4 forward (two degree scatters, an
    aggregation a layer) and 2 backward; then one AdamW step."""
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.tree import leaves, value_and_grad

    cfg = registry.get_arch("gcn-cora").smoke()
    rules = shd.Rules.from_mesh(None)
    params = gnn.gcn_init(cfg, seed=0, device="cpu")
    batch = gnn_common.gnn_smoke_batch(True, device="cpu")
    batch["edge_mask"] = torch.arange(batch["edge_mask"].shape[0]) % 3 != 0
    out = {}
    for dev in ("cpu", cuda):
        p = {"layers": [{k: v.clone().to(dev) for k, v in layer.items()} for layer in params["layers"]]}  # the step writes p
        b = {k: v.to(dev) for k, v in batch.items()}
        before = embedbag.LAUNCHES
        value, grads = value_and_grad(lambda q: gnn.gcn_loss(cfg, rules, q, b))(p)
        torch.cuda.synchronize()
        launches = embedbag.LAUNCHES - before
        state = opt_lib.get("adamw").init(p)
        new, _, _ = gnn.make_gnn_train_step(cfg, rules)(p, state, b)
        out[str(dev)] = (value.cpu(), [x.cpu() for x in leaves(grads)], [x.cpu() for x in leaves(new)])
    assert launches == 6
    (v_cpu, g_cpu, n_cpu), (v_gpu, g_gpu, n_gpu) = out["cpu"], out[str(cuda)]
    assert abs(float(v_gpu) - float(v_cpu)) <= 1e-5 * abs(float(v_cpu))
    for a, w in zip(g_gpu + n_gpu, g_cpu + n_cpu):
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_crash_and_resume_is_bit_identical_on_gpu(cuda, tmp_path):
    from repro_torch.training import loop
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.tree import leaves

    cfg = registry.get_arch("gcn-cora").smoke()
    batch = {k: v.to(cuda) for k, v in gnn_common.gnn_smoke_batch(True, device="cpu").items()}

    def init_fn():
        params = gnn.gcn_init(cfg, seed=0, device=cuda)
        return params, opt_lib.get("adamw").init(params)

    kw = dict(init_fn=init_fn, train_step=gnn.make_gnn_train_step(cfg, shd.Rules.from_mesh(None)),
              batch_fn=lambda s: batch, n_steps=9)
    ref = loop.run(**kw)
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        loop.run(**kw, ckpt_dir=ck, ckpt_every=3, crash_at_step=5)
    resumed = loop.run(**kw, ckpt_dir=ck, ckpt_every=3)
    assert resumed.start_step == 3 and resumed.losses == ref.losses[3:]
    for a, b in zip(leaves((ref.params, ref.opt_state)), leaves((resumed.params, resumed.opt_state))):
        assert a.device.type == "cuda" and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The meta branches of B6 and B7, and count_step on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_branches_match_cuda_outputs_and_launch_nothing(cuda, dtype):
    """B6 and B7 on meta tensors: outputs of the CUDA launch's shape and
    dtype, and no launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((300, 48), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, 300, (1000,), generator=gen, device=cuda, dtype=torch.int32)
    bags = torch.sort(torch.randint(0, 70, (1000,), generator=gen, device=cuda, dtype=torch.int32))[0]
    q = torch.randn((2, 8, 64), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, 512, 2, 64), generator=gen, device=cuda).to(dtype)
    kv_len = torch.tensor(300, dtype=torch.int32, device=cuda)
    b6, b7 = embedbag.LAUNCHES, decode_attn.LAUNCHES
    meta6 = embedbag.embedding_bag_sorted(table.to("meta"), idx.to("meta"), bags.to("meta"), 70)
    meta7 = decode_attn.flash_decode_gqa(q.to("meta"), k.to("meta"), k.to("meta"), kv_len.cpu())
    assert (embedbag.LAUNCHES, decode_attn.LAUNCHES) == (b6, b7)
    card6 = embedbag.embedding_bag_sorted(table, idx, bags, 70)
    card7 = decode_attn.flash_decode_gqa(q, k, k, kv_len)
    torch.cuda.synchronize()
    assert (embedbag.LAUNCHES, decode_attn.LAUNCHES) == (b6 + 1, b7 + 1)
    for m, c in ((meta6, card6), (meta7, card7)):
        assert (m.device.type, m.shape, m.dtype) == ("meta", c.shape, c.dtype)


def test_count_step_equal_on_meta_and_cuda(cuda):
    """count_step of a small decode step (B7) and of an EmbeddingBag (B6)
    counts the same FLOPs, bytes and kernel calls on meta twins as on the
    card."""
    from repro_torch.launch import analysis

    cfg = dataclasses.replace(lm_common.lm_smoke("qwen3-14b"), d_head=64)
    rules = shd.Rules.from_mesh(None)
    params = transformer.init_params(cfg, seed=0, device=cuda)
    batch = lm_common.lm_smoke_batch(cfg, "decode", device=cuda)
    cache, tokens = batch["cache"], batch["tokens"]
    meta_cache = {"k": cache["k"].to("meta"), "v": cache["v"].to("meta"), "len": cache["len"].cpu()}
    meta = analysis.count_step(transformer.make_decode_step(cfg, rules),
                               (_to(params, "meta"), meta_cache, tokens.to("meta")))
    card = analysis.count_step(transformer.make_decode_step(cfg, rules), (params, cache, tokens))
    assert (meta.flops, meta.bytes, meta.kernels) == (card.flops, card.bytes, card.kernels)
    assert len(card.kernels) == cfg.n_layers

    table = torch.randn((500, 32), device=cuda)
    idx = torch.randint(0, 500, (2000,), device=cuda, dtype=torch.int32)
    bags = torch.randint(0, 64, (2000,), device=cuda, dtype=torch.int32)

    def bag(t, i, b):
        return eb_ops.embedding_bag(t, i, b, 64)

    meta = analysis.count_step(bag, (table.to("meta"), idx.to("meta"), bags.to("meta")))
    card = analysis.count_step(bag, (table, idx, bags))
    assert (meta.flops, meta.bytes, meta.kernels) == (card.flops, card.bytes, card.kernels)
    assert card.kernels == [("embedding_bag_sorted", 2000 * 32, (2000 + 64) * 32 * 4, 2000)]


def test_one_rank_nccl_mesh_equals_no_mesh(cuda, tmp_path):
    """A (1, 1) mesh of one NCCL rank on the card: S1's gather and the
    reference and sharded executors (both tile stores, witness levels on
    f32) equal ``mesh=None`` on the card, and the sharded path launches its
    kernel k levels a body (one bucket) on the rank, whose loop is
    captured with its pmax, as on one card."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import ranks

    g, placement = _sharded_setup()
    ranks.init_rank(0, 1, str(tmp_path / "store"), device=cuda, timeout_s=120)
    try:
        mesh = lmesh.make_test_mesh(1, 1)
        assert dist.get_backend() == "nccl" and shd.is_device_mesh(mesh)
        mask = np.zeros(g.n_labels, bool)
        mask[[0, 3]] = True
        arrays = strategies.stage_site_arrays(placement, cuda)
        for cap in (arrays["src"].shape[1], 5):
            got = strategies.s1_gather(strategies.stage_site_arrays(placement, cuda, mesh), mask, cap, mesh)
            want = strategies.s1_gather(arrays, mask, cap)
            assert all(torch.equal(a, b) for a, b in zip(got[:4], want[:4])) and got[4] == want[4]
        for expr in ("l0 (l1|l2)* l3", "(l0|l4)+", "l1 . l3^-1"):
            ca = paa.compile_query(expr, g)
            starts = paa.valid_start_nodes(ca, g)[:40]
            for backend, tile_dtype, sem in (
                ("reference", "f32", "witness"), ("frontier_kernel_sharded", "f32", "witness"),
                ("frontier_kernel_sharded", "uint32", "pairs"),
            ):
                run, launches = [], []
                for m in (mesh, None):
                    frontier.reset_launches()
                    ops.FIXPOINT_COUNTERS.clear()
                    out = strategies.s2_execute(placement, ca, starts, backend=backend, tile_dtype=tile_dtype,
                                                semantics=sem, block_size=32, device=cuda, mesh=m)
                    run.append((out[0], out[1]) + tuple(x.tobytes() for x in out[2:]))
                    launches.append((sum(frontier.launch_counts().values()), ops.FIXPOINT_COUNTERS["levels"],
                                     ops.FIXPOINT_COUNTERS["bodies"]))
                assert run[0][0].tobytes() == run[1][0].tobytes() and run[0][1:] == run[1][1:], (expr, backend)
                assert launches[0][1] == launches[1][1] > 0, (expr, backend)  # the same BFS levels
                if backend == "reference":
                    assert launches[0][0] == launches[1][0] == 0
                else:  # a rank's loop and one card's (one bucket) launch k levels a body
                    assert launches[0][0] == launches[0][2] * ops.LEVELS_PER_CHECK
                    assert launches[1][0] == launches[1][2] * ops.LEVELS_PER_CHECK
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_service_equals_no_mesh(cuda, tmp_path):
    """``QueryService(mesh=)`` on a (1, 1) mesh of one NCCL rank, the
    sharded backend over the bit-plane store (B3), an S1 window and witness
    requests (B1): the rank leads its own flush orders, and every ticket's
    answers, strategy, costs and witness levels equal ``mesh=None``'s on
    the card, with the same launches."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import ranks

    g, placement = _sharded_setup()
    stream = workloads.generate(g, workloads.WorkloadConfig(n_queries=12, hot_pool=3, max_starts=6, seed=2))
    cfg = ServeConfig(n_rollouts=40, seed=0, s2_backend="frontier_kernel_sharded", s2_tile_dtype="uint32",
                      s2_block_size=32)

    def serve(mesh):
        svc = QueryService(placement, NetworkParams(150, 450, 0.2), config=cfg, device=cuda, mesh=mesh)
        frontier.reset_launches()
        ops.FIXPOINT_COUNTERS.clear()
        tickets = [svc.enqueue(w.query, w.starts, strategy="S2") for w in stream[:6]]
        svc.flush()
        tickets += [svc.enqueue(w.query, w.starts, strategy="S1") for w in stream[:3]]
        svc.flush()
        tickets += [svc.enqueue(w.query, w.starts, strategy="S2", semantics="witness") for w in stream[6:]]
        svc.flush()
        svc.stop_followers()
        counts = dict(frontier.launch_counts(), levels=ops.FIXPOINT_COUNTERS["levels"],
                      bodies=ops.FIXPOINT_COUNTERS["bodies"])
        return [(a.query, a.strategy, a.answers, [dataclasses.astuple(c) for c in a.observed],
                 None if a.levels is None else a.levels.tobytes())
                for a in (t.result() for t in tickets)], counts

    want, want_launches = serve(None)
    ranks.init_rank(0, 1, str(tmp_path / "store"), device=cuda, timeout_s=120)
    try:
        mesh = lmesh.make_test_mesh(1, 1)
        assert dist.get_backend() == "nccl"
        got, launches = serve(mesh)
    finally:
        dist.destroy_process_group()
    assert got == want and launches["levels"] == want_launches["levels"]
    assert launches["fused_level_blocks_u32"] > 0 and launches["fused_level_blocks"] > 0  # witness: f32
    # the rank's loop and one card's (one bucket) launch k levels a body
    kernels = ("fused_level_blocks_u32", "fused_level_blocks")
    assert sum(launches[k] for k in kernels) == launches["bodies"] * ops.LEVELS_PER_CHECK
    assert sum(want_launches[k] for k in kernels) == want_launches["bodies"] * ops.LEVELS_PER_CHECK


RANK_LOOP_PATHS = [("reference", "f32", "pairs"), ("reference", "f32", "witness"),
                   ("frontier_kernel_sharded", "uint32", "pairs"), ("frontier_kernel_sharded", "f32", "witness")]


@pytest.mark.parametrize("backend, tile_dtype, semantics", RANK_LOOP_PATHS)
def test_one_rank_nccl_replay_equals_eager_and_no_mesh(cuda, monkeypatch, tmp_path, backend, tile_dtype, semantics):
    """On a (1, 1) mesh of one NCCL rank, a per-rank executor's fixpoints
    replayed from CUDA graphs that hold their ``pmax`` (``LEVELS_PER_CHECK``
    levels a replay) equal the eager gated body of one level a check
    (``ops.EAGER``) and ``mesh=None`` bit for bit: answers, meters, witness
    planes and BFS levels.  The first call captures once (one chunk
    height), a second replays only; one host sync a body; the bodies'
    ``all_reduce`` calls are one a level, k a body, counted at each
    replay; the sharded path's kernel launches k a body."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import ranks

    g, placement = _sharded_setup()
    ca = paa.compile_query("l0 (l1|l2)* l3", g)
    starts = paa.valid_start_nodes(ca, g)[:40]
    kw = {"placement": placement} if backend == "frontier_kernel_sharded" else {}
    one_card = strategies.make_s2_step_fn(ca, g.n_nodes, backend=backend, tile_dtype=tile_dtype, semantics=semantics,
                                          block_size=32, device=cuda, **kw)
    arrays = strategies.stage_site_arrays(placement, cuda) if backend == "reference" else None
    want = _loop_run(one_card, placement, ca, starts, arrays, semantics)[0]
    ranks.init_rank(0, 1, str(tmp_path / "store"), device=cuda, timeout_s=120)
    try:
        mesh = lmesh.make_test_mesh(1, 1)
        arrays = strategies.stage_site_arrays(placement, cuda, mesh) if backend == "reference" else None

        def step():
            return strategies.make_s2_step_fn(ca, g.n_nodes, backend=backend, tile_dtype=tile_dtype,
                                              semantics=semantics, block_size=32, device=cuda, mesh=mesh, **kw)

        monkeypatch.setattr(ops, "EAGER", True)
        monkeypatch.setattr(ops, "LEVELS_PER_CHECK", 1)
        eager, eager_c, _ = _loop_run(step(), placement, ca, starts, arrays, semantics)
        monkeypatch.setattr(ops, "EAGER", False)
        monkeypatch.setattr(ops, "LEVELS_PER_CHECK", 4)
        fn = step()
        for call in range(2):
            got, c, n = _loop_run(fn, placement, ca, starts, arrays, semantics)
            assert got == eager == want, (backend, semantics, call)
            assert c["levels"] == eager_c["levels"] > 0 and c["host_syncs"] == c["bodies"] <= eager_c["bodies"]
            assert c["captures"] == (1 if call == 0 else 0)
            assert c["replays"] == c["bodies"] - c["captures"]  # the first body ran eagerly
            assert c["all_reduces"] == c["bodies"] * 4 and eager_c["all_reduces"] == eager_c["bodies"]
            assert n == (c["bodies"] * 4 if backend == "frontier_kernel_sharded" else 0)
        fn.release()
    finally:
        dist.destroy_process_group()


def test_an_evicted_rank_executor_returns_its_graph_memory(cuda, tmp_path):
    """A per-rank executor on an NCCL rank, evicted from the cache
    (``_ExecEntry.release``), frees its graphs, their static state and its
    plan: ``memory_allocated`` comes back to its level before the build."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import ranks

    g, placement = _sharded_setup()
    ca = paa.compile_query("l0 (l1|l2)* l3", g)
    starts = paa.valid_start_nodes(ca, g)[:40]
    ranks.init_rank(0, 1, str(tmp_path / "store"), device=cuda, timeout_s=120)
    try:
        mesh = lmesh.make_test_mesh(1, 1)
        arrays = strategies.stage_site_arrays(placement, cuda, mesh)
        for i, backend in enumerate(("frontier_kernel_sharded", "frontier_kernel_sharded", "reference")):
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            step = strategies.make_s2_step_fn(ca, g.n_nodes, backend=backend, placement=placement, block_size=32,
                                              device=cuda, mesh=mesh)
            ops.FIXPOINT_COUNTERS.clear()
            strategies.s2_execute(placement, ca, starts, step_fn=step, device_arrays=arrays)
            assert ops.FIXPOINT_COUNTERS["captures"] == 1 and torch.cuda.memory_allocated() > base
            entry = plancache._ExecEntry(graph_key=(), sig=None, fn=step)
            del step
            entry.release()
            gc.collect()
            torch.cuda.synchronize()
            if i:  # the first build is the warm-up: whatever it allocates for good
                assert torch.cuda.memory_allocated() == base, backend
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
def test_one_rank_nccl_embedding_bag_sharded_equals_b6(cuda, tmp_path, table_dtype):
    """``embedding_bag_sharded`` on a (1, 1) mesh of one NCCL rank (the
    rank's shard is the whole table, its block the whole batch) is the
    one-card B6 bags bit for bit, in one B6 launch and a psum over the
    model axis; B6 with no lookup writes zero bags."""
    import torch.distributed as dist

    from repro_torch.dist import collectives
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import ranks

    table = torch.randn((3000, 128), device=cuda).to(table_dtype)
    idx = torch.randint(0, 3000, (512, 3), device=cuda, dtype=torch.int32)
    rules = shd.Rules.from_mesh(None)
    for hot in (1, 3):
        want = dlrm_model.embedding_bag_sharded(table, idx[:, :hot].contiguous(), rules)
        ranks.init_rank(0, 1, str(tmp_path / f"store{hot}"), device=cuda, timeout_s=120)
        try:
            mesh = lmesh.make_test_mesh(1, 1)
            with shd.use_mesh(mesh):
                mesh_rules = shd.Rules.from_mesh(mesh)
                before = embedbag.LAUNCHES
                collectives.WIRE_COUNTERS.clear()
                got = dlrm_model.embedding_bag_sharded(
                    dlrm_model.table_row_shard(table, 0, mesh_rules.model_size), idx[:, :hot].contiguous(),
                    mesh_rules)
                torch.cuda.synchronize()
                assert embedbag.LAUNCHES - before == 1 and collectives.WIRE_COUNTERS["all_reduces"] == 1
        finally:
            dist.destroy_process_group()
        assert got.dtype == table_dtype and torch.equal(got.view(torch.int16 if table_dtype == torch.bfloat16
                                                                 else torch.int32),
                                                        want.view(torch.int16 if table_dtype == torch.bfloat16
                                                                  else torch.int32))
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    zero = embedbag.embedding_bag_sorted(table, empty, empty, 7)
    assert zero.shape == (7, 128) and not zero.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 112, 128, 256])
def test_decode_partials_and_combine_equal_flash_decode(cuda, dh, dtype):
    """B7's partials then combine entries on one shard at offset 0 are
    ``flash_decode_gqa``'s own two launches: bit for bit where it splits
    (S 16,384 at B 1, G 2: 128 splits), and bit for bit at one split too
    (B 64, G 8, S 1,024), where ``flash_decode_gqa`` normalises in the
    split kernel: the combine's merge of one split multiplies by e^0 = 1
    and adds to 0, then divides as the split kernel does.  Over 4 shards
    of the cache, each with its offset and the global kv_len, the merge
    is within 2e-5 (f32) or 2e-2 (bf16) of the largest output; kv_len 0
    gives every shard's V mean merged (V's mean over all S)."""
    for b, g, s in ((1, 2, 16384), (64, 8, 1024)):
        r = 5 if dh == 128 else 4
        q = torch.randn((b, g * r, dh), device=cuda).to(dtype)
        k = torch.randn((b, s, g, dh), device=cuda).to(dtype)
        v = torch.randn((b, s, g, dh), device=cuda).to(dtype)
        n_split, _ = decode_attn.decode_splits(b, g, s)
        assert (n_split > 1) == (s == 16384)
        for kv in (s, s - 77, 300, 0):
            kv_len = torch.tensor(kv, dtype=torch.int32, device=cuda)
            want = decode_attn.flash_decode_gqa(q, k, v, kv_len)
            p0, c0 = decode_attn.PARTIAL_LAUNCHES, decode_attn.COMBINE_LAUNCHES
            part = decode_attn.flash_decode_gqa_partials(q, k, v, kv_len, 0)
            assert part.m.shape == (b, g, n_split, r)
            got = decode_attn.flash_decode_combine(part, dtype)
            torch.cuda.synchronize()
            assert (decode_attn.PARTIAL_LAUNCHES - p0, decode_attn.COMBINE_LAUNCHES - c0) == (1, 1)
            assert torch.equal(got, want), (b, g, s, kv)
            s_loc = s // 4
            shards = [decode_attn.flash_decode_gqa_partials(q, k[:, i * s_loc : (i + 1) * s_loc].contiguous(),
                                                            v[:, i * s_loc : (i + 1) * s_loc].contiguous(),
                                                            kv_len, i * s_loc, block_kv=math.gcd(s_loc, 512))
                      for i in range(4)]
            merged = decode_attn.ranks_major(torch.stack([p.buf for p in shards]), shards[0].shape)
            four = decode_attn.flash_decode_combine(merged, dtype)
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            scale = float(want.float().abs().max())
            assert float((four.float() - want.float()).abs().max()) <= tol * scale, (b, g, s, kv)


def test_decode_partials_past_kv_len_write_zero_weight(cuda):
    """A shard that lies wholly past the global kv_len writes m = -1e30,
    l = 0 and acc = 0 in every split (it walks nothing), where a local
    kv_len of 0 would walk its whole shard at -1e30 (l = its length); the
    wrapper refuses a negative offset and partials of other shapes."""
    q = torch.randn((2, 8, 128), device=cuda).to(torch.bfloat16)
    k = torch.randn((2, 4096, 2, 128), device=cuda).to(torch.bfloat16)
    kv_len = torch.tensor(1000, dtype=torch.int32, device=cuda)
    part = decode_attn.flash_decode_gqa_partials(q, k, k, kv_len, 4096)
    torch.cuda.synchronize()
    assert (part.m == -1e30).all() and (part.l == 0).all() and (part.acc == 0).all()
    local0 = decode_attn.flash_decode_gqa_partials(q, k, k, torch.zeros_like(kv_len), 0)
    assert float(local0.l.sum()) == 4096 * 2 * 8
    with pytest.raises(ValueError, match="kv_offset"):
        decode_attn.flash_decode_gqa_partials(q, k, k, kv_len, -1)
    with pytest.raises(ValueError, match="partials"):
        decode_attn.flash_decode_combine(decode_attn.Partials(part.buf[:-1], part.shape), torch.bfloat16)


def test_one_rank_nccl_expert_parallel_moe_equals_capacity_plain(cuda, tmp_path):
    """The expert-parallel MoE layer on a (1, 1) mesh of one NCCL rank,
    bf16, 64 experts top-8 (kimi-k2's ``fsdp`` gathers over a one-rank data
    axis): at capacity 1.25 it drops assignments and equals
    ``moe_capacity_plain`` within 2e-2 of the largest |output|; at 8.0
    nothing drops and it equals the one-card layer likewise."""
    import torch.distributed as dist

    from repro_torch.dist import collectives
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import ranks

    gen = torch.Generator(device=cuda).manual_seed(5)
    p = layers.init_moe(gen, 256, 128, 64, torch.bfloat16)
    # a direction every token shares, which experts 0-7 favour: their loads
    # pass capacity 1.25's 208 slots an expert
    common = torch.randn(256, generator=gen, device=cuda)
    x = (torch.randn((4, 256, 256), generator=gen, device=cuda) + common).to(torch.bfloat16)
    p["router"][:, :8] += 2.0 * common[:, None] / common.square().sum()
    ranks.init_rank(0, 1, str(tmp_path / "store"), device=cuda, timeout_s=120)
    try:
        mesh = lmesh.make_test_mesh(1, 1)
        rules = shd.Rules.from_mesh(mesh)
        with shd.use_mesh(mesh):
            for cf in (1.25, 8.0):
                collectives.WIRE_COUNTERS.clear()
                got = layers.apply_moe(layers.moe_shard(p, rules, fsdp=True), x, n_experts=64, top_k=8,
                                       rules=rules, capacity_factor=cf, fsdp=True)
                want, kept = layers.moe_capacity_plain(p, x, n_experts=64, top_k=8, rules=rules,
                                                       capacity_factor=cf)
                assert collectives.WIRE_COUNTERS["all_to_all"] == 3
                assert collectives.WIRE_COUNTERS["all_gather"] == 3
                scale = float(want.float().abs().max())
                assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale, cf
                assert (not kept.all()) == (cf == 1.25)
        one = layers.apply_moe(p, x, n_experts=64, top_k=8, rules=shd.Rules.from_mesh(None))
        assert float((got.float() - one.float()).abs().max()) <= 2e-2 * float(one.float().abs().max())
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_train_step_equals_one_card(cuda, tmp_path):
    """GCN's and DLRM's train steps (AdamW, ZeRO-1) on a (1, 1) mesh of one
    NCCL rank: the loss, every parameter and every moment after two steps
    ``torch.equal`` to the one-card step's (a one-rank program is the
    one-card program: its reductions and gathers move nothing); a smoke
    MoE LM's loss and gradient with remat, expert-parallel on the rank,
    within 1e-5 and 1e-4 of the one-card layer's (f32: GShard slots
    against routed rows sum in other orders)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import ranks
    from repro_torch.training.tree import leaves, value_and_grad

    gcfg = registry.get_arch("gcn-cora").smoke()
    gbatch = gnn_common.gnn_smoke_batch(True, seed=3, device=cuda)
    dcfg = dlrm_mlperf.smoke()
    gen = torch.Generator(device=cuda).manual_seed(9)
    dbatch = {"dense": torch.randn((16, dcfg.n_dense), generator=gen, device=cuda),
              "sparse": torch.randint(0, 32, (16, dcfg.n_sparse, 1), generator=gen, device=cuda, dtype=torch.int32),
              "labels": (torch.rand(16, generator=gen, device=cuda) < 0.5).float()}

    def run(mesh):
        rules = shd.Rules.from_mesh(mesh)
        out = []
        with shd.use_mesh(mesh):
            params = gnn.gcn_init(gcfg, seed=1, device=cuda)
            state = gnn.optimizer_for(gcfg, rules, params).init(params)
            step = gnn.make_gnn_train_step(gcfg, rules)
            for _ in range(2):
                params, state, loss = step(params, state, gbatch)
            out += [loss] + leaves((params, state))
            params = dlrm_model.shard_params(dcfg, rules, dlrm_model.init_params(dcfg, seed=2, device=cuda), 16)
            state = dlrm_model.optimizer_for(dcfg, rules, params, 16).init(params)
            step = dlrm_model.make_train_step(dcfg, rules)
            for _ in range(2):
                params, state, loss = step(params, state, dbatch)
            out += [loss] + leaves((params, state))
        return out

    lcfg = dataclasses.replace(registry.get_arch("granite-moe-1b-a400m").smoke(), remat=True)
    tokens = torch.randint(0, lcfg.vocab, (4, 33), generator=gen, device=cuda, dtype=torch.int32)
    lbatch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def lm_loss(mesh):
        """The MoE LM's loss and gradient with each layer recomputed in the
        backward, which CUDA runs on autograd's device thread: the
        expert-parallel layer there must see the installed mesh."""
        rules = transformer.rules_for(lcfg, mesh)
        with shd.use_mesh(mesh):
            params = transformer.shard_params(lcfg, rules, transformer.init_params(lcfg, seed=3, device=cuda))
            return value_and_grad(lambda p: transformer.loss_fn(lcfg, rules, p, lbatch["tokens"],
                                                                lbatch["labels"]))(params)

    want = run(None)
    want_lm = lm_loss(None)
    real_moe = layers.apply_moe
    layers.apply_moe = functools.partial(real_moe, capacity_factor=4.0)  # nothing drops
    ranks.init_rank(0, 1, str(tmp_path / "store"), device=cuda, timeout_s=120)
    try:
        mesh = lmesh.make_test_mesh(1, 1)
        got = run(mesh)
        got_lm = lm_loss(mesh)
    finally:
        layers.apply_moe = real_moe
        dist.destroy_process_group()
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert abs(float(got_lm[0]) - float(want_lm[0])) <= 1e-5 * abs(float(want_lm[0]))
    for a, b in zip(leaves(got_lm[1]), leaves(want_lm[1])):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-6)


def test_big_equiformer_gradient_equals_plain_twin(cuda, tmp_path, monkeypatch):
    """``equiformer_energy_big``'s gradient on a (1, 1) mesh of one NCCL
    rank, on a graph of 4 chunks of 1,024 edges (the last partly masked),
    every layer and chunk recomputed in the backward: every leaf finite
    and within 2e-2 of its plain twin's (``equiformer_atoms_big_plain``,
    f32 sums where the path adds chunk by chunk into bf16), each leaf
    held to the larger of its largest and 1e-3 of the model's largest."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import ranks
    from repro_torch.training.tree import leaves, value_and_grad

    cfg = registry.get_arch("equiformer-v2").smoke()
    n, e = 512, 4096
    gen = torch.Generator(device=cuda).manual_seed(4)
    batch = {"species": torch.randint(0, cfg.n_species, (n,), generator=gen, device=cuda, dtype=torch.int32),
             "positions": torch.rand((n, 3), generator=gen, device=cuda) * 4.0,
             "node_mask": torch.ones(n, dtype=torch.bool, device=cuda),
             "edge_src": torch.randint(0, n, (e,), generator=gen, device=cuda, dtype=torch.int32),
             "edge_dst": torch.randint(0, n, (e,), generator=gen, device=cuda, dtype=torch.int32),
             "edge_mask": torch.arange(e, device=cuda) < e - 700}
    params = gnn.equiformer_init(cfg, seed=3, device=cuda)
    monkeypatch.setattr(gnn, "_BIG_CHUNK", 1024)
    _, want = value_and_grad(lambda p: gnn.equiformer_atoms_big_plain(cfg, p, batch).sum())(params)
    ranks.init_rank(0, 1, str(tmp_path / "store"), device=cuda, timeout_s=120)
    try:
        mesh = lmesh.make_test_mesh(1, 1)
        with shd.use_mesh(mesh):
            rules = shd.Rules.from_mesh(mesh)
            _, got = value_and_grad(lambda p: gnn.equiformer_energy_big(cfg, rules, p, batch)[0])(params)
    finally:
        dist.destroy_process_group()
    floor = 1e-3 * max(float(w.abs().max()) for w in leaves(want))
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        assert bool(torch.isfinite(g).all()), i
        assert float((g - w).abs().max()) <= 2e-2 * max(float(w.abs().max()), floor), i
