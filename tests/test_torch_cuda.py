"""The port on the card: the four CUDA level kernels (B1 and B3 behind
``fused_level_blocks``, B2 and B4 behind ``packed_level_blocks``), the
baseline step B5 (``frontier_step_blocks``), EmbeddingBag B6 and flash
decode B7 against their plain PyTorch versions, the wrappers' refusals,
and the S1 and S2 executors (witness semantics and bounded counting
too), the branching estimator, the baseline fixpoint and the serving
runtime (``QueryService``, its plan store's device memory,
``AsyncQueryService``'s flush worker) on the GPU against the same code
on the CPU.  A CUDA kernel
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
import gc

import numpy as np
import pytest
import torch

from repro_torch.core import estimation, paa, regex, strategies
from repro_torch.core.cost_model import NetworkParams
from repro_torch.graph import generators, partition, structure, workloads
from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.embedbag import embedbag
from repro_torch.kernels.embedbag import ops as eb_ops
from repro_torch.kernels.frontier import frontier, ops
from repro_torch.serve import AsyncQueryService, QueryService, ServeConfig

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
        if device == cuda:
            name = SERVE_KERNEL[(backend, tile_dtype)]
            assert counts[name] == ops.FIXPOINT_COUNTERS["levels"] > 0
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
    assert counts[name] == ops.FIXPOINT_COUNTERS["levels"] > 0
    for (q, s), a in zip(queries, got):
        assert a.answers == want.submit(q, s, strategy="S2").answers
