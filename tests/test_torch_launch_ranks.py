"""The dry run's per-rank count (``launch/cells.py``'s rank programs,
``launch/analysis.py``'s collectives, ``launch/mesh.py``'s fake group).

* (a) One spawn of 4 ``gloo`` ranks on a (2, 2) mesh.  Each rank counts
  its program of every case on its real CPU tensors, then, its group torn
  down, the same program on meta twins under a ``fake`` group of 4 ranks
  as the same rank.  FLOPs, logical and wire collective bytes by kind are
  equal; the wire bytes are the rank's ``WIRE_COUNTERS["bytes"]`` growth;
  HBM bytes are equal but for exactly the shape-only stand-ins' own ops
  (DLRM's mask of a shard's lookups, GCN's edge mask, the reference
  executor's edge sets and its fixpoint loop's flag and gate, counted
  apart) and the host values the meta run uploads as the card would (a
  CPU tensor or a Python scalar made a device tensor), which a CPU run
  does not dispatch.
* (b) At the (16, 16) layout, one cell per family: the logical
  collective bytes against a closed form of the shapes.
* (c) A mesh of one rank: the rank's FLOPs are the one-card program's,
  every collective runs over a one-rank group and adds no logical byte.
* (d) ``repro``'s compiled HLO (``collective_bytes``) for DLRM serve and
  the GCN train step on 8 forced host devices, against the port's
  logical bytes by kind on the same (4, 2) layout.
* (e) The kernels' custom ops under ``torch.library.opcheck`` and counted
  once a call with their work formulas; B6 records a gradient only where
  one is needed; the count refuses a c10d op other than ``allreduce_``.
* (f) One cell per family at the (2, 16, 16) layout under a fake group of
  512 ranks.

Every fake group lives in a subprocess, a spawned rank, or inside
``launch.mesh.fake_mesh``, which tears it down.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import dlrm_mlperf, gnn_common, lm_common, registry
from repro_torch.core import paa, strategies
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.graph import generators
from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.embedbag import embedbag
from repro_torch.kernels.frontier import ops as fops
from repro_torch.launch import analysis, cells, dryrun, mesh, ranks
from repro_torch.models import dlrm, gnn
from repro_torch.models import transformer as tr
from repro_torch.training.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
WORLD, SHAPE = 4, (2, 2)
SPAWN_TIMEOUT_S = 150
SHARD_ABOVE_ROWS = 40
CASES = ("lm_train", "moe_train", "decode_seq", "dlrm_serve", "dlrm_train", "gcn_train", "equiformer_big",
         "rpq_reference")

pytestmark = pytest.mark.timeout_s(SPAWN_TIMEOUT_S + 120)


# ---------------------------------------------------------------------------
# the cases: each a rank's program on real CPU tensors
# ---------------------------------------------------------------------------


def _dlrm_cfg():
    return dlrm_mlperf.smoke()


def _dlrm_batch(cfg, kind: str) -> dict:
    """Each data block of 4 rows sends half of a sharded table's lookups
    to each row shard, the meta run's even share."""
    b = dlrm_mlperf.smoke_batch(cfg, kind, seed=1, device="cpu")
    for t, rows in enumerate(cfg.table_sizes):
        k = -(-rows // SHAPE[1])
        b["sparse"][:, t, 0] = torch.tensor([0, k, 1, k + 1, 2, k + 2, 3, k + 3], dtype=torch.int32)
    return b


def _rpq_inputs():
    """A graph of one label, and site arrays with every slot a valid edge
    of it: the real run's edge sets are the meta run's every-slot
    stand-in, in shape."""
    g = generators.random_labeled_graph(40, 200, 1, seed=5)
    rng = np.random.default_rng(5)
    e = 48
    arrays = {"src": rng.integers(0, 40, (4, e)), "dst": rng.integers(0, 40, (4, e)),
              "lbl": np.zeros((4, e)), "mask": np.ones((4, e), bool)}
    return g, {k: torch.from_numpy(v.astype(bool if k == "mask" else np.int32)) for k, v in arrays.items()}, (
        paa.compile_query("l0 l0*", g))


def _program(name: str, m) -> tuple:
    """(step, args, stand-in bytes fn) of case ``name`` on the installed
    rank ``m``, real CPU tensors; the stand-in fn gives the bytes of the
    real run's ops that the meta run's stand-in replaces."""
    if name in ("lm_train", "moe_train", "decode_seq"):
        cfg = lm_common.lm_smoke("granite" if name == "moe_train" else "qwen3-14b", moe=name == "moe_train")
        rules = tr.rules_for(cfg, m)
        params = tr.init_params(cfg, seed=0, device="cpu")
        with shd.use_mesh(m):
            params = tr.shard_params(cfg, rules, params)
            if name == "decode_seq":
                b = lm_common.lm_smoke_batch(cfg, "decode", device="cpu")
                cache = tr.cache_shard(cfg, rules, b["cache"], seq_sharded=True)
                step = tr.make_decode_step(cfg, rules, seq_sharded=True)
                return cells.on_mesh(m, step), (params, cache, b["tokens"]), None
            state = tr.optimizer_for(cfg, rules, params).init(params)
        batch = lm_common.lm_smoke_batch(cfg, "train", device="cpu")
        return cells.on_mesh(m, tr.make_train_step(cfg, rules)), (params, state, batch), None
    if name.startswith("dlrm"):
        cfg = _dlrm_cfg()
        kind = name.split("_")[1]
        rules = shd.Rules.from_mesh(m)
        batch = _dlrm_batch(cfg, kind)
        n = batch["dense"].shape[0]
        with shd.use_mesh(m):
            params = dlrm.shard_params(cfg, rules, dlrm.init_params(cfg, seed=0, device="cpu"), n)
            n_blk = n // SHAPE[0] * cfg.multi_hot
            # per sharded table: the mask and the bag ids of the block's lookups
            # gathered by the shard's mask (N bytes of bool, 4 bytes a kept id
            # written and read), where the meta run takes a slice
            extra = sum(r > SHARD_ABOVE_ROWS for r in cfg.table_sizes) * 2 * (n_blk + 8 * (n_blk // SHAPE[1]))
            if kind == "train":
                state = dlrm.optimizer_for(cfg, rules, params, n).init(params)
                return cells.on_mesh(m, dlrm.make_train_step(cfg, rules)), (params, state, batch), lambda: extra
        return cells.on_mesh(m, dlrm.make_serve_step(cfg, rules)), (params, batch), lambda: extra
    if name in ("gcn_train", "equiformer_big"):
        arch = "gcn-cora" if name == "gcn_train" else "equiformer-v2"
        cfg = registry.get_arch(arch).smoke()
        batch = gnn_common.gnn_smoke_batch(arch == "gcn-cora", seed=3, device="cpu")
        if arch == "equiformer-v2":
            batch["energy"] = batch["energy"][:1]
        rules = shd.Rules.from_mesh(m)
        params = gnn.INIT_FNS[arch](cfg, seed=0, device="cpu")
        with shd.use_mesh(m):
            state = gnn.optimizer_for(cfg, rules, params).init(params)
        e_loc = batch["edge_src"].shape[0] // (SHAPE[0] * SHAPE[1])
        # GCN's kept edges: two gathers by the (all-true) mask of the rank's edges
        extra = (lambda: 2 * (e_loc + 8 * e_loc)) if arch == "gcn-cora" else None
        return cells.on_mesh(m, gnn.make_gnn_train_step(cfg, rules)), (params, state, batch), extra
    g, whole, ca = _rpq_inputs()
    lo, hi = collectives.site_block(4, ("data",), m)
    arrays = {k: v[lo:hi].contiguous() for k, v in whole.items()}
    fn = strategies.make_s2_step_fn(ca, g.n_nodes, 1, backend="reference", mesh=m, site_axes=("data",),
                                    batch_axis="model")
    starts = torch.arange(0, 40, 5, dtype=torch.int32)

    def edge_sets(*a):
        return strategies._reference_edge_sets(ca, strategies.transition_runs(ca),
                                                strategies.symbol_set_groups(ca),
                                                dict(zip(("src", "lbl", "dst", "mask"), a)), g.n_nodes)

    def step(src, lbl, dst, mask, starts):
        return fn(starts, {"src": src, "lbl": lbl, "dst": dst, "mask": mask})

    args = tuple(arrays[k] for k in ("src", "lbl", "dst", "mask")) + (starts,)

    def loop():
        # the real run's fixpoint is an ops.LevelLoop (one gated body at
        # max_levels 1): its flag, gate and level counter around the level,
        # on the rank's (starts, states, nodes) bools, are ops of its own,
        # counted here on a level that changes nothing; the meta run takes
        # one level without them
        frontier = torch.zeros((starts.shape[0] // SHAPE[1], ca.n_states, g.n_nodes), dtype=torch.bool)
        frontier[0, ca.start, 0] = True
        run = fops.LevelLoop(lambda state, lev: state, 1, "gloo").run
        return analysis.count_step(lambda f: run((f,)), (frontier,)).bytes

    return step, args, (edge_sets, args[:4], loop)


def _meta(tree):
    return tree_map(lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t, tree)


def _meta_args(name: str, args):
    if name == "decode_seq":  # the cache's len stays on the CPU
        params, cache, tokens = args
        return _meta(params), dict(_meta({k: cache[k] for k in ("k", "v")}), len=cache["len"].clone()), _meta(tokens)
    return _meta(args)


def _summary(c: analysis.StepCount) -> dict:
    return {"flops": c.flops, "bytes": c.bytes, "argument_bytes": c.argument_bytes,
            "collectives": c.collectives, "wire": c.wire, "kernels": [k[0] for k in c.kernels]}


def _count_cases(rank: int, m, real: bool) -> dict:
    out = {}
    for name in CASES:
        # the smoke graph takes equiformer_energy_big; the smoke tables of
        # more than SHARD_ABOVE_ROWS rows are sharded (the paper's rule
        # replicates every table of a smoke size)
        gnn._BIG_GRAPH_NODES, gnn._BIG_CHUNK = 24, 8
        dlrm.embedding_placement = lambda rows, *a, **k: types.SimpleNamespace(
            mode="shard" if rows > SHARD_ABOVE_ROWS else "replicate")
        step, args, stand_in = _program(name, m)
        if not real:
            args = _meta_args(name, args)
        w0 = collectives.WIRE_COUNTERS["bytes"]
        uploads = []
        traffic = analysis._traffic

        def counted(func, a, kw, ins, outs):
            # a host value made a tensor as it is (a CPU tensor copied in its
            # dtype, a Python scalar as a tensor): on the meta device the
            # card's upload, which a CPU run mostly skips (``.to`` of a CPU
            # tensor to the CPU is no op); counted on both sides
            b = traffic(func, a, kw, ins, outs)
            if (func is torch.ops.aten._to_copy.default and ins[0].device.type == "cpu"
                    and ins[0].dtype == outs[0].dtype) or func is torch.ops.aten.scalar_tensor.default:
                uploads.append(b)
            return b

        analysis._traffic = counted
        try:
            c = analysis.count_step(step, args)
        finally:
            analysis._traffic = traffic
        r = _summary(c)
        r["uploads"] = sum(uploads)
        r["wire_counter"] = collectives.WIRE_COUNTERS["bytes"] - w0
        if isinstance(stand_in, tuple):  # the edge sets, counted apart, and the loop's own ops
            fn, a, loop = stand_in
            r["stand_in"] = analysis.count_step(fn, a if real else _meta(a)).bytes + (loop() if real else 0)
        elif stand_in is not None:
            r["stand_in"] = stand_in() if real else 0
        out[name] = r
    return out


def _rank_program(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    ranks.init_rank(rank, world, store, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    try:
        m = DeviceMesh("cpu", torch.arange(world).reshape(SHAPE), mesh_dim_names=("data", "model"))
        real = _count_cases(rank, m, True)
    finally:
        dist.destroy_process_group()
    with mesh.fake_mesh(mesh.MeshLayout(("data", "model"), SHAPE), rank=rank) as fm:
        fake = _count_cases(rank, fm, False)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"real": real, "meta": fake}, f)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch_ranks")
    ranks.run_ranks(_rank_program, WORLD, (WORLD, str(d / "store"), str(d)), timeout_s=SPAWN_TIMEOUT_S,
                    device="cpu")
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank", range(WORLD))
def test_meta_count_equals_real_run(spawned, case, rank):
    real, meta = spawned[rank]["real"][case], spawned[rank]["meta"][case]
    assert meta["flops"] == real["flops"]
    assert meta["kernels"] == real["kernels"]
    assert meta["collectives"] == real["collectives"] and real["collectives"]
    assert meta["wire"] == real["wire"]
    assert real["wire"]["allreduce_"]["bytes"] == real["wire_counter"] == meta["wire_counter"] > 0
    assert meta["argument_bytes"] == real["argument_bytes"]
    assert (real["bytes"] - real["uploads"]) - (meta["bytes"] - meta["uploads"]) == (
        real.get("stand_in", 0) - meta.get("stand_in", 0))


# ---------------------------------------------------------------------------
# (b) closed-form collective bytes at the (16, 16) layout
# ---------------------------------------------------------------------------


def _kinds(count: analysis.StepCount) -> dict:
    """Per kind (calls, logical bytes) of the collectives over more than
    one rank."""
    return {k: (c["calls"], c["bytes"]) for k, c in count.collectives.items() if c["calls"]}


def _rank_count(arch: str, shape: str, layout, m):
    plan = cells.build_cell(arch, shape, layout, m)
    return plan, analysis.count_step(plan.rank.fn, plan.rank.args)


def test_closed_form_collectives_single_pod():
    layout = mesh.make_production_mesh()
    D, M = layout.shape["data"], layout.shape["model"]
    with mesh.fake_mesh(layout) as m:
        # DLRM serve_p99: a psum over the model axis of each sharded table's
        # bf16 bags of the rank's D-th of the batch, then the f32 logits
        # gathered over the data axis
        cfg = registry.get_arch("dlrm-mlperf").full()
        plan, c = _rank_count("dlrm-mlperf", "serve_p99", layout, m)
        B = registry.RECSYS_SHAPES["serve_p99"].dims["batch"]
        n_sharded = cfg.table_modes(D * M, B).count("shard")
        assert n_sharded > 0
        assert _kinds(c) == {"all-reduce": (n_sharded, n_sharded * (B // D) * cfg.embed_dim * 2),
                             "all-gather": (1, B * 4)}

        # qwen3-14b long_500k: a layer's B7 partials, (B, H, n_split, Dh + 2)
        # f32 of the rank's S/M positions, gathered over the model axis; the
        # rank's tensor-parallel blocks: q's, k's and v's bf16 columns
        # gathered (every head attends on the rank's positions), wo's and
        # w_down's partial outputs and the embedding psum-ed, the logits'
        # vocab columns gathered
        qcfg = registry.get_arch("qwen3-14b").full()
        plan, c = _rank_count("qwen3-14b", "long_500k", layout, m)
        dims = registry.LM_SHAPES["long_500k"].dims
        n_split = decode_attn.decode_splits(dims["batch"], qcfg.n_kv_heads, dims["seq"] // M)[0]
        part = dims["batch"] * qcfg.n_q_heads * n_split * (qcfg.d_head + 2) * 4
        L, b = qcfg.n_layers, dims["batch"]
        qkv = b * (qcfg.n_q_heads + 2 * qcfg.n_kv_heads) * qcfg.d_head * 2
        assert _kinds(c) == {"all-gather": (4 * L + 1, L * (M * part + qkv) + b * qcfg.padded_vocab * 2),
                             "all-reduce": (2 * L + 1, (2 * L + 1) * b * qcfg.d_model * 2)}
        assert [k[0] for k in c.kernels] == ["flash_decode_gqa_partials", "flash_decode_combine"] * qcfg.n_layers

        # GCN full_graph_sm train: the degrees' and each layer's scatters
        # psum-ed over data, then model (one all_reduce an axis); each
        # layer's messages enter the edge axes, whose backward psums their
        # cotangent over both at once; ZeRO-1 all-gathers each leaf it cut
        gcfg = gnn_common.gcn_for_shape(registry.get_arch("gcn-cora").full(),
                                       registry.GNN_SHAPES["full_graph_sm"])
        plan, c = _rank_count("gcn-cora", "full_graph_sm", layout, m)
        params = plan.rank.args[0]
        n = plan.rank.args[2]["node_feat"].shape[0]
        widths = [layer["w"].shape[1] for layer in params["layers"]]
        with shd.use_mesh(m):
            opt = gnn.optimizer_for(gcfg, shd.Rules.from_mesh(m), params)
        gathered = [t.numel() * 4 for t, z in zip(analysis.tensor_leaves(params), opt.zero_dims) if z is not None]
        assert _kinds(c) == {
            "all-reduce": (2 * 2 + 2 * len(widths) + len(widths),
                           2 * 2 * n * 4 + 2 * sum(n * w * 4 for w in widths) + sum(n * w * 4 for w in widths)),
            "all-gather": (len(gathered), sum(gathered)),
        }

        # alibaba-rpq serve_queries: the reference executor on its sites,
        # the widest run agreed (int64), per fixpoint chunk of the rank's
        # starts one level's uint8 frontier pmax-ed over the site axis and
        # d_s2 psum-ed, then the four outputs gathered over the model axis
        rcfg = registry.get_arch("alibaba-rpq").full()
        plan, c = _rank_count("alibaba-rpq", "serve_queries", layout, m)
        dims = registry.RPQ_SHAPES["serve_queries"].dims
        src = plan.rank.args[0]
        widest = src.numel()
        chunk = max(1, strategies.REFERENCE_CHUNK_BYTES // (strategies._REFERENCE_BYTES_PER_PAIR * widest))
        b_loc = dims["batch"] // M
        n_fix = -(-b_loc // chunk)
        n_states = cells.rpq_automaton(rcfg).n_states
        per_fix = [min(chunk, b_loc - i * chunk) for i in range(n_fix)]
        assert _kinds(c) == {
            "all-reduce": (1 + 2 * n_fix, 8 + sum(b * n_states * dims["n_nodes"] + b * 4 for b in per_fix)),
            "all-gather": (4, dims["batch"] * (dims["n_nodes"] + 4 + 4 + 4)),
        }


# ---------------------------------------------------------------------------
# (c) a mesh of one rank
# ---------------------------------------------------------------------------

ONE_RANK_CELLS = [("dlrm-mlperf", "serve_p99"), ("dlrm-mlperf", "train_batch"), ("gcn-cora", "full_graph_sm"),
                  ("schnet", "molecule"), ("qwen3-14b", "decode_32k"), ("alibaba-rpq", "serve_queries")]


def test_one_rank_mesh_is_the_one_card_program(monkeypatch):
    """On a (1, 1) mesh every collective runs over a one-rank group and
    adds no logical byte, and the rank's FLOPs are the one-card
    program's.  With the collectives taken out (identities), its HBM bytes
    are the one-card program's too, but DLRM's: a rank masks its lookups
    to its row shard even when it holds every row (two compares, an and,
    a re-base: 21 bytes a lookup of each sharded table)."""
    layout = mesh.MeshLayout(("data", "model"), (1, 1))
    ident = {"psum": lambda x, axes, mesh=None: x, "pmax": lambda x, axes, mesh=None: x.detach(),
             "gather_rows": lambda x, axes, n, mesh=None, dim=0: x,
             "all_gather": lambda x, axes, dim=0, mesh=None: x,
             "psum_scatter": lambda x, axes, dim=0, mesh=None: x, "all_to_all": lambda x, axes, mesh=None: x}
    with mesh.fake_mesh(layout) as m:
        for arch, shape in ONE_RANK_CELLS:
            plan = cells.build_cell(arch, shape, layout, m)
            one = analysis.count_step(plan.fn, plan.args)
            rank = analysis.count_step(plan.rank.fn, plan.rank.args)
            assert rank.flops == one.flops, (arch, shape)
            assert rank.argument_bytes == one.argument_bytes, (arch, shape)
            assert rank.wire and all(w["one_rank_calls"] == w["calls"] for w in rank.wire.values()), (arch, shape)
            assert rank.collective_bytes == 0 and rank.roofline().collective_s == 0.0
            assert all(c["calls"] == 0 for c in rank.collectives.values())
            with monkeypatch.context() as p:
                for name, fn in ident.items():
                    p.setattr(collectives, name, fn)
                p.setattr(gnn, "edge_psum", lambda x, rules, op=None: x)
                bare = analysis.count_step(plan.rank.fn, plan.rank.args)
            assert not bare.wire and bare.flops == one.flops
            extra = 0
            if arch == "dlrm-mlperf":
                cfg = registry.get_arch(arch).full()
                batch = plan.args[-1]["dense"].shape[0]
                extra = cfg.table_modes(1, batch).count("shard") * 21 * batch * cfg.multi_hot
            assert bare.bytes - one.bytes == extra, (arch, shape)


# ---------------------------------------------------------------------------
# (e) the kernels' custom ops
# ---------------------------------------------------------------------------


def _b6_args(dtype=torch.float32):
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 30, 50).astype(np.int32))
    bags = torch.from_numpy(np.sort(rng.integers(0, 12, 50)).astype(np.int32))
    return table, idx, bags, 12


def _b7_args(seq=128, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 64, generator=g).to(dtype)
    k = torch.randn(2, seq, 2, 64, generator=g).to(dtype)
    v = torch.randn(2, seq, 2, 64, generator=g).to(dtype)
    return q, k, v, torch.tensor(seq - 9, dtype=torch.int32)


def test_custom_ops_opcheck():
    table, idx, bags, n_bags = _b6_args()
    torch.library.opcheck(torch.ops.repro_torch.embedding_bag_sorted.default,
                          (table.requires_grad_(), idx, bags, n_bags))
    q, k, v, kv_len = _b7_args()
    torch.library.opcheck(torch.ops.repro_torch.flash_decode_gqa.default, (q, k, v, kv_len, 64))
    torch.library.opcheck(torch.ops.repro_torch.flash_decode_gqa_partials.default, (q, k, v, kv_len, 64, 64))
    part = decode_attn.flash_decode_gqa_partials(q, k, v, kv_len, 64, block_kv=64)
    torch.library.opcheck(torch.ops.repro_torch.flash_decode_combine.default,
                          (part.buf, *part.shape, torch.bfloat16))


@pytest.mark.parametrize("dev", ["meta", "cpu"])
def test_custom_ops_counted_once_by_formula(dev):
    """Each op a dispatch mode sees is one call, charged its work formula
    and never the plain version's ops."""
    table, idx, bags, n_bags = (t.to(dev) if isinstance(t, torch.Tensor) else t for t in _b6_args(torch.bfloat16))
    c = analysis.count_step(lambda *a: embedbag.embedding_bag_sorted(*a, n_bags), (table, idx, bags))
    flops, nbytes, n, _ = embedbag.bag_work(table, idx, bags, n_bags)
    assert c.kernels == [("embedding_bag_sorted", flops, nbytes, n)] and (c.flops, c.bytes) == (flops, nbytes)

    q, k, v, kv_len = _b7_args(dtype=torch.bfloat16)
    q, k, v = (t.to(dev) for t in (q, k, v))

    def shard(q, k, v):
        part = decode_attn.flash_decode_gqa_partials(q, k, v, kv_len, 64, block_kv=64)
        return decode_attn.flash_decode_combine(part, q.dtype)

    c = analysis.count_step(shard, (q, k, v))
    p = decode_attn.partials_work(q, k, v, kv_len, 64, 64)
    n_split = decode_attn.partial_splits(q, k)
    b = decode_attn.combine_work(torch.empty(2 * 8 * n_split * 66, device="meta"), 2, 2, n_split, 4, 64,
                                 torch.bfloat16)
    assert c.kernels == [("flash_decode_gqa_partials", p[0], p[1], p[2]),
                         ("flash_decode_combine", b[0], b[1], b[2])]
    assert c.flops == p[0] + b[0] and c.tensor_core_flops == p[0]
    assert c.bytes == p[1] + b[1]
    assert p[2] == kv_len.item() - 64  # the shard's positions below kv_len


def test_b6_op_gradient_is_b6_on_the_transpose():
    """The op's registered backward: B6 again, on the lookups sorted by
    row (a caller's ``transpose`` where ``embedding_bag_sorted_grad`` is
    given one), the table's dense gradient."""
    table, idx, bags, n_bags = _b6_args()
    g = torch.randn(n_bags, table.shape[1], generator=torch.Generator().manual_seed(1))
    want = torch.zeros_like(table).index_add_(0, idx.long(), g[bags.long()])
    t = table.clone().requires_grad_()
    embedbag.embedding_bag_sorted(t, idx, bags, n_bags).backward(g)
    assert torch.allclose(t.grad, want, atol=1e-6)
    calls = []
    t2 = table.clone().requires_grad_()

    def transpose():
        calls.append(1)
        return embedbag.transpose_lookups(idx, bags)

    c = analysis.count_step(lambda t: embedbag.embedding_bag_sorted_grad(t, idx, bags, n_bags, transpose), (t2,))
    c.output.backward(g)
    assert calls == [1] and torch.equal(t2.grad, t.grad)
    assert [k[0] for k in c.kernels] == ["embedding_bag_sorted"]


@pytest.mark.parametrize("case", ["frozen table", "no_grad", "records"])
def test_b6_records_a_gradient_only_where_one_is_needed(case):
    """A call with a table that needs no gradient, or under ``no_grad``,
    dispatches below autograd and records nothing; a call that records
    gets the op's backward.  Each gives the plain version's sums and is
    counted once."""
    table, idx, bags, n_bags = _b6_args()
    t = table.clone().requires_grad_(case != "frozen table")
    with torch.set_grad_enabled(case != "no_grad"):
        c = analysis.count_step(lambda t: embedbag.embedding_bag_sorted(t, idx, bags, n_bags), (t,))
    assert torch.equal(c.output.detach(), embedbag.embedding_bag_sorted_plain(table, idx, bags, n_bags))
    assert (c.output.grad_fn is not None) == (case == "records")
    assert [k[0] for k in c.kernels] == ["embedding_bag_sorted"]


def test_count_refuses_a_c10d_op_it_does_not_count():
    """The port's collectives ride on ``all_reduce``; another c10d op
    would be charged as HBM traffic, so the count raises on it."""
    with mesh.fake_mesh(mesh.MeshLayout(("data", "model"), (2, 2))):
        x = torch.empty(8, device="meta")
        assert analysis.count_step(lambda x: dist.all_reduce(x) or x, (x,)).wire["allreduce_"]["calls"] == 1
        with pytest.raises(NotImplementedError, match="broadcast_"):
            analysis.count_step(lambda x: dist.broadcast(x, 0) or x, (x,))


# ---------------------------------------------------------------------------
# (f) the two-pod layout
# ---------------------------------------------------------------------------

MULTI_CELLS = [("dlrm-mlperf", "serve_bulk"), ("qwen3-14b", "long_500k"), ("gcn-cora", "ogb_products"),
               ("alibaba-rpq", "serve_queries")]


@pytest.mark.parametrize("arch, shape", MULTI_CELLS)
def test_multi_pod_cell_completes(arch, shape):
    stats = dryrun.run_cell(arch, shape, True, {}, verbose=False)
    assert stats["meta"]["n_devices"] == 512
    coll, roof = stats["collectives"], stats["roofline"]
    assert coll is not None and coll["n_ops"] > 0 and coll["bytes"] > 0
    assert roof["collective_s"] == coll["bytes"] / analysis.LINK_BW
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    assert stats["cost"]["flops"] > 0 or arch == "alibaba-rpq"
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (d) repro's kinds: its compiled HLO on 8 forced host devices
# ---------------------------------------------------------------------------

REPRO_HLO = textwrap.dedent(
    """
    import json, os, re, sys, types
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.configs import dlrm_mlperf, gnn_common, registry
    from repro.dist import compat
    from repro.dist import sharding as shd
    from repro.launch.analysis import _SHAPE_RE, _shape_bytes, collective_bytes
    from repro.models import dlrm, gnn
    from repro.training import optimizer as opt_lib

    mesh = compat.make_mesh((4, 2), ("data", "model"))
    rules = shd.Rules.from_mesh(mesh)
    dlrm.embedding_placement = lambda rows, *a, **k: types.SimpleNamespace(
        mode="shard" if rows > SHARD_ABOVE_ROWS else "replicate")
    op_re = re.compile(r"= (\\(?[^=]*?\\)?) (all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
                       r"(?:-start)?\\(")
    group_re = re.compile(r"replica_groups=(?:\\{\\{([0-9,]*)\\}|\\[[0-9]+,([0-9]+)\\])")

    def ops(text):
        # (kind, bytes, group size) of each element of each collective
        out = []
        for line in text.splitlines():
            m = op_re.search(line)
            if not m:
                continue
            g = group_re.search(line)
            size = 0 if g is None else int(g.group(2)) if g.group(2) else len(g.group(1).split(","))
            out += [(m.group(2), _shape_bytes(d, s), size) for d, s in _SHAPE_RE.findall(m.group(1))]
        return out

    res = {}
    with shd.use_mesh(mesh):
        cfg = dlrm_mlperf.smoke()
        text = jax.jit(dlrm.make_serve_step(cfg, rules)).lower(
            dlrm.init_params(cfg, jax.random.PRNGKey(0)), dlrm_mlperf.smoke_batch(cfg, "serve")).compile().as_text()
        res["dlrm_serve"] = {"kinds": collective_bytes(text), "ops": ops(text)}
        gcfg = registry.get_arch("gcn-cora").smoke()
        params = gnn.INIT_FNS["gcn-cora"](gcfg, jax.random.PRNGKey(0))
        state = opt_lib.get(gcfg.optimizer).init(params)
        text = jax.jit(gnn.make_gnn_train_step(gcfg, rules)).lower(
            params, state, gnn_common.gnn_smoke_batch(True)).compile().as_text()
        res["gcn_train"] = {"kinds": collective_bytes(text), "ops": ops(text)}
    with open(sys.argv[1], "w") as f:
        json.dump(res, f)
    """
).replace("SHARD_ABOVE_ROWS", str(SHARD_ABOVE_ROWS))
CHILD_ENV = {**{k: os.environ[k] for k in ("HOME", "PATH", "TMPDIR") if k in os.environ},
             "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}


def _port_notes(monkeypatch) -> dict:
    """The port's DLRM serve and GCN train steps (the smoke configs and
    batches) on a (4, 2) fake mesh as rank 0: every collective it notes
    as (kind, logical bytes, ranks), and its record."""
    notes, out = [], {}
    real_note = collectives._note
    monkeypatch.setattr(collectives, "_note", lambda kind, b, w, n: (notes.append((kind, b, n)),
                                                                      real_note(kind, b, w, n)))
    monkeypatch.setattr(dlrm, "embedding_placement", lambda rows, *a, **k: types.SimpleNamespace(
        mode="shard" if rows > SHARD_ABOVE_ROWS else "replicate"))
    with mesh.fake_mesh(mesh.MeshLayout(("data", "model"), (4, 2))) as m:
        rules = shd.Rules.from_mesh(m)
        cfg = dlrm_mlperf.smoke()
        batch = dlrm_mlperf.smoke_batch(cfg, "serve", device="cpu")
        with shd.use_mesh(m):
            params = dlrm.shard_params(cfg, rules, dlrm.init_params(cfg, seed=0, device="cpu"), 8)
        c = analysis.count_step(cells.on_mesh(m, dlrm.make_serve_step(cfg, rules)), (_meta(params), _meta(batch)))
        out["dlrm_serve"] = (list(notes), c)
        notes.clear()
        gcfg = registry.get_arch("gcn-cora").smoke()
        params = gnn.INIT_FNS["gcn-cora"](gcfg, seed=0, device="cpu")
        with shd.use_mesh(m):
            state = gnn.optimizer_for(gcfg, rules, params).init(params)
            zero = gnn.optimizer_for(gcfg, rules, params).zero_dims
        c = analysis.count_step(cells.on_mesh(m, gnn.make_gnn_train_step(gcfg, rules)),
                                (_meta(params), _meta(state), _meta(gnn_common.gnn_smoke_batch(True, device="cpu"))))
        out["gcn_train"] = (list(notes), c, params, zero)
    return out


def _minus(a: list, b: list) -> list:
    """The multiset ``a`` less ``b``."""
    rest = list(a)
    for x in b:
        rest.remove(x)
    return rest


def test_collective_kinds_against_repro_hlo(tmp_path, monkeypatch):
    """Where the two programs issue the same collective, its kind and
    logical bytes agree; each difference is a design difference that
    ROADMAP §C logs with both numbers:

    * GCN train: every all-reduce the port issues is one of ``repro``'s
      (the degrees' and layers' scatter psums over data, then model; the
      messages' transposes over both axes); ``repro`` also psums each
      layer's scatter cotangent over model and data, whose backward is
      the identity in the port, and the port's ZeRO-1 all-gathers its
      parameters, which this jit (no in_shardings) does not place;
    * DLRM serve: each sharded table's bag psum over the model axis,
      bf16 in the port, an f32 element of that shape in ``repro``'s CPU
      HLO, which also issues collectives the port does not (an
      all-gather and a collective-permute from a scatter-add) and leaves
      its logits sharded where the port gathers them."""
    out = tmp_path / "hlo.json"
    r = subprocess.run([sys.executable, "-c", REPRO_HLO, str(out)], env=CHILD_ENV, capture_output=True,
                       text=True, timeout=240, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    repro = json.loads(out.read_text())
    port = _port_notes(monkeypatch)

    notes, c, params, zero = port["gcn_train"]
    r_ops = [tuple(o) for o in repro["gcn_train"]["ops"]]
    ours = [n for n in notes if n[0] == "all-reduce"]
    extra = _minus([o for o in r_ops if o[0] == "all-reduce"], ours)  # raises if one of ours is not repro's
    n = 24
    widths = [layer["w"].shape[1] for layer in params["layers"]]
    assert sorted(extra) == sorted(("all-reduce", n * w * 4, k) for w in widths for k in (2, 4))
    gathers = [t.numel() * 4 for t, z in zip(analysis.tensor_leaves(params), zero) if z is not None]
    assert sorted(b for k, b, _ in notes if k == "all-gather") == sorted(gathers)
    assert repro["gcn_train"]["kinds"]["all-gather"] == 0
    assert c.collectives["all-reduce"]["bytes"] + sum(b for _, b, _ in extra) == (
        repro["gcn_train"]["kinds"]["all-reduce"])

    notes, c = port["dlrm_serve"]
    cfg = dlrm_mlperf.smoke()
    b_loc = 8 // 4
    n_sharded = sum(rows > SHARD_ABOVE_ROWS for rows in cfg.table_sizes)
    assert sorted(notes) == sorted([("all-reduce", b_loc * cfg.embed_dim * 2, 2)] * n_sharded
                                   + [("all-gather", 8 * 4, 4)])
    r_ops = [tuple(o) for o in repro["dlrm_serve"]["ops"]]
    assert r_ops.count(("all-reduce", b_loc * cfg.embed_dim * 4, 2)) >= n_sharded
    assert ("all-gather", 8 * 4, 4) not in r_ops
