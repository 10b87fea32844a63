"""``repro_torch.launch`` against ``repro.launch``: the cells, their
placements on both production layouts, the roofline and the counted
work.

* Every cell of the port's ``all_cells()`` is ``repro``'s, in order.  One
  subprocess with 512 forced host devices builds ``repro``'s plan of
  every cell on the (16, 16) and (2, 16, 16) meshes (it never lowers);
  each argument leaf's fitted placement, shape and per-device bytes, and
  the plan's ``n_params``, ``n_active``, ``tokens``, ``kind`` and model
  FLOPs must equal the port's.
* ``Roofline`` at the H100's rates; ``count_step`` on a loop-free
  program against its closed form; B6's and B7's meta branches and
  their work formulas; XLA's cost analysis counting a ``while`` body
  once (the rule the port's shape-only fixpoints follow).
* At smoke size, a step on meta tensors against the same step on the
  CPU: output shapes and dtypes equal, FLOPs equal, except GCN's padded
  edges, which the meta run keeps (the difference is exactly the masked
  edges' B6 work).  The MoE step's meta run routes evenly; its expert
  products are linear in the routed rows, so its FLOPs are equal too.
* The CLI: ``--list`` and one cell to a JSON file.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compat
from repro_torch.configs import dlrm_mlperf, gnn_common, lm_common, registry
from repro_torch.core import paa, strategies
from repro_torch.dist import sharding as shd
from repro_torch.graph import generators, partition
from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.embedbag import embedbag
from repro_torch.launch import analysis, cells, dryrun, mesh
from repro_torch.models import dlrm as dlrm_model
from repro_torch.models import gnn, transformer as tr
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 240

pytestmark = pytest.mark.timeout_s(CHILD_TIMEOUT_S + 60)

CHILD = textwrap.dedent(
    """
    import json, math, os, sys, time
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    t0 = time.perf_counter()
    import jax
    from repro.configs import registry
    from repro.launch import analysis
    from repro.launch.cells import build_cell
    from repro.launch.dryrun import all_cells
    from repro.launch.mesh import make_production_mesh

    def entry(e):
        if isinstance(e, tuple):
            return e[0] if len(e) == 1 else list(e)
        return e

    out = {"cells": all_cells(), "plans": {}}
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        for arch, shape in all_cells():
            plan = build_cell(arch, shape, m)
            args, _ = jax.tree_util.tree_flatten_with_path(plan.args)
            shs, _ = jax.tree_util.tree_flatten_with_path(plan.in_shardings)
            assert [jax.tree_util.keystr(p) for p, _ in args] == [jax.tree_util.keystr(p) for p, _ in shs]
            leaves = {}
            for (path, a), (_, sh) in zip(args, shs):
                spec = [entry(e) for e in tuple(sh.spec)]
                spec += [None] * (len(a.shape) - len(spec))
                leaves[jax.tree_util.keystr(path)] = {
                    "shape": list(a.shape), "dtype": str(a.dtype), "itemsize": a.dtype.itemsize,
                    "spec": spec, "bytes": math.prod(sh.shard_shape(a.shape)) * a.dtype.itemsize,
                }
            fam = registry.get_arch(arch).family
            out["plans"][f"{arch}|{shape}|{'multi' if multi else 'single'}"] = {
                "leaves": leaves, "n_params": plan.n_params, "n_active": plan.n_active,
                "tokens": plan.tokens, "kind": plan.kind,
                "model_flops": analysis.model_flops(fam, plan.kind, plan.n_params, plan.n_active, plan.tokens),
            }
    out["seconds"] = time.perf_counter() - t0
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def repro_plans(tmp_path_factory):
    """``repro``'s plan of every cell on both production meshes, built in
    a subprocess with 512 forced host devices."""
    out = tmp_path_factory.mktemp("launch") / "plans.json"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", CHILD, str(out)], env=env, capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    data = json.loads(out.read_text())
    print(f"repro's plans: {len(data['plans'])} builds in {time.perf_counter() - t0:.1f} s "
          f"({data['seconds']:.1f} s inside the child)")
    return data


def _paths(args, placements, prefix=""):
    """(jax keystr path, tensor, placement) of every argument leaf."""
    if isinstance(args, torch.Tensor):
        yield prefix, args, placements
    elif isinstance(args, dict):
        for k in sorted(args):
            yield from _paths(args[k], placements[k], prefix + f"[{k!r}]")
    else:
        for i, (a, p) in enumerate(zip(args, placements)):
            yield from _paths(a, p, prefix + f"[{i}]")


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _dtype_matches(t: torch.Tensor, jax_dtype: str) -> bool:
    if jax_dtype.startswith("key<"):  # a jax key: 8 bytes, an int64 seed in the port
        return t.dtype == torch.int64
    return str(t.dtype).removeprefix("torch.") == jax_dtype


def test_all_cells_equal_repro(repro_plans):
    assert [list(c) for c in dryrun.all_cells()] == repro_plans["cells"]
    assert len(dryrun.all_cells()) == 42


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_placements_equal_repro(repro_plans, multi):
    layout = mesh.make_production_mesh(multi_pod=multi)
    key = "multi" if multi else "single"
    mismatches = []
    for arch, shape in dryrun.all_cells():
        want = repro_plans["plans"][f"{arch}|{shape}|{key}"]
        plan = cells.build_cell(arch, shape, layout)
        got = {p: (t, pl) for p, t, pl in _paths(plan.args, plan.in_placements)}
        assert sorted(got) == sorted(want["leaves"]), (arch, shape)
        total = 0
        for path, w in want["leaves"].items():
            t, pl = got[path]
            total += w["bytes"]
            row = (list(t.shape), t.element_size(), [_entry(e) for e in pl])
            if row != (w["shape"], w["itemsize"], w["spec"]) or not _dtype_matches(t, w["dtype"]):
                mismatches.append((arch, shape, path, row, w))
        assert analysis.argument_bytes(plan, layout) == total, (arch, shape)
        fields = (plan.n_params, plan.n_active, plan.tokens, plan.kind)
        assert fields == (want["n_params"], want["n_active"], want["tokens"], want["kind"]), (arch, shape)
        mf = analysis.model_flops(registry.get_arch(arch).family, plan.kind, plan.n_params,
                                  plan.n_active, plan.tokens)
        assert mf == want["model_flops"], (arch, shape)
    assert mismatches == []


def test_layouts():
    single, multi = mesh.make_production_mesh(), mesh.make_production_mesh(multi_pod=True)
    assert (single.shape, single.size) == ({"data": 16, "model": 16}, 256)
    assert (multi.shape, multi.size) == ({"pod": 2, "data": 16, "model": 16}, 512)
    assert shd.Rules.from_mesh(multi).batch == ("pod", "data")
    small = mesh.make_test_mesh(2, 4)
    assert (small.axis_names, small.shape, small.size) == (("data", "model"), {"data": 2, "model": 4}, 8)
    assert shd.Rules.from_mesh(small).fit(("data", "model"), (5, 8)) == (None, "model")
    with pytest.raises(NotImplementedError):
        with shd.use_mesh(single):
            pass


def test_roofline_terms():
    r = analysis.Roofline(flops_per_device=989e12, hbm_bytes_per_device=3.35e12 / 2, n_devices=256)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 0.5) < 1e-9
    assert r.collective_s is None
    assert r.bottleneck == "compute"
    assert r.bound_s == r.compute_s
    f32 = analysis.Roofline(67e12, 0.0, 1, tensor_core_flops_per_device=0.0)
    assert abs(f32.compute_s - 1.0) < 1e-9
    assert set(r.as_dict()) == {"compute_s", "memory_s", "collective_s", "bottleneck", "bound_s",
                                "overlap_headroom"}


def test_count_step_matches_closed_form_on_loop_free_program():
    """``repro``'s ``test_hlo_flops_match_analytic_on_unrolled_program``
    shapes: two products, exact FLOPs and bytes, on meta and CPU tensors."""
    D, F, B = 256, 512, 64

    def f(x, w1, w2):
        return ((x @ w1) @ w2).sum()

    for dev in ("meta", "cpu"):
        args = (torch.ones(B, D, device=dev), torch.ones(D, F, device=dev), torch.ones(F, D, device=dev))
        c = analysis.count_step(f, args)
        assert c.flops == 2 * B * D * F * 2
        assert c.tensor_core_flops == 0
        assert c.bytes == 4 * ((B * D + D * F + B * F) + (B * F + F * D + B * D) + (B * D + 1))
        assert c.argument_bytes == 4 * (B * D + D * F + F * D)
        assert c.peak_bytes >= 4 * (B * F + B * D)


@pytest.mark.parametrize("dev", ["meta", "cpu"])
def test_gathers_and_indexed_writes_count_the_rows_they_touch(dev):
    """A gather reads the rows it selects, not its whole source; an
    indexed write in place moves its indices and values (and reads as
    many destination rows where it accumulates), not the destination."""
    rows, d, n = 1000, 64, 8
    table = torch.ones(rows, d, device=dev)
    idx = torch.arange(n, device=dev)
    out_bytes, idx_bytes = n * d * 4, n * 8
    for f in (lambda t, i: t[i], lambda t, i: torch.nn.functional.embedding(i, t),
              lambda t, i: t.index_select(0, i)):
        assert analysis.count_step(f, (table, idx)).bytes == idx_bytes + 2 * out_bytes
    g = idx[:, None].expand(n, d).contiguous()
    assert analysis.count_step(lambda t, i: t.gather(0, i), (table, g)).bytes == n * d * 8 + 2 * out_bytes
    vals = torch.ones(n, d, device=dev)

    def put(t, i, v, accumulate):
        return t.index_put_((i,), v, accumulate=accumulate)

    for accumulate in (False, True):
        c = analysis.count_step(lambda *a: put(*a, accumulate), (table, idx, vals))
        assert c.bytes == idx_bytes + out_bytes * (3 if accumulate else 2)
    assert analysis.count_step(lambda t, i, v: t.index_copy_(0, i, v), (table, idx, vals)).bytes == (
        idx_bytes + 2 * out_bytes)
    assert analysis.count_step(lambda t, i, v: t.index_add_(0, i, v), (table, idx, vals)).bytes == (
        idx_bytes + 3 * out_bytes)


def test_xla_counts_a_while_body_once():
    """XLA's cost analysis of a ``while`` counts its body once, whatever
    the trip count: so do the port's shape-only fixpoints."""
    D = 128

    def f(x, w):
        return jax.lax.while_loop(lambda c: c[1] < 10, lambda c: (c[0] @ w, c[1] + 1), (x, 0))[0]

    s = jax.ShapeDtypeStruct((D, D), jnp.float32)
    flops = compat.cost_analysis_dict(jax.jit(f).lower(s, s).compile())["flops"]
    one = 2 * D**3
    assert one <= flops < 2 * one


def test_b6_meta_branch_and_work():
    n, rows, d, n_bags = 100, 50, 16, 30
    table = torch.empty(rows, d, dtype=torch.bfloat16, device="meta")
    idx = torch.empty(n, dtype=torch.int32, device="meta")
    before = embedbag.LAUNCHES
    c = analysis.count_step(lambda t, i, b: embedbag.embedding_bag_sorted(t, i, b, n_bags), (table, idx, idx))
    assert (c.output.shape, c.output.dtype, c.output.device.type) == ((n_bags, d), torch.bfloat16, "meta")
    assert c.kernels == [("embedding_bag_sorted", n * d, (n + n_bags) * d * 2, n)]
    assert (c.flops, c.bytes, c.tensor_core_flops) == (n * d, (n + n_bags) * d * 2, 0)
    assert embedbag.LAUNCHES == before
    with pytest.raises(TypeError):
        embedbag.embedding_bag_sorted(table, idx.long(), idx, n_bags)
    # on the CPU the same call counts the same work, the plain version's ops hidden
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
    i = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32))
    b = torch.from_numpy(np.sort(rng.integers(0, n_bags, n)).astype(np.int32))
    cc = analysis.count_step(lambda *a: embedbag.embedding_bag_sorted(*a, n_bags), (t, i, b))
    assert (cc.flops, cc.bytes) == (n * d, (n + n_bags) * d * 4)


def test_b7_meta_branch_and_work():
    b, h, g, s, dh = 2, 8, 2, 1024, 64
    q = torch.empty(b, h, dh, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, s, g, dh, dtype=torch.bfloat16, device="meta")
    kv_len = torch.tensor(700, dtype=torch.int32)
    before = decode_attn.LAUNCHES
    c = analysis.count_step(lambda *a: decode_attn.flash_decode_gqa(*a), (q, k, k, kv_len))
    assert (c.output.shape, c.output.dtype, c.output.device.type) == ((b, h, dh), torch.bfloat16, "meta")
    flops = 4 * b * h * 700 * dh
    nbytes = (2 * b * 700 * g * dh + 2 * b * h * dh) * 2
    assert c.kernels == [("flash_decode_gqa", flops, nbytes, 700)]
    assert (c.flops, c.tensor_core_flops, c.bytes) == (flops, flops, nbytes)
    assert decode_attn.LAUNCHES == before
    with pytest.raises(TypeError):
        decode_attn.flash_decode_gqa(q, k, k, kv_len.long())
    with pytest.raises(ValueError):
        analysis.count_step(decode_attn.flash_decode_gqa, (q, k, k, kv_len.to("meta")))


def _meta(tree):
    return tree_map(lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t, tree)


def _same_shapes(a, b):
    la, lb = analysis.tensor_leaves(a), analysis.tensor_leaves(b)
    return [(tuple(t.shape), t.dtype) for t in la] == [(tuple(t.shape), t.dtype) for t in lb]


def _meta_and_cpu(fn_of, args):
    """count_step of a step on meta twins of ``args``, then on ``args``
    (each step from ``fn_of()``: steps update state in place)."""
    meta = analysis.count_step(fn_of(), _meta(args))
    cpu = analysis.count_step(fn_of(), args)
    return meta, cpu


@pytest.fixture
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_meta_lm_decode_equals_cpu(threads):
    cfg = lm_common.lm_smoke("qwen3-14b")
    rules = shd.Rules.from_mesh(None)
    params = tr.init_params(cfg, seed=0, device="cpu")
    batch = lm_common.lm_smoke_batch(cfg, "decode", device="cpu")
    args = (params, batch["cache"], batch["tokens"])
    meta_args = (_meta(params), dict(_meta(batch["cache"]), len=batch["cache"]["len"].clone()),
                 _meta(batch["tokens"]))
    meta = analysis.count_step(tr.make_decode_step(cfg, rules), meta_args)
    cpu = analysis.count_step(tr.make_decode_step(cfg, rules), args)
    assert _same_shapes(meta.output, cpu.output)
    assert meta.flops == cpu.flops > 0
    assert [k[0] for k in meta.kernels] == ["flash_decode_gqa"] * cfg.n_layers
    assert meta.kernels == cpu.kernels
    assert meta.argument_bytes == cpu.argument_bytes


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_meta_lm_train_step_equals_cpu(threads, moe):
    cfg = lm_common.lm_smoke("granite-moe-1b-a400m" if moe else "qwen3-14b", moe=moe)
    rules = shd.Rules.from_mesh(None)
    params = tr.init_params(cfg, seed=0, device="cpu")
    state = opt_lib.get(cfg.optimizer).init(params)
    batch = lm_common.lm_smoke_batch(cfg, "train", device="cpu")
    meta, cpu = _meta_and_cpu(lambda: tr.make_train_step(cfg, rules), (params, state, batch))
    assert _same_shapes(meta.output, cpu.output)
    assert meta.flops == cpu.flops > 0  # MoE: the balanced routing moves no FLOP (linear in rows)
    assert meta.argument_bytes == cpu.argument_bytes


def test_meta_cache_changes_no_count(threads, monkeypatch):
    """The meta-result cache answers repeated ops; with it turned off the
    counts and the outputs' layouts are the same."""
    cfg = lm_common.lm_smoke("qwen3-14b")
    rules = shd.Rules.from_mesh(None)
    params = tr.param_shapes(cfg)
    batch = _meta(lm_common.lm_smoke_batch(cfg, "train", device="cpu"))

    def run():
        state = opt_lib.get(cfg.optimizer).init(params)
        c = analysis.count_step(tr.make_train_step(cfg, rules), (params, state, batch))
        return (c.flops, c.tensor_core_flops, c.bytes, c.peak_bytes,
                [(t.shape, t.stride(), t.dtype) for t in analysis.tensor_leaves(c.output)])

    cached = run()
    monkeypatch.setattr(analysis, "_cacheable", lambda func: False)
    assert run() == cached


def test_meta_dlrm_serve_equals_cpu(threads):
    cfg = dlrm_mlperf.smoke()
    rules = shd.Rules.from_mesh(None)
    params = dlrm_model.init_params(cfg, seed=0, device="cpu")
    batch = dlrm_mlperf.smoke_batch(cfg, "serve", device="cpu")
    meta, cpu = _meta_and_cpu(lambda: dlrm_model.make_serve_step(cfg, rules), (params, batch))
    assert _same_shapes(meta.output, cpu.output)
    assert meta.flops == cpu.flops > 0
    assert meta.kernels == cpu.kernels and len(meta.kernels) == cfg.n_sparse
    assert dlrm_model.param_shapes(cfg).keys() == params.keys()
    assert [(t.shape, t.dtype) for t in leaves(dlrm_model.param_shapes(cfg))] == [
        (t.shape, t.dtype) for t in leaves(params)]


def test_meta_gcn_train_keeps_padded_edges(threads):
    """The meta run keeps every padded edge; the CPU run drops the masked
    ones.  The FLOPs differ by exactly the masked edges' B6 work."""
    cfg = gnn.GCNConfig(d_feat=8, n_classes=4)
    rules = shd.Rules.from_mesh(None)
    params = gnn.gcn_init(cfg, seed=0, device="cpu")
    batch = gnn_common.gnn_smoke_batch(True, device="cpu")
    batch["edge_mask"][::5] = False
    masked = int((~batch["edge_mask"]).sum())
    state = opt_lib.get(cfg.optimizer).init(params)
    meta, cpu = _meta_and_cpu(lambda: gnn.make_gnn_train_step(cfg, rules), (params, state, batch))
    assert _same_shapes(meta.output, cpu.output)
    assert len(meta.kernels) == len(cpu.kernels)
    extra = 0
    for (name, fm, _, nm), (_, fc, _, nc) in zip(meta.kernels, cpu.kernels):
        if nm != nc:
            assert nm - nc == masked and fm - fc == masked * (fm // nm)
            extra += fm - fc
    assert extra > 0
    assert meta.flops - cpu.flops == extra


def test_meta_reference_executor_takes_one_level():
    g = generators.random_labeled_graph(40, 160, 3, seed=3)
    placement = partition.distribute(g, n_sites=4, replication_rate=0.3, seed=3)
    ca = paa.compile_query("l0 (l1|l2)* l0", g)
    arrays = strategies.stage_site_arrays(placement, device="cpu")
    fn = strategies.make_s2_step_fn(ca, g.n_nodes, 16, backend="reference")
    starts = torch.arange(0, 40, 5, dtype=torch.int32)
    cpu = fn(starts, arrays)
    levels0 = strategies.fops.FIXPOINT_COUNTERS["levels"]
    meta = fn(starts.to("meta"), _meta(arrays))
    assert strategies.fops.FIXPOINT_COUNTERS["levels"] - levels0 == 1
    assert _same_shapes(meta, cpu)


def test_param_shapes_equal_init():
    for moe in (False, True):
        cfg = lm_common.lm_smoke("x", moe=moe)
        got = [(p, t.shape, t.dtype) for p, t, _ in _paths(tr.param_shapes(cfg), tr.param_shapes(cfg))]
        want = [(p, t.shape, t.dtype) for p, t, _ in _paths(tr.init_params(cfg, device="cpu"),
                                                             tr.init_params(cfg, device="cpu"))]
        assert got == want


def test_cli_list_and_one_cell(tmp_path, monkeypatch, capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--list"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines() == [f"{a} × {s}" for a, s in dryrun.all_cells()]
    out = tmp_path / "dry.json"
    monkeypatch.setattr(sys, "argv", ["dryrun", "--mesh", "both", "--arch", "alibaba-rpq",
                                      "--shape", "estimate", "--out", str(out)])
    dryrun.main()
    assert "2 ok, 0 failed" in capsys.readouterr().out
    res = json.loads(out.read_text())
    assert set(res) == {"fields", "alibaba-rpq|estimate|single", "alibaba-rpq|estimate|multi"}
    for key, n_dev in (("alibaba-rpq|estimate|single", 256), ("alibaba-rpq|estimate|multi", 512)):
        r = res[key]
        assert r["ok"] is True
        assert set(r) == {"ok", "memory", "cost", "collectives", "roofline", "model_flops",
                          "useful_flops_ratio", "times", "meta"}
        assert set(r["memory"]) == {"argument_bytes", "output_bytes", "program_peak_bytes"}
        assert r["meta"]["n_devices"] == n_dev and r["collectives"] is None
        assert r["roofline"]["collective_s"] is None
        layout = mesh.make_production_mesh(multi_pod=n_dev == 512)
        plan = cells.build_cell("alibaba-rpq", "estimate", layout)
        n = plan.args[0].shape[0]
        assert r["memory"]["argument_bytes"] == analysis.argument_bytes(plan, layout) == (
            4 * (n * n + n) + 8192 * 8 // n_dev)
    assert res["fields"] == analysis.FIELDS
