"""Training over ``gloo`` ranks on the CPU: the collectives' gradients,
the train steps per rank with ZeRO-1 AdamW and Adafactor over a leaf's
shards, ``equiformer_energy_big``'s gradient, ``compressed_psum``, and
checkpoints saved and restored on other layouts.

One spawn of 4 ``gloo`` ranks runs every case on (2, 1) (ranks 0 and
1), (4, 1), (2, 2) and (1, 4) ``(data, model)`` meshes; one ``repro``
subprocess runs its jitted train steps on the same mesh shapes of 8
forced host devices beside it.  Inputs are drawn once here with numpy
(the weights by the port's inits, carried as numpy) and handed to both.

What is held, per model (DLRM with its two larger tables row-sharded,
GCN, SchNet, NequIP, EquiformerV2, a dense LM with two microbatches,
granite-style expert parallelism at a capacity that drops nothing, and
kimi-style ``fsdp_experts`` with Adafactor):

* each rank's reduced gradient blocks, gathered whole, against the
  port's one-card step: f32 1e-5 of a leaf's largest |value|
  (EquiformerV2 1e-4), bf16 2e-2; the loss likewise;
* the updated parameters and the optimizer state, gathered whole,
  against the one-card optimizer applied to that gathered gradient:
  AdamW bit for bit (it works element by element, ZeRO or not),
  Adafactor 1e-6 of a leaf's largest (its means sum the shards in
  another order);
* against ``repro``: the loss, AdamW's moments (``m`` is 0.1 × the
  gradient, ``v`` 0.05 × its square) or Adafactor's factors, and the
  parameters; AdamW's first step moves a parameter by ``lr × sign``, so
  a parameter is held where its gradient is more than 1e-3 of its
  leaf's largest (a smaller one may flip its sign in rounding).  The
  granite-style case at capacity 1.25, whose drops the one-card step
  cannot reference, is held to ``repro`` alone.

Tolerances as the largest |difference| over the largest |value|.
"""

import dataclasses
import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap
import types

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import interop
from repro_torch.configs import dlrm_mlperf, gnn_common, kimi_k2_1t_a32b, registry
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.launch import ranks
from repro_torch.models import dlrm, gnn, layers
from repro_torch.models import transformer as tr
from repro_torch.training import checkpoint, compression, loop
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, leaves_with_paths, value_and_grad

torch.set_num_threads(1)

SHAPES = [(2, 1), (4, 1), (2, 2), (1, 4)]
WORLD = 4
SPAWN_TIMEOUT_S = 300
GNN_ARCHS = ["gcn-cora", "schnet", "nequip", "equiformer-v2"]
LMS = {"dense": "qwen3-14b", "granite": "granite-moe-1b-a400m", "kimi": "kimi-k2-1t-a32b"}
MODELS = ["dlrm"] + GNN_ARCHS + list(LMS)
CAP_NO_DROP, CAP_DROP = 4.0, 1.25
LM_BATCH, LM_SEQ, DLRM_BATCH = 4, 16, 8
SHARD_ABOVE_ROWS = 40
BIG_NODES, BIG_EDGES, BIG_CHUNK, BIG_TOL = 64, 64, 8, 2e-2
COMPRESS_STEPS, COMPRESS_LEN = 3, 40
LOOP_STEPS, LOOP_EVERY, LOOP_CRASH = 4, 2, 3
TOL_F32, TOL_EQ, TOL_BF16 = 1e-5, 1e-4, 2e-2
FLOOR = 1e-3
ADAM_B1, ADAM_B2 = 0.9, 0.95  # opt_lib.adamw's and repro's defaults


# ---------------------------------------------------------------------------
# inputs, drawn once
# ---------------------------------------------------------------------------


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: the optimizers update in place."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v) for v in tree]
    return _numpy(tree)


def _t(a) -> torch.Tensor:
    return interop._tensor(a, torch.device("cpu"))


def _lm_cfg(key: str):
    cfg = registry.get_arch(LMS["granite" if key == "granite_drop" else key]).smoke()
    if key == "dense":
        cfg = dataclasses.replace(cfg, microbatches=2)
    if key == "kimi":
        cfg = dataclasses.replace(cfg, fsdp_experts=True, optimizer="adafactor",
                                  sharding_overrides=kimi_k2_1t_a32b.SHARDING_OVERRIDES)
    return cfg


def _dlrm_cfg(f32_tables: bool = False):
    cfg = dlrm_mlperf.smoke()
    return dataclasses.replace(cfg, table_dtype=torch.float32) if f32_tables else cfg


def _dlrm_batch(rng, cfg) -> dict:
    sizes = np.asarray(cfg.table_sizes)
    return {"dense": rng.normal(size=(DLRM_BATCH, cfg.n_dense)).astype(np.float32),
            "sparse": (rng.random((DLRM_BATCH, cfg.n_sparse, cfg.multi_hot)) * sizes[None, :, None]).astype(np.int32),
            "labels": (rng.random(DLRM_BATCH) < 0.5).astype(np.float32)}


def _inputs() -> dict:
    rng = np.random.default_rng(29)
    cases = {}
    cfg = _dlrm_cfg()
    cases["dlrm"] = {"params": _tree(dlrm.init_params(cfg, seed=1, device="cpu")), "batch": _dlrm_batch(rng, cfg)}
    for arch in GNN_ARCHS:
        batch = {k: v.numpy() for k, v in gnn_common.gnn_smoke_batch(arch == "gcn-cora", seed=3, device="cpu").items()}
        batch["edge_mask"] = batch["edge_mask"] & (np.arange(batch["edge_mask"].shape[0]) % 5 != 2)
        cfg = registry.get_arch(arch).smoke()
        cases[arch] = {"params": _tree(gnn.INIT_FNS[arch](cfg, seed=2, device="cpu")), "batch": batch}
    for key in list(LMS) + ["granite_drop"]:
        cfg = _lm_cfg(key)
        params = _tree(tr.init_params(cfg, seed=4, device="cpu"))
        if key == "granite_drop":
            # tokens that share a direction experts 0 and 1 favour: capacity
            # 1.25 drops assignments at every shape
            common = rng.normal(size=cfg.d_model).astype(np.float32)
            params["embed"] = (params["embed"] + 3.0 * common).astype(np.float32)
            params["layers"]["moe"]["router"][:, :, :2] += (4.0 * common / np.linalg.norm(common))[None, :, None]
        tokens = rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1)).astype(np.int32)
        cases[key] = {"params": params, "batch": {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}}
    ecfg = registry.get_arch("equiformer-v2").smoke()
    n, e = BIG_NODES, BIG_EDGES
    big = {"species": rng.integers(0, ecfg.n_species, n).astype(np.int32),
           "positions": (rng.random((n, 3)) * 4.0).astype(np.float32),
           "node_mask": np.arange(n) < n - 3,
           "edge_src": rng.integers(0, n, e).astype(np.int32),
           "edge_dst": rng.integers(0, n, e).astype(np.int32),
           "edge_mask": np.arange(e) % 7 != 3}
    cfg = _dlrm_cfg(f32_tables=True)
    return {"cases": cases, "big": big, "big_params": _tree(gnn.equiformer_init(ecfg, seed=5, device="cpu")),
            "compress": rng.normal(size=(COMPRESS_STEPS, WORLD, COMPRESS_LEN)).astype(np.float32),
            "loop": {"params": _tree(dlrm.init_params(cfg, seed=6, device="cpu")),
                     "batches": [_dlrm_batch(rng, cfg) for _ in range(LOOP_STEPS)]}}


def _rows_rule(module):
    """Shard the tables of more than SHARD_ABOVE_ROWS rows (``module``'s
    ``embedding_placement``, which its ``table_modes`` reads)."""
    module.embedding_placement = lambda rows, *a, **k: types.SimpleNamespace(
        mode="shard" if rows > SHARD_ABOVE_ROWS else "replicate")


# ---------------------------------------------------------------------------
# a train step, per rank or on one card
# ---------------------------------------------------------------------------


def _recording_get(real_get, box: list):
    """``opt_lib.get`` whose optimizers record the gradients their update
    is handed (on a rank: its reduced blocks)."""
    def get(name, lr=3e-4):
        inner = real_get(name, lr)

        def update(params, grads, state, **kw):
            box.append([g.detach().clone() for g in leaves(grads)])
            return inner.update(params, grads, state, **kw)

        return opt_lib.Optimizer(inner.init, update, inner.state_spec)

    return get


def _setup(key: str, case: dict, mesh):
    """(rank params, train step, optimizer, batch, held placements) of
    ``key`` on the installed ``mesh`` (``None``: one card)."""
    if key == "dlrm":
        cfg = _dlrm_cfg()
        rules = shd.Rules.from_mesh(mesh)
        params = dlrm.shard_params(cfg, rules, interop.dlrm_params_from_numpy(case["params"], "cpu"), DLRM_BATCH)
        held = dlrm.held_placements(cfg, rules, DLRM_BATCH)
        return (params, dlrm.make_train_step(cfg, rules), dlrm.optimizer_for(cfg, rules, params, DLRM_BATCH),
                {k: _t(v) for k, v in case["batch"].items()}, held)
    if key in GNN_ARCHS:
        cfg = registry.get_arch(key).smoke()
        rules = shd.Rules.from_mesh(mesh)
        params = interop.gnn_params_from_numpy(case["params"], "cpu")
        return (params, gnn.make_gnn_train_step(cfg, rules), gnn.optimizer_for(cfg, rules, params),
                {k: _t(v) for k, v in case["batch"].items()}, gnn.held_placements(params))
    cfg = _lm_cfg(key)
    rules = tr.rules_for(cfg, mesh)
    params = tr.shard_params(cfg, rules, interop.lm_params_from_numpy(case["params"], "cpu"))
    return (params, tr.make_train_step(cfg, rules), tr.optimizer_for(cfg, rules, params),
            {k: _t(v) for k, v in case["batch"].items()}, tr.held_placements(cfg, rules))


def _whole(tree_leaves, places, mesh) -> list:
    """Each leaf gathered whole from the ranks' blocks (as numpy)."""
    if mesh is None:
        return [_numpy(t) for t in tree_leaves]
    return [_numpy(collectives.assemble_leaf(t, p, mesh)) for t, p in zip(tree_leaves, places)]


def _train_case(key: str, case: dict, mesh) -> dict:
    """One train step of ``key``: the loss, the gradient the optimizer was
    handed, the parameters and the state before and after, each gathered
    whole; on a rank also its state blocks' shapes and ZeRO dims."""
    box: list = []
    real_get, real_moe = opt_lib.get, layers.apply_moe
    opt_lib.get = _recording_get(real_get, box)
    cap = CAP_DROP if key == "granite_drop" else CAP_NO_DROP
    layers.apply_moe = functools.partial(real_moe, capacity_factor=cap)
    try:
        with shd.use_mesh(mesh):
            params, step, opt, batch, held = _setup("granite" if key == "granite_drop" else key, case, mesh)
            state = opt.init(params)
            if mesh is None:
                p_place = g_place = s_place = [None] * len(leaves(params))
            else:
                p_place = shd.placement_leaves(held)
                s_place = [p for p in shd.placement_leaves(opt.state_placements(state)) if p != ()]
                g_place = s_place[: len(p_place)] if opt.name == "adamw" else p_place
            before = _whole(leaves(params), p_place, mesh)
            held_shapes = [tuple(t.shape) for t in leaves(params)]
            # the rank's share of the numpy weights, as interop cuts it
            interop_agrees = mesh is None or all(
                torch.equal(a, b) for a, b in zip(leaves(params), leaves(interop.rank_shard_from_numpy(
                    case["params"], held, "cpu"))))
            params, state, loss = step(params, state, batch)
            state_leaves = [t for path, t in leaves_with_paths(state) if "['step']" not in path]
            out = {"loss": float(loss), "grads": _whole(box[-1], g_place, mesh),
                   "params0": before, "params": _whole(leaves(params), p_place, mesh),
                   "state": _whole(state_leaves, s_place, mesh), "optimizer": _lm_cfg(key).optimizer
                   if key in LMS or key == "granite_drop" else "adamw"}
            if mesh is not None:
                out["blocks"] = [tuple(t.shape) for t in state_leaves]
                out["zero_dims"] = list(opt.zero_dims)
                out["held"], out["held_shapes"], out["interop_agrees"] = p_place, held_shapes, interop_agrees
    finally:
        opt_lib.get, layers.apply_moe = real_get, real_moe
    return out


def _big_grad(inputs: dict, mesh) -> dict:
    """``equiformer_energy_big``'s energy and gradient on ``mesh`` (chunks
    of BIG_CHUNK edges), or on one card its plain twin's."""
    cfg = registry.get_arch("equiformer-v2").smoke()
    params = interop.gnn_params_from_numpy(inputs["big_params"], "cpu")
    batch = {k: _t(v) for k, v in inputs["big"].items()}
    if mesh is None:
        energy, grads = value_and_grad(lambda p: gnn.equiformer_atoms_big_plain(cfg, p, batch).sum())(params)
    else:
        real_chunk, gnn._BIG_CHUNK = gnn._BIG_CHUNK, BIG_CHUNK
        try:
            with shd.use_mesh(mesh):
                rules = shd.Rules.from_mesh(mesh)
                energy, grads = value_and_grad(lambda p: gnn.equiformer_energy_big(cfg, rules, p, batch)[0])(params)
        finally:
            gnn._BIG_CHUNK = real_chunk
    return {"energy": float(energy), "grads": [_numpy(g) for g in leaves(grads)]}


def _adjoints(mesh) -> dict:
    """⟨f(x), y⟩ and ⟨x, fᵀ(y)⟩ on this rank for each collective over the
    whole mesh, in float64: ``y`` is the same on every rank where f's
    output is (psum, gather_rows; enter's input), the rank's own
    elsewhere."""
    axes = collectives.mesh_axes(mesh)
    n, me = collectives.axis_size(mesh, axes), collectives.mesh_rank(mesh)
    mine = torch.Generator().manual_seed(100 + me)
    shared = torch.Generator().manual_seed(7)

    def rand(shape, gen):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    cases = {
        "psum": (lambda x: collectives.psum(x, axes, mesh), (4, 3), (4, 3), True),
        "gather_rows": (lambda x: collectives.gather_rows(x, axes, 2 * n, mesh), (2, 3), (2 * n, 3), True),
        "all_gather": (lambda x: collectives.all_gather(x, axes, 1, mesh), (3, 2), (3, 2 * n), False),
        "psum_scatter": (lambda x: collectives.psum_scatter(x, axes, 0, mesh), (2 * n, 3), (2, 3), False),
        "all_to_all": (lambda x: collectives.all_to_all(x, axes, mesh), (2 * n, 3), (2 * n, 3), False),
        "enter": (lambda x: collectives.enter(x, axes, mesh), (4, 3), (4, 3), False),
    }
    out = {}
    for name, (f, in_shape, out_shape, invariant_out) in cases.items():
        x = rand(in_shape, shared if name == "enter" else mine).requires_grad_()
        y = rand(out_shape, shared if invariant_out else mine)
        fx = f(x)
        (ft_y,) = torch.autograd.grad(fx, x, y)
        out[name] = (float((fx.detach() * y).sum()), float((x.detach() * ft_y).sum()))
    x = rand((3,), mine).requires_grad_()
    out["pmax_no_grad"] = not collectives.pmax(x, axes, mesh).requires_grad
    return out


def _compress(inputs: dict, mesh) -> list:
    """COMPRESS_STEPS of ``compressed_psum`` over the data axis, each
    rank's gradient its row of the inputs: (mean, residual) a step."""
    d = collectives.axis_index(mesh, "data")
    residual = torch.zeros(COMPRESS_LEN)
    out = []
    with shd.use_mesh(mesh):
        for s in range(COMPRESS_STEPS):
            mean, residual = compression.compressed_psum(_t(inputs["compress"][s, d]), residual, "data")
            out.append((_numpy(mean), _numpy(residual)))
    return out


def _loop_setup(inputs: dict, mesh):
    """DLRM with f32 tables for ``loop.run`` on ``mesh``: (init_fn, step,
    batch_fn, shardings)."""
    cfg = _dlrm_cfg(f32_tables=True)
    rules = shd.Rules.from_mesh(mesh)
    p0 = inputs["loop"]["params"]

    def init_fn():
        params = dlrm.shard_params(cfg, rules, interop.dlrm_params_from_numpy(p0, "cpu"), DLRM_BATCH)
        return params, dlrm.optimizer_for(cfg, rules, params, DLRM_BATCH).init(params)

    params, state = init_fn()
    opt = dlrm.optimizer_for(cfg, rules, params, DLRM_BATCH)
    shardings = (dlrm.held_placements(cfg, rules, DLRM_BATCH), opt.state_placements(state))

    def batch_fn(s):
        return {k: _t(v) for k, v in inputs["loop"]["batches"][s].items()}

    return init_fn, dlrm.make_train_step(cfg, rules), batch_fn, shardings


def _loop_cases(inputs: dict, meshes: dict, out_dir: str) -> dict:
    """At (2, 2): ``loop.run`` crashed at LOOP_CRASH and resumed, against an
    uninterrupted run (each leaf gathered whole); at (4, 1): the last
    checkpoint restored with the rank's shardings (its blocks)."""
    out = {}
    mesh = meshes[2, 2]
    with shd.use_mesh(mesh):
        init_fn, step, batch_fn, shardings = _loop_setup(inputs, mesh)
        places = shd.placement_leaves(shardings)
        kw = dict(init_fn=init_fn, train_step=step, batch_fn=batch_fn, n_steps=LOOP_STEPS,
                  ckpt_every=LOOP_EVERY, shardings=shardings)
        ref = loop.run(**kw, ckpt_dir=os.path.join(out_dir, "loop_ref"))
        crashed = os.path.join(out_dir, "loop_crash")
        try:
            loop.run(**kw, ckpt_dir=crashed, crash_at_step=LOOP_CRASH)
        except RuntimeError as err:
            out["crashed"] = "simulated node failure" in str(err)
        resumed = loop.run(**kw, ckpt_dir=crashed)
        out["ref"] = _whole(leaves((ref.params, ref.opt_state)), places, mesh)
        out["resumed"] = _whole(leaves((resumed.params, resumed.opt_state)), places, mesh)
        out["losses"] = (ref.losses, resumed.losses, resumed.start_step)
    mesh = meshes[4, 1]
    with shd.use_mesh(mesh):
        init_fn, _, _, shardings = _loop_setup(inputs, mesh)
        got = checkpoint.restore(os.path.join(out_dir, "loop_ref"), LOOP_STEPS, init_fn(), shardings=shardings)
        out["restored"] = [(_numpy(t), p) for t, p in zip(leaves(got), shd.placement_leaves(shardings))]
    return out


def _rank_program(rank: int, world: int, store: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    ranks.init_rank(rank, world, store, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    try:
        _rows_rule(dlrm)
        meshes = {s: DeviceMesh("cpu", torch.arange(s[0] * s[1]).reshape(s), mesh_dim_names=("data", "model"))
                  for s in SHAPES}
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        res = {}
        for shape, mesh in meshes.items():
            if mesh.get_coordinate() is None:
                continue
            r = res[shape] = {"coord": tuple(mesh.get_coordinate()), "adjoint": _adjoints(mesh)}
            collectives.WIRE_COUNTERS.clear()
            for key in MODELS + ["granite_drop"]:
                r[key] = _train_case(key, inputs["cases"][key], mesh)
            r["wire"] = dict(collectives.WIRE_COUNTERS)
            r["big"] = _big_grad(inputs, mesh)
        res["compress"] = _compress(inputs, meshes[4, 1])
        res["loop"] = _loop_cases(inputs, meshes, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# repro on 8 forced host devices
# ---------------------------------------------------------------------------

REPRO_SCRIPT = textwrap.dedent(
    """
    import dataclasses, functools, json, os, pickle, sys, types
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs import dlrm_mlperf, kimi_k2_1t_a32b, registry
    from repro.dist import compat
    from repro.dist import sharding as shd
    from repro.models import dlrm, gnn, layers
    from repro.models import transformer as tr
    from repro.training import checkpoint, compression
    from repro.training import optimizer as opt_lib

    assert len(jax.devices()) == 8
    with open(sys.argv[1], "rb") as f:
        inputs = pickle.load(f)
    C = CONST
    dlrm.embedding_placement = lambda rows, *a, **k: types.SimpleNamespace(
        mode="shard" if rows > C["rows"] else "replicate")
    gnn._BIG_CHUNK = C["chunk"]
    tree = lambda t: jax.tree.map(jnp.asarray, t)
    real_moe = layers.apply_moe

    def cfg_of(key):
        if key == "dlrm":
            return dlrm_mlperf.smoke()
        if key in C["gnns"]:
            return registry.get_arch(key).smoke()
        cfg = registry.get_arch(C["lms"]["granite" if key == "granite_drop" else key]).smoke()
        if key == "dense":
            cfg = dataclasses.replace(cfg, microbatches=2)
        if key == "kimi":
            cfg = dataclasses.replace(cfg, fsdp_experts=True, optimizer="adafactor",
                                      sharding_overrides=kimi_k2_1t_a32b.SHARDING_OVERRIDES)
        return dataclasses.replace(cfg, remat=False)

    out = {}
    for shape in [tuple(s) for s in json.loads(sys.argv[3])]:
        mesh = compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[: shape[0] * shape[1]])
        with shd.use_mesh(mesh):
            for key in C["models"]:
                cfg = cfg_of(key)
                layers.apply_moe = functools.partial(real_moe, capacity_factor=C["drop"] if key == "granite_drop"
                                                     else C["no_drop"])
                if key == "dlrm":
                    step = dlrm.make_train_step(cfg, shd.Rules.from_mesh(mesh))
                elif key in C["gnns"]:
                    step = gnn.make_gnn_train_step(cfg, shd.Rules.from_mesh(mesh))
                else:
                    step = tr.make_train_step(cfg, tr.rules_for(cfg, mesh))
                case = inputs["cases"][key]
                params = tree(case["params"])
                state = opt_lib.get(cfg.optimizer).init(params)
                new_p, new_s, loss = jax.jit(step)(params, state, tree(case["batch"]))
                s_leaves = [x for path, x in jax.tree_util.tree_flatten_with_path(new_s)[0]
                            if "step" not in jax.tree_util.keystr(path)]
                out[shape, key] = (float(loss), [np.asarray(x) for x in jax.tree.leaves(new_p)],
                                   [np.asarray(x) for x in s_leaves])
            layers.apply_moe = real_moe
            ecfg = registry.get_arch("equiformer-v2").smoke()
            rules = shd.Rules.from_mesh(mesh)
            e, g = jax.jit(jax.value_and_grad(
                lambda p, b: gnn.equiformer_energy_big(ecfg, rules, p, b)[0]))(tree(inputs["big_params"]),
                                                                             tree(inputs["big"]))
            out[shape, "big"] = (float(e), [np.asarray(x) for x in jax.tree.leaves(g)])
    if sys.argv[4] == "compress":
      mesh = compat.make_mesh((4,), ("data",), devices=jax.devices()[:4])
      step = shd.shard_map(lambda g, r: compression.compressed_psum(g[0], r[0], "data"), mesh=mesh,
                           in_specs=(P("data"), P("data")), out_specs=(P(), P("data")), check_vma=False)
      residual = jnp.zeros((4, C["compress_len"]), jnp.float32)
      steps = []
      for s in range(C["compress_steps"]):
          mean, res = jax.jit(step)(jnp.asarray(inputs["compress"][s]), residual)
          residual = res.reshape(4, -1)
          steps.append((np.asarray(mean), np.asarray(residual)))
      out["compress"] = steps
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    """
).replace("CONST", repr({"rows": SHARD_ABOVE_ROWS, "chunk": BIG_CHUNK, "gnns": GNN_ARCHS, "lms": LMS,
                         "shapes": SHAPES, "models": MODELS + ["granite_drop"], "drop": CAP_DROP,
                         "no_drop": CAP_NO_DROP, "compress_len": COMPRESS_LEN, "compress_steps": COMPRESS_STEPS,
                         "loop_steps": LOOP_STEPS}))
REPRO_TIMEOUT_S = 300
CHILD_ENV = {**{k: os.environ[k] for k in ("HOME", "PATH", "TMPDIR") if k in os.environ},
             "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}

REPRO_RESTORE = textwrap.dedent(
    """
    import dataclasses, pickle, sys
    import numpy as np
    import jax
    from repro.configs import dlrm_mlperf
    from repro.models import dlrm
    from repro.training import checkpoint
    from repro.training import optimizer as opt_lib

    cfg = dataclasses.replace(dlrm_mlperf.smoke(), table_dtype=jax.numpy.float32)
    like = jax.eval_shape(lambda: (lambda p: (p, opt_lib.get("adamw").init(p)))(
        dlrm.init_params(cfg, jax.random.PRNGKey(0))))
    got = checkpoint.restore(sys.argv[1], int(sys.argv[2]), like)
    with open(sys.argv[3], "wb") as f:
        pickle.dump([np.asarray(x) for x in jax.tree.leaves(got)], f)
    """
)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
    path = d / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(_inputs(), f)
    return path


@pytest.fixture(scope="module")
def inputs(inputs_path):
    with open(inputs_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def repro_8_devices(inputs_path):
    """``repro_8_devices()``: ``repro``'s jitted train steps on each mesh
    shape of 8 forced host devices, from a subprocess started when the
    fixture is made and waited for (at most ``REPRO_TIMEOUT_S``) on first
    use."""
    d = inputs_path.parent
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for i, shape in enumerate(SHAPES):  # one process a mesh shape, side by side
        with open(d / f"repro{i}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", REPRO_SCRIPT, str(inputs_path), str(d / f"repro{i}.pkl"),
                 json.dumps([shape]), "compress" if i == 0 else "-"],
                stdout=log, stderr=subprocess.STDOUT, env=CHILD_ENV, cwd=cwd))
    cache = {}

    def get():
        if not cache:
            for i, proc in enumerate(procs):
                try:
                    rc = proc.wait(timeout=REPRO_TIMEOUT_S)
                finally:
                    proc.kill()
                assert rc == 0, f"repro's 8-device run failed:\n{(d / f'repro{i}.log').read_text()}"
                with open(d / f"repro{i}.pkl", "rb") as f:
                    cache.update(pickle.load(f))
        return cache

    yield get
    for proc in procs:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def spawned(inputs_path, repro_8_devices):
    """Every rank's results by mesh, from one spawn (``repro``'s run starts
    first and runs beside it)."""
    d = inputs_path.parent
    ranks.run_ranks(_rank_program, WORLD, (WORLD, str(d / "store"), str(inputs_path), str(d)),
                    timeout_s=SPAWN_TIMEOUT_S, device="cpu")
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def one_card(inputs):
    real = dlrm.embedding_placement
    _rows_rule(dlrm)
    try:
        out = {key: _train_case(key, inputs["cases"][key], None) for key in MODELS}
    finally:
        dlrm.embedding_placement = real
    out["big"] = _big_grad(inputs, None)
    return out


def _ranks_of(spawned, shape):
    return [r[shape] for r in spawned if shape in r]


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _close(got, want, tol: float, what, where=None, floor: float = 0.0) -> None:
    """|got - want| within ``tol`` × the larger of ``want``'s largest |value|
    and ``floor``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    if where is not None:
        diff = diff[where]
    assert diff.max(initial=0.0) <= tol * max(np.abs(want).max(initial=0.0), floor, 1e-30), (what, diff.max(initial=0.0))


def _floor(arrays) -> float:
    """FLOOR of the largest |value| over a model's leaves: a leaf whose
    gradient cancels to rounding noise (EquiformerV2's last attention bias:
    the softmax does not move with a head's shift) has no scale of its own."""
    return FLOOR * max(float(np.abs(np.asarray(a, np.float64)).max(initial=0.0)) for a in arrays)


def _tol(key: str, a: np.ndarray) -> float:
    if a.dtype == ml_dtypes.bfloat16:
        return TOL_BF16
    return TOL_EQ if key == "equiformer-v2" else TOL_F32


def _check_moments(key: str, got: dict, m_want: list, v_want: list, what) -> None:
    """AdamW's first-step moments against ``repro``'s.  m = (1 - b1)·g is
    held to 2 × the leaf's tolerance of its largest |m| (floored as
    ``_floor``): so the gradient may be off by ε_g = that limit over
    (1 - b1), and v = (1 - b2)·g² by (1 - b2)·(2·max|g| + ε_g)·ε_g
    (|a² - b²| = |a - b|·|a + b|), g the gradient the rank's optimizer
    received: v's relative error is twice g's, plus its own rounding."""
    n = len(got["params"])
    m_got, v_got = got["state"][:n], got["state"][n:]
    m_floor = _floor(m_want)
    for i, (mg, mw, vg, vw) in enumerate(zip(m_got, m_want, v_got, v_want)):
        tol = 2 * _tol(key, np.asarray(got["params"][i]))
        _close(mg, mw, tol, what + ("m", i), floor=m_floor)
        eps_g = tol * max(np.abs(np.asarray(mw, np.float64)).max(initial=0.0), m_floor) / (1 - ADAM_B1)
        g_max = np.abs(np.asarray(got["grads"][i], np.float64)).max(initial=0.0)
        vw = np.asarray(vw, np.float64)
        bound = (1 - ADAM_B2) * (2 * g_max + eps_g) * eps_g + 2.0**-22 * np.abs(vw)
        diff = np.abs(np.asarray(vg, np.float64) - vw)
        assert (diff <= bound).all(), (what, "v", i, float((diff / bound).max()))


def _adamw_reference(params0: list, grads: list) -> tuple[list, list]:
    """The one-card AdamW step on whole leaves: (parameters, m and v)."""
    p = [_t(a) for a in params0]
    g = [_t(a) for a in grads]
    opt = opt_lib.adamw()
    state = opt.init(p)
    p, state = opt.update(p, g, state)
    return [_numpy(t) for t in p], [_numpy(t) for t in state["m"] + state["v"]]


# ---------------------------------------------------------------------------
# the collectives' gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_collective_backward_is_its_adjoint(spawned, shape):
    """⟨f(x), y⟩ = ⟨x, fᵀ(y)⟩ over the whole mesh in float64, each side
    summed over the ranks that hold it on their own and counted once
    where every rank holds the same value; ``pmax`` records no gradient."""
    rs = _ranks_of(spawned, shape)
    n = len(rs)
    for name in ("psum", "gather_rows", "all_gather", "psum_scatter", "all_to_all", "enter"):
        lhs = [r["adjoint"][name][0] for r in rs]
        rhs = [r["adjoint"][name][1] for r in rs]
        if name in ("psum", "gather_rows"):
            assert np.allclose(lhs, lhs[0], rtol=1e-12), name
            left, right = lhs[0], sum(rhs)
        elif name == "enter":
            assert np.allclose(rhs, rhs[0], rtol=1e-12), name
            left, right = sum(lhs), rhs[0]
        else:
            left, right = sum(lhs), sum(rhs)
        assert abs(left - right) <= 1e-10 * max(abs(left), 1.0), (shape, name, left, right, n)
    assert all(r["adjoint"]["pmax_no_grad"] for r in rs)


# ---------------------------------------------------------------------------
# the train steps against the port's one-card step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", MODELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_train_step_equals_one_card(spawned, one_card, shape, key):
    """The loss and each reduced gradient, gathered whole, against the
    one-card step (f32 1e-5, EquiformerV2 1e-4, bf16 2e-2 of a leaf's
    largest); the parameters and state after the step against the
    one-card optimizer applied to that gradient: AdamW bit for bit,
    Adafactor within 1e-6; every rank alike."""
    want = one_card[key]
    for r in _ranks_of(spawned, shape):
        got = r[key]
        assert abs(got["loss"] - want["loss"]) <= TOL_F32 * abs(want["loss"]), (shape, key)
        floor = _floor(want["grads"])
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            _close(g, w, _tol(key, w), (shape, key, "grad", i), floor=floor)
        for i, (p0, w) in enumerate(zip(got["params0"], want["params0"])):
            assert _bits(p0) == _bits(w), (shape, key, "params before", i)
        if got["optimizer"] == "adamw":
            params, state = _adamw_reference(got["params0"], got["grads"])
            for i, (p, w) in enumerate(zip(got["params"], params)):
                assert _bits(p) == _bits(w), (shape, key, "param", i)
            for i, (s, w) in enumerate(zip(got["state"], state)):
                assert _bits(s) == _bits(w), (shape, key, "moment", i)
        else:
            for i, (p, w) in enumerate(zip(got["params"], want["params"])):
                _close(p, w, 1e-6, (shape, key, "param", i))
            floor = _floor(want["state"])
            for i, (s, w) in enumerate(zip(got["state"], want["state"])):
                _close(s, w, 2 * TOL_F32, (shape, key, "factor", i), floor=floor)


@pytest.mark.parametrize("key", ["dlrm", "gcn-cora", "dense", "granite"])
@pytest.mark.parametrize("shape", SHAPES)
def test_zero_holds_a_block_and_updates_bit_for_bit(spawned, shape, key):
    """ZeRO-1: each rank holds its 1/data block of ``m`` and ``v`` where
    ``zero_sharding`` places one (on the leaf as the rank holds it, the
    first dimension the rank holds whole that the data axis divides), and
    the parameters after the step are the replicated update's bits (the
    one-card AdamW on the gathered gradient); the rank's share of the
    weights is the one ``interop.rank_shard_from_numpy`` cuts."""
    n_data = shape[0]
    for r in _ranks_of(spawned, shape):
        got = r[key]
        n = len(got["held"])
        assert got["interop_agrees"], (shape, key)
        assert any(z is not None for z in got["zero_dims"]), key
        for i, (z, place, whole) in enumerate(zip(got["zero_dims"], got["held"], got["held_shapes"])):
            m_block, v_block = got["blocks"][i], got["blocks"][n + i]
            assert m_block == v_block, (key, i)
            want = list(whole)
            if z is not None:
                assert place[z] is None and whole[z] % n_data == 0, (shape, key, i)
                want[z] //= n_data
            assert list(m_block) == want, (shape, key, i)
        params, state = _adamw_reference(got["params0"], got["grads"])
        for a, b in zip(got["params"] + got["state"], params + state):
            assert _bits(a) == _bits(b), (shape, key)


@pytest.mark.parametrize("shape", SHAPES)
def test_rank_gradients_are_reduced_over_the_blocked_axes(spawned, shape):
    """Each step sent its gradient reductions over the wire: the enters'
    and collectives' backwards were called, and every step's all_reduces
    carried bytes (the (1, 4) mesh's data axis is one rank: the DLRM and
    LM gradients need no reduction there, the GNNs' edge blocks do)."""
    for r in _ranks_of(spawned, shape):
        wire = r["wire"]
        assert wire["enter_backward"] > 0 and wire["psum_backward"] > 0
        assert wire["all_to_all_backward"] > 0 if shape[1] > 1 else True
        assert wire["all_gather_backward"] > 0 if shape[0] > 1 else True


# ---------------------------------------------------------------------------
# against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", MODELS + ["granite_drop"])
@pytest.mark.parametrize("shape", SHAPES)
def test_train_step_equals_repro(repro_8_devices, spawned, shape, key):
    """The loss, the optimizer state (AdamW's moments: the gradient;
    Adafactor's factors) and the parameters after ``repro``'s jitted
    step on the same mesh shape: f32 1e-5 (EquiformerV2 1e-4), bf16
    2e-2; AdamW's parameters where the gradient passes 1e-3 of its
    leaf's largest.  At capacity 1.25 (``granite_drop``) some assignments
    drop, so an assignment kept on one side only would move a token's
    output by a whole expert term."""
    loss, params, state = repro_8_devices()[shape, key]
    for r in _ranks_of(spawned, shape):
        got = r[key]
        assert abs(got["loss"] - loss) <= TOL_F32 * abs(loss), (shape, key, got["loss"], loss)
        n = len(got["params"])
        if got["optimizer"] == "adamw":
            _check_moments(key, got, state[:n], state[n:], (shape, key))
        else:  # Adafactor's factors
            floor = _floor(state)
            for i, (s, w) in enumerate(zip(got["state"], state)):
                _close(s, w, 2 * TOL_F32, (shape, key, "state", i), floor=floor)
        g_floor = _floor(got["grads"])
        for i, (p, w) in enumerate(zip(got["params"], params)):
            where = None
            if got["optimizer"] == "adamw":
                g = np.abs(np.asarray(got["grads"][i], np.float64))
                where = g > max(1e-3 * g.max(initial=0.0), g_floor)
            _close(p, w, _tol(key, p), (shape, key, "param", i), where)


# ---------------------------------------------------------------------------
# equiformer_energy_big's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_big_equiformer_gradient(repro_8_devices, spawned, one_card, shape):
    """``equiformer_energy_big``'s energy and every gradient leaf (chunks
    of BIG_CHUNK edges, each chunk and layer recomputed in the backward)
    finite and the same on every rank, within BIG_TOL of its plain twin's
    on one card (bf16 node state: the path adds chunk by chunk into bf16,
    the twin in f32) and of ``repro``'s where ``repro``'s is finite.  On a
    model axis of more than one rank ``repro``'s gradient is NaN: it masks
    another rank's destination after the exponential
    (``where(inr, exp(logits - m), 0)``), whose gradient is 0 × inf
    (ROADMAP §C); the port masks the exponent."""
    energy, grads = repro_8_devices()[shape, "big"]
    want = one_card["big"]
    rs = _ranks_of(spawned, shape)
    repro_finite = all(np.isfinite(g).all() for g in grads)
    assert repro_finite == (shape[1] == 1)
    for r in rs:
        got = r["big"]
        assert abs(got["energy"] - want["energy"]) <= BIG_TOL * abs(want["energy"])
        assert abs(got["energy"] - energy) <= BIG_TOL * abs(energy)
        floor = _floor(want["grads"])
        for i, (g, w, rw) in enumerate(zip(got["grads"], want["grads"], grads)):
            assert np.isfinite(g).all(), (shape, i)
            _close(g, w, BIG_TOL, (shape, "big", i), floor=floor)
            if repro_finite:
                _close(g, rw, BIG_TOL, (shape, "big repro", i), floor=floor)
            assert _bits(g) == _bits(rs[0]["big"]["grads"][i])


# ---------------------------------------------------------------------------
# compressed_psum, checkpoints and the loop
# ---------------------------------------------------------------------------


def test_compressed_psum_equals_repro(repro_8_devices, spawned, inputs):
    """COMPRESS_STEPS of error feedback over a data axis of 4 ranks against
    ``repro``'s inside ``shard_map`` on 4 forced devices: each rank's
    residual within 1e-6 of the largest gradient it fed back (it never
    sees the sum; XLA may fuse its product and difference), the mean
    within bf16's
    rounding of the largest (the ranks' bf16 payloads summed in another
    order), the same on every rank."""
    want = repro_8_devices()["compress"]
    by_rank = {r[(4, 1)]["coord"][0]: r["compress"] for r in spawned}
    for s, (mean, residuals) in enumerate(want):
        for d, steps in by_rank.items():
            got_mean, got_res = steps[s]
            _close(got_res, residuals[d], 1e-6, (s, d), floor=np.abs(inputs["compress"][: s + 1, d]).max())
            _close(got_mean, mean, 1e-2, (s, d))
            assert _bits(got_mean) == _bits(by_rank[0][s][0])


def test_loop_resumes_and_restores_over_ranks(spawned, inputs_path):
    """``loop.run`` at (2, 2) crashed at LOOP_CRASH and resumed from its
    last checkpoint ends bit for bit where the uninterrupted run does;
    the last checkpoint, written whole by rank 0 after every rank agreed,
    restores at (4, 1) (each rank's blocks equal the saved leaves'), on
    one card and in ``repro``."""
    d = inputs_path.parent
    res = [r["loop"] for r in spawned]
    for r in res:
        assert r["crashed"]
        ref_losses, resumed_losses, start = r["losses"]
        assert start == LOOP_CRASH // LOOP_EVERY * LOOP_EVERY
        assert resumed_losses == ref_losses[start:]
        for a, b in zip(r["ref"], r["resumed"]):
            assert _bits(a) == _bits(b)
    ck = str(d / "loop_ref")
    assert checkpoint.latest_step(ck) == LOOP_STEPS
    inputs = pickle.loads((d / "inputs.pkl").read_bytes())
    params = interop.dlrm_params_from_numpy(inputs["loop"]["params"], "cpu")
    like = (params, opt_lib.adamw().init(params))
    whole = [_numpy(t) for t in leaves(checkpoint.restore(ck, LOOP_STEPS, like))]
    for a, b in zip(whole, res[0]["ref"]):
        assert _bits(a) == _bits(b)
    n = 4
    for rank, r in enumerate(res):
        for (block, place), w in zip(r["restored"], whole):
            want = w
            for dim, entry in enumerate(place):
                if entry == "data":
                    k = w.shape[dim] // n
                    want = np.take(want, np.arange(rank * k, (rank + 1) * k), axis=dim)
            assert _bits(block) == _bits(want)
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = d / "repro_restore.pkl"
    subprocess.run([sys.executable, "-c", REPRO_RESTORE, ck, str(LOOP_STEPS), str(out)], check=True, env=CHILD_ENV,
                   cwd=cwd, timeout=REPRO_TIMEOUT_S)
    got = pickle.loads(out.read_bytes())
    assert len(got) == len(whole)
    for a, b in zip(got, whole):
        assert _bits(a) == _bits(b)
