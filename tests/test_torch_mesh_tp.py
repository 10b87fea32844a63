"""The LMs' dense layers tensor-parallel over the model axis, and
retrieval's candidates on ``repro``'s fitted blocks, over ``gloo`` ranks
on the CPU.

Each rank holds ``repro``'s placements fitted to every leaf
(``tr.held_placements``, ``tr.shard_params``): q, k, v, the FFN's gate
and up column blocks, ``wo`` and ``w_down`` row blocks, ``embed`` by
vocab rows and ``lm_head`` by vocab columns, a dimension the model axis
does not divide whole.  Three smoke configs: ``dense`` (qwen3-14b's
smoke: 4 q heads, 2 kv heads, vocab 211 padded to 256, f32), ``odd`` (6
q heads, which 4 does not divide, so q's columns are cut but its heads
gathered whole, as qwen3-14b's 40 at 16 ranks; the vocab 211 unpadded,
whole on every rank) and ``bf16`` (``dense`` in bfloat16).  Forward
logits, prefill (logits and cache), a decode step on a whole cache (a
rank's heads read their kv groups of it: B7's ``kv_head_offset``), the
sequence-sharded decode, and the loss, its gradient and one train step
are held to the port's one-card run and to ``repro`` on 4 of 8 forced
host devices on the same mesh shape; that step's parameters and ZeRO-1
moments, saved at (2, 2), restore at (1, 4) as that layout's blocks.
Retrieval's top 64, each rank
scoring its block of the candidates over every axis as ``repro`` fits
it (512 candidates lie over all four ranks; 510 drop the model axis),
equals the one-card top 64 and ``repro``'s up to ties.

One spawn of 4 ``gloo`` ranks runs every case on (4, 1), (2, 2) and
(1, 4) ``(data, model)`` meshes; one ``repro`` subprocess runs beside it.
Inputs are drawn once with numpy (the weights by the port's inits,
carried as numpy) and handed to both.

Tolerances, as the largest |difference| over the largest |value|
(``test_torch_mesh_lm.py``'s): f32 1e-5, bf16 2e-2; gradients 1e-5 of a
leaf's largest, floored at 1e-3 of the model's largest.  The ranks sum a
product's blocks in another order than one card (the ``psum`` after a
row-parallel product).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import interop
from repro_torch.configs import dlrm_mlperf, registry
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.kernels.decode_attn import decode_attn as da
from repro_torch.launch import cells, ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import dlrm
from repro_torch.models import transformer as tr
from repro_torch.training import checkpoint
from repro_torch.training.tree import leaves, leaves_with_paths, value_and_grad

torch.set_num_threads(1)

SHAPES = [(4, 1), (2, 2), (1, 4)]
LM_SHAPES = [(2, 2), (1, 4)]
WORLD = 4
SPAWN_TIMEOUT_S = 300
TOL_F32, TOL_BF16, FLOOR = 1e-5, 2e-2, 1e-3
DECODE_LENS = (7, 40)  # the seq-sharded decode: inside the first shard, past half the cache
N_CANDIDATES = (512, 510)  # over every axis; 510 drops the model axis where it has 2 or 4 ranks
CARD_BYTES = 80e9


def _smoke():
    return registry.get_arch("qwen3-14b").smoke()


CONFIGS = {
    "dense": _smoke,
    "odd": lambda: dataclasses.replace(_smoke(), n_q_heads=6, vocab_pad=1),
    "bf16": lambda: dataclasses.replace(_smoke(), dtype=torch.bfloat16),
}
TRAINED = ("dense", "odd")  # repro's chunked loss asserts the vocab divides over the model axis: dense only


def _tol(name: str) -> float:
    return TOL_BF16 if name == "bf16" else TOL_F32


def _numpy(t: torch.Tensor) -> np.ndarray:
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
    return interop._tensor(np.array(a), torch.device("cpu"))  # a copy: decode steps write the cache


def _inputs() -> dict:
    rng = np.random.default_rng(21)
    lms = {}
    for name, make in CONFIGS.items():
        cfg = make()
        L, G, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
        cache = rng.normal(size=(2, L, 2, 64, G, Dh)).astype(np.float32)
        if cfg.dtype == torch.bfloat16:
            cache = cache.astype(ml_dtypes.bfloat16)
        toks = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
        lms[name] = {
            "params": _tree(tr.init_params(cfg, seed=3, device="cpu")),
            "prompts": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32),
            "tokens": rng.integers(0, cfg.vocab, (2,)).astype(np.int32),
            "k": cache[0], "v": cache[1],
            "train": {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
        }
    dcfg = dlrm_mlperf.smoke()
    sizes = np.asarray(dcfg.table_sizes)
    retrieval = {n: {"dense": rng.normal(size=(1, dcfg.n_dense)).astype(np.float32),
                     "sparse": (rng.random((1, dcfg.n_sparse, 1)) * sizes[None, :, None]).astype(np.int32),
                     "candidates": rng.normal(size=(n, dcfg.embed_dim)).astype(np.float32)}
                 for n in N_CANDIDATES}
    return {"lm": lms, "dlrm": _tree(dlrm.init_params(dcfg, seed=5, device="cpu")), "retrieval": retrieval}


# ---------------------------------------------------------------------------
# the cases, per rank or on one card
# ---------------------------------------------------------------------------


def _whole_grads(cfg, rules, params: dict, grads: dict, B: int) -> list:
    """A rank's gradient leaves summed over the axes its batch block lies
    on (as the rank optimizer reduces them), each gathered whole over the
    axes its block lies on."""
    axes = collectives.batch_block(rules, B)[2]
    out = []
    for g, place in zip(leaves(grads), shd.placement_leaves(tr.held_placements(cfg, rules))):
        if axes:
            g = collectives.psum(g, axes)
        out.append(_numpy(collectives.assemble_leaf(g.contiguous(), place)))
    return out


def _lm_case(name: str, case: dict, mesh) -> dict:
    cfg = CONFIGS[name]()
    rules = tr.rules_for(cfg, mesh)
    whole = interop.lm_params_from_numpy(case["params"], "cpu")
    prompts, tokens = _t(case["prompts"]), _t(case["tokens"])
    out = {}
    with shd.use_mesh(mesh):
        params = tr.shard_params(cfg, rules, whole)
        if mesh is not None:
            held = shd.placement_leaves(tr.held_placements(cfg, rules))
            out["held"] = {p.replace("/", ""): tuple(t.shape) for p, t in leaves_with_paths(params)}
            out["blocks_exact"] = all(torch.equal(t, collectives.leaf_block(w, pl))
                                      for t, w, pl in zip(leaves(params), leaves(whole), held))
            tp = tr.tensor_parallel(cfg, rules)
            out["tp"] = (tp.axis, tuple(tp.heads), tuple(tp.groups), tp.vocab.whole)
        out["forward"] = _numpy(tr.forward(cfg, rules, params, prompts))
        logits, cache = tr.make_prefill(cfg, rules)(params, prompts)
        out["prefill"] = (_numpy(logits), _numpy(cache["k"]))
        full = {"k": _t(case["k"]), "v": _t(case["v"]), "len": torch.tensor(7, dtype=torch.int32)}
        out["decode"] = _numpy(tr.make_decode_step(cfg, rules)(params, tr.cache_shard(cfg, rules, full), tokens)[0])
        for n in DECODE_LENS:
            full = {"k": _t(case["k"]), "v": _t(case["v"]), "len": torch.tensor(n, dtype=torch.int32)}
            shard = tr.cache_shard(cfg, rules, full, seq_sharded=True)
            got, new = tr.make_decode_step(cfg, rules, seq_sharded=True)(params, shard, tokens)
            out["seq", n] = (_numpy(got), _numpy(new["k"]))
        if name in TRAINED:
            toks, labels = _t(case["train"]["tokens"]), _t(case["train"]["labels"])
            loss, grads = value_and_grad(lambda p: tr.loss_fn(cfg, rules, p, toks, labels))(params)
            out["loss"] = float(loss)
            out["grads"] = _whole_grads(cfg, rules, params, grads, toks.shape[0]) if mesh is not None else [
                _numpy(g) for g in leaves(grads)]
            out["grads_held"] = [_numpy(g) for g in leaves(grads)]
            mine = tr.shard_params(cfg, rules, interop.lm_params_from_numpy(case["params"], "cpu"))
            opt = tr.optimizer_for(cfg, rules, mine)
            new, _, step_loss = tr.make_train_step(cfg, rules)(mine, opt.init(mine), {"tokens": toks,
                                                                                    "labels": labels})
            places = (shd.placement_leaves(tr.held_placements(cfg, rules)) if mesh is not None
                      else [None] * len(leaves(new)))
            out["step"] = (float(step_loss), [_numpy(t if pl is None else collectives.assemble_leaf(t, pl))
                                              for t, pl in zip(leaves(new), places)])
    return out


def _retrieval_cases(inputs: dict, mesh) -> dict:
    cfg = dlrm_mlperf.smoke()
    rules = shd.Rules.from_mesh(mesh)
    params = interop.dlrm_params_from_numpy(inputs["dlrm"], "cpu")
    out = {}
    with shd.use_mesh(mesh):
        mine = dlrm.shard_params(cfg, rules, params, 1)
        for n, case in inputs["retrieval"].items():
            batch = {k: _t(v) for k, v in case.items()}
            collectives.WIRE_COUNTERS.clear()
            scores, idx = dlrm.make_retrieval_step(cfg, rules)(mine, batch)
            block = collectives.flat_block(rules, n)
            out["retrieval", n] = (_numpy(scores), _numpy(idx), block, dict(collectives.WIRE_COUNTERS))
            if mesh is not None:  # the rank handed only its block, as the dry run hands it
                blk = dict(batch, candidates=batch["candidates"][block[0]:block[1]].clone())
                s2, i2 = dlrm.make_retrieval_step(cfg, rules, n)(mine, blk)
                assert torch.equal(s2, scores) and torch.equal(i2, idx)
            if mesh is None:  # every candidate's score, for ties
                q = dlrm._mlp_apply(params["bot"], batch["dense"])[0]
                embs = [q] + [e[0].float() for e in dlrm.embedding_bags(cfg, rules, params, batch["sparse"][:1])]
                out["all_scores", n] = _numpy(batch["candidates"] @ torch.stack(embs).mean(0))
    return out


def _cases(inputs: dict, mesh, lm: bool) -> dict:
    out = _retrieval_cases(inputs, mesh)
    if lm:
        for name, case in inputs["lm"].items():
            for key, val in _lm_case(name, case, mesh).items():
                out[name, key] = val
    return out


def _checkpoint_case(inputs: dict, meshes: dict, out_dir: str) -> dict:
    """``dense`` at (2, 2): one train step, then its tensor-parallel
    parameters and ZeRO-1 AdamW state saved whole (``checkpoint.save``
    with the rank's placements); restored at (1, 4) under that layout's
    held placements and optimizer state placements."""
    cfg, case = CONFIGS["dense"](), inputs["lm"]["dense"]
    batch = {k: _t(v) for k, v in case["train"].items()}
    ck = os.path.join(out_dir, "ckpt_tp")
    out = {}
    with shd.use_mesh(meshes[2, 2]):
        rules = tr.rules_for(cfg, meshes[2, 2])
        params = tr.shard_params(cfg, rules, interop.lm_params_from_numpy(case["params"], "cpu"))
        opt = tr.optimizer_for(cfg, rules, params)
        params, state, _ = tr.make_train_step(cfg, rules)(params, opt.init(params), batch)
        places = shd.placement_leaves((tr.held_placements(cfg, rules), opt.state_placements(state)))
        checkpoint.save(ck, 1, (params, state), shardings=places)
        out["saved"] = [_numpy(collectives.assemble_leaf(t.contiguous(), p)) for t, p in
                        zip(leaves((params, state)), places)]
    with shd.use_mesh(meshes[1, 4]):
        rules = tr.rules_for(cfg, meshes[1, 4])
        params = tr.shard_params(cfg, rules, interop.lm_params_from_numpy(case["params"], "cpu"))
        opt = tr.optimizer_for(cfg, rules, params)
        like = (params, opt.init(params))
        places = shd.placement_leaves((tr.held_placements(cfg, rules), opt.state_placements(like[1])))
        got = checkpoint.restore(ck, 1, like, shardings=places)
        out["restored"] = [(_numpy(t), p) for t, p in zip(leaves(got), places)]
    return out


def _rank_program(rank: int, world: int, store: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    ranks.init_rank(rank, world, store, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    try:
        meshes = {s: DeviceMesh("cpu", torch.arange(s[0] * s[1]).reshape(s), mesh_dim_names=("data", "model"))
                  for s in SHAPES}
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        res = {}
        for shape, mesh in meshes.items():
            res[shape] = _cases(inputs, mesh, shape in LM_SHAPES)
            res[shape]["coord"] = tuple(mesh.get_coordinate())
        res["checkpoint"] = _checkpoint_case(inputs, meshes, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# repro on 8 forced host devices
# ---------------------------------------------------------------------------

REPRO_SCRIPT = textwrap.dedent(
    """
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import dlrm_mlperf, registry
    from repro.dist import compat
    from repro.dist import sharding as shd
    from repro.models import dlrm
    from repro.models import transformer as tr

    assert len(jax.devices()) == 8
    with open(sys.argv[1], "rb") as f:
        inputs = pickle.load(f)
    tree = lambda t: jax.tree.map(jnp.asarray, t)
    C = CONST
    smoke = registry.get_arch("qwen3-14b").smoke()
    configs = {"dense": smoke, "odd": dataclasses.replace(smoke, n_q_heads=6, vocab_pad=1),
               "bf16": dataclasses.replace(smoke, dtype=jnp.bfloat16)}
    out = {}
    for shape in C["shapes"]:
        mesh = compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[:4])
        rules = shd.Rules.from_mesh(mesh)
        with shd.use_mesh(mesh):
            dcfg = dlrm_mlperf.smoke()
            step = jax.jit(dlrm.make_retrieval_step(dcfg, rules))
            for n, case in inputs["retrieval"].items():
                s, i = step(tree(inputs["dlrm"]), tree(case))
                out[shape, "retrieval", n] = (np.asarray(s), np.asarray(i))
            if shape not in C["lm_shapes"]:
                continue
            for name, case in inputs["lm"].items():
                cfg = dataclasses.replace(configs[name], remat=False)
                lr = tr.rules_for(cfg, mesh)
                specs = tr.param_specs(cfg, lr)
                shapes = tr.param_shapes(cfg)
                blocks = {}
                for path, spec in jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
                    leaf = shapes
                    for k in path:
                        leaf = leaf[k.key]
                    fitted = shd.fit_spec(mesh, spec, leaf.shape)
                    dims = []
                    for d, e in zip(leaf.shape, tuple(fitted) + (None,) * (len(leaf.shape) - len(fitted))):
                        names = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
                        dims.append(d // int(np.prod([mesh.shape[a] for a in names])))
                    blocks[jax.tree_util.keystr(path)] = tuple(dims)
                out[shape, name, "blocks"] = blocks
                params = tree(case["params"])
                prompts = jnp.asarray(case["prompts"])
                out[shape, name, "forward"] = np.asarray(jax.jit(lambda p, t: tr.forward(cfg, lr, p, t))(params, prompts))
                logits, cache = jax.jit(tr.make_prefill(cfg, lr))(params, prompts)
                out[shape, name, "prefill"] = (np.asarray(logits), np.asarray(cache["k"]))
                full = {"k": jnp.asarray(case["k"]), "v": jnp.asarray(case["v"]), "len": jnp.int32(7)}
                got, _ = jax.jit(tr.make_decode_step(cfg, lr))(params, full, jnp.asarray(case["tokens"]))
                out[shape, name, "decode"] = np.asarray(got)
                step = jax.jit(tr.make_decode_step(cfg, lr, seq_sharded=True))
                for n in C["lens"]:
                    full = {"k": jnp.asarray(case["k"]), "v": jnp.asarray(case["v"]), "len": jnp.int32(n)}
                    got, new = step(params, full, jnp.asarray(case["tokens"]))
                    out[shape, name, "seq", n] = (np.asarray(got), np.asarray(new["k"]))
                if name == "dense":
                    tok, lab = jnp.asarray(case["train"]["tokens"]), jnp.asarray(case["train"]["labels"])
                    loss, grads = jax.jit(jax.value_and_grad(lambda p: tr.loss_fn(cfg, lr, p, tok, lab)))(params)
                    out[shape, name, "grad"] = (float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)])
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    """
).replace("CONST", repr({"shapes": SHAPES, "lm_shapes": LM_SHAPES, "lens": DECODE_LENS}))
REPRO_TIMEOUT_S = 300
CHILD_ENV = {**{k: os.environ[k] for k in ("HOME", "PATH", "TMPDIR") if k in os.environ},
             "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_tp")
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
    """``repro_8_devices()``: ``repro``'s programs on each shape (4 of 8
    forced host devices), from a subprocess started when the fixture is
    made and waited for on first use."""
    d = inputs_path.parent
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(d / "repro.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", REPRO_SCRIPT, str(inputs_path), str(d / "repro.pkl")],
                                stdout=log, stderr=subprocess.STDOUT, env=CHILD_ENV, cwd=cwd)
    cache = []

    def get():
        if not cache:
            try:
                rc = proc.wait(timeout=REPRO_TIMEOUT_S)
            finally:
                proc.kill()
            assert rc == 0, f"repro's 8-device run failed:\n{(d / 'repro.log').read_text()}"
            with open(d / "repro.pkl", "rb") as f:
                cache.append(pickle.load(f))
        return cache[0]

    yield get
    proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def spawned(inputs_path, repro_8_devices):
    """Every rank's results by mesh shape, from one spawn."""
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
    return _cases(inputs, None, True)


def _ranks_of(spawned, shape) -> list:
    return [r[shape] for r in spawned if shape in r]


def _close(got, want, tol: float, what, floor: float = 0.0, where=None) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.abs(got - want)
    if where is not None:
        diff = diff[where]
    scale = max(np.abs(want).max(initial=0.0), floor, 1e-30)
    assert diff.max(initial=0.0) <= tol * scale, (what, diff.max(initial=0.0), tol * scale)


def _batch_rows(shape, coord, n: int = 2) -> slice:
    """A rank's rows of a batch of ``n``: blocked over data when it divides."""
    if n % shape[0]:
        return slice(0, n)
    k = n // shape[0]
    return slice(coord[0] * k, (coord[0] + 1) * k)


def _same_up_to_ties(idx, want_idx, all_scores, tol: float, what) -> None:
    """Top-k indices equal but where they tie: a differing index scores
    what the one ranked there scores, within ``tol`` of the largest."""
    differ = np.asarray(idx) != np.asarray(want_idx)
    gap = np.abs(all_scores[np.asarray(idx)[differ]] - all_scores[np.asarray(want_idx)[differ]]).max(initial=0.0)
    assert gap <= tol * np.abs(all_scores).max(), (what, gap)


# ---------------------------------------------------------------------------
# B7 on a kv-head offset (its plain twin; the kernel is held in test_torch_cuda.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset, heads, n_q", [(2, 2, 4), (5, 1, 2), (0, 0, 8), (3, 0, 5)])
def test_plain_decode_on_kv_head_offset_equals_contiguous_copy(dtype, offset, heads, n_q):
    """``flash_decode_gqa`` (and its partials) on kv groups ``[offset,
    offset + heads)`` of a whole 8-group cache, read as a view, equals it
    on a contiguous copy of those groups, bit for bit; on meta tensors its
    formulas count those groups' bytes only."""
    gen = torch.Generator().manual_seed(offset)
    k = torch.randn((2, 256, 8, 64), generator=gen).to(dtype)
    v = torch.randn((2, 256, 8, 64), generator=gen).to(dtype)
    q = torch.randn((2, n_q, 64), generator=gen).to(dtype)
    g = heads or 8 - offset
    ks, vs = k[:, :, offset : offset + g].contiguous(), v[:, :, offset : offset + g].contiguous()
    kv_len = torch.tensor(200, dtype=torch.int32)
    assert torch.equal(da.flash_decode_gqa(q, k, v, kv_len, 64, offset, heads), da.flash_decode_gqa(q, ks, vs, kv_len, 64))
    part = da.flash_decode_gqa_partials(q, k, v, kv_len, 64, 64, offset, heads)
    assert part.shape == (2, g, 1, n_q // g, 64)
    assert torch.equal(part.buf, da.flash_decode_gqa_partials(q, ks, vs, kv_len, 64, 64).buf)
    assert da.decode_work(q, k, v, kv_len, 64, offset, heads) == da.decode_work(q, ks, vs, kv_len, 64)
    assert da.partials_work(q, k, v, kv_len, 64, 64, offset, heads) == da.partials_work(q, ks, vs, kv_len, 64, 64)
    meta = da.flash_decode_gqa(q.to("meta"), k.to("meta"), v.to("meta"), kv_len, 64, offset, heads)
    assert meta.shape == q.shape and meta.is_meta
    with pytest.raises(ValueError):
        da.flash_decode_gqa(q, k, v, kv_len, 64, 7, 2)  # groups past the cache


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", LM_SHAPES)
def test_each_rank_holds_its_fitted_blocks(repro_8_devices, spawned, shape, name):
    """Every leaf a rank holds has the shape ``repro``'s placement fitted
    on the same mesh gives a device (whole where the model axis does not
    divide a dimension: ``odd``'s vocab of 211), and is the whole leaf's
    block at the rank's coordinate; q's heads over the model axis where 4
    or 2 divide them (``odd``'s 6 at 4 ranks are gathered whole)."""
    want = repro_8_devices()[shape, name, "blocks"]
    cfg = CONFIGS[name]()
    M = shape[1]
    for r in _ranks_of(spawned, shape):
        held = r[name, "held"]
        assert {k: v for k, v in held.items()} == want, (shape, name)
        assert r[name, "blocks_exact"]
        axis, heads, groups, vocab_whole = r[name, "tp"]
        assert axis == "model"
        m = r["coord"][1]
        n_heads = cfg.n_q_heads // M if cfg.n_q_heads % M == 0 else cfg.n_q_heads
        assert heads[1] - heads[0] == n_heads and (n_heads == cfg.n_q_heads or heads[0] == m * n_heads)
        assert vocab_whole == (cfg.padded_vocab % M != 0)
        assert held["['layers']['attn']['wq']"][2] == cfg.n_q_heads * cfg.d_head // M
        assert held["['embed']"][0] == (cfg.padded_vocab if vocab_whole else cfg.padded_vocab // M)
        r_kv = cfg.n_q_heads // cfg.n_kv_heads
        assert groups[0] == heads[0] // r_kv


@pytest.mark.parametrize("arch, ok_gb", [("qwen3-32b", 80), ("kimi-k2-1t-a32b", 80)])
def test_decode_32k_rank_arguments_fit_the_card(arch, ok_gb):
    """At (16, 16) the bytes of rank 0's decode_32k arguments (its
    ``RankPlan``'s meta blocks: the fitted weights, the cache's batch
    block with every kv head, the tokens) are the closed form and under
    the card's 80 GB: the dense weights 1/16 each, qwen3-32b's cache
    68.7 GB, kimi's experts 1/16 over the model axis and their d_ff over
    data."""
    layout = mesh_lib.make_production_mesh()
    D, M = layout.shape["data"], layout.shape["model"]
    cfg = registry.get_arch(arch).full()
    with mesh_lib.fake_mesh(layout) as m:
        plan = cells.build_cell(arch, "decode_32k", layout, m)
    got = sum(t.numel() * t.element_size() for t in leaves(plan.rank.args) if isinstance(t, torch.Tensor))
    dims = registry.LM_SHAPES["decode_32k"].dims
    item = torch.empty((), dtype=cfg.dtype).element_size()
    L, d, hq, hkv = cfg.n_layers, cfg.d_model, cfg.n_q_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    attn = L * (2 * d * hq + 2 * d * hkv) * item // M
    norms = L * 2 * d * 4 + (L * 2 * cfg.d_head * 4 if cfg.qk_norm else 0) + d * 4
    vocab = 2 * cfg.padded_vocab * d * item // M
    if cfg.is_moe:
        ff = cfg.d_ff // D if cfg.fsdp_experts else cfg.d_ff
        mlp = L * (3 * (cfg.n_experts // M) * d * ff * item + d * cfg.n_experts * 4)
    else:
        mlp = L * 3 * d * cfg.d_ff * item // M
    cache = 2 * L * (dims["batch"] // D) * dims["seq"] * hkv * item
    want = attn + norms + vocab + mlp + cache + dims["batch"] * 4 + 4
    assert got == want, (arch, got, want)
    assert got < ok_gb * 1e9, (arch, got)


# ---------------------------------------------------------------------------
# against the one-card run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", LM_SHAPES)
def test_forward_prefill_decode_equal_one_card(spawned, one_card, shape, name):
    """Forward logits, prefill logits and cache (the rank's rows, every kv
    head), and a decode step on a whole cache at len 7 (the rank's heads
    reading their kv groups in place) equal the one-card run's."""
    tol = _tol(name)
    for r in _ranks_of(spawned, shape):
        rows = _batch_rows(shape, r["coord"])
        _close(r[name, "forward"], one_card[name, "forward"], tol, (shape, name, "forward"))
        logits, k = r[name, "prefill"]
        _close(logits, one_card[name, "prefill"][0], tol, (shape, name, "prefill"))
        _close(k, one_card[name, "prefill"][1][:, rows], tol, (shape, name, "cache"))
        _close(r[name, "decode"], one_card[name, "decode"], tol, (shape, name, "decode"))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", LM_SHAPES)
def test_seq_sharded_decode_equals_one_card(spawned, one_card, shape, name):
    """The sequence-sharded decode (every head on the rank's positions,
    its rows of ``wo``) equals the one-card decode: logits and the rank's
    new cache positions."""
    tol = _tol(name)
    M = shape[1]
    for r in _ranks_of(spawned, shape):
        rows = _batch_rows(shape, r["coord"])
        lo = r["coord"][1] * (64 // M)
        for n in DECODE_LENS:
            logits, k = r[name, ("seq", n)]
            want_logits, want_k = one_card[name, ("seq", n)]
            _close(logits, want_logits, tol, (shape, name, n))
            _close(k, want_k[:, rows, lo : lo + 64 // M], tol, (shape, name, n, "cache"))


@pytest.mark.parametrize("name", TRAINED)
@pytest.mark.parametrize("shape", LM_SHAPES)
def test_gradient_and_train_step_equal_one_card(spawned, one_card, shape, name):
    """The loss, every gradient leaf (the rank's blocks summed over the
    batch axes and gathered whole) within 1e-5 of its largest (floored),
    and one ZeRO-1 AdamW step's parameters where the gradient passes 1e-3
    of its leaf's largest (elsewhere the step moves by ~lr × sign(g))."""
    want = one_card[name, "grads"]
    floor = FLOOR * max(np.abs(g).max() for g in want)
    for r in _ranks_of(spawned, shape):
        assert abs(r[name, "loss"] - one_card[name, "loss"]) <= TOL_F32 * abs(one_card[name, "loss"])
        for i, (g, w) in enumerate(zip(r[name, "grads"], want)):
            _close(g, w, TOL_F32, (shape, name, "grad", i), floor)
        loss, params = r[name, "step"]
        w_loss, w_params = one_card[name, "step"]
        assert abs(loss - w_loss) <= TOL_F32 * abs(w_loss)
        for i, (p, w, g) in enumerate(zip(params, w_params, want)):
            big = np.abs(g) > max(1e-3 * np.abs(g).max(), floor)
            _close(p, w, TOL_F32, (shape, name, "param", i), where=big)


@pytest.mark.parametrize("shape", LM_SHAPES)
def test_replicated_leaves_get_one_gradient_on_every_model_rank(spawned, shape):
    """A leaf every model rank holds whole (the norms, qk-norm) gets the
    same gradient on each of them, bit for bit: its cotangent entered the
    rank's blocks through ``collectives.enter``."""
    for name in TRAINED:
        by_data = {}
        for r in _ranks_of(spawned, shape):
            whole = [g for g, path in zip(r[name, "grads_held"], r[name, "held"]) if "norm" in path or "ln" in path]
            by_data.setdefault(r["coord"][0], []).append(whole)
        for group in by_data.values():
            for other in group[1:]:
                assert all(a.tobytes() == b.tobytes() for a, b in zip(group[0], other)), (shape, name)


@pytest.mark.parametrize("n", N_CANDIDATES)
@pytest.mark.parametrize("shape", SHAPES)
def test_retrieval_top64_equals_one_card_and_repro(repro_8_devices, spawned, one_card, shape, n):
    """Each rank scores its block of the candidates over every axis,
    fitted as ``repro`` fits them (512 over all four ranks; 510 over the
    data axis alone where it has 2 ranks, whole at (1, 4)), and the top 64
    of the gathered pairs equals the one-card top 64 and ``repro``'s up to
    ties, with scores within 1e-6 of the largest; the block is handed
    whole or as the rank's block alike."""
    all_scores = one_card["all_scores", n]
    w_scores, w_idx = one_card["retrieval", n][:2]
    r_scores, r_idx = repro_8_devices()[shape, "retrieval", n]
    n_ranks = {512: 4, 510: shape[0] if 510 % shape[0] == 0 and shape[0] > 1 else 1}[n]
    for r in _ranks_of(spawned, shape):
        scores, idx, (lo, hi, axes), wire = r["retrieval", n]
        assert hi - lo == n // n_ranks, (shape, n, lo, hi)
        assert (wire.get("all_gather", 0) == 2) == (n_ranks > 1)
        _close(scores, w_scores, 1e-6, (shape, n))
        _close(scores, r_scores, 1e-6, (shape, n, "repro"))
        _same_up_to_ties(idx, w_idx, all_scores, 1e-6, (shape, n))
        _same_up_to_ties(idx, r_idx, all_scores, 1e-6, (shape, n, "repro"))


def _np_block(w: np.ndarray, place, sizes: dict, coord: dict) -> np.ndarray:
    """``w``'s block under ``place`` at the rank's ``coord`` (axis ->
    coordinate), each placed dimension cut row-major over its axes."""
    for dim, entry in enumerate(place):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        n, idx = 1, 0
        for a in axes:
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        k = w.shape[dim] // n
        w = np.take(w, np.arange(idx * k, (idx + 1) * k), axis=dim)
    return w


def test_checkpoint_restores_tp_blocks_across_layouts(spawned):
    """A checkpoint of ``dense``'s tensor-parallel parameters and ZeRO-1
    moments saved at (2, 2) is the same whole tree on every rank, and
    restored at (1, 4) each rank holds exactly that layout's blocks of
    the saved leaves (the model-sharded leaves a quarter, cut at its
    model coordinate)."""
    saved = spawned[0]["checkpoint"]["saved"]
    cut = 0
    for r in spawned:
        assert all(a.tobytes() == b.tobytes() for a, b in zip(r["checkpoint"]["saved"], saved))
        d, m = r[1, 4]["coord"]
        for (block, place), w in zip(r["checkpoint"]["restored"], saved):
            want = _np_block(w, place, {"data": 1, "model": 4}, {"data": d, "model": m})
            assert block.shape == want.shape and block.tobytes() == want.tobytes(), place
            cut += block.shape != w.shape
    assert cut > 0


# ---------------------------------------------------------------------------
# against repro on the same mesh shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", LM_SHAPES)
def test_ranks_equal_repro(repro_8_devices, spawned, shape, name):
    """Forward, prefill, the whole-cache decode and the sequence-sharded
    decode of every rank against ``repro``'s on the same mesh shape, and
    for ``dense`` the loss and the gradient (``repro``'s chunked loss
    needs the vocab to divide over the model axis)."""
    want = repro_8_devices()
    tol = _tol(name)
    M = shape[1]
    for r in _ranks_of(spawned, shape):
        rows = _batch_rows(shape, r["coord"])
        _close(r[name, "forward"], want[shape, name, "forward"], tol, (shape, name, "forward"))
        logits, k = r[name, "prefill"]
        w_logits, w_k = want[shape, name, "prefill"]
        _close(logits, w_logits, tol, (shape, name, "prefill"))
        _close(k, w_k[:, rows], tol, (shape, name, "cache"))
        _close(r[name, "decode"], want[shape, name, "decode"], tol, (shape, name, "decode"))
        lo = r["coord"][1] * (64 // M)
        for n in DECODE_LENS:
            logits, k_new = r[name, ("seq", n)]
            w_logits, w_k = want[shape, name, "seq", n]
            _close(logits, w_logits, tol, (shape, name, n))
            _close(k_new, w_k[:, rows, lo : lo + 64 // M], tol, (shape, name, n, "cache"))
        if name == "dense":
            loss, grads = want[shape, name, "grad"]
            assert abs(r[name, "loss"] - loss) <= TOL_F32 * abs(loss)
            floor = FLOOR * max(np.abs(g).max() for g in grads)
            for i, (g, w) in enumerate(zip(r[name, "grads"], grads)):
                _close(g, w, TOL_F32, (shape, name, "repro grad", i), floor)
