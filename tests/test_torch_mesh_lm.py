"""The models' last mesh programs over ``gloo`` ranks on the CPU: the
expert-parallel MoE layer (``layers.apply_moe`` on an installed mesh),
the LMs per rank (the batch blocked over the batch axes, MoE layers
expert-parallel, kimi-k2's ``fsdp_experts`` gathers), the decode step on
a KV cache sharded along the sequence over the model axis
(``make_decode_step(seq_sharded=True)`` on B7's partials and combine)
and ``equiformer_energy_big``, each against the port's one-card run
where one exists and against ``repro`` under ``shd.use_mesh`` on the
same mesh shape of 4 of 8 forced host devices.  B7's plain partials and
combine are held to ``flash_decode_gqa_plain`` here too.

One spawn of 4 ``gloo`` ranks runs every case on (4, 1), (2, 2) and
(1, 4) ``(data, model)`` meshes; one ``repro`` subprocess runs the same
cases on the same shapes beside it.  Inputs are drawn once here with
numpy (the LMs' and EquiformerV2's weights by the port's inits, carried
as numpy) and handed to both.

Tolerances, as the largest |difference| over the largest |value|:
* f32 MoE layers and f32 LMs 2e-5 (``repro``'s ``test_multidevice.py``
  holds its expert-parallel layer to 2e-5): the frameworks and the ranks
  sum products in other orders;
* B7's plain partials and combine: bit for bit on one shard at offset 0,
  1e-6 (f32) and 1e-2 (bf16) over 4 shards, whose merge rounds p against
  other running maxes;
* ``equiformer_energy_big``: 2e-3 against ``repro``'s (bf16 node state
  and accumulator: a sum or product may round to another bf16 value on
  each side, and the rounding carries through the layers; 4e-5 seen),
  the same energy on every rank of a mesh, and 5e-3 against its plain
  twin on one card, ``equiformer_atoms_big_plain`` (whose sums run in
  f32, where the path adds chunk by chunk into bf16): the energy (8e-4
  seen) and each rank's per-atom energies (1.3e-3 seen); the twin's
  energy is within 2e-3 of ``repro``'s (8e-4 seen).

The expert-parallel layer drops assignments past its capacities; at the
capacity factor 1.25 the test input's router is skewed so that some do,
and the layer's output must equal ``moe_capacity_plain``'s (the kept
assignments, worked out on one card) and ``repro``'s: an assignment kept
on one side and dropped on the other moves a token's output by a whole
expert term, far past the tolerance.
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
from repro_torch.configs import kimi_k2_1t_a32b, registry
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.kernels.decode_attn import decode_attn as da
from repro_torch.launch import ranks
from repro_torch.models import gnn, layers
from repro_torch.models import transformer as tr

torch.set_num_threads(1)

SHAPES = [(4, 1), (2, 2), (1, 4)]
WORLD = 4
SPAWN_TIMEOUT_S = 300
TOL = 2e-5
BIG_TOL_REPRO, BIG_TOL_PLAIN = 2e-3, 5e-3
CAPACITIES = (4.0, 1.25)
MOE = {"E": 8, "D": 32, "F": 16, "k": 2, "B": 4, "S": 16}
LM_ARCHS = {"granite": "granite-moe-1b-a400m", "kimi": "kimi-k2-1t-a32b", "qwen": "qwen3-14b"}
DECODE_LENS = (7, 40)  # pos 7: inside the first shard at every M; pos 40: past the first half
BIG_NODES, BIG_EDGES, BIG_CHUNK = 64, 256, 32


def _lm_cfg(name: str):
    cfg = registry.get_arch(LM_ARCHS[name]).smoke()
    if name == "kimi":  # the smoke config with kimi's FSDP experts
        cfg = dataclasses.replace(cfg, fsdp_experts=True, sharding_overrides=kimi_k2_1t_a32b.SHARDING_OVERRIDES)
    return cfg


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v) for v in tree]
    return _numpy(tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    E, D, F, B, S = MOE["E"], MOE["D"], MOE["F"], MOE["B"], MOE["S"]
    # a shared direction in every token that experts 0 and 1 (model rank 0
    # at M = 4) favour: capacity 1.25 drops assignments on every shape
    common = rng.normal(size=D)
    x = (rng.normal(size=(B, S, D)) + common).astype(np.float32)
    router = rng.normal(size=(D, E)) / np.sqrt(D)
    router[:, :2] += 1.5 * common[:, None] / np.square(common).sum()
    router = router.astype(np.float32)
    moe = {"router": router,
           "w_gate": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32),
           "w_up": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32),
           "w_down": (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(np.float32)}
    lms = {}
    for name in LM_ARCHS:
        cfg = _lm_cfg(name)
        L, G, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
        lms[name] = {
            "params": _tree(tr.init_params(cfg, seed=1, device="cpu")),
            "prompts": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32),
            "tokens": rng.integers(0, cfg.vocab, (2,)).astype(np.int32),
            "k": rng.normal(size=(L, 2, 64, G, Dh)).astype(np.float32),
            "v": rng.normal(size=(L, 2, 64, G, Dh)).astype(np.float32),
        }
    ecfg = registry.get_arch("equiformer-v2").smoke()
    n, e = BIG_NODES, BIG_EDGES
    big = {"species": rng.integers(0, ecfg.n_species, n).astype(np.int32),
           "positions": (rng.random((n, 3)) * 4.0).astype(np.float32),
           "node_mask": np.arange(n) < n - 3,
           "edge_src": rng.integers(0, n, e).astype(np.int32),
           "edge_dst": rng.integers(0, n, e).astype(np.int32),
           "edge_mask": np.arange(e) % 7 != 3}
    return {"moe": moe, "x": x, "lm": lms, "big": big,
            "equiformer": _tree(gnn.equiformer_init(ecfg, seed=2, device="cpu"))}


# ---------------------------------------------------------------------------
# the cases, per rank or on one card
# ---------------------------------------------------------------------------


def _np_out(x):
    if isinstance(x, torch.Tensor):
        return _numpy(x.detach().contiguous())
    return tuple(_np_out(v) for v in x)


def _lm_cases(name: str, case: dict, mesh) -> dict:
    """Prefill and one decode step of a smoke LM (the decode from a random
    64-long cache at len 7), and for the dense one the sequence-sharded
    decode at each of DECODE_LENS; on ``mesh``, each rank on its block of
    the batch and its share of the cache and experts."""
    cfg = _lm_cfg(name)
    rules = tr.rules_for(cfg, mesh)
    params = interop.lm_params_from_numpy(case["params"], "cpu")
    out = {}
    with shd.use_mesh(mesh):
        mine = tr.shard_params(cfg, rules, params)
        if cfg.is_moe:  # the rank's experts as interop cuts them from repro's numpy
            by_interop = interop.moe_expert_shard_from_numpy(case["params"]["layers"]["moe"], rules,
                                                             cfg.fsdp_experts, "cpu")
            out["shard"] = ({k: tuple(v.shape) for k, v in by_interop.items()},
                            all(torch.equal(mine["layers"]["moe"][k], v) for k, v in by_interop.items()))
        logits, cache = tr.make_prefill(cfg, rules)(mine, _t(case["prompts"]))
        out["prefill"] = (_np_out(logits), _np_out(cache["k"]))
        full = {"k": _t(case["k"]), "v": _t(case["v"]), "len": torch.tensor(7, dtype=torch.int32)}
        step_logits, _ = tr.make_decode_step(cfg, rules)(mine, tr.cache_shard(cfg, rules, full), _t(case["tokens"]))
        out["decode"] = _np_out(step_logits)
        if not cfg.is_moe:
            for n in DECODE_LENS:
                full = {"k": _t(case["k"]), "v": _t(case["v"]), "len": torch.tensor(n, dtype=torch.int32)}
                shard = tr.cache_shard(cfg, rules, full, seq_sharded=True)
                got, new = tr.make_decode_step(cfg, rules, seq_sharded=True)(mine, shard, _t(case["tokens"]))
                out["seq", n] = (_np_out(got), _np_out(new["k"]), tuple(shard["k"].shape), int(new["len"]))
    return out


def _mesh_cases(inputs: dict, mesh) -> dict:
    """Every case on ``mesh`` (``None``: one card), as numpy."""
    out = {}
    p = {k: _t(v) for k, v in inputs["moe"].items()}
    x = _t(inputs["x"])
    rules = shd.Rules.from_mesh(mesh)
    with shd.use_mesh(mesh):
        mine = layers.moe_shard(p, rules)
        for cf in CAPACITIES:
            collectives.WIRE_COUNTERS.clear()
            got = layers.apply_moe(mine, x, n_experts=MOE["E"], top_k=MOE["k"], rules=rules, capacity_factor=cf)
            out["moe", cf] = (_np_out(got), dict(collectives.WIRE_COUNTERS))
            if mesh is not None:
                want, kept = layers.moe_capacity_plain(p, x, n_experts=MOE["E"], top_k=MOE["k"], rules=rules,
                                                       capacity_factor=cf)
                out["moe_plain", cf] = (_np_out(want), int((~kept).sum()))
    for name, case in inputs["lm"].items():
        for key, val in _lm_cases(name, case, mesh).items():
            out[name, key] = val
    ecfg = registry.get_arch("equiformer-v2").smoke()
    eparams = interop.gnn_params_from_numpy(inputs["equiformer"], "cpu")
    batch = {k: _t(v) for k, v in inputs["big"].items()}
    if mesh is None:  # the large-graph path's plain twin: every node's energy
        out["big_atoms"] = _np_out(gnn.equiformer_atoms_big_plain(ecfg, eparams, batch))
    else:
        real_chunk, gnn._BIG_CHUNK = gnn._BIG_CHUNK, BIG_CHUNK
        try:
            with shd.use_mesh(mesh):
                out["big"] = _np_out(gnn.equiformer_energy_big(ecfg, rules, eparams, batch))
                out["big_atoms"] = _np_out(gnn.equiformer_atoms_big(ecfg, rules, eparams, batch))
        finally:
            gnn._BIG_CHUNK = real_chunk
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
            res[shape] = _mesh_cases(inputs, mesh)
            res[shape]["coord"] = tuple(mesh.get_coordinate())
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
    from repro.configs import kimi_k2_1t_a32b, registry
    from repro.dist import compat
    from repro.dist import sharding as shd
    from repro.models import gnn, layers
    from repro.models import transformer as tr

    assert len(jax.devices()) == 8
    with open(sys.argv[1], "rb") as f:
        inputs = pickle.load(f)
    gnn._BIG_CHUNK = CONST["chunk"]
    tree = lambda t: jax.tree.map(jnp.asarray, t)
    archs = CONST["archs"]
    out = {}
    for shape in CONST["shapes"]:
        mesh = compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[:4])
        rules = shd.Rules.from_mesh(mesh)
        with shd.use_mesh(mesh):
            for cf in CONST["capacities"]:
                fn = jax.jit(lambda p, x: layers.apply_moe(p, x, n_experts=CONST["E"], top_k=CONST["k"],
                                                           rules=rules, capacity_factor=cf))
                out[shape, "moe", cf] = np.asarray(fn(tree(inputs["moe"]), jnp.asarray(inputs["x"])))
            for name, case in inputs["lm"].items():
                cfg = registry.get_arch(archs[name]).smoke()
                if name == "kimi":
                    cfg = dataclasses.replace(cfg, fsdp_experts=True,
                                              sharding_overrides=kimi_k2_1t_a32b.SHARDING_OVERRIDES)
                cfg = dataclasses.replace(cfg, remat=False)
                lr = tr.rules_for(cfg, mesh)
                params = tree(case["params"])
                logits, cache = jax.jit(tr.make_prefill(cfg, lr))(params, jnp.asarray(case["prompts"]))
                out[shape, name, "prefill"] = (np.asarray(logits), np.asarray(cache["k"]))
                full = {"k": jnp.asarray(case["k"]), "v": jnp.asarray(case["v"]), "len": jnp.int32(7)}
                got, _ = jax.jit(tr.make_decode_step(cfg, lr))(params, full, jnp.asarray(case["tokens"]))
                out[shape, name, "decode"] = np.asarray(got)
                if not cfg.is_moe:
                    step = jax.jit(tr.make_decode_step(cfg, lr, seq_sharded=True))
                    for n in CONST["lens"]:
                        full = {"k": jnp.asarray(case["k"]), "v": jnp.asarray(case["v"]), "len": jnp.int32(n)}
                        got, new = step(params, full, jnp.asarray(case["tokens"]))
                        out[shape, name, "seq", n] = (np.asarray(got), np.asarray(new["k"]))
            ecfg = registry.get_arch("equiformer-v2").smoke()
            big = jax.jit(lambda p, b: gnn.equiformer_energy_big(ecfg, rules, p, b))
            out[shape, "big"] = np.asarray(big(tree(inputs["equiformer"]), tree(inputs["big"])))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    """
).replace("CONST", repr({"chunk": BIG_CHUNK, "archs": LM_ARCHS, "shapes": SHAPES, "capacities": CAPACITIES,
                             "lens": DECODE_LENS, "E": MOE["E"], "k": MOE["k"]}))
REPRO_TIMEOUT_S = 300
CHILD_ENV = {**{k: os.environ[k] for k in ("HOME", "PATH", "TMPDIR") if k in os.environ},
             "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_lm")
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
    """``repro_8_devices()``: ``repro``'s programs on each shape of
    SHAPES (4 of 8 forced host devices), from a subprocess started when
    the fixture is made and waited for (at most ``REPRO_TIMEOUT_S``) on
    first use."""
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
    """Every rank's results by mesh shape, from one spawn (``repro``'s
    run starts first and runs beside it)."""
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
    return _mesh_cases(inputs, None)


def _close(got, want, tol: float, what) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, (what, err, tol * scale)


def _batch_rows(shape, coord, n: int = 2) -> slice:
    """A rank's rows of a batch of ``n``: blocked over data when it divides."""
    n_data = shape[0]
    if n % n_data:
        return slice(0, n)
    k = n // n_data
    return slice(coord[0] * k, (coord[0] + 1) * k)


# ---------------------------------------------------------------------------
# B7's plain partials and combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_partials_and_combine(dtype):
    """One shard at offset 0: partials then combine equal
    ``flash_decode_gqa_plain`` bit for bit at every kv_len; 4 shards of
    256 within 1e-6 (f32) or 1e-2 (bf16); a shard wholly past kv_len
    gives (-1e30, 0, 0); a global kv_len of 0 gives V's mean over all S
    (each shard's every position at -1e30)."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 8, 64), generator=gen).to(dtype)
    k = torch.randn((2, 1024, 2, 64), generator=gen).to(dtype)
    v = torch.randn((2, 1024, 2, 64), generator=gen).to(dtype)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    for n in (1024, 1000, 300, 5, 0):
        kv_len = torch.tensor(n, dtype=torch.int32)
        want = da.flash_decode_gqa_plain(q, k, v, kv_len)
        one = da.flash_decode_gqa_partials(q, k, v, kv_len)
        assert one.m.shape == (2, 2, 1, 4) and one.acc.shape == (2, 2, 1, 4, 64)
        assert torch.equal(da.flash_decode_combine(one, dtype), want), n
        shards = [da.flash_decode_gqa_partials(q, k[:, i * 256 : (i + 1) * 256].contiguous(),
                                               v[:, i * 256 : (i + 1) * 256].contiguous(), kv_len, i * 256, 256)
                  for i in range(4)]
        for i, s in enumerate(shards):
            if 0 < n <= i * 256:
                assert (s.m == -1e30).all() and (s.l == 0).all() and (s.acc == 0).all(), (n, i)
        merged = da.ranks_major(torch.stack([s.buf for s in shards]), shards[0].shape)
        assert merged.m.shape == (2, 2, 4, 4) and torch.equal(merged.acc[:, :, 2], shards[2].acc[:, :, 0])
        got = da.flash_decode_combine(merged, dtype)
        _close(got.float(), want.float(), tol, n)
        if n == 0:
            mean = v.float().mean(dim=1).repeat_interleave(4, dim=1)  # (B, H, Dh): each q row its group's mean
            _close(got.float(), mean, tol, "V's mean")


# ---------------------------------------------------------------------------
# against the one-card run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_expert_parallel_layer_equals_one_card_and_capacity_plain(spawned, one_card, inputs, shape):
    """At capacity 4.0 nothing drops and every rank's output is the
    one-card layer's and ``moe_dense``'s within 2e-5; at 1.25 some
    assignments drop and every rank's output is ``moe_capacity_plain``'s;
    three ``all_to_all``s a layer over the model axis."""
    p = {k: _t(v) for k, v in inputs["moe"].items()}
    dense = _np_out(layers.moe_dense(p, _t(inputs["x"]), n_experts=MOE["E"], top_k=MOE["k"]))
    for r in (r[shape] for r in spawned):
        got, wire = r["moe", 4.0]
        assert r["moe_plain", 4.0][1] == 0
        _close(got, one_card["moe", 4.0][0], TOL, shape)
        _close(got, dense, TOL, shape)
        got, wire = r["moe", 1.25]
        want, dropped = r["moe_plain", 1.25]
        assert dropped > 0, shape
        _close(got, want, TOL, shape)
        assert wire["all_to_all"] == 3
        if shape[0] == 4:  # the whole batch, on every rank of a one-rank model axis
            assert dropped == spawned[0][shape]["moe_plain", 1.25][1]


@pytest.mark.parametrize("shape", SHAPES)
def test_seq_sharded_decode_equals_one_card(spawned, one_card, shape):
    """The dense smoke LM's decode step on a 64-long cache sharded along
    the sequence over the model axis: each rank holds 64 / M positions of
    its block of the batch, the new position is written by its owner
    only, and the logits equal the one-card decode's within 2e-5, with
    kv_len inside the first shard (8) and past half the cache (41)."""
    for r in (r[shape] for r in spawned):
        coord = r["coord"]
        rows = _batch_rows(shape, coord)
        M = shape[1]
        cfg = _lm_cfg("qwen")
        for n in DECODE_LENS:
            logits, k_new, held, new_len = r["qwen", ("seq", n)]
            want_logits, want_k = one_card["qwen", ("seq", n)][:2]
            assert held == (cfg.n_layers, rows.stop - rows.start, 64 // M, cfg.n_kv_heads, cfg.d_head)
            assert new_len == n + 1
            _close(logits, want_logits, TOL, (shape, n))
            s_loc = 64 // M
            lo = coord[1] * s_loc
            _close(k_new, want_k[:, rows, lo : lo + s_loc], TOL, (shape, n, "cache"))


@pytest.mark.parametrize("shape", SHAPES)
def test_lm_prefill_and_decode_per_rank(spawned, one_card, shape):
    """The three smoke LMs per rank: the rank's experts are the ones
    ``interop`` cuts from ``repro``'s numpy (kimi's d_ff block too), its
    prefill cache its block of the batch, and the dense LM's prefill and
    decode logits the one-card run's within 2e-5 (the MoE LMs' may drop
    at capacity 1.25: held to ``repro`` below)."""
    for r in (r[shape] for r in spawned):
        rows = _batch_rows(shape, r["coord"])
        for name in LM_ARCHS:
            cfg = _lm_cfg(name)
            logits, k = r[name, "prefill"]
            assert logits.shape == (2, cfg.padded_vocab)
            assert k.shape[1] == rows.stop - rows.start
            if cfg.is_moe:
                shapes, agree = r[name, "shard"]
                e_loc = cfg.n_experts // shape[1]
                ff = cfg.d_ff // shape[0] if cfg.fsdp_experts else cfg.d_ff
                assert agree and shapes["w_gate"] == (cfg.n_layers, e_loc, cfg.d_model, ff)
                assert shapes["w_down"] == (cfg.n_layers, e_loc, ff, cfg.d_model)
            else:
                _close(logits, one_card[name, "prefill"][0], TOL, (shape, name))
                _close(k, one_card[name, "prefill"][1][:, rows], TOL, (shape, name))
                _close(r[name, "decode"], one_card[name, "decode"], TOL, (shape, name))


@pytest.mark.parametrize("shape", SHAPES)
def test_big_equiformer_per_rank(spawned, one_card, shape):
    """``equiformer_energy_big`` at the smoke config on 64 nodes and 256
    edges (1 in 7 masked, 3 nodes masked) in chunks of 32 edges: the same
    energy on every rank, within BIG_TOL_PLAIN of its plain twin's on one
    card, and each rank's per-atom energies (``equiformer_atoms_big``, its
    resting rows) within BIG_TOL_PLAIN of the twin's at those rows."""
    want = one_card["big_atoms"]
    n_m = BIG_NODES // shape[1]
    n_rest = n_m // shape[0]
    got = [r[shape]["big"] for r in spawned]
    for r in spawned:
        g, (d, m) = r[shape]["big"], r[shape]["coord"]
        assert g.shape == (1,) and np.isfinite(g).all()
        assert g.tobytes() == got[0].tobytes()
        _close(g, want.sum(dtype=np.float64)[None], BIG_TOL_PLAIN, shape)
        lo = m * n_m + d * n_rest
        _close(r[shape]["big_atoms"], want[lo : lo + n_rest], BIG_TOL_PLAIN, (shape, d, m))


@pytest.mark.parametrize("shape", SHAPES)
def test_big_equiformer_plain_equals_repro(repro_8_devices, one_card, shape):
    """The plain twin's energy (``equiformer_atoms_big_plain`` summed) is
    ``repro``'s ``equiformer_energy_big`` on each mesh shape, within
    BIG_TOL_REPRO."""
    _close(one_card["big_atoms"].sum(dtype=np.float64)[None], repro_8_devices()[shape, "big"], BIG_TOL_REPRO, shape)


# ---------------------------------------------------------------------------
# against repro on the same mesh shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_ranks_equal_repro(repro_8_devices, spawned, shape):
    """``repro``'s expert-parallel layer at both capacities (so its drops
    are the port's), the three smoke LMs' prefill and decode logits and
    prefill caches (kimi with ``fsdp_experts``), the dense LM's
    sequence-sharded decode and its new cache, and
    ``equiformer_energy_big``, each on the same mesh shape, against every
    rank at the tolerances above."""
    want = repro_8_devices()
    for r in (r[shape] for r in spawned):
        rows = _batch_rows(shape, r["coord"])
        for cf in CAPACITIES:
            _close(r["moe", cf][0], want[shape, "moe", cf], TOL, (shape, cf))
        for name in LM_ARCHS:
            logits, k = r[name, "prefill"]
            w_logits, w_k = want[shape, name, "prefill"]
            _close(logits, w_logits, TOL, (shape, name))
            _close(k, w_k[:, rows], TOL, (shape, name))
            _close(r[name, "decode"], want[shape, name, "decode"], TOL, (shape, name))
        M = shape[1]
        for n in DECODE_LENS:
            logits, k_new = r["qwen", ("seq", n)][:2]
            w_logits, w_k = want[shape, "qwen", "seq", n]
            _close(logits, w_logits, TOL, (shape, n))
            lo = r["coord"][1] * (64 // M)
            _close(k_new, w_k[:, rows, lo : lo + 64 // M], TOL, (shape, n))
        _close(r["big"], want[shape, "big"], BIG_TOL_REPRO, (shape, "big"))
