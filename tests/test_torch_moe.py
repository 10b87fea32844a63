"""The port's MoE layer and the MoE LMs against ``repro``'s on the CPU:
``init_moe``'s tree, ``apply_moe`` (the one-card branch, computed on
the routed rows) against ``repro``'s ``_moe_local`` (dense over every
expert) and against the port's dense twin ``moe_dense``, and
``forward``, ``make_prefill`` and ``make_decode_step`` on granite-moe's
and kimi-k2's smoke configs (2 layers, d_model 64, 4 experts top-2),
with one set of weights carried into both (``interop.lm_params_from_numpy``
on the port's side).

Tolerances, as the largest |port - repro| over the largest |repro| of a
tensor: 1e-5 in f32 (the frameworks sum products in other orders); 2e-2
in bf16, the transformer tests' (bf16 rounds at other places in the two,
and the decode's attention is B7's online softmax).  The routed
implementation and the dense twin run the same products on the same
rows, so they agree to 1e-6 in f32.

Routing is a discontinuous choice: where a token's k-th and (k+1)-th
router logits lie within rounding of each other, a rounding apart picks
another expert, and that token's output then differs by far more than
any tolerance.  By default XLA keeps bf16 intermediates of a fusion in
f32 (excess precision), which moves the smoke configs' second-layer
router logits by up to ~0.02 against a run that rounds every op to
bf16, as PyTorch does; that flips near ties.  So ``repro``'s whole
models are compiled with ``xla_allow_excess_precision`` off, which
rounds every op as an op-by-op run does (bit for bit on these configs),
with ``remat`` off (remat only changes gradients)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import lm_common as r_lm_common
from repro.configs import registry as r_registry
from repro.dist import sharding as r_shd
from repro.models import layers as r_layers
from repro.models import transformer as r_tr

from repro_torch import interop
from repro_torch.configs import lm_common, registry
from repro_torch.dist import sharding as shd
from repro_torch.models import layers
from repro_torch.models import transformer as tr

torch.set_num_threads(2)

R_RULES = r_shd.Rules.from_mesh(None)
RULES = shd.Rules.from_mesh(None)
MOE_ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol: float) -> None:
    """max |got - want| <= tol x max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _reference(fn, *args):
    """``fn(*args)`` of ``repro``, compiled with every op rounded to its
    dtype (module docstring)."""
    compiled = jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as numpy; bf16 as ``ml_dtypes``' bfloat16, the
    form ``np.asarray`` gives of a JAX bf16 array."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def models():
    """(repro config, port config, repro params, port params) per (arch,
    dtype), built once.  One set of weights on both sides: drawn by the
    port's ``init_params`` (whose tree is ``repro``'s, checked below), as
    numpy arrays handed to ``repro`` and carried into the port by
    ``interop``; ``repro``'s own init draws every leaf op by op, seconds
    on the CPU."""
    cache = {}

    def get(arch: str, dtype: str):
        if (arch, dtype) not in cache:
            jdt, tdt, _ = DTYPES[dtype]
            rcfg = dataclasses.replace(r_registry.get_arch(arch).smoke(), dtype=jdt, remat=False)
            cfg = dataclasses.replace(registry.get_arch(arch).smoke(), dtype=tdt)
            tree = jax.tree.map(_numpy, tr.init_params(cfg, seed=0, device="cpu"))
            rp = jax.tree.map(jnp.asarray, tree)
            p = interop.lm_params_from_numpy(tree, "cpu")
            cache[arch, dtype] = (rcfg, cfg, rp, p)
        return cache[arch, dtype]

    return get


def _moe_inputs(dtype: str, seed: int, t: int = 24, d: int = 64, f: int = 48, e: int = 6):
    """A MoE layer's weights and a (2, t / 2, d) input drawn with numpy:
    (repro's, the port's) of each."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    w = {
        "router": rng.normal(size=(d, e)).astype(np.float32) / np.sqrt(d),
        "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) / np.sqrt(d),
        "w_up": rng.normal(size=(e, d, f)).astype(np.float32) / np.sqrt(d),
        "w_down": rng.normal(size=(e, f, d)).astype(np.float32) / np.sqrt(f),
    }
    x = rng.normal(size=(2, t // 2, d)).astype(np.float32)
    rp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt) for k, v in w.items()}
    p = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else tdt) for k, v in w.items()}
    return (rp, jnp.asarray(x, jdt)), (p, torch.from_numpy(x).to(tdt))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_init_moe_tree_shapes_and_dtypes(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    want = r_layers.init_moe(jax.random.key(0), 64, 48, 6, jdt)
    gen = torch.Generator().manual_seed(0)
    got = layers.init_moe(gen, 64, 48, 6, tdt, lead=(3,))
    assert list(got) == list(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == (3,) + leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
    # each draw is N(0, 1/fan_in), as repro's
    assert abs(float(got["w_down"].float().std()) - 1 / np.sqrt(48)) < 0.02


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_moe_matches_repro_moe_local(dtype, top_k, seed):
    """The same experts chosen, and outputs within the dtype's tolerance
    of ``repro``'s dense ``_moe_local``."""
    (rp, jx), (p, x) = _moe_inputs(dtype, seed)
    tol = DTYPES[dtype][2]
    r_logits = jx.reshape(-1, 64).astype(jnp.float32) @ rp["router"]
    r_w, r_idx = jax.lax.top_k(r_logits, top_k)
    w, idx = layers._route(p, x.reshape(-1, 64), top_k)
    assert np.array_equal(idx.numpy(), np.asarray(r_idx))
    _close(w, jax.nn.softmax(r_w, axis=-1), 1e-6)
    want = r_layers._moe_local(rp, jx, n_experts=6, top_k=top_k)
    got = layers.apply_moe(p, x, n_experts=6, top_k=top_k, rules=RULES)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, want, tol)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_routed_equals_dense_twin(dtype, seed):
    """The routed rows against every expert on every token: the same
    products of the same rows, summed over k in the same order."""
    _, (p, x) = _moe_inputs(dtype, seed, t=40, e=8)
    got = layers.apply_moe(p, x, n_experts=8, top_k=3, rules=RULES)
    want = layers.moe_dense(p, x, n_experts=8, top_k=3)
    _close(got, want, 1e-6 if dtype == "f32" else 1e-2)


def test_apply_moe_with_experts_left_without_rows():
    """Two tokens, top-1 of 6 experts: most experts get no row."""
    _, (p, x) = _moe_inputs("f32", 5, t=2)
    got = layers.apply_moe(p, x, n_experts=6, top_k=1, rules=RULES)
    _close(got, layers.moe_dense(p, x, n_experts=6, top_k=1), 1e-6)


def test_apply_moe_refuses_a_model_axis():
    """Rules with a model axis but no installed mesh run the one-card
    layer, as ``repro``'s ``apply_moe`` does (``mesh is None``): the
    expert-parallel program runs only on an installed ``DeviceMesh``
    (``tests/test_torch_mesh_lm.py``)."""
    _, (p, x) = _moe_inputs("f32", 0)
    layout = type("Layout", (), {"axis_names": ("data", "model"), "shape": {"data": 2, "model": 2}})
    want = layers.moe_dense(p, x, n_experts=6, top_k=2)
    got = layers.apply_moe(p, x, n_experts=6, top_k=2, rules=shd.Rules.from_mesh(layout))
    _close(got, want, 1e-6)
    # repro's own apply_moe takes the same branch for these rules and no mesh
    (rp, jx), _ = _moe_inputs("f32", 0)
    layout_r = type("Layout", (), {"axis_names": ("data", "model"), "shape": {"data": 2, "model": 2}})
    r_got = r_layers.apply_moe(rp, jx, n_experts=6, top_k=2, rules=r_shd.Rules.from_mesh(layout_r))
    _close(got, r_got, 1e-5)
    # a layout without a model axis runs the one-card layer, as repro's
    data_only = type("Layout", (), {"axis_names": ("data",), "shape": {"data": 4}})
    got = layers.apply_moe(p, x, n_experts=6, top_k=2, rules=shd.Rules.from_mesh(data_only))
    _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# the MoE LMs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_has_repro_tree_shapes_and_dtypes(arch):
    rcfg, cfg = r_registry.get_arch(arch).smoke(), registry.get_arch(arch).smoke()
    want = jax.tree_util.tree_flatten_with_path(r_tr.param_shapes(rcfg))[0]
    got = tr.init_params(cfg, seed=0, device="cpu")
    assert "moe" in got["layers"] and "mlp" not in got["layers"]
    assert len(want) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in want:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path


def test_interop_refuses_a_layer_tree_it_does_not_know(models):
    _, _, rp, _ = models("granite-moe-1b-a400m", "f32")
    tree = jax.tree.map(np.asarray, rp)
    tree["layers"]["mlp"] = tree["layers"]["moe"]
    with pytest.raises(KeyError, match="mlp or moe"):
        interop.lm_params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_repro(models, arch, dtype):
    rcfg, cfg, rp, p = models(arch, dtype)
    toks = r_lm_common.lm_smoke_batch(rcfg, "prefill")["tokens"]
    want = _reference(lambda p, t: r_tr.forward(rcfg, R_RULES, p, t), rp, toks)
    got = tr.forward(cfg, RULES, p, torch.from_numpy(np.array(toks)))
    assert got.shape == (2, 32, cfg.padded_vocab)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_matches_repro(models, arch, dtype):
    rcfg, cfg, rp, p = models(arch, dtype)
    tol = DTYPES[dtype][2]
    toks = r_lm_common.lm_smoke_batch(rcfg, "prefill")["tokens"]
    ptoks = lm_common.lm_smoke_batch(cfg, "prefill", device="cpu")["tokens"]
    r_logits, r_cache = _reference(r_tr.make_prefill(rcfg, R_RULES), rp, toks)
    logits, cache = tr.make_prefill(cfg, RULES)(p, ptoks)
    assert logits.shape == (2, cfg.padded_vocab) and logits.dtype == cfg.dtype
    _close(logits, r_logits, tol)
    for name in ("k", "v"):
        _close(cache[name], r_cache[name], tol)
    assert int(cache["len"]) == int(r_cache["len"]) == 32


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_matches_repro(models, arch, dtype):
    """One step from ``lm_smoke_batch``'s decode cache (len 7)."""
    rcfg, cfg, rp, p = models(arch, dtype)
    tol = DTYPES[dtype][2]
    rb = r_lm_common.lm_smoke_batch(rcfg, "decode")
    b = lm_common.lm_smoke_batch(cfg, "decode", device="cpu")
    r_logits, r_cache = _reference(r_tr.make_decode_step(rcfg, R_RULES), rp, rb["cache"], rb["tokens"])
    logits, cache = tr.make_decode_step(cfg, RULES)(p, b["cache"], b["tokens"])
    _close(logits, r_logits, tol)
    for name in ("k", "v"):
        assert cache[name] is b["cache"][name]  # written in place
        _close(cache[name], r_cache[name], tol)
    assert int(cache["len"]) == int(r_cache["len"]) == 8


def test_greedy_decode_after_prefill(models):
    """kimi-k2's smoke config in f32: prefill, the cache copied into a
    40-long buffer, then 4 greedy steps fed the same tokens on both
    sides; every step's logits and the final cache agree."""
    rcfg, cfg, rp, p = models("kimi-k2-1t-a32b", "f32")
    tol = DTYPES["f32"][2]
    toks = lm_common.lm_smoke_batch(cfg, "prefill", device="cpu")["tokens"]
    r_logits, r_pre = jax.jit(r_tr.make_prefill(rcfg, R_RULES))(rp, jnp.asarray(toks.numpy()))
    logits, pre = tr.make_prefill(cfg, RULES)(p, toks)
    r_cache = r_tr.init_cache(rcfg, 2, 40)
    r_cache = {"k": r_cache["k"].at[:, :, :32].set(r_pre["k"]),
               "v": r_cache["v"].at[:, :, :32].set(r_pre["v"]), "len": r_pre["len"]}
    cache = tr.init_cache(cfg, 2, 40, device="cpu")
    cache["k"][:, :, :32], cache["v"][:, :, :32], cache["len"] = pre["k"], pre["v"], pre["len"]
    r_step, step = jax.jit(r_tr.make_decode_step(rcfg, R_RULES)), tr.make_decode_step(cfg, RULES)
    for _ in range(4):
        nxt = logits[:, : cfg.vocab].float().argmax(-1).to(torch.int32)
        r_logits, r_cache = r_step(rp, r_cache, jnp.asarray(nxt.numpy()))
        logits, cache = step(p, cache, nxt)
        _close(logits, r_logits, tol)
    for name in ("k", "v"):
        _close(cache[name], r_cache[name], tol)
    assert int(cache["len"]) == int(r_cache["len"]) == 36
