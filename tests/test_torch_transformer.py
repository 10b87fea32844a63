"""The port's LM serving path against ``repro``'s on the CPU: the layers,
``forward``, ``make_prefill`` and ``make_decode_step`` on the smoke
configs (2 layers, d_model 64), with ``repro``'s parameters carried by
``interop.lm_params_from_numpy``.

Tolerances, as the largest |port - repro| over the largest |repro| of a
tensor: 1e-5 in f32 (the two frameworks sum products in other orders);
2e-2 in bf16, B7's bf16 tolerance (``tests/test_kernels.py``), since the
port's decode attention is B7's online softmax where ``repro``'s layer is
a plain softmax, and bf16 rounds at other places in the two.  The
decode's attention on the CPU is B7's plain version.

``repro``'s decode writes the cache with ``dynamic_update_slice_in_dim``,
which clamps its start: at ``len == max_len`` it overwrites the last slot
and reports ``len`` past the end, where the port raises (ROADMAP §C)."""

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
DENSE_ARCHS = ["qwen3-14b", "qwen3-32b", "internlm2-1.8b"]
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


@pytest.fixture(scope="module")
def models():
    """(repro config, port config, repro params, port params) per (arch,
    dtype), built once."""
    cache = {}

    def get(arch: str, dtype: str):
        if (arch, dtype) not in cache:
            jdt, tdt, _ = DTYPES[dtype]
            rcfg = dataclasses.replace(r_registry.get_arch(arch).smoke(), dtype=jdt)
            cfg = dataclasses.replace(registry.get_arch(arch).smoke(), dtype=tdt)
            rp = r_tr.init_params(rcfg, jax.random.key(0))
            p = interop.lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
            cache[arch, dtype] = (rcfg, cfg, rp, p)
        return cache[arch, dtype]

    return get


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_and_rope(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    got = layers.rmsnorm(tx, torch.from_numpy(scale))
    assert got.dtype == tdt
    _close(got, r_layers.rmsnorm(jx, jnp.asarray(scale)), tol)
    got = layers.rope(tx, torch.from_numpy(pos))
    assert got.dtype == tdt
    _close(got, r_layers.rope(jx, jnp.asarray(pos)), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "sq, skv, q_chunk, kv_chunk, causal, q_offset",
    [(32, 32, 32, 32, True, 0), (37, 37, 16, 8, True, 0), (9, 40, 4, 16, False, 0),
     (12, 30, 8, 16, True, 18)],
)
def test_chunked_attention(dtype, sq, skv, q_chunk, kv_chunk, causal, q_offset):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset)
    want = r_layers.chunked_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), **kw)
    got = layers.chunked_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    assert got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s, kv_len", [(64, 8), (64, 64), (1040, 1030)])
def test_decode_attention_runs_b7(dtype, s, kv_len):
    """The layer runs B7 (its plain version here) with a block dividing
    S, 1,040 included (the chip phase's request cache)."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s)
    q = rng.normal(size=(2, 1, 8, 64)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 64)).astype(np.float32)
    want = r_layers.decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.int32(kv_len))
    got = layers.decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.tensor(kv_len, dtype=torch.int32)
    )
    assert got.dtype == tdt and got.shape == (2, 1, 8, 64)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_proj_and_mlp(models, dtype):
    rcfg, cfg, rp, p = models("qwen3-14b", dtype)
    _, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    jx, tx = jnp.asarray(x, rcfg.dtype), torch.from_numpy(x).to(tdt)
    r_attn = jax.tree.map(lambda a: a[0], rp["layers"]["attn"])
    attn = {k: v[0] for k, v in p["layers"]["attn"].items()}
    want = r_layers.apply_attention_proj(r_attn, jx, 4, 2, 16, jnp.asarray(pos), R_RULES)
    got = layers.apply_attention_proj(attn, tx, 4, 2, 16, torch.from_numpy(pos), RULES)
    for g, w in zip(got, want):
        _close(g, w, tol)
    r_mlp = jax.tree.map(lambda a: a[0], rp["layers"]["mlp"])
    mlp = {k: v[0] for k, v in p["layers"]["mlp"].items()}
    _close(layers.apply_mlp(mlp, tx, RULES), r_layers.apply_mlp(r_mlp, jx, R_RULES), tol)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_params_has_repro_tree_shapes_and_dtypes(arch):
    rcfg, cfg = r_registry.get_arch(arch).smoke(), registry.get_arch(arch).smoke()
    want = jax.tree_util.tree_flatten_with_path(r_tr.param_shapes(rcfg))[0]
    got = tr.init_params(cfg, seed=0, device="cpu")
    assert len(want) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in want:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path


def test_init_params_is_seeded():
    cfg = registry.get_arch("qwen3-14b").smoke()
    a, b = tr.init_params(cfg, 3, "cpu"), tr.init_params(cfg, 3, "cpu")
    c = tr.init_params(cfg, 4, "cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"], c["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"][0], a["layers"]["attn"]["wq"][1])


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_repro(models, arch, dtype):
    rcfg, cfg, rp, p = models(arch, dtype)
    toks = r_lm_common.lm_smoke_batch(rcfg, "prefill")["tokens"]
    want = r_tr.forward(rcfg, R_RULES, rp, toks)
    got = tr.forward(cfg, RULES, p, torch.from_numpy(np.array(toks)))
    assert got.shape == (2, 32, cfg.padded_vocab)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_matches_repro(models, arch, dtype):
    rcfg, cfg, rp, p = models(arch, dtype)
    tol = DTYPES[dtype][2]
    toks = r_lm_common.lm_smoke_batch(rcfg, "prefill")["tokens"]
    ptoks = lm_common.lm_smoke_batch(cfg, "prefill", device="cpu")["tokens"]
    assert np.array_equal(np.asarray(toks), ptoks.numpy())
    r_logits, r_cache = jax.jit(r_tr.make_prefill(rcfg, R_RULES))(rp, toks)
    logits, cache = tr.make_prefill(cfg, RULES)(p, ptoks)
    assert logits.shape == (2, cfg.padded_vocab) and logits.dtype == cfg.dtype
    _close(logits, r_logits, tol)
    for name in ("k", "v"):
        assert cache[name].dtype == cfg.dtype
        _close(cache[name], r_cache[name], tol)
    assert int(cache["len"]) == int(r_cache["len"]) == 32


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_step_matches_repro(models, arch, dtype):
    """One step from ``lm_smoke_batch``'s decode cache (len 7)."""
    rcfg, cfg, rp, p = models(arch, dtype)
    tol = DTYPES[dtype][2]
    rb = r_lm_common.lm_smoke_batch(rcfg, "decode")
    b = lm_common.lm_smoke_batch(cfg, "decode", device="cpu")
    assert int(b["cache"]["len"]) == 7 and np.array_equal(np.asarray(rb["tokens"]), b["tokens"].numpy())
    r_logits, r_cache = jax.jit(r_tr.make_decode_step(rcfg, R_RULES))(rp, rb["cache"], rb["tokens"])
    logits, cache = tr.make_decode_step(cfg, RULES)(p, b["cache"], b["tokens"])
    _close(logits, r_logits, tol)
    for name in ("k", "v"):
        assert cache[name] is b["cache"][name]  # written in place
        _close(cache[name], r_cache[name], tol)
    assert int(cache["len"]) == int(r_cache["len"]) == 8


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_greedy_decode_after_prefill(models, dtype):
    """Prefill, the cache copied into a 40-long buffer, then 6 greedy
    steps fed the same tokens on both sides; every step's logits and the
    final cache agree."""
    rcfg, cfg, rp, p = models("qwen3-14b", dtype)
    tol = DTYPES[dtype][2]
    toks = lm_common.lm_smoke_batch(cfg, "prefill", device="cpu")["tokens"]
    r_logits, r_pre = jax.jit(r_tr.make_prefill(rcfg, R_RULES))(rp, jnp.asarray(toks.numpy()))
    logits, pre = tr.make_prefill(cfg, RULES)(p, toks)
    r_cache = r_tr.init_cache(rcfg, 2, 40)
    r_cache = {"k": r_cache["k"].at[:, :, :32].set(r_pre["k"]),
               "v": r_cache["v"].at[:, :, :32].set(r_pre["v"]), "len": r_pre["len"]}
    cache = tr.init_cache(cfg, 2, 40, device="cpu")
    cache["k"][:, :, :32] = pre["k"]
    cache["v"][:, :, :32] = pre["v"]
    cache["len"] = pre["len"]
    r_step, step = jax.jit(r_tr.make_decode_step(rcfg, R_RULES)), tr.make_decode_step(cfg, RULES)
    for _ in range(6):
        nxt = logits[:, : cfg.vocab].float().argmax(-1).to(torch.int32)
        r_logits, r_cache = r_step(rp, r_cache, jnp.asarray(nxt.numpy()))
        logits, cache = step(p, cache, nxt)
        _close(logits, r_logits, tol)
    for name in ("k", "v"):
        _close(cache[name], r_cache[name], tol)
    assert int(cache["len"]) == int(r_cache["len"]) == 38


def test_decode_on_full_cache_raises_where_repro_clamps(models):
    """At len == max_len ``repro``'s ``dynamic_update_slice_in_dim``
    clamps the write to the last slot and returns len max_len + 1; the
    port's indexed write raises instead."""
    rcfg, cfg, rp, p = models("qwen3-14b", "f32")
    rb = r_lm_common.lm_smoke_batch(rcfg, "decode")
    r_cache = dict(rb["cache"], len=jnp.int32(64))
    _, r_new = r_tr.make_decode_step(rcfg, R_RULES)(rp, r_cache, rb["tokens"])
    assert int(r_new["len"]) == 65
    r_k = np.asarray(r_new["k"])
    assert np.abs(r_k[:, :, 63]).max() > 0 and np.abs(r_k[:, :, :63]).max() == 0  # slot 63 overwritten
    b = lm_common.lm_smoke_batch(cfg, "decode", device="cpu")
    b["cache"]["len"] = torch.tensor(64, dtype=torch.int32)
    with pytest.raises(IndexError, match="full"):
        tr.make_decode_step(cfg, RULES)(p, b["cache"], b["tokens"])
    assert not b["cache"]["k"].any()  # nothing written
