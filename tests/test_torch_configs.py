"""The port's configs, input specs, synthetic data and sharding rules
against ``repro``'s: every ported config's ``full()`` and ``smoke()``
field for field (JAX dtypes mapped to torch's, ``PartitionSpec`` to
tuples), the shape tables, the input specs (meta tensors against
``ShapeDtypeStruct``), the smoke batches and the four
``data/pipeline.py`` batches byte for byte, and ``Rules`` off-mesh and,
through ``repro``'s pure ``_default_table`` and ``_fit``, on layouts of
several devices."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import alibaba_rpq as r_alibaba_rpq
from repro.configs import dlrm_mlperf as r_dlrm_mlperf
from repro.configs import lm_common as r_lm_common
from repro.configs import registry as r_registry
from repro.data import pipeline as r_pipeline
from repro.dist import sharding as r_shd

from repro_torch.configs import alibaba_rpq, dlrm_mlperf, lm_common, registry
from repro_torch.data import pipeline
from repro_torch.dist import sharding as shd

ARCHS = [
    "alibaba-rpq", "dlrm-mlperf", "equiformer-v2", "gcn-cora", "granite-moe-1b-a400m",
    "internlm2-1.8b", "kimi-k2-1t-a32b", "nequip", "qwen3-14b", "qwen3-32b", "schnet",
]
LM_ARCHS = [a for a in ARCHS if registry.get_arch(a).family == "lm"]
ACCESSORS = [
    "act_btd", "act_bthd", "act_ffn", "logits", "p_attn_in", "p_attn_out", "p_mlp_in",
    "p_mlp_out", "p_moe_experts", "p_router", "p_embed", "p_lm_head", "p_table_rows",
    "kv_cache", "kv_cache_seq_sharded", "edges",
]
LAYOUTS = {"data4_model2": (("data", "model"), (4, 2)), "pod2_data2_model4": (("pod", "data", "model"), (2, 2, 4)),
           "data8": (("data",), (8,))}
SHAPES = [(256, 4096, 5120), (3, 7), (152064, 5120), (2, 128, 32768, 8, 128), (49155,), ()]


def _value(v):
    """A config field in a form both packages share: dtypes by name."""
    if isinstance(v, torch.dtype):
        return str(v).split(".")[-1]
    if isinstance(v, tuple):
        return tuple(_value(x) for x in v)
    if isinstance(v, type):  # numpy and jax.numpy scalar types
        return np.dtype(v).name
    return v


def _fields(cfg) -> dict:
    return {f.name: _value(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


def _spec(p) -> tuple:
    return tuple(p)


def _layout(names, sizes):
    """A device layout as ``Rules.from_mesh`` reads one: axis names and sizes."""
    return types.SimpleNamespace(axis_names=tuple(names), shape=dict(zip(names, sizes)))


def _tree(spec):
    """A spec tree's leaves as (shape, dtype name)."""
    if isinstance(spec, dict):
        return {k: _tree(v) for k, v in spec.items()}
    if isinstance(spec, torch.Tensor):
        assert spec.device.type == "meta"
        return tuple(spec.shape), str(spec.dtype).split(".")[-1]
    return tuple(spec.shape), np.dtype(spec.dtype).name


def test_registry_lists_the_ported_archs():
    assert registry.list_archs() == ARCHS == r_registry.list_archs()


@pytest.mark.parametrize("table", ["LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "RPQ_SHAPES"])
def test_shape_tables(table):
    got, want = getattr(registry, table), getattr(r_registry, table)
    assert {k: dataclasses.astuple(v) for k, v in got.items()} == {
        k: dataclasses.astuple(v) for k, v in want.items()
    }


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_repro(arch, which):
    got, want = registry.get_arch(arch), r_registry.get_arch(arch)
    assert got.family == want.family and got.notes == want.notes
    assert sorted(got.shapes) == sorted(want.shapes)
    g, w = getattr(got, which)(), getattr(want, which)()
    assert type(g).__name__ == type(w).__name__
    assert _fields(g) == _fields(w)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_config_derived_counts(arch):
    g, w = registry.get_arch(arch).full(), r_registry.get_arch(arch).full()
    assert (g.padded_vocab, g.is_moe, g.param_count(), g.active_param_count()) == (
        w.padded_vocab, w.is_moe, w.param_count(), w.active_param_count()
    )


@pytest.mark.parametrize("shape", list(registry.LM_SHAPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_input_specs(arch, shape):
    cfg, rcfg = registry.get_arch(arch).full(), r_registry.get_arch(arch).full()
    got = lm_common.lm_input_specs(cfg, registry.LM_SHAPES[shape])
    want = r_lm_common.lm_input_specs(rcfg, r_registry.LM_SHAPES[shape])
    assert _tree(got) == _tree(want)


@pytest.mark.parametrize("shape", list(registry.RECSYS_SHAPES))
def test_dlrm_input_specs(shape):
    got = dlrm_mlperf.input_specs(dlrm_mlperf.full(), registry.RECSYS_SHAPES[shape])
    want = r_dlrm_mlperf.input_specs(r_dlrm_mlperf.full(), r_registry.RECSYS_SHAPES[shape])
    assert _tree(got) == _tree(want)


@pytest.mark.parametrize("shape", list(registry.RPQ_SHAPES))
def test_rpq_input_specs(shape):
    if "batch" not in registry.RPQ_SHAPES[shape].dims:
        with pytest.raises(KeyError):
            alibaba_rpq.input_specs(alibaba_rpq.full(), registry.RPQ_SHAPES[shape], 1024)
        return
    got = alibaba_rpq.input_specs(alibaba_rpq.full(), registry.RPQ_SHAPES[shape], 1024)
    want = r_alibaba_rpq.input_specs(r_alibaba_rpq.full(), r_registry.RPQ_SHAPES[shape], 1024)
    assert _tree(got) == _tree(want)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lm_smoke_batch(kind):
    cfg = registry.get_arch("qwen3-14b").smoke()
    got = lm_common.lm_smoke_batch(cfg, kind, seed=3, device="cpu")
    want = r_lm_common.lm_smoke_batch(r_registry.get_arch("qwen3-14b").smoke(), kind, seed=3)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, w in flat:
        g = got
        for key in path:
            g = g[key.key]
        assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name
        assert np.array_equal(g.numpy(), np.asarray(w)), path


@pytest.mark.parametrize("kind", ["train", "serve", "retrieval"])
def test_dlrm_smoke_batch(kind):
    got = dlrm_mlperf.smoke_batch(dlrm_mlperf.smoke(), kind, seed=2, device="cpu")
    want = r_dlrm_mlperf.smoke_batch(r_dlrm_mlperf.smoke(), kind, seed=2)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].numpy().tobytes() == np.asarray(w).tobytes() and got[k].shape == w.shape, k


def _same_bytes(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("args", [(211, 4, 32, 0), (151936, 8, 64, 5, 3, 1, 2), (92544, 3, 17, 2, 9)])
def test_lm_batch_byte_identical(args):
    _same_bytes(pipeline.lm_batch(*args, device="cpu"), r_pipeline.lm_batch(*args))


@pytest.mark.parametrize("multi_hot, batch, step", [(1, 512, 0), (3, 64, 7)])
def test_dlrm_batch_byte_identical(multi_hot, batch, step):
    sizes = dlrm_mlperf.full().table_sizes
    _same_bytes(pipeline.dlrm_batch(sizes, 13, multi_hot, batch, step, seed=4, device="cpu"),
                r_pipeline.dlrm_batch(sizes, 13, multi_hot, batch, step, seed=4))


def test_cora_like_batch_byte_identical():
    _same_bytes(pipeline.cora_like_batch(300, 1200, 40, 7, seed=1, device="cpu"),
                r_pipeline.cora_like_batch(300, 1200, 40, 7, seed=1))


def test_molecules_batch_byte_identical():
    _same_bytes(pipeline.molecules_batch(6, 30, 64, seed=2, device="cpu"),
                r_pipeline.molecules_batch(6, 30, 64, seed=2))


@pytest.mark.parametrize("accessor", ACCESSORS)
def test_rules_off_mesh(accessor):
    got, want = shd.Rules.from_mesh(None), r_shd.Rules.from_mesh(None)
    assert getattr(got, accessor)() == _spec(getattr(want, accessor)())
    assert (got.batch, got.model_size, got.batch_axes, got.model_axis) == (
        want.batch, want.model_size, want.batch_axes, want.model_axis
    )
    for shape in SHAPES:
        assert got.spec(accessor, shape) == _spec(want.spec(accessor, shape))
        assert shd.fit_spec(None, getattr(got, accessor)(), shape) == _spec(
            r_shd.fit_spec(None, getattr(want, accessor)(), shape)
        )


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rules_on_a_layout(layout):
    """The port's rules for a layout of several devices resolve and fit
    every accessor as ``repro``'s pure table and fitting do."""
    names, sizes = LAYOUTS[layout]
    axis_sizes = dict(zip(names, sizes))
    rules = shd.Rules.from_mesh(_layout(names, sizes))
    batch_axes = tuple(n for n in names if n in ("pod", "data"))
    batch = None if not batch_axes else batch_axes[0] if len(batch_axes) == 1 else batch_axes
    model = "model" if "model" in names else None
    flat = batch_axes + ((model,) if model else ())
    table = r_shd._default_table(batch, model, flat or None)
    assert rules.table == tuple((pat, _spec(p)) for pat, p in table)
    assert (rules.batch, rules.model_size) == (batch, axis_sizes.get("model", 0))
    for accessor in ACCESSORS:
        spec = getattr(rules, accessor)()
        for shape in SHAPES:
            want = _spec(r_shd._fit(axis_sizes, spec, shape))
            assert rules.fit(spec, shape) == want, (accessor, shape)
            for dim in range(len(shape)):
                assert rules.spec_divisor(want, dim) == int(np.prod(
                    [axis_sizes[n] for n in r_shd._entry_names(want[dim])] or [1]))


def test_rules_overrides_win():
    from repro.configs import kimi_k2_1t_a32b as r_kimi
    from repro_torch.configs import kimi_k2_1t_a32b as kimi
    from repro_torch.models import transformer as tr

    rules = tr.rules_for(kimi.full(), _layout(("pod", "data", "model"), (2, 4, 8)))
    assert rules.table[:3] == tuple((pat, _spec(p)) for pat, p in r_kimi.SHARDING_OVERRIDES)
    assert rules.spec("params/layers/moe/w_down") == (None, "model", ("pod", "data"), None)
    assert rules.spec("params/layers/moe/w_up", (61, 384, 7168, 2048)) == _spec(
        r_shd._fit({"pod": 2, "data": 4, "model": 8}, r_kimi.SHARDING_OVERRIDES[1][1], (61, 384, 7168, 2048))
    )


def test_use_mesh_refuses_a_mesh():
    with shd.use_mesh(None) as m:
        assert m is None and shd.get_mesh() is None
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        with shd.use_mesh(_layout(("data",), (4,))):
            pass
    x = torch.ones(3)
    assert shd.constrain(x, ("data",)) is x
