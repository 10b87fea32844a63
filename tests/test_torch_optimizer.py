"""The port's optimizers against ``repro``'s on the CPU: ``adamw`` and
``adafactor`` over three updates of a tree of f32 and bf16 leaves of
ranks 0 to 3, from ``repro``'s initial state carried by
``interop.opt_state_from_numpy``, with the same gradients each step; the
state placements (``state_spec_for``, each optimizer's ``state_spec``)
and ``zero_sharding`` against ``repro``'s specs.

Tolerances: f32 parameters and moments within 1e-6 of the largest
|value| of their leaf (the two frameworks' ``pow``, ``sqrt`` and fused
element-wise code round apart by an ulp); bf16 parameters equal or one
bf16 ulp apart (an f32 value an ulp apart can round to the neighbouring
bf16)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.training import optimizer as r_opt

from repro_torch import interop
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import leaves, leaves_with_paths

torch.set_num_threads(2)

# (path in the tree, shape, dtype)
LEAVES = [((), "f32"), ((5,), "bf16"), ((4, 6), "f32"), ((3, 4, 5), "bf16"), ((2, 3, 4), "f32"),
          ((7,), "f32"), ((6, 2), "bf16")]


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _tree(rng, scale: float = 1.0):
    """{"a": leaf 0, "blocks": [{"w": .., "b": ..}, ..], "z": (leaf)} of
    LEAVES as numpy arrays (bf16 as ml_dtypes)."""
    arrs = []
    for shape, dt in LEAVES:
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        arrs.append(a.astype(jnp.bfloat16) if dt == "bf16" else a)
    return {"a": arrs[0], "blocks": [{"w": arrs[2], "b": arrs[1]}, {"w": arrs[3], "b": arrs[5]}],
            "z": {"k": arrs[4], "q": arrs[6]}}


def _to_port(tree):
    return interop.gnn_params_from_numpy({"layers": [tree]}, "cpu")["layers"][0]


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy().astype(np.int32)
        w = want.view(np.int16).astype(np.int32)
        assert np.abs(g - w).max() <= 1, what
        return
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= 1e-6 * scale, what


@pytest.mark.parametrize("lr", [3e-4, 0.05])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_repro(name, lr):
    rng = np.random.default_rng(0 if name == "adamw" else 1)
    r_optimizer, optimizer = r_opt.get(name, lr=lr), opt.get(name, lr=lr)
    params_np = _tree(rng)
    r_params = jax.tree.map(jnp.asarray, params_np)
    r_state = r_optimizer.init(r_params)
    params = _to_port(params_np)
    state = interop.opt_state_from_numpy(jax.tree.map(np.asarray, r_state), "cpu")
    # the port's own init is repro's, leaf for leaf
    own = optimizer.init(params)
    assert [p for p, _ in leaves_with_paths(own)] == [
        "/".join(str(k) for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(r_state)[0]]
    for a, b in zip(leaves(own), jax.tree.leaves(r_state)):
        assert a.dtype == (torch.int32 if b.dtype == jnp.int32 else torch.float32)
        assert np.array_equal(a.numpy(), np.asarray(b))
    for step in range(3):
        grads_np = _tree(rng, scale=10.0 ** (step - 1))
        r_params, r_state = r_optimizer.update(r_params, jax.tree.map(jnp.asarray, grads_np), r_state)
        params, state = optimizer.update(params, _to_port(grads_np), state)
        for (path, got), want in zip(leaves_with_paths(params), jax.tree.leaves(r_params)):
            _close(got, want, f"step {step} param {path}")
        for (path, got), want in zip(leaves_with_paths(state), jax.tree.leaves(r_state)):
            if path.endswith("['step']"):
                assert int(got) == int(want) == step + 1 and got.dtype == torch.int32
            else:
                _close(got, want, f"step {step} state {path}")


def test_update_is_in_place_under_no_grad():
    """The returned trees hold the caller's tensors, and the update
    records no autograd history."""
    params = {"w": torch.ones(3, 2, requires_grad=True), "b": torch.zeros(2)}
    optimizer = opt.adamw(lr=0.1)
    state = optimizer.init(params)
    w, m = params["w"], state["m"]["w"]
    new, new_state = optimizer.update(params, {"w": torch.ones(3, 2), "b": torch.ones(2)}, state)
    assert new["w"] is w and new_state["m"]["w"] is m and w.grad_fn is None
    assert not torch.equal(w.detach(), torch.ones(3, 2)) and int(new_state["step"]) == 1


def test_get_refuses_an_unknown_name():
    with pytest.raises(ValueError):
        opt.get("sgd")
    with pytest.raises(ValueError):
        opt.state_spec_for("sgd", {}, {})


# (repro spec, port placement, shape) of a parameter tree's leaves
SPECS = {
    "embed": (P("model", None), ("model", None), (256, 64)),
    "layers": [
        {"w": (P(None, None, "model"), (None, None, "model"), (2, 64, 128)),
         "moe": (P(None, "model", None, None), (None, "model", None, None), (2, 4, 64, 32)),
         "norm": (P(None), (None,), (64,))},
    ],
    "bias": (P(), (), (48,)),
    "scale": (P(), (), ()),
    "short": (P("data"), ("data",), (16, 8, 3)),
}


def _split(tree, i):
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_split(v, i) for v in tree]
    return tree[i]


def _as_tuples(tree):
    """repro's spec tree with each PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    return tuple(tree) if isinstance(tree, P) else tree


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_placements_equal_repro(name):
    r_specs, specs = _split(SPECS, 0), _split(SPECS, 1)
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), _split(SPECS, 2),
                          is_leaf=lambda x: isinstance(x, tuple))
    metas = jax.tree.map(lambda s: torch.empty(s, device="meta"), _split(SPECS, 2),
                         is_leaf=lambda x: isinstance(x, tuple))
    want = r_opt.state_spec_for(name, shapes, r_specs)
    assert opt.state_spec_for(name, metas, specs) == _as_tuples(want)
    want = r_opt.get(name).state_spec(r_specs)
    assert opt.get(name).state_spec(specs) == _as_tuples(want)


@pytest.mark.parametrize("spec, shape", [
    ((None, None), (32, 8)), (("model", None), (32, 8)), (("model",), (32, 48)), ((), (15, 7)),
    ((None,), (0, 16)), (("model", None, None), (4, 30, 64)), ((), ()),
])
def test_zero_sharding_equals_repro(spec, shape):
    for size in (16, 4):
        want = r_opt.zero_sharding(P(*spec), shape, data_size=size)
        assert opt.zero_sharding(spec, shape, data_size=size) == tuple(want)
