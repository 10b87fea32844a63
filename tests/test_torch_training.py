"""The port's training substrate on the CPU: ``repro``'s
``tests/test_fault_tolerance.py`` cases on the port (crash and resume
bit-identical, a torn checkpoint ignored, a restore round trip into a
meta tree, prune, int8 compression with error feedback), and
checkpoints across the packages: an f32 checkpoint written by either
restores in the other, and a bf16 one written by either restores in the
port, where ``repro``'s restore raises (ROADMAP §C).

GCN's smoke config and batch, AdamW, as ``repro``'s test."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as r_registry
from repro.models import gnn as r_gnn
from repro.training import checkpoint as r_checkpoint
from repro.training import compression as r_compression
from repro.training import optimizer as r_opt

from repro_torch import interop
from repro_torch.configs import gnn_common, registry
from repro_torch.dist import sharding as shd
from repro_torch.models import gnn
from repro_torch.training import checkpoint, compression, loop
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, leaves_with_paths, tree_map

torch.set_num_threads(2)

RULES = shd.Rules.from_mesh(None)


def _setup():
    cfg = registry.get_arch("gcn-cora").smoke()
    batch = gnn_common.gnn_smoke_batch(True, device="cpu")

    def init_fn():
        params = gnn.gcn_init(cfg, seed=0, device="cpu")
        return params, opt_lib.get("adamw").init(params)

    step = gnn.make_gnn_train_step(cfg, RULES)
    return init_fn, step, lambda s: batch


def _equal_trees(a, b) -> None:
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_crash_and_resume_is_bit_identical(tmp_path):
    init_fn, step, batch_fn = _setup()
    # uninterrupted run
    ref = loop.run(init_fn=init_fn, train_step=step, batch_fn=batch_fn, n_steps=12)
    assert ref.losses[-1] < ref.losses[0]
    # crashing run: fails at step 7, then resumes from the step-5 checkpoint
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        loop.run(
            init_fn=init_fn, train_step=step, batch_fn=batch_fn, n_steps=12,
            ckpt_dir=ck, ckpt_every=5, crash_at_step=7,
        )
    resumed = loop.run(
        init_fn=init_fn, train_step=step, batch_fn=batch_fn, n_steps=12,
        ckpt_dir=ck, ckpt_every=5,
    )
    assert resumed.start_step == 5 and resumed.end_step == 12 and len(resumed.losses) == 7
    assert resumed.losses == ref.losses[5:]
    _equal_trees(ref.params, resumed.params)
    _equal_trees(ref.opt_state, resumed.opt_state)


def test_torn_checkpoint_ignored(tmp_path):
    init_fn, step, batch_fn = _setup()
    ck = str(tmp_path / "ck")
    loop.run(init_fn=init_fn, train_step=step, batch_fn=batch_fn, n_steps=4,
             ckpt_dir=ck, ckpt_every=2)
    # fake a torn write: step dir without COMMIT
    os.makedirs(os.path.join(ck, "step_00000099"))
    assert checkpoint.latest_step(ck) == 4
    assert checkpoint.latest_step(str(tmp_path / "none")) is None


def test_elastic_restore_roundtrip(tmp_path):
    """Save, then restore into a meta tree of the same structure: every
    leaf's values, dtype and shape, on the requested device."""
    init_fn, _, _ = _setup()
    params, opt_state = init_fn()
    d = str(tmp_path / "ck")
    checkpoint.save(d, 3, (params, opt_state))
    like = tree_map(lambda t: t.to("meta"), (params, opt_state))
    p2, o2 = checkpoint.restore(d, 3, like, device="cpu")
    _equal_trees(params, p2)
    _equal_trees(opt_state, o2)
    assert o2["step"].shape == () and o2["step"].dtype == torch.int32


def test_checkpoint_prune(tmp_path):
    init_fn, _, _ = _setup()
    state = init_fn()
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(d, s, state)
    checkpoint.prune(d, keep=2)
    assert checkpoint.latest_step(d) == 5
    kept = [n for n in os.listdir(d) if n.startswith("step_")]
    assert sorted(kept) == ["step_00000004", "step_00000005"]


def test_restore_onto_a_mesh_raises(tmp_path):
    """Off a mesh ``shardings`` of ``None`` entries restores whole leaves;
    a placement tree that does not match the leaves raises (the placed
    restore over ranks: ``tests/test_torch_mesh_train.py``)."""
    init_fn, _, _ = _setup()
    state = init_fn()
    d = str(tmp_path / "ck")
    checkpoint.save(d, 1, state)
    got = checkpoint.restore(d, 1, state, shardings=tree_map(lambda t: None, state))
    for a, b in zip(leaves(got), leaves(state)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="placements"):
        checkpoint.restore(d, 1, state, shardings=[None])


def test_compression_error_feedback_converges():
    """int8 + error feedback: the *cumulative* compressed sum tracks the
    true sum (the residual stays bounded)."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    residual = torch.zeros_like(g_true)
    acc_c = torch.zeros_like(g_true)
    acc_t = torch.zeros_like(g_true)
    for step in range(50):
        g = g_true * (1.0 + 0.1 * np.sin(step))
        g_fb = g + residual
        q, scale = compression.compress(g_fb)
        deq = compression.decompress(q, scale)
        residual = g_fb - deq
        acc_c = acc_c + deq
        acc_t = acc_t + g
    rel = float(torch.linalg.norm(acc_c - acc_t) / torch.linalg.norm(acc_t))
    assert rel < 1e-2
    # wire payload is int8: 4x smaller than f32
    assert q.dtype == torch.int8


def test_compress_equals_repro():
    rng = np.random.default_rng(1)
    for g in (rng.normal(size=(300,)) * 3, np.zeros(5), rng.normal(size=(4, 7)) * 1e-3):
        g = g.astype(np.float32)
        r_q, r_scale = r_compression.compress(jnp.asarray(g))
        q, scale = compression.compress(torch.from_numpy(g))
        assert np.array_equal(q.numpy(), np.asarray(r_q))
        assert float(scale) == float(r_scale)
        assert np.array_equal(compression.decompress(q, scale).numpy(),
                              np.asarray(r_compression.decompress(r_q, r_scale)))


def test_compressed_psum_waits_for_the_mesh_and_residuals_are_zero():
    """``compressed_psum`` sums over an axis of ranks: without a mesh it
    raises (over ranks: ``tests/test_torch_mesh_train.py``)."""
    with pytest.raises(ValueError, match="DeviceMesh"):
        compression.compressed_psum(torch.ones(3), torch.zeros(3), "data")
    params = {"w": torch.ones(2, 3, dtype=torch.bfloat16), "b": [torch.ones(4)]}
    res = compression.init_residuals(params)
    assert res["w"].dtype == torch.float32 and res["w"].shape == (2, 3) and not res["b"][0].any()


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _repro_state():
    """repro's GCN smoke parameters and AdamW state after one update (so
    the moments are not zero), and the port's copy of them."""
    rcfg = r_registry.get_arch("gcn-cora").smoke()
    params = r_gnn.gcn_init(rcfg, jax.random.key(0))
    r_optimizer = r_opt.get("adamw")
    state = r_optimizer.init(params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), params)
    params, state = r_optimizer.update(params, grads, state)
    port = (interop.gnn_params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
            interop.opt_state_from_numpy(jax.tree.map(np.asarray, state), "cpu"))
    return (params, state), port


def _same(port_tree, repro_tree) -> None:
    r_flat = jax.tree_util.tree_flatten_with_path(repro_tree)[0]
    p_flat = leaves_with_paths(port_tree)
    assert [p for p, _ in p_flat] == ["/".join(str(k) for k in path) for path, _ in r_flat]
    for (p, x), (_, y) in zip(p_flat, r_flat):
        y = np.asarray(y)
        if x.dtype == torch.bfloat16:
            assert np.array_equal(x.view(torch.int16).numpy(), y.view(np.int16)), p
        else:
            assert str(x.dtype).split(".")[-1] == y.dtype.name and np.array_equal(x.numpy(), y), p


def test_f32_checkpoint_written_by_repro_restores_in_the_port(tmp_path):
    r_tree, port = _repro_state()
    d = str(tmp_path / "ck")
    r_checkpoint.save(d, 7, r_tree)
    assert checkpoint.latest_step(d) == 7
    got = checkpoint.restore(d, 7, tree_map(lambda t: torch.empty_like(t), port))
    _same(got, r_tree)


def test_f32_checkpoint_written_by_the_port_restores_in_repro(tmp_path):
    r_tree, port = _repro_state()
    d = str(tmp_path / "ck")
    checkpoint.save(d, 7, port)
    manifest = json.load(open(os.path.join(d, "step_00000007", "manifest.json")))
    r_dir = str(tmp_path / "r_ck")
    r_checkpoint.save(r_dir, 7, r_tree)
    assert manifest == json.load(open(os.path.join(r_dir, "step_00000007", "manifest.json")))
    assert r_checkpoint.latest_step(d) == 7
    got = r_checkpoint.restore(d, 7, jax.eval_shape(lambda: r_tree))
    _same(port, got)


def _bf16_tree():
    """(repro's tree, the port's): {'w': bf16 (4, 3), 'b': f32 (2,), 'layers':
    [bf16 (5,)]}, the same values."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 3)).astype(jnp.bfloat16)
    b = rng.normal(size=(2,)).astype(np.float32)
    l0 = rng.normal(size=(5,)).astype(jnp.bfloat16)
    r_tree = {"w": jnp.asarray(w), "b": jnp.asarray(b), "layers": [jnp.asarray(l0)]}
    port = interop.gnn_params_from_numpy({"layers": [{"w": w, "b": b, "layers": [l0]}]}, "cpu")["layers"][0]
    return r_tree, port


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_bf16_checkpoint_restores_in_the_port(tmp_path, writer):
    r_tree, port = _bf16_tree()
    d = str(tmp_path / "ck")
    (checkpoint.save if writer == "port" else r_checkpoint.save)(d, 1, port if writer == "port" else r_tree)
    leaves_meta = json.load(open(os.path.join(d, "step_00000001", "manifest.json")))["leaves"]
    assert [m["dtype"] for m in leaves_meta] == ["float32", "bfloat16", "bfloat16"]
    got = checkpoint.restore(d, 1, tree_map(lambda t: t.to("meta"), port), device="cpu")
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (4, 3)
    _same(got, r_tree)


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_repro_restore_raises_on_a_bf16_leaf(tmp_path, writer):
    """The reference fault (ROADMAP §C): ``repro``'s restore calls
    ``jnp.asarray`` on the raw 2-byte array that npz holds for a bf16
    leaf, whoever wrote it."""
    r_tree, port = _bf16_tree()
    d = str(tmp_path / "ck")
    (checkpoint.save if writer == "port" else r_checkpoint.save)(d, 1, port if writer == "port" else r_tree)
    with pytest.raises(TypeError, match="V2"):
        r_checkpoint.restore(d, 1, jax.eval_shape(lambda: r_tree))


def test_opt_state_from_numpy_refuses_an_unknown_tree():
    with pytest.raises(KeyError, match="optimizer state"):
        interop.opt_state_from_numpy({"mu": np.zeros(2), "step": np.int32(0)}, "cpu")
    with pytest.raises(TypeError, match="int32"):
        interop.opt_state_from_numpy({"m": {}, "v": {}, "step": np.float32(0)}, "cpu")
    state = interop.opt_state_from_numpy({"f": {"w": {"v": np.ones(3, np.float32)}}, "step": np.int32(4)}, "cpu")
    assert int(state["step"]) == 4 and state["step"].dtype == torch.int32 and leaves(state["f"])[0].shape == (3,)
