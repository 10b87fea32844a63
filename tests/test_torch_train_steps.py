"""Every model's loss and train step against ``repro``'s on the CPU, at the
registry's smoke sizes: the dense LM (qwen3-14b's smoke config, bf16,
one microbatch), the MoE LM (granite-moe's, f32, two microbatches), DLRM
(bf16 tables, f32 MLPs), GCN, SchNet, NequIP and EquiformerV2.  One set
of weights on both sides (drawn by the port's init, handed to ``repro``
as numpy arrays, carried into the port by ``interop``), the same batch;
the loss and every gradient leaf against ``jax.value_and_grad`` of
``repro``'s loss, then one ``train_step``'s new parameters and loss
against ``repro``'s jitted step.

Tolerances, as the largest |port - repro| over the largest |repro| of a
leaf: f32 1e-5 (EquiformerV2 1e-4: its Wigner-D regression and 12
layers of products sum in another order); bf16 2e-2.  The LM's loss
masks the vocab's padding columns (vocab 211 padded to 256), in two
chunks of ``chunked_cross_entropy``; both are also held to ``repro``'s
losses directly.  The MoE LM runs in f32, where no router logit lies
within rounding of the next: no near tie flips a token's experts (in
bf16 they would; ``tests/test_torch_moe.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import dlrm_mlperf as r_dlrm_cfg
from repro.configs import gnn_common as r_gnn_common
from repro.configs import lm_common as r_lm_common
from repro.configs import registry as r_registry
from repro.dist import sharding as r_shd
from repro.models import dlrm as r_dlrm
from repro.models import gnn as r_gnn
from repro.models import layers as r_layers
from repro.models import transformer as r_tr
from repro.training import optimizer as r_opt

from repro_torch import interop
from repro_torch.configs import dlrm_mlperf, gnn_common, lm_common, registry
from repro_torch.dist import sharding as shd
from repro_torch.models import dlrm, gnn, layers
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves_with_paths, value_and_grad

torch.set_num_threads(2)

R_RULES = r_shd.Rules.from_mesh(None)
RULES = shd.Rules.from_mesh(None)
F32_TOL, BF16_TOL, EQUIFORMER_TOL = 1e-5, 2e-2, 1e-4
# a gradient leaf zero up to rounding, relative to the tree's largest; the
# gradients at which AdamW's first step (eps 1e-8) is ill-conditioned
ZERO_GRAD, ADAM_EPS_ZONE = 1e-6, 1e-6


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's bytes as numpy (bf16 as ml_dtypes' bfloat16):
    ``jnp.asarray`` may alias a numpy array's memory, and the port's
    train step writes its parameters in place."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16).copy()
    return t.numpy().copy()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_trees(got, want, tol_f32: float, what: str, grads=None, lr: float = 0.0) -> None:
    """Leaf by leaf in jax's order: max |got - want| <= tol x max |want|,
    tol the f32 one or BF16_TOL for a bf16 leaf.

    A leaf whose largest |want| is below ZERO_GRAD x the tree's largest
    is zero up to rounding (EquiformerV2's last attention bias: a shift
    of a head's logits that its softmax cancels); it is held to the
    tree's largest instead.  With ``grads`` (``repro``'s gradients of the
    parameters ``want`` holds after one AdamW step), an element whose
    |gradient| is below ADAM_EPS_ZONE is where AdamW's first step
    g / (|g| + eps) turns the gradient's rounding into an O(1) change of
    its update: an f32 one is held to 2 x ``lr``, the most two such
    steps can differ by; every other element to the tolerance."""
    w_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    g_flat = leaves_with_paths(got)
    assert [p for p, _ in g_flat] == ["/".join(str(k) for k in path) for path, _ in w_flat], what
    tree_scale = max(float(np.abs(_f32(w)).max()) for _, w in w_flat)
    g_leaves = [None] * len(w_flat) if grads is None else [_f32(x) for x in jax.tree.leaves(grads)]
    for (path, g), (_, w), gw in zip(g_flat, w_flat, g_leaves):
        w = _f32(w)
        tol = BF16_TOL if g.dtype == torch.bfloat16 else tol_f32
        assert g.shape == w.shape, (what, path)
        scale = max(float(np.abs(w).max()), 1e-30)
        if scale < ZERO_GRAD * tree_scale:
            scale = tree_scale
        diff = np.abs(_f32(g) - w)
        if gw is not None and g.dtype != torch.bfloat16:  # bf16's 2e-2 is far above 2 x lr
            ill = np.abs(gw) < ADAM_EPS_ZONE
            assert float(diff[ill].max(initial=0.0)) <= 2 * lr, (what, path)
            diff = diff[~ill]
        err = float(diff.max(initial=0.0))
        assert err <= tol * scale, (what, path, err, tol * scale)


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    want = float(want)
    assert abs(float(got) - want) <= tol * max(abs(want), 1e-30), (what, float(got), want)


def _check(r_loss, loss, r_step, step, rp, p, rb, b, optimizer: str, tol: float) -> None:
    """Loss and gradients, then one train step, against repro's."""
    r_value, r_grads = jax.jit(jax.value_and_grad(lambda q: r_loss(q, rb)))(rp)
    value, grads = value_and_grad(lambda q: loss(q, b))(p)
    _close(value, r_value, tol, "loss")
    _close_trees(grads, r_grads, tol, "gradients")
    r_optimizer = r_opt.get(optimizer)
    assert optimizer == "adamw"
    r_state = r_optimizer.init(rp)
    state = interop.opt_state_from_numpy(jax.tree.map(np.asarray, r_state), "cpu")
    r_new, r_new_state, r_step_loss = jax.jit(r_step)(rp, r_state, rb)
    new, new_state, step_loss = step(p, state, b)
    _close(step_loss.detach(), r_step_loss, tol, "step loss")
    assert int(new_state["step"]) == 1
    _close_trees(new, r_new, tol, "new parameters", grads=r_grads, lr=3e-4)


# ---------------------------------------------------------------------------
# the LMs
# ---------------------------------------------------------------------------

LM_CASES = {  # name: (arch, dtype, microbatches): one slice's gradients in the
    # parameters' dtype (bf16 here), two slices' in f32 accumulators
    "dense-bf16": ("qwen3-14b", "bf16", 1),
    "moe-f32-micro2": ("granite-moe-1b-a400m", "f32", 2),
}
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL), "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_train_step_matches_repro(case):
    arch, dtype, micro = LM_CASES[case]
    jdt, tdt, tol = DTYPES[dtype]
    rcfg = dataclasses.replace(r_registry.get_arch(arch).smoke(), dtype=jdt, microbatches=micro)
    cfg = dataclasses.replace(registry.get_arch(arch).smoke(), dtype=tdt, microbatches=micro)
    assert cfg.vocab < cfg.padded_vocab  # the loss masks padding columns
    p = tr.init_params(cfg, seed=0, device="cpu")
    rp = jax.tree.map(jnp.asarray, jax.tree.map(_numpy, p))
    rb = r_lm_common.lm_smoke_batch(rcfg, "train")
    b = lm_common.lm_smoke_batch(cfg, "train", device="cpu")
    assert np.array_equal(b["tokens"].numpy(), np.asarray(rb["tokens"]))
    _check(lambda q, x: r_tr.loss_fn(rcfg, R_RULES, q, x["tokens"], x["labels"]),
           lambda q, x: tr.loss_fn(cfg, RULES, q, x["tokens"], x["labels"]),
           r_tr.make_train_step(rcfg, R_RULES), tr.make_train_step(cfg, RULES),
           rp, p, rb, b, cfg.optimizer, tol)


def test_kimi_trains_with_adafactor():
    """kimi-k2's config selects AdaFactor: its factored state, one step."""
    name = registry.get_arch("kimi-k2-1t-a32b").full().optimizer
    assert name == r_registry.get_arch("kimi-k2-1t-a32b").full().optimizer == "adafactor"
    rcfg = dataclasses.replace(r_registry.get_arch("kimi-k2-1t-a32b").smoke(), dtype=jnp.float32, optimizer=name)
    cfg = dataclasses.replace(registry.get_arch("kimi-k2-1t-a32b").smoke(), dtype=torch.float32, optimizer=name)
    p = tr.init_params(cfg, seed=1, device="cpu")
    rp = jax.tree.map(jnp.asarray, jax.tree.map(_numpy, p))
    rb = r_lm_common.lm_smoke_batch(rcfg, "train", seed=1)
    b = lm_common.lm_smoke_batch(cfg, "train", seed=1, device="cpu")
    state = opt_lib.get("adafactor").init(p)
    assert state["f"]["layers"]["moe"]["w_gate"]["vr"].shape == p["layers"]["moe"]["w_gate"].shape[:-1]
    r_state = r_opt.get("adafactor").init(rp)
    r_new, _, r_loss = jax.jit(r_tr.make_train_step(rcfg, R_RULES))(rp, r_state, rb)
    new, _, loss = tr.make_train_step(cfg, RULES)(p, state, b)
    _close(loss, r_loss, F32_TOL, "loss")
    _close_trees(new, r_new, F32_TOL, "new parameters")


@pytest.mark.parametrize("n_valid", [211, 256, 100])
def test_chunked_cross_entropy_matches_repro(n_valid):
    """Against ``repro``'s chunked loss and its unchunked ``cross_entropy``,
    with padding columns masked (n_valid < V) and without; the gradients
    of the hidden states and the head too."""
    rng = np.random.default_rng(n_valid)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    head = rng.normal(size=(16, 256)).astype(np.float32)
    labels = rng.integers(0, min(n_valid, 256), (2, 5)).astype(np.int32)

    def r_fn(xx, hh):
        return r_layers.chunked_cross_entropy(xx, hh, jnp.asarray(labels), R_RULES, n_valid)

    r_value, (r_gx, r_gh) = jax.value_and_grad(r_fn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    xt, ht = torch.from_numpy(x).requires_grad_(), torch.from_numpy(head).requires_grad_()
    value = layers.chunked_cross_entropy(xt, ht, torch.from_numpy(labels), RULES, n_valid)
    value.backward()
    value = value.detach()
    _close(value, r_value, F32_TOL, "chunked loss")
    _close_trees([xt.grad, ht.grad], [r_gx, r_gh], F32_TOL, "chunked gradients")
    full = r_layers.cross_entropy(jnp.asarray(x) @ jnp.asarray(head), jnp.asarray(labels), R_RULES, n_valid)
    _close(layers.cross_entropy(torch.from_numpy(x @ head), torch.from_numpy(labels), RULES, n_valid),
           full, F32_TOL, "cross_entropy")
    _close(value, full, F32_TOL, "chunked against unchunked")


# ---------------------------------------------------------------------------
# DLRM and the GNNs
# ---------------------------------------------------------------------------


def test_dlrm_train_step_matches_repro():
    rcfg, cfg = r_dlrm_cfg.smoke(), dlrm_mlperf.smoke()
    p = dlrm.init_params(cfg, seed=0, device="cpu")
    assert p["tables"]["t0"].dtype == torch.bfloat16
    rp = jax.tree.map(jnp.asarray, jax.tree.map(_numpy, p))
    rb = r_dlrm_cfg.smoke_batch(rcfg, "train")
    b = dlrm_mlperf.smoke_batch(cfg, "train", device="cpu")
    _check(lambda q, x: r_dlrm.loss_fn(rcfg, R_RULES, q, x), lambda q, x: dlrm.loss_fn(cfg, RULES, q, x),
           r_dlrm.make_train_step(rcfg, R_RULES), dlrm.make_train_step(cfg, RULES),
           rp, p, rb, b, cfg.optimizer, F32_TOL)


@pytest.mark.parametrize("arch", ["gcn-cora", "schnet", "nequip", "equiformer-v2"])
def test_gnn_train_step_matches_repro(arch):
    rcfg, cfg = r_registry.get_arch(arch).smoke(), registry.get_arch(arch).smoke()
    p = gnn.INIT_FNS[arch](cfg, seed=0, device="cpu")
    rp = jax.tree.map(jnp.asarray, jax.tree.map(_numpy, p))
    needs_feat = arch == "gcn-cora"
    rb = r_gnn_common.gnn_smoke_batch(needs_feat)
    b = gnn_common.gnn_smoke_batch(needs_feat, device="cpu")
    # every third edge masked on both sides
    m = np.arange(rb["edge_mask"].shape[0]) % 3 != 0
    rb, b = dict(rb, edge_mask=jnp.asarray(m)), dict(b, edge_mask=torch.from_numpy(m))
    tol = EQUIFORMER_TOL if arch == "equiformer-v2" else F32_TOL
    _check(lambda q, x: r_gnn.LOSS_FNS[arch](rcfg, R_RULES, q, x),
           lambda q, x: gnn.LOSS_FNS[arch](cfg, RULES, q, x),
           r_gnn.make_gnn_train_step(rcfg, R_RULES), gnn.make_gnn_train_step(cfg, RULES),
           rp, p, rb, b, cfg.optimizer, tol)


def test_train_step_changes_params_in_place_and_records_no_graph():
    cfg = registry.get_arch("schnet").smoke()
    p = gnn.schnet_init(cfg, seed=0, device="cpu")
    before = p["embed"].clone()
    state = opt_lib.get("adamw").init(p)
    b = gnn_common.gnn_smoke_batch(False, device="cpu")
    new, new_state, loss = gnn.make_gnn_train_step(cfg, RULES)(p, state, b)
    assert new["embed"] is p["embed"] and not torch.equal(p["embed"], before)
    assert p["embed"].grad is None and not p["embed"].requires_grad and loss.grad_fn is None
