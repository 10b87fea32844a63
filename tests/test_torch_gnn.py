"""The port's GNN family against ``repro``'s on the CPU: the four serve
steps (GCN, SchNet, NequIP, EquiformerV2) on ``gnn_smoke_batch`` with
one set of weights carried into both (``interop.gnn_params_from_numpy``
on the port's side), with all edges and with some masked, and under a
layout's rules; ``scatter_sum`` (B6's plain version here) against
``jax.ops.segment_sum``; the spherical harmonics, edge rotations,
Wigner-D matrices and the host Wigner basis; the configs' input specs
for every (arch, shape); and the registry.

Tolerances, as the largest |port - repro| over the largest |repro| of a
tensor, all f32.  ``scatter_sum`` sums each node's messages in edge
order, as ``segment_sum`` does on the CPU, so it is exact.  The serve
steps 1e-5 (they land within ~3e-7): GCN's port scales the gathered rows
by rsqrt(dout) and the sums by rsqrt(din) where ``repro`` multiplies each
message by their product, so the two round apart; every model's products
sum in another order than XLA's; EquiformerV2's Wigner-D regression
(``pinv`` on 80 sample points) compounds that over its layers.
``real_sph_harm`` 1e-6 and ``wigner_d`` 1e-5; the host basis is numpy on
both sides, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import gnn_common as r_gnn_common
from repro.configs import registry as r_registry
from repro.dist import sharding as r_shd
from repro.models import gnn as r_gnn

from repro_torch import interop
from repro_torch.configs import gnn_common, registry
from repro_torch.dist import sharding as shd
from repro_torch.models import gnn

torch.set_num_threads(2)

R_RULES = r_shd.Rules.from_mesh(None)
RULES = shd.Rules.from_mesh(None)
GNN_ARCHS = ["gcn-cora", "schnet", "nequip", "equiformer-v2"]
TOL = 1e-5


def _close(got, want, tol: float) -> None:
    """max |got - want| <= tol x max |want|."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _batches(arch: str, masked: bool, seed: int = 0):
    """(repro's smoke batch, the port's), the same values; with
    ``masked``, every third edge masked in both."""
    needs_feat = arch == "gcn-cora"
    rb = r_gnn_common.gnn_smoke_batch(needs_feat, seed=seed)
    b = gnn_common.gnn_smoke_batch(needs_feat, seed=seed, device="cpu")
    assert set(b) == set(rb)
    for k in rb:
        assert np.array_equal(b[k].numpy(), np.asarray(rb[k])), k
    if masked:
        m = np.arange(rb["edge_mask"].shape[0]) % 3 != 0
        rb = dict(rb, edge_mask=jnp.asarray(m))
        b = dict(b, edge_mask=torch.from_numpy(m))
    return rb, b


@pytest.fixture(scope="module")
def params():
    """(repro's jitted serve step, port config, repro params, port
    params) per arch.  One set of weights on both sides: drawn by the
    port's init (whose tree is ``repro``'s, checked below), as numpy
    arrays handed to ``repro`` and carried into the port by ``interop``;
    ``repro``'s own init draws every leaf op by op, ~10 s for the four
    on the CPU."""
    cache = {}

    def get(arch: str):
        if arch not in cache:
            rcfg, cfg = r_registry.get_arch(arch).smoke(), registry.get_arch(arch).smoke()
            tree = jax.tree.map(lambda t: t.numpy(), gnn.INIT_FNS[arch](cfg, seed=0, device="cpu"))
            rp = jax.tree.map(jnp.asarray, tree)
            p = interop.gnn_params_from_numpy(tree, "cpu")
            cache[arch] = (jax.jit(r_gnn.make_gnn_serve_step(rcfg, R_RULES)), cfg, rp, p)
        return cache[arch]

    return get


# ---------------------------------------------------------------------------
# the serve steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_serve_step_matches_repro(params, arch, masked):
    r_step, cfg, rp, p = params(arch)
    rb, b = _batches(arch, masked)
    want = r_step(rp, rb)
    got = gnn.make_gnn_serve_step(cfg, RULES)(p, b)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _close(got, want, TOL)


@pytest.mark.parametrize("arch", ["schnet", "nequip", "equiformer-v2"])
def test_energy_of_one_graph_without_graph_ids(params, arch):
    """Without ``graph_ids`` the readout is the sum over atoms, as
    ``repro``'s."""
    r_step, cfg, rp, p = params(arch)
    rb, b = _batches(arch, masked=False, seed=1)
    rb = {k: v for k, v in rb.items() if k != "graph_ids"}
    b = {k: v for k, v in b.items() if k != "graph_ids"}
    want = r_step(rp, rb)
    got = gnn.make_gnn_serve_step(cfg, RULES)(p, b)
    assert got.shape == (1,)
    _close(got, want, TOL)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_init_has_repro_tree_shapes_and_dtypes(arch):
    rcfg, cfg = r_registry.get_arch(arch).smoke(), registry.get_arch(arch).smoke()
    want = jax.eval_shape(lambda key: r_gnn.INIT_FNS[arch](rcfg, key), jax.random.key(0))
    got = gnn.INIT_FNS[arch](cfg, seed=0, device="cpu")
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == w.dtype.name
    again = jax.tree_util.tree_leaves(gnn.INIT_FNS[arch](cfg, seed=0, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(g_leaves, again))


def test_gnn_params_refuse_an_unknown_tree():
    with pytest.raises(KeyError, match="GNN params"):
        interop.gnn_params_from_numpy({"embed": np.zeros(2), "blocks": []}, "cpu")


# ---------------------------------------------------------------------------
# the scatter and the geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, n_nodes", [((50,), 7), ((64, 5), 24), ((40, 3, 4), 9), ((30, 2), 100)])
def test_scatter_sum_equals_segment_sum(shape, n_nodes):
    """Rows of any trailing shape, nodes that no edge reaches (zero), and
    destinations in arbitrary order: exact."""
    rng = np.random.default_rng(len(shape) + n_nodes)
    msg = rng.normal(size=shape).astype(np.float32)
    dst = rng.integers(0, n_nodes, shape[0]).astype(np.int32)
    want = jax.ops.segment_sum(jnp.asarray(msg), jnp.asarray(dst), num_segments=n_nodes)
    edges = gnn.sort_edges(torch.from_numpy(dst))
    got = gnn.scatter_sum(torch.from_numpy(msg), edges, n_nodes)
    assert got.shape == (n_nodes,) + shape[1:]
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_a_layouts_rules_change_nothing_off_mesh(params):
    """Without an active mesh ``repro`` neither shards edges nor psums,
    whatever axes ``rules`` names; the port's serve step gives the same
    energies under a (data, model) layout's rules as under one card's."""
    _, cfg, _, p = params("schnet")
    _, b = _batches("schnet", masked=True)
    layout = type("Layout", (), {"axis_names": ("data", "model"), "shape": {"data": 2, "model": 2}})
    got = gnn.make_gnn_serve_step(cfg, shd.Rules.from_mesh(layout))(p, b)
    assert torch.equal(got, gnn.make_gnn_serve_step(cfg, RULES)(p, b))


@pytest.mark.parametrize("l_max", [2, 3, 6])
def test_real_sph_harm_matches_repro(l_max):
    rng = np.random.default_rng(l_max)
    v = rng.normal(size=(200, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[0] = (0.0, 0.0, 1.0)  # a pole: rho is the 1e-20 floor
    want = np.asarray(jax.jit(lambda u: r_gnn.real_sph_harm(u, l_max))(jnp.asarray(v)))
    got = gnn.real_sph_harm(torch.from_numpy(v), l_max)
    assert got.dtype == torch.float32
    # rho and cos(phi) may differ by an ulp (torch's vectorised CPU sqrt is
    # not correctly rounded on every host, XLA's is), and each order of the
    # Legendre and Chebyshev recurrences adds to it: degree l is held to
    # 4 ulps (2^-24) an order of its largest value
    for l in range(l_max + 1):
        cols = slice(l * l, (l + 1) ** 2)
        _close(got[:, cols], want[:, cols], 4 * max(l, 1) * 2.0**-24)


@pytest.mark.parametrize("l_max", [2, 3, 6])
def test_wigner_basis_is_bit_exact(l_max):
    r_pts, r_pinv = r_gnn._wigner_basis_np(l_max)
    pts, pinv = gnn._wigner_basis_np(l_max)
    assert pts.tobytes() == r_pts.tobytes() and pinv.tobytes() == r_pinv.tobytes()
    assert np.array_equal(gnn._fibonacci_points(80), r_gnn._fibonacci_points(80))
    for m, (pos, neg) in r_gnn._m_indices(l_max, 2).items():
        assert np.array_equal(gnn._m_indices(l_max, 2)[m][0], pos)
        assert np.array_equal(gnn._m_indices(l_max, 2)[m][1], neg)


@pytest.mark.parametrize("l_max", [3, 6])
def test_edge_rotation_and_wigner_d_match_repro(l_max):
    rng = np.random.default_rng(7)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[0], v[1] = (0.0, 0.0, 1.0), (0.0, 0.0, -1.0)  # aligned and anti-aligned with z
    r_rot = jax.jit(r_gnn.edge_rotation)(jnp.asarray(v))
    rot = gnn.edge_rotation(torch.from_numpy(v))
    _close(rot, r_rot, 1e-6)
    r_pts, r_pinv = r_gnn._wigner_basis(l_max)
    pts, pinv = gnn._wigner_basis(l_max, "cpu")
    want = jax.jit(lambda r: r_gnn.wigner_d(r, l_max, r_pts, r_pinv))(r_rot)
    got = gnn.wigner_d(rot, l_max, pts, pinv)
    _close(got, want, 1e-5)
    # D is a rotation of the coefficients: orthogonal
    eye = torch.eye((l_max + 1) ** 2).expand_as(got)
    assert float((got @ got.transpose(-1, -2) - eye).abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _tree(spec: dict) -> dict:
    out = {}
    for k, v in spec.items():
        if isinstance(v, torch.Tensor):
            assert v.device.type == "meta"
            out[k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        else:
            out[k] = (tuple(v.shape), np.dtype(v.dtype).name)
    return out


@pytest.mark.parametrize("shape", list(registry.GNN_SHAPES))
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_input_specs(arch, shape):
    """As ``repro``'s cells build them: GCN sized to each shape's dataset."""
    cfg, rcfg = registry.get_arch(arch).full(), r_registry.get_arch(arch).full()
    needs_feat = arch == "gcn-cora"
    sh, rsh = registry.GNN_SHAPES[shape], r_registry.GNN_SHAPES[shape]
    if needs_feat:
        cfg, rcfg = gnn_common.gcn_for_shape(cfg, sh), r_gnn_common.gcn_for_shape(rcfg, rsh)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert gnn_common.shape_counts(sh) == r_gnn_common.shape_counts(rsh)
    got = gnn_common.gnn_input_specs(cfg, sh, needs_feat)
    want = r_gnn_common.gnn_input_specs(rcfg, rsh, needs_feat)
    assert _tree(got) == _tree(want)


@pytest.mark.parametrize("e", [1, 511, 512, 61_859_140])
def test_pad_edges(e):
    assert gnn_common.pad_edges(e) == r_gnn_common.pad_edges(e)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("needs_feat", [False, True])
def test_gnn_smoke_batch_holds_repros_values(needs_feat, seed):
    rb = r_gnn_common.gnn_smoke_batch(needs_feat, seed=seed)
    b = gnn_common.gnn_smoke_batch(needs_feat, seed=seed, device="cpu")
    assert list(b) == list(rb)
    for k in rb:
        assert b[k].numpy().dtype == np.asarray(rb[k]).dtype, k
        assert np.array_equal(b[k].numpy(), np.asarray(rb[k])), k


def test_registry_lists_the_gnn_archs():
    for arch in GNN_ARCHS:
        spec, rspec = registry.get_arch(arch), r_registry.get_arch(arch)
        assert spec.family == rspec.family == "gnn"
        assert type(spec.full()).__name__ == type(rspec.full()).__name__
        assert spec.full().name == arch
