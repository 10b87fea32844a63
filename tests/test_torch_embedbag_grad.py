"""B6's gradient on the CPU against ``repro``'s: the table's gradient of
``ops.embedding_bag`` (``embedbag.embedding_bag_sorted_grad``: B6's
plain version forward, and again on the lookups sorted by row backward)
against ``jax.vjp`` of ``repro``'s ``embedding_bag_local`` (``jnp.take`` +
``jax.ops.segment_sum``) for the same cotangent.

Both add each table row's cotangents in lookup order (XLA's scatter-add
on the CPU rounds a bf16 sum after every add, as B6 does), so f32 and
bf16 are equal bit for bit.  Also: rows no lookup reads get exact zeros;
``gnn.scatter_sum``'s backward (one lookup a message row, the transposed
lookups known without a sort) equals the vjp of ``segment_sum``; GCN's
aggregation over the kept edges, whose backward sorts them by source
once, equals the vjp of ``repro``'s EmbeddingBag on the same lookups;
the call stays outside autograd when the table needs no gradient (a
serve step launches what it did); and ``torch.autograd.gradcheck`` of
the plain path in float64."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import dlrm as r_dlrm

from repro_torch.kernels.embedbag import embedbag
from repro_torch.kernels.embedbag import ops
from repro_torch.models import gnn

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _bits(x) -> np.ndarray:
    """A tensor's or JAX array's values as f32 numpy (bf16 exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _lookups(rng, rows: int, n: int, n_bags: int, hub: bool):
    """Row ids that leave the last rows unread and, with ``hub``, send a
    third of the lookups to row 1; bag ids in arbitrary order."""
    idx = rng.integers(0, rows - 3, n)
    if hub:
        idx[rng.random(n) < 0.33] = 1
    return idx.astype(np.int32), rng.integers(0, n_bags, n).astype(np.int32)


def _repro_grad(table, idx, bags, n_bags, g, jdt):
    _, vjp = jax.vjp(
        lambda t: r_dlrm.embedding_bag_local(t, jnp.asarray(idx), jnp.asarray(bags), n_bags),
        jnp.asarray(table, jdt),
    )
    return vjp(jnp.asarray(g, jdt))[0]


def _port_grad(table, idx, bags, n_bags, g, tdt, fn=ops.embedding_bag):
    t = _t(table, tdt).requires_grad_()
    out = fn(t, torch.from_numpy(idx), torch.from_numpy(bags), n_bags)
    assert out.grad_fn is not None
    out.backward(_t(g, tdt))
    return t.grad


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("shape", [(40, 8, 300, 17), (12, 128, 64, 64), (9, 3, 1, 4)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_table_gradient_equals_repro_vjp(dtype, shape, hub):
    """(rows, D, lookups, bags): bit for bit, the unread rows zero."""
    jdt, tdt = DTYPES[dtype]
    rows, d, n, n_bags = shape
    rng = np.random.default_rng(rows + d + n + hub)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    idx, bags = _lookups(rng, rows, n, n_bags, hub)
    g = rng.normal(size=(n_bags, d)).astype(np.float32)
    want = _repro_grad(table, idx, bags, n_bags, g, jdt)
    got = _port_grad(table, idx, bags, n_bags, g, tdt)
    assert got.dtype == tdt and got.shape == (rows, d)
    assert np.array_equal(_bits(got), _bits(want))
    assert not _bits(got)[rows - 3 :].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gnn_aggregate_gradient_equals_repro_vjp(dtype):
    """``gnn_aggregate`` is the EmbeddingBag with sources as rows and
    destinations as bags: its messages' gradient as ``repro``'s."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    n, e = 30, 200
    table = rng.normal(size=(n, 6)).astype(np.float32)
    src, dst = _lookups(rng, n, e, n, hub=True)
    g = rng.normal(size=(n, 6)).astype(np.float32)
    want = _repro_grad(table, src, dst, n, g, jdt)
    got = _port_grad(table, src, dst, n, g, tdt, fn=ops.gnn_aggregate)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sorted_entry_transposes_in_sorted_order(dtype):
    """``embedding_bag_sorted_grad`` on lookups already sorted by bag,
    with its default transpose: as ``repro``'s vjp on those lookups."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    table = rng.normal(size=(20, 16)).astype(np.float32)
    idx, bags = _lookups(rng, 20, 150, 25, hub=True)
    order = np.argsort(bags, kind="stable")
    idx, bags = idx[order], bags[order]
    g = rng.normal(size=(25, 16)).astype(np.float32)
    want = _repro_grad(table, idx, bags, 25, g, jdt)
    got = _port_grad(table, idx, bags, 25, g, tdt, fn=embedbag.embedding_bag_sorted_grad)
    assert np.array_equal(_bits(got), _bits(want))


def test_transpose_lookups():
    """Sorted stably by row: each row's lookups in their order."""
    idx = torch.tensor([3, 1, 3, 0, 1, 3], dtype=torch.int32)
    bags = torch.tensor([0, 0, 1, 2, 2, 4], dtype=torch.int32)
    idx_t, bags_t = embedbag.transpose_lookups(idx, bags)
    assert bags_t.tolist() == [0, 1, 1, 3, 3, 3]
    assert idx_t.tolist() == [2, 0, 2, 0, 1, 4]
    assert idx_t.dtype == bags_t.dtype == torch.int32 and idx_t.is_contiguous()


@pytest.mark.parametrize("shape, n_nodes", [((50,), 7), ((64, 5), 24), ((40, 3, 4), 9), ((30, 2), 100)])
def test_scatter_sum_gradient_equals_segment_sum_vjp(shape, n_nodes):
    """One lookup a message row: the gradient gathers each edge's
    destination row, exactly, for nodes with and without edges."""
    rng = np.random.default_rng(len(shape) + n_nodes)
    msg = rng.normal(size=shape).astype(np.float32)
    dst = rng.integers(0, n_nodes, shape[0]).astype(np.int32)
    g = rng.normal(size=(n_nodes,) + shape[1:]).astype(np.float32)
    _, vjp = jax.vjp(lambda m: jax.ops.segment_sum(m, jnp.asarray(dst), num_segments=n_nodes), jnp.asarray(msg))
    want = vjp(jnp.asarray(g))[0]
    m = torch.from_numpy(msg).requires_grad_()
    gnn.scatter_sum(m, gnn.sort_edges(torch.from_numpy(dst)), n_nodes).backward(torch.from_numpy(g))
    assert np.array_equal(m.grad.numpy(), np.asarray(want))


def test_gcn_aggregation_gradient_sorts_by_source_once(monkeypatch):
    """GCN's aggregation over the kept edges (sorted by destination),
    backward over the same edges sorted by source: the table's gradient
    equals ``repro``'s vjp on those lookups, and the two layers share one
    transposed sort (three stable sorts of the edges a forward, one at the
    first backward)."""
    rng = np.random.default_rng(5)
    n, e = 24, 90
    batch = {
        "node_feat": torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32)),
        "edge_src": torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        "edge_dst": torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        "edge_mask": torch.from_numpy(np.arange(e) % 4 != 0),
    }
    cfg = gnn.GCNConfig(d_feat=6, d_hidden=5, n_classes=3)
    params = gnn.gcn_init(cfg, seed=0, device="cpu")
    for leaf in (params["layers"][0]["w"], params["layers"][1]["w"]):
        leaf.requires_grad_()
    calls, transposes = [], []
    real_sorted, real_transpose = embedbag.embedding_bag_sorted, gnn.transpose_lookups

    def counted(table, idx, bags, n_bags):
        calls.append((table.shape, idx.clone(), bags.clone()))
        return real_sorted(table, idx, bags, n_bags)

    def counted_transpose(idx, bags):
        transposes.append(1)
        return real_transpose(idx, bags)

    monkeypatch.setattr(embedbag, "embedding_bag_sorted", counted)
    monkeypatch.setattr(gnn, "transpose_lookups", counted_transpose)
    out = gnn.gcn_forward(cfg, None, params, batch)
    assert len(calls) == 4 and not transposes  # two degree scatters, two aggregations
    out.square().sum().backward()
    assert len(calls) == 6 and len(transposes) == 1  # one B6 a layer backward
    # the backward's lookups: the kept edges sorted stably by source
    _, kept_src, kept_dst = calls[2]
    _, idx_t, bags_t = calls[5]
    assert torch.equal(bags_t, torch.sort(kept_src, stable=True).values)
    assert torch.equal(idx_t, kept_dst[torch.sort(kept_src, stable=True).indices])
    # and that launch against repro's vjp of the same lookups
    rows = rng.normal(size=(n, 5)).astype(np.float32)
    g = rng.normal(size=(n, 5)).astype(np.float32)
    want = _repro_grad(rows, kept_src.numpy(), kept_dst.numpy(), n, g, jnp.float32)
    t = torch.from_numpy(rows).requires_grad_()
    embedbag.embedding_bag_sorted_grad(
        t, kept_src, kept_dst, n, lambda: real_transpose(kept_src, kept_dst)).backward(torch.from_numpy(g))
    assert np.array_equal(t.grad.numpy(), np.asarray(want))


def test_no_graph_when_no_gradient_is_needed(monkeypatch):
    """A table that needs no gradient, or a call under ``no_grad``: one
    plain call, no autograd node, no transposed sort."""
    calls = []
    real = embedbag.embedding_bag_sorted
    monkeypatch.setattr(embedbag, "embedding_bag_sorted", lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32))
    idx, bags = (torch.from_numpy(a) for a in _lookups(rng, 10, 30, 6, hub=False))
    assert ops.embedding_bag(table, idx, bags, 6).grad_fn is None
    with torch.no_grad():
        assert ops.embedding_bag(table.clone().requires_grad_(), idx, bags, 6).grad_fn is None
    assert len(calls) == 2
    out = ops.embedding_bag(table.clone().requires_grad_(), idx, bags, 6)
    assert len(calls) == 3 and out.grad_fn is not None
    out.sum().backward()
    assert len(calls) == 4  # the backward is one more B6


def test_gradcheck_of_the_plain_path_in_float64():
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.normal(size=(7, 3))).requires_grad_()
    idx, bags = (torch.from_numpy(a) for a in _lookups(rng, 7, 20, 5, hub=True))
    assert torch.autograd.gradcheck(lambda t: ops.embedding_bag(t, idx, bags, 5), (table,))
    msg = torch.from_numpy(rng.normal(size=(12, 2))).requires_grad_()
    edges = gnn.sort_edges(torch.from_numpy(rng.integers(0, 4, 12).astype(np.int32)))
    assert torch.autograd.gradcheck(lambda m: gnn.scatter_sum(m, edges, 4), (msg,))
