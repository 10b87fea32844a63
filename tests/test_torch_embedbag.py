"""The port's EmbeddingBag (B6's plain version on the CPU) against
``repro``'s: ``embedding_bag`` and ``gnn_aggregate`` with ``repro``'s Pallas
kernel in interpret mode, and the plain oracles.  On f32 tables the port
and ``repro``'s kernel add the same rows in the same order in f32, so
they agree bit for bit.  On bf16 tables ``repro``'s kernel rounds to bf16
after every lookup where the port rounds once: they agree to bf16's
rounding of a few sums, stated per test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.embedbag import embedbag as r_embedbag
from repro.kernels.embedbag import ops as r_ops
from repro.kernels.embedbag import ref as r_ref

from repro_torch.kernels.embedbag import embedbag, ops, ref

torch.set_num_threads(1)


def _case(rows, dim, n_lookup, n_bags, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    idx = rng.integers(0, rows, n_lookup).astype(np.int32)
    bags = rng.integers(0, n_bags, n_lookup).astype(np.int32)
    return table, idx, bags


@pytest.mark.parametrize("rows, dim, n_lookup, n_bags", [(64, 8, 40, 10), (128, 128, 96, 16), (256, 64, 128, 24)])
def test_embedding_bag_bit_exact(rows, dim, n_lookup, n_bags):
    """repro's three shapes (tests/test_kernels.py): equal to repro's
    kernel bit for bit, and to both oracles to f32 rounding."""
    table, idx, bags = _case(rows, dim, n_lookup, n_bags, rows)
    want = np.asarray(r_ops.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bags), n_bags, interpret=True
    ))
    t = tuple(torch.from_numpy(a) for a in (table, idx, bags))
    got = ops.embedding_bag(*t, n_bags)
    assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()
    oracle = np.asarray(r_ref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bags), n_bags))
    np.testing.assert_allclose(ref.embedding_bag_ref(*t, n_bags).numpy(), oracle, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-6, atol=1e-6)


def test_embedding_bag_sorted_equals_pallas_kernel():
    """embedding_bag_sorted on sorted lookups equals repro's kernel on
    every visited bag; the port's unvisited bags are zero."""
    table, idx, bags = _case(100, 24, 300, 40, 7)
    order = np.argsort(bags, kind="stable")
    idx, bags = idx[order], bags[order]
    want = np.asarray(r_embedbag.embedding_bag_sorted(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bags), 48, interpret=True
    ))
    got = embedbag.embedding_bag_sorted(*(torch.from_numpy(a) for a in (table, idx, bags)), 48).numpy()
    visited = np.zeros(48, bool)
    visited[bags] = True
    assert got[visited].tobytes() == want[visited].tobytes()
    assert not got[~visited].any()


def test_embedding_bag_empty_bags():
    table = np.eye(8, 4, dtype=np.float32)
    idx = np.array([1, 1, 3], np.int32)
    bags = np.array([0, 0, 5], np.int32)  # bags 1-4, 6-7 empty
    want = np.asarray(r_ops.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bags), 8, interpret=True
    ))
    got = ops.embedding_bag(*(torch.from_numpy(a) for a in (table, idx, bags)), 8)
    assert got.numpy().tobytes() == want.tobytes()
    assert got[[1, 2, 3, 4, 6, 7]].eq(0).all()


def test_embedding_bag_no_lookups():
    got = ops.embedding_bag(
        torch.ones((5, 3)), torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32), 4
    )
    assert got.shape == (4, 3) and not got.any()


def test_gnn_aggregate_matches_repro():
    rng = np.random.default_rng(3)
    n, e, d = 30, 100, 16
    feats = rng.normal(size=(n, d)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    want = np.asarray(r_ops.gnn_aggregate(
        jnp.asarray(feats), jnp.asarray(src), jnp.asarray(dst), n, interpret=True
    ))
    got = ops.gnn_aggregate(*(torch.from_numpy(a) for a in (feats, src, dst)), n)
    assert got.numpy().tobytes() == want.tobytes()
    segsum = np.asarray(jax.ops.segment_sum(jnp.asarray(feats)[src], jnp.asarray(dst), num_segments=n))
    np.testing.assert_allclose(got.numpy(), segsum, rtol=2e-6, atol=1e-6)


def test_embedding_bag_bf16_table():
    """bf16 table, bags of ~12 lookups: the port's one rounding of an f32
    sum against repro's rounding after every lookup.  Each of repro's
    roundings is off by at most half a bf16 ulp of its partial sum, so
    the two differ by at most 12 half-ulps of the largest partial sum
    (≤ 2^-8 relative): held to 12 · 2^-8 of the bag's largest partial
    |sum|, plus 1e-6.  Bags of one lookup copy the row: exact."""
    table, idx, bags = _case(128, 64, 200, 16, 1)
    bf = jnp.asarray(table, jnp.bfloat16)
    want = np.asarray(r_ops.embedding_bag(bf, jnp.asarray(idx), jnp.asarray(bags), 16, interpret=True), np.float32)
    tt = torch.from_numpy(table).bfloat16()
    got = ops.embedding_bag(tt, torch.from_numpy(idx), torch.from_numpy(bags), 16)
    assert got.dtype == torch.bfloat16
    rows = tt.float().numpy()[idx]
    bound = np.zeros((16, 64), np.float32)
    for b in range(16):
        sel = rows[bags == b]
        if len(sel):
            bound[b] = np.abs(np.cumsum(sel, axis=0)).max(axis=0) * len(sel) * 2.0**-8
    assert (np.abs(got.float().numpy() - want) <= bound + 1e-6).all()
    ten = torch.arange(10, dtype=torch.int32)
    assert torch.equal(ops.embedding_bag(tt, ten, ten, 10), tt[:10])


def test_plain_version_sums_in_bag_order_in_chunks(monkeypatch):
    """The plain version's rank-by-rank chunks change nothing: a chunk of
    2 rows gives the bytes of one pass."""
    table, idx, bags = _case(50, 12, 400, 9, 11)
    order = np.argsort(bags, kind="stable")
    t = (torch.from_numpy(table), torch.from_numpy(idx[order]), torch.from_numpy(bags[order]))
    whole = embedbag.embedding_bag_sorted_plain(*t, 9)
    monkeypatch.setattr(embedbag, "PLAIN_CHUNK", 2)
    assert embedbag.embedding_bag_sorted_plain(*t, 9).numpy().tobytes() == whole.numpy().tobytes()


def test_cpu_calls_launch_no_kernel():
    before = embedbag.LAUNCHES
    table, idx, bags = _case(20, 4, 30, 5, 2)
    ops.embedding_bag(*(torch.from_numpy(a) for a in (table, idx, bags)), 5)
    assert embedbag.LAUNCHES == before


def test_wrapper_refuses_other_devices():
    t = torch.zeros((4, 4), device="meta")
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        embedbag.embedding_bag_sorted(t, ids, ids, 2)
