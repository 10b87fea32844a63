"""The port's EmbeddingBag (B6's plain version on the CPU) against
``repro``'s: ``embedding_bag`` and ``gnn_aggregate`` with ``repro``'s Pallas
kernel in interpret mode, and the plain oracles.  The port adds the same
rows in the same order as ``repro``'s kernel and, on bf16 tables, rounds
to bf16 after every lookup as it does, so the two agree bit for bit in
both dtypes.  A numpy twin of the CUDA kernel's walk (which lane group
sums which bags, and which empty bags it zeroes) and the wrapper's launch
geometry are checked against plain enumerations."""

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


def _bits(a) -> bytes:
    """The bytes of an f32 or bf16 array or tensor, to compare bit for bit."""
    a = np.asarray(a.view(torch.int16) if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_sorted_equals_pallas_kernel(dtype):
    """embedding_bag_sorted on sorted lookups equals repro's kernel on
    every visited bag, in the table's dtype; the port's unvisited bags
    are zero."""
    table, idx, bags = _case(100, 24, 300, 40, 7)
    order = np.argsort(bags, kind="stable")
    idx, bags = idx[order], bags[order]
    want = np.asarray(r_embedbag.embedding_bag_sorted(
        jnp.asarray(table, dtype), jnp.asarray(idx), jnp.asarray(bags), 48, interpret=True
    ))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = embedbag.embedding_bag_sorted(tt, torch.from_numpy(idx), torch.from_numpy(bags), 48)
    visited = np.zeros(48, bool)
    visited[bags] = True
    assert _bits(got[torch.from_numpy(visited)]) == _bits(want[visited])
    assert not got[torch.from_numpy(~visited)].any()


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gnn_aggregate_matches_repro(dtype):
    """Bit for bit against repro's gnn_aggregate; the bf16 graph has a hub
    of 220 in-edges, whose sum rounds after every edge."""
    rng = np.random.default_rng(3)
    n, e, d = 30, 100, 16
    feats = rng.normal(size=(n, d)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if dtype == "bfloat16":
        src = np.concatenate([src, rng.integers(0, n, 220).astype(np.int32)])
        dst = np.concatenate([dst, np.full(220, 7, np.int32)])
    want = np.asarray(r_ops.gnn_aggregate(
        jnp.asarray(feats, dtype), jnp.asarray(src), jnp.asarray(dst), n, interpret=True
    ))
    ft = torch.from_numpy(feats).to(getattr(torch, dtype))
    got = ops.gnn_aggregate(ft, torch.from_numpy(src), torch.from_numpy(dst), n)
    assert got.dtype == ft.dtype and _bits(got) == _bits(want)
    if dtype == "float32":
        segsum = np.asarray(jax.ops.segment_sum(jnp.asarray(feats)[src], jnp.asarray(dst), num_segments=n))
        np.testing.assert_allclose(got.numpy(), segsum, rtol=2e-6, atol=1e-6)


def _long_bag_case():
    """400 lookups into 4 bags, one of them 250 lookups long, of rows whose
    magnitudes span 2^-6 .. 2^6: rounding once and after every lookup
    part visibly there."""
    rng = np.random.default_rng(9)
    rows, dim = 96, 32
    table = (rng.normal(size=(rows, dim)) * 2.0 ** rng.integers(-6, 7, (rows, 1))).astype(np.float32)
    idx = rng.integers(0, rows, 400).astype(np.int32)
    bags = np.repeat(np.array([2, 0, 3, 1], np.int32), [250, 60, 50, 40])
    return table, idx, rng.permutation(bags).astype(np.int32), 6


@pytest.mark.parametrize("case", ["bags of ~12", "a bag of 250, mixed magnitudes"])
def test_embedding_bag_bf16_table(case):
    """bf16 tables: the port rounds to bf16 after every lookup, as repro's
    kernel does, and equals it bit for bit; rounding the f32 sum once
    would not (checked on the same lookups).  Bags of one lookup copy the
    row."""
    table, idx, bags, n_bags = _case(128, 64, 200, 16, 1) + (16,) if case == "bags of ~12" else _long_bag_case()
    bf = jnp.asarray(table, jnp.bfloat16)
    want = np.asarray(r_ops.embedding_bag(bf, jnp.asarray(idx), jnp.asarray(bags), n_bags, interpret=True))
    tt = torch.from_numpy(table).bfloat16()
    got = ops.embedding_bag(tt, torch.from_numpy(idx), torch.from_numpy(bags), n_bags)
    assert got.dtype == torch.bfloat16
    assert _bits(got) == _bits(want)
    once = ops.embedding_bag(tt.float(), torch.from_numpy(idx), torch.from_numpy(bags), n_bags).bfloat16()
    assert (once != got).sum() > 0.2 * got.numel()
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
    """A meta table is a shape-only call (an empty meta output, no
    launch); lookups on another device than the table are refused."""
    t = torch.zeros((4, 4), device="meta")
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    before = embedbag.LAUNCHES
    out = embedbag.embedding_bag_sorted(t, ids, ids, 3)
    assert (out.shape, out.dtype, out.device.type, embedbag.LAUNCHES) == ((3, 4), t.dtype, "meta", before)
    with pytest.raises(ValueError, match="is on cpu, table on meta"):
        embedbag.embedding_bag_sorted(t, torch.zeros(2, dtype=torch.int32), ids, 2)


# ---------------------------------------------------------------------------
# The CUDA kernel's walk and the wrapper's geometry, on the CPU
# ---------------------------------------------------------------------------


def _kernel_walk(bags, n_bags, lanes, per_unit):
    """A numpy twin of ``csrc/embedbag.cu``'s walk, window by window with
    the kernel's ballots: every unit's writes in order, ("sum", bag,
    positions added) or ("zero", bag, [])."""
    n = len(bags)
    writes = []
    for unit in range(n // per_unit + 1):
        s, e = unit * per_unit, min(unit * per_unit + per_unit, n + 1)
        base, prev = s, (bags[s - 1] if s > 0 else -1)
        started, cur, pos = False, None, []
        while True:
            w = [int(bags[q]) if q < n else n_bags for q in range(base, base + lanes)]
            up = [prev] + w[:-1]
            starts = [w[g] != up[g] for g in range(lanes)]
            stops = [base + g >= n or (starts[g] and base + g >= e) for g in range(lanes)]
            j = 0
            if not started:
                if not any(starts):
                    if base + lanes >= e:
                        break
                    prev, base = w[-1], base + lanes
                    continue
                j = starts.index(True)
                if base + j >= e:
                    break
                started = True
            stop = stops.index(True) if any(stops) else lanes
            for k in range(j, stop):
                if starts[k]:
                    if cur is not None:
                        writes.append(("sum", cur, pos))
                    writes += [("zero", b, []) for b in range(up[k] + 1, w[k])]
                    cur, pos = w[k], []
                pos.append(base + k)
            if stop < lanes:
                if cur is not None:
                    writes.append(("sum", cur, pos))
                if base + stop == n and n < e:
                    writes += [("zero", b, []) for b in range(up[stop] + 1, n_bags)]
                break
            prev, base = w[-1], base + lanes
    return writes


def _sorted_bags(name):
    """Sorted bag ids with leading, trailing and interior empty bags, bags
    longer than a window and than a unit's range, and one-lookup bags."""
    rng = np.random.default_rng(len(name))
    if name == "empty":
        return np.zeros(0, np.int32), 5
    if name == "one lookup per bag":
        return np.arange(70, dtype=np.int32), 70
    if name == "long bags":
        return np.repeat(np.array([1, 2, 5], np.int32), [1100, 40, 300]), 8
    if name == "gaps":
        return np.sort(rng.choice(np.arange(3, 200), 150)).astype(np.int32), 230
    return np.sort(rng.integers(0, 40, 500)).astype(np.int32), 40  # "random"


@pytest.mark.parametrize("lanes, per_unit", [(2, 2), (2, 16), (8, 32), (16, 16), (32, 32), (32, 256)])
@pytest.mark.parametrize("name", ["empty", "one lookup per bag", "long bags", "gaps", "random"])
def test_kernel_walk_writes_every_bag_once_in_sorted_order(name, lanes, per_unit):
    """Every bag is written exactly once: a visited bag as the sum of its
    lookups in sorted order, an empty one as zeros."""
    bags, n_bags = _sorted_bags(name)
    writes = _kernel_walk(bags, n_bags, lanes, per_unit)
    assert sorted(b for _, b, _ in writes) == list(range(n_bags))
    for kind, b, pos in writes:
        assert pos == np.flatnonzero(bags == b).tolist()
        assert (kind == "sum") == bool(pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_walk_sums_equal_plain(dtype):
    """Summing each write's positions in order, rounded to the table's
    dtype after every lookup, gives the plain version's bytes."""
    bags, n_bags = _sorted_bags("long bags")
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(50, 6)).astype(np.float32)).to(dtype)
    idx = rng.integers(0, 50, len(bags)).astype(np.int32)
    out = torch.full((n_bags, 6), float("nan"), dtype=dtype)
    for _, b, pos in _kernel_walk(bags, n_bags, 8, 32):
        acc = torch.zeros(6, dtype=dtype)
        for p in pos:
            acc = (acc.float() + table[idx[p]].float()).to(dtype)
        out[b] = acc
    want = embedbag.embedding_bag_sorted_plain(table, torch.from_numpy(idx), torch.from_numpy(bags), n_bags)
    assert out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).numpy().tobytes() == (
        want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).numpy().tobytes())


@pytest.mark.parametrize("d", [1, 2, 3, 8, 100, 128, 129, 300])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("align", [256, 8])
def test_launch_geometry_against_enumeration(d, itemsize, align):
    """The widest load that divides the row and the alignment, the
    smallest power-of-two lane group (2 to 32) that covers the row, the
    column chunks that cover the rest; a unit's range the least power of
    two that keeps the units at most UNITS, within [lanes,
    MAX_PER_UNIT]."""
    for n in (0, 1, 70, 262_144, 61_859_140):
        geo = embedbag.launch_geometry(d, itemsize, align, n)
        vec = max(v for v in (2, 4, 8, 16) if v >= itemsize and (d * itemsize) % v == 0 and align % v == 0)
        assert geo["vec_bytes"] == vec
        lanes = next(g for g in (2, 4, 8, 16, 32) if g * vec >= d * itemsize or g == 32)
        assert geo["lanes"] == lanes
        assert geo["n_chunks"] == -(-d * itemsize // (lanes * vec))
        p = 1
        while p * embedbag.UNITS < n:
            p *= 2
        assert geo["per_unit"] == min(embedbag.MAX_PER_UNIT, max(lanes, p))
