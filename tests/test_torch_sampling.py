"""The port's ``graph/sampling.py`` against ``repro``'s: the static
shape plan and every array of a sampled block (global node ids, each
layer's local edge lists and masks) bit for bit, on graphs with nodes of
no in-edge, degrees below and above the fanout, and several seeds; the
samplers are built on the two packages' ``LabeledGraph`` of the same
edges."""

import numpy as np
import pytest

from repro.graph import sampling as r_sampling
from repro.graph import structure as r_structure

from repro_torch.graph import sampling, structure

# (nodes, edges, generator seed): sparse (many nodes without in-edges),
# mid, dense (in-degrees far above the fanout)
GRAPHS = [(200, 150, 1), (500, 2_000, 2), (300, 12_000, 3)]


def _graphs(n: int, e: int, seed: int):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    lbl = np.zeros(e, np.int32)
    return (r_structure.LabeledGraph(n, src, lbl, dst, ["e"]),
            structure.LabeledGraph(n, src.copy(), lbl.copy(), dst.copy(), ["e"]))


@pytest.mark.parametrize("fanout", [(15, 10), (3,), (2, 4, 3)])
@pytest.mark.parametrize("batch", [1, 16, 1024])
def test_plan_shapes(batch, fanout):
    assert sampling.NeighborSampler.plan_shapes(batch, fanout) == \
        r_sampling.NeighborSampler.plan_shapes(batch, fanout)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("fanout", [(15, 10), (2, 3, 2)])
@pytest.mark.parametrize("graph", range(len(GRAPHS)))
def test_sample_is_bit_exact(graph, fanout, seed):
    rg, g = _graphs(*GRAPHS[graph])
    r_s, s = r_sampling.NeighborSampler(rg), sampling.NeighborSampler(g)
    assert np.array_equal(s.offsets, r_s.offsets) and np.array_equal(s.sorted_src, r_s.sorted_src)
    seeds = np.random.default_rng(seed).choice(g.n_nodes, size=min(24, g.n_nodes), replace=False)
    want = r_s.sample(seeds, fanout, seed=seed)
    got = s.sample(seeds, fanout, seed=seed)
    assert (got.n_real_nodes, got.batch_size) == (want.n_real_nodes, want.batch_size)
    assert got.nodes.dtype == want.nodes.dtype and got.nodes.tobytes() == want.nodes.tobytes()
    for name in ("edge_src", "edge_dst", "edge_mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert len(a) == len(b) == len(fanout)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
