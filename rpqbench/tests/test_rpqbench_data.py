"""The frozen inputs equal what the port's own functions give, array for
array, at seeds 0 and 1."""

import numpy as np
import pytest

from repro_torch.graph import generators as port_gen
from repro_torch.graph import partition as port_part
from repro_torch.graph import workloads as port_work
from repro_torch.graph.structure import LabeledGraph

from rpqbench.data import generators, partition, workloads


@pytest.fixture(scope="module", params=[0, 1])
def twins(request):
    return generators.alibaba_like(seed=request.param), port_gen.alibaba_like(seed=request.param), request.param


def test_rpqbench_data_alibaba_like(twins):
    mine, port, _ = twins
    assert mine.n_nodes == port.n_nodes and mine.labels == port.labels
    for a in ("src", "lbl", "dst"):
        np.testing.assert_array_equal(getattr(mine, a), getattr(port, a))


def test_rpqbench_data_table2():
    assert generators.TABLE2_QUERIES == port_gen.TABLE2_QUERIES


@pytest.mark.parametrize("n_sites", [16, 256])
def test_rpqbench_data_distribute(twins, n_sites):
    mine, port, seed = twins
    if n_sites == 256:  # the full placement's draws, on a smaller graph to keep the test's memory low
        mine, port = generators.alibaba_like(8000, 40000, seed=seed), port_gen.alibaba_like(8000, 40000, seed=seed)
    site_edges, replication = partition.distribute(mine.n_edges, n_sites, 0.2, seed=seed)
    pl = port_part.distribute(port, n_sites, 0.2, seed=seed)
    np.testing.assert_array_equal(replication, pl.replication)
    assert len(site_edges) == len(pl.site_edges)
    for a, b in zip(site_edges, pl.site_edges):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 6])
def test_rpqbench_data_random_overlay(seed):
    src, dst = partition.random_overlay(256, 3.0, seed=seed)
    net = port_part.random_overlay(256, 3.0, seed=seed)
    np.testing.assert_array_equal(src, net.adj_src)
    np.testing.assert_array_equal(dst, net.adj_dst)


def test_rpqbench_data_generate(twins):
    mine, port, seed = twins
    kw = dict(n_queries=300, hot_pool=8, hot_fraction=0.8, min_starts=1, max_starts=8, seed=seed)
    got = workloads.generate(mine, workloads.StreamConfig(**kw))
    want = port_work.generate(LabeledGraph(port.n_nodes, port.src, port.lbl, port.dst, port.labels),
                              port_work.WorkloadConfig(**kw))
    assert [(r.query, r.hot) for r in got] == [(r.query, r.hot) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.starts, b.starts)
