"""Deterministic synthetic data pipelines.

Port of ``repro/data/pipeline.py``: the same numpy draws, returned as
torch tensors with the same bytes, on ``device`` (None: the GPU, as
``repro``'s arrays land on its default device).  Every batch is a pure
function of ``(seed, step, shard)``: any host can recompute any shard's
batch with no data-server affinity, so a restarted or reassigned worker
resumes exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _on(device, **arrays) -> dict:
    device = resolve_device(device)
    return {name: torch.from_numpy(np.ascontiguousarray(a)).to(device) for name, a in arrays.items()}


def lm_batch(
    vocab: int, batch: int, seq: int, step: int, seed: int = 0, shard: int = 0, n_shards: int = 1,
    device=None,
) -> dict:
    """Markov-chain token stream: deterministic in (seed, step, shard)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard]))
    b = batch // n_shards
    # cheap structured stream: random walk over vocab with local coherence
    start = rng.integers(0, vocab, (b, 1))
    steps = rng.integers(-7, 8, (b, seq))
    toks = (start + np.cumsum(steps, axis=1)) % vocab
    labels = np.roll(toks, -1, axis=1)
    return _on(device, tokens=toks.astype(np.int32), labels=labels.astype(np.int32))


def dlrm_batch(
    table_sizes, n_dense: int, multi_hot: int, batch: int, step: int, seed: int = 0, device=None
) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    sparse = np.stack(
        [rng.integers(0, rows, (batch, multi_hot)) for rows in table_sizes], axis=1
    )
    return _on(
        device,
        dense=rng.normal(size=(batch, n_dense)).astype(np.float32),
        sparse=sparse.astype(np.int32),
        labels=rng.integers(0, 2, batch).astype(np.int32),
    )


def cora_like_batch(
    n_nodes: int, n_edges: int, d_feat: int, n_classes: int, seed: int = 0, device=None
) -> dict:
    """Citation-graph-like synthetic batch (full-batch node classification)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    labels = rng.integers(0, n_classes, n_nodes)
    # features weakly correlated with labels so training actually learns
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    feat[:, :n_classes] += np.eye(n_classes)[labels] * 2.0
    return _on(
        device,
        node_feat=feat,
        edge_src=src.astype(np.int32),
        edge_dst=dst.astype(np.int32),
        edge_mask=np.ones((n_edges,), bool),
        node_mask=np.ones((n_nodes,), bool),
        labels=labels.astype(np.int32),
        train_mask=rng.random(n_nodes) < 0.6,
    )


def molecules_batch(n_graphs: int, nodes_per: int, edges_per: int, seed: int = 0, device=None) -> dict:
    """Batched small molecules with a learnable synthetic energy target."""
    rng = np.random.default_rng(seed)
    N = n_graphs * nodes_per
    species = rng.integers(0, 5, N)
    positions = rng.normal(size=(N, 3)) * 1.5
    src_l, dst_l = [], []
    for g in range(n_graphs):
        base = g * nodes_per
        src_l.append(base + rng.integers(0, nodes_per, edges_per))
        dst_l.append(base + rng.integers(0, nodes_per, edges_per))
    graph_ids = np.repeat(np.arange(n_graphs), nodes_per)
    # synthetic target: species-weighted pair potential (invariant)
    energy = np.zeros(n_graphs, np.float32)
    for g in range(n_graphs):
        sl = slice(g * nodes_per, (g + 1) * nodes_per)
        p = positions[sl]
        d = np.linalg.norm(p[:, None] - p[None, :], axis=-1) + np.eye(nodes_per)
        energy[g] = float((1.0 / d).sum() * 0.01 + species[sl].sum() * 0.1)
    return _on(
        device,
        species=species.astype(np.int32),
        positions=positions.astype(np.float32),
        edge_src=np.concatenate(src_l).astype(np.int32),
        edge_dst=np.concatenate(dst_l).astype(np.int32),
        edge_mask=np.ones((n_graphs * edges_per,), bool),
        node_mask=np.ones((N,), bool),
        graph_ids=graph_ids.astype(np.int32),
        energy=energy,
    )
