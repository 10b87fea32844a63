"""Shared GNN config and input plumbing for the four graph archs.

Port of ``repro/configs/gnn_common.py``; the input specs are meta-device
tensors, the twin of ``jax.ShapeDtypeStruct``, and the smoke batches
hold ``repro``'s values."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ShapeSpec
from repro_torch.models import gnn


def shape_counts(shape: ShapeSpec) -> tuple[int, int, int]:
    """(n_nodes, n_edges, n_graphs) of the lowered batch for a shape."""
    d = shape.dims
    if shape.name == "minibatch_lg":
        b, f0, f1 = d["batch_nodes"], d["fanout0"], d["fanout1"]
        nodes = b + b * f0 + b * f0 * f1
        edges = b * f0 + b * f0 * f1
        return nodes, edges, 1
    if shape.name == "molecule":
        return d["n_nodes"] * d["batch"], d["n_edges"] * d["batch"], d["batch"]
    return d["n_nodes"], d["n_edges"], 1


def pad_edges(e: int, shards: int = 512) -> int:
    return -(-e // shards) * shards


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def gnn_input_specs(cfg, shape: ShapeSpec, needs_feat: bool) -> dict:
    """Meta-device stand-ins of a step's inputs (no allocation)."""
    n, e, g = shape_counts(shape)
    big_equi = getattr(cfg, "name", "") == "equiformer-v2" and n >= 150_000
    if big_equi:
        # node rows shard over model(16) × data(≤32); edge chunks of 32k
        # must divide the per-data-shard edge count on both meshes
        n = -(-n // 512) * 512
        e = -(-e // (1 << 20)) * (1 << 20)
    else:
        e = pad_edges(e)
    i32, f32, b = torch.int32, torch.float32, torch.bool
    spec = {
        "edge_src": _meta((e,), i32),
        "edge_dst": _meta((e,), i32),
        "edge_mask": _meta((e,), b),
        "node_mask": _meta((n,), b),
    }
    if needs_feat:
        spec["node_feat"] = _meta((n, shape.dims.get("d_feat", 16)), f32)
        spec["labels"] = _meta((n,), i32)
        spec["train_mask"] = _meta((n,), b)
    else:
        spec["species"] = _meta((n,), i32)
        spec["positions"] = _meta((n, 3), f32)
        spec["energy"] = _meta((g,), f32)
        if g > 1:
            spec["graph_ids"] = _meta((n,), i32)
    return spec


def gnn_smoke_batch(
    needs_feat: bool, n=24, e=64, d_feat=8, n_classes=4, g=2, seed=0, device=None
) -> dict:
    """``repro``'s smoke batch, drawn from ``seed`` in the same order, as
    tensors on ``device`` (None: the GPU)."""
    device = resolve_device(device)
    r = np.random.default_rng(seed)
    batch = {
        "edge_src": r.integers(0, n, e).astype(np.int32),
        "edge_dst": r.integers(0, n, e).astype(np.int32),
        "edge_mask": np.ones((e,), bool),
        "node_mask": np.ones((n,), bool),
    }
    if needs_feat:
        batch["node_feat"] = r.normal(size=(n, d_feat)).astype(np.float32)
        batch["labels"] = r.integers(0, n_classes, n).astype(np.int32)
        batch["train_mask"] = r.random(n) < 0.5
    else:
        batch["species"] = r.integers(0, 5, n).astype(np.int32)
        batch["positions"] = (r.normal(size=(n, 3)) * 2).astype(np.float32)
        batch["graph_ids"] = np.sort(r.integers(0, g, n)).astype(np.int32)
        batch["energy"] = r.normal(size=(g,)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def gcn_for_shape(cfg: gnn.GCNConfig, shape: ShapeSpec) -> gnn.GCNConfig:
    """GCN's input width/classes track the dataset of each shape."""
    classes = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47, "molecule": 8}
    return dataclasses.replace(
        cfg,
        d_feat=shape.dims.get("d_feat", 16),
        n_classes=classes.get(shape.name, 8),
    )
