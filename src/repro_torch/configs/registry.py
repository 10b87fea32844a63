"""Architecture registry.

Port of ``repro/configs/registry.py``.  Each arch file registers an
:class:`ArchSpec` with ``full()`` (the exact assigned configuration),
``smoke()`` (a reduced same-family config for CPU tests) and ``shapes``
(the assigned input-shape set).  The port loads all eleven: the paper's
RPQ system, dlrm-mlperf, the five LMs and the four GNNs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval
    dims: dict[str, int]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | rpq
    full: Callable[[], Any]
    smoke: Callable[[], Any]
    shapes: dict[str, ShapeSpec]
    notes: str = ""


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        alibaba_rpq,
        dlrm_mlperf,
        equiformer_v2,
        gcn_cora,
        granite_moe_1b_a400m,
        internlm2_1_8b,
        kimi_k2_1t_a32b,
        nequip,
        qwen3_14b,
        qwen3_32b,
        schnet,
    )


# ---------------------------------------------------------------------------
# Shared shape tables
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode", {"seq": 32768, "batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode", {"seq": 524288, "batch": 1}),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train", {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg",
        "train",
        {
            "n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
            "fanout0": 15, "fanout1": 10, "d_feat": 602,
        },
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "train", {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}
    ),
    "molecule": ShapeSpec(
        "molecule", "train", {"n_nodes": 30, "n_edges": 64, "batch": 128}
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}
    ),
}

RPQ_SHAPES = {
    "serve_queries": ShapeSpec(
        "serve_queries", "serve", {"n_nodes": 50000, "n_edges": 340000, "batch": 128}
    ),
    "estimate": ShapeSpec("estimate", "serve", {"n_rollouts": 8192}),
}
