"""dlrm-mlperf: MLPerf DLRM (Criteo 1TB) [arXiv:1906.00091].  Port of
``repro/configs/dlrm_mlperf.py``; the input specs are meta-device
tensors, and the smoke batches hold ``repro``'s values."""
import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES, ShapeSpec, register
from repro_torch.models import dlrm


def full() -> dlrm.DLRMConfig:
    return dlrm.DLRMConfig()


def smoke() -> dlrm.DLRMConfig:
    return dlrm.DLRMConfig(
        table_sizes=(64, 48, 32), n_sparse=3, embed_dim=8, n_dense=5,
        bot_mlp=(16, 8), top_mlp=(16, 8, 1),
    )


def input_specs(cfg: dlrm.DLRMConfig, shape: ShapeSpec) -> dict:
    b = shape.dims["batch"]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    spec = {
        "dense": meta((b, cfg.n_dense), torch.float32),
        "sparse": meta((b, cfg.n_sparse, cfg.multi_hot), torch.int32),
    }
    if shape.kind == "train":
        spec["labels"] = meta((b,), torch.int32)
    if shape.kind == "retrieval":
        spec["candidates"] = meta((shape.dims["n_candidates"], cfg.embed_dim), torch.float32)
    return spec


def smoke_batch(cfg: dlrm.DLRMConfig, kind: str, seed: int = 0, device=None) -> dict:
    device = resolve_device(device)
    r = np.random.default_rng(seed)
    b = 8 if kind != "retrieval" else 1

    def tensor(a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    batch = {
        "dense": tensor(r.normal(size=(b, cfg.n_dense)), np.float32),
        "sparse": tensor(r.integers(0, min(cfg.table_sizes), (b, cfg.n_sparse, cfg.multi_hot)), np.int32),
    }
    if kind == "train":
        batch["labels"] = tensor(r.integers(0, 2, b), np.int32)
    if kind == "retrieval":
        batch["candidates"] = tensor(r.normal(size=(512, cfg.embed_dim)), np.float32)
    return batch


register(ArchSpec("dlrm-mlperf", "recsys", full, smoke, RECSYS_SHAPES))
