"""Shared LM config and input plumbing for the five transformer archs.

Port of ``repro/configs/lm_common.py``; the input specs are meta-device
tensors, the twin of ``jax.ShapeDtypeStruct``, and the smoke batches
hold ``repro``'s values."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ShapeSpec
from repro_torch.models import transformer as tr


def lm_smoke(name: str, moe: bool = False) -> tr.LMConfig:
    return tr.LMConfig(
        name=name, n_layers=2, d_model=64, n_q_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128 if not moe else 64, vocab=211, qk_norm=True,
        n_experts=4 if moe else 0, top_k=2 if moe else 0, microbatches=1,
        dtype=torch.float32,
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def lm_input_specs(cfg: tr.LMConfig, shape: ShapeSpec) -> dict:
    """Meta-device stand-ins of a step's inputs (no allocation)."""
    b, s = shape.dims["batch"], shape.dims["seq"]
    i32 = torch.int32
    if shape.kind == "train":
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    if shape.kind == "prefill":
        return {"tokens": _meta((b, s), i32)}
    if shape.kind == "decode":
        kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
        return {
            "cache": {"k": _meta(kv, cfg.dtype), "v": _meta(kv, cfg.dtype), "len": _meta((), i32)},
            "tokens": _meta((b,), i32),
        }
    raise ValueError(shape.kind)


def lm_smoke_batch(cfg: tr.LMConfig, kind: str, seed: int = 0, device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def ints(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int32)).to(device)

    if kind == "train":
        toks = rng.integers(0, cfg.vocab, (4, 32))
        return {"tokens": ints(toks), "labels": ints(np.roll(toks, -1, 1))}
    if kind == "prefill":
        return {"tokens": ints(rng.integers(0, cfg.vocab, (2, 32)))}
    if kind == "decode":
        cache = tr.init_cache(cfg, batch=2, max_len=64, device=device)
        cache["len"] = torch.tensor(7, dtype=torch.int32, device=device)
        return {"cache": cache, "tokens": ints(rng.integers(0, cfg.vocab, (2,)))}
    raise ValueError(kind)
