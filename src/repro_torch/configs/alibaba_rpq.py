"""alibaba-rpq: the paper's own system, batched distributed RPQ serving
over arbitrarily distributed edges (S2 executor), plus the
cost-estimation rollout engine.

Port of ``repro/configs/alibaba_rpq.py``; the input specs are
meta-device tensors, the twin of ``jax.ShapeDtypeStruct``."""
import dataclasses

import torch

from repro_torch.configs.registry import ArchSpec, RPQ_SHAPES, ShapeSpec, register


@dataclasses.dataclass(frozen=True)
class RPQConfig:
    name: str = "alibaba-rpq"
    n_nodes: int = 50000
    n_sites: int = 256
    query: str = "q1"  # Table-2 query id used for the lowered automaton
    replication_rate: float = 0.2
    max_levels: int = 64


def full() -> RPQConfig:
    return RPQConfig()


def smoke() -> RPQConfig:
    return RPQConfig(n_nodes=64, n_sites=4, max_levels=16)


def input_specs(cfg: RPQConfig, shape: ShapeSpec, n_edges_padded: int) -> dict:
    s = cfg.n_sites

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "src": meta((s, n_edges_padded), torch.int32),
        "lbl": meta((s, n_edges_padded), torch.int32),
        "dst": meta((s, n_edges_padded), torch.int32),
        "mask": meta((s, n_edges_padded), torch.bool),
        "starts": meta((shape.dims["batch"],), torch.int32),
    }


register(ArchSpec("alibaba-rpq", "rpq", full, smoke, RPQ_SHAPES))
