"""granite-moe-1b-a400m: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base;
hf].  Port of ``repro/configs/granite_moe_1b_a400m.py``."""
from repro_torch.configs import lm_common
from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models import transformer as tr


def full() -> tr.LMConfig:
    return tr.LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_q_heads=16,
        n_kv_heads=8, d_head=64, d_ff=512, vocab=49155,
        n_experts=32, top_k=8, microbatches=4, optimizer="adamw",
    )


register(ArchSpec(
    "granite-moe-1b-a400m", "lm", full,
    lambda: lm_common.lm_smoke("granite-moe-1b-a400m", moe=True), LM_SHAPES,
))
