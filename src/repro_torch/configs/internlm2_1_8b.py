"""internlm2-1.8b: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544 —
GQA [arXiv:2403.17297; hf].  Port of
``repro/configs/internlm2_1_8b.py``."""
from repro_torch.configs import lm_common
from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models import transformer as tr


def full() -> tr.LMConfig:
    return tr.LMConfig(
        name="internlm2-1.8b", n_layers=24, d_model=2048, n_q_heads=16, n_kv_heads=8,
        d_head=128, d_ff=8192, vocab=92544, qk_norm=False,
        microbatches=2, optimizer="adamw",
    )


register(ArchSpec("internlm2-1.8b", "lm", full, lambda: lm_common.lm_smoke("internlm2-1.8b"), LM_SHAPES))
