"""qwen3-32b: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936 —
qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].  Port of
``repro/configs/qwen3_32b.py``."""
from repro_torch.configs import lm_common
from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models import transformer as tr


def full() -> tr.LMConfig:
    return tr.LMConfig(
        name="qwen3-32b", n_layers=64, d_model=5120, n_q_heads=64, n_kv_heads=8,
        d_head=128, d_ff=25600, vocab=151936, qk_norm=True,
        microbatches=8, optimizer="adamw",
    )


register(ArchSpec("qwen3-32b", "lm", full, lambda: lm_common.lm_smoke("qwen3-32b"), LM_SHAPES))
