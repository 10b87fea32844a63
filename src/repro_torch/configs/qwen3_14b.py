"""qwen3-14b: 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936 —
qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].  Port of
``repro/configs/qwen3_14b.py``."""
from repro_torch.configs import lm_common
from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models import transformer as tr


def full() -> tr.LMConfig:
    return tr.LMConfig(
        name="qwen3-14b", n_layers=40, d_model=5120, n_q_heads=40, n_kv_heads=8,
        d_head=128, d_ff=17408, vocab=151936, qk_norm=True,
        microbatches=4, optimizer="adamw",
    )


register(ArchSpec("qwen3-14b", "lm", full, lambda: lm_common.lm_smoke("qwen3-14b"), LM_SHAPES))
