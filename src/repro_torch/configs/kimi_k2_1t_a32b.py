"""kimi-k2-1t-a32b: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE [arXiv:2501.kimi2;
unverified].

Port of ``repro/configs/kimi_k2_1t_a32b.py``: Adafactor and FSDP-sharded
expert weights, the rest-sharding as ``Rules`` overrides (expert tensors
(L, E, d_in, d_ff): experts over ``model``, the d_ff "rest" dim over the
data axes).  On one card ``layers.apply_moe`` runs its experts on
their routed rows; over ranks its expert-parallel program runs each
rank's experts on its d_ff block, gathered for the layer
(``fsdp_experts``).  The overrides name the placements a layout fits."""
from repro_torch.configs import lm_common
from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models import transformer as tr

# pattern -> placement pairs consumed by tr.rules_for() / Rules.from_mesh(overrides=...)
SHARDING_OVERRIDES = (
    ("params/*/moe/w_gate", (None, "model", None, ("pod", "data"))),
    ("params/*/moe/w_up", (None, "model", None, ("pod", "data"))),
    ("params/*/moe/w_down", (None, "model", ("pod", "data"), None)),
)


def full() -> tr.LMConfig:
    return tr.LMConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_q_heads=64,
        n_kv_heads=8, d_head=112, d_ff=2048, vocab=163840,
        n_experts=384, top_k=8, microbatches=8,
        optimizer="adafactor", fsdp_experts=True,
        sharding_overrides=SHARDING_OVERRIDES,
    )


register(ArchSpec(
    "kimi-k2-1t-a32b", "lm", full,
    lambda: lm_common.lm_smoke("kimi-k2-1t-a32b", moe=True), LM_SHAPES,
))
