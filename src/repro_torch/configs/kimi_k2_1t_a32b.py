"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert
vocab=163840, MoE 384e top-8 — trillion-param MoE, 32B active
[arXiv:2501.kimi2 paper-table; unverified].  The released model uses MLA and
a shared expert; the assignment's table specifies GQA kv=8 and pure top-8
routing, which is what we implement (as :mod:`repro.configs.kimi_k2_1t_a32b` does).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=32, vocab_size=256,
        n_experts=8, top_k=2,
    )
