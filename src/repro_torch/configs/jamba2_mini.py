"""jamba2-mini [jamba] — 32L d_model=4096, a period of 8 layers: Mamba-1
mixers (inner 8192, state 16, dt rank 256, RMS norms on dt / B / C) with
grouped-query attention (32H, kv=8, head 128, no RoPE) at i % 8 == 4;
feed-forwards alternating a dense SwiGLU (d_ff=14336) at even i and a
dropless top-2 mixture of 16 experts (width 14336, weights not renormalised)
at odd i; vocab=65536, untied head [hf:ai21labs/AI21-Jamba2-Mini].

The port only: the JAX package has no such family, so this architecture is
registered in :data:`repro_torch.configs.PORT_ONLY_ARCHS`."""

from repro_torch.models.config import ModelConfig

#: Jamba's period: attention where ``i % 8 == 4``, a mixture of experts where ``i % 2 == 1``.
PERIOD = ("mamba_mlp", "mamba_moe", "mamba_mlp", "mamba_moe", "attn_mlp", "mamba_moe", "mamba_mlp", "mamba_moe")

CONFIG = ModelConfig(
    name="jamba2-mini",
    family="jamba",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_impl="dropless",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    dt_rank=256,
    block_pattern=PERIOD,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba2-mini-smoke", family="jamba", n_layers=8, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256, n_experts=4, top_k=2, moe_impl="dropless",
        ssm_state=4, dt_rank=8, block_pattern=PERIOD,
    )
