"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 1:2 ratio (pattern rec,rec,attn),
window 2048 [arXiv:2402.19427; unverified]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    rnn_width=4096,
    ssm_conv=4,
    norm="rmsnorm",
    act="gelu",
    gated_mlp=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke", family="hybrid", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=256,
        window=16, block_pattern=("rec", "rec", "attn"), rnn_width=64,
        act="gelu",
    )
