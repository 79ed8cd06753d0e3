"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE, LayerNorm + plain-GELU MLP (4x)
[arXiv:2402.19173; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=256,
        norm="layernorm", act="gelu", gated_mlp=False,
    )
