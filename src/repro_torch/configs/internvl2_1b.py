"""internvl2-1b [vlm] — InternViT frontend (stubbed) + Qwen2-0.5B-class LM
backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
[arXiv:2404.16821; hf].  The assignment specifies the transformer backbone
only; ``vision_embeds`` arrive precomputed (patch-embedding stub)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    vision_tokens=256,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        vision_tokens=4,
        rope_theta=1e6,
    )
