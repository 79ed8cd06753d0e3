"""whisper-large-v3 [audio] — enc-dec, 32L(+32L enc) d_model=1280 20H (MHA
kv=20) d_ff=5120 vocab=51866 — conv/mel frontend stubbed: ``frames`` arrive
as precomputed embeddings (B, 1500, d) [arXiv:2212.04356; unverified]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    encoder_layers=32,
    encoder_positions=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    learned_pos=True,
    max_position=1 << 16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec", n_layers=2, encoder_layers=2,
        encoder_positions=8, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, norm="layernorm", act="gelu", gated_mlp=False,
        learned_pos=True, max_position=4096,
    )
