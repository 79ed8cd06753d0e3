"""Model configuration: one dataclass drives every architecture family.

A copy of :mod:`repro.models.config` (the port imports nothing of the JAX
package), so a config built here describes the same model as there.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | jamba
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_impl: str = "dense"  # dense (apply_moe) | ep (expert parallelism over the model axis: moe_ep.py) | dropless

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    # --- hybrid (recurrentgemma): RG-LRU + local attention ---
    window: int = 0  # local-attention window
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn"); jamba: ("mamba_mlp", "attn_moe", ...)
    rnn_width: int = 0  # 0 -> d_model

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_positions: int = 0  # frames after the (stubbed) conv frontend

    # --- vlm ---
    vision_tokens: int = 0  # patch embeddings per image (stub frontend)

    # --- common ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (GLU) | gelu (plain MLP)
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    learned_pos: bool = False  # whisper
    max_position: int = 1 << 20
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.family in ("ssm", "jamba") and self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))
        if self.family == "hybrid" and self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (TPU lanes / mesh-divisible)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (assignment: SSM/hybrid/linear only)"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        total += d  # final norm

        def attn_params(n_heads, n_kv, d_head):
            return d * n_heads * d_head + 2 * d * n_kv * d_head + n_heads * d_head * d

        def mlp_params(d_ff, gated):
            return d * d_ff * (3 if gated else 2)

        if self.family == "jamba":
            return total + sum(self._jamba_layer_params(kind) for kind in self._jamba_kinds())
        if self.family == "ssm":
            di, n, r = self.d_inner, self.ssm_state, self.dt_rank
            per = (
                d * 2 * di  # in_proj
                + di * self.ssm_conv  # conv
                + di * (r + 2 * n)  # x_proj
                + r * di + di  # dt_proj
                + di * n + di  # A_log, D
                + di * d  # out_proj
                + d  # norm
            )
            return total + self.n_layers * per
        if self.family == "hybrid":
            pattern = self.block_pattern or ("rec",)
            rec = (
                d * 2 * self.rnn_width  # x/gate proj
                + self.rnn_width * self.ssm_conv
                + 2 * self.rnn_width * self.rnn_width  # rg-lru input/recurrence gates (diag-blocks approx)
                + self.rnn_width  # Lambda
                + self.rnn_width * d
                + d
            )
            att = attn_params(self.n_heads, self.n_kv_heads, self.d_head) + d
            mlp = mlp_params(self.d_ff, self.gated_mlp) + d
            per_layer = []
            for i in range(self.n_layers):
                kind = pattern[i % len(pattern)]
                per_layer.append((rec if kind == "rec" else att) + mlp)
            return total + sum(per_layer)

        att = attn_params(self.n_heads, self.n_kv_heads, self.d_head) + d
        if self.family == "moe":
            ff = self.n_experts * mlp_params(self.d_ff, self.gated_mlp) + d * self.n_experts
            if self.dense_residual:
                ff += mlp_params(self.d_ff, self.gated_mlp)
        else:
            ff = mlp_params(self.d_ff, self.gated_mlp)
        per = att + ff + d
        layers = self.n_layers
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = att + mlp_params(self.d_ff, self.gated_mlp) + 2 * d
            dec = 2 * att + mlp_params(self.d_ff, self.gated_mlp) + 3 * d
            return total + self.encoder_layers * enc + self.n_layers * dec + self.encoder_positions * d
        return total + layers * per

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family not in ("moe", "jamba"):
            return self.param_count()
        d = self.d_model
        expert = d * self.d_ff * (3 if self.gated_mlp else 2)
        inactive = (self.n_experts - self.top_k) * expert
        moe_layers = self.n_layers if self.family == "moe" else sum(k.endswith("_moe") for k in self._jamba_kinds())
        return self.param_count() - moe_layers * inactive

    def _jamba_kinds(self) -> list[str]:
        return [self.block_pattern[i % len(self.block_pattern)] for i in range(self.n_layers)]

    def _jamba_layer_params(self, kind: str) -> int:
        """One jamba layer's parameters, every one the port makes: the two norms,
        the mixer (Mamba-1 with its conv bias and dt / B / C norms, or
        attention) and the feed-forward (the router and every expert, or the
        dense MLP)."""
        d, di, n, r = self.d_model, self.d_inner, self.ssm_state, self.dt_rank
        mixer, ffn = kind.split("_")
        if mixer == "mamba":
            mix = (d * 2 * di + di * self.ssm_conv + di + di * (r + 2 * n) + r * di + di + di * n + di + di * d
                   + r + 2 * n)
        else:
            mix = 2 * d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head
        mlp = d * self.d_ff * (3 if self.gated_mlp else 2)
        ff = d * self.n_experts + self.n_experts * mlp if ffn == "moe" else mlp
        return 2 * d + mix + ff
