"""Models of the port: all six families of the JAX package's model zoo, as
config-driven PyTorch models.

Families: dense GQA transformers, MoE (expert-parallel with
``moe_impl="ep"``), Mamba-1 SSM, the RG-LRU / local-attention hybrid, the
Whisper-style encoder-decoder, and a VLM backbone with a stubbed vision
frontend.  Parameters are the JAX package's pytree as a plain dict of
tensors (the same names, shapes and dtypes), paired with a logical-axes tree
for sharding (:mod:`repro_torch.parallel.sharding`), and every layer is a
plain function over ``(config, params, activations)``, as in
:mod:`repro.models`.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_axes,
    prefill,
)

__all__ = [
    "ModelConfig",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "param_axes",
    "prefill",
]
