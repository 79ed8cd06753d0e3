"""Assigned input shapes and meta-tensor input specs per (arch, shape).

The port of :mod:`repro.configs.shapes`: the same four LM shapes and skip
rule, with ``torch.empty(shape, dtype=..., device="meta")`` in place of
``jax.ShapeDtypeStruct`` (shapes and dtypes, no storage)::

  train_4k     seq 4096,    global_batch 256   -> train step
  prefill_32k  seq 32768,   global_batch 32    -> prefill
  decode_32k   kv 32768,    global_batch 128   -> decode step (1 new token)
  long_500k    kv 524288,   global_batch 1     -> decode step; sub-quadratic
                                                  archs only (SSM / hybrid)

:func:`cache_specs` gives a decode shape's cache the same way.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(is_applicable, reason_if_not): long_500k needs a sub-quadratic arch."""
    spec = SHAPES[shape_name]
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k requires sub-quadratic attention (SSM/hybrid only); skipped per assignment"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta tensors standing in for every data input of the step (tokens,
    labels when training, an encoder-decoder's ``frames``, a VLM's
    ``vision_embeds`` and ``vision_mask``)."""
    spec = SHAPES[shape_name]
    b, s = spec.global_batch, spec.seq_len
    if spec.kind == "decode":  # one new token against a seq_len cache
        return {"tokens": _meta((b, 1), torch.int32)}
    out = {"tokens": _meta((b, s), torch.int32)}
    if spec.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
    if cfg.family == "encdec":
        out["frames"] = _meta((b, cfg.encoder_positions, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        out["vision_embeds"] = _meta((b, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        out["vision_mask"] = _meta((b, s), torch.bool)
    return out


def cache_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta tensors standing in for a decode shape's whole cache (bf16, as the
    JAX package's dry run makes it: ``global_batch`` requests of ``seq_len``
    slots; no rank's sequence slice)."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import AbstractMesh, use_compat_mesh

    spec = SHAPES[shape_name]
    with use_compat_mesh(AbstractMesh()):
        return T.init_cache(cfg, spec.global_batch, spec.seq_len, torch.bfloat16, device="meta")
