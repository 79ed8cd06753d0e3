"""The whole model around the layers of :mod:`bench.reference.dense` and
:mod:`bench.reference.ssm`: the token embedding, the layers, the final
RMSNorm and the output head ``unembed (d, V)``; the logits a server's tokens
are judged by, and the training loss with its gradients.

``params`` is the configuration's parameter dict (``embed.tokens``,
``unembed``, ``final_norm.scale``, ``layers``: a list of per-layer dicts).
Serving takes its tensors as they are and computes each layer in float32;
training takes float32 leaves that require grad.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint

from bench.reference import dense, ssm
from bench.reference.common import cross_entropy_sum, exact_float32, mm, rms_norm

LAYERS = {"dense": dense.layer, "ssm": ssm.layer}
#: Positions of the output head computed at a time in the loss (the float32 logits of a chunk).
LOSS_CHUNK = 1024


def _float(p: dict) -> dict:
    return {k: v.float() for k, v in p.items()}


def _layer_fn(m: dict, eps: float, precision: str):
    if m["family"] not in LAYERS:
        raise ValueError(f"the reference has no {m['family']!r} family; it has {tuple(LAYERS)}")
    fn = LAYERS[m["family"]]

    def run(p: dict, x: torch.Tensor) -> torch.Tensor:
        return fn(m, _float(p), x, eps, precision)

    return run


def hidden(m: dict, params: dict, tokens: torch.Tensor, eps: float, precision: str = "fp32", *,
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states ``(B, S, d)`` of ``tokens (B, S)``;
    ``remat`` recomputes each layer in the backward (training)."""
    run = _layer_fn(m, eps, precision)
    x = params["embed.tokens"].float()[tokens.long()]
    for p in params["layers"]:
        x = checkpoint.checkpoint(run, p, x, use_reentrant=False) if remat else run(p, x)
    return rms_norm(x, params["final_norm.scale"].float(), eps)


@torch.no_grad()
def logits_at(m: dict, params: dict, tokens: torch.Tensor, positions, eps: float,
              precision: str = "fp32") -> torch.Tensor:
    """Float32 logits ``(B, len(positions), V)`` at the given positions of each row."""
    with exact_float32():
        h = hidden(m, params, tokens, eps, precision)[:, list(positions)]
        return mm(h, params["unembed"].float(), precision)


def loss(m: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor, eps: float,
         precision: str = "fp32") -> torch.Tensor:
    """Mean next-token cross-entropy over every position (float32), the head
    and the log-sum-exp taken a chunk of positions at a time."""
    h = hidden(m, params, tokens, eps, precision, remat=True)
    w = params["unembed"]
    h2, lab = h.reshape(-1, h.shape[-1]), labels.reshape(-1)

    def chunk(hc, lc, w):
        return cross_entropy_sum(mm(hc, w, precision), lc)

    total = sum(checkpoint.checkpoint(chunk, h2[i:i + LOSS_CHUNK], lab[i:i + LOSS_CHUNK], w, use_reentrant=False)
                for i in range(0, h2.shape[0], LOSS_CHUNK))
    return total / h2.shape[0]
