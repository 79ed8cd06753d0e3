"""AdamW ops: CUDA tensors -> the kernels, any other device (the CPU, meta
tensors of a dry run) -> the plain PyTorch versions.

``update`` and ``sum_of_squares`` run

  * on CUDA tensors, the hand-written kernels
    (:mod:`repro_torch.kernels.adamw.kernel`) -- they launch or raise;
  * on any other device, the plain PyTorch versions (:mod:`ref`), which are
    also the yardstick the kernels are held to on the card.

Placed leaves (DTensors) are the caller's: :mod:`repro_torch.optim.adamw`
hands these ops each rank's local shard.
"""

from __future__ import annotations

from repro_torch.kernels.adamw import kernel, ref


def update(p, g, mu, nu, step, consts):
    return (kernel.update if p.device.type == "cuda" else ref.upd_block)(p, g, mu, nu, step, consts)


def sum_of_squares(x):
    return (kernel.sum_of_squares if x.device.type == "cuda" else ref.sum_of_squares)(x)
