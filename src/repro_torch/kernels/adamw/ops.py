"""AdamW ops: CUDA tensors -> the kernels, any other device (the CPU, meta
tensors of a dry run) -> the plain PyTorch versions.

``update`` and ``sum_of_squares`` run

  * on CUDA tensors, the hand-written kernels
    (:mod:`repro_torch.kernels.adamw.kernel`) -- they launch or raise;
  * on any other device, the plain PyTorch versions (:mod:`ref`), which are
    also the yardstick the kernels are held to on the card.  The plain update
    is element by element, so it takes a leaf in blocks of
    :data:`UPDATE_ELEMENTS` (the same bits as the whole leaf at once, with a
    block's float32 temporaries).

Placed leaves (DTensors) are the caller's: :mod:`repro_torch.optim.adamw`
hands these ops each rank's local shard.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.adamw import kernel, ref

#: Elements of a leaf the plain update takes at a time: a step's float32 temporaries are a
#: few blocks of this size (256 MB each), not a few copies of the biggest leaf.
UPDATE_ELEMENTS = 1 << 26


def update(p, g, mu, nu, step, consts):
    """``(new_p, new_mu, new_nu)`` of one leaf (see the module)."""
    if p.device.type == "cuda":
        return kernel.update(p, g, mu, nu, step, consts)
    if p.numel() <= UPDATE_ELEMENTS:  # one block: its outputs
        return ref.upd_block(p, g, mu, nu, step, consts)
    outs = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (p, mu, nu))
    flat = [x.reshape(-1) for x in (p, g, mu, nu)]
    for i in range(0, p.numel(), UPDATE_ELEMENTS):
        block = ref.upd_block(*(x[i:i + UPDATE_ELEMENTS] for x in flat), step, consts)
        for o, b in zip(outs, block):
            o.view(-1)[i:i + UPDATE_ELEMENTS].copy_(b)
    return outs


def sum_of_squares(x):
    return (kernel.sum_of_squares if x.device.type == "cuda" else ref.sum_of_squares)(x)
