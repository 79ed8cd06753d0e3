"""The model's weights, made on the device from the seed.

The parameter names, shapes and dtypes are the program's own (its parameter
tree on the meta device); the values are the benchmark's: all leaves of one
dtype drawn by one ``normal_`` call into one buffer, each leaf a view of it,
then scaled or set by its name's rule:

* norm scales and Mamba's ``D``: ones; biases (``conv_b``, ``dt_bias``): zeros;
* Mamba's ``A_log``: ``log(1..N)`` on every channel (the S4D-real start);
* ``embed.tokens``: N(0, 1); ``conv_w``: N(0, 0.25);
* every other weight: N(0, 1 / fan_in), fan_in the size of the dimensions
  the weight contracts: the first; the first two of ``attn.wo (H, Dh, d)``;
  the second of an expert weight, a 3-D leaf under ``moe.`` (``wi_gate``,
  ``wi_up``, ``wo``: ``(E, d_in, d_out)``, one product per expert).

The same seed gives the same values on the same device, so the reference
and a run's later checks can make them again.
"""

from __future__ import annotations

import math

import torch

from bench.harness.env import derive


def _rule(name: str, shape: tuple) -> tuple[str, float]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "D"):
        return "fill", 1.0
    if leaf in ("bias", "conv_b", "dt_bias"):
        return "fill", 0.0
    if leaf == "A_log":
        return "a_log", 0.0
    if name == "embed.tokens":
        return "normal", 1.0
    if leaf == "conv_w":
        return "normal", 0.5
    if len(shape) == 3 and name.endswith("attn.wo"):
        fan_in = shape[0] * shape[1]
    elif len(shape) == 3 and name.split(".")[-2:-1] == ["moe"]:
        fan_in = shape[1]
    else:
        fan_in = shape[0]
    return "normal", 1.0 / math.sqrt(fan_in)


def _named(tree: dict) -> list[tuple[str, dict, str]]:
    """``(full name, dict holding it, key)`` of every leaf."""
    out = [(k, tree, k) for k in sorted(tree) if k != "layers"]
    for i, layer in enumerate(tree.get("layers", [])):
        out += [(f"layers.{i}.{k}", layer, k) for k in sorted(layer)]
    return out


def make(shapes: dict, seed: int, device) -> dict:
    """A parameter tree like ``shapes`` (meta tensors) with the benchmark's values on ``device``."""
    out = {k: v for k, v in shapes.items() if k != "layers"}
    out["layers"] = [dict(layer) for layer in shapes.get("layers", [])]
    leaves = _named(out)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    by_dtype: dict[torch.dtype, list] = {}
    for entry in leaves:
        by_dtype.setdefault(entry[1][entry[2]].dtype, []).append(entry)
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        flat = torch.empty(sum(d[k].numel() for _, d, k in group), dtype=dtype, device=device)
        flat.normal_(generator=gen)
        at = 0
        for name, holder, key in group:
            shape = tuple(holder[key].shape)
            n = math.prod(shape)
            view = flat[at:at + n].view(shape)
            at += n
            kind, value = _rule(name, shape)
            if kind == "fill":
                view.fill_(value)
            elif kind == "a_log":
                view.copy_(torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)).expand(shape))
            else:
                view.mul_(value)
            holder[key] = view
    return out
