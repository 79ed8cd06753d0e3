"""Parameters: random init on a device, and the carry-across from the JAX package.

The parameters are the JAX package's pytree as a plain dict with the same
names, shapes and dtypes::

    {"embed.tokens": (V_pad, d), "unembed": (d, V_pad), "final_norm.scale": (d,),
     "layers": [{"norm1.scale": ..., "attn.wq": (d, H, Dh), ...}, ...]}

(an encoder-decoder adds ``"encoder"``, a second list of layers, and
``encoder_norm.*`` at the top level: :data:`LAYER_LISTS`).

:class:`ParamBuilder` draws each dense weight from a truncated normal in
[-2, 2] times ``std = 1 / sqrt(fan_in)`` (or a given scale; ``fan_in`` is
``shape[0]``, the number of experts for an expert weight, as in the JAX
package) from an explicit ``torch.Generator`` on the target device, in
slices of at most :data:`DRAW_ELEMENTS` elements along the first axis, so
that the float32 transients of a draw stay small beside the weight (one
expert weight of kimi-k2 is 5.6 G elements).  The numbers differ from
``jax.random``'s for the same seed; :func:`from_jax` carries the JAX
package's own init across instead, for the tests that compare the two, and
:func:`state_from_jax` the whole training state a checkpoint holds
(parameters and the AdamW state ``{"mu", "nu", "step"}``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ERF_SQRT2 = math.erf(math.sqrt(2.0))  # 2 * Phi(2) - 1: the [-2, 2] cut of a unit normal
#: The parameter dict's lists of per-layer dicts (``"encoder"``: enc-dec only).
LAYER_LISTS = ("layers", "encoder")
#: Most elements one draw of :meth:`ParamBuilder.dense` makes at a time (256 MB of float32).
DRAW_ELEMENTS = 1 << 26


def truncated_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """float32 unit normal truncated to [-2, 2], by inverting the CDF of a
    uniform draw (as ``torch.nn.init.trunc_normal_`` does)."""
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(-_ERF_SQRT2, _ERF_SQRT2, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


class ParamBuilder:
    """Accumulates ``{name: tensor}`` for one parameter group (a layer, or the
    embeddings), in the model's dtype unless told otherwise, and beside it
    ``{name: logical axes}`` (one name or ``None`` per dimension, the JAX
    package's ``ParamBuilder.axes``; :mod:`repro_torch.parallel.sharding` maps
    them onto a mesh)."""

    def __init__(self, generator: torch.Generator, device, dtype: torch.dtype):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.params: dict[str, torch.Tensor] = {}
        self.axes: dict[str, tuple] = {}

    def dense(self, name: str, shape: tuple[int, ...], axes: tuple, scale: float | None = None):
        std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        if self.device.type != "meta":
            rows = max(1, DRAW_ELEMENTS // max(1, math.prod(shape[1:])))
            for i in range(0, shape[0], rows):
                n = min(rows, shape[0] - i)
                out[i:i + n] = truncated_normal((n, *shape[1:]), self.generator, self.device).mul_(std)
        return self._add(name, out, axes)

    def zeros(self, name: str, shape: tuple[int, ...], axes: tuple, dtype=None):
        return self._add(name, torch.zeros(shape, dtype=dtype or self.dtype, device=self.device), axes)

    def ones(self, name: str, shape: tuple[int, ...], axes: tuple, dtype=None):
        return self._add(name, torch.ones(shape, dtype=dtype or self.dtype, device=self.device), axes)

    def const(self, name: str, value: torch.Tensor, axes: tuple):
        return self._add(name, value.to(self.device), axes)

    def _add(self, name: str, value: torch.Tensor, axes: tuple):
        if len(axes) != value.dim():
            raise ValueError(f"{name}: {len(axes)} logical axes for a {value.dim()}-d parameter")
        self.params[name] = value
        self.axes[name] = tuple(axes)
        return self


def model_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _tensor(x: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bfloat16 included: JAX's bf16 arrays reach numpy as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so their bits
    go across as int16."""
    x = np.array(x, order="C")  # a copy: torch must not share a read-only buffer
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def from_jax(cfg, params_np: dict, device, *, dtype: torch.dtype | None = None) -> dict:
    """The JAX package's parameters (its pytree with numpy leaves) as the
    port's, on ``device``.  Raises unless every name, shape and dtype is the
    one the port's own init makes for ``cfg`` (every dtype ``dtype`` when it
    is given: an optimizer moment tree)."""
    from repro_torch.models.transformer import init_params

    want = init_params(cfg, seed=0, device="meta")
    device = torch.device(device)

    def carry(got: dict, spec: dict, where: str) -> dict:
        if set(got) != set(spec):
            raise ValueError(f"{where}: names {sorted(got)} differ from {sorted(spec)}")
        out = {}
        for name, w in spec.items():
            t = _tensor(np.asarray(got[name]))
            if tuple(t.shape) != tuple(w.shape) or t.dtype != (dtype or w.dtype):
                raise ValueError(
                    f"{where}{name}: {t.dtype}{tuple(t.shape)} differs from the port's {w.dtype}{tuple(w.shape)}"
                )
            out[name] = t.to(device)
        return out

    lists = [name for name in LAYER_LISTS if name in want]
    for name in LAYER_LISTS:
        got, spec = params_np.get(name), want.get(name)
        if (got is None) != (spec is None) or (spec is not None and len(got) != len(spec)):
            have = "no" if got is None else len(got)
            raise ValueError(f"{have} {name}, expected {'none' if spec is None else len(spec)}")
    top = {k: v for k, v in params_np.items() if k not in lists}
    out = carry(top, {k: v for k, v in want.items() if k not in lists}, "")
    for name in lists:
        out[name] = [carry(p, w, f"{name}[{i}].") for i, (p, w) in enumerate(zip(params_np[name], want[name]))]
    return out


def state_from_jax(cfg, params_np: dict, opt_state_np: dict, device) -> tuple[dict, dict]:
    """The JAX package's ``(params, opt_state)`` (numpy leaves) as the port's,
    on ``device``: the moments ``mu`` / ``nu`` carry like the parameters, in
    their own dtype (float32 or bfloat16, one for every leaf), and ``step`` is
    an int32 scalar."""
    params = from_jax(cfg, params_np, device)
    moments = {}
    for name in ("mu", "nu"):
        tree = opt_state_np[name]
        dtype = _tensor(np.asarray(tree["embed.tokens"])).dtype
        moments[name] = from_jax(cfg, tree, device, dtype=dtype)
    step = _tensor(np.asarray(opt_state_np["step"]))
    if step.dtype != torch.int32 or step.shape != ():
        raise ValueError(f"step is {step.dtype}{tuple(step.shape)}, expected an int32 scalar")
    return params, {**moments, "step": step.to(device)}
