"""Parameters: random init on a device, and the carry-across from the JAX package.

The parameters are the JAX package's pytree as a plain dict with the same
names, shapes and dtypes::

    {"embed.tokens": (V_pad, d), "unembed": (d, V_pad), "final_norm.scale": (d,),
     "layers": [{"norm1.scale": ..., "attn.wq": (d, H, Dh), ...}, ...]}

(an encoder-decoder adds ``"encoder"``, a second list of layers, and
``encoder_norm.*`` at the top level: :data:`LAYER_LISTS`).

:class:`ParamBuilder` draws each dense weight as the JAX package's does:
``jax.random.truncated_normal(key, -2, 2, shape, float32)`` times ``std = 1
/ sqrt(fan_in)`` (or a given scale; ``fan_in`` is ``shape[0]``, the number of
experts for an expert weight), the key split off the builder's own key for
each weight, in ``jax.random``'s stream (:mod:`repro_torch.data.threefry`)
and with its arithmetic (:func:`truncated_normal`).  So ``init_params(cfg,
seed)`` is the JAX package's ``init_params(cfg, PRNGKey(seed))``: bit for bit
but where the CPU's or the card's ``log`` / ``log1p`` round an ulp away from
XLA's (about 0.5 % of float32 elements, one ulp; far fewer once rounded to
bfloat16).  A weight is drawn in slices of at most :data:`DRAW_ELEMENTS`
elements along the first axis (partitionable threefry numbers elements by
their global index, so the slices are the same stream), so that the
transients of a draw stay small beside the weight (one expert weight of
kimi-k2 is 5.6 G elements).  :func:`from_jax` carries the JAX package's
arrays across as they are, and :func:`state_from_jax` the whole training
state a checkpoint holds (parameters and the AdamW state ``{"mu", "nu",
"step"}``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.data import threefry

#: The parameter dict's lists of per-layer dicts (``"encoder"``: enc-dec only).
LAYER_LISTS = ("layers", "encoder")
#: Most elements one draw of :meth:`ParamBuilder.dense` makes at a time (256 MB of float32).
DRAW_ELEMENTS = 1 << 26


#: XLA's float32 ``erf_inv`` polynomial (Giles') for w = -log1p(-x^2) < 5, in w - 2.5.
#: A truncated normal's uniform lies within erf(sqrt 2) = 0.9545 of 0, where w <= 2.42:
#: XLA's other polynomial (w >= 5) and its +-1 case are never selected there.
_ERFINV = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
           -0.00417768164, 0.246640727, 1.50140941)
#: XLA's ``log1p`` below |x| = sqrt(2) - 1 (Cephes' rational function), numerator and denominator.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _const(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c`` as a float32 scalar tensor on ``x``'s device (it broadcasts)."""
    return torch.tensor(c, dtype=torch.float32, device=x.device)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``p = p * x + c`` over ``coeffs`` from 0, each step one fused multiply-add."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = torch.addcmul(_const(c, x), p, x)
    return p


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA computes it: the rational function for small
    |x|, ``log(1 + x)`` above."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + torch.addcmul(small, _const(-0.5, x), x2)
    return torch.where(x.abs() < math.sqrt(2.0) - 1.0, small, torch.log(x + 1.0))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` of ``|x| <= erf(sqrt 2)`` as XLA computes it (its
    polynomial, fused multiply-adds)."""
    w = -_log1p(-(x * x)) - 2.5
    return _horner(w, _ERFINV) * x


def _erf_bounds() -> tuple[float, float]:
    """``erf(-2 / sqrt(2))`` and ``erf(2 / sqrt(2))`` in float32, as
    ``jax.random.truncated_normal`` takes them (on the CPU, the same on any
    device)."""
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32)
    lo, hi = torch.erf(torch.tensor([-2.0, 2.0]) / sqrt2).tolist()
    return lo, hi


def truncated_normal(key: tuple[int, int], start: int, count: int, device) -> torch.Tensor:
    """Elements ``[start, start + count)`` (flat index) of
    ``jax.random.truncated_normal(key, -2.0, 2.0, shape, float32)``: the
    uniform draw in ``[erf(-sqrt 2), erf(sqrt 2))`` (its mantissa bits, then
    ``u * (b - a) + a`` as one fused multiply-add), ``sqrt(2) * erf_inv``,
    clipped inside ``(-2, 2)``."""
    bits = threefry.random_bits(key, start, count, device)
    u = bits.bitwise_right_shift_(9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000).view(torch.float32).sub_(1.0)
    lo, hi = _erf_bounds()
    u = torch.clamp_min(torch.addcmul(_const(lo, u), u, _const(hi - lo, u)), lo)
    out = _erfinv(u).mul_(math.sqrt(2.0))
    below = math.nextafter(2.0, 0.0)
    return out.clamp_(-below, below)


class ParamBuilder:
    """Accumulates ``{name: tensor}`` for one parameter group (a layer, or the
    embeddings), in the model's dtype unless told otherwise, and beside it
    ``{name: logical axes}`` (one name or ``None`` per dimension, the JAX
    package's ``ParamBuilder.axes``; :mod:`repro_torch.parallel.sharding` maps
    them onto a mesh).  ``key``: the group's ``jax.random`` key (a pair of
    uint32, :func:`repro_torch.data.threefry.prng_key`), of which each dense
    weight splits its own, as the JAX package's builder does; None on the
    meta device."""

    def __init__(self, key: tuple[int, int] | None, device, dtype: torch.dtype):
        self.key = key
        self.device = torch.device(device)
        self.dtype = dtype
        self.params: dict[str, torch.Tensor] = {}
        self.axes: dict[str, tuple] = {}

    def _next(self) -> tuple[int, int]:
        self.key, sub = threefry.split(self.key, 2)
        return sub

    def dense(self, name: str, shape: tuple[int, ...], axes: tuple, scale: float | None = None):
        std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        if self.device.type != "meta":
            key = self._next()
            row = math.prod(shape[1:])
            rows = max(1, DRAW_ELEMENTS // max(1, row))
            for i in range(0, shape[0], rows):
                n = min(rows, shape[0] - i)
                draw = truncated_normal(key, i * row, n * row, self.device).mul_(std)
                out[i:i + n] = draw.reshape(n, *shape[1:])
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
