"""The Mamba-1 scan's inputs (``kernels/mamba_inputs``) on the CPU.

``models/ssm.py::ssm_inputs`` forms dtA and dBx through the ``mamba_inputs``
op; off the card the op runs the plain version (``ref.py``), which must give
the bits the inline formation gave before it moved there, for both Mamba
families (``ssm``: falcon-mamba-7b; ``jamba``: dt / B / C norms before the
``dt_proj`` product) in float32 and bfloat16.  The op picks the plain version
for CPU tensors, for ``impl="plain"`` and for meta tensors, and launches
nothing; the kernel's own entry raises off the card
(``tests/test_torch_kernel_dispatch.py``).  The kernel itself is held to the
plain version bit for bit on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mamba_inputs import kernel, ops, ref
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import shard

ARCHS = ("falcon-mamba-7b", "jamba2-mini")


def inline_ssm_inputs(cfg: ModelConfig, params, name: str, x_act):
    """``ssm_inputs`` as ``models/ssm.py`` wrote it before the formation moved to
    ``kernels/mamba_inputs/ref.py``."""
    n, r = cfg.ssm_state, cfg.dt_rank
    proj = shard(x_act @ params[f"{name}.x_proj"], "batch", "seq", None)
    dt_low, bmat, cmat = proj[..., :r], proj[..., r : r + n], proj[..., r + n :]
    if cfg.family == "jamba":
        dt_low = L.apply_norm(cfg, params, f"{name}.dt_norm", dt_low)
        bmat = L.apply_norm(cfg, params, f"{name}.b_norm", bmat)
        cmat = L.apply_norm(cfg, params, f"{name}.c_norm", cmat)
    dt = dt_low @ params[f"{name}.dt_proj"] + params[f"{name}.dt_bias"]
    dt = torch.logaddexp(dt.float(), torch.zeros_like(dt.float()))
    a = -torch.exp(params[f"{name}.A_log"].float())
    dtA = dt[..., None] * a
    dBx = (dt * x_act.float())[..., None] * bmat.float()[:, :, None, :]
    return dtA, dBx, cmat


def mamba_layer(arch: str, dtype: str, seed: int = 0):
    """The smoke config, the parameters of its first Mamba layer (the bias and
    the norms' scales drawn away from their zeros and ones) and that mixer's
    name."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = T.init_params(cfg, seed, device="cpu")
    kinds = T.layer_kinds(cfg)
    layer = params["layers"][next(i for i, k in enumerate(kinds) if k.startswith("mamba"))]
    gen = torch.Generator().manual_seed(seed + 1)
    for key, w in layer.items():
        if key.endswith(".dt_bias"):
            w.copy_(torch.randn(w.shape, generator=gen) * 2)
        elif key.endswith(".scale"):
            w.copy_(0.5 + torch.rand(w.shape, generator=gen))
    return cfg, layer, "mixer"


def activation(cfg, rows=2, seq=13, seed=2):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, seq, cfg.d_inner), generator=gen) * 2
    return torch.nn.functional.silu(x).to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def op_inputs(dtype=torch.float32, b=2, s=5, d=6, n=4, seed=0):
    gen = torch.Generator().manual_seed(seed)
    proj = torch.randn((b, s, 3 + 2 * n), generator=gen).to(dtype)
    return (torch.randn((b, s, d), generator=gen).to(dtype) * 4, torch.randn((d,), generator=gen).to(dtype),
            torch.log(torch.arange(1, n + 1, dtype=torch.float32).repeat(d, 1)),
            torch.randn((b, s, d), generator=gen).to(dtype), proj[..., 3:3 + n])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_plain_formation_gives_the_inline_formations_bits(arch, dtype):
    cfg, layer, name = mamba_layer(arch, dtype)
    x_act = activation(cfg)
    got, want = ssm.ssm_inputs(cfg, layer, name, x_act), inline_ssm_inputs(cfg, layer, name, x_act)
    for g, w, what in zip(got, want, ("dtA", "dBx", "C")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g, w), what
    b, s, d = x_act.shape
    assert got[0].shape == got[1].shape == (b, s, d, cfg.ssm_state) and got[0].dtype == torch.float32


@pytest.mark.parametrize("impl", [None, "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_op_runs_the_plain_version_on_the_cpu(impl, dtype):
    args = op_inputs(dtype)
    before = kernel.launches
    got, want = ops.mamba_inputs(*args, impl=impl), ref.mamba_inputs(*args)
    assert kernel.launches == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and torch.equal(g, w)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.mamba_inputs(*args, impl="kernel")


def test_meta_tensors_take_the_plain_version():
    args = [x.to("meta") for x in op_inputs(torch.bfloat16, b=3, s=7, d=10, n=16)]
    before = kernel.launches
    dtA, dBx = ops.mamba_inputs(*args)
    assert kernel.launches == before
    for out in (dtA, dBx):
        assert out.device.type == "meta" and out.dtype == torch.float32 and tuple(out.shape) == (3, 7, 10, 16)


def test_softplus_takes_the_large_argument_and_infinite_branches():
    """logaddexp(v, 0): v itself far above 0 (no overflow), 0 far below, inf at
    inf, and the bias add rounded to bf16 before it widens."""
    v = torch.tensor([-math.inf, -200.0, -20.0, 0.0, 20.0, 200.0, 3e38, math.inf])
    sp = ref.softplus(v)
    assert torch.equal(sp[[0, 1, 5, 6, 7]], torch.tensor([0.0, 0.0, 200.0, 3e38, math.inf]))
    assert float(sp[3]) == pytest.approx(math.log(2.0))
    assert float(sp[4]) == pytest.approx(20.0 + math.log1p(math.exp(-20.0)))
    pre = torch.tensor([[[1.0 + 2.0**-7]]], dtype=torch.bfloat16)
    bias = torch.tensor([2.0**-8], dtype=torch.bfloat16)
    one = torch.ones((1, 1, 1), dtype=torch.bfloat16)
    dtA, _ = ref.mamba_inputs(pre, bias, torch.zeros((1, 1)), one, one)  # a = -exp(0) = -1
    # 1 + 2^-7 + 2^-8 lies halfway between two bf16 values and rounds to the even one, 1 + 2^-6
    assert float(dtA) == -float(ref.softplus(torch.tensor(1.0 + 2.0**-6)))
    assert float(dtA) != -float(ref.softplus(torch.tensor(1.0 + 2.0**-7 + 2.0**-8)))


def test_gradients_reach_every_input_of_the_plain_formation():
    args = [x.detach().requires_grad_(True) for x in op_inputs()]
    dtA, dBx = ops.mamba_inputs(*args)
    (dtA.sum() + 2 * dBx.sum()).backward()
    assert all(x.grad is not None and x.grad.shape == x.shape and bool(torch.isfinite(x.grad).all()) for x in args)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_decode_step_hands_impl_to_the_op(arch, monkeypatch):
    """``decode_step(impl=...)`` reaches each Mamba layer's op, as ``prefill``'s
    does, so a plain decode forms its scan inputs with the plain version."""
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(4))
    _, cache = T.prefill(cfg, params, {"tokens": tokens[:, :8]}, 16, q_block=8, kv_block=8, device="cpu")
    seen = []

    def spy(*args, impl=None):
        seen.append(impl)
        return ref.mamba_inputs(*args)

    monkeypatch.setattr(ops, "mamba_inputs", spy)
    mamba = sum(kind.startswith("mamba") for kind in T.layer_kinds(cfg))
    steps = [T.decode_step(cfg, params, tokens[:, 8:], cache, impl=impl, device="cpu")[0] for impl in (None, "plain")]
    assert mamba and seen == [None] * mamba + ["plain"] * mamba
    assert torch.equal(*steps)
    with pytest.raises(ValueError, match="unknown impl"):
        T.decode_step(cfg, params, tokens[:, 8:], cache, impl="kernel", device="cpu")
