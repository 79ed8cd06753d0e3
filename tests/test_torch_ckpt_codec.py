"""The port's checkpoint codec against the JAX package's, on the CPU.

The port's plain ``quantize`` (what the CPU runs, and the yardstick of the
CUDA kernel on the card) is held ``==`` to :func:`repro.kernels.ckpt_codec.ref.quantize`
on the JAX codec test's shapes and dtypes: both widen to float32, take the
block max and divide by IEEE division, and round half to even.  Against the
TPU kernel run in interpret mode, ``==`` does not hold: the interpreted
kernel multiplies by the reciprocal of 127 where the reference divides, so a
block's scale may differ by one ulp and a ``q`` on an exact .5 tie by one
step.  That comparison keeps the JAX test's own tolerance (at most one step,
on fewer than 1e-3 of the entries; scales within rtol 1e-6).  The round-trip
bound, idempotence and zero-input tests mirror ``tests/kernels/test_ckpt_codec.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.kernels.ckpt_codec import ref as jax_ref
from repro.kernels.ckpt_codec.kernel import quantize_tpu
from repro_torch.kernels.ckpt_codec import kernel, ops, ref
from repro_torch.kernels.ckpt_codec.ref import BLOCK, dequantize, quantize

SHAPES = [(1000,), (64, 64), (7, 33, 5), (4096,)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def inputs(shape, dtype, seed=0):
    """The same values for both packages: numpy float32 from a seed, cast by each."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_equals_jax_ref(shape, dtype):
    xj, xt = inputs(shape, dtype)
    qj, sj, shj = jax_ref.quantize(xj)
    qt, st_, sht = ops.quantize(xt)
    assert sht == shj == shape
    assert qt.dtype == torch.int8 and st_.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st_.numpy().view(np.int32), np.asarray(sj).view(np.int32))
    dj = np.asarray(jax_ref.dequantize(qj, sj, shj))
    np.testing.assert_array_equal(dequantize(qt, st_, sht).numpy(), dj)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_against_tpu_kernel_interpret(shape, dtype):
    xj, xt = inputs(shape, dtype)
    qk, sk, shk = quantize_tpu(xj, interpret=True)
    qt, st_, sht = quantize(xt)
    assert shk == sht == shape
    dq = np.abs(np.asarray(qk, np.int32) - qt.numpy().astype(np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() < 1e-3
    np.testing.assert_allclose(st_.numpy(), np.asarray(sk), rtol=1e-6)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(3000).astype(np.float32))
    before = kernel.launches
    q, s, shape = ops.quantize(x)
    q2, s2, _ = ref.quantize(x)
    assert kernel.launches == before
    assert torch.equal(q, q2) and torch.equal(s, s2) and shape == (3000,)
    with pytest.raises(ValueError, match="cuda"):
        kernel.prepare(x)
    with pytest.raises(ValueError, match="cuda"):
        kernel.quantize(x)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_padding_ties_and_nan_blocks(dtype):
    # a ragged tail, an all-zero block, exact .5 ties of a block's step, and a NaN block
    x = torch.zeros(3 * BLOCK + 17, dtype=torch.float32)
    x[BLOCK : 2 * BLOCK] = torch.arange(BLOCK, dtype=torch.float32) * 0.5 - 64.0  # -64, -63.5, ..., 63.5
    x[BLOCK + 5] = 127.0  # block max 127: the step is 1.0, so every x.5 is a tie
    x[2 * BLOCK : 3 * BLOCK] = float("nan")
    x[3 * BLOCK :] = torch.linspace(-2, 2, 17)
    q, s, shape = quantize(x.to(dtype))
    assert q.shape == (4, BLOCK) and s.shape == (4,)
    assert (q[0] == 0).all() and s[0] == torch.tensor(1e-12, dtype=torch.float32) / 127  # the floor
    assert torch.isnan(s[2])
    assert (q[3, 17:] == 0).all()  # padding quantizes to 0
    assert s[1] == 1.0
    want = np.round(x[BLOCK : 2 * BLOCK].to(dtype).float().numpy())  # numpy rounds half to even
    np.testing.assert_array_equal(q[1].numpy(), want.astype(np.int8))
    assert q[1, 1] == -64 and q[1, 129] == 0 and q[1, 131] == 2  # -63.5, 0.5, 1.5


@given(
    st.integers(min_value=1, max_value=4000),
    st.floats(min_value=1e-6, max_value=1e6),
    st.integers(min_value=0, max_value=2**31 - 1),
)
@settings(max_examples=30, deadline=None)
def test_roundtrip_error_bound(n, scale, seed):
    """|dequant(quant(x)) - x| <= block_max/127 * 0.5 + eps, for any x."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32)) * scale
    q, s, shape = quantize(x)
    err = (dequantize(q, s, shape) - x).abs().numpy()
    blocks = np.pad(x.numpy(), (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    bound = np.abs(blocks).max(axis=1, keepdims=True) / 127.0 * 0.5 + 1e-7
    bound_full = np.repeat(bound, BLOCK, axis=1).reshape(-1)[:n]
    assert (err <= bound_full + 1e-6 * scale).all()


@given(st.integers(min_value=1, max_value=2000))
@settings(max_examples=20, deadline=None)
def test_quantize_is_idempotent_on_its_output(n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
    q, s, shape = quantize(x)
    dq = dequantize(q, s, shape)
    q2, s2, _ = quantize(dq)
    np.testing.assert_allclose(dequantize(q2, s2, shape).numpy(), dq.numpy(), atol=1e-6)


def test_zero_input():
    q, s, shape = quantize(torch.zeros(300))
    assert int(q.max()) == 0
    np.testing.assert_array_equal(dequantize(q, s, shape).numpy(), np.zeros(300))


def test_quantization_error_is_small():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((64, 64)).astype(np.float32))
    assert 0.0 < ref.quantization_error(x) <= 0.5 / 127 + 1e-7
