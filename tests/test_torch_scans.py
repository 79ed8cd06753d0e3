"""The port's SSM and RG-LRU scans (plain PyTorch, on the CPU) against the JAX package's.

The same numpy inputs from a seed go through the TPU kernels in interpret mode
(``ssm_scan_tpu`` / ``rglru_scan_tpu``), the JAX references (associative
scans) and the port's ops / wrappers, which on CPU tensors run the plain
sequential recurrences.  Tolerances are the JAX tests' own
(``tests/kernels/test_scans.py``): 1e-4 for the SSM scan, 1e-5 for RG-LRU;
the ragged lengths (no multiple of the TPU kernels' chunk) go against the
references only.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.kernel import rglru_scan_tpu
from repro.kernels.rglru_scan import ref as jax_rglru_ref
from repro.kernels.rglru_scan.ref import rglru_step as jax_rglru_step
from repro.kernels.ssm_scan import ref as jax_ssm_ref
from repro.kernels.ssm_scan.kernel import ssm_scan_tpu
from repro.kernels.ssm_scan.ref import ssm_step as jax_ssm_step
from repro_torch.kernels.rglru_scan import kernel as rglru_kernel
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan import ref as rglru_ref
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref

# the associative-scan references, jitted: eagerly each call takes seconds
jax_ssm_scan = jax.jit(jax_ssm_ref.ssm_scan)
jax_rglru_scan = jax.jit(jax_rglru_ref.rglru_scan)


def ssm_inputs(b, s, d, n, c_dtype=np.float32, seed=0):
    """dtA = -softplus(normal) (finite, <= 0), dBx and C standard normal."""
    rng = np.random.default_rng(seed)
    dtA = -np.logaddexp(rng.standard_normal((b, s, d, n)), 0.0).astype(np.float32)
    dBx = rng.standard_normal((b, s, d, n), dtype=np.float32)
    c = rng.standard_normal((b, s, n), dtype=np.float32).astype(c_dtype)
    return dtA, dBx, c


def rglru_inputs(b, s, w, seed=0):
    rng = np.random.default_rng(seed)
    log_a = -np.logaddexp(rng.standard_normal((b, s, w)), 0.0).astype(np.float32)
    gx = rng.standard_normal((b, s, w), dtype=np.float32)
    return log_a, gx


def t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(2, 128, 16, 4), (1, 256, 64, 16), (2, 64, 8, 8)])
def test_ssm_matches_tpu_kernel_and_ref(shape):
    dtA, dBx, c = ssm_inputs(*shape)
    y, h = ssm_ops.ssm_scan(t(dtA), t(dBx), t(c))
    assert y.dtype == h.dtype == torch.float32
    y_k, h_k = ssm_scan_tpu(jnp.asarray(dtA), jnp.asarray(dBx), jnp.asarray(c), chunk=32, interpret=True)
    y_r, h_r = jax_ssm_scan(dtA, dBx, c)
    close(y, y_k, 1e-4)
    close(h, h_k, 1e-4)
    close(y, y_r, 1e-4)
    close(h, h_r, 1e-4)


def test_ssm_bf16_readout():
    """C in bfloat16, as the bf16 models hand it over; both sides upcast it."""
    dtA, dBx, c = ssm_inputs(1, 64, 16, 4, c_dtype=ml_dtypes.bfloat16, seed=1)
    y, _ = ssm_ops.ssm_scan(t(dtA), t(dBx), t(c))
    y_k, _ = ssm_scan_tpu(jnp.asarray(dtA), jnp.asarray(dBx), jnp.asarray(c), chunk=32, interpret=True)
    close(y, y_k, 1e-4)


@pytest.mark.parametrize("shape", [(2, 77, 12, 16), (1, 5, 3, 2)])
def test_ssm_ragged_length(shape):
    dtA, dBx, c = ssm_inputs(*shape, seed=2)
    y, h = ssm_ops.ssm_scan(t(dtA), t(dBx), t(c))
    y_r, h_r = jax_ssm_scan(dtA, dBx, c)
    close(y, y_r, 1e-4)
    close(h, h_r, 1e-4)


def test_ssm_step_matches_jax_and_streams_like_scan():
    dtA, dBx, c = ssm_inputs(2, 16, 8, 4, seed=3)
    y_full, h_full = ssm_ref.ssm_scan(t(dtA), t(dBx), t(c))
    h = torch.zeros((2, 8, 4))
    h_j = jnp.zeros((2, 8, 4))
    for i in range(16):
        y_t, h = ssm_ops.ssm_step(t(dtA[:, i]), t(dBx[:, i]), t(c[:, i]), h)
        y_j, h_j = jax_ssm_step(dtA[:, i], dBx[:, i], c[:, i], h_j)
        close(y_t, y_j, 1e-4)
        close(h, h_j, 1e-4)
    np.testing.assert_allclose(y_t.numpy(), y_full[:, -1].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 128, 32), (1, 256, 128)])
def test_rglru_matches_tpu_kernel_and_ref(shape):
    log_a, gx = rglru_inputs(*shape)
    h, last = rglru_ops.rglru_scan(t(log_a), t(gx))
    h_k, last_k = rglru_scan_tpu(jnp.asarray(log_a), jnp.asarray(gx), chunk=32, interpret=True)
    h_r, last_r = jax_rglru_scan(log_a, gx)
    close(h, h_k, 1e-5)
    close(last, last_k, 1e-5)
    close(h, h_r, 1e-5)
    close(last, last_r, 1e-5)


def test_rglru_ragged_length():
    log_a, gx = rglru_inputs(2, 77, 48, seed=4)
    h, last = rglru_ops.rglru_scan(t(log_a), t(gx))
    h_r, last_r = jax_rglru_scan(log_a, gx)
    close(h, h_r, 1e-5)
    close(last, last_r, 1e-5)


def test_rglru_step_matches_jax_and_streams_like_scan():
    log_a, gx = rglru_inputs(2, 32, 16, seed=5)
    _, last = rglru_ref.rglru_scan(t(log_a), t(gx))
    h = torch.zeros((2, 16))
    h_j = jnp.zeros((2, 16))
    for i in range(32):
        h, _ = rglru_ops.rglru_step(t(log_a[:, i]), t(gx[:, i]), h)
        h_j, _ = jax_rglru_step(log_a[:, i], gx[:, i], h_j)
        close(h, h_j, 1e-5)
    assert torch.equal(h, last)  # the scan is the step, repeated


def test_plain_impl_and_wrappers_refuse_cpu_launches():
    dtA, dBx, c = ssm_inputs(1, 8, 4, 4)
    log_a, gx = rglru_inputs(1, 8, 4)
    for a, b in zip(ssm_ops.ssm_scan(t(dtA), t(dBx), t(c), impl="plain"), ssm_ops.ssm_scan(t(dtA), t(dBx), t(c))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown impl"):
        rglru_ops.rglru_scan(t(log_a), t(gx), impl="interpret")
    before = (ssm_kernel.launches, rglru_kernel.launches)
    with pytest.raises(ValueError, match="runs on cuda"):
        ssm_kernel.prepare(t(dtA), t(dBx), t(c))
    with pytest.raises(ValueError, match="runs on cuda"):
        rglru_kernel.prepare(t(log_a), t(gx))
    assert (ssm_kernel.launches, rglru_kernel.launches) == before
