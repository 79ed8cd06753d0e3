// The per-element formation of the Mamba-1 scan's inputs, as device functions: what
// mamba_inputs.cu writes to memory, and what a scan that forms its inputs in registers calls.
//
// For a (b, s, d) row and its state n, from dt_pre = dt_low @ dt_proj, the bias, A_log, x and B:
//   dt        = softplus(T(dt_pre + dt_bias))      (the sum rounded to the model's dtype T)
//   a         = -exp(A_log[d, n])
//   dtA[n]    = dt * a
//   dBx[n]    = (dt * x) * B[n]
// operation for operation as PyTorch's eager kernels round them (repro_torch/kernels/mamba_inputs/
// ref.py::mamba_inputs): each + and * one IEEE-rounded intrinsic (the build has --fmad=false and no
// fast math), softplus as PyTorch's logaddexp(v, 0) computes it, with expf and log1pf.

#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace mamba_inputs {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// x as a T tensor stores it (round to nearest even), widened back.
template <typename T>
__device__ __forceinline__ float stored(float x);
template <>
__device__ __forceinline__ float stored<float>(float x) { return x; }
template <>
__device__ __forceinline__ float stored<__nv_bfloat16>(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// torch.logaddexp(a, b) as PyTorch's CUDA kernel computes it in float32.
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return __fadd_rn(m, log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}

// dt of a (b, s, d) row: softplus of the biased projection, the sum rounded to T first.
template <typename T>
__device__ __forceinline__ float dt_of(T dt_pre, T dt_bias) {
  return logaddexp(stored<T>(__fadd_rn(widen(dt_pre), widen(dt_bias))), 0.0f);
}

// a of a (d, n) state.
__device__ __forceinline__ float a_of(float a_log) { return -expf(a_log); }

// dtA and dBx of one state, given dt, a, dtx = dt * x (__fmul_rn(dt, widen(x))) and B[n] widened.
__device__ __forceinline__ void state_inputs(float dt, float a, float dtx, float b, float& dtA, float& dBx) {
  dtA = __fmul_rn(dt, a);
  dBx = __fmul_rn(dtx, b);
}

}  // namespace mamba_inputs
