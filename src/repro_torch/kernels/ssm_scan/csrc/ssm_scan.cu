// Mamba-1 selective scan of falcon-mamba's blocks, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssm_scan/kernel.py::ssm_scan_tpu (body _ssm_kernel), the Pallas
// TPU kernel that runs the scan in prefill (models/transformer.py prefill):
//   h_t = exp(dtA_t) * h_{t-1} + dBx_t,  y_t = sum_n h_t[n] * C_t[n],  h_0 = 0
// with dtA, dBx (B, S, D, N) float32 and C (B, S, N) float32 or bfloat16, writing y (B, S, D)
// and the last state h (B, D, N), both float32.
//
// Design: one lane per (b, d, n); the N lanes of a channel are neighbours in a warp (N is a
// power of two up to 32), so a step's loads of dtA and dBx are one contiguous run per warp,
// each lane keeps its h[n] in a register, and y_t is a shuffle-xor reduction over the N
// lanes.  The loads of four steps are issued before their arithmetic.  The TPU kernel's time
// chunks and VMEM state are not needed: the state never leaves the registers.
//
// What bounds it on this card: bytes -- dtA and dBx read once (8 * B * S * D * N bytes, about
// 8.6 GB at falcon-mamba-7b's width and 2 x 4096 tokens), C read, y and h_last written, at
// 3.35 TB/s.  What the simple design leaves on the table: the two (B, S, D, N) inputs exist
// only because the model's _ssm_inputs materializes them; a scan that reads dt, x, A, B and C
// ((B, S, D) and (B, S, N) tensors) and forms dtA and dBx in registers would move about 1/16
// of the bytes.  That fusion changes the kernel's function and is later work.
//
// Exactness: built with --fmad=false, h rounds as in the plain PyTorch version
// (repro_torch/kernels/ssm_scan/ref.py); y's sum over n is a tree here and PyTorch's
// reduction there, so y agrees to float32 rounding of a 16-term sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TC>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(const float* __restrict__ dtA,
                                                            const float* __restrict__ dBx,
                                                            const TC* __restrict__ C, float* __restrict__ y,
                                                            float* __restrict__ h_last, long long B, long long S,
                                                            long long D, int N) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;  // (b, d, n)
  const bool active = i < B * D * N;
  // whole groups of N lanes are active or not (B * D * N is a multiple of N)
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  if (!active) return;
  const long long b = i / (D * N), d = (i / N) % D;
  const int n = (int)(i % N);
  const long long step_in = D * N;  // stride of t in dtA / dBx
  const float* a_p = dtA + b * S * D * N + d * N + n;
  const float* x_p = dBx + b * S * D * N + d * N + n;
  const TC* c_p = C + b * S * N + n;
  float* y_p = y + b * S * D + d;
  float h = 0.f;
  long long t = 0;
  for (; t < S; t += kUnroll) {
    float a_r[kUnroll], x_r[kUnroll], c_r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = t + u < S;
      a_r[u] = in ? a_p[(t + u) * step_in] : 0.f;
      x_r[u] = in ? x_p[(t + u) * step_in] : 0.f;
      c_r[u] = in ? to_f32(c_p[(t + u) * N]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u >= S) break;  // uniform across the group: every lane has the same t
      h = expf(a_r[u]) * h + x_r[u];
      float part = h * c_r[u];
      for (int off = N / 2; off > 0; off >>= 1) part += __shfl_xor_sync(mask, part, off);
      if (n == 0) y_p[(t + u) * D] = part;
    }
  }
  h_last[(b * D + d) * N + n] = h;
}

}  // namespace

// Launches the scan on `stream` and returns cudaGetLastError() (0 on success).  dtA, dBx are
// contiguous (B, S, D, N) float32, C (B, S, N) float32 (c_dtype 0) or bfloat16 (c_dtype 1),
// y (B, S, D) and h_last (B, D, N) float32; N is a power of two up to 32.
extern "C" int ssm_scan_launch(const void* dtA, const void* dBx, const void* C, void* y, void* h_last, long long B,
                               long long S, long long D, long long N, long long c_dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || N <= 0 || N > 32 || (N & (N - 1)) != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (B * D * N + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(dtA);
  const float* x = static_cast<const float*>(dBx);
  if (c_dtype == 0) {
    ssm_scan_kernel<float><<<(unsigned int)blocks, kThreads, 0, s>>>(
        a, x, static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(h_last), B, S, D, (int)N);
  } else if (c_dtype == 1) {
    ssm_scan_kernel<__nv_bfloat16><<<(unsigned int)blocks, kThreads, 0, s>>>(
        a, x, static_cast<const __nv_bfloat16*>(C), static_cast<float*>(y), static_cast<float*>(h_last), B, S, D,
        (int)N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
