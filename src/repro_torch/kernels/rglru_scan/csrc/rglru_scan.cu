// RG-LRU scan of RecurrentGemma's recurrent blocks, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rglru_scan/kernel.py::rglru_scan_tpu (body _rglru_kernel), the
// Pallas TPU kernel that runs the recurrence in prefill (models/transformer.py prefill):
//   a_t = exp(log_a_t),  h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * x_t,  h_0 = 0
// over (B, S, W) float32 inputs, writing every h_t (B, S, W) and the last one (B, W).
//
// Design: one thread per (b, w) channel walks t = 0 .. S-1 with h in a register; neighbouring
// threads take neighbouring w, so every load and store of a step is coalesced.  The loads of
// eight steps are issued before their arithmetic, so a thread has eight loads in flight
// instead of waiting on one per step.  The TPU kernel's time chunks and VMEM scratch are
// not needed: the state never leaves the register.
//
// What bounds it on this card: bytes -- two inputs read and one output written once,
// 12 * B * S * W bytes, at 3.35 TB/s.  What the simple design leaves on the table: only
// B * W threads run (8192 at recurrentgemma-9b's width, a few warps per SM), so the scan is
// latency-bound on its serial chain; splitting S into chunks scanned in parallel with a
// second pass over the chunk carries, or fusing the gates' elementwise math into the scan,
// would come closer to the bound.
//
// Exactness: built with --fmad=false, each + and * rounds as in the plain PyTorch version
// (repro_torch/kernels/rglru_scan/ref.py), which does the same operations in the same order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float step(float h, float log_a, float x) {
  const float a = expf(log_a);
  const float beta = sqrtf(fmaxf(1.0f - a * a, 1e-12f));
  return a * h + beta * x;
}

__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(const float* __restrict__ log_a,
                                                              const float* __restrict__ gated_x,
                                                              float* __restrict__ h_seq,
                                                              float* __restrict__ h_last, long long B,
                                                              long long S, long long W) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;  // (b, w)
  if (i >= B * W) return;
  const long long b = i / W, w = i % W;
  const long long base = b * S * W + w;
  const float* la = log_a + base;
  const float* x = gated_x + base;
  float* hs = h_seq + base;
  float h = 0.f;
  long long t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float la_r[kUnroll], x_r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      la_r[u] = la[(t + u) * W];
      x_r[u] = x[(t + u) * W];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = step(h, la_r[u], x_r[u]);
      hs[(t + u) * W] = h;
    }
  }
  for (; t < S; ++t) {
    h = step(h, la[t * W], x[t * W]);
    hs[t * W] = h;
  }
  h_last[i] = h;
}

}  // namespace

// Launches the scan on `stream` and returns cudaGetLastError() (0 on success).  log_a and
// gated_x are contiguous (B, S, W) float32, h_seq (B, S, W) and h_last (B, W) float32.
extern "C" int rglru_scan_launch(const void* log_a, const void* gated_x, void* h_seq, void* h_last, long long B,
                                 long long S, long long W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (B * W + kThreads - 1) / kThreads;
  rglru_scan_kernel<<<(unsigned int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(gated_x), static_cast<float*>(h_seq),
      static_cast<float*>(h_last), B, S, W);
  return (int)cudaGetLastError();
}
