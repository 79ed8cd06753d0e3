// RG-LRU scan of RecurrentGemma's recurrent blocks, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rglru_scan/kernel.py::rglru_scan_tpu (body _rglru_kernel), the
// Pallas TPU kernel that runs the recurrence in prefill (models/transformer.py prefill):
//   a_t = exp(log_a_t),  h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * x_t,  h_0 = 0
// over (B, S, W) float32 inputs, writing every h_t (B, S, W) and the last one (B, W).
//
// What bounds it on this card: bytes -- two inputs read and one output written once,
// 12 * B * S * W bytes, at 3.35 TB/s.  The serial chain is one multiply and one add a step;
// exp, sqrt and beta * x do not depend on h.
//
// Design (W a multiple of 4, every pointer 16-byte aligned: the served width 4096): a
// block owns 32 channels of one batch row over all of S, in time chunks of 64 steps (one
// {32 channels, 64 steps} box: 8 KB of each input), with warps split by role.
//   * Warp 0: one thread issues TMA loads of log_a and gated_x chunks into a ring of 4
//     stages (full / empty mbarriers).  With 2 blocks an SM and 256 blocks at
//     recurrentgemma-9b's B * W = 8192 channels, up to 16 MB are in flight across the card.
//   * Warps 1-8: the elementwise work of each staged chunk, in place: a = exp(log_a) over
//     log_a, beta * x over x; then they arrive on the chunk's ready barrier.
//   * Warp 9: the chain, a lane a channel: h = a * h + bx for each step, written in place
//     over a; then the chunk leaves by one TMA store (clipped at S), and the stage is freed
//     once that store has read it.  h_last is written as before.
// TMA's zero fill covers the ragged ends: a channel past W or a step past S reads
// log_a = 0 and x = 0, so a = 1 and bx = 0, and neither is stored.
// Other widths or alignments (TMA needs 16-byte row strides) take the first port's body:
// one thread per channel walking S with eight steps' loads in flight.
//
// Exactness: built with --fmad=false, each + and * rounds as in the plain PyTorch version
// (repro_torch/kernels/rglru_scan/ref.py), which does the same operations in the same order:
// a * a, 1 - a^2, max, sqrt, beta * x, a * h, and the sum, each rounded once.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

__device__ __forceinline__ float gate(float log_a, float* beta) {
  const float a = expf(log_a);
  *beta = sqrtf(fmaxf(1.0f - a * a, 1e-12f));
  return a;
}

// ---------------------------------------------------------------------------------------
// TMA body: time chunks staged through shared memory
// ---------------------------------------------------------------------------------------

constexpr int kChannels = 32;  // channels a block (a lane of the chain warp each)
constexpr int kSteps = 64;     // steps a chunk
constexpr int kStages = 4;
constexpr int kMathWarps = 8;
constexpr int kTmaThreads = (2 + kMathWarps) * 32;  // loader, elementwise warps, chain
constexpr int kChunkFloats = kSteps * kChannels;
constexpr int kSmemBytes = 2 * kStages * kChunkFloats * 4 + 3 * kStages * 8 + 128;  // + alignment slack

__global__ void __launch_bounds__(kTmaThreads, 2)
    rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap la_map, const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap h_map, float* __restrict__ h_last, int S, int W) {
  extern __shared__ uint8_t smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw + ((128 - (hopper::smem_u32(smem_raw) & 127)) & 127));
  float* la_s = smem;                          // [stage][step][channel]: log_a, then a, then h
  float* x_s = smem + kStages * kChunkFloats;  // [stage][step][channel]: x, then beta * x
  uint64_t* full = reinterpret_cast<uint64_t*>(x_s + kStages * kChunkFloats);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;

  const int w0 = blockIdx.x * kChannels, b = blockIdx.y;
  const int n_chunks = (S + kSteps - 1) / kSteps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(ready + s, kMathWarps * 32);
      hopper::mbar_init(empty + s, 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 0) {
    if (lane == 0) {
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % kStages;
        hopper::mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full + s, 2 * kChunkFloats * 4);
        hopper::tma_load_3d(la_s + s * kChunkFloats, &la_map, full + s, w0, i * kSteps, b);
        hopper::tma_load_3d(x_s + s * kChunkFloats, &x_map, full + s, w0, i * kSteps, b);
      }
    }
  } else if (warp <= kMathWarps) {
    const int row0 = warp - 1;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kStages;
      hopper::mbar_wait(full + s, (i / kStages) & 1);
      float* la = la_s + s * kChunkFloats;
      float* x = x_s + s * kChunkFloats;
#pragma unroll
      for (int u = 0; u < kSteps / kMathWarps; ++u) {
        const int idx = (u * kMathWarps + row0) * kChannels + lane;
        float beta;
        const float a = gate(la[idx], &beta);
        la[idx] = a;
        x[idx] = beta * x[idx];
      }
      hopper::fence_proxy_async();  // before TMA writes over these bytes again
      hopper::mbar_arrive(ready + s);
    }
  } else {
    float h = 0.f;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kStages;
      hopper::mbar_wait(ready + s, (i / kStages) & 1);
      float* ah = la_s + s * kChunkFloats + lane;  // a in, h out
      const float* bx = x_s + s * kChunkFloats + lane;
      const int n = min(kSteps, S - i * kSteps);
      if (n == kSteps) {
#pragma unroll 16
        for (int t = 0; t < kSteps; ++t) {
          h = ah[t * kChannels] * h + bx[t * kChannels];
          ah[t * kChannels] = h;
        }
      } else {
        for (int t = 0; t < n; ++t) {
          h = ah[t * kChannels] * h + bx[t * kChannels];
          ah[t * kChannels] = h;
        }
      }
      hopper::fence_proxy_async();  // h is read by the TMA store
      __syncwarp();
      if (lane == 0) {
        hopper::tma_store_3d(&h_map, la_s + s * kChunkFloats, w0, i * kSteps, b);
        hopper::bulk_commit();
        if (i > 0) {
          hopper::bulk_wait_read<1>();  // the previous chunk's store has read its stage
          hopper::mbar_arrive(empty + (i - 1) % kStages);
        }
      }
      __syncwarp();
    }
    if (lane == 0) hopper::bulk_wait_all();
    if (w0 + lane < W) h_last[(long long)b * W + w0 + lane] = h;
  }
}

int launch_tma(const float* log_a, const float* gated_x, float* h_seq, float* h_last, long long B, long long S,
               long long W, cudaStream_t stream) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)(W * 4), (cuuint64_t)(S * W * 4)};
  const cuuint32_t box[3] = {kChannels, kSteps, 1};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap la_map, x_map, h_map;
  int err = hopper::encode_tiled(&la_map, f32, 3, log_a, dims, strides, box, none);
  if (!err) err = hopper::encode_tiled(&x_map, f32, 3, gated_x, dims, strides, box, none);
  if (!err) err = hopper::encode_tiled(&h_map, f32, 3, h_seq, dims, strides, box, none);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(rglru_scan_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned int)((W + kChannels - 1) / kChannels), (unsigned int)B);
  rglru_scan_tma_kernel<<<grid, kTmaThreads, kSmemBytes, stream>>>(la_map, x_map, h_map, h_last, (int)S, (int)W);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------------------
// Per-channel body (widths TMA cannot stride): a thread per (b, w) channel
// ---------------------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float step(float h, float log_a, float x) {
  float beta;
  const float a = gate(log_a, &beta);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Launches the scan on `stream` and returns cudaGetLastError() (0 on success).  log_a and
// gated_x are contiguous (B, S, W) float32, h_seq (B, S, W) and h_last (B, W) float32.
extern "C" int rglru_scan_launch(const void* log_a, const void* gated_x, void* h_seq, void* h_last, long long B,
                                 long long S, long long W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const float* la = static_cast<const float*>(log_a);
  const float* x = static_cast<const float*>(gated_x);
  float* hs = static_cast<float*>(h_seq);
  float* hl = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(la) && aligned16(x) && aligned16(hs) && S < (1LL << 31) && B <= 65535)
    return launch_tma(la, x, hs, hl, B, S, W, s);
  const long long blocks = (B * W + kThreads - 1) / kThreads;
  rglru_scan_kernel<<<(unsigned int)blocks, kThreads, 0, s>>>(la, x, hs, hl, B, S, W);
  return (int)cudaGetLastError();
}
