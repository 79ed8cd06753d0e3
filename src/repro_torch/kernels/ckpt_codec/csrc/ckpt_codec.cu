// int8 block quantization of a checkpoint leaf, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ckpt_codec/kernel.py::quantize_tpu (body _quant_kernel), the
// Pallas TPU kernel of the checkpoint codec.  On a flattened leaf of n elements, padded with
// zeros to n_blocks * 256:
//   scale_b = max(max_i |x_bi|, 1e-12) / 127,   q_bi = clamp(rint(x_bi / scale_b), -127, 127)
// writing q (n_blocks, 256) int8 and scales (n_blocks,) float32.  The checkpoint manager
// (repro_torch/checkpoint/manager.py) runs it on every float leaf of 1024 elements or more
// while the leaf is still on the card, so the copy to the host moves int8 plus scales.
//
// Design: one warp per 256-element block.  Each lane holds 8 consecutive elements, read in the
// leaf's own type with one 16-byte load (two for float32) and widened to float32 in registers,
// so no float32 copy of a bf16 leaf is ever written.  The block's max |x| is a shuffle-xor
// reduction; each lane then writes its 8 int8 as one 8-byte store and lane 0 the scale.  A
// block that runs past n (the ragged tail) reads element by element and takes zeros beyond n.
//
// What bounds it on this card: bytes -- the leaf read once (n * element size) and
// n_blocks * 260 bytes written, at 3.35 TB/s; a few operations per element are far below the
// card's rates.  Neighbouring lanes read neighbouring 16 bytes, so a warp's loads and stores
// are whole 512 / 256-byte segments.
//
// Exactness: both divisions are IEEE (__fdiv_rn; the build has --fmad=false and no fast
// math), rintf rounds half to even like torch.round, and the max is written as compares that
// keep a NaN, as torch.amax and clamp_min do, so q and scales equal the plain PyTorch version's
// (repro_torch/kernels/ckpt_codec/ref.py) bit for bit; on a block holding a NaN, scales agree
// and q is a cast of NaN to int8, undefined in both.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;   // elements a scale covers (ref.BLOCK)
constexpr int kPerLane = 8;   // kBlock / 32
constexpr int kWarps = 8;     // warps (blocks of the leaf) per thread block
constexpr int kThreads = 32 * kWarps;

// dtype codes of the wrapper (kernel.DTYPES)
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float nan_max(float m, float a) { return (a > m || a != a) ? a : m; }

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// The lane's 8 elements starting at element `first` of the leaf, widened; zeros past n.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ x, long long first, long long n, float (&v)[kPerLane]) {
  if (first + kPerLane <= n) {
    constexpr int kVec = (int)(sizeof(T) * kPerLane / 16);  // 16-byte loads: 1 (16-bit) or 2 (float32)
    const uint4* src = reinterpret_cast<const uint4*>(x + first);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const uint4 raw = __ldg(src + k);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPerLane / kVec; ++j) v[k * (kPerLane / kVec) + j] = widen(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) v[j] = first + j < n ? widen(x[first + j]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ckpt_codec_quantize_kernel(const T* __restrict__ x,
                                                                        int8_t* __restrict__ q,
                                                                        float* __restrict__ scales, long long n,
                                                                        long long n_blocks) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_blocks) return;
  const long long first = b * kBlock + lane * kPerLane;
  float v[kPerLane];
  load8(x, first, n, v);

  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) m = nan_max(m, fabsf(v[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = __fdiv_rn(nan_max(m, 1e-12f), 127.0f);

  union {
    int8_t b[kPerLane];
    uint2 u;
  } out;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float r = rintf(__fdiv_rn(v[j], scale));
    out.b[j] = (int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
  }
  *reinterpret_cast<uint2*>(q + first) = out.u;  // q is (n_blocks, 256): always whole
  if (lane == 0) scales[b] = scale;
}

template <typename T>
void launch(const void* x, void* q, void* scales, long long n, long long n_blocks, cudaStream_t stream) {
  const long long grid = (n_blocks + kWarps - 1) / kWarps;
  ckpt_codec_quantize_kernel<T><<<(unsigned int)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scales), n, n_blocks);
}

}  // namespace

// Launches the quantization on `stream` and returns cudaGetLastError() (0 on success).  x is
// a contiguous leaf of n elements of type `dtype` (kernel.DTYPES) starting on a 16-byte
// boundary; q is (n_blocks, 256) int8 and scales (n_blocks,) float32, n_blocks = ceil(n / 256).
extern "C" int ckpt_codec_quantize_launch(const void* x, void* q, void* scales, long long n, long long n_blocks,
                                          int dtype, void* stream) {
  if (n <= 0 || n_blocks != (n + kBlock - 1) / kBlock || (n_blocks + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch<float>(x, q, scales, n, n_blocks, s); break;
    case kBF16: launch<__nv_bfloat16>(x, q, scales, n, n_blocks, s); break;
    case kF16: launch<__half>(x, q, scales, n, n_blocks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
