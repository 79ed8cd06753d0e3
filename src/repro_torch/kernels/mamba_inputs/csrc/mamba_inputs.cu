// The Mamba-1 scan's two float32 inputs, dtA and dBx, in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package forms them in XLA's fusion (src/repro/models/ssm.py),
// and the port's ssm_scan kernel reads them.  Eager PyTorch formed them after the dt_proj matmul
// (repro_torch/kernels/mamba_inputs/ref.py::mamba_inputs) as a bias add, a float32 copy, a
// zeros_like and a logaddexp for softplus, a float32 copy of x and two broadcast products, the
// last two on PyTorch's non-vectorised broadcast path at about half of HBM's rate.
//
// mamba_inputs_kernel reads dt_pre (B, S, D), the bias (D,), A_log (D, N) float32, x (B, S, D)
// and B (B, S, N; any row strides, unit stride along N) once, and writes dtA and dBx, float32
// (B, S, D, N), once, each element as mamba_inputs.cuh's device functions form it: bit for bit
// the plain version's (NaN payloads aside).  dt_pre, the bias, x and B are all bfloat16 or all
// float32.
//
// What bounds it on this card: bytes, and almost all of them written: 8 N bytes a (b, s, d) row
// against 2 or 4 read (128 against 4 at N = 16 in bfloat16), at HBM's 3.35 TB/s; the arithmetic
// (a softplus a row, two products a state) is far below the card's rates.  Design: the N states
// of a row go to N / 4 neighbouring threads of a warp (one thread below N = 4), each writing 16
// bytes of each output as a streaming store, so each store instruction of a warp writes one
// contiguous 512-byte run of a tensor; each of those threads forms dt and dt * x of a different
// row, once, and hands them to the others with warp shuffles.  A block takes 64 rows of 256 / (N /
// 4) channels: a thread forms its states' values of a = -exp(A_log) once for the 64 rows, the
// block stages its rows of B in shared memory (widened to float32), and a thread issues the loads
// of dt_pre and x of 16 groups of rows before their arithmetic.  Blocks go row chunk by row chunk,
// the channel tiles of a chunk next to each other.
//
// At falcon-mamba-7b's layer of a 32,768-id batch (N 16, bf16; H100 SXM, 700 W) the kernel takes
// ~13.0 ms against the 10.58 ms bound (82 %).  A thread a whole row (64 bytes a thread, four
// 16-byte stores 64 bytes apart in a warp) took 26.6 ms (40 %).  What is left is the reads: the
// same stores with no loads reach 97.5 % (as a fill of the card's memory does), and with the loads
// served from L2 92 %; the 4 % of bytes read, interleaved with the stream of writes at HBM, cost
// the rest (issuing all of a block's loads first, staging its tile in shared memory with 16-byte
// loads, or prefetching row chunks into L2 each moved it by 2 points or less).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mamba_inputs.cuh"

namespace {

using mamba_inputs::a_of;
using mamba_inputs::dt_of;
using mamba_inputs::state_inputs;
using mamba_inputs::widen;

constexpr int kThreads = 256;  // threads of a block
constexpr int kRows = 64;      // (b, s) rows a block takes
constexpr int kAhead = 16;     // a thread's loads of dt_pre and x issued before their arithmetic

// dtype codes of the wrapper (kernel.DTYPES)
enum DType { kF32 = 0, kBF16 = 1 };

// N floats at p (aligned to min(16, 4 N) bytes) from shared memory.
template <int N>
__device__ __forceinline__ void load_states(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = q.x, v[4 * k + 1] = q.y, v[4 * k + 2] = q.z, v[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

// N floats to p (aligned to min(16, 4 N) bytes) as streaming stores.
template <int N>
__device__ __forceinline__ void store_states(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      __stcs(reinterpret_cast<float4*>(p) + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
  } else if constexpr (N == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// The threads that share a (b, s, d) row, each writing 16 bytes of its N states (all N below 4).
template <int N>
__host__ __device__ constexpr int lanes() { return N >= 4 ? N / 4 : 1; }

// Block b takes rows [64 (b / tiles), +64) and channels [256 / L (b % tiles), +256 / L), tiles the
// channel tiles of a row chunk, L = lanes<N>().  Row r of B starts at bmat + (r / S) b_batch +
// (r % S) b_seq.
template <int N, typename T>
__global__ void __launch_bounds__(kThreads) mamba_inputs_kernel(
    const T* __restrict__ dt_pre, const T* __restrict__ dt_bias, const float* __restrict__ a_log,
    const T* __restrict__ x, const T* __restrict__ bmat, float* __restrict__ dtA, float* __restrict__ dBx,
    long long R, long long D, long long S, long long b_batch, long long b_seq, long long tiles) {
  constexpr int L = lanes<N>();
  constexpr int M = N / L;  // states a thread writes of its row
  __shared__ long long b_start[kRows];
  __shared__ __align__(16) float b_rows[kRows * N];
  const long long r0 = (long long)(blockIdx.x / tiles) * kRows;
  const int rows = (int)(R - r0 < kRows ? R - r0 : kRows);
  if (threadIdx.x < rows) {
    const long long r = r0 + threadIdx.x;
    b_start[threadIdx.x] = (r / S) * b_batch + (r % S) * b_seq;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * N; i += kThreads) b_rows[i] = widen(bmat[b_start[i / N] + i % N]);
  __syncthreads();
  // the L threads of a row are neighbours in a warp; c is this thread's place among them
  const int c = threadIdx.x % L;
  const long long d = (long long)(blockIdx.x % tiles) * (kThreads / L) + threadIdx.x / L;
  const bool active = d < D;  // a thread past the channels takes part in the exchange only
  float a[M];
#pragma unroll
  for (int m = 0; m < M; ++m) a[m] = active ? a_of(a_log[d * N + c * M + m]) : 0.0f;
  const T bias = dt_bias[active ? d : 0];
  const T* pre_p = dt_pre + (r0 + c) * D + d;
  const T* x_p = x + (r0 + c) * D + d;
  const long long o0 = (r0 * D + d) * N + c * M;
  float* a_out = dtA + o0;
  float* b_out = dBx + o0;
  for (int g0 = 0; g0 < rows; g0 += kAhead * L) {
    // the loads of the next kAhead groups of L rows first: the thread's row c of each group
    T pre[kAhead], xv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (active && g0 + u * L + c < rows) {
        pre[u] = pre_p[(long long)u * L * D];
        xv[u] = x_p[(long long)u * L * D];
      }
    }
    pre_p += (long long)kAhead * L * D;
    x_p += (long long)kAhead * L * D;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i0 = g0 + u * L;
      if (i0 >= rows) break;  // the same for every thread of the block
      // each of the L threads forms dt and dt * x of one of the group's L rows, once
      float dt = 0.0f, dtx = 0.0f;
      if (active && i0 + c < rows) {
        dt = dt_of(pre[u], bias);
        dtx = __fmul_rn(dt, widen(xv[u]));
      }
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (i0 + j >= rows) break;
        const float dt_j = L == 1 ? dt : __shfl_sync(0xffffffffu, dt, j, L);
        const float dtx_j = L == 1 ? dtx : __shfl_sync(0xffffffffu, dtx, j, L);
        if (active) {
          float b[M], out_a[M], out_b[M];
          load_states<M>(b_rows + (i0 + j) * N + c * M, b);
#pragma unroll
          for (int m = 0; m < M; ++m) state_inputs(dt_j, a[m], dtx_j, b[m], out_a[m], out_b[m]);
          store_states<M>(a_out, out_a);
          store_states<M>(b_out, out_b);
        }
        a_out += D * N;
        b_out += D * N;
      }
    }
  }
}

template <int N, typename T>
int launch(const void* dt_pre, const void* dt_bias, const void* a_log, const void* x, const void* bmat, void* dtA,
           void* dBx, long long R, long long D, long long S, long long b_batch, long long b_seq,
           cudaStream_t stream) {
  const long long tiles = (D + kThreads / lanes<N>() - 1) / (kThreads / lanes<N>());
  const long long blocks = tiles * ((R + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mamba_inputs_kernel<N, T><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dt_pre), static_cast<const T*>(dt_bias), static_cast<const float*>(a_log),
      static_cast<const T*>(x), static_cast<const T*>(bmat), static_cast<float*>(dtA), static_cast<float*>(dBx), R,
      D, S, b_batch, b_seq, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int N, const void* dt_pre, const void* dt_bias, const void* a_log, const void* x, const void* bmat,
             void* dtA, void* dBx, long long R, long long D, long long S, long long b_batch, long long b_seq,
             cudaStream_t stream) {
  switch (N) {
    case 1: return launch<1, T>(dt_pre, dt_bias, a_log, x, bmat, dtA, dBx, R, D, S, b_batch, b_seq, stream);
    case 2: return launch<2, T>(dt_pre, dt_bias, a_log, x, bmat, dtA, dBx, R, D, S, b_batch, b_seq, stream);
    case 4: return launch<4, T>(dt_pre, dt_bias, a_log, x, bmat, dtA, dBx, R, D, S, b_batch, b_seq, stream);
    case 8: return launch<8, T>(dt_pre, dt_bias, a_log, x, bmat, dtA, dBx, R, D, S, b_batch, b_seq, stream);
    case 16: return launch<16, T>(dt_pre, dt_bias, a_log, x, bmat, dtA, dBx, R, D, S, b_batch, b_seq, stream);
    case 32: return launch<32, T>(dt_pre, dt_bias, a_log, x, bmat, dtA, dBx, R, D, S, b_batch, b_seq, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the formation of dtA and dBx (B, S, D, N float32, fresh and contiguous) on `stream`
// and returns cudaGetLastError() (0 on success).  dt_pre and x are contiguous (B, S, D), the
// bias (D,), A_log contiguous (D, N) float32; bmat's element (b, s, n) lies at bmat + b b_batch
// + s b_seq + n.  dt_pre, the bias, x and B are of type `dtype` (kernel.DTYPES); N is one of
// 1, 2, 4, 8, 16, 32.  The inputs are left as they are.
extern "C" int mamba_inputs_launch(const void* dt_pre, const void* dt_bias, const void* a_log, const void* x,
                                   const void* bmat, void* dtA, void* dBx, long long B, long long S, long long D,
                                   int N, long long b_batch, long long b_seq, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long R = B * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_n<float>(N, dt_pre, dt_bias, a_log, x, bmat, dtA, dBx, R, D, S, b_batch, b_seq, st);
    case kBF16:
      return launch_n<__nv_bfloat16>(N, dt_pre, dt_bias, a_log, x, bmat, dtA, dBx, R, D, S, b_batch, b_seq, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
