// AdamW's update of one leaf, and a gradient's sum of squares for the global norm, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves AdamW (src/repro/optim/adamw.py::adamw_update)
// to XLA's fusion.  Eager PyTorch runs the plain update (repro_torch/kernels/adamw/ref.py::
// upd_block) as about ten float32 element-wise kernels a leaf, each reading and writing a float32
// temporary, and the global norm as three more passes a leaf (a float32 copy, its square, its
// sum).  On the glm4-9b train step (2.06 B bf16 parameters, float32 moments) that was half of the
// step's device time.
//
// adamw_update_kernel: one launch a leaf reads p, g, mu and nu once and writes fresh new_p,
// new_mu and new_nu once, computing upd_block's expression tree operation for operation in
// float32:
//   g'  = g * clip
//   mu' = b1 * mu + (1 - b1) * g'
//   nu' = b2 * nu + ((1 - b2) * g') * g'
//   d   = (mu' / b1c) / (sqrt(nu' / b2c) + eps) + wd * p
//   p'  = p - d * lr
// then rounds p', mu' and nu' to their storage types (round to nearest even).  Every operation
// is one IEEE-rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn; the build
// has --fmad=false and no fast math), as PyTorch's element-wise kernels round each of them, so
// the outputs equal the plain version's on the card bit for bit (NaN payloads aside).  clip,
// b1c, b2c and lr are the step's float32 values on the device (a buffer of 4 floats, read by
// pointer), so the host never waits for the gradient's norm.
//
// adamw_sumsq_kernel, then adamw_sumsq_final_kernel: the sum of x * x over a leaf (x widened to
// float32, each square rounded to float32 as torch.square rounds it) in two deterministic stages
// and no atomics.  Each thread accumulates in float32 on 8 lanes (one per element of its 16-byte
// loads), then lanes, warps and the block are summed in a fixed tree into one partial a block;
// one block then sums the partials in a fixed order.  The grid depends only on the card and the
// length, so the bits repeat from call to call; the order of the additions differs from
// torch.sum's, and so may the last bits.
//
// What bounds both on this card: bytes.  The update moves 3 P + 4 M bytes an element (P, M the
// parameter and moment sizes: 22 for bf16 parameters and float32 moments), the sum P, against
// HBM's 3.35 TB/s; a few dozen float32 operations an element are far below the card's rates.
// Design: each thread takes 8 consecutive elements at a time with 16-byte loads and stores
// (two for a float32 tensor), neighbouring threads on neighbouring 16 bytes, so a warp moves
// whole 512-byte segments; the loads are marked streaming (each byte is used once); indices are
// 64-bit (the 151552 x 4096 embedding is 620 M elements).  The update gives every thread one
// 8-element chunk and launches as many blocks as the leaf needs, so the block scheduler refills
// each SM as its blocks retire and every SM's memory pipes stay full to the end (at the
// embedding: 4.72 ms, 86.5 % of the bound, against 5.0-5.2 ms for a grid-stride loop over the
// blocks the card keeps resident; H100, 700 W).  The sum keeps the grid-stride loop over at most
// 1024 resident blocks, one partial each.  A tensor that starts off a 16-byte boundary takes a
// scalar head up to the first index where every pointer is aligned (none when they cannot all
// be: then every element goes the scalar way), and the ragged tail goes scalar too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads of an update or first-stage block
constexpr int kVec = 8;            // elements a thread takes at a time
constexpr int kMaxPartials = 1024; // first-stage blocks at most (kernel.SUMSQ_PARTIALS)
constexpr int kFinalThreads = 1024;

// dtype codes of the wrapper (kernel.DTYPES)
enum DType { kF32 = 0, kBF16 = 1 };

struct Consts {
  float b1, b2, one_b1, one_b2, eps, wd;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float& out) { out = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16& out) { out = __float2bfloat16_rn(x); }

// 8 elements from x (16-byte aligned), widened to float32.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ x, float (&v)[kVec]) {
  constexpr int kLoads = (int)(sizeof(T) * kVec / 16);  // 1 (bf16) or 2 (float32)
  const uint4* src = reinterpret_cast<const uint4*>(x);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const uint4 raw = __ldcs(src + k);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / kLoads; ++j) v[k * (kVec / kLoads) + j] = widen(e[j]);
  }
}

// 8 float32 values rounded to T and stored at x (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ x, const float (&v)[kVec]) {
  constexpr int kStores = (int)(sizeof(T) * kVec / 16);
  uint4* dst = reinterpret_cast<uint4*>(x);
#pragma unroll
  for (int k = 0; k < kStores; ++k) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / kStores; ++j) narrow(v[k * (kVec / kStores) + j], e[j]);
    __stcs(dst + k, raw);
  }
}

// upd_block's expression tree on one element, in place on (p, m, v).
__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v, const Consts& c, float clip,
                                              float b1c, float b2c, float lr) {
  g = __fmul_rn(g, clip);
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.one_b1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.one_b2, g), g));
  float d = __fdiv_rn(__fdiv_rn(m, b1c), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), c.eps));
  d = __fadd_rn(d, __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(d, lr));
}

// Elements [head, head + 8 * chunks) go 8 at a time; [0, head) and the rest of [.., n) one at a
// time.
template <typename P, typename M>
__global__ void __launch_bounds__(kThreads) adamw_update_kernel(
    const P* __restrict__ p, const P* __restrict__ g, const M* __restrict__ mu, const M* __restrict__ nu,
    P* __restrict__ new_p, M* __restrict__ new_mu, M* __restrict__ new_nu, const float* __restrict__ step,
    Consts c, long long n, long long head, long long chunks) {
  const float clip = step[0], b1c = step[1], b2c = step[2], lr = step[3];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long k = tid; k < chunks; k += stride) {
    const long long i = head + k * kVec;
    float vp[kVec], vg[kVec], vm[kVec], vv[kVec];
    load8(p + i, vp);
    load8(g + i, vg);
    load8(mu + i, vm);
    load8(nu + i, vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) adamw_element(vp[j], vg[j], vm[j], vv[j], c, clip, b1c, b2c, lr);
    store8(new_p + i, vp);
    store8(new_mu + i, vm);
    store8(new_nu + i, vv);
  }
  const long long body_end = head + chunks * kVec;
  const long long scalars = head + (n - body_end);
  for (long long k = tid; k < scalars; k += stride) {
    const long long i = k < head ? k : body_end + (k - head);
    float ep = widen(p[i]), em = widen(mu[i]), ev = widen(nu[i]);
    adamw_element(ep, widen(g[i]), em, ev, c, clip, b1c, b2c, lr);
    narrow(ep, new_p[i]);
    narrow(em, new_mu[i]);
    narrow(ev, new_nu[i]);
  }
}

// The block's sum of each thread's `s` (a fixed tree: warp shuffles, then warp 0 over the warps),
// valid in thread 0.
template <int kBlock>
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warp_sums[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = threadIdx.x < kBlock / 32 ? warp_sums[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adamw_sumsq_kernel(const T* __restrict__ x, float* __restrict__ partials,
                                                                 long long n, long long head, long long chunks) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  for (long long k = tid; k < chunks; k += stride) {
    float v[kVec];
    load8(x + head + k * kVec, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], v[j]));
  }
  const long long body_end = head + chunks * kVec;
  const long long scalars = head + (n - body_end);
  for (long long k = tid; k < scalars; k += stride) {
    const float v = widen(x[k < head ? k : body_end + (k - head)]);
    acc[0] = __fadd_rn(acc[0], __fmul_rn(v, v));
  }
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])),
                            __fadd_rn(__fadd_rn(acc[4], acc[5]), __fadd_rn(acc[6], acc[7])));
  const float total = block_sum<kThreads>(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kFinalThreads) adamw_sumsq_final_kernel(const float* __restrict__ partials,
                                                                           int count, float* __restrict__ out) {
  const float total = block_sum<kFinalThreads>(threadIdx.x < count ? partials[threadIdx.x] : 0.0f);
  if (threadIdx.x == 0) out[0] = total;
}

// The first element index (< 8) from which every pointer is 16-byte aligned, or -1 when there
// is none.
int vector_head(const void* const* ptrs, const int* sizes, int count) {
  for (int h = 0; h < kVec; ++h) {
    bool aligned = true;
    for (int i = 0; i < count; ++i) aligned = aligned && ((uintptr_t)ptrs[i] + (uintptr_t)h * sizes[i]) % 16 == 0;
    if (aligned) return h;
  }
  return -1;
}

// head and chunks of a leaf of n elements whose pointers are ptrs.
void split(const void* const* ptrs, const int* sizes, int count, long long n, long long& head, long long& chunks) {
  const int h = vector_head(ptrs, sizes, count);
  if (h < 0) {
    head = chunks = 0;
    return;
  }
  head = h < n ? h : n;
  chunks = (n - head) / kVec;
}

// Blocks of `kernel` for `work` thread items: at most what the card keeps resident at once, and
// at most `cap`.
template <typename K>
cudaError_t resident_grid(K kernel, long long work, long long cap, long long& blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  blocks = (work + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return cudaSuccess;
}

template <typename P, typename M>
int launch_update(const void* p, const void* g, const void* mu, const void* nu, void* new_p, void* new_mu,
                  void* new_nu, const float* step, Consts c, long long n, cudaStream_t stream) {
  const void* ptrs[7] = {p, g, mu, nu, new_p, new_mu, new_nu};
  const int sizes[7] = {sizeof(P), sizeof(P), sizeof(M), sizeof(M), sizeof(P), sizeof(M), sizeof(M)};
  long long head, chunks;
  split(ptrs, sizes, 7, n, head, chunks);
  const long long work = chunks + head + (n - head - chunks * kVec);
  long long grid = (work + kThreads - 1) / kThreads;  // one item a thread
  if (grid > 0x7fffffffLL) grid = 0x7fffffffLL;       // past 2^42 elements the threads loop
  adamw_update_kernel<P, M><<<(unsigned int)grid, kThreads, 0, stream>>>(
      static_cast<const P*>(p), static_cast<const P*>(g), static_cast<const M*>(mu), static_cast<const M*>(nu),
      static_cast<P*>(new_p), static_cast<M*>(new_mu), static_cast<M*>(new_nu), step, c, n, head, chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sumsq(const void* x, float* partials, float* out, long long n, cudaStream_t stream) {
  const void* ptrs[1] = {x};
  const int sizes[1] = {sizeof(T)};
  long long head, chunks;
  split(ptrs, sizes, 1, n, head, chunks);
  const long long work = chunks + head + (n - head - chunks * kVec);
  long long grid = 0;
  const cudaError_t err = resident_grid(adamw_sumsq_kernel<T>, work, kMaxPartials, grid);
  if (err != cudaSuccess) return (int)err;
  adamw_sumsq_kernel<T><<<(unsigned int)grid, kThreads, 0, stream>>>(static_cast<const T*>(x), partials, n, head,
                                                                     chunks);
  adamw_sumsq_final_kernel<<<1, kFinalThreads, 0, stream>>>(partials, (int)grid, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the update of one leaf of n elements on `stream` and returns cudaGetLastError() (0 on
// success).  p and g are of type `param_dtype`, mu and nu of `moment_dtype` (kernel.DTYPES), each
// contiguous; new_p, new_mu and new_nu are fresh tensors of the same types; step holds the
// float32 [clip, b1c, b2c, lr] on the device.  The inputs are left as they are.
extern "C" int adamw_update_launch(const void* p, const void* g, const void* mu, const void* nu, void* new_p,
                                   void* new_mu, void* new_nu, const void* step, float b1, float b2, float one_b1,
                                   float one_b2, float eps, float wd, long long n, int param_dtype, int moment_dtype,
                                   void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Consts c{b1, b2, one_b1, one_b2, eps, wd};
  const float* s = static_cast<const float*>(step);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (param_dtype == kBF16 && moment_dtype == kF32)
    return launch_update<__nv_bfloat16, float>(p, g, mu, nu, new_p, new_mu, new_nu, s, c, n, st);
  if (param_dtype == kBF16 && moment_dtype == kBF16)
    return launch_update<__nv_bfloat16, __nv_bfloat16>(p, g, mu, nu, new_p, new_mu, new_nu, s, c, n, st);
  if (param_dtype == kF32 && moment_dtype == kF32)
    return launch_update<float, float>(p, g, mu, nu, new_p, new_mu, new_nu, s, c, n, st);
  if (param_dtype == kF32 && moment_dtype == kBF16)
    return launch_update<float, __nv_bfloat16>(p, g, mu, nu, new_p, new_mu, new_nu, s, c, n, st);
  return (int)cudaErrorInvalidValue;
}

// Launches the two stages of the sum of squares of x (n elements of type `dtype`, contiguous) on
// `stream` and returns cudaGetLastError(); partials holds kMaxPartials float32, out one.
extern "C" int adamw_sumsq_launch(const void* x, void* partials, void* out, long long n, int dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_sumsq<float>(x, part, o, n, st);
    case kBF16: return launch_sumsq<__nv_bfloat16>(x, part, o, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
