// Forward flash attention (causal and/or sliding window, GQA) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_tpu (body
// _attn_kernel), the Pallas TPU kernel that runs prefill attention in the models
// (models/layers.py apply_attention).  It computes the same function:
//   o[b, q, h] = sum_k softmax_k(q . k * 1/sqrt(D)) v[b, k, h / G]
// over the visible keys (k <= q + q_offset when causal, k > q + q_offset - window with a
// window), with the online softmax (m, l, acc) in float32, masked scores set to -1e30
// (finite, as the TPU kernel does) and l clamped to 1e-37 at the end.
//
// Design: one block per (batch, kv head, q tile).  The G query heads of the kv head become
// rows of the tile (rows / G query positions x G heads), so a kv tile loaded once serves
// every head that reads it.  A loop over kv tiles inside the block takes the place of the
// TPU's sequential grid axis; it runs only over the tiles that some row of the block sees
// (causal and window bounds), so fully masked tiles are skipped, and partial tiles (the
// diagonal, the window's edge, a ragged last tile) get the position mask.  Two bodies:
//   * bfloat16 (the models' dtype): tensor cores.  128 rows and 8 warps a block, each warp
//     16 rows, FlashAttention-2's register layout: S = Q K^T and O accumulate in float32
//     registers through mma.sync.m16n8k16 on bf16 fragments read with ldmatrix from padded
//     (bank-conflict-free) shared memory; the row max / sum are quad shuffles; P is rounded
//     to bf16 for the PV product (the TPU kernel keeps it in float32: an ulp of bf16).
//   * float32: the FMA units, 64 rows and 256 threads a block; each thread computes a
//     column of scores for its rows and folds P V into its output column's accumulators.
//
// What bounds it on this card: bf16 tensor-core FLOPs, 4 * D per visible (q, k) pair
// (QK^T and PV) at 989 TFLOP/s.  What the simple design leaves on the table: wgmma (the
// only way to the full rate; mma.sync reaches a fraction of it), TMA loads of K / V
// double-buffered against the math (here every tile is loaded, then computed, behind a
// __syncthreads), a persistent schedule that balances the causal triangle, and, for
// float32, any tensor-core path at all (3xTF32 could keep float32 accuracy).
//
// Built with the rest of the port with --fmad=false; the float32 dot products use explicit
// fmaf, so they are single-rounding FMAs all the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // float32 body
constexpr int kRows = 64;      // query rows (positions x heads) of a float32 block
constexpr int kMmaWarps = 8;   // bf16 body: warps of a block, 16 rows each
constexpr int kMmaRows = 16 * kMmaWarps;
constexpr int kMaxGroup = 64;  // largest G = H / KV (the float32 tile's rows)
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;  // (B, Sq, H, D)
  const void* k;  // (B, Sk, KV, D)
  const void* v;  // (B, Sk, KV, D)
  void* o;        // (B, Sq, H, D)
  long long B, Sq, Sk, H, KV, G, q_tile, window, q_offset;  // q_tile: positions a block
  int causal;
  float scale;
};

// Shared-memory floats of one block: Q rows, K^T (padded rows), V, P, and m / l / alpha.
template <int D, int KT>
constexpr int smem_floats() {
  return kRows * D + D * (KT + 1) + KT * D + kRows * KT + 3 * kRows;
}

// ---------------------------------------------------------------------------------------
// float32 body: FMA units
// ---------------------------------------------------------------------------------------

template <int D, int KT>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(const Args a) {
  static_assert(kThreads % KT == 0 && KT % 32 == 0 && D % 4 == 0, "tile shape");
  constexpr int kScoreGroups = kThreads / KT;          // row groups of the score phase
  constexpr int kScoreRows = kRows / kScoreGroups;     // score rows per thread
  constexpr int kAccRows = kRows * D / kThreads;       // output rows per thread
  constexpr int kAccGroups = kThreads / D > 0 ? kThreads / D : 1;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* kt = qs + kRows * D;                   // [D][KT + 1]: K transposed
  float* vs = kt + D * (KT + 1);                // [KT][D]
  float* ps = vs + KT * D;                      // [kRows][KT]: scores, then P
  float* m_s = ps + kRows * KT;                 // [kRows]
  float* l_s = m_s + kRows;                     // [kRows]
  float* alpha_s = l_s + kRows;                 // [kRows]

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);
  const int tid = threadIdx.x;
  const long long kvh = blockIdx.y, b = blockIdx.z;
  const long long q0 = (long long)blockIdx.x * a.q_tile;  // first query index of the tile
  const long long nq = min(a.q_tile, a.Sq - q0);          // query positions in the tile
  const int rows = (int)(nq * a.G);                       // valid rows; the rest stay zero

  // Q tile: row r is position q0 + r / G of head kvh * G + r % G (contiguous in memory)
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < rows) x = q[((b * a.Sq + q0 + r / a.G) * a.H + kvh * a.G + r % a.G) * D + d];
    qs[i] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // the keys that some row of the tile sees
  const long long q_lo = q0 + a.q_offset, q_hi = q0 + nq - 1 + a.q_offset;
  long long k_begin = 0, k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  if (a.window) k_begin = max(k_begin, q_lo - a.window + 1);

  const int acc_col = tid % D, acc_group = tid / D;  // output column and row group
  float acc[kAccRows];
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) acc[j] = 0.f;

  const int s_col = tid % KT, s_group = tid / KT;  // score column and row group
  const int warp = tid / 32, lane = tid % 32;

  for (long long k0 = (k_begin / KT) * KT; k0 < k_end; k0 += KT) {
    __syncthreads();  // the previous tile's P and V are consumed (and Q is stored)
    for (int i = tid; i < KT * D; i += kThreads) {
      const int c = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < a.Sk) {
        const long long off = ((b * a.Sk + k0 + c) * a.KV + kvh) * D + d;
        kx = k[off];
        vx = v[off];
      }
      kt[d * (KT + 1) + c] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    // scores of column s_col for rows s_group + j * kScoreGroups
    {
      float s[kScoreRows];
#pragma unroll
      for (int j = 0; j < kScoreRows; ++j) s[j] = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float k_0 = kt[(d + 0) * (KT + 1) + s_col];
        const float k_1 = kt[(d + 1) * (KT + 1) + s_col];
        const float k_2 = kt[(d + 2) * (KT + 1) + s_col];
        const float k_3 = kt[(d + 3) * (KT + 1) + s_col];
#pragma unroll
        for (int j = 0; j < kScoreRows; ++j) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[(s_group + j * kScoreGroups) * D + d]);
          s[j] = fmaf(qv.x, k_0, s[j]);
          s[j] = fmaf(qv.y, k_1, s[j]);
          s[j] = fmaf(qv.z, k_2, s[j]);
          s[j] = fmaf(qv.w, k_3, s[j]);
        }
      }
      const long long kp = k0 + s_col;
#pragma unroll
      for (int j = 0; j < kScoreRows; ++j) {
        const int r = s_group + j * kScoreGroups;
        const long long qp = q0 + r / a.G + a.q_offset;
        bool visible = kp < a.Sk;
        if (a.causal) visible = visible && kp <= qp;
        if (a.window) visible = visible && kp > qp - a.window;
        ps[r * KT + s_col] = visible ? s[j] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: a warp per row
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < KT; c += 32) mx = fmaxf(mx, ps[r * KT + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < KT; c += 32) {
        const float p = expf(ps[r * KT + c] - m_new);
        ps[r * KT + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for column acc_col, rows acc_group + j * kAccGroups
#pragma unroll
    for (int j = 0; j < kAccRows; ++j) acc[j] *= alpha_s[acc_group + j * kAccGroups];
    for (int c = 0; c < KT; c += 4) {
      const float v_0 = vs[(c + 0) * D + acc_col];
      const float v_1 = vs[(c + 1) * D + acc_col];
      const float v_2 = vs[(c + 2) * D + acc_col];
      const float v_3 = vs[(c + 3) * D + acc_col];
#pragma unroll
      for (int j = 0; j < kAccRows; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(&ps[(acc_group + j * kAccGroups) * KT + c]);
        acc[j] = fmaf(p.x, v_0, acc[j]);
        acc[j] = fmaf(p.y, v_1, acc[j]);
        acc[j] = fmaf(p.z, v_2, acc[j]);
        acc[j] = fmaf(p.w, v_3, acc[j]);
      }
    }
  }
  __syncthreads();  // l of a tile that visited no kv tile is the initial 0

#pragma unroll
  for (int j = 0; j < kAccRows; ++j) {
    const int r = acc_group + j * kAccGroups;
    if (r < rows) {
      const float l = fmaxf(l_s[r], 1e-37f);
      o[((b * a.Sq + q0 + r / a.G) * a.H + kvh * a.G + r % a.G) * D + acc_col] = acc[j] / l;
    }
  }
}


// ---------------------------------------------------------------------------------------
// bfloat16 body: mma.sync tensor-core tiles
// ---------------------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows of the padded shared tiles: D + 8 bf16, so the 8 rows an ldmatrix reads start 16
// bytes apart in the banks.
template <int D>
__host__ __device__ constexpr int mma_stride() {
  return D + 8;
}

template <int D, int KT>
constexpr int mma_smem_bytes() {
  return (int)sizeof(__nv_bfloat16) * (kMmaRows + 2 * KT) * mma_stride<D>();
}

// Copies `n` rows of D bf16 into a padded shared tile, 16 bytes a thread at a time; row i
// comes from src + offset(i), rows at or past `valid` are zero.
template <int D, typename Offset>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, const __nv_bfloat16* src, int n, int valid,
                                          Offset offset) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += kMmaWarps * 32) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + offset(r) + c * 8);
    *reinterpret_cast<uint4*>(tile + r * mma_stride<D>() + c * 8) = x;
  }
}

template <int D, int KT>
__global__ void __launch_bounds__(kMmaWarps * 32) flash_attention_mma_kernel(const Args a) {
  static_assert(D % 16 == 0 && KT % 16 == 0, "tile shape");
  constexpr int S = mma_stride<D>();
  constexpr int kKeyTiles = KT / 8;  // n-tiles of S
  constexpr int kDimTiles = D / 8;   // n-tiles of O

  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kMmaRows][S]
  __nv_bfloat16* ks = qs + kMmaRows * S;                            // [KT][S]
  __nv_bfloat16* vs = ks + KT * S;                                  // [KT][S]

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // the fragment's row group and column pair
  const long long kvh = blockIdx.y, b = blockIdx.z;
  const long long q0 = (long long)blockIdx.x * a.q_tile;
  const long long nq = min(a.q_tile, a.Sq - q0);
  const int rows = (int)(nq * a.G);

  const long long q_base = b * a.Sq * a.H + kvh * a.G;  // (b, q0 + r / G, kvh * G + r % G)
  load_rows<D>(qs, q + (q_base + q0 * a.H) * D, kMmaRows, rows,
               [&](int r) { return ((long long)(r / a.G) * a.H + r % a.G) * D; });

  // this thread's two rows (g and g + 8 of its warp's 16) and their absolute positions
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const long long qp0 = q0 + r0 / a.G + a.q_offset, qp1 = q0 + r1 / a.G + a.q_offset;

  const long long q_lo = q0 + a.q_offset, q_hi = q0 + nq - 1 + a.q_offset;
  long long k_begin = 0, k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  if (a.window) k_begin = max(k_begin, q_lo - a.window + 1);

  float acc[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only

  const long long kv_base = (b * a.Sk * a.KV + kvh) * D;
  for (long long k0 = (k_begin / KT) * KT; k0 < k_end; k0 += KT) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    const int kvalid = (int)min((long long)KT, a.Sk - k0);
    const auto key_offset = [&](int c) { return (k0 + c) * a.KV * D; };
    load_rows<D>(ks, k + kv_base, KT, kvalid, key_offset);
    load_rows<D>(vs, v + kv_base, KT, kvalid, key_offset);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x KT keys
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qs + (warp * 16 + lane % 16) * S + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < kKeyTiles; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (j * 8 + (lane / 16) * 8 + lane % 8) * S + kk + ((lane / 8) % 2) * 8);
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
      }
    }

    // scale, mask where the tile is not visible to every row of the block
    const bool full = k0 + KT <= a.Sk && (!a.causal || k0 + KT - 1 <= q_lo) && (!a.window || k0 > q_hi - a.window);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long kp = k0 + j * 8 + 2 * t + (e & 1);
        const long long qp = e < 2 ? qp0 : qp1;
        bool visible = true;
        if (!full) {
          visible = kp < a.Sk;
          if (a.causal) visible = visible && kp <= qp;
          if (a.window) visible = visible && kp > qp - a.window;
        }
        s[j][e] = visible ? s[j][e] * a.scale : kNegInf;
      }
    }

    // online softmax on the two rows; a row's four threads are one quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        s[j][2 * h] = expf(s[j][2 * h] - m_new);
        s[j][2 * h + 1] = expf(s[j][2 * h + 1] - m_new);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < kDimTiles; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator layout is the A fragment of the next product
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDimTiles; j += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * S + j * 8 + (lane / 16) * 8);
        mma_bf16(acc[j], pa, vb[0], vb[1]);
        mma_bf16(acc[j + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // l over the row's quad, then O / l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-37f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    if (r >= rows) continue;
    __nv_bfloat16* out = o + (q_base + (q0 + r / a.G) * a.H + r % a.G) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j) {
      const __nv_bfloat162 x = __floats2bfloat162_rn(acc[j][2 * h] / l[h], acc[j][2 * h + 1] / l[h]);
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) = x;
    }
  }
}

template <int D, int KT>
int launch_mma(Args a, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<D, KT>();
  auto kernel = flash_attention_mma_kernel<D, KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  a.q_tile = kMmaRows / a.G;
  const dim3 grid((unsigned int)((a.Sq + a.q_tile - 1) / a.q_tile), (unsigned int)a.KV, (unsigned int)a.B);
  kernel<<<grid, kMmaWarps * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_bf16(const Args& a, long long D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16, 64>(a, stream);
    case 32: return launch_mma<32, 64>(a, stream);
    case 64: return launch_mma<64, 64>(a, stream);
    case 128: return launch_mma<128, 64>(a, stream);
    case 256: return launch_mma<256, 32>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D, int KT>
int launch_fma(Args a, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<D, KT>();
  a.q_tile = kRows / a.G;
  auto kernel = flash_attention_f32_kernel<D, KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((a.Sq + a.q_tile - 1) / a.q_tile), (unsigned int)a.KV, (unsigned int)a.B);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_f32(const Args& a, long long D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_fma<16, 64>(a, stream);
    case 32: return launch_fma<32, 64>(a, stream);
    case 64: return launch_fma<64, 64>(a, stream);
    case 128: return launch_fma<128, 64>(a, stream);
    case 256: return launch_fma<256, 32>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the attention on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v, o are contiguous device pointers of the shapes above; dtype 0 is float32, 1 is
// bfloat16 (o has q's dtype).  The caller checks shapes, dtypes, D in {16, 32, 64, 128, 256},
// 1 <= G = H / KV <= 64 and that q, k, v start on 16-byte boundaries.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, long long B,
                                      long long Sq, long long Sk, long long H, long long KV, long long D,
                                      long long causal, long long window, long long q_offset, long long dtype,
                                      float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || B <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.window = window;
  a.q_offset = q_offset;
  a.causal = causal ? 1 : 0;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, D, s);
  if (dtype == 1) return launch_bf16(a, D, s);
  return (int)cudaErrorInvalidValue;
}
