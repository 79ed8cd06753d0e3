// Flash attention (causal and/or sliding window, GQA) for Hopper (sm_90a): the forward, and
// the backward of bfloat16 at D in {64, 112, 128} (its own note, further down).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_tpu (body
// _attn_kernel), the Pallas TPU kernel that runs prefill attention in the models
// (models/layers.py apply_attention).  It computes the same function:
//   o[b, q, h] = sum_k softmax_k(q . k * 1/sqrt(D)) v[b, k, h / G]
// over the visible keys (k <= q + q_offset when causal, k > q + q_offset - window with a
// window), with the online softmax (m, l, acc) in float32, masked scores set to -1e30
// (finite, as the TPU kernel does) and l clamped to 1e-37 at the end.
//
// What bounds it on this card: bf16 tensor-core operations, 4 * D per visible (q, k) pair
// and head (Q K^T and P V) at 989 TFLOP/s.
//
// Every body runs one block per (batch, kv head, q tile).  The G query heads of the kv head
// are rows of the tile (rows / G query positions x G heads), so a kv tile loaded once serves
// every head that reads it, and a tile of 128 rows spans only 128 / G positions, which keeps
// the causal diagonal's masked work small.  A loop over kv tiles inside the block takes the
// place of the TPU's sequential grid axis; it runs only over the tiles that some row of the
// block sees (k_hi > q_lo - window and k_lo <= q_hi, the TPU kernel's tests), and only the
// tiles that some row does not see in full (the diagonal, the window's edge, a ragged last
// tile) pay for the position mask.
//
// bfloat16, D in {64, 112, 128, 256} (the served models' 64, 112, 128 and 256):
// warp-specialised wgmma + TMA, in the shape of FlashAttention-3.
//   * Three warpgroups.  Warpgroup 0 gives its registers back (setmaxnreg.dec to 40) and one
//     of its threads issues TMA loads: the 128-row Q tile once (a 4-d box {64 columns, G
//     heads, 128 / G positions, 1} over q as (B, Sq, H, D), so the GQA packing costs no
//     index math), then K and V tiles into a ring of 2 stages, each with a full and an
//     empty mbarrier (K and V apart, so Q K^T starts before V lands).  Warpgroups 1 and 2
//     (setmaxnreg.inc to 232) take 64 rows each: S = Q K^T with wgmma m64nKTk16, both
//     operands in shared memory in the 128-byte swizzle TMA writes; the online softmax on
//     the float32 accumulators; O += P V with P rounded to bf16 in registers as the A
//     operand and V as an MN-major B descriptor (no transpose pass).
//   * Overlap: intra-warpgroup pipelining.  Each consumer issues tile j's Q K^T and tile
//     j-1's P V back to back, waits for the first only, runs tile j's softmax while P V is
//     on the tensor cores, then waits for P V and rescales O.  Chosen over ping-pong
//     scheduling of the two warpgroups because it needs no cross-warpgroup barriers and
//     works the same for every D; ping-pong on top of it (named barriers handing the
//     issue of the products from one warpgroup to the other) and a third K / V stage
//     were each measured at the served shapes and moved nothing (PERF.md).
//   * Tiles (Q + 2 stages of K and V in shared memory): D = 64: 128 x 128 keys (80 KB);
//     D = 128: 128 x 128 (160 KB); D = 256: 128 x 64 (192 KB; O is 128 registers a thread).
//   * D = 112 (kimi-k2: 7168 / 64 heads) runs the D = 128 layout: the tensor maps give the
//     rows their real 112 columns, so TMA fills columns 112-127 of every Q, K and V box
//     with zeros (the boxes' bytes, which the mbarriers count, are whole either way) and
//     clips them off the O store.  Q K^T takes K = 112 (7 wgmma steps of 16); P V runs N =
//     128, whose last 16 columns are zeros and never stored.  No padded copy is made.
//   * Softmax in the exp2 domain: p = ex2.approx(fmaf(s, scale * log2 e, -m * scale *
//     log2 e)), alpha = ex2((m_old - m_new) * scale * log2 e).  The library is built with
//     --fmad=false (the sweep's bits need it), so this one contraction is written out.  A
//     row that has seen only masked keys keeps the plain version's value: equal weights
//     (p = 1) where its scores are all -1e30.
//   * Ragged edges: TMA fills out-of-bounds rows with zeros (their keys are masked; their
//     query rows are never stored), and O leaves by TMA stores, which clip at Sq.  O is
//     staged in the swizzled Q tile, whose reads are done by then.
//   * Schedule: q tiles run heaviest first under a causal mask (the grid's slow axis walks
//     q tiles from the last), so the diagonal's light tiles fill the tail.
// bfloat16, D in {16, 32}: those rows are 32 and 64 bytes, which would need swizzle modes
// and descriptors of their own; they keep the mma.sync body of the first port (8 warps x
// 16 rows, ldmatrix fragments from padded shared memory).  No served model has them.
// float32 (small checks only): the FMA units, 64 rows and 256 threads a block; its dot
// products use explicit fmaf, so they are single-rounding FMAs under --fmad=false too.
//
// LSE: given a pointer (the wrapper passes one only when a gradient is asked for), every body
// also writes each row's log-sum-exp m + log l of the scaled scores (natural log, float32,
// (B, H, Sq)) in its epilogue, for the backward kernels at the end of this file; with a null
// pointer nothing more is written.
//
// What this design still leaves: FP8, multicast of K / V to a cluster of q tiles, and a
// persistent grid.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

constexpr int kThreads = 256;  // float32 body
constexpr int kRows = 64;      // query rows (positions x heads) of a float32 block
constexpr int kMmaWarps = 8;   // mma.sync body: warps of a block, 16 rows each
constexpr int kMmaRows = 16 * kMmaWarps;
constexpr int kMaxGroup = 64;  // largest G = H / KV (the float32 tile's rows)
constexpr int kHeadDim112 = 112;  // the one head dim that is no power of two
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;  // (B, Sq, H, D)
  const void* k;  // (B, Sk, KV, D)
  const void* v;  // (B, Sk, KV, D)
  void* o;        // (B, Sq, H, D)
  float* lse;     // (B, H, Sq) float32, or null: m + log l of each row (natural log, scaled scores)
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
  static_assert(kThreads % KT == 0 && KT % 32 == 0 && D % 4 == 0 && D <= kThreads, "tile shape");
  constexpr int kScoreGroups = kThreads / KT;          // row groups of the score phase
  constexpr int kScoreRows = kRows / kScoreGroups;     // score rows per thread
  constexpr int kAccGroups = kThreads / D;             // row groups of the output phase
  constexpr int kAccRows = kRows / kAccGroups;         // output rows per thread
  static_assert(kRows % kAccGroups == 0, "output rows");

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
  const bool acc_active = acc_group < kAccGroups;    // D = 112: threads 224-255 hold no output
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
    if (!acc_active) continue;
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
    if (acc_active && r < rows) {
      const float l = fmaxf(l_s[r], 1e-37f);
      o[((b * a.Sq + q0 + r / a.G) * a.H + kvh * a.G + r % a.G) * D + acc_col] = acc[j] / l;
    }
  }
  if (a.lse != nullptr) {  // m is in units of scaled scores here
    for (int r = tid; r < rows; r += kThreads)
      a.lse[(b * a.H + kvh * a.G + r % a.G) * a.Sq + q0 + r / a.G] = m_s[r] + logf(fmaxf(l_s[r], 1e-37f));
  }
}


// ---------------------------------------------------------------------------------------
// bfloat16 body, D in {16, 32}: mma.sync tensor-core tiles
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
    if (a.lse != nullptr && t == 0)  // m is in units of scaled scores here
      a.lse[(b * a.H + kvh * a.G + r % a.G) * a.Sq + q0 + r / a.G] = m[h] + logf(l[h]);
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

// ---------------------------------------------------------------------------------------
// bfloat16 body, D in {64, 128, 256}: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------------------

constexpr int kTmaRows = 128;     // query rows of a block: two consumer warpgroups x 64
constexpr int kTmaThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kSwizzleRow = 128;  // bytes of a swizzled row: 64 bf16 columns

template <int D>
struct TmaTile;
template <>
struct TmaTile<64> {
  static constexpr int KT = 128, STAGES = 2;
};
template <>
struct TmaTile<128> {
  static constexpr int KT = 128, STAGES = 2;
};
template <>
struct TmaTile<256> {
  static constexpr int KT = 64, STAGES = 2;
};

// Shared memory of a block, in bytes from a 1024-byte aligned base (the swizzle atom).  Q
// (then O) and each K / V stage are D / 64 column chunks of [rows][64] bf16.
template <int D, int KT, int STAGES>
struct TmaLayout {
  static constexpr int q_bytes = kTmaRows * D * 2;
  static constexpr int kv_bytes = KT * D * 2;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + STAGES * kv_bytes;
  static constexpr int bar_off = v_off + STAGES * kv_bytes;
  static constexpr int n_bars = 1 + 4 * STAGES;  // Q full; K / V full and empty per stage
  static constexpr int bytes = bar_off + 8 * n_bars + 1024;  // + the slack to align the base
};

struct TmaArgs {
  int Sq, Sk, KV, G, P, n_qtiles, window, q_offset, causal;  // P: positions a q tile
  float scale_log2;                                           // 1/sqrt(D) * log2(e)
  float* lse;                                                 // (B, H, Sq), or null
};

constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma descriptor of a 128-byte swizzled operand: 8-row groups 1024 bytes apart (SBO);
// `lbo` is the distance between 64-column chunks of an MN-major operand (unused K-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of registers that an in-flight wgmma owns.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// d (64 x 64, float32) (+)= A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, float32) (+)= A (64 x 16, shared, K-major) * B (128 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) += A (64 x 16, bf16 registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, bf16 registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256, float32) += A (64 x 16, bf16 registers) * B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, accumulate);
  else wgmma_ss_n128(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

// S = Q K^T for a consumer's 64 rows: DK / 16 steps of 16 columns (32 bytes inside a
// swizzled row; a new column chunk every 4 steps).
template <int DK, int KT>
__device__ __forceinline__ void issue_qk(float (&s)[KT / 2], uint32_t q_addr, uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t a = sw128_desc(q_addr + (kk / 4) * kTmaRows * kSwizzleRow + off, 16);
    const uint64_t b = sw128_desc(k_addr + (kk / 4) * KT * kSwizzleRow + off, 16);
    wgmma_ss<KT>(s, a, b, kk > 0);
  }
  wgmma_commit();
}

// O += P V: KT / 16 steps of 16 keys; V is MN-major (D contiguous), its column chunks KT
// rows apart.
template <int D, int KT>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], uint32_t (&p)[KT / 4], uint32_t v_addr) {
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_rs<D>(o, p + 4 * kk, sw128_desc(v_addr + kk * 16 * kSwizzleRow, KT * kSwizzleRow));
  wgmma_commit();
}

// The online softmax of one kv tile on this thread's two rows (h = 0: row r0, h = 1: row
// r0 + 8), whose columns 8 j + 2 t (+1) lie in s[4 j + 2 h] (+1).  Leaves P in s and the
// factor of the old O in alpha.
template <int KT, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[KT / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const TmaArgs& a, int k0, int t, int qp0, int qp1) {
  if (kMask) {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        bool visible = kp < a.Sk;
        if (a.causal) visible = visible && kp <= qp;
        if (a.window) visible = visible && kp > qp - a.window;
        if (!visible) s[4 * j + e] = kNegInf;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    alpha[h] = ex2((m[h] - m_new) * a.scale_log2);
    const float neg = -(m_new * a.scale_log2);
    const bool dead = kMask && m_new == kNegInf;  // every key so far masked: equal weights
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = dead ? 1.f : ex2(fmaf(x, a.scale_log2, neg));
        sum += x;
      }
    }
    l[h] = l[h] * alpha[h] + sum;
    m[h] = m_new;
  }
}

// The softmax of kv tile `i` (masked only where some row of the block does not see all of
// it), then P rounded to bf16 as the A fragments of the P V product: columns 16 k .. 16 k
// + 15 of S are registers 8 k .. 8 k + 7, which pack in pairs into p[4 k] .. p[4 k + 3].
template <int KT>
__device__ __forceinline__ void softmax_step(float (&s)[KT / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const TmaArgs& a, int k0, int q_lo, int q_hi, int t, int qp0,
                                             int qp1) {
  const bool full = k0 + KT <= a.Sk && (!a.causal || k0 + KT - 1 <= q_lo) && (!a.window || k0 > q_hi - a.window);
  if (full) softmax_tile<KT, false>(s, m, l, alpha, a, k0, t, qp0, qp1);
  else softmax_tile<KT, true>(s, m, l, alpha, a, k0, t, qp0, qp1);
}

template <int KT>
__device__ __forceinline__ void pack_p(uint32_t (&p)[KT / 4], const float (&s)[KT / 2]) {
#pragma unroll
  for (int j = 0; j < KT / 4; ++j) {
    const __nv_bfloat162 v2 = __floats2bfloat162_rn(s[2 * j], s[2 * j + 1]);
    p[j] = *reinterpret_cast<const uint32_t*>(&v2);
  }
}

// D: the columns of the shared-memory rows (a multiple of 64); DK <= D: the head dim, the
// columns of the rows in memory (D = 128, DK = 112 for kimi-k2; DK = D otherwise).
template <int D, int KT, int STAGES, int DK>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_attention_tma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
                               const TmaArgs a) {
  using L = TmaLayout<D, KT, STAGES>;
  constexpr int kChunks = D / 64;
  static_assert(D % 64 == 0 && KT % 16 == 0 && (KT == 64 || KT == 128), "tile shape");
  static_assert(DK % 16 == 0 && DK <= D && DK > D - 64, "head dim");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;  // Q, then O
  uint8_t* ks = smem + L::k_off;
  uint8_t* vs = smem + L::v_off;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int qt = a.causal ? a.n_qtiles - 1 - (int)blockIdx.y : (int)blockIdx.y;  // heaviest first
  const int q0 = qt * a.P;
  const int nq = min(a.P, a.Sq - q0);
  const int q_lo = q0 + a.q_offset, q_hi = q0 + nq - 1 + a.q_offset;
  int k_begin = 0, k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  if (a.window) k_begin = max(k_begin, q_lo - a.window + 1);
  const int t_first = k_begin / KT;
  const int n_tiles = max(0, (k_end + KT - 1) / KT - t_first);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(k_empty + s, 8);  // one arrival per consumer warp
      hopper::mbar_init(v_empty + s, 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);  // warp-uniform, as the compiler sees it
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_full, kChunks * a.G * a.P * kSwizzleRow);
      for (int c = 0; c < kChunks; ++c)
        hopper::tma_load_4d(qs + c * kTmaRows * kSwizzleRow, &q_map, q_full, c * 64, kvh * a.G, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        const int k0 = (t_first + i) * KT;
        hopper::mbar_wait(k_empty + s, ph ^ 1);
        hopper::mbar_expect_tx(k_full + s, L::kv_bytes);
        for (int c = 0; c < kChunks; ++c)
          hopper::tma_load_4d(ks + s * L::kv_bytes + c * KT * kSwizzleRow, &k_map, k_full + s, c * 64, kvh, k0, b);
        hopper::mbar_wait(v_empty + s, ph ^ 1);
        hopper::mbar_expect_tx(v_full + s, L::kv_bytes);
        for (int c = 0; c < kChunks; ++c)
          hopper::tma_load_4d(vs + s * L::kv_bytes + c * KT * kSwizzleRow, &v_map, v_full + s, c * 64, kvh, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    hopper::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = cw * 64 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    const int qp0 = q0 + r0 / a.G + a.q_offset, qp1 = q0 + (r0 + 8) / a.G + a.q_offset;
    const uint32_t q_addr = hopper::smem_u32(qs) + cw * 64 * kSwizzleRow;
    const uint32_t k_addr = hopper::smem_u32(ks), v_addr = hopper::smem_u32(vs);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    uint32_t p[KT / 4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

    // S lives in fresh registers each tile (written only by wgmma before the softmax), so
    // no instruction outside wgmma defines a wgmma's registers while another is in flight.
    hopper::mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      {
        float s[KT / 2];
        hopper::mbar_wait(k_full, 0);
        issue_qk<DK, KT>(s, q_addr, k_addr);
        wgmma_wait<0>();
        fence_regs(s);
        if (lane == 0) hopper::mbar_arrive(k_empty);
        softmax_step<KT>(s, m, l, alpha, a, t_first * KT, q_lo, q_hi, t, qp0, qp1);  // O is zero: no rescale
        pack_p<KT>(p, s);
      }
      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % STAGES, sp = (i - 1) % STAGES;
        float s[KT / 2];
        hopper::mbar_wait(k_full + st, (i / STAGES) & 1);
        issue_qk<DK, KT>(s, q_addr, k_addr + st * L::kv_bytes);
        hopper::mbar_wait(v_full + sp, ((i - 1) / STAGES) & 1);
        issue_pv<D, KT>(o, p, v_addr + sp * L::kv_bytes);
        wgmma_wait<1>();  // Q K^T of tile i is done; P V of tile i - 1 may still run
        fence_regs(s);
        if (lane == 0) hopper::mbar_arrive(k_empty + st);
        softmax_step<KT>(s, m, l, alpha, a, (t_first + i) * KT, q_lo, q_hi, t, qp0, qp1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) hopper::mbar_arrive(v_empty + sp);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        pack_p<KT>(p, s);
      }
      const int last = n_tiles - 1, sl = last % STAGES;
      hopper::mbar_wait(v_full + sl, (last / STAGES) & 1);
      issue_pv<D, KT>(o, p, v_addr + sl * L::kv_bytes);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(v_empty + sl);
    }

    // O / l in bf16 over this warpgroup's Q rows, in the swizzled layout the TMA store reads
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-37f);
      // m is a raw score here: the natural LSE of the scaled scores is (m scale log2 e + log2 l) ln 2
      const int r = r0 + 8 * h;
      if (a.lse != nullptr && t == 0 && r < nq * a.G)
        a.lse[((long long)b * a.KV * a.G + kvh * a.G + r % a.G) * a.Sq + q0 + r / a.G] =
            (m[h] * a.scale_log2 + log2f(l[h])) * kLn2;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;  // r % 8 == g
        uint8_t* dst = qs + (j / 8) * kTmaRows * kSwizzleRow + r * kSwizzleRow + (((j % 8) ^ g) * 16) + t * 4;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int c = 0; c < kChunks; ++c)
        hopper::tma_store_4d(&o_map, qs + c * kTmaRows * kSwizzleRow, c * 64, kvh * a.G, q0, b);
      hopper::bulk_commit();
      hopper::bulk_wait_all();
    }
  }
}

template <int D, int DK = D>
int launch_tma(const Args& args, cudaStream_t stream) {
  constexpr int KT = TmaTile<D>::KT, STAGES = TmaTile<D>::STAGES;
  using L = TmaLayout<D, KT, STAGES>;
  const long long B = args.B, Sq = args.Sq, Sk = args.Sk, H = args.H, KV = args.KV;
  TmaArgs a;
  a.Sq = (int)Sq;
  a.Sk = (int)Sk;
  a.KV = (int)KV;
  a.G = (int)(H / KV);
  a.P = kTmaRows / a.G;
  a.n_qtiles = (int)((Sq + a.P - 1) / a.P);
  a.window = (int)args.window;
  a.q_offset = (int)args.q_offset;
  a.causal = args.causal;
  a.scale_log2 = args.scale * 1.4426950408889634f;
  a.lse = args.lse;
  if (a.n_qtiles > 65535 || B * KV > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  // First a runtime call: it makes the device's context current in this thread, which the
  // CUDA driver's tensor-map encoder needs (a thread that has made no runtime call, such as one
  // of autograd's, has none).
  auto kernel = flash_attention_tma_kernel<D, KT, STAGES, DK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (e != cudaSuccess) return (int)e;

  // the rows' real DK columns: a box's columns past DK are filled with zeros on loads and
  // clipped on the O store
  const cuuint64_t q_dims[4] = {(cuuint64_t)DK, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t q_strides[3] = {(cuuint64_t)DK * 2, (cuuint64_t)(H * DK * 2), (cuuint64_t)(Sq * H * DK * 2)};
  const cuuint32_t q_box[4] = {64, (cuuint32_t)a.G, (cuuint32_t)a.P, 1};
  const cuuint64_t k_dims[4] = {(cuuint64_t)DK, (cuuint64_t)KV, (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t k_strides[3] = {(cuuint64_t)DK * 2, (cuuint64_t)(KV * DK * 2), (cuuint64_t)(Sk * KV * DK * 2)};
  const cuuint32_t k_box[4] = {64, 1, (cuuint32_t)KT, 1};
  CUtensorMap q_map, k_map, v_map, o_map;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = hopper::encode_tiled(&q_map, bf16, 4, args.q, q_dims, q_strides, q_box, sw);
  if (!err) err = hopper::encode_tiled(&o_map, bf16, 4, args.o, q_dims, q_strides, q_box, sw);
  if (!err) err = hopper::encode_tiled(&k_map, bf16, 4, args.k, k_dims, k_strides, k_box, sw);
  if (!err) err = hopper::encode_tiled(&v_map, bf16, 4, args.v, k_dims, k_strides, k_box, sw);
  if (err) return err;

  const dim3 grid((unsigned int)(B * KV), (unsigned int)a.n_qtiles);
  kernel<<<grid, kTmaThreads, L::bytes, stream>>>(q_map, k_map, v_map, o_map, a);
  return (int)cudaGetLastError();
}

// D = 16 and 32 stay on mma.sync (their 32- and 64-byte rows would need swizzle modes of
// their own); the served head dims take the wgmma + TMA body, D = 112 in the D = 128 layout.
int launch_bf16(const Args& a, long long D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16, 64>(a, stream);
    case 32: return launch_mma<32, 64>(a, stream);
    case 64: return launch_tma<64>(a, stream);
    case kHeadDim112: return launch_tma<128, kHeadDim112>(a, stream);
    case 128: return launch_tma<128>(a, stream);
    case 256: return launch_tma<256>(a, stream);
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
    case kHeadDim112: return launch_fma<kHeadDim112, 64>(a, stream);
    case 128: return launch_fma<128, 64>(a, stream);
    case 256: return launch_fma<256, 32>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------------------
// Backward, bfloat16, D in {64, 112, 128}: four kernels on the forward's O and LSE
// ---------------------------------------------------------------------------------------
//
// Replaces no TPU kernel: the JAX package differentiates its plain reference, and so did
// this port until the backward below (its plain twin is ref.py::attention_backward).
//
// The gradient, per head, with P = exp(S scale - LSE) and S = Q K^T (masked entries 0):
//   D_i = rowsum(dO o O),  dV = P^T dO,  dS = P o (dO V^T - D),  dK = scale dS^T Q,  dQ = scale dS K.
// What bounds it on this card: bf16 tensor-core operations, 10 * D per visible (q, k) pair
// and head (the five products S, dP = dO V^T, dV, dK, dQ) at 989 TFLOP/s: 6.87e11 operations,
// 0.695 ms, at glm4-9b's train shape (B 2, S 4096, 32 heads on 2, D 128, causal).
//
//   * prep (a warp a row): D_i in float32 from the bf16 dO and O, and LSE * log2 e, into a
//     float32 workspace (B H, 2, Sq rounded up to 64); padded rows get LSE 1e30 (P = 0).
//   * dK / dV (attention_bwd_dkdv_kernel): a block per (batch, kv head, head group, 128-key
//     tile); its K and V tiles load once by TMA and stay; a producer warp streams the Q, dO
//     and (LSE, D) tiles of 64 positions of every head of the group over the queries that see
//     the keys (the forward's causal and window tests, turned around) through a ring of 3
//     stages.  Two consumer warpgroups own 64 keys each and keep dK and dV (64 x D float32)
//     in registers: S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared memory),
//     P^T in float32, dV += P^T dO with P^T rounded to bf16 as the register A operand and dO
//     as an MN-major B (the forward's P V), dS^T = P^T o (dP^T - D) in float32, dK += dS^T Q
//     the same way.  dP^T runs on the tensor cores while P^T is formed, dV while dS^T is; a
//     tile ends with its products done (no wgmma in flight across the loop, as in the forward).
//   * dQ (attention_bwd_dq_kernel): a second pass over the key tiles, in the forward's own
//     shape: a block per (batch, kv head, 128 rows = 128 / G positions x G heads), Q and dO
//     loaded once, K and V tiles of 64 keys through a ring of 3 stages; S = Q K^T and dP = dO
//     V^T, dS in float32, dQ += dS K with dS in bf16 registers and K as an MN-major B, the
//     previous tile's dQ product running while this tile's S and dP are formed.  dQ is
//     summed in float32 registers and stored once by TMA: no atomics, no float32 dQ
//     workspace, and the same bits on every run.  Chosen over FA2/FA3's float32 atomics into
//     a workspace because it reuses the forward's tiling and barriers and is deterministic;
//     it costs the three products S, dP and dQ again (7 * 2 D operations a pair where the
//     bound counts 10 * D).
//   * Filling 132 SMs: a block per (batch, kv head, key tile) would be 2 * 2 * 32 = 128
//     blocks at glm4-9b's train shape, of very unequal causal work.  The dK / dV grid splits
//     each kv head's G query heads into the fewest groups (a divisor of G) that give at
//     least three blocks an SM (G 16 -> 4 groups of 4 heads: 512 blocks), and walks key tiles
//     from the first, which under a causal mask see the most queries, so the light tiles fill
//     the tail.  Each group's dK / dV goes to a float32 partial; a last kernel sums the
//     groups in a fixed order and rounds to bf16 (with one group the block rounds and stores
//     itself).  The dQ grid is the forward's: 2 * 2 * 512 blocks of 128 rows, heaviest first.
//   * Precision: q, k, v, O and dO are bf16 as the forward saw them; P and dS are rounded to
//     bf16 only as tensor-core operands (the forward's P V makes the same rounding); every
//     softmax value, D, LSE and accumulator is float32; scale is applied to dK and dQ in
//     float32 before their one rounding to bf16.
//   * Masks: the forward's tests (causal, window, q_offset, Sk), P = 0 where masked; tiles
//     that every row sees in full skip the test.  A row that sees no key at all has no
//     gradient here: the wrapper sends such calls (a window with q_offset past the keys' end)
//     to the plain recompute.  D = 112 runs the D = 128 layout, as the forward does.

constexpr int kBwdKeys = 128;    // keys of a dK / dV block: two consumer warpgroups x 64
constexpr int kBwdQueries = 64;  // query positions of its q tiles
constexpr int kBwdStages = 3;    // q tiles in flight
constexpr int kDqKeys = 64;      // keys of a dQ block's kv tiles
constexpr int kDqStages = 3;     // kv tiles in flight
constexpr float kLsePad = 1e30f;  // log2-domain LSE of the padded query rows: P = 0 there

struct BwdArgs {
  int B, Sq, Sk, H, KV, G, Sq_pad, window, q_offset, causal;
  int n_groups, heads;        // groups of a kv head's query heads in the dK / dV grid, heads a group
  int n_ktiles;               // key tiles of the dK / dV grid
  int P, n_qtiles;            // positions a tile and q tiles of the dQ grid
  float scale, scale_log2;
  const __nv_bfloat16* o;     // (B, Sq, H, DK)
  const __nv_bfloat16* dout;  // (B, Sq, H, DK)
  const float* lse;           // (B, H, Sq), natural log
  float* stats;               // (B H, 2, Sq_pad): LSE log2 e, then D
  float* part;                // (2, n_groups, B, Sk, KV, DK) float32 when n_groups > 1
  __nv_bfloat16* dk;          // (B, Sk, KV, DK)
  __nv_bfloat16* dv;
};

// D_i and LSE log2 e of every row, a warp a row, rows in (b, h, q) order.
template <int DK>
__global__ void __launch_bounds__(256) attention_bwd_prep_kernel(const BwdArgs a) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.B * a.H * a.Sq_pad) return;
  const int q = (int)(row % a.Sq_pad);
  const long long bh = row / a.Sq_pad;
  const long long b = bh / a.H, h = bh % a.H;
  float* st = a.stats + bh * 2 * a.Sq_pad;
  if (q >= a.Sq) {
    if (lane == 0) {
      st[q] = kLsePad;
      st[a.Sq_pad + q] = 0.f;
    }
    return;
  }
  const long long off = ((b * a.Sq + q) * a.H + h) * DK;
  float sum = 0.f;
  for (int d = 2 * lane; d < DK; d += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.dout + off + d));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.o + off + d));
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) {
    st[q] = a.lse[bh * a.Sq + q] * 1.4426950408889634f;
    st[a.Sq_pad + q] = sum;
  }
}

// Shared memory of a dK / dV block: K and V (D / 64 column chunks of [128][64] bf16), then
// per stage a Q and a dO tile ([64][64] chunks) and the tile's [2][64] floats of LSE and D.
template <int D>
struct DkdvLayout {
  static constexpr int kv_bytes = kBwdKeys * D * 2;
  static constexpr int q_bytes = kBwdQueries * D * 2;
  static constexpr int st_bytes = 2 * kBwdQueries * 4;
  static constexpr int k_off = 0;
  static constexpr int v_off = kv_bytes;
  static constexpr int q_off = 2 * kv_bytes;
  static constexpr int do_off = q_off + kBwdStages * q_bytes;
  static constexpr int st_off = do_off + kBwdStages * q_bytes;
  static constexpr int bar_off = st_off + kBwdStages * st_bytes;
  static constexpr int n_bars = 1 + 2 * kBwdStages;  // K / V full; per stage full and empty
  static constexpr int bytes = bar_off + 8 * n_bars + 1024;
};

template <int D, int DK>
__global__ void __launch_bounds__(kTmaThreads, 1)
    attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap st_map, const BwdArgs a) {
  using L = DkdvLayout<D>;
  constexpr int kChunks = D / 64;
  constexpr int NQ = kBwdQueries;
  static_assert(D % 64 == 0 && DK % 16 == 0 && DK <= D && DK > D - 64, "head dim");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem + L::k_off;
  uint8_t* vs = smem + L::v_off;
  uint8_t* qs = smem + L::q_off;
  uint8_t* dos = smem + L::do_off;
  float* sts = reinterpret_cast<float*>(smem + L::st_off);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kBwdStages;

  const int grp = (int)blockIdx.x % a.n_groups;
  const int kvh = ((int)blockIdx.x / a.n_groups) % a.KV;
  const int b = (int)blockIdx.x / (a.n_groups * a.KV);
  const int k0 = (int)blockIdx.y * kBwdKeys;  // key tiles from the first: the most queries under a causal mask
  const int k_last = min(k0 + kBwdKeys, a.Sk) - 1;
  // the query rows that see some key of the tile
  int q_begin = 0, q_end = a.Sq;
  if (a.causal) q_begin = max(0, k0 - a.q_offset);
  if (a.window) q_end = min(q_end, k_last + a.window - a.q_offset);
  const int qt_first = q_begin / NQ;
  const int n_qt = q_end > q_begin ? (q_end - 1) / NQ - qt_first + 1 : 0;
  const int n_iter = n_qt * a.heads;
  const int h_first = kvh * a.G + grp * a.heads;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * L::kv_bytes);
      for (int c = 0; c < kChunks; ++c) {
        hopper::tma_load_4d(ks + c * kBwdKeys * kSwizzleRow, &k_map, kv_full, c * 64, kvh, k0, b);
        hopper::tma_load_4d(vs + c * kBwdKeys * kSwizzleRow, &v_map, kv_full, c * 64, kvh, k0, b);
      }
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % kBwdStages;
        const int h = h_first + i / n_qt, q0 = (qt_first + i % n_qt) * NQ;
        hopper::mbar_wait(empty + s, ((i / kBwdStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full + s, 2 * L::q_bytes + L::st_bytes);
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(qs + s * L::q_bytes + c * NQ * kSwizzleRow, &q_map, full + s, c * 64, h, q0, b);
          hopper::tma_load_4d(dos + s * L::q_bytes + c * NQ * kSwizzleRow, &do_map, full + s, c * 64, h, q0, b);
        }
        hopper::tma_load_3d(sts + s * 2 * NQ, &st_map, full + s, q0, 0, b * a.H + h);
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int kc0 = k0 + cw * 64;            // this warpgroup's first key
    const int kp0 = kc0 + warp * 16 + g;     // this thread's keys: kp0 and kp0 + 8
    const uint32_t k_addr = hopper::smem_u32(ks) + cw * 64 * kSwizzleRow;
    const uint32_t v_addr = hopper::smem_u32(vs) + cw * 64 * kSwizzleRow;
    const uint32_t q_base = hopper::smem_u32(qs), do_base = hopper::smem_u32(dos);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    uint32_t pp[NQ / 4], dsp[NQ / 4];

    hopper::mbar_wait(kv_full, 0);
    for (int i = 0; i < n_iter; ++i) {
      const int st = i % kBwdStages;
      const int q0 = (qt_first + i % n_qt) * NQ;
      const uint32_t q_addr = q_base + st * L::q_bytes, do_addr = do_base + st * L::q_bytes;
      const float* lse2 = sts + st * 2 * NQ;
      const float* dd = lse2 + NQ;
      float s[NQ / 2], dp[NQ / 2];
      hopper::mbar_wait(full + st, (i / kBwdStages) & 1);
      issue_qk<DK, NQ>(s, k_addr, q_addr);    // S^T = K Q^T
      issue_qk<DK, NQ>(dp, v_addr, do_addr);  // dP^T = V dO^T
      wgmma_wait<1>();                        // S^T done
      fence_regs(s);

      // P^T = exp2(S^T scale log2 e - LSE log2 e), 0 where masked
      const bool full_tile = kc0 + 64 <= a.Sk && (!a.causal || kc0 + 63 <= q0 + a.q_offset) &&
                             (!a.window || kc0 > q0 + NQ - 1 + a.q_offset - a.window);
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          float x = ex2(fmaf(s[4 * j + e], a.scale_log2, -((e & 1) ? lj.y : lj.x)));
          if (!full_tile) {
            const int kp = kp0 + (e >> 1) * 8, qp = q0 + col + a.q_offset;
            bool visible = kp < a.Sk;
            if (a.causal) visible = visible && kp <= qp;
            if (a.window) visible = visible && kp > qp - a.window;
            if (!visible) x = 0.f;
          }
          s[4 * j + e] = x;
        }
      }
      pack_p<NQ>(pp, s);
      issue_pv<D, NQ>(dv, pp, do_addr);  // dV += P^T dO
      wgmma_wait<1>();                   // dP^T done
      fence_regs(dp);
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const float2 dj = *reinterpret_cast<const float2*>(dd + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dj.y : dj.x));
      }
      pack_p<NQ>(dsp, dp);
      issue_pv<D, NQ>(dk, dsp, q_addr);  // dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pp);
      fence_regs(dsp);
      if (lane == 0) hopper::mbar_arrive(empty + st);
    }

    // this thread's keys kp0 and kp0 + 8, columns 8 j + 2 t (+1)
    const long long n = (long long)a.B * a.Sk * a.KV * DK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kp = kp0 + 8 * h;
      if (kp >= a.Sk) continue;
      const long long row = (((long long)b * a.Sk + kp) * a.KV + kvh) * DK;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= DK) continue;
        const float2 xk = make_float2(dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
        const float2 xv = make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
        if (a.n_groups == 1) {
          *reinterpret_cast<__nv_bfloat162*>(a.dk + row + col) = __floats2bfloat162_rn(xk.x, xk.y);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + row + col) = __floats2bfloat162_rn(xv.x, xv.y);
        } else {
          *reinterpret_cast<float2*>(a.part + grp * n + row + col) = xk;
          *reinterpret_cast<float2*>(a.part + (a.n_groups + grp) * n + row + col) = xv;
        }
      }
    }
  }
}

// dK and dV from the groups' float32 partials: summed in group order, rounded to bf16; four
// elements a thread, blockIdx.y 0 for dK and 1 for dV.
__global__ void __launch_bounds__(256) attention_bwd_sum_kernel(const BwdArgs a, long long n) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float* src = a.part + blockIdx.y * a.n_groups * n + i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int g = 1; g < a.n_groups; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + g * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat16* dst = (blockIdx.y ? a.dv : a.dk) + i;
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(acc.x, acc.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

// Shared memory of a dQ block: Q (then dQ) and dO ([128][64] chunks), then per stage a K
// and a V tile ([64][64] chunks).
template <int D>
struct DqLayout {
  static constexpr int q_bytes = kTmaRows * D * 2;
  static constexpr int kv_bytes = kDqKeys * D * 2;
  static constexpr int q_off = 0;
  static constexpr int do_off = q_bytes;
  static constexpr int k_off = 2 * q_bytes;
  static constexpr int v_off = k_off + kDqStages * kv_bytes;
  static constexpr int bar_off = v_off + kDqStages * kv_bytes;
  static constexpr int n_bars = 1 + 4 * kDqStages;  // Q and dO full; K / V full and empty per stage
  static constexpr int bytes = bar_off + 8 * n_bars + 1024;
};

template <int D, int DK>
__global__ void __launch_bounds__(kTmaThreads, 1)
    attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                            const __grid_constant__ CUtensorMap dq_map, const BwdArgs a) {
  using L = DqLayout<D>;
  constexpr int kChunks = D / 64;
  constexpr int KT = kDqKeys;
  static_assert(D % 64 == 0 && DK % 16 == 0 && DK <= D && DK > D - 64, "head dim");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem + L::q_off;  // Q, then dQ
  uint8_t* dos = smem + L::do_off;
  uint8_t* ks = smem + L::k_off;
  uint8_t* vs = smem + L::v_off;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kDqStages;
  uint64_t* k_empty = v_full + kDqStages;
  uint64_t* v_empty = k_empty + kDqStages;

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int qt = a.causal ? a.n_qtiles - 1 - (int)blockIdx.y : (int)blockIdx.y;  // heaviest first
  const int q0 = qt * a.P;
  const int nq = min(a.P, a.Sq - q0);
  const int q_lo = q0 + a.q_offset, q_hi = q0 + nq - 1 + a.q_offset;
  int k_begin = 0, k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  if (a.window) k_begin = max(k_begin, q_lo - a.window + 1);
  const int t_first = k_begin / KT;
  const int n_tiles = max(0, (k_end + KT - 1) / KT - t_first);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(k_empty + s, 8);
      hopper::mbar_init(v_empty + s, 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_full, 2 * kChunks * a.G * a.P * kSwizzleRow);
      for (int c = 0; c < kChunks; ++c) {
        hopper::tma_load_4d(qs + c * kTmaRows * kSwizzleRow, &q_map, q_full, c * 64, kvh * a.G, q0, b);
        hopper::tma_load_4d(dos + c * kTmaRows * kSwizzleRow, &do_map, q_full, c * 64, kvh * a.G, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kDqStages;
        const uint32_t ph = (i / kDqStages) & 1;
        const int k0 = (t_first + i) * KT;
        hopper::mbar_wait(k_empty + s, ph ^ 1);
        hopper::mbar_expect_tx(k_full + s, L::kv_bytes);
        for (int c = 0; c < kChunks; ++c)
          hopper::tma_load_4d(ks + s * L::kv_bytes + c * KT * kSwizzleRow, &k_map, k_full + s, c * 64, kvh, k0, b);
        hopper::mbar_wait(v_empty + s, ph ^ 1);
        hopper::mbar_expect_tx(v_full + s, L::kv_bytes);
        for (int c = 0; c < kChunks; ++c)
          hopper::tma_load_4d(vs + s * L::kv_bytes + c * KT * kSwizzleRow, &v_map, v_full + s, c * 64, kvh, k0, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = cw * 64 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    const int qp0 = q0 + r0 / a.G + a.q_offset, qp1 = q0 + (r0 + 8) / a.G + a.q_offset;
    float lse2[2], dd[2];  // the rows' LSE log2 e and D (padding rows: P = 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      lse2[h] = kLsePad;
      dd[h] = 0.f;
      if (r < nq * a.G) {
        const float* st = a.stats + ((long long)b * a.H + kvh * a.G + r % a.G) * 2 * a.Sq_pad + q0 + r / a.G;
        lse2[h] = st[0];
        dd[h] = st[a.Sq_pad];
      }
    }
    const uint32_t q_addr = hopper::smem_u32(qs) + cw * 64 * kSwizzleRow;
    const uint32_t do_addr = hopper::smem_u32(dos) + cw * 64 * kSwizzleRow;
    const uint32_t k_addr = hopper::smem_u32(ks), v_addr = hopper::smem_u32(vs);

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    uint32_t dsp[KT / 4];

    // P = exp2(S scale log2 e - LSE log2 e) of the tile at k0, 0 where masked
    const auto probs = [&](float(&p)[KT / 2], int k0) {
      const bool full_tile =
          k0 + KT <= a.Sk && (!a.causal || k0 + KT - 1 <= q_lo) && (!a.window || k0 > q_hi - a.window);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = ex2(fmaf(p[4 * j + e], a.scale_log2, -lse2[e >> 1]));
          if (!full_tile) {
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            bool visible = kp < a.Sk;
            if (a.causal) visible = visible && kp <= qp;
            if (a.window) visible = visible && kp > qp - a.window;
            if (!visible) x = 0.f;
          }
          p[4 * j + e] = x;
        }
      }
    };
    // dS = P (dP - D), in dP's registers
    const auto dscores = [&](float(&dp)[KT / 2], const float(&p)[KT / 2]) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - dd[e >> 1]);
      }
    };

    hopper::mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      {
        float s[KT / 2], dp[KT / 2];
        hopper::mbar_wait(k_full, 0);
        issue_qk<DK, KT>(s, q_addr, k_addr);  // S = Q K^T
        hopper::mbar_wait(v_full, 0);
        issue_qk<DK, KT>(dp, do_addr, v_addr);  // dP = dO V^T
        wgmma_wait<1>();
        fence_regs(s);
        probs(s, t_first * KT);
        wgmma_wait<0>();
        fence_regs(dp);
        if (lane == 0) hopper::mbar_arrive(v_empty);
        dscores(dp, s);
        pack_p<KT>(dsp, dp);
      }
      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % kDqStages, sp = (i - 1) % kDqStages;
        const uint32_t ph = (i / kDqStages) & 1;
        float s[KT / 2], dp[KT / 2];
        hopper::mbar_wait(k_full + st, ph);
        issue_qk<DK, KT>(s, q_addr, k_addr + st * L::kv_bytes);
        hopper::mbar_wait(v_full + st, ph);
        issue_qk<DK, KT>(dp, do_addr, v_addr + st * L::kv_bytes);
        issue_pv<D, KT>(dq, dsp, k_addr + sp * L::kv_bytes);  // dQ += dS K of the previous tile
        wgmma_wait<2>();                                       // S done
        fence_regs(s);
        probs(s, (t_first + i) * KT);
        wgmma_wait<1>();  // dP done
        fence_regs(dp);
        if (lane == 0) hopper::mbar_arrive(v_empty + st);
        dscores(dp, s);
        wgmma_wait<0>();  // the previous tile's dQ product
        fence_regs(dq);
        fence_regs(dsp);
        if (lane == 0) hopper::mbar_arrive(k_empty + sp);
        pack_p<KT>(dsp, dp);
      }
      const int sl = (n_tiles - 1) % kDqStages;
      issue_pv<D, KT>(dq, dsp, k_addr + sl * L::kv_bytes);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dsp);
    }

    // dQ scale in bf16 over this warpgroup's Q rows, in the swizzled layout the TMA store reads
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        uint8_t* dst = qs + (j / 8) * kTmaRows * kSwizzleRow + r * kSwizzleRow + (((j % 8) ^ g) * 16) + t * 4;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(dq[4 * j + 2 * h] * a.scale, dq[4 * j + 2 * h + 1] * a.scale);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int c = 0; c < kChunks; ++c)
        hopper::tma_store_4d(&dq_map, qs + c * kTmaRows * kSwizzleRow, c * 64, kvh * a.G, q0, b);
      hopper::bulk_commit();
      hopper::bulk_wait_all();
    }
  }
}

template <int D, int DK>
int launch_backward(BwdArgs a, const void* q, const void* k, const void* v, void* dq, cudaStream_t stream) {
  // runtime calls first: they make the context current for the tensor-map encoder (launch_tma)
  auto dkdv = attention_bwd_dkdv_kernel<D, DK>;
  auto dqk = attention_bwd_dq_kernel<D, DK>;
  cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, DkdvLayout<D>::bytes);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, DqLayout<D>::bytes);
  if (e != cudaSuccess) return (int)e;
  const long long B = a.B, Sq = a.Sq, Sk = a.Sk, H = a.H, KV = a.KV;
  const cuuint64_t q_dims[4] = {(cuuint64_t)DK, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t q_strides[3] = {(cuuint64_t)DK * 2, (cuuint64_t)(H * DK * 2), (cuuint64_t)(Sq * H * DK * 2)};
  const cuuint64_t k_dims[4] = {(cuuint64_t)DK, (cuuint64_t)KV, (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t k_strides[3] = {(cuuint64_t)DK * 2, (cuuint64_t)(KV * DK * 2), (cuuint64_t)(Sk * KV * DK * 2)};
  const cuuint64_t st_dims[3] = {(cuuint64_t)a.Sq_pad, 2, (cuuint64_t)(B * H)};
  const cuuint64_t st_strides[2] = {(cuuint64_t)a.Sq_pad * 4, (cuuint64_t)a.Sq_pad * 8};
  const cuuint32_t head_box[4] = {64, 1, (cuuint32_t)kBwdQueries, 1};  // one head's 64 positions
  const cuuint32_t group_box[4] = {64, (cuuint32_t)a.G, (cuuint32_t)a.P, 1};  // the forward's q tile
  const cuuint32_t key_box[4] = {64, 1, (cuuint32_t)kBwdKeys, 1};
  const cuuint32_t dq_key_box[4] = {64, 1, (cuuint32_t)kDqKeys, 1};
  const cuuint32_t st_box[3] = {(cuuint32_t)kBwdQueries, 2, 1};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap q1, do1, k1, v1, st, qg, dog, dqg, k2, v2;
  int err = hopper::encode_tiled(&q1, bf16, 4, q, q_dims, q_strides, head_box, sw);
  if (!err) err = hopper::encode_tiled(&do1, bf16, 4, a.dout, q_dims, q_strides, head_box, sw);
  if (!err) err = hopper::encode_tiled(&k1, bf16, 4, k, k_dims, k_strides, key_box, sw);
  if (!err) err = hopper::encode_tiled(&v1, bf16, 4, v, k_dims, k_strides, key_box, sw);
  if (!err)
    err = hopper::encode_tiled(&st, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a.stats, st_dims, st_strides, st_box,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err) err = hopper::encode_tiled(&qg, bf16, 4, q, q_dims, q_strides, group_box, sw);
  if (!err) err = hopper::encode_tiled(&dog, bf16, 4, a.dout, q_dims, q_strides, group_box, sw);
  if (!err) err = hopper::encode_tiled(&dqg, bf16, 4, dq, q_dims, q_strides, group_box, sw);
  if (!err) err = hopper::encode_tiled(&k2, bf16, 4, k, k_dims, k_strides, dq_key_box, sw);
  if (!err) err = hopper::encode_tiled(&v2, bf16, 4, v, k_dims, k_strides, dq_key_box, sw);
  if (err) return err;

  const long long rows = B * H * a.Sq_pad;
  attention_bwd_prep_kernel<DK><<<(unsigned int)((rows + 7) / 8), 256, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  dkdv<<<dim3((unsigned int)(B * KV * a.n_groups), (unsigned int)a.n_ktiles), kTmaThreads, DkdvLayout<D>::bytes,
         stream>>>(q1, k1, v1, do1, st, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (a.n_groups > 1) {
    const long long n = B * Sk * KV * DK;
    attention_bwd_sum_kernel<<<dim3((unsigned int)((n / 4 + 255) / 256), 2), 256, 0, stream>>>(a, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  dqk<<<dim3((unsigned int)(B * KV), (unsigned int)a.n_qtiles), kTmaThreads, DqLayout<D>::bytes, stream>>>(
      qg, k2, v2, dog, dqg, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the attention on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v, o are contiguous device pointers of the shapes above; dtype 0 is float32, 1 is
// bfloat16 (o has q's dtype).  lse, when not null, receives each row's log-sum-exp (B, H, Sq)
// in float32 for the backward kernel; with null nothing more is written.  The caller checks shapes, dtypes, D in {16, 32, 64, 112, 128, 256},
// 1 <= G = H / KV <= 64, that q, k, v, o start on 16-byte boundaries (TMA's alignment) and
// that the positions fit in 32-bit TMA coordinates.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, float* lse, long long B,
                                      long long Sq, long long Sk, long long H, long long KV, long long D,
                                      long long causal, long long window, long long q_offset, long long dtype,
                                      float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || B <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
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

// Launches the backward on `stream` (prep, dK / dV, the groups' sum when n_groups > 1, dQ) and
// returns cudaGetLastError() (0 on success).  bfloat16 q, k, v, o, dout, dq, dk, dv of the
// forward's shapes; lse (B, H, Sq) float32 as the forward wrote it; stats a float32
// workspace of (B H, 2, Sq rounded up to 64); part a float32 workspace of (2, n_groups, B,
// Sk, KV, D) when n_groups > 1 (else unused).  The caller checks what flash_attention_launch's
// caller checks, D in {64, 112, 128}, that n_groups divides G, and that every query row sees
// a key.
extern "C" int flash_attention_backward_launch(const void* q, const void* k, const void* v, const void* o,
                                               const float* lse, const void* dout, void* dq, void* dk, void* dv,
                                               float* stats, float* part, long long B, long long Sq, long long Sk,
                                               long long H, long long KV, long long D, long long causal,
                                               long long window, long long q_offset, long long n_groups, float scale,
                                               void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || B <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (n_groups < 1 || (H / KV) % n_groups != 0 || (n_groups > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.B = (int)B;
  a.Sq = (int)Sq;
  a.Sk = (int)Sk;
  a.H = (int)H;
  a.KV = (int)KV;
  a.G = (int)(H / KV);
  a.Sq_pad = (int)((Sq + kBwdQueries - 1) / kBwdQueries * kBwdQueries);
  a.window = (int)window;
  a.q_offset = (int)q_offset;
  a.causal = causal ? 1 : 0;
  a.n_groups = (int)n_groups;
  a.heads = a.G / a.n_groups;
  a.n_ktiles = (int)((Sk + kBwdKeys - 1) / kBwdKeys);
  a.P = kTmaRows / a.G;
  a.n_qtiles = (int)((Sq + a.P - 1) / a.P);
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = lse;
  a.stats = stats;
  a.part = part;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  if (a.n_qtiles > 65535 || a.n_ktiles > 65535 || B * KV * n_groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_backward<64, 64>(a, q, k, v, dq, s);
    case kHeadDim112: return launch_backward<128, kHeadDim112>(a, q, k, v, dq, s);
    case 128: return launch_backward<128, 128>(a, q, k, v, dq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
