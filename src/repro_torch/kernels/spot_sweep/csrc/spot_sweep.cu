// The fused (type x bid x seed) spot sweep of the paper's §VII study, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/spot_sweep/kernel.py::sweep_pallas (body _sweep_kernel), the
// Pallas TPU kernel that carries every bid-limited checkpointing scheme (NONE, OPT, HOUR,
// EDGE, ADAPT) through the padded (cells x periods) availability grid.
//
// What bounds it on this card: the dependent chain of its longest walk, not bandwidth.
// A (scheme, cell) is a serial walk -- each period, HOUR / EDGE checkpoint window and ADAPT
// decision tick starts from the state the one before left -- and at full width (5 schemes x
// 10,496 cells, 219 periods) the sweep is one wave of threads, so the kernel lasts as long
// as its slowest warp: ~400 iterations of ADAPT, each a few dependent float64 operations,
// three IEEE divisions and two survival-table gathers.  The bytes it must move (~115 MB of
// run records) take ~40 us at full bandwidth.  The design keeps device memory off each
// walk's chain:
//
// * One block runs one scheme (a template parameter, dispatched on blockIdx): each
//   scheme's cells are padded to whole blocks, and the long walks (ADAPT, HOUR, EDGE) come
//   first in block order.  A warp never straddles two schemes whatever C is.
// * Run records leave the walk.  A walk stores nothing per period but one bit a period
//   that has a record (a word per 32 periods, into scratch); after the block's walks its
//   threads write all of its rows' records, 32 consecutive periods a warp instruction:
//   rec_exists from the bits up to the completing period, rec_end = B (the completion
//   time at the completing period), rec_user at the completing period only.  A walk
//   leaves its loop at completion, so the periods after it cost it nothing.
// * Period inputs come a period ahead.  A, B, valid (and ptr0 for EDGE) of the next period
//   are loaded into registers when a period is taken, and the lines kAhead periods on are
//   prefetched into L1.
// * ADAPT keeps the cell's table offset and top in registers, reuses the last tick's
//   second gathered value when this tick's first bin is the same entry, and prefetches
//   the lines the next tick can reach (after a checkpoint or not) while it decides.
// * An iteration that takes a period with work also takes its first window / tick.
//
// One thread per (scheme, cell) with a flat per-thread (period, step) cursor: an
// iteration takes one period or one window / tick, so the lanes of a warp stay on the
// same iteration and a warp's loop count is its busiest lane's periods plus steps.
//
// Exactness: every expression keeps the association order of the plain version
// (repro_torch/engine/kernels.py) -- work + (s - t), t + (work_s - work), a + k*delta - t_c --
// and uses only IEEE-rounded float64 + - * / and compares.  The library is built with
// --fmad=false, so no multiply-add is contracted into an FMA.  Minimum and clip are written
// as compares that propagate NaN as np.minimum / np.clip do (CUDA's fmin/fmax drop a NaN).
// Age bins are a true IEEE division truncated toward zero, and table gathers use 64-bit
// indices.  Results are bit-identical to the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kEps = 1e-9;  // core/simulator.py _EPS
constexpr int kThreads = 128;  // cells a block (one scheme)
constexpr int kMaxSchemes = 5;
constexpr long long kAhead = 8;  // periods between a line's prefetch into L1 and its use
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 16;      // items of 32 records a warp has in flight in the record pass
enum SchemeCode : int { kNone = 0, kOpt = 1, kHour = 2, kEdge = 3, kAdapt = 4 };

struct Params {
  long long S, C, P;
  int codes[kMaxSchemes];  // scheme code of each output slot
  int order[kMaxSchemes];  // output slots in block order, longest chains first
  long long cell_blocks;   // blocks a scheme: ceil(C / kThreads)
  const double* A;         // (C, P) period starts, NaN pad
  const double* B;         // (C, P) period ends, NaN pad
  const bool* valid;       // (C, P)
  const double* horizon;   // (C,)
  const long long* ptr0;        // (C, P) first rising edge after A + t_r (EDGE)
  const double* edges_flat;     // (E,) rising-edge times of every market (EDGE)
  const long long* edge_base;   // (C,)
  const long long* edge_n;      // (C,)
  const double* tab_flat;       // (T,) compact survival tables (ADAPT)
  const long long* tab_off;     // (C,)
  const long long* tab_top;     // (C,)
  double init_saved, work_s, t_c, t_r, hour_delta, interval, bin_s;
  long long n_bins;
  bool* done;             // (S, C)
  double* comp_time;      // (S, C)
  long long* n_ckpt;      // (S, C)
  double* work_lost;      // (S, C)
  long long* n_kills;     // (S, C)
  bool* rec_exists;       // (S, C, P)
  double* rec_end;        // (S, C, P)
  bool* rec_user;         // (S, C, P)
  unsigned* rec_bits;     // (S, C, words) scratch: which periods have a record
  long long words;        // ceil(P / 32)
};

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// np.minimum / np.maximum: a NaN in either operand gives NaN.
__device__ __forceinline__ double np_min(double x, double y) { return (x <= y || x != x) ? x : y; }
__device__ __forceinline__ double np_max(double x, double y) { return (x >= y || x != x) ? x : y; }

// One scheme's outcome of one period (engine/kernels.py scheme-kernel tuple).
struct PeriodOut {
  bool done_now;
  double done_at;
  double work_end;
  double saved_out;
  long long ckpt_add;
};

__device__ __forceinline__ PeriodOut none_period(const Params& q, double b, double start_work, double saved) {
  PeriodOut o;
  const double lhs = saved + (b - start_work);
  o.done_now = lhs >= (q.work_s - kEps);
  o.done_at = start_work + (q.work_s - saved);
  o.work_end = lhs;
  o.saved_out = saved;
  o.ckpt_add = 0;
  return o;
}

__device__ __forceinline__ PeriodOut opt_period(const Params& q, double b, double start_work, double saved) {
  const double work_lim = q.work_s - kEps;
  const double remaining = q.work_s - saved;
  const double completes_at = start_work + remaining;
  const bool oracle = completes_at <= (b + kEps);
  const double s = b - q.t_c;
  const bool has_s = !oracle && (s > start_work);

  const double lhsB = saved + (b - start_work);
  const bool doneB = lhsB >= work_lim;
  const double done_atB = start_work + (q.work_s - saved);

  const double w_at_s = saved + (s - start_work);
  const bool doneA1 = w_at_s >= work_lim;
  const double done_atA1 = start_work + (q.work_s - saved);
  const bool ckpt_ok = (s + q.t_c) <= (b + kEps);
  const double work1 = w_at_s;
  const double saved1 = ckpt_ok ? work1 : saved;
  const double t1 = s + q.t_c;
  const bool ended = t1 >= b;
  const double lhsA2 = work1 + (b - t1);
  const bool doneA2 = !ended && (lhsA2 >= work_lim);
  const double done_atA2 = t1 + (q.work_s - work1);
  const double work_endA = ended ? work1 : lhsA2;

  PeriodOut o;
  o.done_now = has_s ? (doneA1 || doneA2) : doneB;
  o.done_at = has_s ? (doneA1 ? done_atA1 : done_atA2) : done_atB;
  o.work_end = has_s ? work_endA : lhsB;
  o.saved_out = (has_s && !doneA1) ? saved1 : saved;
  o.ckpt_add = (has_s && !doneA1 && ckpt_ok) ? 1 : 0;
  return o;
}

// A walking scheme's state inside one period: HOUR / EDGE checkpoint windows, ADAPT
// decision ticks.  `cursor` is HOUR's window index k or EDGE's edge cursor; `s_edge` the
// rising edge at EDGE's cursor; `k_prev` / `s_prev` ADAPT's last gathered table entry and
// its value.
struct Walk {
  double t, work, sv, next_dec, done_at, s_edge, s_prev;
  long long cursor, ckpt_add, k_prev;
  bool done_now;
};

// Per-cell inputs of the walking schemes, loaded once a cell.
struct CellIn {
  const double* edges;  // EDGE: the cell's market's rising edges
  long long n_edges;
  const double* tab;    // ADAPT: the cell's survival table
  long long top;
  long long k_step, k_step_ckpt;  // ADAPT: bins a tick spans without / with a checkpoint
};

// One HOUR (window k starts at a + k*delta - t_c) or EDGE (windows start at the rising
// edges from ptr0 on) window: engine/kernels.py windows_advance.  Returns true when the
// period's walk has ended; the tail segment (work to b, maybe completing) is then applied.
template <int kScheme>
__device__ __forceinline__ bool window_step(const Params& q, const CellIn& cell, double a, double b,
                                            double start_work, Walk& w) {
  const double work_lim = q.work_s - kEps;
  double s;
  bool no_more, window;
  if (kScheme == kHour) {
    s = a + (double)w.cursor * q.hour_delta - q.t_c;
    no_more = !(s < b);
    window = (s < b) && (s > start_work);  // windows before recovery ends are skipped
  } else {
    const bool have = w.cursor < cell.n_edges;
    s = w.s_edge;  // INFINITY past the last edge
    no_more = !have || !(s < b);
    window = have && (s < b);
  }
  bool ended = no_more;
  if (window) {
    const double w_at = w.work + (s - w.t);
    if (w_at >= work_lim) {
      w.done_now = true;
      w.done_at = w.t + (q.work_s - w.work);
      ended = true;
      window = false;
    } else {
      w.work = w_at;
      if ((s + q.t_c) <= (b + kEps)) {
        w.sv = w.work;
        ++w.ckpt_add;
      }
      w.t = s + q.t_c;
      if (w.t >= b) ended = true;  // billed out inside the checkpoint
    }
  }
  if (kScheme == kHour) {
    ++w.cursor;
  } else if (window) {
    ++w.cursor;  // only consumed edges advance
    w.s_edge = w.cursor < cell.n_edges ? cell.edges[w.cursor] : INFINITY;
  }
  if (no_more) {  // tail segment: work to b, maybe completing
    const double lhs = w.work + (b - w.t);
    if (lhs >= work_lim) {
      w.done_now = true;
      w.done_at = w.t + (q.work_s - w.work);
    }
    w.work = lhs;  // work_end
  }
  return ended;
}

// The table entry of hazard bin k, and of the bin of `age` (engine/kernels.py
// adapt_decision: an IEEE division truncated toward zero, then the clamp to the table's
// top).
__device__ __forceinline__ long long clamp_entry(const Params& q, long long top, long long k) {
  return k >= q.n_bins ? top + 1 : (k <= top ? k : top);
}
__device__ __forceinline__ long long bin_entry(const Params& q, long long top, double age) {
  return clamp_entry(q, top, (long long)(age / q.bin_s));
}

// One ADAPT decision tick (engine/kernels.py adapt_tick_core; the decision is
// adapt_decision: checkpoint iff hazard * (unsaved + t_r) > t_c).  Returns true when the
// period's walk has ended (completion or kill).
__device__ __forceinline__ bool adapt_step(const Params& q, const CellIn& cell, double a, double b, Walk& w) {
  const double seg_end = np_min(w.next_dec, b);
  if (w.work + (seg_end - w.t) >= q.work_s - kEps) {
    w.done_now = true;
    w.done_at = w.t + (q.work_s - w.work);
    return true;
  }
  w.work = w.work + (seg_end - w.t);
  w.t = seg_end;
  if (w.t >= b) return true;  // killed at b with no decision left
  const double age = w.t - a;
  const long long k1 = bin_entry(q, cell.top, age);
  const long long k2 = bin_entry(q, cell.top, age + q.interval);
  const double s_later = cell.tab[k2];
  // a tick whose first entry is the last tick's second reuses its value (same entry)
  const double s_now = k1 == w.k_prev ? w.s_prev : cell.tab[k1];
  // the next tick's entries lie from k2 on, up to one interval and one checkpoint further
  prefetch_l1(cell.tab + clamp_entry(q, cell.top, k2 + cell.k_step));
  prefetch_l1(cell.tab + clamp_entry(q, cell.top, k2 + cell.k_step_ckpt));
  w.k_prev = k2;
  w.s_prev = s_later;
  double h = 1.0;
  if (!(s_now <= 0.0)) h = np_min(np_max((s_now - s_later) / s_now, 0.0), 1.0);
  if ((h * ((w.work - w.sv) + q.t_r)) > q.t_c) {
    if ((w.t + q.t_c) <= (b + kEps)) {
      w.sv = w.work;
      ++w.ckpt_add;
    }
    w.t = np_min(w.t + q.t_c, b);
    if (w.t >= b) return true;  // killed while checkpointing
  }
  w.next_dec = w.t + q.interval;
  return false;
}

struct PeriodIn {
  double a, b;
  long long ptr;
  bool v;
};

// A thread's period cursor over its cell's row: take(p) returns period p's inputs, which
// were loaded into registers when period p - 1 was taken, loads period p + 1's, and
// prefetches the lines kAhead periods on into L1.  Periods are taken in order, each once,
// after load(0).
template <int kScheme>
struct PeriodStream {
  const double* A;
  const double* B;
  const bool* V;
  const long long* PTR;
  long long P;
  PeriodIn next;

  __device__ __forceinline__ void load(long long p) {
    if (p < P) {
      next.v = V[p];
      next.a = A[p];
      next.b = B[p];
      if (kScheme == kEdge) next.ptr = PTR[p];
    }
  }

  __device__ __forceinline__ PeriodIn take(long long p) {
    const PeriodIn in = next;
    load(p + 1);
    if (p + kAhead < P) {
      prefetch_l1(A + p + kAhead);
      prefetch_l1(B + p + kAhead);
      prefetch_l1(V + p + kAhead);
      if (kScheme == kEdge) prefetch_l1(PTR + p + kAhead);
    }
    return in;
  }
};

// The periods of a row that have a run record, as bits: word w of a row holds periods
// 32w .. 32w + 31.  The walk takes the periods in order and stores each word when it takes
// the first period past it (and the last word when it stops), so every word up to where
// the walk stopped is written.
struct RecordBits {
  unsigned* words;  // the row's words
  long long w;      // the word of the period taken last
  unsigned bits;

  __device__ __forceinline__ void take(long long p) {
    if ((p >> 5) != w) {
      flush();
      w = p >> 5;
      bits = 0;
    }
  }
  __device__ __forceinline__ void mark(long long p) { bits |= 1u << (p & 31); }
  __device__ __forceinline__ void flush() {
    if (w >= 0) words[w] = bits;
  }
};

// What a row's walk leaves for the block's record pass.
struct RowEnd {
  long long p_done;  // the completing period, -1 if the job never completes
  double comp;       // its completion time
};

// The walk of one (scheme, cell): every period in order, with the scheme's state in
// registers; writes the cell's five final states and returns its RowEnd.
template <int kScheme>
__device__ __forceinline__ RowEnd walk_cell(const Params& q, long long si, long long c) {
  constexpr bool kWalks = kScheme == kHour || kScheme == kEdge || kScheme == kAdapt;
  const long long P = q.P;
  PeriodStream<kScheme> in{q.A + c * P, q.B + c * P, q.valid + c * P,
                           kScheme == kEdge ? q.ptr0 + c * P : nullptr, P, PeriodIn{0.0, 0.0, 0, false}};
  in.load(0);
  const double hor = q.horizon[c];
  CellIn cell{nullptr, 0, nullptr, 0, 0, 0};
  if (kScheme == kEdge) {
    cell.edges = q.edges_flat + q.edge_base[c];
    cell.n_edges = q.edge_n[c];
  }
  if (kScheme == kAdapt) {
    cell.tab = q.tab_flat + q.tab_off[c];
    cell.top = q.tab_top[c];
    cell.k_step = (long long)(q.interval / q.bin_s);
    cell.k_step_ckpt = (long long)((q.interval + q.t_c) / q.bin_s) + 1;
  }

  double saved = q.init_saved, comp = INFINITY, lost = 0.0;
  bool done = false, has_run = false;
  long long n_ckpt = 0, n_kills = 0, p_done = -1;
  RecordBits rec{q.rec_bits + (si * q.C + c) * q.words, -1, 0u};

  // One flat loop over this thread's (period, step) cursor: an iteration takes the next
  // period (and, if it has work, enters it and takes its first window / tick) or takes one
  // window / tick of the period it is in, so the lanes of a warp stay on the same
  // iteration whatever their periods look like (a nested per-period loop would make the
  // warp wait, period by period, for its slowest lane).
  long long p = 0;
  bool walking = false;
  double a = 0.0, b = 0.0, start_work = 0.0;
  Walk w;
  while (p < P) {
    bool close = false;  // the period ends in this iteration
    PeriodOut o;
    o.done_now = false;
    if (!walking) {
      const PeriodIn pi = in.take(p);
      rec.take(p);
      if (!pi.v) {
        ++p;
        continue;
      }
      a = pi.a;
      b = pi.b;
      start_work = a + q.t_r;
      if (kScheme == kNone && has_run) saved = 0.0;  // NONE restarts from scratch
      if (start_work >= b) {  // killed before recovery finished: billed, no progress
        if (b < hor) {
          ++n_kills;
          has_run = true;
          rec.mark(p);
        }
        ++p;
        continue;
      }
      if (kWalks) {  // enter the period and take its first step in this iteration
        w.t = start_work;
        w.work = saved;
        w.sv = saved;
        w.next_dec = start_work + q.interval;
        w.done_at = NAN;
        w.ckpt_add = 0;
        w.done_now = false;
        w.cursor = kScheme == kEdge ? pi.ptr : 1;
        w.s_edge = (kScheme == kEdge && pi.ptr < cell.n_edges) ? cell.edges[pi.ptr] : INFINITY;
        w.k_prev = -1;  // no entry gathered yet in this period
        w.s_prev = 0.0;
        walking = true;
      } else {
        o = kScheme == kNone ? none_period(q, b, start_work, saved) : opt_period(q, b, start_work, saved);
        close = true;
      }
    }
    if (walking) {
      const bool ended = kScheme == kAdapt ? adapt_step(q, cell, a, b, w)
                                           : window_step<kScheme>(q, cell, a, b, start_work, w);
      if (ended) {
        o.done_now = w.done_now;
        o.done_at = w.done_at;
        o.work_end = w.work;
        o.saved_out = w.sv;
        o.ckpt_add = w.ckpt_add;
        walking = false;
        close = true;
      }
    }
    if (close) {  // fold the period's outcome
      rec.mark(p);
      n_ckpt += o.ckpt_add;
      if (o.done_now) {
        comp = o.done_at;
        done = true;
        p_done = p;
        break;  // the rest of the cell's periods have no record
      }
      ++n_kills;
      has_run = true;
      if (kScheme == kNone) {
        lost = lost + (o.work_end - 0.0);
      } else {
        lost = lost + (o.work_end - o.saved_out);
        saved = o.saved_out;
      }
      ++p;
    }
  }
  rec.flush();
  const long long i = si * q.C + c;
  q.done[i] = done;
  q.comp_time[i] = comp;
  q.n_ckpt[i] = n_ckpt;
  q.work_lost[i] = lost;
  q.n_kills[i] = n_kills;
  return RowEnd{p_done, comp};
}

__global__ void __launch_bounds__(kThreads) spot_sweep_kernel(const Params q) {
  __shared__ RowEnd rows[kThreads];
  const long long si = q.order[blockIdx.x / q.cell_blocks];
  const long long c0 = (long long)(blockIdx.x % q.cell_blocks) * kThreads;
  const long long c = c0 + threadIdx.x;
  if (c < q.C) {
    RowEnd r;
    switch (q.codes[si]) {
      case kNone: r = walk_cell<kNone>(q, si, c); break;
      case kOpt: r = walk_cell<kOpt>(q, si, c); break;
      case kHour: r = walk_cell<kHour>(q, si, c); break;
      case kEdge: r = walk_cell<kEdge>(q, si, c); break;
      default: r = walk_cell<kAdapt>(q, si, c); break;
    }
    rows[threadIdx.x] = r;
  }
  __syncthreads();

  // The run records of the block's rows, (row, period)-major as the outputs lie.  An
  // item is 32 periods of a row, one a lane (so the warp's loads and stores are
  // consecutive); a warp has kUnroll items in flight.  A record exists where the walk
  // marked it, up to the completing period; it ends at B but the completing one at the
  // completion time.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long P = q.P;
  const int W = (int)q.words;
  const int items = (int)(q.C - c0 < kThreads ? q.C - c0 : kThreads) * W;
  const double* B = q.B + c0 * P;
  const unsigned* bits = q.rec_bits + (si * q.C + c0) * W;
  const long long out0 = (si * q.C + c0) * P;
  for (int i0 = warp; i0 < items; i0 += kWarps * kUnroll) {
    double bv[kUnroll];
    unsigned wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarps, r = i / W;
      const long long p = (long long)(i - r * W) * 32 + lane;
      if (i < items) {
        wv[u] = bits[i];  // written by the walk if it took these periods
        if (p < P) bv[u] = B[r * P + p];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarps, r = i / W;
      const long long p = (long long)(i - r * W) * 32 + lane;
      if (i < items && p < P) {
        const RowEnd& row = rows[r];
        const long long j = out0 + r * P + p;
        const bool walked = row.p_done < 0 || p <= row.p_done;
        const bool user = p == row.p_done;
        q.rec_exists[j] = walked && ((wv[u] >> lane) & 1u);
        q.rec_end[j] = user ? row.comp : bv[u];
        q.rec_user[j] = user;
      }
    }
  }
}

// Slot order of the blocks: ADAPT, HOUR, EDGE, OPT, NONE (longest walks first).
int chain_rank(int code) {
  switch (code) {
    case kAdapt: return 0;
    case kHour: return 1;
    case kEdge: return 2;
    case kOpt: return 3;
    default: return 4;
  }
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for more than five schemes.  `codes` is a host array of the S
// scheme codes.  Pointers to the EDGE / ADAPT inputs may be null when the scheme set has
// no EDGE / ADAPT.  `rec_bits` is scratch of S * C * ceil(P / 32) words.
extern "C" int spot_sweep_launch(
    const int* codes, long long S, long long C, long long P,
    const double* A, const double* B, const bool* valid, const double* horizon,
    const long long* ptr0, const double* edges_flat, const long long* edge_base,
    const long long* edge_n, const double* tab_flat, const long long* tab_off,
    const long long* tab_top, double init_saved, double work_s, double t_c, double t_r,
    double hour_delta, double interval, double bin_s, long long n_bins, bool* done,
    double* comp_time, long long* n_ckpt, double* work_lost, long long* n_kills,
    bool* rec_exists, double* rec_end, bool* rec_user, unsigned* rec_bits, void* stream) {
  if (S < 0 || S > kMaxSchemes) return (int)cudaErrorInvalidValue;
  if (S == 0 || C == 0) return 0;
  Params q{S, C, P, {}, {}, (C + kThreads - 1) / kThreads, A, B, valid, horizon, ptr0,
           edges_flat, edge_base, edge_n, tab_flat, tab_off, tab_top, init_saved, work_s, t_c,
           t_r, hour_delta, interval, bin_s, n_bins, done, comp_time, n_ckpt, work_lost,
           n_kills, rec_exists, rec_end, rec_user, rec_bits, (P + 31) / 32};
  for (int s = 0; s < S; ++s) {
    q.codes[s] = codes[s];
    int k = s;  // insertion sort of the slots by chain rank, stable
    while (k > 0 && chain_rank(codes[q.order[k - 1]]) > chain_rank(codes[s])) {
      q.order[k] = q.order[k - 1];
      --k;
    }
    q.order[k] = s;
  }
  const long long blocks = S * q.cell_blocks;
  spot_sweep_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}
