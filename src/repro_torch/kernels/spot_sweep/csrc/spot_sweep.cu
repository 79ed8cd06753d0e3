// The fused (type x bid x seed) spot sweep of the paper's §VII study, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/spot_sweep/kernel.py::sweep_pallas (body _sweep_kernel), the
// Pallas TPU kernel that carries every bid-limited checkpointing scheme (NONE, OPT, HOUR,
// EDGE, ADAPT) through the padded (cells x periods) availability grid.
//
// Design: one thread per (scheme, cell), scheme-major (thread i runs scheme i / C on cell
// i % C), so a warp holds one scheme.  Each thread walks its own cell's periods in order
// with the whole scheme state in registers, through one flat loop over its own (period,
// step) cursor -- the per-thread form of _adapt_decoupled: an iteration enters a period or
// takes one HOUR / EDGE checkpoint window or one ADAPT decision tick, so a warp's loop count
// is its busiest lane's periods plus steps, not the sum over periods of the slowest lane.
// EDGE reads its first edge cursor from ptr0[c, p] in every period.  None of the Pallas
// block / VMEM structure is carried over: a thread needs no shared memory.
//
// What bounds it on this card: the serial chain of the busiest thread (its periods plus its
// windows or ticks, each a few dependent float64 operations and, for ADAPT, two gathers from
// the survival tables) and the run records it writes, about 10 bytes x S x C x P, each
// thread's records strided by P.  The records' layout is the one the host biller reads.
// Faster designs (coalesced record stores, splitting long cells) come later.
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
enum SchemeCode : int { kNone = 0, kOpt = 1, kHour = 2, kEdge = 3, kAdapt = 4 };

struct Params {
  const int* schemes;  // (S,) scheme codes
  long long S, C, P;
  const double* A;        // (C, P) period starts, NaN pad
  const double* B;        // (C, P) period ends, NaN pad
  const bool* valid;      // (C, P)
  const double* horizon;  // (C,)
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
};

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

__device__ PeriodOut none_period(const Params& q, double b, double start_work, double saved) {
  PeriodOut o;
  const double lhs = saved + (b - start_work);
  o.done_now = lhs >= (q.work_s - kEps);
  o.done_at = start_work + (q.work_s - saved);
  o.work_end = lhs;
  o.saved_out = saved;
  o.ckpt_add = 0;
  return o;
}

__device__ PeriodOut opt_period(const Params& q, double b, double start_work, double saved) {
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
// decision ticks.  `cursor` is HOUR's window index k or EDGE's edge cursor.
struct Walk {
  double t, work, sv, next_dec, done_at;
  long long cursor, ckpt_add;
  bool done_now, tail;
};

__device__ __forceinline__ void walk_enter(const Params& q, int scheme, long long c, long long p,
                                           double start_work, double saved, Walk& w) {
  w.t = start_work;
  w.work = saved;
  w.sv = saved;
  w.next_dec = start_work + q.interval;
  w.done_at = NAN;
  w.ckpt_add = 0;
  w.done_now = false;
  w.tail = false;
  w.cursor = scheme == kEdge ? q.ptr0[c * q.P + p] : 1;
}

// One HOUR (window k starts at a + k*delta - t_c) or EDGE (windows start at the rising
// edges from ptr0 on) window: engine/kernels.py windows_advance.  Returns true when the
// period's walk has ended; the tail segment (work to b, maybe completing) is then applied.
__device__ bool window_step(const Params& q, int scheme, long long c, double a, double b,
                            double start_work, Walk& w) {
  const double work_lim = q.work_s - kEps;
  double s;
  bool no_more, window;
  if (scheme == kHour) {
    s = a + (double)w.cursor * q.hour_delta - q.t_c;
    no_more = !(s < b);
    window = (s < b) && (s > start_work);  // windows before recovery ends are skipped
  } else {
    const bool have = w.cursor < q.edge_n[c];
    s = have ? q.edges_flat[q.edge_base[c] + w.cursor] : INFINITY;
    no_more = !have || !(s < b);
    window = have && (s < b);
  }
  bool ended = no_more;
  w.tail = no_more;
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
  if (scheme == kHour) {
    ++w.cursor;
  } else if (window) {
    ++w.cursor;  // only consumed edges advance
  }
  if (w.tail) {  // tail segment: work to b, maybe completing
    const double lhs = w.work + (b - w.t);
    if (lhs >= work_lim) {
      w.done_now = true;
      w.done_at = w.t + (q.work_s - w.work);
    }
    w.work = lhs;  // work_end
  }
  return ended;
}

__device__ __forceinline__ double survival_at(const Params& q, long long k, long long off,
                                              long long top) {
  const long long idx = k >= q.n_bins ? top + 1 : (k <= top ? k : top);
  return q.tab_flat[off + idx];
}

// engine/kernels.py adapt_decision: checkpoint iff hazard * (unsaved + t_r) > t_c.
__device__ bool adapt_take(const Params& q, double age, double unsaved, long long off,
                           long long top) {
  const long long k1 = (long long)(age / q.bin_s);
  const double s_now = survival_at(q, k1, off, top);
  const long long k2 = (long long)((age + q.interval) / q.bin_s);
  const double s_later = survival_at(q, k2, off, top);
  double h = 1.0;
  if (!(s_now <= 0.0)) h = np_min(np_max((s_now - s_later) / s_now, 0.0), 1.0);
  return (h * (unsaved + q.t_r)) > q.t_c;
}

// One ADAPT decision tick (engine/kernels.py adapt_tick_core).  Returns true when the
// period's walk has ended (completion or kill).
__device__ bool adapt_step(const Params& q, long long c, double a, double b, Walk& w) {
  const double seg_end = np_min(w.next_dec, b);
  if (w.work + (seg_end - w.t) >= q.work_s - kEps) {
    w.done_now = true;
    w.done_at = w.t + (q.work_s - w.work);
    return true;
  }
  w.work = w.work + (seg_end - w.t);
  w.t = seg_end;
  if (w.t >= b) return true;  // killed at b with no decision left
  if (adapt_take(q, w.t - a, w.work - w.sv, q.tab_off[c], q.tab_top[c])) {
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

__global__ void spot_sweep_kernel(const Params q) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q.S * q.C) return;
  const long long si = i / q.C;
  const long long c = i % q.C;
  const int scheme = q.schemes[si];
  const bool walks = scheme == kHour || scheme == kEdge || scheme == kAdapt;
  const double* A = q.A + c * q.P;
  const double* B = q.B + c * q.P;
  const bool* V = q.valid + c * q.P;
  const long long rec0 = i * q.P;  // (si * C + c) * P
  const double hor = q.horizon[c];

  double saved = q.init_saved, comp = INFINITY, lost = 0.0;
  bool done = false, has_run = false;
  long long n_ckpt = 0, n_kills = 0;

  // One flat loop over this thread's (period, step) cursor: an iteration either enters
  // period p or takes one window / tick of it, so the lanes of a warp stay on the same
  // iteration whatever their periods look like (a nested per-period loop would make the
  // warp wait, period by period, for its slowest lane).
  long long p = 0;
  bool walking = false;
  double a = 0.0, b = 0.0, start_work = 0.0;
  Walk w;
  while (p < q.P) {
    bool close = false;  // the period ends in this iteration
    PeriodOut o;
    o.done_now = false;
    if (!walking) {
      b = B[p];
      if (!V[p] || done) {
        q.rec_exists[rec0 + p] = false;
        q.rec_end[rec0 + p] = b;
        q.rec_user[rec0 + p] = false;
        ++p;
        continue;
      }
      a = A[p];
      start_work = a + q.t_r;
      if (scheme == kNone && has_run) saved = 0.0;  // NONE restarts from scratch
      if (start_work >= b) {  // killed before recovery finished: billed, no progress
        const bool killed = b < hor;
        if (killed) {
          ++n_kills;
          has_run = true;
        }
        q.rec_exists[rec0 + p] = killed;
        q.rec_end[rec0 + p] = b;
        q.rec_user[rec0 + p] = false;
        ++p;
        continue;
      }
      if (walks) {
        walk_enter(q, scheme, c, p, start_work, saved, w);
        walking = true;
        continue;
      }
      o = scheme == kNone ? none_period(q, b, start_work, saved) : opt_period(q, b, start_work, saved);
      close = true;
    } else {
      if (scheme == kAdapt ? adapt_step(q, c, a, b, w) : window_step(q, scheme, c, a, b, start_work, w)) {
        o.done_now = w.done_now;
        o.done_at = w.done_at;
        o.work_end = w.work;
        o.saved_out = w.sv;
        o.ckpt_add = w.ckpt_add;
        walking = false;
        close = true;
      }
    }
    if (close) {  // fold the period's outcome and write its run record
      n_ckpt += o.ckpt_add;
      if (o.done_now) {
        comp = o.done_at;
        done = true;
      } else {
        ++n_kills;
        has_run = true;
        if (scheme == kNone) {
          lost = lost + (o.work_end - 0.0);
        } else {
          lost = lost + (o.work_end - o.saved_out);
          saved = o.saved_out;
        }
      }
      q.rec_exists[rec0 + p] = true;
      q.rec_end[rec0 + p] = o.done_now ? o.done_at : b;
      q.rec_user[rec0 + p] = o.done_now;
      ++p;
    }
  }
  q.done[i] = done;
  q.comp_time[i] = comp;
  q.n_ckpt[i] = n_ckpt;
  q.work_lost[i] = lost;
  q.n_kills[i] = n_kills;
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() (0 on success).  Pointers
// to the EDGE / ADAPT inputs may be null when the scheme set has no EDGE / ADAPT.
extern "C" int spot_sweep_launch(
    const int* schemes, long long S, long long C, long long P,
    const double* A, const double* B, const bool* valid, const double* horizon,
    const long long* ptr0, const double* edges_flat, const long long* edge_base,
    const long long* edge_n, const double* tab_flat, const long long* tab_off,
    const long long* tab_top, double init_saved, double work_s, double t_c, double t_r,
    double hour_delta, double interval, double bin_s, long long n_bins, bool* done,
    double* comp_time, long long* n_ckpt, double* work_lost, long long* n_kills,
    bool* rec_exists, double* rec_end, bool* rec_user, void* stream) {
  const Params q{schemes, S, C, P, A, B, valid, horizon, ptr0, edges_flat, edge_base, edge_n,
                 tab_flat, tab_off, tab_top, init_saved, work_s, t_c, t_r, hour_delta,
                 interval, bin_s, n_bins, done, comp_time, n_ckpt, work_lost, n_kills,
                 rec_exists, rec_end, rec_user};
  const long long n = S * C;
  if (n == 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  spot_sweep_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}
