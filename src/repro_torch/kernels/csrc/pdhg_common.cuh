// Device code shared by the PDHG kernels (pdhg_kernels.cu) and the ELL
// sparse MVM (sparse_mvm.cu), hand-written for Hopper (sm_90a).
//
// The per-element algebra of one PDHG step lives ONCE, in dual_elem and
// primal_elem, and each operator's row product lives once too: a dense
// row by one warp (DenseRows) and an ELL row by a group of threads
// (EllRows).  The update kernels (B1, B2), the ELL MVM (B4) and the
// check-window megakernels (B3 dense, B5 ELL) all call these, so a stepped
// window and a fused window apply the same arithmetic by construction:
// B4 and B5 reduce every ELL row in the same order.  B3's transpose form
// (fused_steps_kt) walks rows its own way, to read K once a step, but
// applies the same dual_elem, primal_elem and step schedule.
//
// Everything carries a leading batch axis of B independent instances
// ("lanes").  A lane's vectors are contiguous slices of length m or n;
// its step sizes are element `lane` of (B,) arrays read through device
// pointers (a single instance is B = 1 with 0-d step sizes).

#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace pdhg {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;             // threads per block, all kernels
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxGridDim = 65535;

// y_new = y + sigma * Sigma_i * (b_i - (K x_bar)_i)
template <typename T>
__device__ __forceinline__ T dual_elem(T y, T kxbar, T b, T S, T sigma) {
  return y + sigma * S * (b - kxbar);
}

// clip(v, lo, hi) with NaN propagated, as jnp.clip and torch.clamp do
// (a diverged iterate must stay NaN so the merit reports it); +-inf
// bounds compare as ordinary values and are inert.
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// x_new = clip(x - tau * T_j * (c_j - (K^T y)_j), lb_j, ub_j)
// x_bar = x_new + theta * (x_new - x)
template <typename T>
__device__ __forceinline__ void primal_elem(T x, T kty, T c, T t, T lb, T ub,
                                            T tau, T theta, T* x_new,
                                            T* x_bar) {
  const T xn = clip(x - tau * t * (c - kty), lb, ub);
  *x_new = xn;
  *x_bar = xn + theta * (xn - x);
}

// theta_{k+1} = 1 / sqrt(1 + 2 gamma tau_k): the strongly_convex schedule
// (theta = 1 at gamma = 0)
template <typename T>
__device__ __forceinline__ T theta_of(T tau, T gamma) {
  return T(1) / sqrt(T(1) + T(2) * gamma * tau);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over aligned groups of g lanes (g a power of two <= 32); lane 0 of
// each group holds its group's sum.  Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, o, g);
  return v;
}

// Dot product of one row with a vector, by one warp: lanes stride the
// row so that each load instruction reads 32 neighbouring elements;
// lane 0 holds the sum on return.  Accumulates in T (f32 -> f32,
// f64 -> f64: at least f32 and never below the input type).
template <typename T>
__device__ __forceinline__ T warp_row_dot(const T* __restrict__ row,
                                          const T* v, int len, int lane) {
  T acc = T(0);
#pragma unroll 4
  for (int k = lane; k < len; k += 32) acc += row[k] * v[k];
  return warp_sum(acc);
}

// Slots that one thread of an ELL row group owns per round: a
// contiguous run of 16 bytes of values, 2 in f64 and 4 in f32, read as
// one 16-byte load (and one 8- or 16-byte load of columns) when the rows
// are aligned.  At 32 registers a thread a longer run spills in f64.
template <typename T>
__host__ __device__ constexpr int ell_run() {
  return 16 / (int)sizeof(T);
}

// Resident blocks an SM that B4 and B5 are compiled for: 8 x 256 threads
// is the SM's 2048, which caps a thread at 32 registers.  B5's scalar
// form (ragged widths or unaligned bases, never the stream's buckets)
// spills a register in f64 at 32, so it takes 6 (40 registers: they are
// granted in steps of 8).
constexpr int kEllBlocksPerSM = 8;
constexpr int kEllScalarFusedBlocksPerSM = 6;

// Threads that own one ELL row of width W: the smallest power of two g
// (at most 32) with 8 g >= W, so a warp holds 32 / g rows, 4 at W = 64
// and 8 at W = 32, and a full row takes 4 rounds of runs in f64 and 2 in
// f32.
__host__ __device__ inline int ell_group(int W) {
  int g = 1;
  while (8 * g < W && g < 32) g <<= 1;
  return g;
}

// The rows of a dense product over the whole batch: row r of the
// (rows, len) row-major matrix M belongs to lane r / rows_per_lane and
// multiplies that lane's slice of v.  One warp per row.
template <typename T>
struct DenseRows {
  const T* __restrict__ M;
  int len;

  // Calls f(lane, i, (M v)_i) on lane 0 of the owning warp, for every row
  // q this warp owns (warp, warp + n_warps, ...) of the `rows` rows of the
  // lanes listed in `lanes` (every lane when it is null); row q is row i
  // of the whole batch.  Row and vector indices are 32-bit (the launchers
  // check that every lane's rows and vectors fit); addresses are not.
  // The prefetch hook of EllRows is not called here.
  template <typename P, typename F>
  __device__ __forceinline__ void for_each_row(int rows, int rows_per_lane,
                                               const int* lanes, const T* v,
                                               int v_len, int warp,
                                               int n_warps, P&&,
                                               F&& f) const {
    const int lane = threadIdx.x & 31;
    for (int q = warp; q < rows; q += n_warps) {
      const int slot = q / rows_per_lane;
      const int l = lanes == nullptr ? slot : lanes[slot];
      const int i = l * rows_per_lane + (q - slot * rows_per_lane);
      const T acc = warp_row_dot(M + (long long)i * len, v + l * v_len, len,
                                 lane);
      if (lane == 0) f(l, i, acc);
    }
  }
};

// Asks the L2 for the line holding *p; no register waits for it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One run of values (16 bytes) and of their columns from aligned
// addresses.
__device__ __forceinline__ void load_run(const double* d, const int* c,
                                         double* dv, int* cv) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(d));
  const int2 b = __ldg(reinterpret_cast<const int2*>(c));
  dv[0] = a.x; dv[1] = a.y;
  cv[0] = b.x; cv[1] = b.y;
}
__device__ __forceinline__ void load_run(const float* d, const int* c,
                                         float* dv, int* cv) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(d));
  const int4 b = __ldg(reinterpret_cast<const int4*>(c));
  dv[0] = a.x; dv[1] = a.y; dv[2] = a.z; dv[3] = a.w;
  cv[0] = b.x; cv[1] = b.y; cv[2] = b.z; cv[3] = b.w;
}

// The rows of an ELL product over the whole batch:
//   w[i] = sum_{k < len_i} data[i, k] * v_lane[cols[i, k]]
//          (+ 0 * v_lane[0] when len_i < W)
// where len_i = row_len[i] (clamped to [0, W]), or W for every row when
// row_len is null.  The slots from len_i on are padding (data 0, col 0):
// they are not read, and the one 0 * v_lane[0] term stands for all of
// them, so a non-finite v[0] still turns a padded row to NaN, as the
// reference's product over every slot does.
//
// A group of g = ell_group(W) threads owns a row.  In round r, thread t
// of the group owns the run of R = ell_run<T>() slots from r * g * R +
// t * R: with kVec (W % R == 0 and 16-byte-aligned bases) it issues the
// run's vector loads of data and cols, then its gathers of v, then its
// FMAs in slot order; without, it takes the same slots one by one.  The
// group reduces with log2(g) shuffles.  So the sum order depends on W
// and T alone, and B4 and B5, which both call this, sum every row in the
// same order.  The rounds run to the longest row of the warp, a bound
// uniform across the warp: every lane reaches the shuffles.
template <typename T, bool kVec>
struct EllRows {
  const T* __restrict__ data;
  const int* __restrict__ cols;
  const int* __restrict__ row_len;    // null: every row is W long
  int W;

  // As DenseRows::for_each_row; f(lane, i, w_i) is called on the first
  // thread of the row's group, and pre(i) on the same thread as soon as
  // the row is known, before its loads: B5 asks the L2 there for the
  // element operands f reads, so they arrive while the row is summed.
  template <typename P, typename F>
  __device__ __forceinline__ void for_each_row(int rows, int rows_per_lane,
                                               const int* lanes, const T* v,
                                               int v_len, int warp,
                                               int n_warps, P&& pre,
                                               F&& f) const {
    const int g = ell_group(W);
    const int lane = threadIdx.x & 31;
    const int t = lane & (g - 1);
    const int per_warp = 32 / g;
    constexpr int R = ell_run<T>();
    const int round = g * R;
    for (int base = warp * per_warp; base < rows; base += n_warps * per_warp) {
      const int q = base + lane / g;
      const bool valid = q < rows;
      int l = 0, i = 0, len = 0;
      if (valid) {
        const int slot = q / rows_per_lane;
        l = lanes == nullptr ? slot : lanes[slot];
        i = l * rows_per_lane + (q - slot * rows_per_lane);
        len = row_len == nullptr ? W : min(max(__ldg(row_len + i), 0), W);
        if (t == 0) pre(i);
      }
      const int longest = __reduce_max_sync(0xffffffffu, len);
      const T* d = data + (long long)i * W;
      const int* c = cols + (long long)i * W;
      const T* vl = v + l * v_len;
      T acc = T(0);
      for (int s = 0; s < longest; s += round) {
        const int r0 = s + t * R;
        if (kVec) {
          T dv[R] = {};
          int cv[R] = {};
          if (r0 < len) load_run(d + r0, c + r0, dv, cv);
          T xv[R];
#pragma unroll
          for (int k = 0; k < R; ++k)
            xv[k] = r0 + k < len ? vl[cv[k]] : T(0);
#pragma unroll
          for (int k = 0; k < R; ++k)
            if (r0 + k < len) acc = fma(dv[k], xv[k], acc);
        } else {
          // unaligned or ragged rows: the same slots in the same order,
          // one at a time
#pragma unroll 1
          for (int k = 0; k < R; ++k)
            if (r0 + k < len)
              acc = fma(__ldg(d + r0 + k), vl[__ldg(c + r0 + k)], acc);
        }
      }
      acc = group_sum(acc, g);
      if (valid && t == 0) {
        if (len < W) acc += T(0) * vl[0];
        f(l, i, acc);
      }
    }
  }
};

// Writes the window's step-size schedule of every lane: for s < n_steps,
// tau_s, sigma_s and theta_s at sched[(0|1|2) * n_steps * B + s * B + lane],
// and the values after the window to tau_out/sigma_out.  The schedule
// depends on no vector, so one thread per lane computes it up front, in
// the order the stepped loop applies it.  A lane that `active` (B bytes,
// null: every lane) marks stopped keeps its tau and sigma.
template <typename T>
__device__ __forceinline__ void step_schedule(
    const T* __restrict__ tau_in, const T* __restrict__ sigma_in,
    const unsigned char* __restrict__ active, T* sched, T* tau_out,
    T* sigma_out, int B, int n_steps, T gamma) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  const long long plane = (long long)n_steps * B;
  T tau = tau_in[t];
  T sigma = sigma_in[t];
  const bool live = active == nullptr || active[t];
  for (int s = 0; s < n_steps && live; ++s) {
    const T theta = theta_of(tau, gamma);
    sched[s * (long long)B + t] = tau;
    sched[plane + s * (long long)B + t] = sigma;
    sched[2 * plane + s * (long long)B + t] = theta;
    tau = theta * tau;
    sigma = sigma / theta;
  }
  tau_out[t] = tau;
  sigma_out[t] = sigma;
}

// lanes[0..n) = the lanes that `active` marks live, in order, and
// lanes[B] = n; one thread.
__device__ __forceinline__ void list_live_lanes(
    const unsigned char* __restrict__ active, int* lanes, int B) {
  int n = 0;
  for (int l = 0; l < B; ++l)
    if (active == nullptr || active[l]) lanes[n++] = l;
  lanes[B] = n;
}

// The check window of the megakernels (B3's two-matrix form, B5): n_steps
// full PDHG steps over the live lanes, in one cooperative launch.
//   prologue: the step-size schedule, and with a `lanes` scratch of B + 1
//            ints the list of live lanes (null: every lane, no list);
//   grid.sync();
//   phase A: one row owner per row of K (live lanes) computes
//            (K x_bar)_i and applies dual_elem; y_i is added into the y
//            sum;
//   grid.sync();
//   phase B: one row owner per row of K^T computes (K^T y)_j and applies
//            primal_elem; x_prev_j, x_j, x_bar_j and the x sum are
//            written by the row's owner;
//   grid.sync();
// Only the live lanes' rows are spread over the grid, so every warp's
// share shrinks with them; a stopped lane's state and sums are left as
// they came in.  A row keeps one owner for the whole window, so the sums
// need no atomics.  The state arrays are updated in place.
template <typename T, typename Fwd, typename Adj>
__device__ __forceinline__ void fused_steps(
    const Fwd& fwd, const Adj& adj, const T* __restrict__ b,
    const T* __restrict__ c, const T* __restrict__ lb,
    const T* __restrict__ ub, const T* __restrict__ Tp,
    const T* __restrict__ S, T* x, T* x_prev, T* x_bar, T* y,
    const T* __restrict__ tau_in, const T* __restrict__ sigma_in,
    T* tau_out, T* sigma_out, T* sched, T* xs, T* ys,
    const unsigned char* __restrict__ active, int* lanes, int m, int n,
    int B, int n_steps, T gamma) {
  cg::grid_group grid = cg::this_grid();
  step_schedule(tau_in, sigma_in, active, sched, tau_out, sigma_out, B,
                n_steps, gamma);
  if (lanes != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    list_live_lanes(active, lanes, B);
  grid.sync();
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  const int live = lanes == nullptr ? B : lanes[B];
  const int plane = n_steps * B;
  for (int s = 0; s < n_steps; ++s) {
    // step s's tau, sigma, theta of lane l: sched[(0|1|2) * plane + at + l]
    const int at = s * B;
    fwd.for_each_row(live * m, m, lanes, x_bar, n, warp, n_warps,
                     [&](int i) {       // f's operands, early
                       prefetch_l2(y + i);
                       prefetch_l2(b + i);
                       prefetch_l2(S + i);
                       prefetch_l2(ys + i);
                     },
                     [&](int l, int i, T kx) {
                       const T yn = dual_elem(y[i], kx, b[i], S[i],
                                              sched[plane + at + l]);
                       y[i] = yn;
                       ys[i] += yn;
                     });
    grid.sync();
    adj.for_each_row(live * n, n, lanes, y, m, warp, n_warps,
                     [&](int j) {       // f's operands, early
                       prefetch_l2(x + j);
                       prefetch_l2(c + j);
                       prefetch_l2(Tp + j);
                       prefetch_l2(lb + j);
                       prefetch_l2(ub + j);
                       prefetch_l2(xs + j);
                     },
                     [&](int l, int j, T kty) {
                       const T xo = x[j];
                       T xn, xb;
                       primal_elem(xo, kty, c[j], Tp[j], lb[j], ub[j],
                                   sched[at + l], sched[2 * plane + at + l],
                                   &xn, &xb);
                       x_prev[j] = xo;
                       x[j] = xn;
                       x_bar[j] = xb;
                       xs[j] += xn;
                     });
    grid.sync();
  }
}

// ------------------------------------------ B3, the transpose form ---
//
// The check window of B3 where the adjoint is exactly K^T: each step
// reads K once, for both products.  The step's chain is x_bar -> K x_bar
// -> y -> K^T y -> x, but y_i' needs only row i of K and x_bar, and row
// i's share of K^T y' is y_i' K[i, :].  So a block that owns a panel of
// rows does three things with each row while it is on chip: sums
// K[i, :] . x_bar, applies dual_elem, and adds y_i' K[i, :] into the
// panel's partial K^T y'.  One grid-wide reduction of the partials then
// gives K^T y'.
//
// Work: with L live lanes (list_live_lanes) and G blocks, a lane gets
// P = min(G / L, m) blocks when L <= G, unit (k, p) being the rows
// [p m / P, (p+1) m / P) of the k-th live lane; with L > G, P = 1 and a
// block takes whole lanes in turn (unit u on block u mod G).  Unit u's
// partial K^T y' goes to part[u] (n values); P <= m, so every unit has
// a row.
//
// Phase 1 walks the block's rows, unit by unit, with no division in the
// row loop.  Thread t owns the chunks c of a row, elements
// [(c kKtThreads + t) V, +V), V being 16 bytes of elements (kVec: K and
// every row 16-byte aligned) or one element.  In the ring form (n <=
// kt_ring_cols) each thread copies its own chunks of the rows ahead into
// a ring of S shared-memory stages with cp.async (S - 1 rows in flight,
// S as many as fit beside x_bar: 2 at n = 7680 in f64, 6 in f32), keeps
// its chunks of x_bar in shared memory and of the partial in registers,
// reads a row's stage for its sum and again for the update, and writes
// the partial out at the unit's end.  So K is read from HBM once a step.
// A row's y, b, Sigma and y sum come from shared memory, staged for up to
// kKtRowBlock rows with one load and written back once: a global load in
// every row would queue behind the copies of the rows ahead.
// The copies follow the block's row order across units and steps (K
// does not change), so the next step's first rows are in flight through
// phase 2 and the grid barriers.  The wide form (rows too long for the
// ring) sums each row from HBM, then re-reads it for the update while
// it is in the L1/L2 (one row a block in flight), with x_bar and the
// partial (part[u]) in the L2.
//
// Phase 2: unit (k, p) owns the columns [p n / P, (p+1) n / P) of its
// lane; R = min(P, kKtWarps) warps sum part[k P + q] over q, each a
// fixed residue of q mod R, and one warp adds their sums in warp order
// and applies primal_elem.  Every sum runs in a fixed order with no
// atomics, so a run is bit-identical to the next:
//   (K x_bar)_i = over the warps in order, of (a shuffle tree over the
//                 lanes, of each thread's chunks in order);
//   (K^T y)_j   = over r < R in order, of (over q = r mod R ascending,
//                 of (over the unit's rows in order, y_i K[i, j])).
// Two grid barriers a step, and one block barrier a row.
constexpr int kKtThreads = 512;
constexpr int kKtWarps = kKtThreads / 32;
constexpr int kKtChunks = 8;       // chunks a thread holds, ring form
constexpr int kKtMaxStages = 6;    // rows in shared memory, ring form
constexpr int kKtRowBlock = 128;   // rows whose y, b, Sigma, y sum are
                                   // staged in shared memory at once
// shared memory that x_bar and the ring's stages may take: 216 KB of
// the 227 KB a block may hold, the rest for the static arrays
constexpr int kKtRingBytes = 216 * 1024;

// elements a chunk holds
template <typename T, bool kVec>
__host__ __device__ constexpr int kt_vec() {
  return kVec ? 16 / (int)sizeof(T) : 1;
}

// The longest row of the ring form, set by the registers that hold a
// thread's chunks of the partial (16 doubles or 32 floats): 8192 in f64
// and 16384 in f32 with 16-byte chunks, 4096 with one element a chunk.
// x_bar and two stages of such a row fit in kKtRingBytes.
template <typename T, bool kVec>
__host__ __device__ constexpr int kt_ring_cols() {
  return kKtChunks * kKtThreads * kt_vec<T, kVec>();
}

// elements of one row image in shared memory: n rounded up to 16 bytes
template <typename T>
__host__ __device__ inline long long kt_stage_len(int n) {
  const int v = 16 / (int)sizeof(T);
  return ((long long)n + v - 1) / v * v;
}

// stages of the ring at row length n: as many as fit in kKtRingBytes
// beside x_bar, at most kKtMaxStages
template <typename T>
__host__ __device__ inline int kt_stages(int n) {
  const long long s =
      kKtRingBytes / (kt_stage_len<T>(n) * (long long)sizeof(T)) - 1;
  return (int)(s < kKtMaxStages ? s : kKtMaxStages);
}

// one cp.async of kBytes (4, 8 or 16) from global to shared memory
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(kBytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// waits until at most `pending` (< kKtMaxStages) groups are in flight
__device__ __forceinline__ void cp_async_wait_at_most(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}

// V elements moved as one access (16 bytes when V > 1)
template <typename T, int V>
struct alignas(V > 1 ? 16 : sizeof(T)) Pack {
  T v[V];
};

// Sum of v over the block, the same on every thread: a shuffle tree in
// each warp, then the warps' sums as a tree of four sums of four.  `red`
// holds 2 kKtWarps slots and `parity` alternates from call to call, so
// one __syncthreads a call suffices: a slot is rewritten only after every
// thread has passed the barrier of the call between.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red, int& parity) {
  static_assert(kKtWarps == 16, "the tree below sums 16 warps");
  v = warp_sum(v);
  const T* slots = red + parity * kKtWarps;
  if ((threadIdx.x & 31) == 0) red[parity * kKtWarps + (threadIdx.x >> 5)] = v;
  __syncthreads();
  T q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = (slots[k] + slots[k + 4]) + (slots[k + 8] + slots[k + 12]);
  parity ^= 1;
  return (q[0] + q[1]) + (q[2] + q[3]);
}

// n_steps full PDHG steps over the live lanes of a (B, m, n) K whose
// adjoint is K^T, in one cooperative launch of kKtThreads-thread blocks;
// part holds max(G, B) x n values.  kRing picks the ring form (n <=
// kt_ring_cols<T, kVec>(), with kt_stages<T>(n) x kt_stage_len<T>(n)
// elements of dynamic shared memory) over the wide one.  The same state,
// sums and schedule as fused_steps; `lanes` (B + 1 ints) is required.
template <typename T, bool kRing, bool kVec>
__device__ __forceinline__ void fused_steps_kt(
    const T* __restrict__ K, const T* __restrict__ b,
    const T* __restrict__ c, const T* __restrict__ lb,
    const T* __restrict__ ub, const T* __restrict__ Tp,
    const T* __restrict__ S, T* x, T* x_prev, T* x_bar, T* y,
    const T* __restrict__ tau_in, const T* __restrict__ sigma_in,
    T* tau_out, T* sigma_out, T* sched, T* xs, T* ys, T* part,
    const unsigned char* __restrict__ active, int* lanes, int m, int n,
    int B, int n_steps, T gamma) {
  constexpr int V = kt_vec<T, kVec>();
  constexpr int kHeld = kRing ? kKtChunks * V : 1;
  using Chunk = Pack<T, V>;
  __shared__ T red[2 * kKtWarps];
  __shared__ T colsum[kKtWarps][32];
  // a row block's y, b, Sigma and y sum: one load a block, none a row
  __shared__ T rop[4][kKtRowBlock];
  extern __shared__ __align__(16) unsigned char kt_smem[];

  cg::grid_group grid = cg::this_grid();
  step_schedule(tau_in, sigma_in, active, sched, tau_out, sigma_out, B,
                n_steps, gamma);
  if (blockIdx.x == 0 && threadIdx.x == 0) list_live_lanes(active, lanes, B);
  grid.sync();

  const int tid = threadIdx.x;
  const int wid = tid >> 5, lid = tid & 31;
  const int G = gridDim.x;
  const int blk = blockIdx.x;
  const int L = lanes[B];
  const int P = (L == 0 || L > G) ? 1 : max(1, min(G / L, m));
  const int U = L * P;
  // this block's units are u = blk + t G for t < nb, each the rows
  // [lo_u, hi_u) of a lane: with P > 1 at most one, a panel; with P = 1
  // whole lanes
  const int nb = blk < U ? (U - 1 - blk) / G + 1 : 0;
  const int lo_u = P > 1 ? (int)((long long)(blk % P) * m / P) : 0;
  const int hi_u = P > 1 ? (int)((long long)(blk % P + 1) * m / P) : m;
  const long long total = (long long)nb * (hi_u - lo_u) * n_steps;
  const int plane = n_steps * B;
  auto lane_at = [&](int t) { return lanes[P > 1 ? blk / P : blk + t * G]; };

  // the ring: x_bar, then S stages, row images of stage_len elements
  const long long stage_len = kt_stage_len<T>(n);
  const int S_ = kRing ? kt_stages<T>(n) : 1;
  T* const xb_s = reinterpret_cast<T*>(kt_smem);
  T* const ring = xb_s + stage_len;
  // the copy cursor: the next row to copy (unit pt, lane pl, row pi)
  // and its stage; rows are copied in the order they are summed
  int pt = 0, pi = lo_u, pl = nb ? lane_at(0) : 0, pst = 0;
  long long issued = 0;
  auto issue_next = [&]() {
    if (issued < total) {
      const T* row = K + ((long long)pl * m + pi) * (long long)n;
      T* dst = ring + pst * stage_len;
#pragma unroll
      for (int ch = 0; ch < kKtChunks; ++ch) {
        const int e = (ch * kKtThreads + tid) * V;
        if (e < n) cp_async<V * (int)sizeof(T)>(dst + e, row + e);
      }
      ++issued;
      if (++pst == S_) pst = 0;
      if (++pi == hi_u) {
        pi = lo_u;
        if (++pt == nb) pt = 0;
        pl = lane_at(pt);
      }
    }
    cp_async_commit();
  };

  T acc[kHeld];             // ring: this thread's chunks of the partial
#pragma unroll
  for (int k = 0; k < kHeld; ++k) acc[k] = T(0);
  int parity = 0;
  int cst = 0;              // the stage of the row being summed
  if constexpr (kRing) {
    for (int k = 0; k < S_ - 1; ++k) issue_next();
  }

  for (int s = 0; s < n_steps; ++s) {
    const int at = s * B;
    // ----------------------------------------- phase 1: the rows ---
    for (int t = 0; t < nb; ++t) {
      const int u = blk + t * G;
      const int l = lane_at(t);
      const T* xb = x_bar + (long long)l * n;
      T* pu = part + (long long)u * n;
      const T sigma = sched[plane + at + l];
      if constexpr (kRing) {          // the unit's lane's x_bar
#pragma unroll
        for (int ch = 0; ch < kKtChunks; ++ch) {
          const int e = (ch * kKtThreads + tid) * V;
          if (e < n)
            *reinterpret_cast<Chunk*>(xb_s + e) =
                *reinterpret_cast<const Chunk*>(xb + e);
        }
      } else {
        for (int j = tid; j < n; j += kKtThreads) pu[j] = T(0);
      }
      for (int i0 = lo_u; i0 < hi_u; i0 += kKtRowBlock) {
        const int nr = min(kKtRowBlock, hi_u - i0);
        const long long at0 = (long long)l * m + i0;
        __syncthreads();              // the last block's write-back is done
        if (tid < nr) {
          rop[0][tid] = y[at0 + tid];
          rop[1][tid] = b[at0 + tid];
          rop[2][tid] = S[at0 + tid];
          rop[3][tid] = ys[at0 + tid];
        }
        __syncthreads();
        for (int r = 0; r < nr; ++r) {
          // read before the row's barrier, after which thread 0 writes
          const T y_i = rop[0][r], b_i = rop[1][r], S_i = rop[2][r];
          const T* row = K + (at0 + r) * (long long)n;
          T dot = T(0);
          if constexpr (kRing) {
            // the stage of the row before, which this thread has read,
            // takes the row S - 1 ahead; then this row has landed
            issue_next();
            cp_async_wait_at_most(S_ - 1);
            const T* src = ring + cst * stage_len;
#pragma unroll
            for (int ch = 0; ch < kKtChunks; ++ch) {
              const int e = (ch * kKtThreads + tid) * V;
              if (e < n) {
                const Chunk kv = *reinterpret_cast<const Chunk*>(src + e);
                const Chunk xv = *reinterpret_cast<const Chunk*>(xb_s + e);
#pragma unroll
                for (int v = 0; v < V; ++v)
                  dot = fma(kv.v[v], xv.v[v], dot);
              }
            }
          } else {
#pragma unroll 4
            for (int j = tid; j < n; j += kKtThreads)
              dot = fma(__ldg(row + j), xb[j], dot);
          }
          const T yn = dual_elem(y_i, block_sum(dot, red, parity), b_i,
                                 S_i, sigma);
          if (tid == 0) {
            rop[0][r] = yn;
            rop[3][r] += yn;
          }
          if constexpr (kRing) {
            const T* src = ring + cst * stage_len;
#pragma unroll
            for (int ch = 0; ch < kKtChunks; ++ch) {
              const int e = (ch * kKtThreads + tid) * V;
              if (e < n) {
                const Chunk kv = *reinterpret_cast<const Chunk*>(src + e);
#pragma unroll
                for (int v = 0; v < V; ++v)
                  acc[ch * V + v] = fma(yn, kv.v[v], acc[ch * V + v]);
              }
            }
            if (++cst == S_) cst = 0;
          } else {
#pragma unroll 4
            for (int j = tid; j < n; j += kKtThreads)
              pu[j] = fma(yn, __ldg(row + j), pu[j]);
          }
        }
        __syncthreads();
        if (tid < nr) {
          y[at0 + tid] = rop[0][tid];
          ys[at0 + tid] = rop[3][tid];
        }
      }
      if constexpr (kRing) {          // the unit ends: its partial out
#pragma unroll
        for (int ch = 0; ch < kKtChunks; ++ch) {
          const int e = (ch * kKtThreads + tid) * V;
          if (e < n) {
            Chunk o;
#pragma unroll
            for (int v = 0; v < V; ++v) o.v[v] = acc[ch * V + v];
            *reinterpret_cast<Chunk*>(pu + e) = o;
          }
        }
#pragma unroll
        for (int k = 0; k < kHeld; ++k) acc[k] = T(0);
      }
    }
    grid.sync();
    // -------------------------------------- phase 2: the columns ---
    const int R = min(P, kKtWarps);    // warps that share a column
    const int C = kKtWarps / R;        // columns of 32 a pass
    const int rg = wid % R, cgp = wid / R;
    for (int t = 0; t < nb; ++t) {
      const int u = blk + t * G;
      const int k = u / P, p = u % P;
      const int l = lanes[k];
      const int j0 = (int)((long long)p * n / P);
      const int j1 = (int)((long long)(p + 1) * n / P);
      const T tau = sched[at + l];
      const T theta = sched[2 * plane + at + l];
      for (int jt = j0; jt < j1; jt += 32 * C) {
        if (cgp < C) {
          const int j = jt + cgp * 32 + lid;
          T sum = T(0);
          if (j < j1) {
            const T* pj = part + (long long)k * P * n + j;
#pragma unroll 8
            for (int q = rg; q < P; q += R) sum += pj[(long long)q * n];
          }
          colsum[wid][lid] = sum;
        }
        __syncthreads();
        const int j = jt + wid * 32 + lid;
        if (wid < C && j < j1) {
          T kty = T(0);
          for (int r = 0; r < R; ++r) kty += colsum[wid * R + r][lid];
          const long long at_j = (long long)l * n + j;
          const T xo = x[at_j];
          T xn, xbn;
          primal_elem(xo, kty, c[at_j], Tp[at_j], lb[at_j], ub[at_j], tau,
                      theta, &xn, &xbn);
          x_prev[at_j] = xo;
          x[at_j] = xn;
          x_bar[at_j] = xbn;
          xs[at_j] += xn;
        }
        __syncthreads();
      }
    }
    grid.sync();
  }
  if constexpr (kRing) cp_async_wait<0>();
}

// Largest grid of `kernel` that can be co-resident for a cooperative
// launch (occupancy x SMs) at `threads` threads and `smem` bytes of
// dynamic shared memory a block, cut to `want` blocks.
inline cudaError_t cooperative_grid(const void* kernel, long long want,
                                    int* grid, int threads = kThreads,
                                    size_t smem = 0) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = (long long)per_sm * sms;
  if (want > most) want = most;
  *grid = (int)(want < 1 ? 1 : want);
  return cudaSuccess;
}

// out[0..3) = registers a thread, local (spill) bytes a thread and
// resident blocks an SM of `kernel` at `threads` threads and `smem`
// bytes of dynamic shared memory a block.
inline cudaError_t kernel_attrs(const void* kernel, int* out,
                                int threads = kThreads, size_t smem = 0) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                       threads, smem);
}

// Vector loads of ELL runs: W a multiple of the run and both bases
// 16-byte aligned (then every row's runs are aligned).
template <typename T>
inline bool ell_vectorised(const void* data, const void* cols, int W) {
  return W % ell_run<T>() == 0 && (uintptr_t)data % 16 == 0 &&
         (uintptr_t)cols % 16 == 0;
}

// Whether the rows of B lanes of an (m, n) operator and its vectors have
// 32-bit indices, as the row walks above take them, with room for a
// grid's stride (at most 2^24 threads) past the last row.
inline bool rows_fit_int(long long B, long long m, long long n) {
  return B * (m > n ? m : n) + (1LL << 24) < (1LL << 31);
}

// Whether a window's step-size schedule (3 x n_steps x B) has 32-bit
// indices.
inline bool schedule_fits_int(long long B, long long n_steps) {
  return 3 * n_steps * B < (1LL << 31);
}

// Blocks that give every row of `rows` an owner when a warp owns
// `per_warp` rows.
inline long long blocks_for_rows(long long rows, int per_warp) {
  const long long per_block = (long long)kWarpsPerBlock * per_warp;
  return (rows + per_block - 1) / per_block;
}

}  // namespace pdhg
