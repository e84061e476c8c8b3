// Device code shared by the PDHG kernels (pdhg_kernels.cu) and the ELL
// sparse MVM (sparse_mvm.cu), hand-written for Hopper (sm_90a).
//
// The per-element algebra of one PDHG step lives ONCE, in dual_elem and
// primal_elem, and each operator's row product lives once too: a dense
// row by one warp (DenseRows) and an ELL row by a group of threads
// (EllRows).  The update kernels (B1, B2), the ELL MVM (B4) and the
// check-window megakernels (B3 dense, B5 ELL) all call these, so a stepped
// window and a fused window apply the same arithmetic by construction:
// B4 and B5 reduce every ELL row in the same order.
//
// Everything carries a leading batch axis of B independent instances
// ("lanes").  A lane's vectors are contiguous slices of length m or n;
// its step sizes are element `lane` of (B,) arrays read through device
// pointers (a single instance is B = 1 with 0-d step sizes).

#pragma once

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

// Threads that own one ELL row of width W: min(W, 32) rounded up to a
// power of two, so a warp holds 32 / g whole rows.
__host__ __device__ inline int ell_group(int W) {
  int g = 1;
  while (g < W && g < 32) g <<= 1;
  return g;
}

// The rows of a dense product over the whole batch: row r of the
// (rows, len) row-major matrix M belongs to lane r / rows_per_lane and
// multiplies that lane's slice of v.  One warp per row.
template <typename T>
struct DenseRows {
  const T* __restrict__ M;
  int len;

  // Calls f(r, (M v)_r) on lane 0 of the owning warp, for every row r
  // this warp owns (warp, warp + n_warps, ...).
  template <typename F>
  __device__ __forceinline__ void for_each_row(long long rows,
                                               long long rows_per_lane,
                                               const T* v, long long v_len,
                                               long long warp,
                                               long long n_warps, F&& f)
      const {
    const int lane = threadIdx.x & 31;
    for (long long r = warp; r < rows; r += n_warps) {
      const T* vl = v + (r / rows_per_lane) * v_len;
      const T acc = warp_row_dot(M + r * (long long)len, vl, len, lane);
      if (lane == 0) f(r, acc);
    }
  }
};

// The rows of an ELL product over the whole batch:
//   w[r] = sum_k data[r, k] * v_lane[cols[r, k]],  k < W
// A group of g = ell_group(W) threads owns a row; its lanes stride the
// row's W slots (coalesced: neighbouring lanes read neighbouring slots,
// neighbouring groups neighbouring rows) and reduce with shuffles.  Every
// slot is multiplied, padding included (data 0, col 0), as the reference
// does, so a non-finite v[0] turns a padded row to NaN on both sides.
template <typename T>
struct EllRows {
  const T* __restrict__ data;
  const int* __restrict__ cols;
  int W;

  template <typename F>
  __device__ __forceinline__ void for_each_row(long long rows,
                                               long long rows_per_lane,
                                               const T* v, long long v_len,
                                               long long warp,
                                               long long n_warps, F&& f)
      const {
    const int g = ell_group(W);
    const int lane = threadIdx.x & 31;
    const int lane_g = lane & (g - 1);
    const int per_warp = 32 / g;
    // the loop bound is uniform across the warp: every lane reaches the
    // shuffles of group_sum, valid row or not
    for (long long base = warp * per_warp; base < rows;
         base += n_warps * per_warp) {
      const long long r = base + lane / g;
      const bool valid = r < rows;
      T acc = T(0);
      if (valid) {
        const T* vl = v + (r / rows_per_lane) * v_len;
        const T* d = data + r * (long long)W;
        const int* c = cols + r * (long long)W;
        for (int k = lane_g; k < W; k += g) acc += d[k] * vl[c[k]];
      }
      acc = group_sum(acc, g);
      if (valid && lane_g == 0) f(r, acc);
    }
  }
};

// Writes the window's step-size schedule of every lane: for s < n_steps,
// tau_s, sigma_s and theta_s at sched[(0|1|2) * n_steps * B + s * B + lane],
// and the values after the window to tau_out/sigma_out.  The schedule
// depends on no vector, so one thread per lane computes it up front, in
// the order the stepped loop applies it.
template <typename T>
__device__ __forceinline__ void step_schedule(const T* __restrict__ tau_in,
                                              const T* __restrict__ sigma_in,
                                              T* sched, T* tau_out,
                                              T* sigma_out, int B,
                                              int n_steps, T gamma) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  const long long plane = (long long)n_steps * B;
  T tau = tau_in[t];
  T sigma = sigma_in[t];
  for (int s = 0; s < n_steps; ++s) {
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

// The check window of the megakernels (B3, B5): n_steps full PDHG steps
// over every lane, in one cooperative launch.
//   phase A: one row owner per row of K (all lanes) computes (K x_bar)_i
//            and applies dual_elem; y_i is added into the y sum;
//   grid.sync();
//   phase B: one row owner per row of K^T computes (K^T y)_j and applies
//            primal_elem; x_prev_j, x_j, x_bar_j and the x sum are
//            written by the row's owner;
//   grid.sync();
// A row keeps one owner for the whole window, so the sums need no
// atomics.  The state arrays are updated in place.
template <typename T, typename Fwd, typename Adj>
__device__ __forceinline__ void fused_steps(
    const Fwd& fwd, const Adj& adj, const T* __restrict__ b,
    const T* __restrict__ c, const T* __restrict__ lb,
    const T* __restrict__ ub, const T* __restrict__ Tp,
    const T* __restrict__ S, T* x, T* x_prev, T* x_bar, T* y,
    const T* __restrict__ tau_in, const T* __restrict__ sigma_in,
    T* tau_out, T* sigma_out, T* sched, T* xs, T* ys, int m, int n, int B,
    int n_steps, T gamma) {
  cg::grid_group grid = cg::this_grid();
  step_schedule(tau_in, sigma_in, sched, tau_out, sigma_out, B, n_steps,
                gamma);
  grid.sync();
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long rows_m = (long long)B * m;
  const long long rows_n = (long long)B * n;
  const long long plane = (long long)n_steps * B;
  for (int s = 0; s < n_steps; ++s) {
    const T* tau_s = sched + s * (long long)B;
    const T* sigma_s = tau_s + plane;
    const T* theta_s = tau_s + 2 * plane;
    fwd.for_each_row(rows_m, m, x_bar, n, warp, n_warps,
                     [&](long long i, T kx) {
                       const T yn = dual_elem(y[i], kx, b[i], S[i],
                                              sigma_s[i / m]);
                       y[i] = yn;
                       ys[i] += yn;
                     });
    grid.sync();
    adj.for_each_row(rows_n, n, y, m, warp, n_warps,
                     [&](long long j, T kty) {
                       const long long l = j / n;
                       const T xo = x[j];
                       T xn, xb;
                       primal_elem(xo, kty, c[j], Tp[j], lb[j], ub[j],
                                   tau_s[l], theta_s[l], &xn, &xb);
                       x_prev[j] = xo;
                       x[j] = xn;
                       x_bar[j] = xb;
                       xs[j] += xn;
                     });
    grid.sync();
  }
}

// Largest grid of `kernel` that can be co-resident for a cooperative
// launch (occupancy x SMs), cut to `want` blocks.
inline cudaError_t cooperative_grid(const void* kernel, long long want,
                                    int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  const long long most = (long long)per_sm * sms;
  if (want > most) want = most;
  *grid = (int)(want < 1 ? 1 : want);
  return cudaSuccess;
}

// Blocks that give every row of `rows` an owner when a warp owns
// `per_warp` rows.
inline long long blocks_for_rows(long long rows, int per_warp) {
  const long long per_block = (long long)kWarpsPerBlock * per_warp;
  return (rows + per_block - 1) / per_block;
}

}  // namespace pdhg
