// Hand-written Hopper (sm_90a) kernels for the dense PDHG solve.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded through ctypes: every entry point below has a plain C
// signature (pointers as void*, the stream as void*) and returns the
// cudaError_t of its launch, which the Python wrapper turns into an
// exception.  Nothing here allocates or synchronises; the wrappers
// allocate every output with torch.empty on PyTorch's current stream.
//
// The per-element algebra of one PDHG step lives ONCE, in dual_elem and
// primal_elem.  The two update kernels (B1, B2) and the check-window
// megakernel (B3) all call them, so a stepped window and a fused window
// apply the same arithmetic to every element by construction.
//
// Step sizes tau, sigma and the extrapolation weight theta are read
// through device pointers (0-d tensors), never passed by value: a
// by-value scalar would force a device-to-host read on every step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;             // threads per block, all kernels
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxElementwiseBlocks = 65535;

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Dot product of one row with a vector, by one warp: lanes stride the
// row so that each load instruction reads 32 neighbouring elements;
// lane 0 holds the sum on return.  Accumulates in T, which is
// promote(T, float) for both instantiations.
template <typename T>
__device__ __forceinline__ T warp_row_dot(const T* __restrict__ row,
                                          const T* v, int len, int lane) {
  T acc = T(0);
#pragma unroll 4
  for (int k = lane; k < len; k += 32) acc += row[k] * v[k];
  return warp_sum(acc);
}

// ---------------------------------------------------------------- B1 ---
// Replaces repro/kernels/pdhg_update.py::_dual_kernel (dual_update_padded).
// Bound on the H100: bytes.  It reads four vectors and writes one
// (5 * m * sizeof(T)); at every realistic m that is a few microseconds of
// HBM time, so the launch itself dominates.  Design: one thread per
// element in a grid-stride loop, masking the ragged edge itself, so no
// padding to 256 (the TPU's block) is needed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_update_kernel(const T* __restrict__ y, const T* __restrict__ kxbar,
                   const T* __restrict__ b, const T* __restrict__ S,
                   const T* __restrict__ sigma_p, T* __restrict__ out,
                   long long m) {
  const T sigma = *sigma_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride)
    out[i] = dual_elem(y[i], kxbar[i], b[i], S[i], sigma);
}

// ---------------------------------------------------------------- B2 ---
// Replaces repro/kernels/pdhg_update.py::_primal_kernel
// (primal_update_padded).  Bound on the H100: bytes, 6 vectors read and
// 2 written (8 * n * sizeof(T)); launch-bound at every realistic n.
// Design: as B1, both outputs written in the same pass.
template <typename T>
__global__ void __launch_bounds__(kThreads)
primal_update_kernel(const T* __restrict__ x, const T* __restrict__ kty,
                     const T* __restrict__ c, const T* __restrict__ t,
                     const T* __restrict__ lb, const T* __restrict__ ub,
                     const T* __restrict__ tau_p,
                     const T* __restrict__ theta_p, T* __restrict__ x_new,
                     T* __restrict__ x_bar, long long n) {
  const T tau = *tau_p;
  const T theta = *theta_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride)
    primal_elem(x[j], kty[j], c[j], t[j], lb[j], ub[j], tau, theta,
                &x_new[j], &x_bar[j]);
}

// ---------------------------------------------------------------- B3 ---
// Replaces repro/kernels/pdhg_megakernel.py::_dense_kernel
// (fused_dense_steps): n_steps full PDHG steps, theta schedule included,
// in ONE launch, returning the new state and the window's ergodic sums.
//
// Bound on the H100: bytes.  Every step reads K (m x n) and K_adj
// (n x m) once; at 4096 x 8192 in f64 that is 537 MB a step, ten times
// the 50 MB L2, so HBM at 3.35 TB/s bounds a step at about 160 us.
// The vectors (x_bar, y) are re-read by every warp but stay in L2.
//
// Design: a cooperative launch of at most (resident blocks per SM x SM
// count) blocks, the only grid size at which grid.sync() cannot hang.
//   phase A: one warp per row of K computes (K x_bar)_i with coalesced
//            loads and applies dual_elem; y_i is added into the y sum;
//   grid.sync();
//   phase B: one warp per row of the contiguous K_adj computes
//            (K^T y)_j, then theta = 1/sqrt(1 + 2 gamma tau) and
//            primal_elem; x_prev_j, x_j, x_bar_j and the x sum are
//            written by the row's owner;
//   grid.sync();
// and every thread then advances its own copy of tau <- theta tau,
// sigma <- sigma / theta identically.  A row keeps one owner warp for
// the whole window, so the sums need no atomics.  The state arrays are
// updated in place: the wrapper hands the kernel copies.  Reading K
// once for both products, TMA and tensor cores on the f32 path are
// left for later.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_dense_kernel(const T* __restrict__ K, const T* __restrict__ Ka,
                   const T* __restrict__ b, const T* __restrict__ c,
                   const T* __restrict__ lb, const T* __restrict__ ub,
                   const T* __restrict__ Tp, const T* __restrict__ S,
                   T* x, T* x_prev, T* x_bar, T* y,
                   const T* __restrict__ tau_in,
                   const T* __restrict__ sigma_in, T* tau_out,
                   T* sigma_out, T* xs, T* ys, int m, int n, int n_steps,
                   T gamma) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  T tau = *tau_in;
  T sigma = *sigma_in;
  for (int s = 0; s < n_steps; ++s) {
    for (long long i = warp; i < m; i += n_warps) {
      const T kx = warp_row_dot(K + i * (long long)n, x_bar, n, lane);
      if (lane == 0) {
        const T yn = dual_elem(y[i], kx, b[i], S[i], sigma);
        y[i] = yn;
        ys[i] += yn;
      }
    }
    grid.sync();
    const T theta = T(1) / sqrt(T(1) + T(2) * gamma * tau);
    for (long long j = warp; j < n; j += n_warps) {
      const T kty = warp_row_dot(Ka + j * (long long)m, y, m, lane);
      if (lane == 0) {
        const T xo = x[j];
        T xn, xb;
        primal_elem(xo, kty, c[j], Tp[j], lb[j], ub[j], tau, theta, &xn,
                    &xb);
        x_prev[j] = xo;
        x[j] = xn;
        x_bar[j] = xb;
        xs[j] += xn;
      }
    }
    tau = theta * tau;
    sigma = sigma / theta;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *tau_out = tau;
    *sigma_out = sigma;
  }
}

int elementwise_blocks(long long len) {
  long long blocks = (len + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < kMaxElementwiseBlocks ? blocks
                                              : kMaxElementwiseBlocks);
}

template <typename T>
int dual_update(const void* y, const void* kxbar, const void* b,
                const void* S, const void* sigma, void* out, long long m,
                void* stream) {
  dual_update_kernel<T><<<elementwise_blocks(m), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)y, (const T*)kxbar, (const T*)b, (const T*)S,
      (const T*)sigma, (T*)out, m);
  return (int)cudaGetLastError();
}

template <typename T>
int primal_update(const void* x, const void* kty, const void* c,
                  const void* t, const void* lb, const void* ub,
                  const void* tau, const void* theta, void* x_new,
                  void* x_bar, long long n, void* stream) {
  primal_update_kernel<T><<<elementwise_blocks(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const T*)x, (const T*)kty, (const T*)c, (const T*)t, (const T*)lb,
      (const T*)ub, (const T*)tau, (const T*)theta, (T*)x_new, (T*)x_bar, n);
  return (int)cudaGetLastError();
}

// Largest grid that can be co-resident for a cooperative launch, cut to
// the rows there are (one warp per row).
template <typename T>
cudaError_t fused_grid(int m, int n, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_dense_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return e;
  const long long rows = m > n ? m : n;
  long long want = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long most = (long long)per_sm * sms;
  if (want > most) want = most;
  *grid = (int)(want < 1 ? 1 : want);
  return cudaSuccess;
}

template <typename T>
int fused_dense(const void* K, const void* Ka, const void* b, const void* c,
                const void* lb, const void* ub, const void* Tp,
                const void* S, void* x, void* x_prev, void* x_bar, void* y,
                const void* tau_in, const void* sigma_in, void* tau_out,
                void* sigma_out, void* xs, void* ys, int m, int n,
                int n_steps, double gamma_d, void* stream) {
  int grid = 0;
  cudaError_t e = fused_grid<T>(m, n, &grid);
  if (e != cudaSuccess) return (int)e;
  T gamma = (T)gamma_d;
  void* args[] = {(void*)&K,       (void*)&Ka,       (void*)&b,
                  (void*)&c,       (void*)&lb,       (void*)&ub,
                  (void*)&Tp,      (void*)&S,        (void*)&x,
                  (void*)&x_prev,  (void*)&x_bar,    (void*)&y,
                  (void*)&tau_in,  (void*)&sigma_in, (void*)&tau_out,
                  (void*)&sigma_out, (void*)&xs,     (void*)&ys,
                  (void*)&m,       (void*)&n,        (void*)&n_steps,
                  (void*)&gamma};
  e = cudaLaunchCooperativeKernel((const void*)fused_dense_kernel<T>,
                                  dim3(grid), dim3(kThreads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pdhg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pdhg_dual_update_f32(const void* y, const void* kxbar, const void* b,
                         const void* S, const void* sigma, void* out,
                         long long m, void* stream) {
  return dual_update<float>(y, kxbar, b, S, sigma, out, m, stream);
}

int pdhg_dual_update_f64(const void* y, const void* kxbar, const void* b,
                         const void* S, const void* sigma, void* out,
                         long long m, void* stream) {
  return dual_update<double>(y, kxbar, b, S, sigma, out, m, stream);
}

int pdhg_primal_update_f32(const void* x, const void* kty, const void* c,
                           const void* t, const void* lb, const void* ub,
                           const void* tau, const void* theta, void* x_new,
                           void* x_bar, long long n, void* stream) {
  return primal_update<float>(x, kty, c, t, lb, ub, tau, theta, x_new, x_bar,
                              n, stream);
}

int pdhg_primal_update_f64(const void* x, const void* kty, const void* c,
                           const void* t, const void* lb, const void* ub,
                           const void* tau, const void* theta, void* x_new,
                           void* x_bar, long long n, void* stream) {
  return primal_update<double>(x, kty, c, t, lb, ub, tau, theta, x_new,
                               x_bar, n, stream);
}

int pdhg_fused_dense_f32(const void* K, const void* Ka, const void* b,
                         const void* c, const void* lb, const void* ub,
                         const void* Tp, const void* S, void* x,
                         void* x_prev, void* x_bar, void* y,
                         const void* tau_in, const void* sigma_in,
                         void* tau_out, void* sigma_out, void* xs, void* ys,
                         int m, int n, int n_steps, double gamma,
                         void* stream) {
  return fused_dense<float>(K, Ka, b, c, lb, ub, Tp, S, x, x_prev, x_bar, y,
                            tau_in, sigma_in, tau_out, sigma_out, xs, ys, m,
                            n, n_steps, gamma, stream);
}

int pdhg_fused_dense_f64(const void* K, const void* Ka, const void* b,
                         const void* c, const void* lb, const void* ub,
                         const void* Tp, const void* S, void* x,
                         void* x_prev, void* x_bar, void* y,
                         const void* tau_in, const void* sigma_in,
                         void* tau_out, void* sigma_out, void* xs, void* ys,
                         int m, int n, int n_steps, double gamma,
                         void* stream) {
  return fused_dense<double>(K, Ka, b, c, lb, ub, Tp, S, x, x_prev, x_bar, y,
                             tau_in, sigma_in, tau_out, sigma_out, xs, ys, m,
                             n, n_steps, gamma, stream);
}

}  // extern "C"
