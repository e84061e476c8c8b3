// Hand-written Hopper (sm_90a) kernels for the PDHG solve: the fused
// updates (B1, B2), each also in a step form that the stepped window runs
// beside one schedule launch a window, and the check-window megakernels
// (B3 dense, in a two-matrix and a transpose form, and B5 ELL).
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC
// and loaded through ctypes: every entry point below has a plain C
// signature (pointers as void*, the stream as void*) and returns the
// cudaError_t of its launch, which the Python wrapper turns into an
// exception.  Nothing here allocates or synchronises; the wrappers
// allocate every output (and the megakernels' schedule scratch) with
// torch.empty on PyTorch's current stream.
//
// The per-element algebra and the row products live once, in
// pdhg_common.cuh, which sparse_mvm.cu (B4) includes too.  Every kernel
// takes a leading batch axis of B lanes; step sizes tau, sigma and the
// extrapolation weight theta are (B,) arrays read through device
// pointers, never passed by value: a by-value scalar would force a
// device-to-host read on every step.

#include "pdhg_common.cuh"

namespace {

using pdhg::DenseRows;
using pdhg::EllRows;
using pdhg::kThreads;

// ---------------------------------------------------------------- B1 ---
// Replaces repro/kernels/pdhg_update.py::_dual_kernel (dual_update_padded).
// Bound on the H100: bytes.  It reads four vectors and writes one
// (5 * B * m * sizeof(T)); at every realistic m that is a few microseconds
// of HBM time, so the launch itself dominates.  Design: grid (blocks, B),
// one thread per element in a grid-stride loop within its lane, masking
// the ragged edge itself, so no padding to 256 (the TPU's block).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_update_kernel(const T* __restrict__ y, const T* __restrict__ kxbar,
                   const T* __restrict__ b, const T* __restrict__ S,
                   const T* __restrict__ sigma_p, T* __restrict__ out,
                   long long m) {
  const long long off = (long long)blockIdx.y * m;
  const T sigma = sigma_p[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride)
    out[off + i] = pdhg::dual_elem(y[off + i], kxbar[off + i], b[off + i],
                                   S[off + i], sigma);
}

// ---------------------------------------------------------------- B2 ---
// Replaces repro/kernels/pdhg_update.py::_primal_kernel
// (primal_update_padded).  Bound on the H100: bytes, 6 vectors read and
// 2 written (8 * B * n * sizeof(T)); launch-bound at every realistic n.
// Design: as B1, both outputs written in the same pass.
template <typename T>
__global__ void __launch_bounds__(kThreads)
primal_update_kernel(const T* __restrict__ x, const T* __restrict__ kty,
                     const T* __restrict__ c, const T* __restrict__ t,
                     const T* __restrict__ lb, const T* __restrict__ ub,
                     const T* __restrict__ tau_p,
                     const T* __restrict__ theta_p, T* __restrict__ x_new,
                     T* __restrict__ x_bar, long long n) {
  const long long off = (long long)blockIdx.y * n;
  const T tau = tau_p[blockIdx.y];
  const T theta = theta_p[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const long long k = off + j;
    pdhg::primal_elem(x[k], kty[k], c[k], t[k], lb[k], ub[k], tau, theta,
                      &x_new[k], &x_bar[k]);
  }
}

// ------------------------------------------- B1, B2: the step forms ---
// The stepped window (core/engine.py) runs as one CUDA graph a window on
// the card: one schedule launch, then four launches a step: the forward
// product, dual_step_kernel, the adjoint product, primal_step_kernel.  B1
// and B2 move 154 KB and 492 KB at the main shapes (3840 x 7680 f64), a
// tenth of a microsecond of HBM time, so a launch from the host (about
// 30 us of Python and driver work) and not the body sets their cost; the
// graph takes the host out.  So the step forms do all of a step's vector
// and scalar work in those two launches, and read everything a replay
// needs through device pointers fixed at capture:
//   * schedule_kernel writes every step's tau_s, sigma_s and theta_s of
//     the window up front (pdhg::step_schedule, which B3 and B5 apply
//     too, so the stepped and fused windows share their schedule
//     arithmetic), and the tau and sigma that follow the window.  No
//     step writes a step size that another block of the same launch
//     reads;
//   * dual_step_kernel and primal_step_kernel take step s's slot of the
//     schedule as a pointer and fold the ergodic sums into the same pass
//     (ys += y', xs += x': one IEEE add an element, as the loop's
//     `xs + x` is).  Their outputs go to caller buffers, which the window
//     alternates between steps, so no launch reads what it writes.
// Grid (blocks, B) as B1/B2, one thread an element in a grid-stride loop.

// tau_s, sigma_s, theta_s of every lane and step at sched[(0|1|2) *
// n_steps * B + s * B + lane]; tau and sigma after the window to
// tau_out/sigma_out.  One thread a lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
schedule_kernel(const T* __restrict__ tau_in, const T* __restrict__ sigma_in,
                T* __restrict__ sched, T* __restrict__ tau_out,
                T* __restrict__ sigma_out, int B, int n_steps, T gamma) {
  pdhg::step_schedule(tau_in, sigma_in, nullptr, sched, tau_out, sigma_out,
                      B, n_steps, gamma);
}

// B1's step form: out = dual_elem(y, K x_bar, b, Sigma, sigma_s) and
// ys += out, with sigma_p pointing at step s's sigma of every lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_step_kernel(const T* __restrict__ y, const T* __restrict__ kxbar,
                 const T* __restrict__ b, const T* __restrict__ S,
                 const T* __restrict__ sigma_p, T* __restrict__ out,
                 T* __restrict__ ys, long long m) {
  const long long off = (long long)blockIdx.y * m;
  const T sigma = sigma_p[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const long long k = off + i;
    const T v = pdhg::dual_elem(y[k], kxbar[k], b[k], S[k], sigma);
    out[k] = v;
    ys[k] = ys[k] + v;
  }
}

// B2's step form: x_new, x_bar = primal_elem(x, K^T y', c, T, lb, ub,
// tau_s, theta_s) and xs += x_new.
template <typename T>
__global__ void __launch_bounds__(kThreads)
primal_step_kernel(const T* __restrict__ x, const T* __restrict__ kty,
                   const T* __restrict__ c, const T* __restrict__ t,
                   const T* __restrict__ lb, const T* __restrict__ ub,
                   const T* __restrict__ tau_p,
                   const T* __restrict__ theta_p, T* __restrict__ x_new,
                   T* __restrict__ x_bar, T* __restrict__ xs, long long n) {
  const long long off = (long long)blockIdx.y * n;
  const T tau = tau_p[blockIdx.y];
  const T theta = theta_p[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const long long k = off + j;
    T xn, xb;
    pdhg::primal_elem(x[k], kty[k], c[k], t[k], lb[k], ub[k], tau, theta,
                      &xn, &xb);
    x_new[k] = xn;
    x_bar[k] = xb;
    xs[k] = xs[k] + xn;
  }
}

// ---------------------------------------------------------------- B3 ---
// Replaces repro/kernels/pdhg_megakernel.py::_dense_kernel
// (fused_dense_steps): n_steps full PDHG steps of every live lane, theta
// schedule included, in ONE launch, returning the new state and the
// window's ergodic sums.  Two forms; the caller says which matrix the
// adjoint is, and each form is launched and counted on its own.
//
// The two-matrix form (fused_dense_kernel) reads a distinct K_adj: the
// programmed crossbar blocks.  Bound on the H100: bytes.  Every step
// reads K (B x m x n) and K_adj (B x n x m) once; at 3840 x 7680 in f64
// that is 472 MB a step, nine times the 50 MB L2, so HBM at 3.35 TB/s
// floors a step at 141 us.  Design: pdhg::fused_steps with one warp per
// dense row (coalesced loads), the live lanes' rows spread over the
// whole grid, so a batch of small instances still fills the card.
//
// The transpose form (fused_dense_t_kernel) serves an adjoint that IS
// K^T (solve_jit without K_adj, the dense bucket pipeline) and reads K
// once a step for both products: pdhg::fused_steps_kt, whose note gives
// the design and the sum orders.  Bound on the H100: its operations over
// 67 TFLOP/s when each input is read once (0.18 ms for a 100-step window
// at 3840 x 7680 f64); what it must re-read is K, every step, since K is
// 4.7 times the L2: 236 MB a step, a floor of 70 us at 3.35 TB/s, 7.04 ms
// a 100-step window in f64 and 3.52 ms in f32, below the two GEMVs any
// two-pass design pays.  One block of 512 threads an SM; in the ring form
// (rows up to 8192 elements in f64, 16384 in f32, 16-byte aligned; 4096
// otherwise) each thread holds its 16 (f64) or 32 (f32) elements of the
// partial K^T y in registers, and x_bar and the rows ahead take up to
// 216 KB of shared memory.  Rows longer than that take the wide form,
// which sums each row from HBM and re-reads it from the L1/L2 for the
// update.  Tensor cores do not help a GEMV in f64 and are not used.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_dense_kernel(const T* __restrict__ K, const T* __restrict__ Ka,
                   const T* __restrict__ b, const T* __restrict__ c,
                   const T* __restrict__ lb, const T* __restrict__ ub,
                   const T* __restrict__ Tp, const T* __restrict__ S,
                   T* x, T* x_prev, T* x_bar, T* y,
                   const T* __restrict__ tau_in,
                   const T* __restrict__ sigma_in, T* tau_out,
                   T* sigma_out, T* xs, T* ys, T* sched,
                   const unsigned char* __restrict__ active, int* lanes,
                   int m, int n, int B, int n_steps, T gamma) {
  pdhg::fused_steps(DenseRows<T>{K, n}, DenseRows<T>{Ka, m}, b, c, lb, ub,
                    Tp, S, x, x_prev, x_bar, y, tau_in, sigma_in, tau_out,
                    sigma_out, sched, xs, ys, active, lanes, m, n, B,
                    n_steps, gamma);
}

template <typename T, bool kRing, bool kVec>
__global__ void __launch_bounds__(pdhg::kKtThreads, 1)
fused_dense_t_kernel(const T* __restrict__ K, const T* __restrict__ b,
                     const T* __restrict__ c, const T* __restrict__ lb,
                     const T* __restrict__ ub, const T* __restrict__ Tp,
                     const T* __restrict__ S, T* x, T* x_prev, T* x_bar,
                     T* y, const T* __restrict__ tau_in,
                     const T* __restrict__ sigma_in, T* tau_out,
                     T* sigma_out, T* xs, T* ys, T* sched, T* part,
                     const unsigned char* __restrict__ active, int* lanes,
                     int m, int n, int B, int n_steps, T gamma) {
  pdhg::fused_steps_kt<T, kRing, kVec>(
      K, b, c, lb, ub, Tp, S, x, x_prev, x_bar, y, tau_in, sigma_in,
      tau_out, sigma_out, sched, xs, ys, part, active, lanes, m, n, B,
      n_steps, gamma);
}

// ---------------------------------------------------------------- B5 ---
// Replaces repro/kernels/pdhg_megakernel.py::_ell_kernel
// (fused_ell_steps): as B3, on the forward ELL of K (data_f, cols_f:
// B x m x Wf) and the separately stored ELL of K^T (data_a, cols_a:
// B x n x Wa), each with its row lengths (B x m, B x n; null: every slot),
// over the lanes that `active` (B bytes; null: all) marks live.
//
// Bound on the H100: bytes.  A step must read both forms' stored entries
// (value and int32 column, 12 bytes in f64) and gather x_bar and y.  At
// the sparse stream's main bucket (16 lanes of 16384 x 32768, widths 64
// and 32) that is 2 x 4896600 entries, 117.5 MB, plus 3.1 MB of row
// lengths a step: a 36 us floor at 3.35 TB/s, about 3.6 ms for a
// 100-step window, since the forms are more than twice the 50 MB L2.
// Every slot, padding included, would be 403 MB a step (120 us).  As in
// B4, the gathers (9.8 M random L2 sectors a step) and the element
// operands (about 50 MB a step, evicted by the streamed entries) hold it
// well above that floor.
//
// Design: B3's cooperative step loop, instantiated on pdhg::EllRows, the
// same row product B4 runs (a group of 4-8 threads a row at W = 32-64,
// 16-byte runs of slots, rounds up to the warp's longest row), so a
// fused ELL window and a stepped one (B4 + B1 + B4 + B2) reduce every
// row in the same order.  It is compiled for 8 resident blocks an SM
// (2048 threads, 32 registers a thread, no spills; 6 for the scalar
// form).  Its prologue lists the live lanes so that only their rows are
// spread over the grid: a stopped or filler lane costs nothing, and
// every warp's share shrinks with the live rows.  A row's owner asks the
// L2 for the row's element operands (b, Sigma, y and the y sum; c, T,
// bounds, x and the x sum) before it sums the row, so they arrive in the
// shadow of its gathers.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads,
                                  kVec ? pdhg::kEllBlocksPerSM
                                       : pdhg::kEllScalarFusedBlocksPerSM)
fused_ell_kernel(const T* __restrict__ df, const int* __restrict__ cf,
                 const int* __restrict__ rlf, const T* __restrict__ da,
                 const int* __restrict__ ca, const int* __restrict__ rla,
                 const T* __restrict__ b, const T* __restrict__ c,
                 const T* __restrict__ lb, const T* __restrict__ ub,
                 const T* __restrict__ Tp, const T* __restrict__ S,
                 T* x, T* x_prev, T* x_bar, T* y,
                 const T* __restrict__ tau_in,
                 const T* __restrict__ sigma_in, T* tau_out, T* sigma_out,
                 T* xs, T* ys, T* sched,
                 const unsigned char* __restrict__ active, int* lanes,
                 int m, int n, int wf, int wa, int B, int n_steps,
                 T gamma) {
  pdhg::fused_steps(EllRows<T, kVec>{df, cf, rlf, wf},
                    EllRows<T, kVec>{da, ca, rla, wa}, b, c, lb, ub, Tp, S,
                    x, x_prev, x_bar, y, tau_in, sigma_in, tau_out,
                    sigma_out, sched, xs, ys, active, lanes, m, n, B,
                    n_steps, gamma);
}

int elementwise_blocks(long long len) {
  long long blocks = (len + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < pdhg::kMaxGridDim ? blocks : pdhg::kMaxGridDim);
}

template <typename T>
int dual_update(const void* y, const void* kxbar, const void* b,
                const void* S, const void* sigma, void* out, long long m,
                int B, void* stream) {
  dual_update_kernel<T><<<dim3(elementwise_blocks(m), B), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)y, (const T*)kxbar, (const T*)b, (const T*)S,
      (const T*)sigma, (T*)out, m);
  return (int)cudaGetLastError();
}

template <typename T>
int primal_update(const void* x, const void* kty, const void* c,
                  const void* t, const void* lb, const void* ub,
                  const void* tau, const void* theta, void* x_new,
                  void* x_bar, long long n, int B, void* stream) {
  primal_update_kernel<T><<<dim3(elementwise_blocks(n), B), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const T*)x, (const T*)kty, (const T*)c, (const T*)t, (const T*)lb,
      (const T*)ub, (const T*)tau, (const T*)theta, (T*)x_new, (T*)x_bar, n);
  return (int)cudaGetLastError();
}

template <typename T>
int window_schedule(const void* tau_in, const void* sigma_in, void* sched,
                    void* tau_out, void* sigma_out, int B, int n_steps,
                    double gamma, void* stream) {
  if (B < 1 || n_steps < 0) return (int)cudaErrorInvalidValue;
  schedule_kernel<T><<<(B + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const T*)tau_in, (const T*)sigma_in, (T*)sched, (T*)tau_out,
      (T*)sigma_out, B, n_steps, (T)gamma);
  return (int)cudaGetLastError();
}

template <typename T>
int dual_step(const void* y, const void* kxbar, const void* b, const void* S,
              const void* sigma, void* out, void* ys, long long m, int B,
              void* stream) {
  dual_step_kernel<T><<<dim3(elementwise_blocks(m), B), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const T*)y, (const T*)kxbar, (const T*)b, (const T*)S,
      (const T*)sigma, (T*)out, (T*)ys, m);
  return (int)cudaGetLastError();
}

template <typename T>
int primal_step(const void* x, const void* kty, const void* c, const void* t,
                const void* lb, const void* ub, const void* tau,
                const void* theta, void* x_new, void* x_bar, void* xs,
                long long n, int B, void* stream) {
  primal_step_kernel<T><<<dim3(elementwise_blocks(n), B), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)x, (const T*)kty, (const T*)c, (const T*)t, (const T*)lb,
      (const T*)ub, (const T*)tau, (const T*)theta, (T*)x_new, (T*)x_bar,
      (T*)xs, n);
  return (int)cudaGetLastError();
}

cudaError_t launch_cooperative(const void* kernel, long long want,
                               void** args, void* stream) {
  int grid = 0;
  cudaError_t e = pdhg::cooperative_grid(kernel, want, &grid);
  if (e != cudaSuccess) return e;
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                  0, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int fused_dense(const void* K, const void* Ka, const void* b, const void* c,
                const void* lb, const void* ub, const void* Tp,
                const void* S, void* x, void* x_prev, void* x_bar, void* y,
                const void* tau_in, const void* sigma_in, void* tau_out,
                void* sigma_out, void* xs, void* ys, void* sched,
                const void* active, void* lanes, int m, int n, int B,
                int n_steps, double gamma_d, void* stream) {
  T gamma = (T)gamma_d;
  void* args[] = {(void*)&K,       (void*)&Ka,       (void*)&b,
                  (void*)&c,       (void*)&lb,       (void*)&ub,
                  (void*)&Tp,      (void*)&S,        (void*)&x,
                  (void*)&x_prev,  (void*)&x_bar,    (void*)&y,
                  (void*)&tau_in,  (void*)&sigma_in, (void*)&tau_out,
                  (void*)&sigma_out, (void*)&xs,     (void*)&ys,
                  (void*)&sched,   (void*)&active,   (void*)&lanes,
                  (void*)&m,       (void*)&n,        (void*)&B,
                  (void*)&n_steps, (void*)&gamma};
  if (!pdhg::rows_fit_int(B, m, n) || !pdhg::schedule_fits_int(B, n_steps))
    return (int)cudaErrorInvalidValue;
  // one warp per row of the longer phase
  const long long rows = (long long)B * (m > n ? m : n);
  return (int)launch_cooperative((const void*)fused_dense_kernel<T>,
                                 pdhg::blocks_for_rows(rows, 1), args,
                                 stream);
}

// The transpose form's variant for n (and K's alignment): 2 the ring of
// 16-byte chunks, 1 the ring of single elements, 0 the wide form.
template <typename T>
int dense_t_mode(int n, bool aligned) {
  const bool vec = aligned && ((long long)n * sizeof(T)) % 16 == 0;
  if (vec && n <= pdhg::kt_ring_cols<T, true>()) return 2;
  if (n <= pdhg::kt_ring_cols<T, false>()) return 1;
  return 0;
}

template <typename T>
const void* dense_t_kernel(int mode) {
  return mode == 2   ? (const void*)fused_dense_t_kernel<T, true, true>
         : mode == 1 ? (const void*)fused_dense_t_kernel<T, true, false>
                     : (const void*)fused_dense_t_kernel<T, false, false>;
}

// Dynamic shared memory of the form: x_bar and the ring's stages, ring
// only.  The kernel is allowed that much first (above 48 KB it must be
// asked).
template <typename T>
cudaError_t dense_t_smem(int mode, int n, size_t* smem) {
  *smem = mode ? (size_t)(1 + pdhg::kt_stages<T>(n)) *
                     pdhg::kt_stage_len<T>(n) * sizeof(T)
               : 0;
  return cudaFuncSetAttribute(dense_t_kernel<T>(mode),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <typename T>
int fused_dense_t(const void* K, const void* b, const void* c,
                  const void* lb, const void* ub, const void* Tp,
                  const void* S, void* x, void* x_prev, void* x_bar, void* y,
                  const void* tau_in, const void* sigma_in, void* tau_out,
                  void* sigma_out, void* xs, void* ys, void* sched,
                  void* part, const void* active, void* lanes, int slots,
                  int m, int n, int B, int n_steps, double gamma_d,
                  void* stream) {
  T gamma = (T)gamma_d;
  void* args[] = {(void*)&K,       (void*)&b,        (void*)&c,
                  (void*)&lb,      (void*)&ub,       (void*)&Tp,
                  (void*)&S,       (void*)&x,        (void*)&x_prev,
                  (void*)&x_bar,   (void*)&y,        (void*)&tau_in,
                  (void*)&sigma_in, (void*)&tau_out, (void*)&sigma_out,
                  (void*)&xs,      (void*)&ys,       (void*)&sched,
                  (void*)&part,    (void*)&active,   (void*)&lanes,
                  (void*)&m,       (void*)&n,        (void*)&B,
                  (void*)&n_steps, (void*)&gamma};
  if (m < 1 || n < 1 || slots < B || !pdhg::rows_fit_int(B, m, n) ||
      !pdhg::schedule_fits_int(B, n_steps) ||
      (long long)slots * n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int mode = dense_t_mode<T>(n, (uintptr_t)K % 16 == 0);
  const void* kernel = dense_t_kernel<T>(mode);
  size_t smem = 0;
  cudaError_t e = dense_t_smem<T>(mode, n, &smem);
  if (e != cudaSuccess) return (int)e;
  // at most `slots` blocks: part holds a partial for each unit
  int grid = 0;
  e = pdhg::cooperative_grid(kernel, slots, &grid, pdhg::kKtThreads, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(pdhg::kKtThreads),
                                  args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out[0..5) = registers, local (spill) bytes, resident blocks an SM,
// dynamic shared memory bytes and the form (2, 1, 0 as dense_t_mode) of
// the transpose form at row length n, on a 16-byte aligned K.
template <typename T>
int fused_dense_t_attrs(int n, int* out) {
  const int mode = dense_t_mode<T>(n, true);
  size_t smem = 0;
  cudaError_t e = dense_t_smem<T>(mode, n, &smem);
  if (e != cudaSuccess) return (int)e;
  e = pdhg::kernel_attrs(dense_t_kernel<T>(mode), out, pdhg::kKtThreads,
                         smem);
  out[3] = (int)smem;
  out[4] = mode;
  return (int)e;
}

template <typename T>
int fused_ell(const void* df, const void* cf, const void* rlf,
              const void* da, const void* ca, const void* rla,
              const void* b, const void* c, const void* lb, const void* ub,
              const void* Tp, const void* S, void* x, void* x_prev,
              void* x_bar, void* y, const void* tau_in,
              const void* sigma_in, void* tau_out, void* sigma_out,
              void* xs, void* ys, void* sched, const void* active,
              void* lanes, int m, int n, int wf, int wa, int B, int n_steps,
              double gamma_d, void* stream) {
  T gamma = (T)gamma_d;
  void* args[] = {(void*)&df,      (void*)&cf,       (void*)&rlf,
                  (void*)&da,      (void*)&ca,       (void*)&rla,
                  (void*)&b,       (void*)&c,        (void*)&lb,
                  (void*)&ub,      (void*)&Tp,       (void*)&S,
                  (void*)&x,       (void*)&x_prev,   (void*)&x_bar,
                  (void*)&y,       (void*)&tau_in,   (void*)&sigma_in,
                  (void*)&tau_out, (void*)&sigma_out, (void*)&xs,
                  (void*)&ys,      (void*)&sched,    (void*)&active,
                  (void*)&lanes,   (void*)&m,        (void*)&n,
                  (void*)&wf,      (void*)&wa,       (void*)&B,
                  (void*)&n_steps, (void*)&gamma};
  if (!pdhg::rows_fit_int(B, m, n) || !pdhg::schedule_fits_int(B, n_steps))
    return (int)cudaErrorInvalidValue;
  // the row sums are the same in either form (pdhg::EllRows)
  const bool vec = pdhg::ell_vectorised<T>(df, cf, wf) &&
                   pdhg::ell_vectorised<T>(da, ca, wa);
  const long long want_f = pdhg::blocks_for_rows(
      (long long)B * m, 32 / pdhg::ell_group(wf));
  const long long want_a = pdhg::blocks_for_rows(
      (long long)B * n, 32 / pdhg::ell_group(wa));
  return (int)launch_cooperative(
      vec ? (const void*)fused_ell_kernel<T, true>
          : (const void*)fused_ell_kernel<T, false>,
      want_f > want_a ? want_f : want_a, args, stream);
}

template <typename T>
int fused_ell_attrs(int vec, int* out) {
  return (int)pdhg::kernel_attrs(
      vec ? (const void*)fused_ell_kernel<T, true>
          : (const void*)fused_ell_kernel<T, false>,
      out);
}

}  // namespace

extern "C" {

const char* pdhg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pdhg_dual_update_f32(const void* y, const void* kxbar, const void* b,
                         const void* S, const void* sigma, void* out,
                         long long m, int B, void* stream) {
  return dual_update<float>(y, kxbar, b, S, sigma, out, m, B, stream);
}

int pdhg_dual_update_f64(const void* y, const void* kxbar, const void* b,
                         const void* S, const void* sigma, void* out,
                         long long m, int B, void* stream) {
  return dual_update<double>(y, kxbar, b, S, sigma, out, m, B, stream);
}

int pdhg_primal_update_f32(const void* x, const void* kty, const void* c,
                           const void* t, const void* lb, const void* ub,
                           const void* tau, const void* theta, void* x_new,
                           void* x_bar, long long n, int B, void* stream) {
  return primal_update<float>(x, kty, c, t, lb, ub, tau, theta, x_new, x_bar,
                              n, B, stream);
}

int pdhg_primal_update_f64(const void* x, const void* kty, const void* c,
                           const void* t, const void* lb, const void* ub,
                           const void* tau, const void* theta, void* x_new,
                           void* x_bar, long long n, int B, void* stream) {
  return primal_update<double>(x, kty, c, t, lb, ub, tau, theta, x_new,
                               x_bar, n, B, stream);
}

#define PDHG_STEP_PAIR(SUFFIX, T)                                            \
  int pdhg_schedule_##SUFFIX(const void* tau_in, const void* sigma_in,      \
                             void* sched, void* tau_out, void* sigma_out,    \
                             int B, int n_steps, double gamma,               \
                             void* stream) {                                 \
    return window_schedule<T>(tau_in, sigma_in, sched, tau_out, sigma_out,  \
                              B, n_steps, gamma, stream);                    \
  }                                                                          \
  int pdhg_dual_step_##SUFFIX(const void* y, const void* kxbar,              \
                              const void* b, const void* S,                  \
                              const void* sigma, void* out, void* ys,        \
                              long long m, int B, void* stream) {            \
    return dual_step<T>(y, kxbar, b, S, sigma, out, ys, m, B, stream);       \
  }                                                                          \
  int pdhg_primal_step_##SUFFIX(                                             \
      const void* x, const void* kty, const void* c, const void* t,          \
      const void* lb, const void* ub, const void* tau, const void* theta,    \
      void* x_new, void* x_bar, void* xs, long long n, int B,                \
      void* stream) {                                                        \
    return primal_step<T>(x, kty, c, t, lb, ub, tau, theta, x_new, x_bar,    \
                          xs, n, B, stream);                                 \
  }
PDHG_STEP_PAIR(f32, float)
PDHG_STEP_PAIR(f64, double)

#define PDHG_FUSED_DENSE(SUFFIX, T)                                          \
  int pdhg_fused_dense_##SUFFIX(                                             \
      const void* K, const void* Ka, const void* b, const void* c,           \
      const void* lb, const void* ub, const void* Tp, const void* S,         \
      void* x, void* x_prev, void* x_bar, void* y, const void* tau_in,       \
      const void* sigma_in, void* tau_out, void* sigma_out, void* xs,        \
      void* ys, void* sched, const void* active, void* lanes, int m, int n,  \
      int B, int n_steps, double gamma, void* stream) {                      \
    return fused_dense<T>(K, Ka, b, c, lb, ub, Tp, S, x, x_prev, x_bar, y,   \
                          tau_in, sigma_in, tau_out, sigma_out, xs, ys,      \
                          sched, active, lanes, m, n, B, n_steps, gamma,     \
                          stream);                                           \
  }                                                                          \
  int pdhg_fused_dense_t_##SUFFIX(                                           \
      const void* K, const void* b, const void* c, const void* lb,           \
      const void* ub, const void* Tp, const void* S, void* x, void* x_prev,  \
      void* x_bar, void* y, const void* tau_in, const void* sigma_in,        \
      void* tau_out, void* sigma_out, void* xs, void* ys, void* sched,       \
      void* part, const void* active, void* lanes, int slots, int m, int n,  \
      int B, int n_steps, double gamma, void* stream) {                      \
    return fused_dense_t<T>(K, b, c, lb, ub, Tp, S, x, x_prev, x_bar, y,     \
                            tau_in, sigma_in, tau_out, sigma_out, xs, ys,    \
                            sched, part, active, lanes, slots, m, n, B,      \
                            n_steps, gamma, stream);                         \
  }                                                                          \
  int pdhg_fused_dense_t_attrs_##SUFFIX(int n, int* out) {                   \
    return fused_dense_t_attrs<T>(n, out);                                   \
  }
PDHG_FUSED_DENSE(f32, float)
PDHG_FUSED_DENSE(f64, double)

#define PDHG_FUSED_ELL(SUFFIX, T)                                            \
  int pdhg_fused_ell_##SUFFIX(                                               \
      const void* df, const void* cf, const void* rlf, const void* da,       \
      const void* ca, const void* rla, const void* b, const void* c,         \
      const void* lb, const void* ub, const void* Tp, const void* S,         \
      void* x, void* x_prev, void* x_bar, void* y, const void* tau_in,       \
      const void* sigma_in, void* tau_out, void* sigma_out, void* xs,        \
      void* ys, void* sched, const void* active, void* lanes, int m, int n,  \
      int wf, int wa, int B, int n_steps, double gamma, void* stream) {      \
    return fused_ell<T>(df, cf, rlf, da, ca, rla, b, c, lb, ub, Tp, S, x,    \
                        x_prev, x_bar, y, tau_in, sigma_in, tau_out,         \
                        sigma_out, xs, ys, sched, active, lanes, m, n, wf,   \
                        wa, B, n_steps, gamma, stream);                      \
  }                                                                          \
  int pdhg_fused_ell_attrs_##SUFFIX(int vec, int* out) {                     \
    return fused_ell_attrs<T>(vec, out);                                     \
  }
PDHG_FUSED_ELL(f32, float)
PDHG_FUSED_ELL(f64, double)

}  // extern "C"
