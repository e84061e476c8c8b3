// B4: the row-blocked ELL sparse MVM, hand-written for Hopper (sm_90a).
//
//   w[b, i] = sum_k data[b, i, k] * v[b, cols[b, i, k]],  k < W
//
// Replaces src/repro/kernels/sparse_mvm.py:119 (_ell_kernel, called
// through ell_matvec_padded and ell_matvec), the row-blocked ELL matvec
// of the sparse batch pipeline: every MVM of its norm estimate and of
// its solve.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC
// into the same shared library as pdhg_kernels.cu and loaded through
// ctypes: pointers as void*, sizes as int / long long, the stream as
// void*, and the cudaError_t of the launch as the return value.  Nothing
// here allocates or synchronises.
//
// Bound on the H100: bytes.  The kernel must read the ELL values and
// their int32 columns once (12 bytes a slot in f64, 8 in f32), gather v
// and write w; at the full-width forward ELL (8 lanes x 16384 x 64 slots)
// that is 101 MB of slots, about 30 us at 3.35 TB/s, while the
// arithmetic (two operations a slot) is far below the FP64 peak.  The
// gathers of v (8 lanes x 32768 in f64, 2 MB) come from the L2.
//
// Design.  The TPU kernel gives each program 128 rows and the whole of v
// in VMEM.  Here the grid is (row blocks, B): blockIdx.y is the lane,
// which has its own batch strides for data/cols, v and w, so a strided v
// (a slice of the Lanczos vector) needs no copy.  A group of min(W, 32)
// threads (rounded up to a power of two) owns a row; its threads stride
// the row's slots, coalesced, accumulate in T (never below the input
// type) and reduce with shuffles.  The row product is pdhg::EllRows, the
// very function the ELL megakernel B5 runs, so a stepped ELL window and a
// fused one sum each row in the same order.  Every slot is multiplied,
// padding (data 0, col 0) included, as the reference does.  Width 0
// launches nothing: the wrapper returns zeros.

#include "pdhg_common.cuh"

namespace {

using pdhg::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                  const T* __restrict__ v, T* __restrict__ out, int m, int W,
                  long long d_stride, long long v_stride,
                  long long o_stride) {
  const long long lane_b = blockIdx.y;
  const pdhg::EllRows<T> rows{data + lane_b * d_stride,
                              cols + lane_b * d_stride, W};
  T* w = out + lane_b * o_stride;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  rows.for_each_row(m, m, v + lane_b * v_stride, 0, warp, n_warps,
                    [&](long long i, T acc) { w[i] = acc; });
}

template <typename T>
int ell_matvec(const void* data, const void* cols, const void* v, void* out,
               int m, int W, int B, long long d_stride, long long v_stride,
               long long o_stride, void* stream) {
  long long blocks = pdhg::blocks_for_rows(m, 32 / pdhg::ell_group(W));
  if (blocks < 1) blocks = 1;
  if (blocks > pdhg::kMaxGridDim) blocks = pdhg::kMaxGridDim;
  ell_matvec_kernel<T><<<dim3((unsigned)blocks, B), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const T*)data, (const int*)cols, (const T*)v, (T*)out, m, W, d_stride,
      v_stride, o_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ell_matvec_f32(const void* data, const void* cols, const void* v,
                   void* out, int m, int W, int B, long long d_stride,
                   long long v_stride, long long o_stride, void* stream) {
  return ell_matvec<float>(data, cols, v, out, m, W, B, d_stride, v_stride,
                           o_stride, stream);
}

int ell_matvec_f64(const void* data, const void* cols, const void* v,
                   void* out, int m, int W, int B, long long d_stride,
                   long long v_stride, long long o_stride, void* stream) {
  return ell_matvec<double>(data, cols, v, out, m, W, B, d_stride, v_stride,
                            o_stride, stream);
}

}  // extern "C"
