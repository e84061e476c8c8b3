// B4: the row-blocked ELL sparse MVM, hand-written for Hopper (sm_90a).
//
//   w[b, i] = sum_{k < len[b, i]} data[b, i, k] * v[b, cols[b, i, k]]
//
// Replaces src/repro/kernels/sparse_mvm.py:119 (_ell_kernel, called
// through ell_matvec_padded and ell_matvec), the row-blocked ELL matvec
// of the sparse batch pipeline: every MVM of its norm estimate and of
// its solve.  len is the row's length up to its last stored entry
// (sparse_mvm.ell_row_len, kept with the operator), or W for every row.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC
// into the same shared library as pdhg_kernels.cu and loaded through
// ctypes: pointers as void*, sizes as int / long long, the stream as
// void*, and the cudaError_t of the launch as the return value.  Nothing
// here allocates or synchronises.
//
// Bound on the H100: bytes.  The kernel must read each stored entry's
// value and int32 column once (12 bytes in f64, 8 in f32), gather v and
// write w.  At the sparse stream's main bucket (16 lanes; forward
// 16384 x 64 slots, adjoint 32768 x 32) 4896600 of the 16777216 slots of
// either form hold an entry: 58.8 MB in f64, a 17.5 us floor at
// 3.35 TB/s, against 201 MB (60 us) for every slot.  The arithmetic (two
// operations an entry) is far below the FP64 peak.  What the card
// spends beyond that floor goes mostly to the gathers of v: one random
// 8-byte read an entry, each a 32-byte L2 sector (v, 256 KB a lane in
// f64, stays in the L2), so 4.9 M sectors a product; with every column
// pointed at its row's own index the same kernel runs 20-30 % faster
// (chip_smoke.py's local_gather_ms).
//
// Design.  The TPU kernel gives each program 128 rows and the whole of v
// in VMEM.  Here the grid is (row blocks, B): blockIdx.y is the lane,
// which has its own batch strides for data/cols, v and w, so a strided v
// (a slice of the Lanczos vector) needs no copy.  The row product is
// pdhg::EllRows, the very function the ELL megakernel B5 runs, so a
// stepped ELL window and a fused one sum each row in the same order: a
// group of 4-8 threads a row at W = 32-64 (a warp holds 4-8 rows), each
// thread a 16-byte run of slots a round (2 in f64, 4 in f32) with its
// loads, then its gathers, then its FMAs in flight, vector loads where
// the rows are aligned, and rounds only up to the warp's longest row, so
// the padding past a row's last entry is never read.  Compiled for 8
// resident blocks an SM (32 registers a thread, no spills).  Width 0
// launches nothing: the wrapper returns zeros.

#include "pdhg_common.cuh"

namespace {

using pdhg::kThreads;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, pdhg::kEllBlocksPerSM)
ell_matvec_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                  const int* __restrict__ row_len, const T* __restrict__ v,
                  T* __restrict__ out, int m, int W, long long d_stride,
                  long long v_stride, long long o_stride) {
  const long long lane_b = blockIdx.y;
  const pdhg::EllRows<T, kVec> rows{
      data + lane_b * d_stride, cols + lane_b * d_stride,
      row_len == nullptr ? nullptr : row_len + lane_b * m, W};
  T* w = out + lane_b * o_stride;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  rows.for_each_row(m, m, nullptr, v + lane_b * v_stride, 0, warp, n_warps,
                    [](int) {}, [&](int, int i, T acc) { w[i] = acc; });
}

template <typename T, bool kVec>
int ell_matvec_launch(const void* data, const void* cols,
                      const void* row_len, const void* v, void* out, int m,
                      int W, int B, long long d_stride, long long v_stride,
                      long long o_stride, void* stream) {
  if (!pdhg::rows_fit_int(1, m, 0)) return (int)cudaErrorInvalidValue;
  long long blocks = pdhg::blocks_for_rows(m, 32 / pdhg::ell_group(W));
  if (blocks < 1) blocks = 1;
  if (blocks > pdhg::kMaxGridDim) blocks = pdhg::kMaxGridDim;
  ell_matvec_kernel<T, kVec><<<dim3((unsigned)blocks, B), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)data, (const int*)cols, (const int*)row_len, (const T*)v,
      (T*)out, m, W, d_stride, v_stride, o_stride);
  return (int)cudaGetLastError();
}

template <typename T>
int ell_matvec(const void* data, const void* cols, const void* row_len,
               const void* v, void* out, int m, int W, int B,
               long long d_stride, long long v_stride, long long o_stride,
               void* stream) {
  return pdhg::ell_vectorised<T>(data, cols, W)
             ? ell_matvec_launch<T, true>(data, cols, row_len, v, out, m, W,
                                          B, d_stride, v_stride, o_stride,
                                          stream)
             : ell_matvec_launch<T, false>(data, cols, row_len, v, out, m,
                                           W, B, d_stride, v_stride,
                                           o_stride, stream);
}

template <typename T>
int ell_matvec_attrs(int vec, int* out) {
  return (int)pdhg::kernel_attrs(
      vec ? (const void*)ell_matvec_kernel<T, true>
          : (const void*)ell_matvec_kernel<T, false>,
      out);
}

}  // namespace

extern "C" {

int ell_matvec_f32(const void* data, const void* cols, const void* row_len,
                   const void* v, void* out, int m, int W, int B,
                   long long d_stride, long long v_stride,
                   long long o_stride, void* stream) {
  return ell_matvec<float>(data, cols, row_len, v, out, m, W, B, d_stride,
                           v_stride, o_stride, stream);
}

int ell_matvec_f64(const void* data, const void* cols, const void* row_len,
                   const void* v, void* out, int m, int W, int B,
                   long long d_stride, long long v_stride,
                   long long o_stride, void* stream) {
  return ell_matvec<double>(data, cols, row_len, v, out, m, W, B, d_stride,
                            v_stride, o_stride, stream);
}

// registers, local (spill) bytes and resident blocks an SM of the kernel
// (vec: the 16-byte-load form)
int ell_matvec_attrs_f32(int vec, int* out) {
  return ell_matvec_attrs<float>(vec, out);
}

int ell_matvec_attrs_f64(int vec, int* out) {
  return ell_matvec_attrs<double>(vec, out);
}

}  // extern "C"
