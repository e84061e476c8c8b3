// B6: the differential-pair crossbar MVM, hand-written for Hopper (sm_90a).
//
//   w[b, i] = gain[b, i] * sum_k (G+[b, i, k] - G-[b, i, k]) * v[b, k]
//
// Replaces src/repro/kernels/crossbar_mvm.py:41 (_mvm_kernel, called
// through crossbar_mvm_padded and kernels/ops.py::crossbar_mvm), where
// gain = scale * (1 + noise) carries the conductance scale and the
// per-row multiplicative read noise, applied once.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC
// into the same shared library as pdhg_kernels.cu and loaded through
// ctypes: the entry points below take pointers as void*, sizes as long
// long, the stream as void*, and return the cudaError_t of the launch.
// Nothing here allocates or synchronises.
//
// Bound on the H100: bytes.  The kernel must read G+ and G- once each,
// 2 * R * C * sizeof(T) bytes; v (C) and gain (R) are noise beside
// them.  At the main path's 11520 x 11520 in f64 that is 2.12 GB, a
// 0.634 ms floor at 3.35 TB/s (0.317 ms in f32); the arithmetic, 3 * R
// * C operations, is about 6 us at the FP64 peak.
//
// Design.  The TPU kernel walks 128 x 128 tiles with the column-tile
// axis innermost and carries each row block's sum in a resident output
// block.  Blocks on Hopper run in no order, so here ONE WARP OWNS ONE
// ROW and loops over all of its columns: the lanes stride the row with
// 16-byte loads (double2 / float4) when every row and v are 16-byte
// aligned, and with scalar loads otherwise; each lane accumulates
// (G+ - G-) * v in the input type (f32 -> f32, f64 -> f64, never below
// it), the warp reduces with shuffles, and lane 0 applies gain[i] once.
// Every row has one owner, so there are no atomics and no second pass.
// Ragged R and C are masked here, so the caller never pads G+/G- (at
// full width a padded copy would be a 2 GB copy per MVM).  v (at most
// 92 KB in f64) is read through the read-only cache; every warp re-reads
// it, from L2.  The grid's y axis is a leading batch axis with its own
// strides (B = 1 on the host driver's path; the batched crossbar
// pipeline can mount the same kernel).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 8 warps, 8 rows per block
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int width = 2;
};
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int width = 4;
};

__device__ __forceinline__ double diff_dot(double2 p, double2 n, double2 v,
                                           double acc) {
  acc += (p.x - n.x) * v.x;
  acc += (p.y - n.y) * v.y;
  return acc;
}

__device__ __forceinline__ float diff_dot(float4 p, float4 n, float4 v,
                                          float acc) {
  acc += (p.x - n.x) * v.x;
  acc += (p.y - n.y) * v.y;
  acc += (p.z - n.z) * v.z;
  acc += (p.w - n.w) * v.w;
  return acc;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
crossbar_mvm_kernel(const T* __restrict__ gp, const T* __restrict__ gn,
                    const T* __restrict__ v, const T* __restrict__ gain,
                    T* __restrict__ out, long long R, long long C,
                    long long g_bstride, long long v_bstride,
                    long long r_bstride) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;                   // whole warps leave together
  const long long b = blockIdx.y;
  const T* p = gp + b * g_bstride + row * C;
  const T* n = gn + b * g_bstride + row * C;
  const T* x = v + b * v_bstride;
  T acc = T(0);
  if constexpr (kVectorized) {
    using V = typename Vec16<T>::type;
    const V* pv = reinterpret_cast<const V*>(p);
    const V* nv = reinterpret_cast<const V*>(n);
    const V* xv = reinterpret_cast<const V*>(x);
    const long long len = C / Vec16<T>::width;
#pragma unroll 4
    for (long long k = lane; k < len; k += 32)
      acc = diff_dot(pv[k], nv[k], __ldg(xv + k), acc);
  } else {
#pragma unroll 4
    for (long long k = lane; k < C; k += 32)
      acc += (p[k] - n[k]) * __ldg(x + k);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[b * r_bstride + row] = gain[b * r_bstride + row] * acc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int crossbar_mvm(const void* gp, const void* gn, const void* v,
                 const void* gain, void* out, long long R, long long C,
                 int batch, long long g_bstride, long long v_bstride,
                 long long r_bstride, void* stream) {
  if (R <= 0 || batch <= 0) return (int)cudaSuccess;
  const long long w = Vec16<T>::width;
  // 16-byte loads need every row start and v's start on a 16-byte
  // boundary: the bases aligned and C and the batch strides multiples
  // of the vector width
  const bool vec = C % w == 0 && g_bstride % w == 0 && v_bstride % w == 0 &&
                   aligned16(gp) && aligned16(gn) && aligned16(v);
  const dim3 grid((unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)batch);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    crossbar_mvm_kernel<T, true><<<grid, kThreads, 0, s>>>(
        (const T*)gp, (const T*)gn, (const T*)v, (const T*)gain, (T*)out, R,
        C, g_bstride, v_bstride, r_bstride);
  else
    crossbar_mvm_kernel<T, false><<<grid, kThreads, 0, s>>>(
        (const T*)gp, (const T*)gn, (const T*)v, (const T*)gain, (T*)out, R,
        C, g_bstride, v_bstride, r_bstride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int crossbar_mvm_f32(const void* gp, const void* gn, const void* v,
                     const void* gain, void* out, long long R, long long C,
                     int batch, long long g_bstride, long long v_bstride,
                     long long r_bstride, void* stream) {
  return crossbar_mvm<float>(gp, gn, v, gain, out, R, C, batch, g_bstride,
                             v_bstride, r_bstride, stream);
}

int crossbar_mvm_f64(const void* gp, const void* gn, const void* v,
                     const void* gain, void* out, long long R, long long C,
                     int batch, long long g_bstride, long long v_bstride,
                     long long r_bstride, void* stream) {
  return crossbar_mvm<double>(gp, gn, v, gain, out, R, C, batch, g_bstride,
                              v_bstride, r_bstride, stream);
}

}  // extern "C"
