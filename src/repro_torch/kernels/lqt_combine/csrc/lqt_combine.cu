// Batched LQT combine (paper eq. 42) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/lqt_combine/kernel.py::lqt_combine_lanes.
// It computes the same function, not the same blocking: the eq.-(42)
// combine of each of B element pairs (A, b, C, eta, J)_{1,2}, with the
// one-thread-per-pair arithmetic of lqt_combine.cuh (combine_thread), which
// the whole-scan kernel lqt_scan.cu shares.
//
// Layout: lane-major, as on the TPU.  Entry (i, j) of a matrix operand of
// pair l lives at X[(i * NX + j) * B + l], entry i of a vector at
// v[i * B + l].  One thread owns one pair, so the 32 threads of a warp
// read 32 consecutive values of each plane: every load and store
// coalesces.  Operands must be contiguous; the Python wrapper checks.
//
// What bounds it on an H100: at NX = 4 in float64 a pair reads 6 matrices
// and 4 vectors (112 values) and writes 3 matrices and 2 vectors (56
// values): 1344 bytes for about 1.7 kFLOP, i.e. ~1.3 FLOP/byte, far below
// the card's FP64 ridge (34 TFLOP/s outside the tensor cores over
// 3.35 TB/s, ~10 FLOP/byte, H100 SXM data sheet).  The kernel is
// memory-bound.  The design therefore touches each input
// value once and each output value once, keeps all intermediates in
// registers, and loads operands only when they are needed (C1, J2 first,
// then the inverse, then the rest streamed through) so that the ten NX x NX
// operands never have to be live at once under the 255-register limit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lqt_combine.cuh"

namespace {

template <int NX, typename T>
__global__ void lqt_combine_kernel(
    const T* __restrict__ A1, const T* __restrict__ b1, const T* __restrict__ C1,
    const T* __restrict__ e1, const T* __restrict__ J1, const T* __restrict__ A2,
    const T* __restrict__ b2, const T* __restrict__ C2, const T* __restrict__ e2,
    const T* __restrict__ J2, T* __restrict__ oA, T* __restrict__ ob,
    T* __restrict__ oC, T* __restrict__ oe, T* __restrict__ oJ, int64_t B) {
  const int64_t l = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= B) return;
  // Operand pointers of pair l; entry k of a part is then at p[k * B].
  const lqt::Elem<T> x1{const_cast<T*>(A1) + l, const_cast<T*>(b1) + l,
                        const_cast<T*>(C1) + l, const_cast<T*>(e1) + l,
                        const_cast<T*>(J1) + l, B};
  const lqt::Elem<T> x2{const_cast<T*>(A2) + l, const_cast<T*>(b2) + l,
                        const_cast<T*>(C2) + l, const_cast<T*>(e2) + l,
                        const_cast<T*>(J2) + l, B};
  const lqt::Elem<T> o{oA + l, ob + l, oC + l, oe + l, oJ + l, B};
  lqt::combine_thread<NX, T>(x1, x2, o, lqt::Lanes{});
}

template <int NX, typename T>
cudaError_t launch(const void* const* in, void* const* out, int64_t B,
                   int threads, cudaStream_t stream) {
  const int64_t blocks = (B + threads - 1) / threads;
  const T* const* i = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  lqt_combine_kernel<NX, T><<<dim3(unsigned(blocks)), dim3(threads), 0, stream>>>(
      i[0], i[1], i[2], i[3], i[4], i[5], i[6], i[7], i[8], i[9],
      o[0], o[1], o[2], o[3], o[4], B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nx, const void* const* in, void* const* out, int64_t B,
                     int threads, cudaStream_t s) {
  switch (nx) {
    case 1: return launch<1, T>(in, out, B, threads, s);
    case 2: return launch<2, T>(in, out, B, threads, s);
    case 3: return launch<3, T>(in, out, B, threads, s);
    case 4: return launch<4, T>(in, out, B, threads, s);
    case 5: return launch<5, T>(in, out, B, threads, s);
    case 6: return launch<6, T>(in, out, B, threads, s);
    case 7: return launch<7, T>(in, out, B, threads, s);
    case 8: return launch<8, T>(in, out, B, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  `in` holds the ten operand
// pointers (A1, b1, C1, eta1, J1, A2, b2, C2, eta2, J2), `out` the five
// outputs (A, b, C, eta, J); `dtype` is 0 for float32, 1 for float64.
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int lqt_combine_launch(int dtype, int nx, const void* const* in,
                                  void* const* out, int64_t B, int threads,
                                  void* stream) {
  if (B <= 0 || threads <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(dispatch<float>(nx, in, out, B, threads, s));
  if (dtype == 1) return int(dispatch<double>(nx, in, out, B, threads, s));
  return int(cudaErrorInvalidValue);
}
