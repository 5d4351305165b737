// Batched LQT combine (paper eq. 42) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/lqt_combine/kernel.py::lqt_combine_lanes.
// It computes the same function, not the same blocking: for each of B
// element pairs (A, b, C, eta, J)_{1,2},
//
//   M   = I + C1 J2               (inverted by unpivoted Gauss-Jordan)
//   A   = A2 M^-1 A1
//   b   = A2 M^-1 (b1 + C1 eta2) + b2
//   C   = sym(A2 M^-1 C1 A2^T + C2)
//   eta = A1^T M^-T (eta2 - J2 b1) + eta1
//   J   = sym(A1^T M^-T J2 A1 + J1)
//
// No pivoting is needed: C1 and J2 are symmetric PSD, so every pivot of
// I + C1 J2 is >= 1 during elimination (paper section 4.1).
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

namespace {

template <int NX, typename T>
struct Mat {
  T v[NX][NX];
};

template <int NX, typename T>
__device__ __forceinline__ void load_mat(Mat<NX, T>& m, const T* __restrict__ p,
                                         int64_t B, int64_t l) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) m.v[i][j] = p[(i * NX + j) * B + l];
}

template <int NX, typename T>
__device__ __forceinline__ void load_vec(T (&x)[NX], const T* __restrict__ p,
                                         int64_t B, int64_t l) {
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = p[i * B + l];
}

// out = X @ Y, with X read transposed when TX (so M^-T costs nothing).
template <int NX, typename T, bool TX>
__device__ __forceinline__ void matmat(Mat<NX, T>& out, const Mat<NX, T>& X,
                                       const Mat<NX, T>& Y) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T acc = (TX ? X.v[0][i] : X.v[i][0]) * Y.v[0][k];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc += (TX ? X.v[j][i] : X.v[i][j]) * Y.v[j][k];
      out.v[i][k] = acc;
    }
}

// out = X @ Y^T
template <int NX, typename T>
__device__ __forceinline__ void matmat_bt(Mat<NX, T>& out, const Mat<NX, T>& X,
                                          const Mat<NX, T>& Y) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T acc = X.v[i][0] * Y.v[k][0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc += X.v[i][j] * Y.v[k][j];
      out.v[i][k] = acc;
    }
}

// out = X @ x, with X read transposed when TX.
template <int NX, typename T, bool TX>
__device__ __forceinline__ void matvec(T (&out)[NX], const Mat<NX, T>& X,
                                       const T (&x)[NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T acc = (TX ? X.v[0][i] : X.v[i][0]) * x[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) acc += (TX ? X.v[j][i] : X.v[i][j]) * x[j];
    out[i] = acc;
  }
}

// Store sym(X + Y) = 0.5 (X + Y + (X + Y)^T).
template <int NX, typename T>
__device__ __forceinline__ void store_sym(T* __restrict__ p, const Mat<NX, T>& X,
                                          const Mat<NX, T>& Y, int64_t B,
                                          int64_t l) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j)
      p[(i * NX + j) * B + l] =
          T(0.5) * ((X.v[i][j] + Y.v[i][j]) + (X.v[j][i] + Y.v[j][i]));
}

template <int NX, typename T>
__global__ void lqt_combine_kernel(
    const T* __restrict__ A1, const T* __restrict__ b1, const T* __restrict__ C1,
    const T* __restrict__ e1, const T* __restrict__ J1, const T* __restrict__ A2,
    const T* __restrict__ b2, const T* __restrict__ C2, const T* __restrict__ e2,
    const T* __restrict__ J2, T* __restrict__ oA, T* __restrict__ ob,
    T* __restrict__ oC, T* __restrict__ oe, T* __restrict__ oJ, int64_t B) {
  const int64_t l = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= B) return;

  // M = I + C1 J2, then Gauss-Jordan: a -> I, inv -> M^-1.
  Mat<NX, T> c1, j2, a, inv;
  load_mat(c1, C1, B, l);
  load_mat(j2, J2, B, l);
  matmat<NX, T, false>(a, c1, j2);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    a.v[i][i] += T(1);
#pragma unroll
    for (int j = 0; j < NX; ++j) inv.v[i][j] = (i == j) ? T(1) : T(0);
  }
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const T piv = T(1) / a.v[k][k];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      a.v[k][j] *= piv;
      inv.v[k][j] *= piv;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (i == k) continue;
      const T f = a.v[i][k];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        a.v[i][j] -= f * a.v[k][j];
        inv.v[i][j] -= f * inv.v[k][j];
      }
    }
  }

  // Vectors: t = b1 + C1 eta2, w = eta2 - J2 b1.
  T vb1[NX], ve2[NX], t[NX], w[NX], tmp[NX];
  load_vec(vb1, b1, B, l);
  load_vec(ve2, e2, B, l);
  matvec<NX, T, false>(tmp, c1, ve2);
#pragma unroll
  for (int i = 0; i < NX; ++i) t[i] = vb1[i] + tmp[i];
  matvec<NX, T, false>(tmp, j2, vb1);
#pragma unroll
  for (int i = 0; i < NX; ++i) w[i] = ve2[i] - tmp[i];

  // Products with M^-1 / M^-T; c1 and j2 die here.
  Mat<NX, T> MiC1, MtJ2;
  matmat<NX, T, false>(MiC1, inv, c1);
  matmat<NX, T, true>(MtJ2, inv, j2);
  T Mit[NX], Mtw[NX];
  matvec<NX, T, false>(Mit, inv, t);
  matvec<NX, T, true>(Mtw, inv, w);

  // A1 side: eta and J.  `a` is reused as scratch.
  Mat<NX, T> a1, MiA1;
  load_mat(a1, A1, B, l);
  matmat<NX, T, false>(MiA1, inv, a1);
  T ve1[NX], out[NX];
  load_vec(ve1, e1, B, l);
  matvec<NX, T, true>(out, a1, Mtw);
#pragma unroll
  for (int i = 0; i < NX; ++i) oe[i * B + l] = out[i] + ve1[i];
  {
    Mat<NX, T> j1;
    matmat<NX, T, false>(a, MtJ2, a1);     // M^-T J2 A1
    matmat<NX, T, true>(MtJ2, a1, a);      // A1^T (M^-T J2 A1)
    load_mat(j1, J1, B, l);
    store_sym(oJ, MtJ2, j1, B, l);
  }

  // A2 side: A, b and C.
  Mat<NX, T> a2;
  load_mat(a2, A2, B, l);
  matmat<NX, T, false>(a, a2, MiA1);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) oA[(i * NX + j) * B + l] = a.v[i][j];
  T vb2[NX];
  load_vec(vb2, b2, B, l);
  matvec<NX, T, false>(out, a2, Mit);
#pragma unroll
  for (int i = 0; i < NX; ++i) ob[i * B + l] = out[i] + vb2[i];
  {
    Mat<NX, T> c2;
    matmat_bt<NX, T>(a, MiC1, a2);         // M^-1 C1 A2^T
    matmat<NX, T, false>(MiC1, a2, a);     // A2 (M^-1 C1 A2^T)
    load_mat(c2, C2, B, l);
    store_sym(oC, MiC1, c2, B, l);
  }
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
