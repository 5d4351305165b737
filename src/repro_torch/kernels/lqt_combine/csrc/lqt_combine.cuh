// The eq.-(42) combine of two LQT elements, as device code for Hopper
// (sm_90a), shared by the pairwise kernel (lqt_combine.cu) and the
// whole-scan kernel (lqt_scan.cu) so that the arithmetic exists once.
//
// For element pairs (A, b, C, eta, J)_{1,2}:
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
// Two forms of the same arithmetic, operation for operation (each product
// sums its terms in the same order, each update has the same operands):
//
// * combine_thread: one thread owns one pair and keeps every intermediate in
//   registers, loading operands only when they are needed (C1, J2 first, then
//   the inverse, then the rest streamed through) so that the ten operands
//   never have to be live at once under the 255-register limit.  It is the
//   form for many pairs at once: the pairwise kernel and the wide levels of
//   the scan.
// * combine_warp: one warp owns one pair.  The operands are staged in shared
//   memory and each lane owns one entry of every NX x NX result (two for
//   NX > 5), so a product is NX dependent FMAs on a lane instead of NX^3 on
//   one thread.  It is the form for levels with fewer pairs than the grid has
//   warps, where the one-thread form would be a long dependent chain on a few
//   threads.
//
// Operand access.  An element (Elem) is five part pointers and one stride:
// entry k of a part lives at p[k * s].  s = B for the pairwise kernel's
// lane-major operands and for the scan's lane-major scratch levels (entry k
// of every element of a level together, so the 32 threads of a warp touch
// 32 consecutive values), s = 1 for the natural-layout elements the scan
// reads and writes (one contiguous row per part).  The one-thread form reads
// through an access policy: Lanes (read-only path, ld.global.nc) for the
// pairwise kernel's operands, Plain for the scan, which reads values that
// its own launch wrote earlier and which the read-only path may not see.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lqt {

// One element: its five parts, entry k of each at p[k * s].
template <typename T>
struct Elem {
  T* A;
  T* b;
  T* C;
  T* e;
  T* J;
  int64_t s;
};

template <int NX, typename T>
struct Mat {
  T v[NX][NX];
};

// Entry k of a part at p[k * s], read through the read-only path (NC, for
// operands that the kernel only reads) or with plain loads.
template <bool NC>
struct Strided {
  template <typename T>
  __device__ __forceinline__ static T ld(const T* p) {
    if constexpr (NC) return __ldg(p);
    else return *p;
  }
  template <int NX, typename T>
  __device__ __forceinline__ void load_mat(Mat<NX, T>& m, const T* p, int64_t s) const {
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) m.v[i][j] = ld(p + (i * NX + j) * s);
  }
  template <int NX, typename T>
  __device__ __forceinline__ void load_vec(T (&x)[NX], const T* p, int64_t s) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = ld(p + i * s);
  }
  template <int NX, typename T>
  __device__ __forceinline__ void store_mat(T* p, int64_t s, const Mat<NX, T>& m) const {
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) p[(i * NX + j) * s] = m.v[i][j];
  }
  template <int NX, typename T>
  __device__ __forceinline__ void store_vec(T* p, int64_t s, const T (&x)[NX]) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) p[i * s] = x[i];
  }
  // sym(X + Y) = 0.5 (X + Y + (X + Y)^T)
  template <int NX, typename T>
  __device__ __forceinline__ void store_sym(T* p, int64_t s, const Mat<NX, T>& X,
                                            const Mat<NX, T>& Y) const {
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        p[(i * NX + j) * s] =
            T(0.5) * ((X.v[i][j] + Y.v[i][j]) + (X.v[j][i] + Y.v[j][i]));
  }
};
using Lanes = Strided<true>;    // the pairwise kernel's read-only operands
using Plain = Strided<false>;   // the scan's elements

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

// o = x1 (x) x2 on one thread, parts read and written through `io` (Lanes
// or Plain).  `o` may be `x1` or `x2` itself: every part of the operands is
// read before the same part of the result is written.
template <int NX, typename T, class IO>
__device__ __forceinline__ void combine_thread(const Elem<T>& x1, const Elem<T>& x2,
                                               const Elem<T>& o, const IO& io) {
  // M = I + C1 J2, then Gauss-Jordan: a -> I, inv -> M^-1.
  Mat<NX, T> c1, j2, a, inv;
  io.load_mat(c1, x1.C, x1.s);
  io.load_mat(j2, x2.J, x2.s);
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
  io.load_vec(vb1, x1.b, x1.s);
  io.load_vec(ve2, x2.e, x2.s);
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
  io.load_mat(a1, x1.A, x1.s);
  matmat<NX, T, false>(MiA1, inv, a1);
  T ve1[NX], out[NX];
  io.load_vec(ve1, x1.e, x1.s);
  matvec<NX, T, true>(out, a1, Mtw);
#pragma unroll
  for (int i = 0; i < NX; ++i) out[i] += ve1[i];
  io.store_vec(o.e, o.s, out);
  {
    Mat<NX, T> j1;
    matmat<NX, T, false>(a, MtJ2, a1);     // M^-T J2 A1
    matmat<NX, T, true>(MtJ2, a1, a);      // A1^T (M^-T J2 A1)
    io.load_mat(j1, x1.J, x1.s);
    io.store_sym(o.J, o.s, MtJ2, j1);
  }

  // A2 side: A, b and C.
  Mat<NX, T> a2;
  io.load_mat(a2, x2.A, x2.s);
  matmat<NX, T, false>(a, a2, MiA1);
  io.store_mat(o.A, o.s, a);
  T vb2[NX];
  io.load_vec(vb2, x2.b, x2.s);
  matvec<NX, T, false>(out, a2, Mit);
#pragma unroll
  for (int i = 0; i < NX; ++i) out[i] += vb2[i];
  io.store_vec(o.b, o.s, out);
  {
    Mat<NX, T> c2;
    matmat_bt<NX, T>(a, MiC1, a2);         // M^-1 C1 A2^T
    matmat<NX, T, false>(MiC1, a2, a);     // A2 (M^-1 C1 A2^T)
    io.load_mat(c2, x2.C, x2.s);
    io.store_sym(o.C, o.s, MiC1, c2);
  }
}

// ---------------------------------------------------------------------------
// One warp per pair, on dense elements.
// ---------------------------------------------------------------------------

// Shared-memory values combine_warp needs: 13 NX x NX matrices, 8 vectors.
template <int NX>
__host__ __device__ constexpr int warp_smem_values() {
  return 13 * NX * NX + 8 * NX;
}

// (X @ Y)[i][k], X read transposed when TX; row-major NX x NX in shared memory.
template <int NX, typename T, bool TX>
__device__ __forceinline__ T dot_mm(const T* X, const T* Y, int i, int k) {
  T acc = (TX ? X[i] : X[i * NX]) * Y[k];
#pragma unroll
  for (int j = 1; j < NX; ++j) acc += (TX ? X[j * NX + i] : X[i * NX + j]) * Y[j * NX + k];
  return acc;
}

// (X @ Y^T)[i][k]
template <int NX, typename T>
__device__ __forceinline__ T dot_mbt(const T* X, const T* Y, int i, int k) {
  T acc = X[i * NX] * Y[k * NX];
#pragma unroll
  for (int j = 1; j < NX; ++j) acc += X[i * NX + j] * Y[k * NX + j];
  return acc;
}

// (X @ x)[i], X read transposed when TX.
template <int NX, typename T, bool TX>
__device__ __forceinline__ T dot_mv(const T* X, const T* x, int i) {
  T acc = (TX ? X[i] : X[i * NX]) * x[0];
#pragma unroll
  for (int j = 1; j < NX; ++j) acc += (TX ? X[j * NX + i] : X[i * NX + j]) * x[j];
  return acc;
}

// o = x1 (x) x2 by the 32 lanes of one warp (all must call it), with
// `sm` holding warp_smem_values<NX>() values of this warp.  Every operand is
// read into shared memory before anything is written, so `o` may alias an
// operand.
template <int NX, typename T>
__device__ __forceinline__ void combine_warp(const Elem<T>& x1, const Elem<T>& x2,
                                             const Elem<T>& o, T* sm, int lane) {
  constexpr int M = NX * NX;
  constexpr int E = (M + 31) / 32;         // entries each lane owns
  T* const sA1 = sm;
  T* const sC1 = sA1 + M;
  T* const sJ1 = sC1 + M;
  T* const sA2 = sJ1 + M;
  T* const sC2 = sA2 + M;
  T* const sJ2 = sC2 + M;
  T* const sG = sJ2 + M;       // I + C1 J2, eliminated to I
  T* const sI = sG + M;        // its inverse
  T* const sMiC1 = sI + M;
  T* const sMtJ2 = sMiC1 + M;
  T* const sMiA1 = sMtJ2 + M;
  T* const sU = sMiA1 + M;
  T* const sV = sU + M;
  T* const vb1 = sV + M;
  T* const ve1 = vb1 + NX;
  T* const vb2 = ve1 + NX;
  T* const ve2 = vb2 + NX;
  T* const vt = ve2 + NX;
  T* const vw = vt + NX;
  T* const vMit = vw + NX;
  T* const vMtw = vMit + NX;

#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int q = lane + 32 * r;
    if (q < M) {
      sA1[q] = x1.A[q * x1.s];
      sC1[q] = x1.C[q * x1.s];
      sJ1[q] = x1.J[q * x1.s];
      sA2[q] = x2.A[q * x2.s];
      sC2[q] = x2.C[q * x2.s];
      sJ2[q] = x2.J[q * x2.s];
    }
  }
  if (lane < NX) {
    vb1[lane] = x1.b[lane * x1.s];
    ve1[lane] = x1.e[lane * x1.s];
    vb2[lane] = x2.b[lane * x2.s];
    ve2[lane] = x2.e[lane * x2.s];
  }
  __syncwarp();

  // M = I + C1 J2 and the identity.
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int q = lane + 32 * r;
    if (q < M) {
      const int i = q / NX, k = q % NX;
      const T acc = dot_mm<NX, T, false>(sC1, sJ2, i, k);
      sG[q] = (i == k) ? acc + T(1) : acc;
      sI[q] = (i == k) ? T(1) : T(0);
    }
  }
  __syncwarp();

  // Gauss-Jordan: pivot k scales row k, then clears column k in the others.
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const T piv = T(1) / sG[k * NX + k];
    T g[E], h[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int q = lane + 32 * r;
      if (q < M) {
        const int i = q / NX, j = q % NX;
        const T gk = sG[k * NX + j] * piv, hk = sI[k * NX + j] * piv;
        if (i == k) {
          g[r] = gk;
          h[r] = hk;
        } else {
          const T f = sG[i * NX + k];
          T gi = sG[q], hi = sI[q];
          gi -= f * gk;
          hi -= f * hk;
          g[r] = gi;
          h[r] = hi;
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int q = lane + 32 * r;
      if (q < M) {
        sG[q] = g[r];
        sI[q] = h[r];
      }
    }
    __syncwarp();
  }

  // t = b1 + C1 eta2, w = eta2 - J2 b1.
  if (lane < NX) {
    vt[lane] = vb1[lane] + dot_mv<NX, T, false>(sC1, ve2, lane);
    vw[lane] = ve2[lane] - dot_mv<NX, T, false>(sJ2, vb1, lane);
  }
  __syncwarp();

  // Products with M^-1 / M^-T.
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int q = lane + 32 * r;
    if (q < M) {
      const int i = q / NX, k = q % NX;
      sMiC1[q] = dot_mm<NX, T, false>(sI, sC1, i, k);
      sMtJ2[q] = dot_mm<NX, T, true>(sI, sJ2, i, k);
      sMiA1[q] = dot_mm<NX, T, false>(sI, sA1, i, k);
    }
  }
  if (lane < NX) {
    vMit[lane] = dot_mv<NX, T, false>(sI, vt, lane);
    vMtw[lane] = dot_mv<NX, T, true>(sI, vw, lane);
  }
  __syncwarp();

  // eta, b and A; the inner products of J and C.
  if (lane < NX) {
    o.e[lane * o.s] = dot_mv<NX, T, true>(sA1, vMtw, lane) + ve1[lane];
    o.b[lane * o.s] = dot_mv<NX, T, false>(sA2, vMit, lane) + vb2[lane];
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int q = lane + 32 * r;
    if (q < M) {
      const int i = q / NX, k = q % NX;
      sU[q] = dot_mm<NX, T, false>(sMtJ2, sA1, i, k);   // M^-T J2 A1
      sV[q] = dot_mbt<NX, T>(sMiC1, sA2, i, k);         // M^-1 C1 A2^T
      o.A[q * o.s] = dot_mm<NX, T, false>(sA2, sMiA1, i, k);
    }
  }
  __syncwarp();

  // sG <- A1^T (M^-T J2 A1), sI <- A2 (M^-1 C1 A2^T): both free after the
  // products above.
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int q = lane + 32 * r;
    if (q < M) {
      const int i = q / NX, k = q % NX;
      sG[q] = dot_mm<NX, T, true>(sA1, sU, i, k);
      sI[q] = dot_mm<NX, T, false>(sA2, sV, i, k);
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int q = lane + 32 * r;
    if (q < M) {
      const int i = q / NX, j = q % NX, t = j * NX + i;
      o.J[q * o.s] = T(0.5) * ((sG[q] + sJ1[q]) + (sG[t] + sJ1[t]));
      o.C[q * o.s] = T(0.5) * ((sI[q] + sC2[q]) + (sI[t] + sC2[t]));
    }
  }
}

}  // namespace lqt
