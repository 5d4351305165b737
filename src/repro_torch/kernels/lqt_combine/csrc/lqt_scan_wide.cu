// Inclusive scan of LQT elements (paper eqs. 25-26 with the eq.-(42)
// combine) for wide states, 9 <= nx <= NX_WIDE (scan.py), for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel of its own: the Pallas kernel
// src/repro/kernels/lqt_combine/kernel.py::lqt_combine_lanes keeps each
// element in vector registers, as lqt_scan.cu keeps it in a thread's or a
// warp's registers (Mat<NX> in lqt_combine.cuh).  That bounds lqt_scan.cu
// at nx = 8 and spills in float64 from nx = 5.  An element of nx = 40 is
// 3 nx^2 + 2 nx = 4880 values (39 KB in float64): no thread or warp holds
// one, so this kernel keeps the operands in shared memory and gives each
// combine a whole thread block.
//
// A second entry, lqt_combine_wide_launch, runs the same combine on pairs:
// out[i, r] = a[i, r] (x) b[i, r] over an (n, R) grid of elements, one block
// a pair, one launch (lqt_combine_wide_kernel on the trace).  The element
// construction's in-block folds take it for wide states (ops.py).
//
// What it computes: what lqt_scan.cu computes, in the same tree and the same
// combine order (its header: pair-reduce, odd-scan, even-fixup; the suffix
// scan by index arithmetic, operands in element order), so it differs from
// the plain scan only in each combine's arithmetic.  The phases that
// lqt_scan.cu separates by grid barriers are one launch each here (the host
// loop in run()): a phase with W combines is a grid of W blocks, and up
// phase 0 adds one block per output copy.  A scan of n elements takes
// wide_launches(n) launches (scan.py): 17 for the 513 elements of a
// 512-block record.
//
// Storage.  Levels 1..L live in a scratch buffer, as in lqt_scan.cu, but in
// the natural layout (element idx of a level: part p at scr[p] + idx M_p):
// one block reads and writes one element's dense rows.
//
// One combine, one block (WIDE_THREADS = 256 threads, scan.py):
//
//   G   = [M | A1 | b1 + C1 eta2 | C1] = [M | B],   M = I + C1 J2
//   in-place Gauss-Jordan inversion of M, partial pivoting (row swaps P
//   applied to B too):  G -> [inv(P M) | P B]
//   [X_A | X_b | X_C] = inv(P M) (P B) = M^-1 B
//   A   = A2 X_A
//   b   = A2 X_b + b2
//   C   = sym(A2 X_C A2^T + C2)
//   eta = X_A^T (eta2 - J2 b1) + eta1
//   J   = sym(X_A^T (J2 A1) + J1)
//
// (A1^T M^-T = (M^-1 A1)^T = X_A^T, so one inverse serves both of eq.
// (42)'s solves.)  The products are tiles of 4 x 4 outputs a thread,
// FMAs on operands in shared memory.  The inversion eliminates in the nx
// columns of M alone (nx^3 updates, not the ~2.5 nx^3 of eliminating the
// whole system; B's rows only swap), a warp a row.  (On an H100 a pivot
// search folded into each warp's elimination, or an elimination that moves
// no row, took longer: PERF.md.)
// Shared memory: three nx x nx buffers, G, three vectors and the pivot,
// wide_smem_bytes(nx) in scan.py: 79,056 bytes at nx = 40 in float64 (two
// blocks an SM), and at most the 232,448 a block may have up to NX_WIDE.
//
// Memory.  Every operand part is read before the same part of the result is
// written, so an up phase may write its fixup in place over an operand (the
// symmetric parts through shared memory); no block reads what another block
// of the same launch writes.
//
// What bounds it on an H100: the combines' ~1.4 MFLOP each at nx = 40
// (portbench/counts.py::combine_flops) over 67 TFLOP/s, against reading and
// writing each element once at 3.35 TB/s: 1.37 ms and 0.77 ms for 64
// records of 513 elements in float64, so compute.  It runs on the CUDA
// cores (34 TFLOP/s in float64), fed from shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTile = 4;       // a thread's outputs of a product: kTile x kTile

template <typename T>
struct WideArgs {
  T* in[5];              // A, b, C, eta, J of the input
  int64_t in_se[5];      // element strides, in values
  int64_t in_sr[5];      // record strides, in values
  T* out[5];
  int64_t out_se[5];
  int64_t out_sr[5];
  T* scr[5];             // the five parts of levels 1..L, dense
  int64_t n, R;
  int nx, rev;
  int down, l;           // the phase this launch runs
  int64_t W;             // its combines; blocks from W on copy (up phase 0)
};

template <typename T>
struct Elem {
  T* p[5];
};

__host__ __device__ inline int part_values(int nx, int p) {
  return (p == 1 || p == 3) ? nx : nx * nx;     // b and eta are vectors
}

// Row strides of the shared buffers: odd, so rows fall in different banks.
__host__ __device__ inline int ld_of(int nx) { return nx | 1; }
__host__ __device__ inline int lg_of(int nx) { return (3 * nx + 1) | 1; }

// Values of shared memory one combine takes (scan.py::wide_smem_bytes).
__host__ __device__ inline int64_t smem_values(int nx) {
  return int64_t(3) * nx * ld_of(nx) + int64_t(nx) * lg_of(nx) + 3 * nx + 2;
}

// First scratch element of level lv >= 1: R * sum_{j=1}^{lv-1} (n >> j).
__device__ __forceinline__ int64_t level_offset(int64_t n, int64_t R, int lv) {
  const int64_t m = n >> (lv - 1);
  return R * ((n - __popcll(n)) - (m - __popcll(m)));
}

// Element k of level `lv` of record r, in the scan's order; level 0 is the
// input, or the output when `dst`.
template <typename T>
__device__ __forceinline__ Elem<T> at(const WideArgs<T>& a, int lv, int64_t k,
                                      int64_t r, bool dst) {
  Elem<T> e;
  if (lv == 0) {
    const int64_t x = a.rev ? a.n - 1 - k : k;
#pragma unroll
    for (int q = 0; q < 5; ++q)
      e.p[q] = dst ? a.out[q] + x * a.out_se[q] + r * a.out_sr[q]
                   : a.in[q] + x * a.in_se[q] + r * a.in_sr[q];
  } else {
    const int64_t idx = level_offset(a.n, a.R, lv) + k * a.R + r;
#pragma unroll
    for (int q = 0; q < 5; ++q) e.p[q] = a.scr[q] + idx * part_values(a.nx, q);
  }
  return e;
}

// The scanned value s_lv[k] (lv >= 1) of record r: skip k's trailing ones.
template <typename T>
__device__ __forceinline__ Elem<T> scanned(const WideArgs<T>& a, int lv, int64_t k,
                                           int64_t r) {
  const int t = __ffsll(~k) - 1;
  return at(a, lv + t, k >> t, r, false);
}

// Operands and result of combine q of the launch's phase (the operands
// swapped for the suffix scan).
template <typename T>
__device__ __forceinline__ void pair_at(const WideArgs<T>& a, int64_t q, Elem<T>& x1,
                                        Elem<T>& x2, Elem<T>& o) {
  const int64_t k = q / a.R, r = q - k * a.R;
  if (a.down) {          // y_{l+1}[k] = y_l[2k] (x) y_l[2k+1]
    x1 = at(a, a.l, 2 * k, r, false);
    x2 = at(a, a.l, 2 * k + 1, r, false);
    o = at(a, a.l + 1, k, r, false);
  } else {               // s_l[2k+2] = s_{l+1}[k] (x) y_l[2k+2], in place
    x1 = scanned(a, a.l + 1, k, r);
    x2 = at(a, a.l, 2 * k + 2, r, false);
    o = at(a, a.l, 2 * k + 2, r, a.l == 0);
  }
  if (a.rev) {
    const Elem<T> t = x1;
    x1 = x2;
    x2 = t;
  }
}

// D(i, j) = sum_k X(i, k) Y(k, j) for i < m, j < n, k < kd, handed to
// epi(i, j, D(i, j)); X(i, k) at X[i xi + k xk], Y(k, j) at Y[k yk + j yj].
// Thread t owns rows ti + r TI and columns tj + c TJ (r, c < kTile), so
// consecutive threads read consecutive columns of Y.
template <typename T, typename Epi>
__device__ __forceinline__ void block_mm(int m, int n, int kd, const T* X, int xi,
                                         int xk, const T* Y, int yk, int yj, Epi epi) {
  const int TI = (m + kTile - 1) / kTile, TJ = (n + kTile - 1) / kTile;
  for (int t = threadIdx.x; t < TI * TJ; t += blockDim.x) {
    const int ti = t / TJ, tj = t - ti * TJ;
    const T* xr[kTile];
    const T* yc[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) xr[r] = X + min(ti + r * TI, m - 1) * xi;
#pragma unroll
    for (int c = 0; c < kTile; ++c) yc[c] = Y + min(tj + c * TJ, n - 1) * yj;
    T acc[kTile][kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[r][c] = T(0);
#pragma unroll 2
    for (int k = 0; k < kd; ++k) {
      T x[kTile], y[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) x[r] = xr[r][k * xk];
#pragma unroll
      for (int c = 0; c < kTile; ++c) y[c] = yc[c][k * yk];
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[r][c] = fma(x[r], y[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int i = ti + r * TI;
      if (i >= m) continue;
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int j = tj + c * TJ;
        if (j < n) epi(i, j, acc[r][c]);
      }
    }
  }
}

// One eq.-(42) combine by the whole block (header).  `sm` holds
// smem_values(nx) values.
template <typename T>
__device__ void combine(const Elem<T>& x1, const Elem<T>& x2, const Elem<T>& o,
                        const int nx, T* sm) {
  const int ld = ld_of(nx), lg = lg_of(nx), nn = nx * nx, wd = 3 * nx + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  T* const sC = sm;                 // C1, then J2 A1
  T* const sJ = sC + nx * ld;       // J2
  T* const sP = sJ + nx * ld;
  T* const G = sP + nx * ld;        // the system, nx x wd at row stride lg
  T* const vb = G + nx * lg;        // b1
  T* const ve = vb + nx;            // eta2
  T* const vu = ve + nx;            // eta2 - J2 b1
  T* const piv = vu + nx;           // the step's pivot row and value
  T* const GA = G + nx;             // A1
  T* const Gw = G + 2 * nx;         // b1 + C1 eta2
  T* const GC = G + 2 * nx + 1;     // C1

  for (int q = tid; q < nn; q += nt) {
    const int i = q / nx, j = q - i * nx;
    const T c1 = x1.p[2][q];
    sC[i * ld + j] = c1;
    GC[i * lg + j] = c1;
    GA[i * lg + j] = x1.p[0][q];
    sJ[i * ld + j] = x2.p[4][q];
  }
  for (int i = tid; i < nx; i += nt) {
    vb[i] = x1.p[1][i];
    ve[i] = x2.p[3][i];
  }
  __syncthreads();
  block_mm(nx, nx, nx, sC, ld, 1, sJ, ld, 1, [&](int i, int j, T v) {
    G[i * lg + j] = i == j ? v + T(1) : v;
  });
  block_mm(nx, 1, nx, sC, ld, 1, ve, 1, 0, [&](int i, int, T v) {
    Gw[i * lg] = vb[i] + v;
  });
  block_mm(nx, 1, nx, sJ, ld, 1, vb, 1, 0, [&](int i, int, T v) {
    vu[i] = ve[i] - v;
  });
  __syncthreads();
  block_mm(nx, nx, nx, sJ, ld, 1, GA, lg, 1, [&](int i, int j, T v) {
    sC[i * ld + j] = v;
  });
  __syncthreads();

  // In-place Gauss-Jordan inversion of M with partial pivoting; each row
  // interchange also applies to B = [A1 | w | C1], so that
  // G -> [inv(P M) | P B] and X = M^-1 B = inv(P M) (P B).  A step is a
  // pivot search (one warp), a pass that swaps rows k and p and scales row
  // k, and the elimination of column k (a warp a row).
  for (int k = 0; k < nx; ++k) {
    if (warp == 0) {
      T best = T(-1);
      int bi = k;
      for (int i = k + lane; i < nx; i += 32) {
        const T g = G[i * lg + k];
        const T v = g < T(0) ? -g : g;
        if (v > best) {
          best = v;
          bi = i;
        }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const T ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (lane == 0) {
        piv[0] = T(bi);
        piv[1] = G[bi * lg + k];
      }
    }
    __syncthreads();
    const int p = int(piv[0]);
    const T inv = T(1) / piv[1];
    for (int j = tid; j < wd; j += nt) {         // swap rows k, p; scale row k
      const T t = G[p * lg + j];
      G[p * lg + j] = G[k * lg + j];
      G[k * lg + j] = j < nx ? (j == k ? T(1) : t) * inv : t;
    }
    __syncthreads();
    for (int i = warp; i < nx; i += nw) {        // eliminate column k
      if (i == k) continue;
      const T f = G[i * lg + k];
      __syncwarp();
      for (int j = lane; j < nx; j += 32)
        G[i * lg + j] = (j == k ? T(0) : G[i * lg + j]) - f * G[k * lg + j];
    }
    __syncthreads();
  }

  // X_A = inv(P M) P A1, X_b = inv(P M) P w, X_C = inv(P M) P C1
  T* const sX = sP;                 // X_A
  T* const vX = vb;                 // X_b
  T* const sXC = sJ;                // X_C, then X_A^T J2 A1 + J1
  block_mm(nx, nx, nx, G, lg, 1, GA, lg, 1, [&](int i, int j, T v) {
    sX[i * ld + j] = v;
  });
  block_mm(nx, 1, nx, G, lg, 1, Gw, lg, 0, [&](int i, int, T v) { vX[i] = v; });
  block_mm(nx, nx, nx, G, lg, 1, GC, lg, 1, [&](int i, int j, T v) {
    sXC[i * ld + j] = v;
  });
  __syncthreads();
  T* const sA2 = G;                 // A2 over inv(P M), row stride lg
  for (int q = tid; q < nn; q += nt) {
    const int i = q / nx, j = q - i * nx;
    sA2[i * lg + j] = x2.p[0][q];
  }
  __syncthreads();
  T* const oA = o.p[0];
  T* const ob = o.p[1];
  T* const oe = o.p[3];
  const T* const b2 = x2.p[1];
  const T* const eta1 = x1.p[3];
  block_mm(nx, nx, nx, sA2, lg, 1, sX, ld, 1, [&](int i, int j, T v) {
    oA[i * nx + j] = v;
  });
  block_mm(nx, 1, nx, sA2, lg, 1, vX, 1, 0, [&](int i, int, T v) {
    ob[i] = v + b2[i];
  });
  block_mm(nx, 1, nx, sX, 1, ld, vu, 1, 0, [&](int i, int, T v) {
    oe[i] = v + eta1[i];
  });
  block_mm(nx, nx, nx, sA2, lg, 1, sXC, ld, 1, [&](int i, int j, T v) {
    GA[i * lg + j] = v;             // A2 X_C over P A1
  });
  __syncthreads();
  // A2 X_C A2^T + C2 over P C1, X_A^T (J2 A1) + J1 over X_C
  const T* const C2 = x2.p[2];
  const T* const J1 = x1.p[4];
  block_mm(nx, nx, nx, GA, lg, 1, sA2, 1, lg, [&](int i, int j, T v) {
    GC[i * lg + j] = v + C2[i * nx + j];
  });
  block_mm(nx, nx, nx, sX, 1, ld, sC, ld, 1, [&](int i, int j, T v) {
    sXC[i * ld + j] = v + J1[i * nx + j];
  });
  __syncthreads();
  T* const oC = o.p[2];
  T* const oJ = o.p[4];
  for (int q = tid; q < nn; q += nt) {
    const int i = q / nx, j = q - i * nx;
    oC[q] = T(0.5) * (GC[i * lg + j] + GC[j * lg + i]);
    oJ[q] = T(0.5) * (sXC[i * ld + j] + sXC[j * ld + i]);
  }
}

// Output copy c of up phase 0: out[2k+1] = s_1[k] for c < n_1 R, then
// out[0] = x_0 of each record.
template <typename T>
__device__ void output_copy(const WideArgs<T>& a, int64_t c) {
  const int64_t odd = (a.n >> 1) * a.R;
  Elem<T> src, dst;
  if (c < odd) {
    const int64_t k = c / a.R, r = c - k * a.R;
    src = scanned(a, 1, k, r);
    dst = at(a, 0, 2 * k + 1, r, true);
  } else {
    src = at(a, 0, 0, c - odd, false);
    dst = at(a, 0, 0, c - odd, true);
  }
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const int m = part_values(a.nx, q);
    for (int v = threadIdx.x; v < m; v += blockDim.x) dst.p[q][v] = src.p[q][v];
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) lqt_scan_wide_kernel(const WideArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t q = blockIdx.x;
  if (q < a.W) {
    Elem<T> x1, x2, o;
    pair_at(a, q, x1, x2, o);
    combine(x1, x2, o, a.nx, reinterpret_cast<T*>(smem_raw));
  } else {
    output_copy(a, q - a.W);
  }
}

// Pairs of elements on an (n, R) grid: part p of element (i, r) of x at
// x[p] + i * x_se[p] + r * x_sr[p], dense.
template <typename T>
struct PairArgs {
  T* x1[5];
  int64_t x1_se[5], x1_sr[5];
  T* x2[5];
  int64_t x2_se[5], x2_sr[5];
  T* out[5];
  int64_t out_se[5], out_sr[5];
  int64_t R;
  int nx;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) lqt_combine_wide_kernel(const PairArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t q = blockIdx.x, i = q / a.R, r = q - i * a.R;
  Elem<T> x1, x2, o;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    x1.p[p] = a.x1[p] + i * a.x1_se[p] + r * a.x1_sr[p];
    x2.p[p] = a.x2[p] + i * a.x2_se[p] + r * a.x2_sr[p];
    o.p[p] = a.out[p] + i * a.out_se[p] + r * a.out_sr[p];
  }
  combine(x1, x2, o, a.nx, reinterpret_cast<T*>(smem_raw));
}

// Opt in to the dynamic shared memory one combine takes, once a kernel.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <typename T>
cudaError_t run_pairs(int nx, int64_t n, int64_t R, void* const* x1, const int64_t* x1_strides,
                      void* const* x2, const int64_t* x2_strides, void* const* out,
                      const int64_t* out_strides, int threads, cudaStream_t s) {
  PairArgs<T> a;
  for (int q = 0; q < 5; ++q) {
    a.x1[q] = static_cast<T*>(x1[q]);
    a.x1_se[q] = x1_strides[q];
    a.x1_sr[q] = x1_strides[5 + q];
    a.x2[q] = static_cast<T*>(x2[q]);
    a.x2_se[q] = x2_strides[q];
    a.x2_sr[q] = x2_strides[5 + q];
    a.out[q] = static_cast<T*>(out[q]);
    a.out_se[q] = out_strides[q];
    a.out_sr[q] = out_strides[5 + q];
  }
  a.R = R;
  a.nx = nx;
  void (*kern)(const PairArgs<T>) = lqt_combine_wide_kernel<T>;
  const size_t smem = size_t(smem_values(nx)) * sizeof(T);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  if (n * R > int64_t(0x7fffffff)) return cudaErrorInvalidValue;
  kern<<<dim3(unsigned(n * R)), dim3(unsigned(threads)), smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int nx, int rev, int64_t n, int64_t R, void* const* in,
                const int64_t* in_strides, void* const* out,
                const int64_t* out_strides, void* const* scratch, int threads,
                cudaStream_t s, int* info) {
  WideArgs<T> a;
  for (int q = 0; q < 5; ++q) {
    a.in[q] = static_cast<T*>(in[q]);
    a.in_se[q] = in_strides[q];
    a.in_sr[q] = in_strides[5 + q];
    a.out[q] = static_cast<T*>(out[q]);
    a.out_se[q] = out_strides[q];
    a.out_sr[q] = out_strides[5 + q];
    a.scr[q] = static_cast<T*>(scratch[q]);
  }
  a.n = n;
  a.R = R;
  a.nx = nx;
  a.rev = rev;
  void (*kern)(const WideArgs<T>) = lqt_scan_wide_kernel<T>;
  const size_t smem = size_t(smem_values(nx)) * sizeof(T);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int L = 0;
  while ((n >> (L + 1)) > 0) ++L;
  const int P = L + (L > 0 ? L : 1);           // n = 1: up phase 0 only
  int launches = 0;
  for (int p = 0; p < P; ++p) {
    const bool down = p < L;
    const int l = down ? p : P - 1 - p;
    const int64_t W = down ? (n >> (l + 1)) * R : (((n >> l) - 1) / 2) * R;
    const int64_t copies = (!down && l == 0) ? ((n >> 1) + 1) * R : 0;
    if (W + copies == 0) continue;
    if (W + copies > int64_t(0x7fffffff)) return cudaErrorInvalidValue;
    a.down = down;
    a.l = l;
    a.W = W;
    kern<<<dim3(unsigned(W + copies)), dim3(unsigned(threads)), smem, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++launches;
  }
  if (info) {
    info[0] = launches;
    info[1] = int(smem);
  }
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, bound with ctypes; the arguments are those of
// lqt_scan_launch (lqt_scan.cu), with `nx` a runtime value.  Launches one
// kernel per phase on `stream`; writes the launches and the dynamic shared
// memory per block to info[0..1]; returns the first launch's CUDA error code
// that is not 0 (0 on success).
extern "C" int lqt_scan_wide_launch(int dtype, int nx, int rev, int64_t n, int64_t R,
                                    void* const* in, const int64_t* in_strides,
                                    void* const* out, const int64_t* out_strides,
                                    void* const* scratch, int threads, void* stream,
                                    int* info) {
  if (n <= 0 || R <= 0 || nx < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(run<float>(nx, rev, n, R, in, in_strides, out, out_strides, scratch,
                          threads, s, info));
  if (dtype == 1)
    return int(run<double>(nx, rev, n, R, in, in_strides, out, out_strides, scratch,
                           threads, s, info));
  return int(cudaErrorInvalidValue);
}

// Plain C entry point of the pairwise combine: `x1`, `x2`, `out` hold five
// part pointers each, `*_strides` ten strides in values (the five strides of
// i, then the five of r) of an (n, R) grid of elements.  One launch on
// `stream`; returns its CUDA error code (0 on success).
extern "C" int lqt_combine_wide_launch(int dtype, int nx, int64_t n, int64_t R,
                                       void* const* x1, const int64_t* x1_strides,
                                       void* const* x2, const int64_t* x2_strides,
                                       void* const* out, const int64_t* out_strides,
                                       int threads, void* stream) {
  if (n <= 0 || R <= 0 || nx < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(run_pairs<float>(nx, n, R, x1, x1_strides, x2, x2_strides, out,
                                out_strides, threads, s));
  if (dtype == 1)
    return int(run_pairs<double>(nx, n, R, x1, x1_strides, x2, x2_strides, out,
                                 out_strides, threads, s));
  return int(cudaErrorInvalidValue);
}
