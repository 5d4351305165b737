// Whole inclusive scan of LQT elements (paper eqs. 25-26 with the eq.-(42)
// combine) in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the scan that the Pallas TPU kernel
// src/repro/kernels/lqt_combine/kernel.py::lqt_combine_lanes is driven
// through (src/repro/kernels/lqt_combine/ops.py::kernel_suffix_scan /
// kernel_prefix_scan), where every level of the tree is its own launch over
// lane-major copies of the level.  Here one launch covers every level and
// every record.
//
// What it computes.  For n elements x_0 .. x_{n-1} of each of R records
// (natural layout: part p of element e of record r at in[p] + e * se[p] +
// r * sr[p], the NX x NX or NX values of a part dense), the inclusive scan
// along the elements, earlier operand first; with `rev`, the suffix scan
// out_i = x_i (x) ... (x) x_{n-1}, i.e. the scan of the reversed sequence
// with the operands swapped.  The reversal is index arithmetic (element
// j of the scan is element n - 1 - j of the tensors): nothing is flipped or
// copied around the launch.
//
// Combine order.  The tree is jax.lax.associative_scan's, as
// repro_torch.core.pscan.associative_scan writes it out: pair-reduce,
// odd-scan, even-fixup.  With n_l = n >> l elements on level l (level 0 the
// input) and L = floor(log2 n):
//   down phase l = 0 .. L-1:  y_{l+1}[k] = y_l[2k] (x) y_l[2k+1],
//                             k < n_{l+1}
//   up phase l = L-1 .. 0:    s_l[2k+2] = s_{l+1}[k] (x) y_l[2k+2],
//                             k < (n_l - 1) / 2
//                             s_l[2k+1] = s_{l+1}[k],  s_l[0] = y_l[0]
// (s_L = y_L, one element).  Each combine has exactly the operands of the
// recursive version, so the kernel differs from the plain scan only in each
// combine's arithmetic.
//
// Storage.  Levels 1..L live in a scratch buffer (R * sum_l n_l < R * n
// elements, allocated by the caller; level lv starts at element
// R * sum_{j=1}^{lv-1} n_j), lane-major like the pairwise kernel's operands:
// entry v of every element of a level together, elements record-minor, so
// the one-thread form reads and writes them coalesced.  (Measured on an
// H100 by tools/lqt_scan_probe.py: the one-thread combine takes 2.7x longer
// on natural-layout rows than on lane-major operands; the read-only path
// does not matter.)  The input and output stay in their natural layout,
// which only the level-0 phases touch.  An up phase writes its fixups in
// place (each s_l[2k+2] is read and written by the one combine that owns it)
// and copies nothing: s_l at an odd position k is s_{l+1}[k >> 1], and so
// on, so it is read where it was computed, at position k >> t of level
// l + t, t the trailing ones of k (an even position, fixed up in place or
// the level's untouched first element).  Only up phase 0 copies: every
// output position must be written, the odd ones from their resolved
// scratch element and position 0 from the input.  Phases with nothing to
// do (the last down level's empty fixup) are skipped, barrier included.
//
// Work forms, per phase (W = combines in it, G blocks of `wpb` warps):
//   * W <= wpb: the phase runs in block 0 alone, one warp per pair
//     (combine_warp), and consecutive such phases are separated by
//     __syncthreads only: the narrow middle of the tree (the deepest down and
//     the first up phases of a single record) costs no grid barrier;
//   * W <= G * wpb: one warp per pair over the whole grid: a level with
//     fewer pairs than the grid has warps would leave the one-thread form a
//     dependent chain of ~1.5k (NX = 4) to ~2.9k (NX = 5) FMAs on a few
//     threads; a warp spreads each product over its lanes (NX deep, not
//     NX^3);
//   * wider: one thread per pair (combine_thread), full warps spread over
//     the blocks, as in the pairwise kernel: there every warp of the grid
//     has pairs, and the per-pair register form does the fewest
//     instructions.
// Up phase 0 is the one phase that writes natural-layout rows (the output):
// a thread writing its own row would touch 32 rows per store instruction,
// so each warp assembles its 32 result rows in a shared-memory tile and
// writes them row by row (RowTile); the output copies go through the same
// tile, reading the lane-major scratch with consecutive lanes on
// consecutive elements.  Phases are separated by a grid-wide
// barrier (cooperative_groups grid sync), which needs every block resident:
// the launch is cooperative, with the grid sized from the occupancy of this
// instantiation (registers and shared memory) and never wider than the
// widest phase's pairs in warps.
//
// Memory.  The scratch is written and read again within the launch, so all
// loads are plain (no __restrict__, no read-only path); the grid barrier
// orders them.  The operands of an in-place up phase alias its output: the
// one-thread form reads each part before it writes that part, and the warp
// form reads everything into shared memory first.
//
// What bounds it on an H100: reading each element once and writing each
// output once is 2 * n * R * (3 NX^2 + 2 NX) values, ~1.8 MB for one record of
// 2049 elements at NX = 4 in float64 (0.55 us at 3.35 TB/s), against the
// combines' ~2 n R combine FLOPs at 34 TFLOP/s (float64 outside the tensor
// cores).  One record is bounded by neither: the tree's ~2 L dependent
// phases, each a combine's latency plus a barrier, set its time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lqt_combine.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;

template <typename T>
struct ScanArgs {
  T* in[5];              // A, b, C, eta, J of the input
  int64_t in_se[5];      // element strides, in values
  int64_t in_sr[5];      // record strides, in values
  T* out[5];
  int64_t out_se[5];
  int64_t out_sr[5];
  T* scr[5];             // the five parts of levels 1..L, dense
  int64_t n, R;
  int rev;
};

template <int NX>
__host__ __device__ constexpr int part_values(int p) {
  return (p == 1 || p == 3) ? NX : NX * NX;     // b and eta are vectors
}

// First scratch element of level lv >= 1: R * sum_{j=1}^{lv-1} (n >> j),
// from sum_{j>=1} (m >> j) = m - popcount(m).
__device__ __forceinline__ int64_t level_offset(int64_t n, int64_t R, int lv) {
  const int64_t m = n >> (lv - 1);
  return R * ((n - __popcll(n)) - (m - __popcll(m)));
}

// Element k of level `lv` of record r, in the scan's order.  Level 0 is the
// input, or the output when `dst`, one dense row per part (stride 1).
// Levels >= 1 are lane-major in the scratch: entry v of part p of element
// idx = k R + r of level lv at scr[p] + off(lv) M_p + v N_lv + idx, with
// N_lv = R n_lv elements on the level.
template <int NX, typename T>
__device__ __forceinline__ lqt::Elem<T> at(const ScanArgs<T>& a, int lv, int64_t k,
                                           int64_t r, bool dst) {
  T* p[5];
  int64_t s = 1;
  if (lv == 0) {
    const int64_t e = a.rev ? a.n - 1 - k : k;
#pragma unroll
    for (int q = 0; q < 5; ++q)
      p[q] = dst ? a.out[q] + e * a.out_se[q] + r * a.out_sr[q]
                 : a.in[q] + e * a.in_se[q] + r * a.in_sr[q];
  } else {
    const int64_t off = level_offset(a.n, a.R, lv), idx = k * a.R + r;
    s = (a.n >> lv) * a.R;
#pragma unroll
    for (int q = 0; q < 5; ++q) p[q] = a.scr[q] + off * part_values<NX>(q) + idx;
  }
  return {p[0], p[1], p[2], p[3], p[4], s};
}

// The scanned value s_lv[k] (lv >= 1) of record r: skip k's trailing ones.
template <int NX, typename T>
__device__ __forceinline__ lqt::Elem<T> scanned(const ScanArgs<T>& a, int lv,
                                                int64_t k, int64_t r) {
  const int t = __ffsll(~k) - 1;
  return at<NX>(a, lv + t, k >> t, r, false);
}

// k = q / R, r = q % R, in 32-bit arithmetic where both fit.
__device__ __forceinline__ void divmod(int64_t q, int64_t R, int64_t& k, int64_t& r) {
  if (((q | R) >> 32) == 0) {
    const uint32_t k32 = uint32_t(q) / uint32_t(R);
    k = k32;
    r = int64_t(uint32_t(q) - k32 * uint32_t(R));
  } else {
    k = q / R;
    r = q - k * R;
  }
}

// Operands and result of combine q of a phase (the operands swapped for the
// suffix scan).
template <int NX, typename T>
__device__ __forceinline__ void pair_at(const ScanArgs<T>& a, bool down, int l,
                                        int64_t q, lqt::Elem<T>& x1,
                                        lqt::Elem<T>& x2, lqt::Elem<T>& o) {
  int64_t k, r;
  divmod(q, a.R, k, r);
  if (down) {          // y_{l+1}[k] = y_l[2k] (x) y_l[2k+1]
    x1 = at<NX>(a, l, 2 * k, r, false);
    x2 = at<NX>(a, l, 2 * k + 1, r, false);
    o = at<NX>(a, l + 1, k, r, false);
  } else {             // s_l[2k+2] = s_{l+1}[k] (x) y_l[2k+2], in place
    x1 = scanned<NX>(a, l + 1, k, r);
    x2 = at<NX>(a, l, 2 * k + 2, r, false);
    o = at<NX>(a, l, 2 * k + 2, r, l == 0);
  }
  if (a.rev) {
    const lqt::Elem<T> t = x1;
    x1 = x2;
    x2 = t;
  }
}

// Rows of natural-layout output, written by a warp through its tile.  A
// lane's NX^2 or NX values go to its row of the tile; the warp then writes
// the 32 rows one after another with consecutive lanes on consecutive
// values, so each store instruction covers whole rows instead of one value
// of 32 rows.  All 32 lanes call it; a lane without a row passes null.
template <int NX, typename T>
struct RowTile {
  static constexpr int kRow = (NX * NX) | 1;   // odd: a lane's row is bank-free
  T* tile;                                      // 32 * kRow values of this warp
  int lane;

  template <int CNT>
  __device__ __forceinline__ void write_rows(T* dst) const {
    __syncwarp();
    const unsigned long long mine = reinterpret_cast<unsigned long long>(dst);
#pragma unroll
    for (int it = 0; it < CNT; ++it) {
      const int idx = it * 32 + lane, j = idx / CNT, t = idx - j * CNT;
      T* row = reinterpret_cast<T*>(__shfl_sync(0xffffffffu, mine, j));
      if (row) row[t] = tile[j * kRow + t];
    }
    __syncwarp();
  }
};

// The one-thread form's access in the scan: plain strided loads; stores to
// a natural-layout row (stride 1, only up phase 0's output) through the
// warp's RowTile, other stores strided.  The stride is the same on all
// lanes of a phase, so the branch is warp-uniform.
template <int NX, typename T>
struct ScanIO : lqt::Plain {
  RowTile<NX, T> rows;

  __device__ __forceinline__ void store_mat(T* p, int64_t s, const lqt::Mat<NX, T>& m) const {
    if (s != 1) {
      if (p) lqt::Plain::store_mat(p, s, m);
      return;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) rows.tile[rows.lane * rows.kRow + i * NX + j] = m.v[i][j];
    rows.template write_rows<NX * NX>(p);
  }
  __device__ __forceinline__ void store_vec(T* p, int64_t s, const T (&x)[NX]) const {
    if (s != 1) {
      if (p) lqt::Plain::store_vec(p, s, x);
      return;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) rows.tile[rows.lane * rows.kRow + i] = x[i];
    rows.template write_rows<NX>(p);
  }
  __device__ __forceinline__ void store_sym(T* p, int64_t s, const lqt::Mat<NX, T>& X,
                                            const lqt::Mat<NX, T>& Y) const {
    if (s != 1) {
      if (p) lqt::Plain::store_sym(p, s, X, Y);
      return;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        rows.tile[rows.lane * rows.kRow + i * NX + j] =
            T(0.5) * ((X.v[i][j] + Y.v[i][j]) + (X.v[j][i] + Y.v[j][i]));
    rows.template write_rows<NX * NX>(p);
  }
};

// Part P of one output copy through the tile: read the lane's source part
// (strided; lane-major scratch, so consecutive lanes read consecutive
// values), then write the 32 rows.
template <int NX, int P, typename T>
__device__ __forceinline__ void copy_part(const RowTile<NX, T>& rows, const lqt::Elem<T>& src,
                                          const lqt::Elem<T>& dst, bool active) {
  constexpr int M = part_values<NX>(P);
  const T* s = P == 0 ? src.A : P == 1 ? src.b : P == 2 ? src.C : P == 3 ? src.e : src.J;
  T* d = P == 0 ? dst.A : P == 1 ? dst.b : P == 2 ? dst.C : P == 3 ? dst.e : dst.J;
  if (active) {
#pragma unroll
    for (int v = 0; v < M; ++v) rows.tile[rows.lane * rows.kRow + v] = s[v * src.s];
  }
  rows.template write_rows<M>(active ? d : nullptr);
}

// The output copies of up phase 0: copy c < n_1 R is out[2k+1] = s_1[k],
// then out[0] = x_0 of each record.  One warp per 32 copies.
template <int NX, typename T>
__device__ __forceinline__ void output_copies(const ScanArgs<T>& a, const RowTile<NX, T>& rows,
                                              int64_t copies, int64_t base, int64_t step) {
  const int64_t odd = (a.n >> 1) * a.R;
  for (; base < copies; base += step) {
    const int64_t c = base + rows.lane;
    const bool active = c < copies;
    lqt::Elem<T> src{}, dst{};
    if (active && c < odd) {
      int64_t k, r;
      divmod(c, a.R, k, r);
      src = scanned<NX>(a, 1, k, r);
      dst = at<NX>(a, 0, 2 * k + 1, r, true);
    } else if (active) {
      src = at<NX>(a, 0, 0, c - odd, false);
      dst = at<NX>(a, 0, 0, c - odd, true);
    }
    copy_part<NX, 0>(rows, src, dst, active);
    copy_part<NX, 1>(rows, src, dst, active);
    copy_part<NX, 2>(rows, src, dst, active);
    copy_part<NX, 3>(rows, src, dst, active);
    copy_part<NX, 4>(rows, src, dst, active);
  }
}

// Shared memory of one warp: the row tile or the warp form's operands,
// whichever is larger.
template <int NX>
__host__ __device__ constexpr int warp_values() {
  return 32 * RowTile<NX, float>::kRow > lqt::warp_smem_values<NX>()
             ? 32 * RowTile<NX, float>::kRow
             : lqt::warp_smem_values<NX>();
}

template <int NX, typename T>
__global__ void __launch_bounds__(kMaxThreads)
lqt_scan_kernel(const ScanArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  T* const wsm = reinterpret_cast<T*>(smem_raw) + warp * warp_values<NX>();
  const int64_t G = gridDim.x;
  const int64_t n = a.n, R = a.R;
  cg::grid_group grid = cg::this_grid();

  int L = 0;
  while ((n >> (L + 1)) > 0) ++L;
  const int P = L + (L > 0 ? L : 1);           // n = 1: up phase 0 only
  bool started = false, prev_local = false;
  for (int p = 0; p < P; ++p) {
    const bool down = p < L;
    const int l = down ? p : P - 1 - p;
    const int64_t W = down ? (n >> (l + 1)) * R : (((n >> l) - 1) / 2) * R;
    const int64_t copies = (!down && l == 0) ? ((n >> 1) + 1) * R : 0;
    if (W == 0 && copies == 0) continue;       // nothing to do, no barrier
    const bool local = G == 1 || (W <= wpb && copies <= blockDim.x);
    if (started) {
      if (local && prev_local) {
        if (blockIdx.x == 0) __syncthreads();
      } else {
        grid.sync();
      }
    }
    started = true;
    prev_local = local;
    if (local && blockIdx.x != 0) continue;

    // the combines of the phase
    if (local || W <= G * wpb) {           // one warp per pair
      int64_t q = local ? warp : blockIdx.x + G * warp;
      const int64_t step = local ? wpb : G * wpb;
      for (; q < W; q += step) {
        lqt::Elem<T> x1, x2, o;
        pair_at<NX>(a, down, l, q, x1, x2, o);
        lqt::combine_warp<NX, T>(x1, x2, o, wsm, lane);
        __syncwarp();
      }
    } else {                               // one thread per pair, 32 per warp
      const ScanIO<NX, T> io{{}, {wsm, lane}};
      for (int64_t base = (blockIdx.x + G * warp) * 32; base < W;
           base += G * blockDim.x) {
        // a lane past the phase's end computes the last pair again and
        // writes nothing (the warp stores its rows together)
        const int64_t q = base + lane < W ? base + lane : W - 1;
        lqt::Elem<T> x1, x2, o;
        pair_at<NX>(a, down, l, q, x1, x2, o);
        if (base + lane >= W) o = {nullptr, nullptr, nullptr, nullptr, nullptr, o.s};
        lqt::combine_thread<NX, T>(x1, x2, o, io);
      }
    }

    // the output copies of up phase 0, 32 per warp
    if (copies) {
      const RowTile<NX, T> rows{wsm, lane};
      const int64_t base = local ? int64_t(warp) * 32 : (blockIdx.x + G * warp) * 32;
      const int64_t step = local ? int64_t(blockDim.x) : G * blockDim.x;
      output_copies<NX>(a, rows, copies, base, step);
    }
  }
}

template <int NX, typename T>
cudaError_t launch(const ScanArgs<T>& a, int threads, cudaStream_t stream,
                   int* info) {
  void (*kern)(const ScanArgs<T>) = lqt_scan_kernel<NX, T>;
  const int wpb = threads / 32;
  const size_t smem = size_t(wpb) * warp_values<NX>() * sizeof(T);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem)) !=
      cudaSuccess)
    return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  // no wider than the widest phase (down phase 0) needs in warps
  const int64_t widest = (a.n / 2) * a.R;
  int64_t grid = (widest + wpb - 1) / wpb;
  if (grid > int64_t(occ) * sms) grid = int64_t(occ) * sms;
  if (grid < 1) grid = 1;
  if (info) {
    info[0] = int(grid);
    info[1] = occ;
    info[2] = int(smem);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nx, const ScanArgs<T>& a, int threads, cudaStream_t s,
                     int* info) {
  switch (nx) {
    case 1: return launch<1, T>(a, threads, s, info);
    case 2: return launch<2, T>(a, threads, s, info);
    case 3: return launch<3, T>(a, threads, s, info);
    case 4: return launch<4, T>(a, threads, s, info);
    case 5: return launch<5, T>(a, threads, s, info);
    case 6: return launch<6, T>(a, threads, s, info);
    case 7: return launch<7, T>(a, threads, s, info);
    case 8: return launch<8, T>(a, threads, s, info);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(int nx, int rev, int64_t n, int64_t R, void* const* in,
                const int64_t* in_strides, void* const* out,
                const int64_t* out_strides, void* const* scratch, int threads,
                cudaStream_t s, int* info) {
  ScanArgs<T> a;
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
  a.rev = rev;
  return dispatch<T>(nx, a, threads, s, info);
}

}  // namespace

// Plain C entry point, bound with ctypes.  `in`/`out` hold the five part
// pointers (A, b, C, eta, J) of the input and the output, `in_strides` /
// `out_strides` ten strides in values (the five element strides, then the
// five record strides), `scratch` the five part pointers of a dense buffer of
// R * sum_{l>=1} (n >> l) elements (null when n = 1).  `dtype` is 0 for
// float32, 1 for float64; `rev` selects the suffix scan.  Launches
// cooperatively on `stream`; writes the grid size, the resident blocks per SM
// and the dynamic shared memory per block to info[0..2]; returns the launch's
// CUDA error code (0 on success).
extern "C" int lqt_scan_launch(int dtype, int nx, int rev, int64_t n, int64_t R,
                               void* const* in, const int64_t* in_strides,
                               void* const* out, const int64_t* out_strides,
                               void* const* scratch, int threads, void* stream,
                               int* info) {
  if (n <= 0 || R <= 0 || threads < 32 || threads > kMaxThreads || threads % 32)
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
