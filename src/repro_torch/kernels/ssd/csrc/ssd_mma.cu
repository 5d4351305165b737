// Chunked SSD (mamba2 state-space dual) scan for NVIDIA Hopper (sm_90a):
// chunk-parallel, three stages, products on the bf16 tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py::ssd_chunked
// (body _ssd_kernel) for bfloat16 operands.  Same function.  For each of BH
// sequences and each chunk c of Q steps, with cum = cumsum(l) over the
// chunk and total = cum[Q-1]:
//
//   y_t     = exp(cum_t) C_t . state_c                          (inter-chunk)
//           + sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dtx_s   (intra-chunk)
//   state_{c+1} = exp(total_c) state_c + inc_c,
//   inc_c   = sum_t (exp(total_c - cum_t) dtx_t) (x) B_t,    state_0 = 0,
//
// the paper's affine element fold (eqs. 45-46) with a diagonal transition.
// The TPU kernel walked the chunks of a sequence in order, carrying the
// state in VMEM.  Here the three stages of the reference's ssd_scan_jnp run
// as three launches, so that every (sequence, chunk) is a block of its own:
//
//   1. ssd_chunk_state_kernel, one block per (sequence, chunk): the chunk's
//      element, total and inc (a (P, S) float32 tile), to float32 scratch.
//   2. ssd_state_pass_kernel, one thread per (sequence, p, s): the
//      exclusive scan over chunks, state_c written over inc_c in place
//      (sequential over the L/Q chunks: 8 at hymba's prefill).
//   3. ssd_chunk_scan_kernel, one block per (sequence, chunk, 64 columns of
//      P): y, written once, rounded to bf16.  The M o C B^T work covers
//      only the 16 x 16 tiles on and below the diagonal; the Q x Q matrix
//      is never formed (at Q = 256 it would be 256 KB of float32).
//
// Products.  Every product is a bf16 mma.sync.m16n8k16 with float32
// accumulators.  C B^T has bf16 operands and is exact up to float32
// summation, as the TPU's preferred_element_type=float32 product is.  Three
// operands are float32 in the reference: M o G in (M o G) dtx, the state in
// C state^T, and exp(total - cum) dtx in inc.  Each is split into
// hi = bf16(x) and lo = bf16(x - hi), and the two products are summed in
// float32, so each operand carries at most 2^-16 relative error
// (float32-class) and not bf16's 2^-8.  The plain emulation of that split
// (ref.py::ssd_staged_ref(split_bf16=True)) stays within 1e-5 x max|y| of
// the unsplit float32 arithmetic on the reference shapes
// (tests/test_torch_lm_kernels.py); on the card the stage-2 states agree
// with the unsplit staged plain version to ~4e-6 of their magnitude
// (chip_smoke.py).  Depths and widths under 16 (S = 4 or 8, P = 8) and
// chunk lengths that are not multiples of 16 are padded with zeros in
// shared memory.  Shared rows are padded by 16 bytes so that ldmatrix
// phases are free of bank conflicts.  Decays are exp2 of log2(e) times a
// difference of cumulative sums.
//
// What bounds it on an H100 (data-sheet peaks): at hymba-1.5b's prefill
// (BH = 8 x 50 = 400 sequences of L = 2048, P = 64, S = 16, Q = 256, bf16)
// a call must read l, dtx, B, C once and write y once: 265.4 MB, 0.0792 ms
// at 3.35 TB/s, against ~20 GFLOP of products (~0.02 ms on the tensor
// cores): the bound is bytes.  The design reads dtx and B twice (stages 1
// and 3) and moves the (400, 8, 64, 16) float32 states through device
// memory four times (13 MB each), ~0.13 ms of traffic in all.  It fills
// the card with 3200 blocks per stage; every tile copy is a cp.async issued
// before the block's cumulative-sum scan, so the copies overlap it; stage 3
// caps registers so that 3 blocks (24 warps) share an SM and one block's
// products overlap another's copies.  Stage 3's triangle of dependent
// mma -> exp -> split -> mma steps is what holds it above its copies' time.
//
// ptxas on the card (sm_90a, -O3), as chip_smoke.py's build phase prints
// them (PERF.md section 6): stage 3 at PB = 64 80 registers with 24 bytes
// of spill stores (the cost of 3 blocks per SM), at PB = 32 and 16 80 and
// 74 registers with none; stage 1 42 registers, stage 2 32, no spills; 754
// HMMA instructions in the SASS (cuobjdump).  Shared memory is
// dynamic; at hymba's shapes stage 1 takes 1,056 + 2 Qp (2 (Pp + 8) + Sp +
// 8) bytes = 87,072 and stage 3 1,056 + 2 (Qp (2 (Sp + 8) + PB + 8) + 2 PB
// (Sp + 8)) bytes = 68,640.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NW = 8;          // warps per block (stages 1 and 3)
constexpr int NT = NW * 32;
constexpr int QMAX = 256;      // largest chunk: one scan element per thread
constexpr int SMAX = 128;      // largest state width
constexpr int SCAN_BYTES = 4 * (QMAX + NW);   // cum[QMAX], wsum[NW]
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(QMAX == NT, "the chunk scan gives each thread one step");

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a * b on the tensor cores: m16n8k16, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (a, b) = hi + lo to 2^-16 relative, as packed bf16 pairs (a in the low
// half): hi = bf16(x), lo = bf16(x - hi); x - hi is exact in float32.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// A fragments (hi and lo) of a 16 x 16 float32 tile held as two m16n8
// accumulators: the S-to-P re-pack of flash attention.  a0: row g, k 0-7;
// a1: row g+8, k 0-7; a2: row g, k 8-15; a3: row g+8, k 8-15.
__device__ __forceinline__ void split_frag(const float (&w)[2][4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split2(w[j][0], w[j][1], hi[2 * j], lo[2 * j]);
    split2(w[j][2], w[j][3], hi[2 * j + 1], lo[2 * j + 1]);
  }
}

// cum[0, Qp) = inclusive cumsum of the chunk's l (entries t >= Q add 0);
// returns total = cum[Q - 1].  Ends with a __syncthreads.
__device__ float chunk_cumsum(const float* __restrict__ lc, int Q,
                              float* cum, float* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = tid < Q ? lc[tid] : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  cum[tid] = v;
  __syncthreads();
  return cum[Q - 1];
}

// rows [0, Qp) x cols [0, np) of a shared tile (row stride ld) from rows of
// n elements (row stride src_ld) starting at src; rows >= Q and cols >= n
// are zero.  16-byte cp.async copies where n is a multiple of 8, else
// element by element.  The caller waits (cp_async_wait_all) and syncs.
__device__ void load_tile(bf16* dst, int ld, const bf16* __restrict__ src,
                          int src_ld, int Q, int Qp, int n, int np) {
  if ((n & 7) == 0 && (src_ld & 7) == 0) {
    const int vpr = np / 8;
    for (int i = threadIdx.x; i < Qp * vpr; i += NT) {
      const int r = i / vpr, c = (i % vpr) * 8;
      const bool in = r < Q && c < n;
      cp_async16(dst + r * ld + c, in ? src + (int64_t)r * src_ld + c : src,
                 in);
    }
  } else {
    for (int i = threadIdx.x; i < Qp * np; i += NT) {
      const int r = i / np, c = i % np;
      dst[r * ld + c] = (r < Q && c < n) ? src[(int64_t)r * src_ld + c]
                                         : __float2bfloat16(0.f);
    }
  }
}

__host__ __device__ constexpr int state_smem(int Q, int P, int S) {
  return SCAN_BYTES +
         2 * (round16(Q) * (2 * (round16(P) + 8) + round16(S) + 8));
}

// ---- stage 1: the chunk's element -----------------------------------------
// inc (Pp x Sp) = w^T (Pp x Qp) . B (Qp x Sp), w = exp(total - cum) dtx,
// with w split into hi and lo.  Work items: 16 rows p x 16 columns s.
__global__ void __launch_bounds__(NT)
    ssd_chunk_state_kernel(const float* __restrict__ lg,
                           const bf16* __restrict__ dtx,
                           const bf16* __restrict__ Bm,
                           float* __restrict__ states,
                           float* __restrict__ totals, int L, int P, int S,
                           int Q, int nc) {
  const int Qp = round16(Q), Pp = round16(P), Sp = round16(S);
  const int LDW = Pp + 8, LDB = Sp + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* wsum = cum + QMAX;
  bf16* sHi = reinterpret_cast<bf16*>(smem_raw + SCAN_BYTES);  // [Qp][LDW]
  bf16* sLo = sHi + Qp * LDW;                                  // [Qp][LDW]
  bf16* sB = sLo + Qp * LDW;                                   // [Qp][LDB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t seq = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int64_t c0 = seq * L + int64_t(c) * Q;   // first step, flat

  // raw dtx rows go to sLo; B to sB; both in flight during the scan
  load_tile(sLo, LDW, dtx + c0 * P, P, Q, Qp, P, Pp);
  load_tile(sB, LDB, Bm + c0 * S, S, Q, Qp, S, Sp);
  const float total = chunk_cumsum(lg + c0, Q, cum, wsum);
  if (tid == 0) totals[seq * nc + c] = total;
  cp_async_wait_all();
  __syncthreads();

  // w = exp(total - cum_t) dtx_t, split in place: sLo -> (sHi, sLo).  Each
  // thread reads and rewrites its own 16-byte vectors.
  const int vpr = Pp / 8;
  for (int i = tid; i < Qp * vpr; i += NT) {
    const int t = i / vpr, p = (i % vpr) * 8;
    uint4* lo_v = reinterpret_cast<uint4*>(sLo + t * LDW + p);
    const uint4 raw = *lo_v;
    const uint32_t* x = reinterpret_cast<const uint32_t*>(&raw);
    const float e = exp2f(LOG2E * (total - cum[t]));
    uint32_t h[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[j]));
      split2(e * f.x, e * f.y, h[j], lo[j]);
    }
    *reinterpret_cast<uint4*>(sHi + t * LDW + p) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *lo_v = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();

  float* out = states + (seq * nc + c) * int64_t(P) * S;
  const int n16 = Sp / 16, items = (Pp / 16) * n16;
  for (int it = warp; it < items; it += NW) {
    const int p0 = (it / n16) * 16, s0 = (it % n16) * 16;
    float acc[2][4] = {};
    for (int k0 = 0; k0 < Qp; k0 += 16) {
      uint32_t ah[4], al[4], bf[4];
      // A = w^T: rows p, k = t, from the [t][p] tiles (transposed load)
      const int at = k0 + (lane & 7) + (lane >> 4) * 8;
      const int ap = p0 + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(ah, sHi + at * LDW + ap);
      ldsm_x4_t(al, sLo + at * LDW + ap);
      // B: k = t, n = s, from the [t][s] tile (transposed load)
      ldsm_x4_t(bf, sB + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                        s0 + (lane >> 4) * 8);
      mma_bf16(acc[0], ah, bf[0], bf[1]);
      mma_bf16(acc[1], ah, bf[2], bf[3]);
      mma_bf16(acc[0], al, bf[0], bf[1]);
      mma_bf16(acc[1], al, bf[2], bf[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + g + (e >> 1) * 8;
        const int s = s0 + j * 8 + 2 * tq + (e & 1);
        if (p < P && s < S) out[p * S + s] = acc[j][e];
      }
  }
}

// ---- stage 2: exclusive scan over chunks, in place ------------------------
__global__ void ssd_state_pass_kernel(const float* __restrict__ totals,
                                      float* __restrict__ states, int BH,
                                      int nc, int PS) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= int64_t(BH) * PS) return;
  const int64_t seq = i / PS;
  const int e = int(i % PS);
  float st = 0.f;
  for (int c = 0; c < nc; ++c) {
    float* slot = states + (seq * nc + c) * PS + e;
    const float inc = *slot;
    *slot = st;                       // the state entering chunk c
    st = expf(totals[seq * nc + c]) * st + inc;
  }
}

// ---- stage 3: outputs ------------------------------------------------------
template <int PB>
__host__ __device__ constexpr int scan_smem(int Q, int S) {
  return SCAN_BYTES + 2 * (round16(Q) * (2 * (round16(S) + 8) + PB + 8) +
                           2 * PB * (round16(S) + 8));
}

// Block (sequence, chunk, columns [pb, pb + PB) of P).  Warp w owns 16-row
// tiles of the chunk in a zigzag (w, 2 NW - 1 - w, ...) so that the
// triangle's work is shared evenly.  For each row tile:
//   y  = exp(cum_t) (C . (state_hi + state_lo)^T)
//   y += sum over column tiles on and below the diagonal of
//        (M o C B^T)_hi . dtx + (M o C B^T)_lo . dtx.
template <int PB>
__global__ void __launch_bounds__(NT, 3)
    ssd_chunk_scan_kernel(const float* __restrict__ lg,
                          const bf16* __restrict__ dtx,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm,
                          const float* __restrict__ states,
                          bf16* __restrict__ y, int L, int P, int S, int Q,
                          int nc, int npb) {
  constexpr int NDT = PB / 8;      // n-tiles of y
  const int Qp = round16(Q), Sp = round16(S);
  const int LDS = Sp + 8;
  constexpr int LDX = PB + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* wsum = cum + QMAX;
  bf16* sC = reinterpret_cast<bf16*>(smem_raw + SCAN_BYTES);  // [Qp][LDS]
  bf16* sB = sC + Qp * LDS;                                   // [Qp][LDS]
  bf16* sX = sB + Qp * LDS;                                   // [Qp][LDX]
  bf16* sHi = sX + Qp * LDX;                                  // [PB][LDS]
  bf16* sLo = sHi + PB * LDS;                                 // [PB][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int pbk = blockIdx.x % npb;
  const int64_t sc = blockIdx.x / npb;          // seq * nc + c
  const int64_t seq = sc / nc;
  const int c = int(sc % nc);
  const int64_t c0 = seq * L + int64_t(c) * Q;
  const int pb = pbk * PB;

  load_tile(sC, LDS, Cm + c0 * S, S, Q, Qp, S, Sp);
  load_tile(sB, LDS, Bm + c0 * S, S, Q, Qp, S, Sp);
  load_tile(sX, LDX, dtx + c0 * P + pb, P, Q, Qp, min(PB, P - pb), PB);
  const float* st = states + sc * int64_t(P) * S;
#pragma unroll 4
  for (int i = tid; i < PB * Sp / 2; i += NT) {
    const int p = i / (Sp / 2), s = (i % (Sp / 2)) * 2;
    const bool in = pb + p < P;
    const float a = in && s < S ? st[(pb + p) * S + s] : 0.f;
    const float b = in && s + 1 < S ? st[(pb + p) * S + s + 1] : 0.f;
    uint32_t h, lo;
    split2(a, b, h, lo);
    *reinterpret_cast<uint32_t*>(sHi + p * LDS + s) = h;
    *reinterpret_cast<uint32_t*>(sLo + p * LDS + s) = lo;
  }
  chunk_cumsum(lg + c0, Q, cum, wsum);
  cp_async_wait_all();
  __syncthreads();

  const int nrt = Qp / 16;
  for (int i = 0; i * NW < nrt; ++i) {
    const int rt = (i & 1) ? (i + 1) * NW - 1 - warp : i * NW + warp;
    if (rt >= nrt) continue;
    const int t0 = rt * 16;
    float acc[NDT][4];
#pragma unroll
    for (int d = 0; d < NDT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

    // inter-chunk: C (16 x Sp) . state^T (Sp x PB), state split hi/lo
    for (int k0 = 0; k0 < Sp; k0 += 16) {
      uint32_t cf[4];
      ldsm_x4(cf, sC + (t0 + (lane & 15)) * LDS + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < PB / 16; ++np) {
        const int off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + k0 +
                        ((lane >> 3) & 1) * 8;
        uint32_t hf[4], lf[4];
        ldsm_x4(hf, sHi + off);
        ldsm_x4(lf, sLo + off);
        mma_bf16(acc[2 * np], cf, hf[0], hf[1]);
        mma_bf16(acc[2 * np + 1], cf, hf[2], hf[3]);
        mma_bf16(acc[2 * np], cf, lf[0], lf[1]);
        mma_bf16(acc[2 * np + 1], cf, lf[2], lf[3]);
      }
    }
    const int ta = t0 + g, tb = ta + 8;
    const float cum_a = cum[ta], cum_b = cum[tb];
    const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
    for (int d = 0; d < NDT; ++d) {
      acc[d][0] *= ea;
      acc[d][1] *= ea;
      acc[d][2] *= eb;
      acc[d][3] *= eb;
    }

    // intra-chunk: column tiles s0 <= t0 (two in flight per warp)
#pragma unroll 2
    for (int s0 = 0; s0 <= t0; s0 += 16) {
      float w[2][4] = {};
      for (int k0 = 0; k0 < Sp; k0 += 16) {
        uint32_t cf[4], bf[4];
        ldsm_x4(cf, sC + (t0 + (lane & 15)) * LDS + k0 + (lane >> 4) * 8);
        ldsm_x4(bf, sB + (s0 + (lane & 7) + (lane >> 4) * 8) * LDS + k0 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(w[0], cf, bf[0], bf[1]);
        mma_bf16(w[1], cf, bf[2], bf[3]);
      }
      const bool diag = s0 == t0;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = s0 + j * 8 + 2 * tq + e;
          const float cs = cum[s];
          w[j][e] = (!diag || s <= ta)
                        ? exp2f(LOG2E * (cum_a - cs)) * w[j][e] : 0.f;
          w[j][2 + e] = (!diag || s <= tb)
                            ? exp2f(LOG2E * (cum_b - cs)) * w[j][2 + e]
                            : 0.f;
        }
      uint32_t whi[4], wlo[4];
      split_frag(w, whi, wlo);
#pragma unroll
      for (int dp = 0; dp < PB / 16; ++dp) {
        uint32_t xf[4];
        ldsm_x4_t(xf, sX + (s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                          dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], whi, xf[0], xf[1]);
        mma_bf16(acc[2 * dp + 1], whi, xf[2], xf[3]);
        mma_bf16(acc[2 * dp], wlo, xf[0], xf[1]);
        mma_bf16(acc[2 * dp + 1], wlo, xf[2], xf[3]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = ta + r * 8;
      if (t >= Q) continue;
      bf16* yrow = y + (c0 + t) * P + pb + 2 * tq;
#pragma unroll
      for (int d = 0; d < NDT; ++d)
        if (pb + d * 8 + 2 * tq < P)
          *reinterpret_cast<__nv_bfloat162*>(yrow + d * 8) =
              __floats2bfloat162_rn(acc[d][2 * r], acc[d][2 * r + 1]);
    }
  }
}

template <int PB>
int launch_scan(const float* l, const void* dtx, const void* B, const void* C,
                const float* states, void* y, int BH, int L, int P, int S,
                int Q, cudaStream_t stream) {
  const int smem = scan_smem<PB>(Q, S);
  if (smem > SMEM_MAX) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  const int nc = L / Q, npb = (round16(P) + PB - 1) / PB;
  const int64_t blocks = int64_t(BH) * nc * npb;
  ssd_chunk_scan_kernel<PB><<<dim3(unsigned(blocks)), dim3(NT), smem,
                              stream>>>(
      l, static_cast<const bf16*>(dtx), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), states, static_cast<bf16*>(y), L, P, S, Q,
      nc, npb);
  return int(cudaGetLastError());
}

bool shape_ok(int L, int P, int S, int Q) {
  return P >= 8 && P <= 128 && P % 8 == 0 && S >= 1 && S <= SMAX && Q >= 1 &&
         Q <= QMAX && L % Q == 0;
}

}  // namespace

// All three stages take: l (BH, L) float32; dtx (BH, L, P), B and C
// (BH, L, S) bfloat16, contiguous, 16-byte aligned; P a multiple of 8 up to
// 128, 1 <= S <= 128, 1 <= Q <= 256, L % Q == 0; scratch states
// (BH, L/Q, P, S) and totals (BH, L/Q) float32.  Each launches on `stream`
// and returns cudaGetLastError() after its launch.

// Stage 1: totals and the chunk increments, into states.
extern "C" int ssd_chunk_state_launch(const float* l, const void* dtx,
                                      const void* B, float* states,
                                      float* totals, int BH, int L, int P,
                                      int S, int Q, void* stream) {
  if (!shape_ok(L, P, S, Q)) return int(cudaErrorInvalidValue);
  const int smem = state_smem(Q, P, S);
  if (smem > SMEM_MAX) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  const int nc = L / Q;
  ssd_chunk_state_kernel<<<dim3(unsigned(int64_t(BH) * nc)), dim3(NT), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      l, static_cast<const bf16*>(dtx), static_cast<const bf16*>(B), states,
      totals, L, P, S, Q, nc);
  return int(cudaGetLastError());
}

// Stage 2: states[:, c] <- the state entering chunk c (in place).
extern "C" int ssd_state_pass_launch(const float* totals, float* states,
                                     int BH, int nc, int P, int S,
                                     void* stream) {
  const int64_t n = int64_t(BH) * P * S;
  const int threads = 256;
  ssd_state_pass_kernel<<<dim3(unsigned((n + threads - 1) / threads)),
                          dim3(threads), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      totals, states, BH, nc, P * S);
  return int(cudaGetLastError());
}

// Stage 3: y (BH, L, P) bfloat16 from the entering states.
extern "C" int ssd_chunk_scan_launch(const float* l, const void* dtx,
                                     const void* B, const void* C,
                                     const float* states, void* y, int BH,
                                     int L, int P, int S, int Q,
                                     void* stream) {
  if (!shape_ok(L, P, S, Q)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (round16(P)) {
    case 16:
      return launch_scan<16>(l, dtx, B, C, states, y, BH, L, P, S, Q, s);
    case 32:
      return launch_scan<32>(l, dtx, B, C, states, y, BH, L, P, S, Q, s);
    default:   // 48 .. 128: blocks of 64 columns
      return launch_scan<64>(l, dtx, B, C, states, y, BH, L, P, S, Q, s);
  }
}
