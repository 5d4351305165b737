// Causal / sliding-window GQA flash attention for NVIDIA Hopper (sm_90a),
// bf16 operands on the tensor cores.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention (body
// _attn_kernel) for bfloat16 with D in {16, 32, 64, 80, 128}.  Same function:
//
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h / rep, j] * scale) v[b, h / rep, j]
//
// over the keys j allowed by the causal mask (row >= col) and the window
// (row - col < window), with the q rows aligned to the END of the keys
// (row = i + Lk - Lq).  _attn_kernel does both products as dot_generals on
// bf16 operands with float32 accumulation and rounds P to v's dtype before
// PV; that is exactly a bf16 mma.sync.m16n8k16 with a float32 accumulator,
// which is what this kernel runs.  The normaliser sums the unrounded P; the
// output is acc / max(l, 1e-30) rounded to bf16.
//
// Design (FlashAttention-2 style).  One block of 4 warps owns one
// (b*Hq + h, 64-row q tile); each warp owns 16 q rows.  Q is copied once
// into shared memory and then held in registers as mma A fragments
// (ldmatrix).  K and V tiles of 64 keys are double-buffered in shared
// memory with cp.async: the next tile's copy is in flight while the
// current tile's products run.  Rows are padded by 16 bytes, so the 8 rows
// an ldmatrix phase reads fall on distinct banks (V is read with
// ldmatrix.trans).  S = Q K^T and O += P V are bf16 mma.sync with float32
// accumulators; the online softmax (running max m, normaliser l, rescale
// of O) stays in registers, with row reductions over the 4 lanes of a quad.
// The S accumulator is re-packed in registers as the A operand of PV (P
// never touches shared memory).  GQA reads the kv head h / (Hq / Hkv) in
// place.  kv tiles wholly outside the causal/window band are never loaded;
// only the tiles that straddle the band's edges or the ragged end of the
// keys are masked (masked entries get probability 0, as the TPU kernel's
// -1e30 logits give once a row has one valid key).  Ragged Lq rows are
// zero-filled on load and not written.  exp runs as exp2 on logits
// pre-scaled by scale * log2(e).
//
// What bounds it on an H100 (data-sheet peaks): at hymba-1.5b's prefill
// (B = 8, Hq = 25, Hkv = 5, L = 2048, D = 64, window 1024) a launch needs
// 80.56 GFLOP of QK^T and PV work inside the band (0.0815 ms at the
// 989 TFLOP/s bf16 tensor-core peak) and moves 125.8 MB (q, k, v read once,
// o written once: 0.0376 ms at 3.35 TB/s): the bound is operations.  The
// design puts all products on the tensor cores; what stays between it and
// the bound is mma.sync's share of the wgmma rate, the 64 x 64 tiles on the
// band's edges that are computed and masked (408 tiles per (b, h) at this
// shape, 6 % more products than the band holds), the softmax's exp2 and
// shuffles between the products, and shared-memory reads of K and V by each
// of the 4 warps.
//
// ptxas on the card (sm_90a, -O3, as chip_smoke.py's build phase prints
// it): 96 / 107 / 127 / 149 / 198 registers at D = 16 / 32 / 64 / 80 / 128,
// no spills (the launch bounds hold D <= 64 to 128 registers: 4 blocks per
// SM).
// Shared memory is dynamic, (64 + 4 * 64) * (D + 8) * 2 bytes: 15,360
// (D = 16), 25,600 (32), 46,080 (64), 56,320 (80), 87,040 (128).  The SASS
// holds 240 HMMA instructions (cuobjdump).
//
// D = 80 (hubert-xlarge, h2o-danube-1.8b) is a multiple of 16 but not a
// power of two: 5 k-slices of Q K^T, 10 n-tiles of O (5 ldmatrix.x4.trans
// pairs in P V), 10 16-byte chunks per row; the row stride of 88 elements
// (176 bytes, 11 chunks) still puts the 8 rows of an ldmatrix phase on
// distinct banks.  It takes the D > 64 launch bounds (2 blocks per SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int NW = 4;         // warps per block, 16 q rows each
constexpr int NT = NW * 32;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BQ == NW * 16, "each warp owns 16 q rows");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Two floats rounded to bf16 (nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Up to D = 64, at most 128 registers, so that 4 blocks (16 warps) share an
// SM; D = 128 (87 KB of shared memory) fits 2.
template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 4 : 2)
    flash_attn_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int Hq, int Hkv, int Lq, int Lk, int nq, int causal,
                          int window, float scale_log2) {
  constexpr int LD = D + 8;     // shared row stride (elements): +16 bytes
  constexpr int KS = D / 16;    // k-slices of Q K^T
  constexpr int DT = D / 8;     // n-tiles of O
  constexpr int CH = D / 8;     // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                        // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;                    // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x / nq, qi = blockIdx.x % nq;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qi * BQ;              // first q row of the tile
  const int qs = q0 + (Lk - Lq);       // the same row in key coordinates
  const bf16* qb = q + (int64_t)bh * Lq * D;
  const bf16* kb = k + (int64_t)(b * Hkv + hk) * Lk * D;
  const bf16* vb = v + (int64_t)(b * Hkv + hk) * Lk * D;

  // kv tiles that hold a valid entry for some row of this q tile
  int kt_end = (Lk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (qs + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && qs - window + 1 > 0) kt_begin = (qs - window + 1) / BK;

  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = q0 + r < Lq;
    cp_async16(sQ + r * LD + c, in ? qb + (int64_t)(q0 + r) * D + c : qb, in);
  }
  auto load_kv = [&](int kt, int buf) {
    bf16* dk = sK + buf * BK * LD;
    bf16* dv = sV + buf * BK * LD;
    const int k0 = kt * BK;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = k0 + r < Lk;
      const int64_t off = in ? (int64_t)(k0 + r) * D + c : 0;
      cp_async16(dk + r * LD + c, kb + off, in);
      cp_async16(dv + r * LD + c, vb + off, in);
    }
  };
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int row0 = qs + warp * 16 + g;         // key coordinates

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    __syncthreads();  // every warp is done reading buffer buf ^ 1
    if (kt + 1 < kt_end) {
      load_kv(kt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_begin) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                            (lane >> 4) * 8);
    }

    // S = Q K^T for the warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    const bf16* tk = sK + buf * BK * LD;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, tk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, mask the band's edges, online softmax
    const int k0 = kt * BK;
    const bool full = k0 + BK <= Lk && (!causal || k0 + BK - 1 <= qs) &&
                      (window <= 0 || qs + BQ - 1 - k0 < window);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (!full) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          const bool ok = col < Lk && (!causal || row >= col) &&
                          (window <= 0 || row - col < window);
          x = ok ? x : -__int_as_float(0x7f800000);  // -inf
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];  // quad-partial
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V: P (rounded to bf16) re-packed as A fragments of 16 keys
    const bf16* tv = sV + buf * BK * LD;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, tv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD +
                          dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qr = q0 + warp * 16 + g + r * 8;
    if (qr >= Lq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* orow = o + ((int64_t)bh * Lq + qr) * D + 2 * tq;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(orow + d * 8) =
          pack_bf16(acc[d][2 * r] / den, acc[d][2 * r + 1] / den);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Lq, int Lk, int causal, int window,
           float scale, cudaStream_t stream) {
  const int nq = (Lq + BQ - 1) / BQ;
  const int smem = int(sizeof(bf16)) * (BQ + 4 * BK) * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  const int64_t blocks = int64_t(B) * Hq * nq;
  flash_attn_mma_kernel<D><<<dim3(unsigned(blocks)), dim3(NT), smem,
                             stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hkv, Lq, Lk, nq,
      causal, window, scale * LOG2E);
  return int(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, Lq, D), k/v: (B, Hkv, Lk, D), o: (B, Hq, Lq, D), contiguous
// bfloat16 with 16-byte aligned base pointers; D in {16, 32, 64, 80, 128};
// Hq % Hkv == 0; Lq <= Lk; window <= 0 means no window.  Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_mma_launch(int D, const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Hq, int Hkv, int Lq, int Lk,
                                          int causal, int window, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, window, scale,
                        s);
    case 32:
      return launch<32>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, window, scale,
                        s);
    case 64:
      return launch<64>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, window, scale,
                        s);
    case 80:
      return launch<80>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, window, scale,
                        s);
    case 128:
      return launch<128>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, window,
                         scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
