// Causal / sliding-window GQA flash attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention (body
// _attn_kernel).  Same function, not the same blocking:
//
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h / rep, j] * scale) v[b, h / rep, j]
//
// over the keys j allowed by the causal mask (row >= col) and the window
// (row - col < window), with the q rows aligned to the END of the keys
// (row = i + Lk - Lq).  GQA reads the kv head h / rep in place; K and V are
// never repeated in memory.
//
// The TPU grid walked the kv tiles as a sequential ("arbitrary") grid axis
// carrying the running max, normaliser and accumulator in VMEM scratch.
// Here one block owns one (b*Hq + h, 64-row q tile) and walks the kv tiles
// in a loop, with the running state in registers (float32).  kv tiles
// wholly outside the causal/window band are skipped, so a window of W
// costs O(L*W), not O(L^2).  Masked entries get probability 0 (the TPU
// kernel's -1e30 entries are multiplied away exactly by exp(-1e30 - m) as
// soon as a row has one valid entry, and every row has its own key).  P is
// rounded to v's dtype before the PV product, as the TPU kernel does; the
// normaliser sums the unrounded P.  Output: acc / max(l, 1e-30) in q's
// dtype.
//
// Storage is float or bf16; all arithmetic is float32 on the CUDA cores.
// Each block stages Q^T and K^T (transposed, so that a thread reads its 4
// rows and 8 columns with vector loads), V and P^T in shared memory, all
// as float32; 128 threads each own a 4 x 8 tile of scores and a 4 x D/8
// tile of the accumulator, and reduce row maxima and sums over the 8
// threads of a row group with warp shuffles.
//
// What bounds it on an H100 (data-sheet peaks): at hymba-1.5b's prefill
// (B = 8, Hq = 25, Hkv = 5, L = 2048, D = 64, window 1024) a launch moves
// ~126 MB (q, k, v read once, o written once: ~38 us at 3.35 TB/s) and
// needs ~81 GFLOP of QK^T and PV work inside the band (~81 us at the
// 989 TFLOP/s bf16 tensor-core peak): the bound is operations.  This
// first kernel does that work at the float32 CUDA-core rate (67 TFLOP/s
// peak), so it cannot come within ~15x of the bound; the design's answer
// for now is only to skip the out-of-band tiles and keep all operands in
// shared memory and registers.  mma.sync/wgmma tiles on bf16 operands are
// the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // keys per kv tile
constexpr int NT = 128;      // threads per block
constexpr int RM = 4;        // q rows per thread
constexpr int CG = 8;        // threads per row group (column groups)
constexpr int RN = BK / CG;  // score columns per thread
constexpr int TS = BQ + 4;   // row stride, in floats, of the transposed tiles
constexpr float NEG = -1e30f;

static_assert(BQ == BK, "the transposed tiles share one stride");
static_assert((BQ / RM) * CG == NT, "the thread grid covers the q tile");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA do
}

// N consecutive floats from shared memory (src aligned to the vector width).
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + i);
      dst[i] = t.x;
      dst[i + 1] = t.y;
      dst[i + 2] = t.z;
      dst[i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + i);
      dst[i] = t.x;
      dst[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int Hq,
                      int Hkv, int Lq, int Lk, int nq, int causal, int window,
                      float scale) {
  constexpr int DN = D / CG;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][TS]
  float* kT = qT + D * TS;                      // [D][TS]
  float* vs = kT + D * TS;                      // [BK][D]
  float* pT = vs + BK * D;                      // [BK][TS]

  const int tid = threadIdx.x;
  const int tc = tid % CG, tr = tid / CG;
  const int bh = blockIdx.x / nq, qi = blockIdx.x % nq;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qi * BQ;               // first q row of the tile
  const int q_start = q0 + (Lk - Lq);   // the same row in key coordinates
  const T* qb = q + (int64_t)bh * Lq * D;
  const T* kb = k + (int64_t)(b * Hkv + hk) * Lk * D;
  const T* vb = v + (int64_t)(b * Hkv + hk) * Lk * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    qT[d * TS + r] =
        (q0 + r < Lq) ? to_float(qb[(int64_t)(q0 + r) * D + d]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) acc[i][dd] = 0.f;
  }

  const int nk = (Lk + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k_start = kj * BK;
    // Tiles outside the band of this q tile hold no valid entry (the
    // condition is the same for every thread of the block).
    if (causal && k_start > q_start + BQ - 1) break;
    if (window > 0 && k_start + BK - 1 <= q_start - window) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, d = i % D;
      const bool in = k_start + j < Lk;
      const int64_t off = (int64_t)(k_start + j) * D + d;
      kT[d * TS + j] = in ? to_float(kb[off]) : 0.f;
      vs[j * D + d] = in ? to_float(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RM], bk[RN];
      load_row<RM>(a, qT + d * TS + tr * RM);
      load_row<RN>(bk, kT + d * TS + tc * RN);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q_start + tr * RM + i;
      bool valid[RN];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = k_start + tc * RN + j;
        valid[j] = col < Lk && (!causal || row >= col) &&
                   (window <= 0 || row - col < window);
        s[i][j] *= scale;
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        pT[(tc * RN + j) * TS + tr * RM + i] = to_float(from_float<T>(p));
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DN; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float a[RM], vv[DN];
      load_row<RM>(a, pT + j * TS + tr * RM);
      load_row<DN>(vv, vs + j * D + tc * DN);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int dd = 0; dd < DN; ++dd)
          acc[i][dd] = fmaf(a[i], vv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + tr * RM + i;
    if (r >= Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t)bh * Lq + r) * D + tc * DN;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) orow[dd] = from_float<T>(acc[i][dd] / den);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Lq, int Lk, int causal, int window,
           float scale, cudaStream_t stream) {
  const int nq = (Lq + BQ - 1) / BQ;
  const int smem = int(sizeof(float)) * (2 * D * TS + BK * D + BK * TS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  const int64_t blocks = int64_t(B) * Hq * nq;
  flash_attn_kernel<D, T><<<dim3(unsigned(blocks)), dim3(NT), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Lq, Lk, nq,
      causal, window, scale);
  return int(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* o, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
                 int window, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<D, float>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, window,
                            scale, stream);
  if (dtype == 1)
    return launch<D, __nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal,
                                    window, scale, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, Hq, Lq, D), k/v: (B, Hkv, Lk, D), o: (B, Hq, Lq, D), contiguous,
// one dtype (0 = float32, 1 = bfloat16); D in {8, 16, 32, 64, 80, 128};
// Hq % Hkv == 0; Lq <= Lk; window <= 0 means no window.  Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(int dtype, int D, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int Hq, int Hkv, int Lq, int Lk,
                                      int causal, int window, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
      return launch_dtype<8>(dtype, q, k, v, o, B, Hq, Hkv, Lq, Lk, causal,
                             window, scale, s);
    case 16:
      return launch_dtype<16>(dtype, q, k, v, o, B, Hq, Hkv, Lq, Lk, causal,
                              window, scale, s);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, o, B, Hq, Hkv, Lq, Lk, causal,
                              window, scale, s);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, B, Hq, Hkv, Lq, Lk, causal,
                              window, scale, s);
    case 80:
      return launch_dtype<80>(dtype, q, k, v, o, B, Hq, Hkv, Lq, Lk, causal,
                              window, scale, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, B, Hq, Hkv, Lq, Lk, causal,
                               window, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
