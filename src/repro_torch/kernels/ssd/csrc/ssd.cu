// Chunked SSD (mamba2 state-space dual) scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py::ssd_chunked
// (body _ssd_kernel).  Same function, not the same blocking.  For each of
// BH sequences (batch x head) and each chunk of Q steps, with
// cum = cumsum(l) over the chunk and total = cum[Q-1]:
//
//   y_t    = exp(cum_t) C_t . state                         (inter-chunk)
//          + sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dtx_s (intra-chunk)
//   state <- exp(total) state + sum_t exp(total - cum_t) dtx_t (x) B_t
//
// i.e. the paper's affine element fold (eqs. 45-46) with a diagonal
// transition.  The TPU grid walked the chunks as a sequential ("arbitrary")
// grid axis carrying the (P, S) state in VMEM scratch.  Here one block owns
// one sequence and walks its chunks in a loop, with the state in shared
// memory (float32).  The TPU kernel formed the whole Q x Q decay matrix; at
// Q = 256 that is 256 KB of float32, more than a block's 227 KB of shared
// memory, so this kernel tiles it: rows t in tiles of 64, and for each,
// columns s in tiles of 64 up to the diagonal (the tiles above it are all
// zero and skipped), forming (M o C B^T) for one 64 x 64 tile at a time.
// The cumulative sum is a block-wide scan (warp shuffles, then the warp
// totals).  Storage is float or bf16 (l is always float32); all arithmetic
// is float32, as the TPU kernel's dot products with
// preferred_element_type=float32 are; y is rounded once to dtx's dtype.
//
// What bounds it on an H100 (data-sheet peaks): at hymba-1.5b's prefill
// (BH = 8 x 50 = 400 sequences of L = 2048, P = 64, S = 16, Q = 256, bf16)
// a launch moves ~265 MB (l, dtx, B, C read once, y written once: ~79 us
// at 3.35 TB/s) and needs ~20 GFLOP of chunk products inside the causal
// triangle (~37 GFLOP as dense Q x Q tiles; ~20 us on the bf16 tensor
// cores): the bound is bytes.  Here the products run on the float32 CUDA
// cores (67 TFLOP/s peak, >= 0.3 ms), and the grid is under-filled: 400
// blocks of 256 threads on 132 SMs, each walking its 8 chunks in order.
// A chunk-parallel design (the three stages of the reference's
// ssd_scan_jnp: per-chunk elements, an associative scan over chunks, then
// per-chunk outputs) and tensor-core tiles are the later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int TQ = 64;       // rows t per tile
constexpr int TK = 64;       // columns s per tile
constexpr int TS = TQ + 4;   // row stride, in floats, of the transposed tiles
constexpr int QMAX = 256;    // largest chunk (one scan element per thread)
constexpr int SMAX = 128;    // largest state width
constexpr int NWARP = NT / 32;

static_assert(TQ == TK, "the transposed tiles share one stride");
static_assert(QMAX == NT, "the chunk scan gives each thread one step");

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
  return __float2bfloat16(x);
}

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

// Shared memory, in floats: cum[QMAX], wsum[NWARP], stT[S][P], CT[S][TS],
// BT[S][TS], xs[TK][P], WT[TK][TS].
__host__ __device__ constexpr int smem_floats(int P, int S) {
  return QMAX + NWARP + S * P + 2 * S * TS + TK * P + TK * TS;
}

template <int P, typename T>
__global__ void __launch_bounds__(NT)
    ssd_chunk_kernel(const float* __restrict__ lg, const T* __restrict__ dtx,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     T* __restrict__ y, int L, int S, int Q) {
  // y tile (TQ x P): CGY column groups of RN columns, RGY row groups of RM
  // rows.  G tile (TQ x TK): 16 x 16 threads of 4 x 4.
  constexpr int RN = P >= 16 ? P / 16 : 1;
  constexpr int CGY = P / RN;
  constexpr int RGY = NT / CGY;
  constexpr int RM = TQ / RGY;
  static_assert(CGY * RGY == NT && RM * RGY == TQ, "y thread grid");

  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);  // [QMAX]
  float* wsum = cum + QMAX;                      // [NWARP]
  float* stT = wsum + NWARP;                     // [S][P]  state, transposed
  float* CT = stT + S * P;                       // [S][TS] C rows, transposed
  float* BT = CT + S * TS;                       // [S][TS] B rows, transposed
  float* xs = BT + S * TS;                       // [TK][P] dtx rows
  float* WT = xs + TK * P;                       // [TK][TS] (M o C B^T)^T

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int yc = tid % CGY, yr = tid / CGY;
  const int gc = tid % 16, gr = tid / 16;
  const int64_t seq = blockIdx.x;
  const float* lb = lg + seq * L;
  const T* xb = dtx + seq * L * P;
  const T* bb = Bm + seq * L * S;
  const T* cb = Cm + seq * L * S;
  T* yb = y + seq * L * P;

  for (int i = tid; i < S * P; i += NT) stT[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    // ---- cum = inclusive cumsum of l over the chunk (block scan) --------
    float v = tid < Q ? lb[c0 + tid] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();  // also: the previous chunk's readers are done
    for (int w = 0; w < warp; ++w) v += wsum[w];
    if (tid < Q) cum[tid] = v;
    __syncthreads();
    const float total = cum[Q - 1];

    // ---- outputs, one tile of TQ rows at a time --------------------------
    for (int t0 = 0; t0 < Q; t0 += TQ) {
      for (int i = tid; i < TQ * S; i += NT) {
        const int t = i / S, s = i % S;
        CT[s * TS + t] =
            t0 + t < Q ? to_float(cb[int64_t(c0 + t0 + t) * S + s]) : 0.f;
      }
      __syncthreads();

      // inter-chunk: exp(cum_t) * (C_t . state)
      float yi[RM][RN], ya[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int n = 0; n < RN; ++n) yi[i][n] = ya[i][n] = 0.f;
      for (int s = 0; s < S; ++s) {
        float a[RM], b[RN];
        load_row<RM>(a, CT + s * TS + yr * RM);
        load_row<RN>(b, stT + s * P + yc * RN);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int n = 0; n < RN; ++n) yi[i][n] = fmaf(a[i], b[n], yi[i][n]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int t = t0 + yr * RM + i;
        const float e = t < Q ? expf(cum[t]) : 0.f;
#pragma unroll
        for (int n = 0; n < RN; ++n) yi[i][n] *= e;
      }

      // intra-chunk: column tiles up to the diagonal
      for (int s0 = 0; s0 <= t0; s0 += TK) {
        for (int i = tid; i < TK * S; i += NT) {
          const int t = i / S, s = i % S;
          BT[s * TS + t] =
              s0 + t < Q ? to_float(bb[int64_t(c0 + s0 + t) * S + s]) : 0.f;
        }
        for (int i = tid; i < TK * P; i += NT) {
          const int t = i / P, p = i % P;
          xs[i] = s0 + t < Q ? to_float(xb[int64_t(c0 + s0 + t) * P + p]) : 0.f;
        }
        __syncthreads();

        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
        for (int s = 0; s < S; ++s) {
          float a[4], b[4];
          load_row<4>(a, CT + s * TS + gr * 4);
          load_row<4>(b, BT + s * TS + gc * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], b[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + gr * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + gc * 4 + j;
            const bool ok = s <= t && t < Q;  // s <= t < Q
            WT[(gc * 4 + j) * TS + gr * 4 + i] =
                ok ? expf(cum[t] - cum[s]) * g[i][j] : 0.f;
          }
        }
        __syncthreads();

        for (int s = 0; s < TK; ++s) {
          float a[RM], b[RN];
          load_row<RM>(a, WT + s * TS + yr * RM);
          load_row<RN>(b, xs + s * P + yc * RN);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int n = 0; n < RN; ++n) ya[i][n] = fmaf(a[i], b[n], ya[i][n]);
        }
        __syncthreads();  // BT, xs, WT (and CT after the last tile) are free
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int t = t0 + yr * RM + i;
        if (t >= Q) continue;
        T* yrow = yb + int64_t(c0 + t) * P + yc * RN;
#pragma unroll
        for (int n = 0; n < RN; ++n) yrow[n] = from_float<T>(yi[i][n] + ya[i][n]);
      }
    }

    // ---- state <- exp(total) state + sum_t (exp(total - cum_t) dtx_t) B_t
    // Each thread owns the entries e = tid + k * NT of stT and adds the
    // increment one tile of TK steps at a time (a loop over the entries,
    // not a register array: S is known only at run time).
    const float decay = expf(total);
    for (int e = tid; e < S * P; e += NT) stT[e] *= decay;
    for (int t0 = 0; t0 < Q; t0 += TK) {
      for (int i = tid; i < TK * S; i += NT) {
        const int t = i / S, s = i % S;
        BT[s * TS + t] =
            t0 + t < Q ? to_float(bb[int64_t(c0 + t0 + t) * S + s]) : 0.f;
      }
      for (int i = tid; i < TK * P; i += NT) {
        const int t = i / P, p = i % P;
        xs[i] = t0 + t < Q ? expf(total - cum[t0 + t]) *
                                 to_float(xb[int64_t(c0 + t0 + t) * P + p])
                           : 0.f;
      }
      __syncthreads();
      const int tn = min(TK, Q - t0);
      for (int e = tid; e < S * P; e += NT) {
        const int s = e / P, p = e % P;  // stT[e] = state[p][s]
        float a = 0.f;
        for (int t = 0; t < tn; ++t) a = fmaf(xs[t * P + p], BT[s * TS + t], a);
        stT[e] += a;
      }
      __syncthreads();
    }
    // the next chunk's first __syncthreads orders these writes before reads
  }
}

template <int P, typename T>
int launch(const float* l, const void* dtx, const void* B, const void* C,
           void* y, int BH, int L, int S, int Q, cudaStream_t stream) {
  const int smem = int(sizeof(float)) * smem_floats(P, S);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  ssd_chunk_kernel<P, T><<<dim3(unsigned(BH)), dim3(NT), smem, stream>>>(
      l, static_cast<const T*>(dtx), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), L, S, Q);
  return int(cudaGetLastError());
}

template <int P>
int launch_dtype(int dtype, const float* l, const void* dtx, const void* B,
                 const void* C, void* y, int BH, int L, int S, int Q,
                 cudaStream_t stream) {
  if (dtype == 0)
    return launch<P, float>(l, dtx, B, C, y, BH, L, S, Q, stream);
  if (dtype == 1)
    return launch<P, __nv_bfloat16>(l, dtx, B, C, y, BH, L, S, Q, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// l: (BH, L) float32; dtx: (BH, L, P); B, C: (BH, L, S); y: (BH, L, P);
// contiguous; dtx/B/C/y of one dtype (0 = float32, 1 = bfloat16);
// P in {8, 16, 32, 64, 128}, 1 <= S <= 128, 1 <= Q <= 256, L % Q == 0.
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int ssd_chunked_launch(int dtype, int P, const float* l,
                                  const void* dtx, const void* B,
                                  const void* C, void* y, int BH, int L,
                                  int S, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > SMAX || Q < 1 || Q > QMAX || L % Q)
    return int(cudaErrorInvalidValue);
  switch (P) {
    case 8:
      return launch_dtype<8>(dtype, l, dtx, B, C, y, BH, L, S, Q, s);
    case 16:
      return launch_dtype<16>(dtype, l, dtx, B, C, y, BH, L, S, Q, s);
    case 32:
      return launch_dtype<32>(dtype, l, dtx, B, C, y, BH, L, S, Q, s);
    case 64:
      return launch_dtype<64>(dtype, l, dtx, B, C, y, BH, L, S, Q, s);
    case 128:
      return launch_dtype<128>(dtype, l, dtx, B, C, y, BH, L, S, Q, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
