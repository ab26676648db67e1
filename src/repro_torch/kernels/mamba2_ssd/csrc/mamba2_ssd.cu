// Mamba-2 SSD scan for Hopper (sm_90a):
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t
//
// per head, the state S (P, N).  Replaces the Pallas TPU kernel
//   B5 src/repro/kernels/mamba2_ssd/kernel.py:ssd_pallas (body _ssd_kernel)
// and computes what it computes, not block by block:
//
//   x      (B, S, H, P)   bf16 or f32, read through its strides (P
//                         contiguous)
//   dt     (B, S, H)      x's dtype, after softplus (H contiguous)
//   A      (H,)           x's dtype, negative
//   Bs, Cs (B, S, N)      x's dtype, shared by every head (one group; N
//                         contiguous)
//   s0     (B, H, P, N)   f32, contiguous, or null for zeros
//   y      (B, S, H, P)   x's dtype, contiguous
//   sf     (B, H, P, N)   f32, the state after the last row
//
// The model hands over x, Bs and Cs as column slices of its convolution's
// output (mamba2_apply); reading them through strides saves three copies.
//
// Arithmetic, all in f32: the TPU kernel's, chunk by chunk of the
// model's Q rows (Q = 256 at full width), each chunk in tiles of kT = 64
// rows (a chunk's last tile may be shorter).  cum = cumsum(dt A) from the
// chunk's start, summed row by row in order; per tile, with base the cum
// before its first row (0 at a chunk's start) and last the cum at its
// last row: M = (C B^T) * L with L[i, j] = exp(cum_i - cum_j) for j <= i
// and 0 above; y = M (x dt) + exp(cum_i - base) (C S^T); then S =
// exp(last - base) S + (x dt)^T (B * exp(last - cum)).  At base = 0
// these are ssd_pallas's formulas; a chunk's later tiles reach its
// earlier rows through the state, which is the same sum in exact
// arithmetic.  The cums are those of the plain version (ref.py
// ssd_chunked_ref: an f32 cumsum from the chunk's start, in row order),
// so both round their decays alike: over a 256-row chunk cum reaches
// -200 and more, where its ulp is 1.5e-5.  Tiles do less work than whole
// chunks: the (Q, Q) part costs Q (N + P) / 2 FMA a row, the state's read
// and update 2 N P a row at any Q.
//
// Every decay is the exponential of a difference of cums, as in the TPU
// kernel (kernel.py:41-44, :55): never exp(cum_i) exp(-cum_j).  mamba2's
// decay has no clamp (B4's has); at the reference's initialiser A = -1
// and dt ~ 0.8, so cum reaches ~ -200 across the model's chunk, where
// exp(-cum) overflows f32.  Above the diagonal the difference is
// positive and is never exponentiated.
//
// Parallelism.  The TPU grid is (B, chunks), with all H heads' state in
// VMEM (2.6 MB at mamba2-2.7b's width) and a (Q, Q, H) decay tile (21 MB);
// neither fits an SM.  Here one block loops over the tiles of one (b, h),
// carrying the state in shared memory; the heads are spread over the
// grid, and a block may take a share of the P columns (columns of P never
// meet: the decay is per head).  Every block recomputes its tile's C B^T,
// which all heads share: about 16 N / (16 N + 16 p + N p) of its FMAs
// for p columns a block at kT = 64 (31% at mamba2-2.7b's width, p = 32),
// against no traffic between blocks.  At mamba2-2.7b's width a block
// takes 32 of the 64 columns, so at batch 4 the grid is 2 B H = 640
// blocks of 256 threads, two per SM (107 KB of shared memory each).
//
// Shared memory, f32, with NP, PP = N and the block's P columns rounded
// up to 4 (padded rows and columns are zero, which leaves every sum
// unchanged): B^T (NP, kT + 4), later scaled by exp(last - cum); x dt
// (kT, PP); the state's transpose (NP, PP); C (kT, NP + 1); M (kT, kT +
// 1); and three kT vectors.  Products run as 4 x 4 register tiles per
// thread: a broadcast operand read as scalars, the other as float4.  Only
// the lower triangle of M's 4 x 4 tiles is computed, and y's rows read M
// only up to their tile's diagonal.
//
// Bound: the bytes.  At mamba2-2.7b's training shape (B=4, S=4096, H=80,
// P=64, N=128, bf16) x, y, dt, Bs, Cs and the final state are ~357 MB:
// 0.107 ms at 3.35 TB/s, while the chunked form at Q = 256 is ~6.5e10 FLOP
// over its causal triangles (0.066 ms on bf16 tensor cores; at f32's
// accuracy, two 3xTF32 passes a product with one bf16 operand, 0.26 ms).
// This design runs ~7.1e10 FLOP as f32 FMAs on the CUDA cores (1.06 ms at
// their 67 TFLOP/s peak), so it is far from that bound: 6.38 ms on an H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 3e).  The model's shapes (P 32
// or 64, N a multiple of 16, chunks a multiple of 64) run the
// chunk-parallel tensor-core body instead (mamba2_ssd_chunk.cu, picked by
// ops.body); this body runs the rest.  Its own gaps: C B^T recomputed per
// block, no overlap of loads with math, and no backward kernel (the
// autograd backward recomputes through the plain version).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;        // rows of a tile
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Element strides of x (B, S, H, P), P contiguous.
struct XStrides {
  long long b, s, h;
};
// Element strides of a (B, S, ...) operand whose last axis is contiguous.
struct RowStrides {
  long long b, s;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The P columns a block takes: at most 32, two blocks of 107 KB on each
// SM at P = 64, N = 128.  At mamba2-2.7b's training shape on the H100
// that beats one block of all 64 columns and blocks of 16
// (scripts/ssd_p_block_ab.py times them; PERF.md has the times).
constexpr int kPBlock = 32;

// Shared-memory layout, in floats; the float4-read buffers start on
// 16-byte boundaries.
struct Layout {
  int NP, PP, ldb, ldc, ldm;
  int bt, x, st, c, m, cum, ecum, w, total;
  __host__ __device__ Layout(int N, int PB) {
    NP = round4(N);
    PP = round4(PB);
    ldb = kT + 4;
    ldc = NP + 1;
    ldm = kT + 1;
    bt = 0;
    x = bt + NP * ldb;
    st = x + kT * PP;
    c = st + NP * PP;
    m = c + round4(kT * ldc);
    cum = m + round4(kT * ldm);
    ecum = cum + kT;
    w = ecum + kT;
    total = w + kT;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const T* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ s0,
                   T* __restrict__ y, float* __restrict__ sf, int S, int H,
                   int P, int N, int Q, int PB, XStrides sx, RowStrides sd,
                   RowStrides sb, RowStrides sc) {
  const Layout lay(N, PB);
  const int NP = lay.NP, PP = lay.PP;
  const int ldb = lay.ldb, ldc = lay.ldc, ldm = lay.ldm;
  extern __shared__ __align__(16) float smem[];
  float* BT = smem + lay.bt;      // (NP, ldb): B^T, then B^T exp(last - cum)
  float* X = smem + lay.x;        // (kT, PP): x dt over this block's columns
  float* ST = smem + lay.st;      // (NP, PP): the state's transpose
  float* Cs = smem + lay.c;       // (kT, ldc): C
  float* M = smem + lay.m;        // (kT, ldm): (C B^T) * L, lower triangle
  float* CUM = smem + lay.cum;    // (kT): dt A, then cum
  float* ECUM = smem + lay.ecum;  // (kT): exp(cum_i - base)
  float* W = smem + lay.w;        // (kT): exp(last - cum_j)

  const int nsplit = (P + PB - 1) / PB;
  const int bh = blockIdx.x / nsplit;
  const int p0 = (blockIdx.x - bh * nsplit) * PB;
  const int pb = min(PB, P - p0);
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const float a = to_f32<T>(A[h]);
  const T* xb = x + b * sx.b + h * sx.h + p0;
  const T* db = dt + b * sd.b + h;
  const T* bb = Bm + b * sb.b;
  const T* cb = Cm + b * sc.b;
  const size_t y_s = static_cast<size_t>(H) * P;
  T* yb = y + static_cast<size_t>(b) * S * y_s + static_cast<size_t>(h) * P +
          p0;

  for (int e = tid; e < NP * PP; e += kThreads) {
    const int p = e / NP;
    const int n = e - p * NP;
    ST[n * PP + p] =
        s0 != nullptr && n < N && p < pb
            ? s0[(static_cast<size_t>(bh) * P + p0 + p) * N + n]
            : 0.f;
  }

  const int TQ = kT / 4;
  const int TP = PP / 4;
  const int TN = NP / 4;
  float base = 0.f;
  for (int t0 = 0; t0 < S;) {
    const int c0 = t0 - t0 % Q;   // the start of this tile's chunk
    if (t0 == c0) base = 0.f;
    const int rows = min(kT, c0 + Q - t0);
    // Stage the tile: B^T and C over all N, x dt over this block's
    // columns, dt A.  Rows past the chunk and padded columns are zero (dt
    // A = 0 there, so cum stays at the last real row's).
    for (int e = tid; e < kT * NP; e += kThreads) {
      const int i = e / NP;
      const int n = e - i * NP;
      float bv = 0.f, cv = 0.f;
      if (i < rows && n < N) {
        const long long t = t0 + i;
        bv = to_f32<T>(bb[t * sb.s + n]);
        cv = to_f32<T>(cb[t * sc.s + n]);
      }
      BT[n * ldb + i] = bv;
      Cs[i * ldc + n] = cv;
    }
    for (int e = tid; e < kT * PP; e += kThreads) {
      const int j = e / PP;
      const int p = e - j * PP;
      float v = 0.f;
      if (j < rows && p < pb) {
        const long long t = t0 + j;
        v = to_f32<T>(xb[t * sx.s + p]) * to_f32<T>(db[t * sd.s]);
      }
      X[e] = v;
    }
    if (tid < kT)
      CUM[tid] =
          tid < rows ? to_f32<T>(db[(t0 + tid) * sd.s]) * a : 0.f;
    __syncthreads();

    // cum, continued from base row by row in order (as the plain
    // version's cumsum adds), by one thread: 64 adds a tile.
    if (tid == 0) {
      float run = base;
      for (int i = 0; i < kT; ++i) {
        run += CUM[i];
        CUM[i] = run;
      }
    }
    __syncthreads();
    const float last = CUM[kT - 1];
    if (tid < kT) {
      ECUM[tid] = expf(CUM[tid] - base);
      W[tid] = expf(last - CUM[tid]);
    }

    // M over the lower triangle of 4 x 4 tiles: tile t is (ti, tj) with
    // t = ti (ti + 1) / 2 + tj, tj <= ti.
    for (int t = tid; t < TQ * (TQ + 1) / 2; t += kThreads) {
      int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      while (ti * (ti + 1) / 2 > t) --ti;
      const int tj = t - ti * (ti + 1) / 2;
      float acc[4][4] = {};
      for (int n = 0; n < NP; ++n) {
        const float4 bq =
            *reinterpret_cast<const float4*>(BT + n * ldb + 4 * tj);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cv = Cs[(4 * ti + r) * ldc + n];
          acc[r][0] = fmaf(cv, bq.x, acc[r][0]);
          acc[r][1] = fmaf(cv, bq.y, acc[r][1]);
          acc[r][2] = fmaf(cv, bq.z, acc[r][2]);
          acc[r][3] = fmaf(cv, bq.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * tj + e;
          M[i * ldm + j] =
              j <= i ? acc[r][e] * expf(CUM[i] - CUM[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // B^T exp(last - cum) for the state update (M no longer reads B^T),
    // and y = M (x dt) + exp(cum_i) (C S^T), rows of a tile reading M up
    // to their diagonal tile.
    for (int e = tid; e < NP * kT; e += kThreads) {
      const int n = e / kT;
      const int j = e - n * kT;
      BT[n * ldb + j] *= W[j];
    }
    for (int t = tid; t < TQ * TP; t += kThreads) {
      const int ti = t / TP;
      const int tp = t - ti * TP;
      float off[4][4] = {};
      for (int n = 0; n < NP; ++n) {
        const float4 sv =
            *reinterpret_cast<const float4*>(ST + n * PP + 4 * tp);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cv = Cs[(4 * ti + r) * ldc + n];
          off[r][0] = fmaf(cv, sv.x, off[r][0]);
          off[r][1] = fmaf(cv, sv.y, off[r][1]);
          off[r][2] = fmaf(cv, sv.z, off[r][2]);
          off[r][3] = fmaf(cv, sv.w, off[r][3]);
        }
      }
      float acc[4][4] = {};
      for (int j = 0; j < min(4 * ti + 4, rows); ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(X + j * PP + 4 * tp);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float mv = M[(4 * ti + r) * ldm + j];
          acc[r][0] = fmaf(mv, xv.x, acc[r][0]);
          acc[r][1] = fmaf(mv, xv.y, acc[r][1]);
          acc[r][2] = fmaf(mv, xv.z, acc[r][2]);
          acc[r][3] = fmaf(mv, xv.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        if (i >= rows) continue;
        T* yr = yb + static_cast<size_t>(t0 + i) * y_s;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * tp + e < pb)
            yr[4 * tp + e] = from_f32<T>(acc[r][e] + off[r][e] * ECUM[i]);
      }
    }
    __syncthreads();

    // S = exp(last - base) S + (B exp(last - cum))^T (x dt): each thread
    // updates its own 4 x 4 tiles of the transposed state.
    const float decay = expf(last - base);
    for (int t = tid; t < TN * TP; t += kThreads) {
      const int tn = t / TP;
      const int tp = t - tn * TP;
      float acc[4][4] = {};
      for (int j = 0; j < rows; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(X + j * PP + 4 * tp);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bv = BT[(4 * tn + r) * ldb + j];
          acc[r][0] = fmaf(bv, xv.x, acc[r][0]);
          acc[r][1] = fmaf(bv, xv.y, acc[r][1]);
          acc[r][2] = fmaf(bv, xv.z, acc[r][2]);
          acc[r][3] = fmaf(bv, xv.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* s = ST + (4 * tn + r) * PP + 4 * tp;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] = s[e] * decay + acc[r][e];
      }
    }
    __syncthreads();
    base = last;
    t0 += rows;
  }

  for (int e = tid; e < pb * N; e += kThreads) {
    const int p = e / N;
    const int n = e - p * N;
    sf[(static_cast<size_t>(bh) * P + p0 + p) * N + n] = ST[n * PP + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* s0, void* y, void* sf, int B, int S,
           int H, int P, int N, int Q, int PB, XStrides sx, RowStrides sd,
           RowStrides sb, RowStrides sc, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout(N, PB).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * H * ((P + PB - 1) / PB);
  ssd_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sf), S, H, P, N, Q, PB, sx,
      sd, sb, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  ``bf16`` selects bf16 (1) or
// f32 (0) for x, dt, A, Bs, Cs and y; s0 may be null (a zero state).
// 1 <= P <= 64, 1 <= N <= 128, 1 <= Q <= 256, S % Q == 0.  x_b/_s/_h,
// d_b/_s, b_b/_s and c_b/_s are element strides of x, dt, Bs and Cs.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int mamba2_ssd_forward(
    const void* x, const void* dt, const void* A, const void* Bs,
    const void* Cs, const void* s0, void* y, void* sf, int B, int S, int H,
    int P, int N, int Q, int bf16, long long x_b, long long x_s,
    long long x_h, long long d_b, long long d_s, long long b_b,
    long long b_s, long long c_b, long long c_s, void* stream) {
  const int PB = P < kPBlock ? P : kPBlock;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      S < 1 || S % Q != 0 || B < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const XStrides sx{x_b, x_s, x_h};
  const RowStrides sd{d_b, d_s}, sb{b_b, b_s}, sc{c_b, c_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, dt, A, Bs, Cs, s0, y, sf, B, S, H,
                                      P, N, Q, PB, sx, sd, sb, sc, s)
              : launch<float>(x, dt, A, Bs, Cs, s0, y, sf, B, S, H, P, N,
                              Q, PB, sx, sd, sb, sc, s);
}
