// RWKV-6 chunked WKV recurrence for Hopper (sm_90a):
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + u k_t^T v_t)
//
// Replaces the Pallas TPU kernel
//   B4 src/repro/kernels/rwkv6_wkv/kernel.py:wkv_pallas (body _wkv_kernel)
// and computes what it computes, not block by block:
//
//   r, k, v, lw (B, S, H, N)   bf16 or f32, read through their strides
//                              (the last dimension contiguous)
//   u           (H, N)         the same dtype, contiguous
//   s0          (B, H, N, N)   f32, contiguous, or null for zeros
//   y           (B, S, H, N)   r's dtype, contiguous
//   sf          (B, H, N, N)   f32, the state after the last chunk
//
// lw is the log-decay, clamped to [-0.35, 0] by the caller.  The model
// holds r, k, v and lw as (B, S, H, N); reading that layout through
// strides saves the four transposes to (B H, S, N) and the one back that
// the JAX wrapper pays (~0.4 GB a launch at full width).
//
// Arithmetic, all in f32 FMAs, chunk by chunk (Q rows, Q <= 128, S % Q ==
// 0): cum = cumsum(lw) over the chunk; ri = r exp(cum_{i-1}) and kj =
// k exp(-cum_j); A[i, j] = <ri_i, kj_j> for j < i and A[i, i] = sum_c r_i
// u k_i (the bonus diagonal); y = A v + ri S; then S = td (S + kj^T v)
// with td = exp(cum_{Q-1}), i.e. S td + (k exp(cum_{Q-1} - cum))^T v.
// The factorisation spans exp(+-0.35 Q) = e^+-45 at Q = 128, which f32
// holds only because of the caller's clamp; the TPU kernel relies on the
// same.  The plain version (ref.py wkv_chunked_ref) does this arithmetic
// in torch.
//
// Parallelism.  The TPU grid is (B H) parallel x chunks sequential; here
// one block loops over the chunks of one (b, h), carrying the state in
// shared memory.  B H is 40 per sequence at rwkv6-3b's width, too few
// blocks for 132 SMs, but the decay is diagonal in the key index, so
// column n of the state and of y depends only on v[:, n]: each block
// takes NV of the N value columns (NV = 32 at N = 64, 16 at N = 128),
// with no sum across blocks.  Each block recomputes the chunk's A, which
// does not depend on v.
//
// Shared memory, f32, with QP, NP, VP = Q, N, NV rounded up to 4 (padded
// rows and columns are zero, which leaves every sum unchanged): r then
// ri (QP, NP + 1); k^T then kj^T (NP, QP + 4); lw, then cum, then A
// (QP, max(NP, QP) + 1); v's columns (QP, VP); the state's columns
// (NP, VP); and small vectors.  160 KB at Q = 128, N = 64; 219 KB at
// Q = 128, N = 128: one block per SM.  Products run as 4 x 4 register
// tiles per thread: a broadcast operand read as scalars, the other as
// float4.  Only the lower triangle of A's 4 x 4 tiles is computed, and
// y's rows read A only up to their tile's diagonal.
//
// Bound: the bytes.  At rwkv6-3b's training shape (B=4, S=4096, H=40,
// N=64, bf16) r, k, v, lw and y are 419 MB: 0.125 ms at 3.35 TB/s, while
// the chunked form is ~2.1e10 FLOP over its causal triangles (0.022 ms on
// bf16 tensor cores; at f32's accuracy, 3xTF32's passes, 0.11 ms).  This design runs f32 FMAs on the
// CUDA cores with one block of 8 warps per SM and recomputes A per
// value-column block, so it is far from that bound.  The model's shapes
// (N a multiple of 16 up to 64, chunks a multiple of 32) run the
// chunk-parallel tensor-core body instead (rwkv6_wkv_chunk.cu, picked by
// ops.body); this body runs the rest (N = 128 among them).  Its own gaps:
// no overlap of loads with math, and no backward kernel (the autograd
// backward recomputes through the plain version).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
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

// Element strides of one (B, S, H, N) operand; its N axis is contiguous.
struct Strides {
  long long b, s, h;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The value columns a block takes: all of N up to 32, then 32, then 16
// (so the shared memory at N = 128 stays within 227 KB).
__host__ inline int value_columns(int N) {
  return N <= 32 ? N : N <= 64 ? 32 : 16;
}

// Shared-memory layout, in floats; every buffer starts on a 16-byte
// boundary.
struct Layout {
  int QP, NP, VP, ldr, ldk, lda;
  int r, kt, ca, v, st, td, u, dg, seg, total;
  __host__ __device__ Layout(int Q, int N, int NV) {
    QP = round4(Q);
    NP = round4(N);
    VP = round4(NV);
    ldr = NP + 1;
    ldk = QP + 4;
    lda = (NP > QP ? NP : QP) + 1;
    r = 0;
    kt = r + round4(QP * ldr);
    ca = kt + round4(NP * ldk);
    v = ca + round4(QP * lda);
    st = v + QP * VP;
    td = st + NP * VP;
    u = td + NP;
    dg = u + NP;
    seg = dg + QP;
    total = seg + kThreads;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ lw,
                   const T* __restrict__ u, const float* __restrict__ s0,
                   T* __restrict__ y, float* __restrict__ sf, int S, int H,
                   int N, int Q, int NV, Strides sr, Strides sk, Strides sv,
                   Strides sl) {
  const Layout lay(Q, N, NV);
  const int QP = lay.QP, NP = lay.NP, VP = lay.VP;
  const int ldr = lay.ldr, ldk = lay.ldk, lda = lay.lda;
  extern __shared__ __align__(16) float smem[];
  float* R = smem + lay.r;      // (QP, ldr): r, then ri
  float* KT = smem + lay.kt;    // (NP, ldk): k^T, then kj^T
  float* CA = smem + lay.ca;    // (QP, lda): lw, then cum, then A
  float* V = smem + lay.v;      // (QP, VP): this block's value columns
  float* ST = smem + lay.st;    // (NP, VP): the state's same columns
  float* TD = smem + lay.td;    // (NP): exp(cum of the chunk's last row)
  float* U = smem + lay.u;      // (NP): the bonus u of this head
  float* DG = smem + lay.dg;    // (QP): sum_c r u k, the diagonal of A
  float* SEG = smem + lay.seg;  // (kThreads): cumsum segment totals

  const int nsplit = (N + NV - 1) / NV;
  const int bh = blockIdx.x / nsplit;
  const int n0 = (blockIdx.x - bh * nsplit) * NV;
  const int nv = min(NV, N - n0);
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h + n0;
  const T* lb = lw + b * sl.b + h * sl.h;
  const size_t y_s = static_cast<size_t>(H) * N;
  T* yb = y + static_cast<size_t>(b) * S * y_s + static_cast<size_t>(h) * N +
          n0;

  for (int c = tid; c < NP; c += kThreads)
    U[c] = c < N ? to_f32<T>(u[static_cast<size_t>(h) * N + c]) : 0.f;
  for (int e = tid; e < NP * VP; e += kThreads) {
    const int c = e / VP;
    const int n = e - c * VP;
    ST[e] = s0 != nullptr && c < N && n < nv
                ? s0[(static_cast<size_t>(bh) * N + c) * N + n0 + n]
                : 0.f;
  }

  const int TQ = QP / 4;
  const int TV = VP / 4;
  const int G = kThreads / NP;           // cumsum segments per column
  const int L = (QP + G - 1) / G;        // rows per segment
  for (int t0 = 0; t0 < S; t0 += Q) {
    // Stage the chunk: r, k^T, lw over all N key columns; v over this
    // block's value columns.  Padded rows and columns are zero.
    for (int e = tid; e < QP * NP; e += kThreads) {
      const int i = e / NP;
      const int c = e - i * NP;
      float rv = 0.f, kv = 0.f, lv = 0.f;
      if (i < Q && c < N) {
        const long long t = t0 + i;
        rv = to_f32<T>(rb[t * sr.s + c]);
        kv = to_f32<T>(kb[t * sk.s + c]);
        lv = to_f32<T>(lb[t * sl.s + c]);
      }
      R[i * ldr + c] = rv;
      KT[c * ldk + i] = kv;
      CA[i * lda + c] = lv;
    }
    for (int e = tid; e < QP * VP; e += kThreads) {
      const int j = e / VP;
      const int n = e - j * VP;
      V[e] = j < Q && n < nv ? to_f32<T>(vb[(t0 + j) * sv.s + n]) : 0.f;
    }
    __syncthreads();

    // cum = cumsum(lw) down each column: G segments of L rows, each
    // summed by one thread, then offset by the segments above it.  The
    // bonus diagonal from the raw r and k meanwhile.
    if (tid < G * NP) {
      const int c = tid % NP;
      const int g = tid / NP;
      float run = 0.f;
      for (int i = g * L; i < min(QP, g * L + L); ++i) {
        run += CA[i * lda + c];
        CA[i * lda + c] = run;
      }
      SEG[g * NP + c] = run;
    }
    for (int i = tid; i < QP; i += kThreads) {
      float d = 0.f;
      for (int c = 0; c < NP; ++c)
        d = fmaf(R[i * ldr + c] * U[c], KT[c * ldk + i], d);
      DG[i] = d;
    }
    __syncthreads();
    if (tid < G * NP && tid >= NP) {
      const int c = tid % NP;
      const int g = tid / NP;
      float off = 0.f;
      for (int p = 0; p < g; ++p) off += SEG[p * NP + c];
      for (int i = g * L; i < min(QP, g * L + L); ++i) CA[i * lda + c] += off;
    }
    __syncthreads();

    // ri = r exp(cum_{i-1}), kj = k exp(-cum_j), td = exp(cum_{QP-1})
    // (padded rows carry lw = 0, so that is the chunk's last real row).
    for (int e = tid; e < QP * NP; e += kThreads) {
      const int i = e / NP;
      const int c = e - i * NP;
      const float prev = i > 0 ? CA[(i - 1) * lda + c] : 0.f;
      R[i * ldr + c] *= expf(prev);
      KT[c * ldk + i] *= expf(-CA[i * lda + c]);
    }
    for (int c = tid; c < NP; c += kThreads)
      TD[c] = expf(CA[(QP - 1) * lda + c]);
    __syncthreads();

    // A over the lower triangle of 4 x 4 tiles: tile t is (ti, tj) with
    // t = ti (ti + 1) / 2 + tj, tj <= ti.
    for (int t = tid; t < TQ * (TQ + 1) / 2; t += kThreads) {
      int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      while (ti * (ti + 1) / 2 > t) --ti;
      const int tj = t - ti * (ti + 1) / 2;
      float acc[4][4] = {};
      for (int c = 0; c < NP; ++c) {
        const float4 kq =
            *reinterpret_cast<const float4*>(KT + c * ldk + 4 * tj);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ra = R[(4 * ti + a) * ldr + c];
          acc[a][0] = fmaf(ra, kq.x, acc[a][0]);
          acc[a][1] = fmaf(ra, kq.y, acc[a][1]);
          acc[a][2] = fmaf(ra, kq.z, acc[a][2]);
          acc[a][3] = fmaf(ra, kq.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ti + a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * tj + e;
          CA[i * lda + j] = j < i ? acc[a][e] : j == i ? DG[i] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = A v + ri S over this block's columns, rows of a tile reading A
    // up to their diagonal tile.
    for (int t = tid; t < TQ * TV; t += kThreads) {
      const int ti = t / TV;
      const int tn = t - ti * TV;
      float acc[4][4] = {};
      for (int j = 0; j < 4 * ti + 4; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(V + j * VP + 4 * tn);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float aa = CA[(4 * ti + a) * lda + j];
          acc[a][0] = fmaf(aa, vv.x, acc[a][0]);
          acc[a][1] = fmaf(aa, vv.y, acc[a][1]);
          acc[a][2] = fmaf(aa, vv.z, acc[a][2]);
          acc[a][3] = fmaf(aa, vv.w, acc[a][3]);
        }
      }
      for (int c = 0; c < NP; ++c) {
        const float4 ss =
            *reinterpret_cast<const float4*>(ST + c * VP + 4 * tn);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ra = R[(4 * ti + a) * ldr + c];
          acc[a][0] = fmaf(ra, ss.x, acc[a][0]);
          acc[a][1] = fmaf(ra, ss.y, acc[a][1]);
          acc[a][2] = fmaf(ra, ss.z, acc[a][2]);
          acc[a][3] = fmaf(ra, ss.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ti + a;
        if (i >= Q) continue;
        T* yr = yb + static_cast<size_t>(t0 + i) * y_s;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * tn + e < nv) yr[4 * tn + e] = from_f32<T>(acc[a][e]);
      }
    }
    __syncthreads();

    // S = td (S + kj^T v): each thread updates its own 4 x 4 tile.
    for (int t = tid; t < (NP / 4) * TV; t += kThreads) {
      const int tc = t / TV;
      const int tn = t - tc * TV;
      float acc[4][4] = {};
      for (int j = 0; j < QP; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(V + j * VP + 4 * tn);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float kk = KT[(4 * tc + a) * ldk + j];
          acc[a][0] = fmaf(kk, vv.x, acc[a][0]);
          acc[a][1] = fmaf(kk, vv.y, acc[a][1]);
          acc[a][2] = fmaf(kk, vv.z, acc[a][2]);
          acc[a][3] = fmaf(kk, vv.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int c = 4 * tc + a;
        float* s = ST + c * VP + 4 * tn;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] = TD[c] * (s[e] + acc[a][e]);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < N * nv; e += kThreads) {
    const int c = e / nv;
    const int n = e - c * nv;
    sf[(static_cast<size_t>(bh) * N + c) * N + n0 + n] = ST[c * VP + n];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* y, void* sf, int B, int S,
           int H, int N, int Q, Strides sr, Strides sk, Strides sv,
           Strides sl, cudaStream_t stream) {
  const int NV = value_columns(N);
  const size_t smem = sizeof(float) * Layout(Q, N, NV).total;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * H * ((N + NV - 1) / NV);
  wkv_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw),
      static_cast<const T*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sf), S, H, N, Q, NV, sr, sk,
      sv, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  ``bf16`` selects bf16 (1) or
// f32 (0) for r, k, v, lw, u and y; s0 may be null (a zero state).
// 1 <= N <= 128, 1 <= Q <= 128, S % Q == 0; each *_b/_s/_h is an
// element stride of one (B, S, H, N) operand.  Returns
// cudaGetLastError() after the launch: 0 on success.
extern "C" int rwkv6_wkv_forward(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* y, void* sf, int B, int S, int H,
    int N, int Q, int bf16, long long r_b, long long r_s, long long r_h,
    long long k_b, long long k_s, long long k_h, long long v_b,
    long long v_s, long long v_h, long long l_b, long long l_s,
    long long l_h, void* stream) {
  if (N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ || S % Q != 0 || B < 0 ||
      H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Strides sr{r_b, r_s, r_h}, sk{k_b, k_s, k_h}, sv{v_b, v_s, v_h},
      sl{l_b, l_s, l_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, sf, B, S, H, N,
                                      Q, sr, sk, sv, sl, s)
              : launch<float>(r, k, v, lw, u, s0, y, sf, B, S, H, N, Q, sr,
                              sk, sv, sl, s);
}
