// RWKV-6 chunked WKV recurrence for Hopper (sm_90a), chunk-parallel on the
// tensor cores:
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + u k_t^T v_t)
//
// Replaces, with rwkv6_wkv.cu's CUDA-core body, the Pallas TPU kernel
//   B4 src/repro/kernels/rwkv6_wkv/kernel.py:wkv_pallas (body _wkv_kernel)
// for the operands ops.body routes here (N a multiple of 16 up to 64, a
// chunk a multiple of 32 up to 128: rwkv6-3b's training shape and its
// smoke width, bf16 or f32).  Operands as in rwkv6_wkv.cu:
//
//   r, k, v, lw (B, S, H, N)   bf16 or f32, read through their strides
//                              (the last dimension contiguous)
//   u           (H, N)         the same dtype, contiguous
//   s0          (B, H, N, N)   f32, contiguous, or null for zeros
//   y           (B, S, H, N)   r's dtype, contiguous
//   sf          (B, H, N, N)   f32, the state after the last chunk
//   st          (B, nc, H, N, N) f32 scratch: each chunk's own state, then
//                              the state entering it
//   tot         (B, nc, H, N)  f32 scratch: exp of the chunk's last cum
//
// lw is the log-decay, clamped to [-0.35, 0] by the caller.  The
// arithmetic is the plain version's (ref.py wkv_chunked_ref), in the order
// it runs, in three launches:
//
//   1. state: for every (b, chunk, h), cum = cumsum(lw) down each column
//      from the chunk's start, row by row in order; the chunk's own state
//      at its end st = (k exp(last - cum))^T v, and tot = exp(last).
//   2. scan: for every (b, h) and state element, over the chunks in order,
//      S_c = S_{c-1} tot_c[row] + st_c with f32 CUDA-core multiply and add
//      (no fused multiply-add), written over st; the last is sf.
//   3. out: for every (b, chunk, h), the same cum (the same code, so the
//      same bits); ri = r exp(cum - lw) and kj = k exp(-cum); A[i, j] =
//      <ri_i, kj_j> for j < i, sum_c r_i u k_i on the diagonal, 0 above;
//      y = A v + ri S_enter, rounded once to r's dtype.
//
// The factorisation ri kj spans exp(+-0.35 Q) = e^+-45 at Q = 128, which
// f32 holds only because of the caller's clamp (the TPU kernel relies on
// the same).  3xTF32 keeps f32's exponent range, so it holds here too;
// bf16 or TF32 operands alone would not keep the digits (below).
//
// Products: mma.sync m16n8k8 with TF32 operands and f32 accumulators, 3xTF32
// (tiled_matmul_tf32x3.cu's split): an f32 operand x is big = x rounded to
// TF32 and small = x - big, and a product sums small big + big small + big
// big, small products first.  v, when the model runs bf16, is exact in
// TF32 and takes no small part (two passes for its products).  The tensor
// cores add with truncation; a contraction here is at most 128 deep, so
// each product is summed from zero in an accumulator of its own and joins
// the f32 result in one round-to-nearest add (32-deep slices, as
// tiled_matmul_tf32x3.cu sums over K = 4096, gave 5.0e-7 of the scale
// against 7.6e-7 here: scripts/scan_body_ab.py).  TF32 or bf16 alone keeps
// ~2^-11 or ~2^-8 of each product and breaks WKV_TOL = 2e-5 of the scale
// (tests/test_torch_rwkv6_wkv.py shows it).
//
// Shared memory and loads.  Fragments are read from f32 tiles in shared
// memory with 32-bit loads, the row strides padded so that a fragment's 32
// reads fall in 32 banks.  Operands are widened into those tiles from
// 16-byte loads (element loads where a row is not 16-byte aligned), every
// load of a block issued before its first store.  512 threads, 16 warps
// (at 256 the body took 1.26 ms, at 512 1.08: scripts/scan_body_ab.py);
// warp tiles of 16 x 16 (launch 1) and 32 x 16 (launch 3) outputs.  At
// rwkv6-3b's training shape launches 1 and 3 are 5,120 blocks each, of
// 110 KB (two an SM) and 193 KB (one an SM).
//
// Bound: the bytes.  At rwkv6-3b's training shape (B=4, S=4096, H=40,
// N=64, Q=128, bf16) r, k, v, lw and y are 419 MB: 0.125 ms at 3.35 TB/s,
// against ~2.1e10 FLOP over the causal triangles, which take 0.11 ms at
// 495 TFLOP/s in 3xTF32's passes (three a product of two f32 operands, two
// a product with bf16 v).  The scratch states add 84 MB each way, twice,
// which the bound does not count.  On an H100 80GB HBM3 at 700 W this body
// takes ~1.08 ms, 3.7x faster than rwkv6_wkv.cu's and 12% of the bound: launch 3 ~0.76 ms, launch 1 ~0.26, launch 2 ~0.06
// (PERF.md; chip_smoke.py phase 3d, scripts/scan_body_ab.py).  Known gaps:
// launch 3 waits on its loads with no other block's MMAs to overlap at
// one block an SM (a block walking several chunks, with the next one's
// loads in registers, was slower: TMA into shared memory is the lever,
// with A held as its lower triangle to make room); mma.sync runs below
// wgmma's rate; and a backward kernel (the autograd backward recomputes
// through the plain version).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;
constexpr int kMaxN = 64;
constexpr long long kSmemLimit = 232448;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Two adjacent outputs, rounded once to T.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A 16-byte word's f32 values: 4 f32, or 8 widened bf16.
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
  f[4] = __uint_as_float(v.z << 16);
  f[5] = __uint_as_float(v.z & 0xffff0000u);
  f[6] = __uint_as_float(v.w << 16);
  f[7] = __uint_as_float(v.w & 0xffff0000u);
}
// 16 bytes of T read element by element (a row that is not 16-byte
// aligned).
__device__ __forceinline__ uint4 gather(const float* p) {
  return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                    __float_as_uint(p[2]), __float_as_uint(p[3]));
}
__device__ __forceinline__ uint4 gather(const __nv_bfloat16* p) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  return make_uint4(q[0] | (static_cast<uint32_t>(q[1]) << 16),
                    q[2] | (static_cast<uint32_t>(q[3]) << 16),
                    q[4] | (static_cast<uint32_t>(q[5]) << 16),
                    q[6] | (static_cast<uint32_t>(q[7]) << 16));
}

// A thread's share of a rows x cols tile of T (row stride ld elements,
// columns contiguous, cols a multiple of 16 bytes), held in registers from
// a load issued early to a store into f32 shared memory later, so that the
// load's latency overlaps the work between them: U 16-byte words, word u
// the tile's (threadIdx.x + u kThreads)-th run of 16 bytes.  ``vec``: the
// rows are 16-byte aligned (one 16-byte load a word), else element loads.
template <typename T, int U>
struct Prefetch {
  static constexpr int V = 16 / sizeof(T);
  uint4 w[U];

  __device__ __forceinline__ void load(const T* src, long long ld, int rows,
                                       int cols, bool vec) {
    const int per_row = cols / V;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < rows * per_row) {
        const int r = e / per_row;
        const T* p = src + r * ld + (e - r * per_row) * V;
        // Cached in L2 only: shared memory leaves L1 little room.
        w[u] = vec ? __ldcg(reinterpret_cast<const uint4*>(p)) : gather(p);
      }
    }
  }

  // Into dst (row stride lds, a multiple of 4), row r scaled as (x s1[r])
  // s2[r] when s1 is given.
  __device__ __forceinline__ void store(float* dst, int lds, int rows,
                                        int cols,
                                        const float* s1 = nullptr,
                                        const float* s2 = nullptr) const {
    const int per_row = cols / V;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < rows * per_row) {
        const int r = e / per_row;
        float f[V];
        unpack(w[u], f);
        if (s1 != nullptr) {
#pragma unroll
          for (int q = 0; q < V; ++q) f[q] = f[q] * s1[r] * s2[r];
        }
        float* d = dst + r * lds + (e - r * per_row) * V;
#pragma unroll
        for (int q = 0; q < V; q += 4)
          *reinterpret_cast<float4*>(d + q) =
              make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
      }
    }
  }
};

// Element strides of one (B, S, H, N) operand; its N axis is contiguous.
struct Strides {
  long long b, s, h;
};

// x -> (big, small) as MMA operands (tiled_matmul_tf32x3.cu:93).  big is
// cvt.rna.tf32.f32(x) bit for bit, with two integer ops; small is x - big,
// exact in f32, whose 13 low bits the MMA ignores (it reads the TF32 value
// truncated toward zero).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// An operand element as a fragment register: split when it carries bits
// below TF32 (LO), else as it is (exact in TF32; small stays 0).
template <bool LO>
__device__ __forceinline__ void frag(float x, uint32_t& big,
                                     uint32_t& small) {
  if (LO) {
    split(x, big, small);
  } else {
    big = __float_as_uint(x);
    small = 0u;
  }
}

// C (16 x 8, f32) += A (16 x 8, tf32, row) B (8 x 8, tf32, col).  Not
// volatile: the compiler may interleave independent MMAs.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc (16 MT x 8 NT) += A (16 MT x K) B (K x 8 NT), with A[m][k]
// at a[m * am + k * ak] and B[k][n] at b[k * bk + n * bn], f32 in shared
// memory; K a multiple of 8.  ALO / BLO: the operand carries bits below
// TF32 (3xTF32 terms) or is exact in TF32 (its small term dropped).  The
// tensor cores sum the product from zero (they add with truncation: one
// product of at most 256 terms keeps their drift near 1e-6 of the scale),
// and it joins acc in one round-to-nearest f32 add.  Accumulator element e
// of tile (i, j) is row 16 i + g + 8 (e / 2), column 8 j + 2 t + e % 2, for
// lane 4 g + t.
template <int MT, int NT, bool ALO, bool BLO>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const float* a, int am, int ak,
                                         const float* b, int bk, int bn,
                                         int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
  // Four k-steps unrolled, so that their fragment loads can run ahead of
  // their MMAs.
#pragma unroll 4
  for (int k = 0; k < K; k += 8) {
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* p = a + (16 * i + g) * am + (k + t) * ak;
      frag<ALO>(p[0], ab[i][0], as[i][0]);
      frag<ALO>(p[8 * am], ab[i][1], as[i][1]);
      frag<ALO>(p[4 * ak], ab[i][2], as[i][2]);
      frag<ALO>(p[8 * am + 4 * ak], ab[i][3], as[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* q = b + (k + t) * bk + (8 * j + g) * bn;
      frag<BLO>(q[0], bb[j][0], bs[j][0]);
      frag<BLO>(q[4 * bk], bb[j][1], bs[j][1]);
    }
    if (ALO) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(part[i][j], as[i], bb[j]);
    }
    if (BLO) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(part[i][j], ab[i], bs[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(part[i][j], ab[i], bb[j]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// cum = cumsum(lw) down each of the N columns of lw (Q, row stride ldl)
// into cum (row stride ldc; it may be lw itself), row by row in order, one
// thread a column (launches 1 and 3 both run this, so their cums are the
// same bits).
__device__ __forceinline__ void column_cumsum(const float* lw, int ldl,
                                              float* cum, int ldc, int Q,
                                              int N) {
  const int c = threadIdx.x;
  if (c < N) {
    float run = 0.f;
    for (int i0 = 0; i0 < Q; i0 += 8) {   // eight rows' loads ahead
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = lw[(i0 + u) * ldl + c];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        run += v[u];
        cum[(i0 + u) * ldc + c] = run;
      }
    }
  }
}

// Launch 1's shared memory, in floats: lw, then cum, then k exp(last -
// cum); v; k (Q, N + 8 each); the last row's cum (N).
__host__ __device__ inline int state_smem(int N, int Q) {
  return 3 * Q * (N + 8) + N;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ lw, float* __restrict__ st,
                     float* __restrict__ tot, int S, int H, int N, int Q,
                     Strides sk, Strides sv, Strides sl, int vec) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 v
  extern __shared__ __align__(16) float smem[];
  const int ld = N + 8;
  float* Kw = smem;              // (Q, ld): lw, cum, then k exp(last - cum)
  float* V = Kw + Q * ld;        // (Q, ld): v
  float* KK = V + Q * ld;        // (Q, ld): k
  float* LAST = KK + Q * ld;     // (N): cum of the chunk's last row

  const int nc = S / Q;
  const int bch = blockIdx.x;    // (b nc + c) H + h
  const int bc = bch / H;
  const int h = bch - bc * H;
  const int b = bc / nc;
  const long long t0 = static_cast<long long>(bc - b * nc) * Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  {  // every load in flight before the first store
    Prefetch<T, kMaxQ * kMaxN * sizeof(T) / 16 / kThreads> pl, pv, pk;
    pl.load(lw + b * sl.b + t0 * sl.s + h * sl.h, sl.s, Q, N, vec);
    pv.load(v + b * sv.b + t0 * sv.s + h * sv.h, sv.s, Q, N, vec);
    pk.load(k + b * sk.b + t0 * sk.s + h * sk.h, sk.s, Q, N, vec);
    pl.store(Kw, ld, Q, N);
    pv.store(V, ld, Q, N);
    pk.store(KK, ld, Q, N);
  }
  __syncthreads();
  column_cumsum(Kw, ld, Kw, ld, Q, N);
  __syncthreads();
  for (int m = tid; m < N; m += kThreads) {
    LAST[m] = Kw[(Q - 1) * ld + m];
    tot[static_cast<size_t>(bch) * N + m] = expf(LAST[m]);
  }
  __syncthreads();
#pragma unroll 4
  for (int e = tid; e < Q * N; e += kThreads) {
    const int j = e / N;
    const int m = e - j * N;
    // The exponent is <= 0: __expf's error, below |x| 2^-23 of the
    // result, is below 2^-24 of 1 for every x.
    Kw[j * ld + m] = KK[j * ld + m] * __expf(LAST[m] - Kw[j * ld + m]);
  }
  __syncthreads();

  // st (N, N) = Kw^T V: A[m][j] = Kw[j][m], B[j][n] = V[j][n]; warp tiles
  // of 16 x 16.
  const int tiles_n = N / 16;
  float* sh = st + static_cast<size_t>(bch) * N * N;
  for (int tile = warp; tile < tiles_n * tiles_n; tile += kWarps) {
    const int tr = tile / tiles_n;
    const int tc = tile - tr * tiles_n;
    float acc[1][2][4];
    zero(acc);
    warp_mma<1, 2, true, !kExact>(acc, Kw + 16 * tr, 1, ld, V + 16 * tc, ld,
                                  1, Q);
    const int m = 16 * tr + g;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 16 * tc + 8 * j + 2 * t;
      store2(sh + m * N + n, acc[0][j][0], acc[0][j][1]);
      store2(sh + (m + 8) * N + n, acc[0][j][2], acc[0][j][3]);
    }
  }
}

// Launch 2: the entering states, in place over st, and the final state.
// One thread a float4 of one (b, h)'s state (four columns of one row m),
// NN4 = N N / 4 of them a head.
__global__ void __launch_bounds__(kThreads)
    wkv_scan_kernel(float* __restrict__ st, const float* __restrict__ tot,
                    const float* __restrict__ s0, float* __restrict__ sf,
                    int B, int nc, int H, int N) {
  const int NN4 = N * N / 4;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(B) * H * NN4) return;
  const int bh = static_cast<int>(idx / NN4);
  const int e4 = static_cast<int>(idx - static_cast<long long>(bh) * NN4);
  const int m = (4 * e4) / N;
  const int b = bh / H;
  const int h = bh - b * H;
  float4 s = s0 != nullptr
                 ? reinterpret_cast<const float4*>(s0)[idx]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* st4 = reinterpret_cast<float4*>(st);
  // Eight chunks' loads in flight before their stores.
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float4 x[8];
    float d[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      if (c0 + w < nc) {
        const size_t bch = (static_cast<size_t>(b) * nc + c0 + w) * H + h;
        x[w] = st4[bch * NN4 + e4];
        d[w] = tot[bch * N + m];
      }
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      if (c0 + w < nc) {
        const size_t bch = (static_cast<size_t>(b) * nc + c0 + w) * H + h;
        st4[bch * NN4 + e4] = s;
        s.x = __fadd_rn(__fmul_rn(s.x, d[w]), x[w].x);
        s.y = __fadd_rn(__fmul_rn(s.y, d[w]), x[w].y);
        s.z = __fadd_rn(__fmul_rn(s.z, d[w]), x[w].z);
        s.w = __fadd_rn(__fmul_rn(s.w, d[w]), x[w].w);
      }
    }
  }
  reinterpret_cast<float4*>(sf)[idx] = s;
}

// Launch 3's shared memory, in floats: r then ri, k then kj (Q, N + 4
// each); v (Q, N + 8); lw (Q, N) and cum (Q, N + 4), later A (Q, Q + 4)
// over both; the entering state (N, N + 8); u (N) and the diagonal (Q).
struct OutLayout {
  int ldr, ldv, lda, lds;
  int r, kj, v, a, cum, s, u, dg, total;
  __host__ __device__ OutLayout(int N, int Q) {
    ldr = N + 4;
    ldv = N + 8;
    lda = Q + 4;
    lds = N + 8;
    r = 0;
    kj = r + Q * ldr;
    v = kj + Q * ldr;
    a = v + Q * ldv;
    cum = a + Q * N;
    s = a + (Q * lda > Q * (N + ldr) ? Q * lda : Q * (N + ldr));
    u = s + N * lds;
    dg = u + N;
    total = dg + Q;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ lw,
                   const T* __restrict__ u, const float* __restrict__ enter,
                   T* __restrict__ y, int S, int H, int N, int Q, Strides sr,
                   Strides sk, Strides sv, Strides sl, int vec) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 v
  const OutLayout lay(N, Q);
  const int ldr = lay.ldr, ldv = lay.ldv, lda = lay.lda, lds = lay.lds;
  extern __shared__ __align__(16) float smem[];
  float* R = smem + lay.r;       // (Q, ldr): r, then ri
  float* KJ = smem + lay.kj;     // (Q, ldr): k, then kj
  float* V = smem + lay.v;       // (Q, ldv): v
  float* LW = smem + lay.a;      // (Q, N): lw
  float* CUM = smem + lay.cum;   // (Q, ldr): cum
  float* Am = smem + lay.a;      // (Q, lda): A, over lw and cum once read
  float* Ss = smem + lay.s;      // (N, lds): the entering state
  float* U = smem + lay.u;       // (N): u of this head
  float* DG = smem + lay.dg;     // (Q): sum_c r u k, A's diagonal

  const int nc = S / Q;
  const int bch = blockIdx.x;    // (b nc + c) H + h
  const int bc = bch / H;
  const int h = bch - bc * H;
  const int b = bc / nc;
  const long long t0 = static_cast<long long>(bc - b * nc) * Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  {  // every load in flight before the first store
    Prefetch<T, kMaxQ * kMaxN * sizeof(T) / 16 / kThreads> pr, pk, pv, pl;
    Prefetch<float, kMaxN * kMaxN * 4 / 16 / kThreads> ps;
    pr.load(r + b * sr.b + t0 * sr.s + h * sr.h, sr.s, Q, N, vec);
    pk.load(k + b * sk.b + t0 * sk.s + h * sk.h, sk.s, Q, N, vec);
    pv.load(v + b * sv.b + t0 * sv.s + h * sv.h, sv.s, Q, N, vec);
    pl.load(lw + b * sl.b + t0 * sl.s + h * sl.h, sl.s, Q, N, vec);
    ps.load(enter + static_cast<size_t>(bch) * N * N, N, N, N, true);
    if (tid < N) U[tid] = to_f32<T>(u[static_cast<size_t>(h) * N + tid]);
    pr.store(R, ldr, Q, N);
    pk.store(KJ, ldr, Q, N);
    pv.store(V, ldv, Q, N);
    pl.store(LW, N, Q, N);
    ps.store(Ss, lds, N, N);
  }
  __syncthreads();
  column_cumsum(LW, N, CUM, ldr, Q, N);
  // The bonus diagonal from the raw r and k: two threads a row.
  {
    const int i = tid >> 1;
    const int c0 = (tid & 1) * (N / 2);
    float d = 0.f;
    if (i < Q)
      for (int c = c0; c < c0 + N / 2; ++c)
        d = fmaf(R[i * ldr + c] * U[c], KJ[i * ldr + c], d);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (i < Q && (tid & 1) == 0) DG[i] = d;
  }
  __syncthreads();
  // ri = r exp(cum - lw) (the plain version's exponent), kj = k exp(-cum);
  // both exponents span +-45, so expf (to within an ulp).
#pragma unroll 4
  for (int e = tid; e < Q * N; e += kThreads) {
    const int i = e / N;
    const int c = e - i * N;
    const float cu = CUM[i * ldr + c];
    R[i * ldr + c] *= expf(cu - LW[i * N + c]);
    KJ[i * ldr + c] *= expf(-cu);
  }
  __syncthreads();

  // A over the tiles (32 rows, 16 columns) that reach below the diagonal:
  // column tile tc of row tile tr when 16 tc < 32 (tr + 1).  Each is
  // <ri_i, kj_j>: A = R's rows, B[c][j] = KJ[j][c].  A is written over lw
  // and cum, which no thread reads after the barrier above.
  const int row_tiles = Q / 32;
  const int col_tiles = Q / 16;
  for (int tile = warp; tile < row_tiles * col_tiles; tile += kWarps) {
    const int tr = tile / col_tiles;
    const int tc = tile - tr * col_tiles;
    if (16 * tc >= 32 * (tr + 1)) continue;
    float acc[2][2][4];
    zero(acc);
    warp_mma<2, 2, true, true>(acc, R + 32 * tr * ldr, ldr, 1,
                               KJ + 16 * tc * ldr, 1, ldr, N);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 32 * tr + 16 * i + g + 8 * (e / 2);
          const int col = 16 * tc + 8 * j + 2 * t + e % 2;
          Am[row * lda + col] = col < row ? acc[i][j][e]
                                : col == row ? DG[row] : 0.f;
        }
  }
  __syncthreads();

  // y = A v + ri S over warp tiles of 32 x 16: A's rows up to the tile's
  // end, then ri against the entering state.
  const int tiles_n = N / 16;
  const size_t y_s = static_cast<size_t>(H) * N;
  T* yb = y + (static_cast<size_t>(b) * S + t0) * y_s +
          static_cast<size_t>(h) * N;
  for (int tile = warp; tile < row_tiles * tiles_n; tile += kWarps) {
    const int tr = tile / tiles_n;
    const int tc = tile - tr * tiles_n;
    float acc[2][2][4];
    zero(acc);
    warp_mma<2, 2, true, !kExact>(acc, Am + 32 * tr * lda, lda, 1,
                                  V + 16 * tc, ldv, 1, 32 * (tr + 1));
    warp_mma<2, 2, true, true>(acc, R + 32 * tr * ldr, ldr, 1, Ss + 16 * tc,
                               lds, 1, N);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = 32 * tr + 16 * i + g;
        const int n = 16 * tc + 8 * j + 2 * t;
        store2(yb + row * y_s + n, acc[i][j][0], acc[i][j][1]);
        store2(yb + (row + 8) * y_s + n, acc[i][j][2], acc[i][j][3]);
      }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* y, void* sf, void* st,
           void* tot, int B, int S, int H, int N, int Q, Strides sr,
           Strides sk, Strides sv, Strides sl, cudaStream_t stream) {
  const int nc = S / Q;
  // The operands' rows 16-byte aligned: Prefetch reads them 16 bytes at a
  // time.
  constexpr int V = 16 / sizeof(T);
  const void* ops[] = {r, k, v, lw};
  const Strides ss[] = {sr, sk, sv, sl};
  int vec = 1;
  for (int i = 0; i < 4; ++i)
    vec &= reinterpret_cast<uintptr_t>(ops[i]) % 16 == 0 &&
           ss[i].b % V == 0 && ss[i].s % V == 0 && ss[i].h % V == 0;
  const size_t smem1 = sizeof(float) * state_smem(N, Q);
  const size_t smem3 = sizeof(float) * OutLayout(N, Q).total;
  if (static_cast<long long>(smem1) > kSmemLimit ||
      static_cast<long long>(smem3) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wkv_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * nc * H;

  wkv_state_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem1,
                         stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), static_cast<float*>(st),
      static_cast<float*>(tot), S, H, N, Q, sk, sv, sl, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long threads2 = static_cast<long long>(B) * H * N * N / 4;
  wkv_scan_kernel<<<static_cast<unsigned>((threads2 + kThreads - 1) /
                                          kThreads),
                    kThreads, 0, stream>>>(
      static_cast<float*>(st), static_cast<const float*>(tot),
      static_cast<const float*>(s0), static_cast<float*>(sf), B, nc, H, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  wkv_out_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem3,
                       stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw),
      static_cast<const T*>(u), static_cast<const float*>(st),
      static_cast<T*>(y), S, H, N, Q, sr, sk, sv, sl, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  ``bf16`` selects bf16 (1) or
// f32 (0) for r, k, v, lw, u and y; s0 may be null (a zero state); st and
// tot are f32 scratch of B nc H N N and B nc H N floats (s0, sf and st
// 16-byte aligned).  N is a multiple of 16 up to 64, Q a multiple of 32 up
// to 128, S % Q == 0; each *_b/_s/_h is an element stride of one (B, S, H,
// N) operand.  Returns the first CUDA error of the three launches: 0 on
// success.
extern "C" int rwkv6_wkv_chunk_forward(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* y, void* sf, void* st, void* tot,
    int B, int S, int H, int N, int Q, int bf16, long long r_b,
    long long r_s, long long r_h, long long k_b, long long k_s,
    long long k_h, long long v_b, long long v_s, long long v_h,
    long long l_b, long long l_s, long long l_h, void* stream) {
  if (N % 16 != 0 || N < 16 || N > kMaxN || Q % 32 != 0 || Q < 32 ||
      Q > kMaxQ || S < Q || S % Q != 0 || B < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Strides sr{r_b, r_s, r_h}, sk{k_b, k_s, k_h}, sv{v_b, v_s, v_h},
      sl{l_b, l_s, l_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, sf, st, tot, B,
                                      S, H, N, Q, sr, sk, sv, sl, s)
              : launch<float>(r, k, v, lw, u, s0, y, sf, st, tot, B, S, H,
                              N, Q, sr, sk, sv, sl, s);
}
