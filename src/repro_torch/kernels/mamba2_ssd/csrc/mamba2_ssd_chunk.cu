// Mamba-2 SSD scan for Hopper (sm_90a), chunk-parallel on the tensor cores:
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t
//
// per head, the state S (P, N).  Replaces, with mamba2_ssd.cu's CUDA-core
// body, the Pallas TPU kernel
//   B5 src/repro/kernels/mamba2_ssd/kernel.py:ssd_pallas (body _ssd_kernel)
// for the operands ops.body routes here (P 32 or 64, N a multiple of 16 up
// to 128, a chunk a multiple of 64 up to 256: mamba2-2.7b's training
// shape and its smoke width, bf16 or f32).  Operands as in mamba2_ssd.cu:
//
//   x      (B, S, H, P)   bf16 or f32, read through its strides (P
//                         contiguous)
//   dt     (B, S, H)      x's dtype, after softplus (H contiguous)
//   A      (H,)           x's dtype, negative
//   Bs, Cs (B, S, N)      x's dtype, shared by every head (N contiguous)
//   s0     (B, H, P, N)   f32, contiguous, or null for zeros
//   y      (B, S, H, P)   x's dtype, contiguous
//   sf     (B, H, P, N)   f32, the state after the last row
//   st     (B, nc, H, P, N) f32 scratch: each chunk's own state, then the
//                         state entering it
//   cum    (B, nc, H, Q)  f32 scratch: each chunk's cumsum of dt A
//   tot    (B, nc, H)     f32 scratch: exp of the chunk's last cum
//
// The arithmetic is the plain version's (ref.py ssd_chunked_ref), in the
// order it runs, in three launches:
//
//   1. state: for every (b, chunk) and a group of heads, cum = cumsum(dt A)
//      from the chunk's start, summed row by row in order by one thread
//      (the plain version's cums, so both round their decays alike: at
//      cum ~ -200 its ulp is 1.5e-5, the size of the tolerance); the
//      chunk's own state at its end st = (x dt exp(last - cum))^T B, and
//      tot = exp(last).  B's rows are staged once for the group's heads.
//   2. scan: for every (b, h) and state element, over the chunks in order,
//      the entering state S_c = tot_c S_{c-1} + st_c with f32 CUDA-core
//      multiply and add (no fused multiply-add, as torch computes it),
//      written over st; the last is sf.
//   3. out: for every (b, chunk), 64-row tile of the chunk and group of
//      heads: C B^T for the tile's rows against rows 0 .. its end, once
//      for the group (C B^T is shared by every head: one group of B and
//      C); per head y = M x + exp(cum_i) (C S^T), M[i, j] =
//      (C B^T)[i, j] exp(cum_i - cum_j) dt_j for j <= i and 0 above, y
//      rounded once to x's dtype.  dt joins M rather than x (the plain
//      version scales x), so x stays exact in TF32 when it is bf16.
//
// Every decay is the exponential of a difference of cums, never exp(cum_i)
// exp(-cum_j), and never of a positive difference: mamba2's decay is not
// clamped, and cum passes -88 (where exp(-cum) overflows f32) inside a
// chunk at the reference's initialiser (trap C10).  Above the diagonal M
// is 0 without an exponential.
//
// Products: mma.sync m16n8k8 with TF32 operands and f32 accumulators, 3xTF32
// (tiled_matmul_tf32x3.cu's split): an f32 operand x is big = x rounded to
// TF32 and small = x - big, and a product sums small big + big small + big
// big, small products first.  An operand that is exact in TF32 — a bf16
// value widened to f32: x, Bs and Cs when the model runs bf16 — takes no
// small part, so its products take two passes (one for C B^T, whose two
// operands are both exact: each product then is exact, as a bf16 MMA's
// would be).  The tensor cores add with truncation; a contraction here is
// at most 256 deep, so each product is summed from zero in an accumulator
// of its own and joins the f32 result in one round-to-nearest add.
// Summing 32-deep slices instead (as tiled_matmul_tf32x3.cu must over
// K = 4096) moved the largest f32 error at mamba2-2.7b's shape from 1.1e-6
// to 4.9e-7 of the scale and cost 5% of the time (scripts/scan_body_ab.py).
// TF32 or bf16 alone keeps ~2^-11 or ~2^-8 of each product and breaks
// WKV_TOL = 2e-5 of the scale (tests/test_torch_mamba2_ssd.py shows it).
//
// Shared memory and loads.  Fragments are read from f32 tiles in shared
// memory with 32-bit loads, the row strides padded so that a fragment's 32
// reads fall in 32 banks (stride = 4 mod 32 where the fragment's 8 groups
// run along rows, 8 mod 32 where its 4 lanes of a group do).  Operands are
// widened into those tiles from 16-byte loads (element loads where a row
// is not 16-byte aligned); launch 1 loads the next head's x rows, and
// launch 3 the next head's entering state and the next tile's x rows,
// into registers while the current ones are multiplied (Prefetch).
// 512 threads, 16 warps (scripts/scan_body_ab.py read 2.50 ms at 256
// threads and 2.13 at 512, in two calls), warp tiles of 32 x 16
// (launch 1) and 16 x 16 (launch 3) outputs.  At mamba2-2.7b's training
// shape launch 1 is 640 blocks of 223 KB, launch 3 2,048 of 172 KB: one
// block an SM.
//
// Bound: 3xTF32's products.  At mamba2-2.7b's training shape (B=4, S=4096,
// H=80, P=64, N=128, Q=256, bf16) the chunked form is ~6.5e10 FLOP over
// its causal triangles.  Each per-head product has one bf16 operand, exact
// in TF32, so it takes two tensor-core passes at 495 TFLOP/s, and C B^T
// one bf16 pass: 0.26 ms, against ~357 MB of x, y, dt, Bs, Cs and the
// final state (0.107 ms at 3.35 TB/s).  The scratch states add 168 MB each way, twice (launches 1 -> 2
// -> 3), which the bound does not count.  On an H100 80GB HBM3 at 700 W
// this body takes ~2.1 ms, 3.0x faster than mamba2_ssd.cu's and 12% of
// the bound: launch 3 ~1.57 ms, launch 1 ~0.44, launch 2 ~0.12 (PERF.md;
// chip_smoke.py phase 3e, scripts/scan_body_ab.py).  Known gaps: with one
// block an SM a warp waits on its own loads and barriers, with little
// other work to overlap (TMA into shared memory and warp specialisation
// are the levers; splitting S and M once into two planes, in place of
// each warp splitting its fragments, was slower); mma.sync runs below
// wgmma's rate; and a backward kernel (the autograd backward recomputes
// through the plain version).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // rows of launch 3's output tile
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
// Heads a block of launch 1 takes (B's rows staged once for them) and of
// launch 3 (C B^T computed once for them).  scripts/scan_body_ab.py times
// other values: at mamba2-2.7b's training shape 4 state heads and 5 or 40
// output heads were slower, 20 output heads tied 10.
constexpr int kStateHeads = 8;
constexpr int kOutHeads = 10;
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
// Copy a rows x cols tile of T (row stride ld elements, columns
// contiguous) into f32 shared memory (row stride lds, a multiple of 4),
// widened.  With every row 16-byte aligned and cols a multiple of a 16-byte
// load's elements, each thread issues four 16-byte loads before it stores
// any (so their latencies overlap); otherwise one element at a time.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int lds, const T* src,
                                      long long ld, int rows, int cols) {
  constexpr int V = 16 / sizeof(T);   // elements a 16-byte load
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && ld % V == 0 &&
      cols % V == 0) {
    const int per_row = cols / V;
    const int total = rows * per_row;
    for (int e0 = threadIdx.x; e0 < total; e0 += 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) {
          const int r = e / per_row;
          v[u] = *reinterpret_cast<const uint4*>(
              src + r * ld + (e - r * per_row) * V);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) {
          const int r = e / per_row;
          float f[V];
          unpack(v[u], f);
          float* d = dst + r * lds + (e - r * per_row) * V;
#pragma unroll
          for (int q = 0; q < V; q += 4)
            *reinterpret_cast<float4*>(d + q) =
                make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols;
      const int c = e - r * cols;
      dst[r * lds + c] = to_f32<T>(src[r * ld + c]);
    }
  }
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

// Element strides of x (B, S, H, P), P contiguous.
struct XStrides {
  long long b, s, h;
};
// Element strides of a (B, S, ...) operand whose last axis is contiguous.
struct RowStrides {
  long long b, s;
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

// Launch 1's product for one head: st (P, N) = Xw^T B, A[p][j] = Xw[j][p],
// B[j][n] = Bsm[j][n], over warp tiles of 32 x 16 (one a warp at
// mamba2-2.7b's width), written to sh.
template <bool kExact>
__device__ __forceinline__ void state_product(const float* Xw, int ldx,
                                              const float* Bsm, int ldb,
                                              float* sh, int P, int N,
                                              int Q) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  constexpr int NT = 2;
  const int tiles_n = N / (8 * NT);
  const int tiles = (P / 32) * tiles_n;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int tr = tile / tiles_n;
    const int tc = tile - tr * tiles_n;
    float acc[2][NT][4];
    zero(acc);
    warp_mma<2, NT, true, !kExact>(acc, Xw + 32 * tr, 1, ldx,
                                   Bsm + 8 * NT * tc, ldb, 1, Q);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int p = 32 * tr + 16 * i + g;
        const int n = 8 * NT * tc + 8 * j + 2 * t;
        store2(sh + p * N + n, acc[i][j][0], acc[i][j][1]);
        store2(sh + (p + 8) * N + n, acc[i][j][2], acc[i][j][3]);
      }
  }
}

// Launch 1's shared memory, in floats: B's rows (Q, N + 8); x dt exp(last
// - cum) (Q, P + 8); the group's cums (kStateHeads, Q); a head's exp(last
// - cum) and dt (Q each).
__host__ __device__ inline int state_smem(int P, int N, int Q) {
  return Q * (N + 8) + Q * (P + 8) + kStateHeads * Q + 2 * Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const T* __restrict__ A, const T* __restrict__ Bm,
                     float* __restrict__ st, float* __restrict__ cum,
                     float* __restrict__ tot, int S, int H, int P, int N,
                     int Q, XStrides sx, RowStrides sd, RowStrides sb,
                     int vec) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 operands
  extern __shared__ __align__(16) float smem[];
  const int ldb = N + 8;
  const int ldx = P + 8;
  float* Bsm = smem;                  // (Q, ldb): B's rows
  float* Xw = Bsm + Q * ldb;          // (Q, ldx): x dt exp(last - cum)
  float* CUM = Xw + Q * ldx;          // (kStateHeads, Q): dt A, then cum
  float* W = CUM + kStateHeads * Q;   // (Q): exp(last - cum_j)
  float* D = W + Q;                   // (Q): dt_j

  const int nc = S / Q;
  const int groups = (H + kStateHeads - 1) / kStateHeads;
  const int bc = blockIdx.x / groups;           // b nc + c
  const int h0 = (blockIdx.x - bc * groups) * kStateHeads;
  const int nh = min(kStateHeads, H - h0);
  const int b = bc / nc;
  const long long t0 = static_cast<long long>(bc - b * nc) * Q;
  const int tid = threadIdx.x;
  const T* xb = x + b * sx.b + t0 * sx.s;

  // A head's x rows, loaded a head ahead of their use.
  Prefetch<T, kMaxQ * kMaxP * sizeof(T) / 16 / kThreads> xn;
  xn.load(xb + h0 * sx.h, sx.s, Q, P, vec);
  stage<T>(Bsm, ldb, Bm + b * sb.b + t0 * sb.s, sb.s, Q, N);
  const T* db = dt + b * sd.b + t0 * sd.s + h0;
  for (int e = tid; e < nh * Q; e += kThreads) {
    const int i = e / nh;
    const int hh = e - i * nh;
    CUM[hh * Q + i] = to_f32<T>(db[i * sd.s + hh]) * to_f32<T>(A[h0 + hh]);
  }
  __syncthreads();
  // cum, row by row in order from the chunk's start: one thread a head,
  // eight rows' loads ahead of their adds.
  if (tid < nh) {
    float* cu = CUM + tid * Q;
    float run = 0.f;
    for (int i0 = 0; i0 < Q; i0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = cu[i0 + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        run += v[u];
        cu[i0 + u] = run;
      }
    }
    tot[static_cast<size_t>(bc) * H + h0 + tid] = expf(run);
  }
  __syncthreads();
  for (int e = tid; e < nh * Q; e += kThreads) {
    const int hh = e / Q;
    const int i = e - hh * Q;
    cum[(static_cast<size_t>(bc) * H + h0 + hh) * Q + i] = CUM[e];
  }

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* cu = CUM + hh * Q;
    const float last = cu[Q - 1];
    // The exponent is <= 0: __expf's error, below |x| 2^-23 of the
    // result, is below 2^-24 of 1 for every x.
    for (int i = tid; i < Q; i += kThreads) {
      W[i] = __expf(last - cu[i]);
      D[i] = to_f32<T>(db[i * sd.s + hh]);
    }
    __syncthreads();   // W, D written; the last head's MMAs read Xw
    xn.store(Xw, ldx, Q, P, D, W);
    __syncthreads();
    if (hh + 1 < nh) xn.load(xb + (h + 1) * sx.h, sx.s, Q, P, vec);
    state_product<kExact>(Xw, ldx, Bsm, ldb,
                          st + (static_cast<size_t>(bc) * H + h) * P * N, P,
                          N, Q);
  }
}

// Launch 2: the entering states, in place over st, and the final state.
// One thread a float4 of one (b, h)'s state, PN4 = P N / 4 of them a head.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(float* __restrict__ st, const float* __restrict__ tot,
                    const float* __restrict__ s0, float* __restrict__ sf,
                    int B, int nc, int H, int PN4) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(B) * H * PN4) return;
  const int bh = static_cast<int>(idx / PN4);
  const int e4 = static_cast<int>(idx - static_cast<long long>(bh) * PN4);
  const int b = bh / H;
  const int h = bh - b * H;
  float4 s = s0 != nullptr
                 ? reinterpret_cast<const float4*>(s0)[idx]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* st4 = reinterpret_cast<float4*>(st);
  // Eight chunks' loads in flight before their stores.
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float4 v[8];
    float d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < nc) {
        const size_t bch = (static_cast<size_t>(b) * nc + c0 + u) * H + h;
        v[u] = st4[bch * PN4 + e4];
        d[u] = tot[bch];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < nc) {
        const size_t bch = (static_cast<size_t>(b) * nc + c0 + u) * H + h;
        st4[bch * PN4 + e4] = s;
        s.x = __fadd_rn(__fmul_rn(s.x, d[u]), v[u].x);
        s.y = __fadd_rn(__fmul_rn(s.y, d[u]), v[u].y);
        s.z = __fadd_rn(__fmul_rn(s.z, d[u]), v[u].z);
        s.w = __fadd_rn(__fmul_rn(s.w, d[u]), v[u].w);
      }
    }
  }
  reinterpret_cast<float4*>(sf)[idx] = s;
}

// Launch 3's shared memory, in floats: C's tile rows (kRows, N + 4); C B^T
// (kRows, Q + 4); then either B's rows of one tile (kRows, N + 4), while
// C B^T is computed, or a head's entering state (P, N + 4), x's rows of
// one tile (kRows, P + 8) and M's tile (kRows, kRows + 4); cum and dt of
// the rows up to the tile's end (Q each).
struct OutLayout {
  int ldc, ldcb, ldx, ldm, lds;
  int c, cb, u, s, x, m, cum, dt, total;
  __host__ __device__ OutLayout(int P, int N, int Q) {
    ldc = N + 4;
    ldcb = Q + 4;
    ldx = P + 8;
    ldm = kRows + 4;
    lds = N + 4;
    c = 0;
    cb = c + kRows * ldc;
    u = cb + kRows * ldcb;
    s = u;
    x = s + P * lds;
    m = x + kRows * ldx;
    const int head = m + kRows * ldm;
    const int btile = u + kRows * ldc;
    cum = head > btile ? head : btile;
    dt = cum + Q;
    total = dt + Q;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_out_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const float* __restrict__ enter,
                   const float* __restrict__ cum, T* __restrict__ y, int S,
                   int H, int P, int N, int Q, XStrides sx, RowStrides sd,
                   RowStrides sb, RowStrides sc, int vec) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 operands
  const OutLayout lay(P, N, Q);
  const int ldc = lay.ldc, ldcb = lay.ldcb, ldx = lay.ldx, ldm = lay.ldm,
            lds = lay.lds;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem + lay.c;       // (kRows, ldc): C's rows of the tile
  float* CB = smem + lay.cb;      // (kRows, ldcb): C B^T up to the tile
  float* Bt = smem + lay.u;       // (kRows, ldc): B's rows of one tile
  float* Ss = smem + lay.s;       // (P, lds): the entering state
  float* Xs = smem + lay.x;       // (kRows, ldx): x's rows of one tile
  float* Ms = smem + lay.m;       // (kRows, ldm): M's tile
  float* CUM = smem + lay.cum;    // (Q): cum of rows 0 .. the tile's end
  float* DT = smem + lay.dt;      // (Q): dt of the same rows

  const int nc = S / Q;
  const int row_tiles = Q / kRows;
  const int groups = (H + kOutHeads - 1) / kOutHeads;
  int blk = blockIdx.x;
  const int rt = blk % row_tiles;   // row tiles of one chunk and group are
  blk /= row_tiles;                 // neighbours: they share its states
  const int hg = blk % groups;
  const int bc = blk / groups;
  const int b = bc / nc;
  const long long t0 = static_cast<long long>(bc - b * nc) * Q;
  const int h0 = hg * kOutHeads;
  const int nh = min(kOutHeads, H - h0);
  const int i0 = rt * kRows;        // the tile's first row in its chunk
  const int K = i0 + kRows;         // rows the tile reads
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // A head's entering state, cums and dts, and a tile's x rows, loaded
  // ahead of their use (the first ones during C B^T).
  Prefetch<float, kMaxP * kMaxN * 4 / 16 / kThreads> sn;
  Prefetch<T, kRows * kMaxP * sizeof(T) / 16 / kThreads> xn;
  float cum_n = 0.f, dt_n = 0.f;
  auto fetch_head = [&](int h) {
    sn.load(enter + (static_cast<size_t>(bc) * H + h) * P * N, N, P, N,
            true);
    if (tid < K) {
      cum_n = cum[(static_cast<size_t>(bc) * H + h) * Q + tid];
      dt_n = to_f32<T>(dt[b * sd.b + (t0 + tid) * sd.s + h]);
    }
  };
  auto fetch_x = [&](int h, int jt) {
    xn.load(x + b * sx.b + (t0 + jt * kRows) * sx.s + h * sx.h, sx.s,
            kRows, P, vec);
  };
  if (nh > 0) {
    fetch_head(h0);
    fetch_x(h0, 0);
  }

  stage<T>(Cs, ldc, Cm + b * sc.b + (t0 + i0) * sc.s, sc.s, kRows, N);
  // C B^T, 64 columns at a time, in warp tiles of 16 x 16: warp (tr, tc) =
  // (warp / 4, warp % 4) owns rows 16 tr .. and columns 16 tc .. of each
  // 64 x 64 tile.
  static_assert(kWarps == (kRows / 16) * (kRows / 16),
                "a warp a 16 x 16 tile of C B^T's 64 x 64");
  {
    const int tr = warp / 4;
    const int tc = warp % 4;
    for (int jt = 0; jt <= rt; ++jt) {
      __syncthreads();   // the previous tile's MMAs have read Bt
      stage<T>(Bt, ldc, Bm + b * sb.b + (t0 + jt * kRows) * sb.s, sb.s,
               kRows, N);
      __syncthreads();
      float acc[1][2][4];
      zero(acc);
      warp_mma<1, 2, !kExact, !kExact>(acc, Cs + 16 * tr * ldc, ldc, 1,
                                       Bt + 16 * tc * ldc, 1, ldc, N);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 16 * tr + g;
        const int col = jt * kRows + 16 * tc + 8 * j + 2 * t;
        CB[r * ldcb + col] = acc[0][j][0];
        CB[r * ldcb + col + 1] = acc[0][j][1];
        CB[(r + 8) * ldcb + col] = acc[0][j][2];
        CB[(r + 8) * ldcb + col + 1] = acc[0][j][3];
      }
    }
  }

  // y over the tile's (kRows, P) in warp tiles of 16 x 16: warp (tr, tc)
  // owns rows 16 tr .. and columns 16 tc .. (all 16 warps at P = 64, the
  // first 8 at P = 32).
  const int tiles_p = P / 16;
  const int tr = warp / tiles_p;
  const int tc = warp - tr * tiles_p;
  const bool active = tr < kRows / 16;
  const size_t y_s = static_cast<size_t>(H) * P;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    __syncthreads();   // the last head's (or C B^T's) reads are done
    sn.store(Ss, lds, P, N);
    if (tid < K) {
      CUM[tid] = cum_n;
      DT[tid] = dt_n;
    }
    __syncthreads();
    if (hh + 1 < nh) fetch_head(h + 1);   // in flight during this head

    // exp(cum_i) (C S^T): A = C's rows, B[n][p] = S[p][n].
    float yo[1][2][4];
    zero(yo);
    if (active) {
      warp_mma<1, 2, !kExact, true>(yo, Cs + 16 * tr * ldc, ldc, 1,
                                    Ss + 16 * tc * lds, 1, lds, N);
      const int r = i0 + 16 * tr + g;
      const float e0 = __expf(CUM[r]);
      const float e1 = __expf(CUM[r + 8]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        yo[0][j][0] *= e0;
        yo[0][j][1] *= e0;
        yo[0][j][2] *= e1;
        yo[0][j][3] *= e1;
      }
    }

    // M x over the tiles of rows 0 .. the tile's end, each tile's x rows
    // loaded during the previous tile's MMAs.
    float acc[1][2][4];
    zero(acc);
    for (int jt = 0; jt <= rt; ++jt) {
      __syncthreads();   // the previous tile's MMAs have read Xs and Ms
      const int j0 = jt * kRows;
      xn.store(Xs, ldx, kRows, P);
      {  // a thread a column j, rows tid / kRows + 4 k: the column's cum
         // and dt read once, and no branch (a masked element takes exp(0)
         // and is then replaced by 0, so no exponent is positive).
        const int j = tid % kRows;
        const int gj = j0 + j;
        const float cj = CUM[gj];
        const float dj = DT[gj];
#pragma unroll
        for (int q = 0; q < kRows * kRows / kThreads; ++q) {
          const int i = tid / kRows + q * (kThreads / kRows);
          const int gi = i0 + i;
          // The exponent is <= 0 (see launch 1).
          const float m = CB[i * ldcb + gj] *
                          __expf(gj <= gi ? CUM[gi] - cj : 0.f) * dj;
          Ms[i * ldm + j] = gj <= gi ? m : 0.f;
        }
      }
      __syncthreads();
      if (jt < rt)
        fetch_x(h, jt + 1);
      else if (hh + 1 < nh)
        fetch_x(h + 1, 0);
      if (active)
        warp_mma<1, 2, true, !kExact>(acc, Ms + 16 * tr * ldm, ldm, 1,
                                      Xs + 16 * tc, ldx, 1, kRows);
    }

    if (active) {
      T* yb = y + (static_cast<size_t>(b) * S + t0 + i0) * y_s +
              static_cast<size_t>(h) * P;
      const int r = 16 * tr + g;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = 16 * tc + 8 * j + 2 * t;
        store2(yb + r * y_s + p, acc[0][j][0] + yo[0][j][0],
               acc[0][j][1] + yo[0][j][1]);
        store2(yb + (r + 8) * y_s + p, acc[0][j][2] + yo[0][j][2],
               acc[0][j][3] + yo[0][j][3]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* s0, void* y, void* sf, void* st,
           void* cum, void* tot, int B, int S, int H, int P, int N, int Q,
           XStrides sx, RowStrides sd, RowStrides sb, RowStrides sc,
           cudaStream_t stream) {
  const int nc = S / Q;
  // x's rows 16-byte aligned: Prefetch reads them 16 bytes at a time.
  constexpr int V = 16 / sizeof(T);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  sx.b % V == 0 && sx.s % V == 0 && sx.h % V == 0;
  const size_t smem1 = sizeof(float) * state_smem(P, N, Q);
  const size_t smem3 = sizeof(float) * OutLayout(P, N, Q).total;
  if (static_cast<long long>(smem1) > kSmemLimit ||
      static_cast<long long>(smem3) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long blocks1 = static_cast<long long>(B) * nc *
                            ((H + kStateHeads - 1) / kStateHeads);
  ssd_state_kernel<T><<<static_cast<unsigned>(blocks1), kThreads, smem1,
                         stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<float*>(st), static_cast<float*>(cum),
      static_cast<float*>(tot), S, H, P, N, Q, sx, sd, sb, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int PN4 = P * N / 4;
  const long long threads2 = static_cast<long long>(B) * H * PN4;
  ssd_scan_kernel<<<static_cast<unsigned>((threads2 + kThreads - 1) /
                                          kThreads),
                    kThreads, 0, stream>>>(
      static_cast<float*>(st), static_cast<const float*>(tot),
      static_cast<const float*>(s0), static_cast<float*>(sf), B, nc, H, PN4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long blocks3 = static_cast<long long>(B) * nc *
                            ((H + kOutHeads - 1) / kOutHeads) * (Q / kRows);
  ssd_out_kernel<T><<<static_cast<unsigned>(blocks3), kThreads, smem3,
                       stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(st), static_cast<const float*>(cum),
      static_cast<T*>(y), S, H, P, N, Q, sx, sd, sb, sc, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  ``bf16`` selects bf16 (1) or
// f32 (0) for x, dt, A, Bs, Cs and y; s0 may be null (a zero state); st,
// cum and tot are f32 scratch of B nc H P N, B nc H Q and B nc H floats
// (s0, sf and st 16-byte aligned).  P is 32 or 64, N a multiple of 16 up
// to 128, Q a multiple of 64 up to 256, S % Q == 0.  x_b/_s/_h, d_b/_s,
// b_b/_s and c_b/_s are element strides of x, dt, Bs and Cs.  Returns the
// first CUDA error of the three launches: 0 on success.
extern "C" int mamba2_ssd_chunk_forward(
    const void* x, const void* dt, const void* A, const void* Bs,
    const void* Cs, const void* s0, void* y, void* sf, void* st, void* cum,
    void* tot, int B, int S, int H, int P, int N, int Q, int bf16,
    long long x_b, long long x_s, long long x_h, long long d_b,
    long long d_s, long long b_b, long long b_s, long long c_b,
    long long c_s, void* stream) {
  if (P % 32 != 0 || P < 32 || P > kMaxP || N % 16 != 0 || N < 16 ||
      N > kMaxN || Q % kRows != 0 || Q < kRows || Q > kMaxQ || S < Q ||
      S % Q != 0 || B < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const XStrides sx{x_b, x_s, x_h};
  const RowStrides sd{d_b, d_s}, sb{b_b, b_s}, sc{c_b, c_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, dt, A, Bs, Cs, s0, y, sf, st, cum,
                                      tot, B, S, H, P, N, Q, sx, sd, sb, sc,
                                      s)
              : launch<float>(x, dt, A, Bs, Cs, s0, y, sf, st, cum, tot, B,
                              S, H, P, N, Q, sx, sd, sb, sc, s);
}
