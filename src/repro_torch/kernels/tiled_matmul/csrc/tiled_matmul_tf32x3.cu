// B6's tensor-core body for its f32 rungs on Hopper (sm_90a): the
// blocked matmul C (M, N) f32 = A (M, K) @ B (K, N), A and B f32,
// row-major and contiguous, summed on the tensor cores with 3xTF32.
//
// Replaces, with tiled_matmul.cu's CUDA-core body, the Pallas TPU kernel
//   B6 src/repro/kernels/tiled_matmul/kernel.py:matmul_pallas
// at the rungs O3 (PE duplication: a block per (i, j) tile, one stage)
// and O4 (double buffering: two stages), at the blocks those rungs pick
// (ops.body routes f32 launches with a block per tile and blocks this
// body takes here; O1 and O2, one block walking every tile, stay on the
// CUDA cores as the ladder's unrefined starting point).  The rung's
// blocks, grid and stages are kept: each rung stays one paper step from
// the rung before.
//
// Numerics: 3xTF32.  Each f32 operand x is split in registers into
// big = x rounded to TF32 (to nearest, ties away: cvt.rna.tf32's value,
// computed with two integer ops) and small = x - big (exact in f32; the
// MMA reads its TF32 part, truncated toward zero, as CUTLASS's fast-F32
// operands are).  A TF32 value has 10 mantissa bits, so big + small
// carries 21 of x's 24 and the products big * big, big * small,
// small * big are exact in f32.  Each k-step adds a_s b_b + a_b b_s +
// a_b b_b in that fixed order, small products first (the order of
// CUTLASS's OpMultiplyAddFastF32); the dropped a_s b_s is below 2^-22
// of |a b|, and small's truncation below 2^-21 of |x|.  The split is
// integer ops because it sets the time: on an H100 SXM at 700 W
// (scripts/tf32x3_split_ab.py, O3 at 4096^3) two cvt.rna.tf32 a value
// took 3.06 ms, one 2.82 and none 2.63, all at the same largest error.
// The tensor cores add with truncation, not round-to-nearest, so an
// accumulator carried through all of K drifts one way: on the same card,
// 1,536 MMAs into one accumulator at 4096^3 missed 1e-5 of max |plain|
// by 3.5x.  So the tensor cores sum only a 32-deep slice of K from zero
// (12 MMAs an output), and each slice's sum joins the f32 accumulator in
// one round-to-nearest add, as the plain version adds its k-blocks.
// TF32 alone (one product) would keep ~3 decimal digits and break
// MATMUL_TOL = 1e-5 of max |plain|.
//
// Why mma.sync, not wgmma: wgmma transposes only 16-bit operands from
// shared memory, so a tf32 wgmma needs B K-major; B6 takes B (K, N)
// row-major, and a transpose would be a step the rung does not have.
//
// Design.  256 threads, 8 warps as 2 x 4 over the block tile (BM, BN) =
// (32 MT, 32 NT), MT, NT in {1, 2, 4}: a warp owns (16 MT, 8 NT) outputs,
// MT x NT m16n8 accumulators in registers.  Per stage A's (BM, bk) tile
// (rows padded by 4 floats) and B's (bk, BN) tile (rows padded by 8) sit
// in shared memory, copied with 16-byte cp.async; with two stages the
// next k-block's copies are in flight while this one is multiplied.  The
// paddings put a fragment's 32 reads in 32 distinct banks (A: 4 g + t,
// B: 8 t + g).  Per k-step of 8 a warp reads its A fragments with
// ldmatrix (an 8 x 4 f32 matrix is an 8 x 8 b16 one) and its B fragments
// with 32-bit loads, splits them, and runs 3 MT NT mma.sync.m16n8k8
// (tf32 in, f32 accumulate) into a slice accumulator, one term over all
// MT NT tiles before the next, so consecutive MMAs do not wait on each
// other.
//
// Bound: the operations.  The same f32 product takes 3 tensor-core
// products, 3 x 2 M N K at 495 TFLOP/s of dense TF32: 0.833 ms at 4096^3
// and 0.0130 ms at 1024^3, against 201 MB / 12.6 MB of bytes at 3.35
// TB/s (0.060 / 0.004 ms).  mma.sync runs below wgmma's rate on
// Hopper, and the split (two integer ops and a subtraction per fragment
// element, in every warp that reads the element) runs on the ALUs beside
// it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kSmemLimit = 232448;
// Depth of K the tensor cores sum from zero before the sum joins the f32
// accumulator (4 mma k-steps).
constexpr int kSlice = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x -> (big, small) as MMA operands.  big is cvt.rna.tf32.f32(x) bit
// for bit (half a TF32 ulp added to the magnitude, the 13 low bits
// cleared), with two integer ops in place of the conversion; small is
// x - big, exact in f32, whose 13 low bits the MMA ignores (it reads the
// TF32 value truncated toward zero).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Four 8 x 4 f32 matrices from shared memory, as ldmatrix's 8 x 8 b16
// matrices: lane l gets (row l / 4, column l % 4) of each — with the
// right row addresses, the A fragment of an m16n8k8 tf32 MMA.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
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

// Copy a rows x cols f32 tile (row stride ld) to shared memory (row
// stride lds) with 16-byte cp.async; cols, ld and lds are multiples of 4.
__device__ __forceinline__ void stage(float* dst, int lds, const float* src,
                                      long long ld, int rows, int cols) {
  const int per_row = cols / 4;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * 4;
    cp_async16(dst + r * lds + c, src + r * ld + c);
  }
}

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads)
    tf32x3_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int M, int N, int K, int bk,
                  int stages) {
  constexpr int BM = 32 * MT;
  constexpr int BN = 32 * NT;
  constexpr int LDB = BN + 8;
  const int lda = bk + 4;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // stages x (BM, lda)
  float* Bs = smem + stages * BM * lda;      // stages x (bk, LDB)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wm = warp / 4;                   // 2 warps down the rows
  const int wn = warp % 4;                   // 4 across the columns
  const int tiles_n = N / BN;
  const int n_tiles = (M / BM) * tiles_n;
  const int nk = K / bk;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int ti = t / tiles_n;
    const int tj = t - ti * tiles_n;
    const long long row0 = static_cast<long long>(ti) * BM;
    const long long col0 = static_cast<long long>(tj) * BN;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    auto load = [&](int kt, int slot) {
      const long long k0 = static_cast<long long>(kt) * bk;
      stage(As + slot * BM * lda, lda, a + row0 * K + k0, K, BM, bk);
      stage(Bs + slot * bk * LDB, LDB, b + k0 * N + col0, N, bk, BN);
      cp_async_commit();
    };

    load(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = stages == 2 ? (kt & 1) : 0;
      if (stages == 2 && kt + 1 < nk) {
        load(kt + 1, slot ^ 1);     // in flight while this block multiplies
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // ldmatrix rows: lane l points at row (l % 8) + 8 ((l / 8) % 2),
      // column 4 (l / 16) of the warp's m16 tile.
      const float* At = As + slot * BM * lda +
                        (wm * 16 * MT + (lane % 8) + 8 * ((lane / 8) % 2)) *
                            lda + 4 * (lane / 16);
      const float* Bt = Bs + slot * bk * LDB + t4 * LDB + wn * 8 * NT + g;
      for (int k0 = 0; k0 < bk; k0 += kSlice) {
        // The tensor cores sum this slice of K from zero; its sum joins
        // the accumulator in one round-to-nearest f32 add.
        float part[MT][NT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
        const int k1 = min(k0 + kSlice, bk);
#pragma unroll 4
        for (int kk = k0; kk < k1; kk += 8) {
          uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
            uint32_t x[4];
            ldmatrix_x4(x, At + i * 16 * lda + kk);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split(__uint_as_float(x[e]), ab[i][e], as[i][e]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float* p = Bt + kk * LDB + j * 8;
            split(p[0], bb[j][0], bs[j][0]);             // (k t, n g)
            split(p[4 * LDB], bb[j][1], bs[j][1]);       // (k t + 4, n g)
          }
          // Each term over every tile before the next term: consecutive
          // MMAs are independent, and each output still adds a_s b_b,
          // a_b b_s, a_b b_b in that order.
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma(part[i][j], as[i], bb[j]);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma(part[i][j], ab[i], bs[j]);
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
      __syncthreads();              // the slot may be overwritten now
      if (stages == 1 && kt + 1 < nk) load(kt + 1, 0);
    }

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long row = row0 + wm * 16 * MT + i * 16 + g + 8 * hr;
          const long long col = col0 + wn * 8 * NT + j * 8 + 2 * t4;
          *reinterpret_cast<float2*>(c + row * N + col) =
              make_float2(acc[i][j][2 * hr], acc[i][j][2 * hr + 1]);
        }
  }
}

long long smem_bytes(int bm, int bn, int bk, int stages) {
  return 4LL * stages * (static_cast<long long>(bm) * (bk + 4) +
                         static_cast<long long>(bk) * (bn + 8));
}

template <int MT, int NT>
int run(const float* a, const float* b, float* c, int M, int N, int K,
        int bk, int grid, int stages, cudaStream_t stream) {
  static int given = 0;   // the shared memory this instance was opted in to
  const long long bytes = smem_bytes(32 * MT, 32 * NT, bk, stages);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > given) {
    const cudaError_t err = cudaFuncSetAttribute(
        tf32x3_kernel<MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    given = static_cast<int>(bytes);
  }
  tf32x3_kernel<MT, NT><<<grid, kThreads, static_cast<size_t>(bytes),
                          stream>>>(a, b, c, M, N, K, bk, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int by_n(int bn, const float* a, const float* b, float* c, int M, int N,
         int K, int bk, int grid, int stages, cudaStream_t s) {
  switch (bn) {
    case 32: return run<MT, 1>(a, b, c, M, N, K, bk, grid, stages, s);
    case 64: return run<MT, 2>(a, b, c, M, N, K, bk, grid, stages, s);
    default: return run<MT, 4>(a, b, c, M, N, K, bk, grid, stages, s);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  a (M, K), b (K, N) f32,
// c (M, N) f32, all row-major, contiguous and 16-byte aligned; bm and bn
// in {32, 64, 128}, bk a multiple of 8, and they divide M, N, K; N and K
// multiples of 4; `grid` blocks walk the tiles in row-major order;
// `stages` 1 or 2.  Returns cudaGetLastError() after the launch: 0 on
// success, cudaErrorInvalidValue for arguments the body does not take.
extern "C" int tiled_matmul_tf32x3_forward(const void* a, const void* b,
                                           void* c, int M, int N, int K,
                                           int bm, int bn, int bk, int grid,
                                           int stages, void* stream) {
  const auto ok_block = [](int x) { return x == 32 || x == 64 || x == 128; };
  if (M < 1 || N < 1 || K < 1 || !ok_block(bm) || !ok_block(bn) || bk < 8 ||
      bk % 8 || M % bm || N % bn || K % bk || N % 4 || K % 4 || grid < 1 ||
      (stages != 1 && stages != 2) ||
      reinterpret_cast<size_t>(a) % 16 || reinterpret_cast<size_t>(b) % 16 ||
      reinterpret_cast<size_t>(c) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 32: return by_n<1>(bn, A, B, C, M, N, K, bk, grid, stages, s);
    case 64: return by_n<2>(bn, A, B, C, M, N, K, bk, grid, stages, s);
    default: return by_n<4>(bn, A, B, C, M, N, K, bk, grid, stages, s);
  }
}
