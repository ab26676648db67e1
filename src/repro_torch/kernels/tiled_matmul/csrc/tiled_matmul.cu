// Blocked matmul for Hopper (sm_90a): the paper's Fig. 4 ladder, rung by
// rung.  C (M, N) f32 = A (M, K) @ B (K, N), A and B both f32 or both
// bf16, row-major and contiguous.  Replaces the Pallas TPU kernels
//   B6 src/repro/kernels/tiled_matmul/kernel.py:matmul_pallas
//      (bodies _matmul_kernel_noacc, split_k=False; _matmul_kernel_acc,
//      split_k=True)
//   B7 src/repro/kernels/tiled_matmul/kernel.py:matmul_whole
// and keeps each rung one paper step away from the rung before, which is
// the ladder's whole purpose (ops.py picks the arguments per level):
//
//   O0 (B7)  whole_kernel: ONE block computes all of C, each thread a dot
//            product read straight from device memory (through the
//            caches) with no shared-memory staging: the naive
//            compute-against-HBM port.  The TPU kernel's "whole operands
//            as the block" cannot be a shared-memory block here: at
//            1024^3 f32 each operand is 4 MB, a block has 232,448 B.
//   O1 (B6)  tiled_kernel, grid 1, bk = K, one stage: one block walks the
//            (M/bm, N/bn) tiles in row-major order (the loop takes the
//            place of the TPU's sequential grid) and stages both K-whole
//            stripes of each tile in shared memory: explicit data caching.
//   O2       grid 1, K in bk blocks, one stage, the f32 accumulator in
//            registers across the k loop: customized pipelining.
//   O3       grid = one block per (i, j) tile: PE duplication.  Only here
//            does the work leave one SM.
//   O4       two stages: the next k-block's cp.async copies are in flight
//            while this one is multiplied (double buffering), with blocks
//            from pick_blocks(level=O4), which halves them so both fit.
//   O5       as O4 with bf16 tiles in shared memory (scratchpad
//            reorganization: half the bytes a tile), summed in f32.  At
//            the blocks the rung picks, ops.body routes bf16 tiles to
//            tiled_matmul_wgmma.cu, the tensor-core body; this body runs
//            the bf16 blocks that one does not take.
//
// This is B6's CUDA-core body: every launch here sums in f32 FMAs, never
// TF32 (a bf16 x bf16 product is exact in f32, so O5 differs from an f32
// product of the rounded operands only in summation order).  ops.body
// routes O3 and O4 at the blocks they pick to tiled_matmul_tf32x3.cu
// (3xTF32 on the tensor cores) and O5's to tiled_matmul_wgmma.cu; this
// body runs O1 and O2 and the blocks those two do not take.
//
// One body for B6.  256 threads as a 16 x 16 grid (ty, tx); a block tile
// (bm, bn) is covered by sub-tiles of (16 RM, 16 RN) outputs, RM, RN in
// {1, 2, 4, 8} chosen per launch as the smallest that covers min(bm, 128)
// and min(bn, 128), so small tiles (O1's 16 x 32 at 1024^3) waste no
// threads and large ones take 64 accumulators a thread.  Thread (ty, tx)
// owns rows ty + 16 r and columns tx + 16 c of its sub-tile: a warp reads
// two rows of A's tile (broadcasts) and 16 consecutive columns of B's.
// Rows and columns past a sub-tile's edge read a clamped index and are
// not stored, so any divisor block works (bm, bn, bk are run-time
// values; ops._fit gives 48, 80, 105 ...).  A tile wider than 128 is
// walked in sub-tiles, each with its own k loop.
//
// Shared memory.  Only the staged tiles live there: stages x (rows x lda
// + bk x cols) elements, lda = bk padded by 16 B when a row of A's tile
// is a multiple of 128 B (so the two rows a warp reads sit in different
// banks).  The accumulator sits in registers, so pick_blocks' count,
// stages x elem x (bm bk + bk bn + bm bn), bounds the staged tiles with
// the bm bn term to spare, and that spare covers the padding (at most
// 16 B a row of A's tile) whenever bn >= 16 B / elem.  The launch
// computes the exact size and refuses (cudaErrorInvalidValue) a layout
// over 232,448 B; above 48 KB it opts in with cudaFuncSetAttribute.
//
// Copies.  cp.async at the widest of 16, 8 and 4 B that every address
// and row stride of the operand allows (16 B for the shapes of the main
// path); where only 2-byte alignment holds (a bf16 row of odd length) the
// tile is copied element by element with plain loads and stores.  Either
// way it is this kernel's copy, not a fallback.
//
// Bound.  At MachSuite's 1024^3 in f32 the work is operations: 2.15e9
// FLOP / 67e12 FLOP/s (f32 outside the tensor cores) = 0.032 ms, against
// 12.6 MB / 3.35e12 B/s = 0.004 ms of bytes.  At O5 in bf16 it is 2.15e9
// / 989e12 = 0.0022 ms on the tensor cores against 8.4 MB = 0.0025 ms of
// bytes.  What this design does about it: O3..O5 spread the tiles over
// the SMs (64 tiles of 128 x 128 at 1024^3 cover 64 of the 132 SMs, so
// the rungs are also timed at 4096^3, where 1,024 tiles fill the card)
// and reuse each staged element 16 RM (or 16 RN) times from registers;
// on the CUDA cores this body stays under the 67 TFLOP/s f32 peak, which
// is why the f32 rungs with a block per tile run 3xTF32 on the tensor
// cores instead.  O0..O2 run on one SM by design: the paper's starting
// point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // B6: a 16 x 16 thread grid
constexpr int kWholeThreads = 1024;   // B7: the most one block may have
constexpr long long kSmemLimit = 232448;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int W>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(W));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a rows x cols tile from global memory (row stride ld elements) to
// shared memory (row stride lds), `width` bytes a copy: 16, 8 or 4 with
// cp.async (completed by the caller's wait), or element by element (2).
template <typename T>
__device__ void stage(T* dst, int lds, const T* src, long long ld, int rows,
                      int cols, int width) {
  if (width < 4) {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols;
      const int c = e - r * cols;
      dst[r * lds + c] = src[r * ld + c];
    }
    return;
  }
  const int vec = width / static_cast<int>(sizeof(T));
  const int per_row = cols / vec;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row;
    const int v = (e - r * per_row) * vec;
    T* d = dst + r * lds + v;
    const T* s = src + r * ld + v;
    if (width == 16) {
      cp_async<16>(d, s);
    } else if (width == 8) {
      cp_async<8>(d, s);
    } else {
      cp_async<4>(d, s);
    }
  }
}

// Element offsets of the shared-memory regions (each a multiple of 16 B).
struct Layout {
  int lda;          // row stride of A's staged tile
  int a_stage;      // elements of one stage of A
  int b_stage;      // elements of one stage of B
  int b_offset;     // elements before B's first stage
  long long bytes;  // total dynamic shared memory
};

// B6.  Blocks take tiles blockIdx.x, blockIdx.x + gridDim.x, ... in
// row-major (i, j) order; wa, wb are the copy widths of A and B.
template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kThreads)
    tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ c, int M, int N, int K, int bm, int bn,
                 int bk, int stages, int wa, int wb, Layout L) {
  constexpr int SM = 16 * RM;
  constexpr int SN = 16 * RN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + L.b_offset;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int tiles_n = N / bn;
  const int n_tiles = (M / bm) * tiles_n;
  const int nk = K / bk;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int ti = t / tiles_n;
    const int tj = t - ti * tiles_n;
    for (int si = 0; si < bm; si += SM) {
      const int rows = min(SM, bm - si);
      const long long row0 = static_cast<long long>(ti) * bm + si;
      for (int sj = 0; sj < bn; sj += SN) {
        const int cols = min(SN, bn - sj);
        const long long col0 = static_cast<long long>(tj) * bn + sj;
        int ar[RM];
        int bc[RN];
#pragma unroll
        for (int r = 0; r < RM; ++r) ar[r] = min(r * 16 + ty, rows - 1) * L.lda;
#pragma unroll
        for (int q = 0; q < RN; ++q) bc[q] = min(q * 16 + tx, cols - 1);
        float acc[RM][RN];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) acc[r][q] = 0.f;

        auto load = [&](int kt, int slot) {
          const long long k0 = static_cast<long long>(kt) * bk;
          stage(As + slot * L.a_stage, L.lda, a + row0 * K + k0, K, rows, bk,
                wa);
          stage(Bs + slot * L.b_stage, cols, b + k0 * N + col0, N, bk, cols,
                wb);
          cp_async_commit();
        };

        load(0, 0);
        for (int kt = 0; kt < nk; ++kt) {
          const int slot = stages == 2 ? (kt & 1) : 0;
          if (stages == 2 && kt + 1 < nk) {
            load(kt + 1, slot ^ 1);   // in flight while this block multiplies
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const T* At = As + slot * L.a_stage;
          const T* Bt = Bs + slot * L.b_stage;
#pragma unroll 4
          for (int kk = 0; kk < bk; ++kk) {
            float av[RM];
            float bv[RN];
#pragma unroll
            for (int r = 0; r < RM; ++r) av[r] = to_f32(At[ar[r] + kk]);
#pragma unroll
            for (int q = 0; q < RN; ++q) bv[q] = to_f32(Bt[kk * cols + bc[q]]);
#pragma unroll
            for (int r = 0; r < RM; ++r)
#pragma unroll
              for (int q = 0; q < RN; ++q)
                acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
          }
          __syncthreads();            // the slot may be overwritten now
          if (stages == 1 && kt + 1 < nk) load(kt + 1, 0);
        }

#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int row = r * 16 + ty;
          if (row >= rows) continue;
          float* crow = c + (row0 + row) * N + col0;
#pragma unroll
          for (int q = 0; q < RN; ++q) {
            const int col = q * 16 + tx;
            if (col < cols) crow[col] = acc[r][q];
          }
        }
      }
    }
  }
}

// B7: one block, each thread a dot product straight from device memory.
// Neighbouring threads take neighbouring columns: B's reads coalesce, A's
// are one broadcast a warp.
template <typename T>
__global__ void __launch_bounds__(kWholeThreads)
    whole_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ c, int M, int N, int K) {
  const long long mn = static_cast<long long>(M) * N;
  for (long long e = threadIdx.x; e < mn; e += blockDim.x) {
    const long long i = e / N;
    const long long j = e - i * N;
    const T* arow = a + i * K;
    const T* bcol = b + j;
    float s = 0.f;
#pragma unroll 4
    for (int p = 0; p < K; ++p)
      s = fmaf(to_f32(arow[p]), to_f32(bcol[static_cast<long long>(p) * N]),
               s);
    c[e] = s;
  }
}

// The widest copy (16, 8, 4 or 2 B) that every byte quantity OR-ed into
// `g` is a multiple of.
int copy_width(unsigned long long g) {
  if (g % 16 == 0) return 16;
  if (g % 8 == 0) return 8;
  if (g % 4 == 0) return 4;
  return 2;
}

int cover(int n) {  // the smallest of 1, 2, 4, 8 with 16 x it >= min(n, 128)
  return n <= 16 ? 1 : n <= 32 ? 2 : n <= 64 ? 4 : 8;
}

long long round_up(long long x, long long m) { return (x + m - 1) / m * m; }

struct Args {
  const void* a;
  const void* b;
  float* c;
  int M, N, K, bm, bn, bk, grid, stages;
  cudaStream_t stream;
};

template <typename T, int RM, int RN>
int run_tiled(const Args& p) {
  constexpr int e = static_cast<int>(sizeof(T));
  const int rows = p.bm < 16 * RM ? p.bm : 16 * RM;
  const int cols = p.bn < 16 * RN ? p.bn : 16 * RN;
  const int tail = p.bn % (16 * RN);   // a narrower last sub-tile of B
  const long long unit = 16 / e;       // elements in 16 B
  Layout L;
  L.lda = p.bk + ((static_cast<long long>(p.bk) * e) % 128 == 0 ? 16 / e : 0);
  const long long a_stage = round_up(static_cast<long long>(rows) * L.lda, unit);
  const long long b_stage = round_up(static_cast<long long>(p.bk) * cols, unit);
  const long long total = p.stages * (a_stage + b_stage);
  L.bytes = total * e;
  if (L.bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  L.a_stage = static_cast<int>(a_stage);
  L.b_stage = static_cast<int>(b_stage);
  L.b_offset = static_cast<int>(p.stages * a_stage);
  const unsigned long long ga =
      reinterpret_cast<unsigned long long>(p.a) |
      static_cast<unsigned long long>(p.K) * e |
      static_cast<unsigned long long>(p.bk) * e |
      static_cast<unsigned long long>(L.lda) * e;
  const unsigned long long gb =
      reinterpret_cast<unsigned long long>(p.b) |
      static_cast<unsigned long long>(p.N) * e |
      static_cast<unsigned long long>(p.bn) * e |
      static_cast<unsigned long long>(cols) * e |
      static_cast<unsigned long long>(tail) * e;
  const int wa = copy_width(ga);
  const int wb = copy_width(gb);
  auto kernel = tiled_kernel<T, RM, RN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.grid, kThreads, static_cast<size_t>(L.bytes), p.stream>>>(
      static_cast<const T*>(p.a), static_cast<const T*>(p.b), p.c, p.M, p.N,
      p.K, p.bm, p.bn, p.bk, p.stages, wa, wb, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RM>
int dispatch_rn(int rn, const Args& p) {
  switch (rn) {
    case 1: return run_tiled<T, RM, 1>(p);
    case 2: return run_tiled<T, RM, 2>(p);
    case 4: return run_tiled<T, RM, 4>(p);
    default: return run_tiled<T, RM, 8>(p);
  }
}

template <typename T>
int dispatch(const Args& p) {
  const int rn = cover(p.bn);
  switch (cover(p.bm)) {
    case 1: return dispatch_rn<T, 1>(rn, p);
    case 2: return dispatch_rn<T, 2>(rn, p);
    case 4: return dispatch_rn<T, 4>(rn, p);
    default: return dispatch_rn<T, 8>(rn, p);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  ``bf16`` selects bf16 (1)
// or f32 (0) operands; C is f32.  All three matrices are row-major and
// contiguous.  Each returns cudaGetLastError() after the launch: 0 on
// success, cudaErrorInvalidValue for arguments the kernel does not take.

// B6: bm, bn, bk divide M, N, K; `grid` blocks (1 walks every tile on one
// SM); `stages` 1 or 2.
extern "C" int tiled_matmul_forward(const void* a, const void* b, void* c,
                                    int M, int N, int K, int bm, int bn,
                                    int bk, int grid, int stages, int bf16,
                                    void* stream) {
  if (M < 1 || N < 1 || K < 1 || bm < 1 || bn < 1 || bk < 1 || M % bm ||
      N % bn || K % bk || grid < 1 || (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a, b, static_cast<float*>(c), M, N, K, bm, bn, bk, grid,
               stages, static_cast<cudaStream_t>(stream)};
  return bf16 ? dispatch<__nv_bfloat16>(p) : dispatch<float>(p);
}

// B7: one block of 1024 threads computes all of C.
extern "C" int whole_matmul_forward(const void* a, const void* b, void* c,
                                    int M, int N, int K, int bf16,
                                    void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  if (bf16) {
    whole_kernel<__nv_bfloat16><<<1, kWholeThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), out, M, N, K);
  } else {
    whole_kernel<float><<<1, kWholeThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), out, M, N,
        K);
  }
  return static_cast<int>(cudaGetLastError());
}
