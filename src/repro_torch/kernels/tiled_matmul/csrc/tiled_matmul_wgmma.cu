// B6's tensor-core body for Hopper (sm_90a): the blocked matmul's bf16
// rung (O5) on warpgroup MMA fed by the Tensor Memory Accelerator.
// C (M, N) f32 = A (M, K) @ B (K, N), A and B bf16, row-major and
// contiguous.  Replaces, with tiled_matmul.cu's CUDA-core body, the
// Pallas TPU kernel
//   B6 src/repro/kernels/tiled_matmul/kernel.py:matmul_pallas
//      (_matmul_kernel_acc: the f32 accumulator carried across K)
// at the blocks ops.pick_blocks gives the O5 rung (128 x 128 x 128 at
// 1024^3 and 4096^3).  O4 -> O5 stays one paper step, "the same blocks,
// bf16 in the scratchpad": on this card bf16 tiles also feed the tensor
// cores, as bf16 fed the MXU at its full rate on the TPU.
//
// ops.body() routes a launch here, from dtype, shape and blocks alone,
// when: bf16; bm 64 or 128 (one or two consumer warpgroups of 64 rows);
// bn a multiple of 16 up to 256; bk a multiple of 64; N and K multiples
// of 8 (TMA's 16-byte global strides); and the ring below fits a block's
// shared memory.  Everything else runs the CUDA-core body.  This entry
// point refuses (cudaErrorInvalidValue) anything outside that rule.
//
// Design.  One block per (bm, bn) tile (the O3+ grid; a smaller grid
// walks the tiles in row-major order, the ring running on across
// tiles).  Warps 0 .. 4 n_wg - 1 are the consumer warpgroups, each
// owning 64 rows of the tile; the last warp is the producer, whose lane
// 0 issues the TMA loads.  The ring holds `stages` slots (2 at O5: the
// O4 double buffering), each with a full and an empty mbarrier.  A slot
// holds A's (bm x bk) tile as bk / 64 boxes of (bm rows x 64 columns)
// and B's (bk x bn) tile as ceil(bn / 64) x bk / 64 boxes of (64 rows x
// 64 columns): a box's inner dimension is the 128-byte swizzle span.
// Both are loaded with CU_TENSOR_MAP_SWIZZLE_128B, so a warpgroup's
// reads of a slot are free of bank conflicts, and each box starts on a
// 1024-byte boundary, the swizzle's period.
//
// A consumer warpgroup runs wgmma.mma_async.m64nWk16.f32.bf16.bf16 with
// both operands from shared memory and the f32 accumulator in registers:
// A K-major (its descriptor advances 32 B a k-step inside the swizzle
// atom), B MN-major through the transpose bit (B is (K, N) row-major):
// its leading byte offset is the stride between 64-column boxes, its
// stride byte offset the 1024 B between groups of 8 k-rows.  A tile of
// bn columns is covered by bn / W instructions of width W, the widest of
// 256, 128, 64, 32, 16 that divides bn (one instruction at the main
// path's 128).  The warpgroup keeps one k-block's MMAs in flight: it
// releases a slot when the next k-block's group has been issued and the
// slot's own has completed (wgmma.wait_group 1), so the producer's next
// load overlaps the MMAs.  The epilogue stores the f32 accumulator
// straight from registers to device memory (8-byte stores).
//
// Numerics: a bf16 x bf16 product is exact in f32; the tensor cores add
// the products of a k-step and the running sum in f32 in their own
// order, so the result differs from the plain version (f32 sums in
// bk-wide blocks) in summation order and in the adders' rounding.
//
// Shared memory: stages x (bm bk + 64 ceil(bn / 64) bk) x 2 B, plus 1 KB
// of alignment and the barriers: 129 KB at (128, 128, 128) x 2 stages,
// so one block runs per SM.
//
// Bound: at 4096^3 the operations, 2 M N K / 989 TFLOP/s = 0.139 ms,
// against 2 x 33.6 MB + 67.1 MB of bytes / 3.35 TB/s = 0.040 ms; at
// 1024^3 the bytes (8.4 MB, 0.0025 ms) against 0.0022 ms of operations.
// What this design does about it: every product runs on the tensor
// cores at their bf16 rate, fed by TMA with no thread spending
// registers or instructions on the copies, and the ring keeps a load in
// flight under each k-block's MMAs.  What is still missing: persistent
// blocks (one per SM walking many tiles, so one tile's epilogue
// overlaps the next one's loads), a TMA store epilogue, clusters that
// multicast a tile to neighbouring SMs, and deeper rings (which would
// change the rung's meaning).  At 1024^3 the rung's 64 tiles fill 64 of
// the 132 SMs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBoxCols = 64;          // bf16 columns of a box: 128 B
constexpr int kRowBytes = 128;        // bytes of a box row
constexpr int kAtomBytes = 1024;      // the 128-byte swizzle's period
constexpr long long kSmemLimit = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA box into shared memory, completing on `bar`; c0 is the
// inner (column) coordinate.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous MMAs that own it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64 nW k16, bf16 operands from shared memory (A
// K-major, B MN-major: imm-trans-b 1), D += A B in f32.
template <int W> struct Wgmma;

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// Byte layout of the ring in dynamic shared memory (after aligning its
// start to kAtomBytes): stages A slots, stages B slots, then the full
// and empty barriers.
struct Ring {
  int a_slot;   // bytes of one slot of A: bm x bk x 2
  int b_slot;   // bytes of one slot of B: 64 ceil(bn / 64) x bk x 2
  int stages;
};

__host__ __device__ inline long long ring_bytes(const Ring& r) {
  return static_cast<long long>(r.stages) * (r.a_slot + r.b_slot) +
         kAtomBytes + 2 * 8 * r.stages;
}

template <int W, int NCH>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 float* __restrict__ c, int M, int N, int K, int bm, int bk,
                 Ring ring) {
  constexpr int BN = W * NCH;
  constexpr int NBOX = (BN + kBoxCols - 1) / kBoxCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAtomBytes - 1) &
      ~static_cast<uintptr_t>(kAtomBytes - 1));
  const int stages = ring.stages;
  unsigned char* As = base;
  unsigned char* Bs = base + stages * ring.a_slot;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + stages * ring.b_slot);
  uint64_t* empty = full + stages;

  const int n_wg = bm / 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], n_wg * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_n = N / BN;
  const int n_tiles = (M / bm) * tiles_n;
  const int nk = K / bk;
  const int kboxes = bk / kBoxCols;

  if (warp == 4 * n_wg) {
    // The producer: lane 0 keeps the ring full.
    if (lane != 0) return;
    const unsigned bytes = ring.a_slot + ring.b_slot;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int row0 = (t / tiles_n) * bm;
      const int col0 = (t % tiles_n) * BN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % stages;
        const int round = it / stages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        mbar_expect_tx(&full[s], bytes);
        unsigned char* a_dst = As + s * ring.a_slot;
        unsigned char* b_dst = Bs + s * ring.b_slot;
        for (int kb = 0; kb < kboxes; ++kb) {
          const int k0 = kt * bk + kb * kBoxCols;
          tma_load(a_dst + kb * bm * kRowBytes, &map_a, &full[s], k0, row0);
#pragma unroll
          for (int nb = 0; nb < NBOX; ++nb)
            tma_load(b_dst + (nb * bk + kb * kBoxCols) * kRowBytes, &map_b,
                     &full[s], col0 + nb * kBoxCols, k0);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = warp / 4;
  float acc[NCH][W / 2];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = (t / tiles_n) * bm;
    const int col0 = (t % tiles_n) * BN;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[ch][i] = 0.f;
    int pending = -1;   // the slot whose MMAs are still in flight
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) fence_acc(acc[ch]);
      wgmma_fence();
      const uint32_t a_base =
          smem_addr(As + s * ring.a_slot) + wg * 64 * kRowBytes;
      const uint32_t b_base = smem_addr(Bs + s * ring.b_slot);
      for (int kb = 0; kb < kboxes; ++kb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {   // k-steps of 16 inside the box
          const uint64_t da = smem_desc(
              a_base + kb * bm * kRowBytes + j * 32, 16, kAtomBytes);
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            const int n0 = ch * W;
            const uint64_t db = smem_desc(
                b_base + ((n0 / kBoxCols) * bk + kb * kBoxCols + j * 16) *
                             kRowBytes +
                    (n0 % kBoxCols) * 2,
                bk * kRowBytes, kAtomBytes);
            Wgmma<W>::run(acc[ch], da, db);
          }
        }
      }
      wgmma_commit();
      if (stages == 1) {
        wgmma_wait<0>();
        mbar_arrive(&empty[s]);
      } else {
        wgmma_wait<1>();   // the previous k-block's MMAs are done
        if (pending >= 0) mbar_arrive(&empty[pending]);
        pending = s;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) fence_acc(acc[ch]);
    if (pending >= 0) mbar_arrive(&empty[pending]);

    // Accumulator layout of m64nW: fragment f of a warp's 16 rows holds
    // (row g, cols 8 f + 2 q, + 1) and (row g + 8, the same columns),
    // g = lane / 4, q = lane % 4.
    const int wrow = row0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int f = 0; f < W / 8; ++f) {
        const int col = col0 + ch * W + 8 * f + 2 * (lane % 4);
        float* p = c + static_cast<long long>(wrow) * N + col;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[ch][4 * f], acc[ch][4 * f + 1]);
        *reinterpret_cast<float2*>(p + 8LL * N) =
            make_float2(acc[ch][4 * f + 2], acc[ch][4 * f + 3]);
      }
    }
  }
}

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime's
// entry-point query so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D bf16 row-major (rows, cols) tensor cut into (box_rows x 64) boxes
// with the 128-byte swizzle; rows and columns past the edge read zero.
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols,
            int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBoxCols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void* a;
  const void* b;
  float* c;
  int M, N, K, bm, bn, bk, grid;
  Ring ring;
  cudaStream_t stream;
};

template <int W, int NCH>
int run(const Args& p) {
  CUtensorMap map_a, map_b;
  if (!encode(&map_a, p.a, p.M, p.K, p.bm) ||
      !encode(&map_b, p.b, p.K, p.N, kBoxCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(ring_bytes(p.ring));
  auto kernel = wgmma_kernel<W, NCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.grid, (p.bm / 64) * 128 + 32, bytes, p.stream>>>(
      map_a, map_b, p.c, p.M, p.N, p.K, p.bm, p.bk, p.ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes): B6's tensor-core body.  a
// (M, K) and b (K, N) bf16, c (M, N) f32, all row-major and contiguous,
// a and b 16-byte aligned; bm, bn, bk divide M, N, K and meet ops.body's
// rule; `grid` blocks walk the tiles; `stages` 1 or 2.  Returns
// cudaGetLastError() after the launch: 0 on success,
// cudaErrorInvalidValue for arguments outside the rule.
extern "C" int tiled_matmul_wgmma_forward(const void* a, const void* b,
                                          void* c, int M, int N, int K,
                                          int bm, int bn, int bk, int grid,
                                          int stages, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (bm != 64 && bm != 128) || bn < 16 ||
      bn > 256 || bn % 16 || bk < 64 || bk % 64 || M % bm || N % bn ||
      K % bk || N % 8 || K % 8 || grid < 1 || (stages != 1 && stages != 2) ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Ring ring{bm * bk * 2,
                  (bn + kBoxCols - 1) / kBoxCols * kBoxCols * bk * 2, stages};
  if (ring_bytes(ring) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a, b, static_cast<float*>(c), M, N, K, bm, bn, bk, grid, ring,
               static_cast<cudaStream_t>(stream)};
  switch (bn) {   // W: the widest of 256, 128, 64, 32, 16 dividing bn
    case 16: return run<16, 1>(p);
    case 32: return run<32, 1>(p);
    case 48: return run<16, 3>(p);
    case 64: return run<64, 1>(p);
    case 80: return run<16, 5>(p);
    case 96: return run<32, 3>(p);
    case 112: return run<16, 7>(p);
    case 128: return run<128, 1>(p);
    case 144: return run<16, 9>(p);
    case 160: return run<32, 5>(p);
    case 176: return run<16, 11>(p);
    case 192: return run<64, 3>(p);
    case 208: return run<16, 13>(p);
    case 224: return run<32, 7>(p);
    case 240: return run<16, 15>(p);
    default: return run<256, 1>(p);
  }
}
