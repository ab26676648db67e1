// B3's tensor-core body for Hopper (sm_90a): flash attention in bf16 on
// mma.sync, FlashAttention-2's design, with an online softmax, GQA by
// index and the causal mask shifted by S_kv - S.
//
// Replaces, with flash_attention.cu's f32 CUDA-core body, the Pallas TPU
// kernel
//   B3 src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
//      (body _attn_kernel)
// for bf16 operands (ops.body() routes by dtype: f32 stays on the CUDA
// cores, where TF32 would break its 1e-5 tolerance):
//
//   q   (B, S, H, D)       bf16
//   k/v (B, S_kv, Hkv, D)  bf16, H % Hkv == 0, S_kv >= S under causal
//   (non-causal: any S_kv >= 1; every row attends all S_kv keys)
//   out (B, S, H, D)       bf16
//
// What it computes is the CUDA-core body's function: query head h of
// batch b reads kv head h / (H / Hkv); scores are dot(q, k) * scale, the
// scale an f32 multiply (1 / sqrt(D), passed in); with causal, query row
// r attends kv positions <= r + (S_kv - S); masked scores are -1e30,
// never -inf; the running max m, sum l and accumulator are f32, and at
// the end out = acc / max(l, 1e-30), rounded once to bf16.
//
// Numerics.  A bf16 x bf16 product is exact in f32, and the MMAs add in
// f32, so the scores differ from the plain version only in summation
// order.  The one new rounding site is P: the probabilities are rounded
// to bf16 in registers (a relative 2^-9) to feed P V's MMA.  l sums the
// f32 probabilities, before that rounding, as FlashAttention-2 does.
// The exponentials are ex2.approx of x log2(e) - m log2(e), one FFMA
// and one MUFU op a probability, after the f32 multiply by the scale.
//
// Design.  One block per (query tile of 128 rows, batch x query head);
// blocks run heavy tiles first (blockIdx.x counts query tiles from the
// end).  At D <= 64 a block is 4 warps and each warp owns 32 query rows,
// two m16 tiles, so every K and V fragment read from shared memory feeds
// both (FlashAttention-2's split; with 16 rows a warp the ldmatrix reads
// of K and V bounded the kernel: scripts/flash_mma_ab.py times both);
// above, 8 warps of 16 rows keep the accumulator in registers.  The q
// tile is staged once; K and V tiles of BK positions (64 for D <= 128;
// 32 at D = 192 and 256, so the f32 accumulator, D / 2 registers a
// thread, fits) are double-buffered with cp.async: the next tile's
// copies are in flight during this tile's math.  Per tile a warp
// computes S = Q K^T with mma.sync.m16n8k16 (bf16 in, f32 out; operands
// from shared memory through ldmatrix), runs the online softmax on the C
// fragments in registers (a row's max and sum over the quad of lanes
// that share it, by shuffles), rounds P to bf16 in registers and reuses
// it as the A fragment of P V, with V through ldmatrix.trans: P never
// goes to shared memory.  Under a causal mask the block stops at its
// last row's limit and a warp skips the tiles past its own rows' limit;
// only tiles that cross a warp's diagonal (or the S_kv edge) are masked.
// Rows past S and K/V rows past S_kv are zero-filled (cp.async's source
// size 0), their scores masked.
// Rows of shared memory are padded by 16 B, so the eight rows an
// ldmatrix reads fall in distinct banks.
//
// Head widths: any dh from 1 to 256, padded to the instance D in
// {32, 64, 128, 192, 256} (columns dh .. D - 1 zero in shared memory, not
// written out).  Rows whose bytes are a multiple of 16 (dh % 8 == 0,
// 16-byte aligned operands) are copied with cp.async; any other (20 bf16
// values are 40 B) element by element with plain loads into the same
// buffers.  Launch bounds ask for two blocks an SM at D <= 64 (eight
// warps) and one above; the build log prints every instance's ptxas
// register and spill lines.
//
// Bound: the operations.  At smollm-360m's training shape (B=8, S=4096,
// H=15, Hkv=5, D=64, causal) the attended pairs take 4 D FLOP each,
// 2.6e11 FLOP against 989 TFLOP/s of dense bf16 (0.26 ms), while q, k,
// v and out are 168 MB against 3.35 TB/s (0.05 ms).  This design runs
// every product on the tensor cores through mma.sync, which on Hopper
// issues at a fraction of wgmma's rate; each warp still re-reads K and
// V from shared memory for its 32 rows, and the softmax's FMUL, FMNMX,
// FFMA and ex2 per score do not overlap the MMAs.  Next (ROADMAP queue
// B): wgmma with P from registers, FlashAttention-3's ping-pong of two
// warpgroups, one K/V tile shared by a GQA group's heads, and a backward
// kernel (today the autograd backward recomputes through the plain
// version).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Per instance: m16 tiles (16 query rows) a warp, warps a block, the
// block's query rows, blocks an SM the launch bounds ask for, and the
// key tile.
template <int D>
__host__ __device__ constexpr int m_tiles() {
  return D <= 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int warps() {
  return D <= 64 ? 4 : 8;
}
template <int D>
__host__ __device__ constexpr int q_rows() {
  return 16 * m_tiles<D>() * warps<D>();
}
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D <= 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D <= 128 ? 64 : 32;
}
template <int D> constexpr size_t smem_bytes() {
  return sizeof(bf16) * (q_rows<D>() + 4 * key_tile<D>()) * (D + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the bytes past `src_bytes` (0 or 16)
// zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// C (16 x 8, f32) += A (16 x 16, bf16, row) B (16 x 8, bf16, col).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2, denormal results flushed to zero: a probability below
// 2^-126 adds nothing to a sum of at least 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage R rows of dh elements (row t at src + t * stride) into dst (row
// pitch D + 8); rows at or past n_rows and columns at or past dh are
// zero.  With `vec` each thread issues 16-byte cp.async copies (the
// caller commits and waits); otherwise it copies element by element.
template <int R, int D, int NTHR>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      size_t stride, int n_rows, int dh,
                                      bool vec) {
  constexpr int LD = D + 8;
  if (vec) {
    constexpr int kChunks = D / 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < R * kChunks; i += NTHR) {
      const int t = i / kChunks;
      const int c = (i - t * kChunks) * 8;
      const bool ok = t < n_rows && c < dh;
      cp_async16(dst + t * LD + c, ok ? src + t * stride + c : src,
                 ok ? 16 : 0);
    }
    return;
  }
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < R * D; i += NTHR) {
    const int t = i / D;
    const int c = i - t * D;
    dst[t * LD + c] = t < n_rows && c < dh ? src[t * stride + c] : zero;
  }
}

template <int D>
__global__ void __launch_bounds__(32 * warps<D>(), min_blocks<D>())
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int S, int Skv, int H, int Hkv, int dh, int vec,
                     float scale, int causal) {
  constexpr int MT = m_tiles<D>();   // m16 tiles (16 query rows) a warp
  constexpr int NTHR = 32 * warps<D>();
  constexpr int BQ = q_rows<D>();
  constexpr int BK = key_tile<D>();
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;      // k-steps of Q K^T
  constexpr int NT = BK / 8;      // n8 tiles of a score row block
  constexpr int DT = D / 8;       // n8 tiles of the output
  extern __shared__ __align__(16) bf16 smem[];
  bf16* q_s = smem;                  // (BQ, LD)
  bf16* k_s = q_s + BQ * LD;        // 2 x (BK, LD)
  bf16* v_s = k_s + 2 * BK * LD;     // 2 x (BK, LD)

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int offset = Skv - S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const size_t q_stride = static_cast<size_t>(H) * dh;
  const size_t kv_stride = static_cast<size_t>(Hkv) * dh;
  const bf16* kb = k + static_cast<size_t>(b) * Skv * kv_stride +
                   static_cast<size_t>(hk) * dh;
  const bf16* vb = v + static_cast<size_t>(b) * Skv * kv_stride +
                   static_cast<size_t>(hk) * dh;

  // Key positions the block attends, and those its warp's rows attend.
  const int last_row = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? min(Skv, last_row + offset + 1) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int r0 = q0 + 16 * MT * warp;   // the warp's first row
  const int w_end =
      r0 >= S ? 0
      : causal ? min(Skv, min(r0 + 16 * MT - 1, S - 1) + offset + 1)
               : Skv;

  stage<BQ, D, NTHR>(q_s,
                      q + (static_cast<size_t>(b) * S + q0) * q_stride +
                          static_cast<size_t>(h) * dh,
                      q_stride, S - q0, dh, vec);
  stage<BK, D, NTHR>(k_s, kb, kv_stride, Skv, dh, vec);
  stage<BK, D, NTHR>(v_s, vb, kv_stride, Skv, dh, vec);
  cp_async_commit();

  // Row r (0, 1) of m-tile mt is query row r0 + 16 mt + g + 8 r.
  float o[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][i][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = kNegInf;
      l[mt][r] = 0.f;
    }

  // ldmatrix addressing: lane -> (row, column) of the 8 x 8 matrix it
  // points at.  A (Q): rows + (lane % 8) + 8 ((lane / 8) % 2), columns
  // + 8 (lane / 16).  B (K): keys + (lane % 8) + 8 (lane / 16), columns
  // + 8 ((lane / 8) % 2).  B (V, transposed): keys as A's rows, columns
  // as A's.
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_col = 8 * (lane / 16);
  const int k_row = (lane % 8) + 8 * (lane / 16);
  const int k_col = 8 * ((lane / 8) % 2);
  const bf16* q_frag = q_s + (16 * MT * warp + a_row) * LD + a_col;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int k1 = (j + 1) * BK;
      stage<BK, D, NTHR>(k_s + (buf ^ 1) * BK * LD, kb + k1 * kv_stride,
                         kv_stride, Skv - k1, dh, vec);
      stage<BK, D, NTHR>(v_s + (buf ^ 1) * BK * LD, vb + k1 * kv_stride,
                         kv_stride, Skv - k1, dh, vec);
      cp_async_commit();
      cp_async_wait<1>();   // tile j (and q) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * BK;
    if (k0 < w_end) {
      const bf16* kt = k_s + buf * BK * LD;
      const bf16* vt = v_s + buf * BK * LD;
      // S = Q K^T: each K fragment feeds the warp's MT m-tiles.
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(a[mt], q_frag + 16 * mt * LD + 16 * ks);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (16 * np + k_row) * LD + 16 * ks + k_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(s[mt][2 * np], a[mt], bk[0], bk[1]);
            mma(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
          }
        }
      }

      // Scale, mask, and the online softmax.  Element e of tile i of
      // m-tile mt is row r0 + 16 mt + g + 8 (e / 2), key k0 + 8 i + 2 t4
      // + e % 2.  A tile every row of the warp sees whole takes no mask.
      const bool whole =
          k0 + BK <= Skv && (!causal || k0 + BK - 1 <= r0 + offset);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[mt][i][e] * scale;
            if (!whole) {
              const int col = k0 + 8 * i + 2 * t4 + (e & 1);
              const int row = r0 + 16 * mt + g + 8 * (e >> 1);
              if (col >= Skv || (causal && col > row + offset)) x = kNegInf;
            }
            s[mt][i][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float alpha[2], ml[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[mt][r], mx[r]);
          alpha[r] = ex2((m[mt][r] - m_new) * kLog2e);
          m[mt][r] = m_new;
          ml[r] = m_new * kLog2e;
          l[mt][r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[mt][i][e], kLog2e, -ml[e >> 1]));
            s[mt][i][e] = p;
            l[mt][e >> 1] += p;   // this lane's share; the quad sums last
          }
#pragma unroll
        for (int i = 0; i < DT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][i][e] *= alpha[e >> 1];
      }

      // O += P V: P's C fragments, rounded to bf16, are the A fragments
      // of the 16-key k-steps; each V fragment feeds the MT m-tiles.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv,
                            vt + (16 * kk + a_row) * LD + 16 * dp + a_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(o[mt][2 * dp], a[mt], bv[0], bv[1]);
            mma(o[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();   // buffer `buf` is free for tile j + 2
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      lr = 1.f / fmaxf(lr, 1e-30f);
      const int row = r0 + 16 * mt + g + 8 * r;
      if (row >= S) continue;
      bf16* orow = out + (static_cast<size_t>(b) * S + row) * q_stride +
                   static_cast<size_t>(h) * dh;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        const int col = 8 * i + 2 * t4;
        if (col >= dh) continue;
        const float x0 = o[mt][i][2 * r] * lr;
        const float x1 = o[mt][i][2 * r + 1] * lr;
        if (dh % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          orow[col] = __float2bfloat16(x0);
          if (col + 1 < dh) orow[col + 1] = __float2bfloat16(x1);
        }
      }
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Skv, int H, int Hkv, int dh, int vec, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + q_rows<D>() - 1) / q_rows<D>(), B * H);
  flash_mma_kernel<D><<<grid, 32 * warps<D>(), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, Skv, H, Hkv,
      dh, vec, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes): bf16 q, k, v and out,
// 1 <= dh <= 256, Skv >= S under causal (any Skv >= 1 without).
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int flash_attention_mma_forward(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int S, int Skv, int H, int Hkv,
                                           int dh, int causal, float scale,
                                           void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  // A causal row r attends keys <= r + Skv - S, so Skv >= S; a non-causal
  // row attends all Skv keys, whatever S is.
  if (Hkv <= 0 || H % Hkv != 0 || Skv < (causal ? S : 1) || dh < 1 ||
      dh > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dh % 8 == 0 && reinterpret_cast<size_t>(q) % 16 == 0 &&
                  reinterpret_cast<size_t>(k) % 16 == 0 &&
                  reinterpret_cast<size_t>(v) % 16 == 0;
#define FLASH_WIDTH(W)                                                     \
  if (dh <= W)                                                             \
    return launch<W>(q, k, v, out, B, S, Skv, H, Hkv, dh, vec, causal,     \
                     scale, s);
  FLASH_WIDTH(32)
  FLASH_WIDTH(64)
  FLASH_WIDTH(128)
  FLASH_WIDTH(192)
  FLASH_WIDTH(256)
#undef FLASH_WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}
