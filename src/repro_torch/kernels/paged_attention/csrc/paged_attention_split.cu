// The paged-attention kernel's tensor-core body for Hopper (sm_90a):
// bf16 queries on bf16, int8 or fp8 e4m3 pools, with each slot's
// positions split across blocks (flash-decoding) and the products on
// mma.sync.
//
// Replaces, with paged_attention.cu's CUDA-core body, the Pallas TPU
// kernels
//   B1 src/repro/kernels/paged_attention/kernel.py:paged_attention_pallas
//   B2 src/repro/kernels/paged_attention/kernel.py:
//      paged_prefill_attention_pallas
// and their quantized branch (_dequant, the ks/vs operands of _scores)
// for bf16 q (ops.body routes by q and pool dtype and head_dim: f32 q and
// f32 pools stay on the CUDA cores):
//
//   q        (B, Q, H, D)   bf16, D a multiple of 16 up to 256
//   k/v pool (R, T, KV, D)  bf16, int8 or fp8 e4m3, row 0 the NULL block
//   k/v scale (R, KV) f32   narrow pools only
//   tables   (B, nb) int32, lengths (B,) int32, out (B, Q, H, D) bf16
//
// What it computes is the CUDA-core body's function, with the same
// rounding sites (the reference's _scores and _accumulate as XLA compiles
// them): row r of kv head h (query head h G + r / Q at query position
// qi = r % Q) attends the positions below its limit lengths[b] - (Q - 1 -
// qi); s = round_bf16(dot(q, k)) * scale in f32; the softmax statistics
// (m, l) in f32 over all the row's positions first, and only then
// p = round_bf16(exp(s - m) / max(l, 1e-30)) and acc += p v in f32; out =
// round_bf16(acc).  No one-pass online softmax: p is rounded with the
// row's global statistics, as the reference rounds it.
//
// Design.  Positions are split into partitions of P positions at fixed
// absolute offsets (0, P, 2P, ...; P a multiple of the 64-position chunk
// and of T, fixed by (T, D) alone in ops.partition_positions), so a
// decode step runs B x KV x row tiles x partitions blocks instead of
// B x KV.  Two launches a call, both with grid (B KV, row tiles,
// partitions):
//   stats: each block takes, for each row of its tile, the online (m, l)
//          over its partition's positions below the row's limit, chunk
//          by chunk, and writes them to an f32 workspace;
//   pv:    each block combines its rows' (m, l) over the row's
//          partitions in partition order (m the max, l the sum of
//          l_q exp(m_q - m)), recomputes the chunk's scores (the same
//          instructions on the same operands: the same bits), forms p
//          and accumulates its partition's p v in f32 registers, and
//          writes that partial to the workspace.  The last block of a
//          (slot, kv head, row tile) to finish — known through a
//          __threadfence() and an atomic counter in the workspace, which
//          that block resets, so no memset launch — sums the partials in
//          partition order and writes round_bf16(sum).
// A partition wholly past a row's limit contributes nothing to it: it is
// skipped, not combined as (-inf, 0).  Blocks of partitions past the
// tile's longest limit exit at once.
//
// Inside a block, 4 warps; a row tile holds RT = 16, 32 or 64 rows (the
// kv head's G Q rows padded to 16, at most 64 a tile), RT / 16 row groups
// of 16 rows, and the warps of a row group split the chunk's score
// columns for Q K^T and the output's 16-column pairs for P V.  Q K^T and
// P V run on mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands from
// shared memory through ldmatrix (V through ldmatrix.trans).  The chunk's
// scores go to shared memory in f32: one warp per row takes the
// statistics there (stats), or every thread forms p in bf16 over them
// (pv: P overlays the score tile, so a 64-row block fits twice in an
// SM), then P V reads P through ldmatrix.  K (and V) tiles of 64 positions are
// double-buffered with cp.async (16-byte copies of whole pool rows): the
// next chunk's copies are in flight during this chunk's math.  A narrow
// pool's words land in a byte ring and are widened, multiplied in f32 by
// their (row, kv head) scale and rounded once to bf16 into the tile —
// kvquant.dequantize's expression, so a narrow pool gives exactly what
// its dequantized bf16 pool gives; the tile then holds bf16, exactly.
// Head widths are padded to the instance D (16, 32, 64, 128, 256) with
// zero columns.
//
// Bits.  Every row is independent of the others: its partitions, chunks,
// combine order and the mma k-steps that make each of its scores and
// outputs are fixed by its query, its limit and the pool, never by Q,
// the row tile or the other rows (a padded row or a position past a
// row's limit enters its P V with p = 0).  So every row of a chunk or a
// verify window equals B1 at that row's limit, bit for bit.  Nothing at
// or past the tile's longest limit is read (cp.async zero-fills those
// rows), and a row's p is 0 at and past its own limit, so NaN in the NULL
// block or a stale tail cannot leak.
//
// Bound: the HBM bytes of the K/V positions attended (at qwen3-8b decode,
// batch 8 with lengths 1..2048, 24.4 MB: 0.0072 ms at 3.35 TB/s).  K is
// read twice (once per launch), which the split's parallelism pays for;
// a row tile of a prefill chunk reads the slot's prefix once per tile
// (4 tiles per kv head for a 64-token chunk at qwen3-8b).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;              // positions a chunk
constexpr int kMaxPartBlocks = 512;     // pool blocks a partition: P / T
constexpr float kNegInf = -1e30f;

// Pool kinds (the wrapper's kv_kind; 0, f32, has no split body).
enum PoolKind { kBF16 = 1, kInt8 = 2, kE4M3 = 3 };

struct Args {
  const bf16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  bf16* out;
  float2* ml;          // (B KV, G Q, NP): each row's (m, l) per partition
  float* part;         // (B KV, G Q, NP, D): each row's partial P V
  unsigned* counters;  // (B KV, row tiles): blocks of the tile finished
  int Q, H, KV, D, T, nb, P, NP, fp8;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with src_bytes 0 the 16 bytes are zeros.
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

// Warps of a block: 8 for a 64-row tile (four row groups of two warps),
// else 4.
template <int RT>
__host__ __device__ constexpr int warps() {
  return RT == 64 ? 8 : 4;
}

// C (16 x 8, f32) += A (16 x 16, bf16, row) B (16 x 8, bf16, col).  Not
// volatile: the compiler may interleave independent MMAs.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void add4(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One 1-byte pool word widened exactly to f32: int8, or fp8 e4m3.
__device__ __forceinline__ float narrow_to_f32(unsigned byte, int fp8) {
  if (fp8) {
    __nv_fp8_e4m3 w;
    w.__x = static_cast<__nv_fp8_storage_t>(byte);
    return static_cast<float>(w);
  }
  return static_cast<float>(static_cast<int8_t>(byte));
}

// Shared memory of one instance, in bytes; every region starts on 16 B.
// The table entries (and a narrow pool's scales) of a partition take
// `nblk` slots each at the end.
struct Layout {
  int q, k, v, raw, s, m, l, lim, rows, ks, vs, bytes;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) / 16 * 16; }

template <int DI, int RT, bool NARROW, bool PV>
__host__ __device__ Layout layout(int nblk) {
  constexpr int LD = DI + 8;
  constexpr int tile = kChunk * LD * 2;         // one bf16 K or V tile
  constexpr int slots = NARROW ? 1 : 2;         // narrow: the ring is raw
  Layout L{};
  int o = 0;
  L.q = o;    o += align16(RT * LD * 2);
  L.k = o;    o += slots * tile;
  L.v = o;    o += PV ? slots * tile : 0;
  L.raw = o;  o += NARROW ? (PV ? 4 : 2) * kChunk * DI : 0;
  L.s = o;    o += RT * (kChunk + 4) * 4;  // P (bf16) overlays it in pv
  L.m = o;    o += align16(RT * 4);
  L.l = o;    o += align16(RT * 4);
  L.lim = o;  o += align16(RT * 4);
  L.rows = o; o += align16(nblk * 4);
  L.ks = o;   o += NARROW ? align16(nblk * 4) : 0;
  L.vs = o;   o += NARROW && PV ? align16(nblk * 4) : 0;
  L.bytes = o + 16;                             // + the last-block flag
  return L;
}

// Stage the chunk at absolute position c0 of one pool (K or V) for kv
// head h: positions at or past `end` and columns at or past D are zero.
// bf16 pools land in `tile` (row pitch DI + 8); narrow pools' words in
// `raw` (row pitch DI bytes), widened later by `widen`.
template <int DI, bool NARROW, int NTHR>
__device__ __forceinline__ void stage(bf16* tile, unsigned char* raw,
                                      const void* pool, const int* rows_s,
                                      int c0, int pstart, int end, int h,
                                      const Args& a) {
  constexpr int kSeg = NARROW ? 16 : 8;   // elements a 16-byte copy
  constexpr int kSegs = DI / kSeg;
  const int segs = a.D / kSeg;
  for (int i = threadIdx.x; i < kChunk * kSegs; i += NTHR) {
    const int t = i / kSegs;
    const int sg = i - t * kSegs;
    const int pos = c0 + t;
    const bool ok = pos < end && sg < segs;
    size_t off = 0;
    if (ok) {
      const int rel = pos - pstart;
      const size_t tok =
          static_cast<size_t>(rows_s[rel / a.T]) * a.T + pos % a.T;
      off = (tok * a.KV + h) * a.D + sg * kSeg;
    }
    if constexpr (NARROW) {
      cp_async16(raw + t * DI + sg * 16,
                 static_cast<const unsigned char*>(pool) + off, ok ? 16 : 0);
    } else {
      cp_async16(tile + t * (DI + 8) + sg * 8,
                 static_cast<const bf16*>(pool) + off, ok ? 16 : 0);
    }
  }
}

// A narrow chunk's words -> its bf16 tile: widen, multiply in f32 by the
// (row, kv head) scale of the position's pool block, round once to bf16.
// Positions at or past `end` and columns past D are zeros (their scales,
// possibly NaN, are never read).
template <int DI, int NTHR>
__device__ __forceinline__ void widen(bf16* tile, const unsigned char* raw,
                                      const float* scale_s, int c0,
                                      int pstart, int end, const Args& a) {
  constexpr int kSegs = DI / 16;
  const int segs = a.D / 16;
  for (int i = threadIdx.x; i < kChunk * kSegs; i += NTHR) {
    const int t = i / kSegs;
    const int sg = i - t * kSegs;
    const int pos = c0 + t;
    uint32_t packed[8];
    if (pos < end && sg < segs) {
      const float sc = scale_s[(pos - pstart) / a.T];
      const uint4 r = *reinterpret_cast<const uint4*>(raw + t * DI + sg * 16);
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float lo =
              narrow_to_f32((w[k] >> (16 * j)) & 0xffu, a.fp8) * sc;
          const float hi =
              narrow_to_f32((w[k] >> (16 * j + 8)) & 0xffu, a.fp8) * sc;
          const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
          packed[2 * k + j] = *reinterpret_cast<const uint32_t*>(&v);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) packed[k] = 0u;
    }
    uint4* dst = reinterpret_cast<uint4*>(tile + t * (DI + 8) + sg * 16);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
}

// S = Q K^T for the chunk in `kt`, scaled, into s_s (row pitch kChunk +
// 4): s = round_bf16(dot) * scale.  The warp computes its row group's 16
// rows over its column group's score columns; every score is the same
// KS mma k-steps in the same order, whichever warp computes it.
template <int DI, int RT>
__device__ __forceinline__ void scores(float* s_s, const bf16* q_s,
                                       const bf16* kt, int nr, float scale) {
  constexpr int LD = DI + 8;
  constexpr int CG = warps<RT>() / (RT / 16);
  constexpr int NTW = kChunk / 8 / CG;     // n8 score tiles a warp
  constexpr int SLD = kChunk + 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp / CG;
  const int cg = warp - rg * CG;
  if (16 * rg >= nr) return;               // rows of padding only
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_col = 8 * (lane / 16);
  const int k_row = (lane % 8) + 8 * (lane / 16);
  const int k_col = 8 * ((lane / 8) % 2);
  float s[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  const bf16* qf = q_s + (16 * rg + a_row) * LD + a_col;
  const bf16* kf = kt + (16 * (cg * NTW / 2) + k_row) * LD + k_col;
#pragma unroll
  for (int ks = 0; ks < DI / 16; ++ks) {
    uint32_t qa[4];
    ldmatrix_x4(qa, qf + 16 * ks);
#pragma unroll
    for (int np = 0; np < NTW / 2; ++np) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kf + 16 * np * LD + 16 * ks);
      mma(s[2 * np], qa, kb[0], kb[1]);
      mma(s[2 * np + 1], qa, kb[2], kb[3]);
    }
  }
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int col = (cg * NTW + i) * 8 + 2 * t4;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = 16 * rg + g + 8 * hr;
      *reinterpret_cast<float2*>(s_s + row * SLD + col) =
          make_float2(round_bf16(s[i][2 * hr]) * scale,
                      round_bf16(s[i][2 * hr + 1]) * scale);
    }
  }
}

template <int DI, int RT, bool NARROW, bool PV>
__global__ void __launch_bounds__(32 * warps<RT>())
    paged_split_kernel(const Args a) {
  constexpr int NW = warps<RT>();
  constexpr int NTHR = 32 * NW;
  constexpr int LD = DI + 8;
  constexpr int SLD = kChunk + 4;
  constexpr int PLD = kChunk + 8;
  constexpr int CG = NW / (RT / 16);
  constexpr int DP = DI / 16;                 // 16-column output pairs
  constexpr int DPW = (DP + CG - 1) / CG;     // pairs a warp at most
  const int bk = blockIdx.x;                  // b * KV + h
  const int b = bk / a.KV;
  const int h = bk - b * a.KV;
  const int G = a.H / a.KV;
  const int GQ = G * a.Q;
  const int r0 = blockIdx.y * RT;
  const int nr = min(RT, GQ - r0);
  const int cap = a.nb * a.T;
  const int length = a.lengths[b];
  const int tid = threadIdx.x;

  // Row j of the tile is row r0 + j of kv head h; its limit depends on
  // its query position only, and grows with it.  The tile's span is its
  // longest limit: that of its latest query position (Q - 1 once the
  // tile's rows wrap past a query head's last position).
  auto row_limit = [&](int j) {
    const int qi = (r0 + j) % a.Q;
    return min(length - (a.Q - 1 - qi), cap);
  };
  const int qi0 = r0 % a.Q;
  const int span = max(0, qi0 + nr - 1 >= a.Q ? min(length, cap)
                                              : row_limit(nr - 1));
  const int n_active = max(1, (span + a.P - 1) / a.P);
  const int part = blockIdx.z;
  if (part >= n_active) return;
  const int pstart = part * a.P;
  const int pend = min(pstart + a.P, span);
  const int nk = pend > pstart ? (pend - pstart + kChunk - 1) / kChunk : 0;
  const int nblk = (pend - pstart + a.T - 1) / a.T;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<DI, RT, NARROW, PV>(a.P / a.T);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.q);
  bf16* k_t = reinterpret_cast<bf16*>(smem + L.k);
  bf16* v_t = reinterpret_cast<bf16*>(smem + L.v);
  unsigned char* raw = smem + L.raw;
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L.s);   // over the scores
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  int* lim_s = reinterpret_cast<int*>(smem + L.lim);
  int* rows_s = reinterpret_cast<int*>(smem + L.rows);
  float* ks_s = reinterpret_cast<float*>(smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  int* last_s = reinterpret_cast<int*>(smem + L.bytes - 16);

  const size_t row_base = static_cast<size_t>(bk) * GQ + r0;  // ml rows
  const int* tb = a.tables + static_cast<size_t>(b) * a.nb + pstart / a.T;
  for (int i = tid; i < nblk; i += NTHR) {
    const int row = tb[i];
    rows_s[i] = row;
    if constexpr (NARROW) {
      const size_t si = static_cast<size_t>(row) * a.KV + h;
      ks_s[i] = a.k_scale[si];
      if constexpr (PV) vs_s[i] = a.v_scale[si];
    }
  }
  if (tid < RT) {
    const int lim = tid < nr ? row_limit(tid) : 0;
    lim_s[tid] = lim;
    float m = kNegInf, l = 0.f;
    if (PV && tid < nr && lim > pstart) {
      // The row's statistics over all its partitions, in partition order,
      // eight partitions' loads in flight at once.
      const int nq = (lim + a.P - 1) / a.P;
      const float2* ml = a.ml + (row_base + tid) * a.NP;
      for (int q0 = 0; q0 < nq; q0 += 8) {
        float2 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = q0 + u < nq ? ml[q0 + u] : make_float2(kNegInf, 0.f);
#pragma unroll
        for (int u = 0; u < 8; ++u) m = fmaxf(m, v[u].x);
      }
      for (int q0 = 0; q0 < nq; q0 += 8) {
        float2 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = q0 + u < nq ? ml[q0 + u] : make_float2(kNegInf, 0.f);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (q0 + u < nq) l += v[u].y * expf(v[u].x - m);
      }
    }
    m_s[tid] = m;
    l_s[tid] = l;
  }
  __syncthreads();

  // This warp's P V accumulator: its row group's 16 rows, 16-column
  // pairs cg, cg + CG, ... of the (padded) head width.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rg = warp / CG;
  const int cg = warp - rg * CG;
  float o[DPW][2][4];
#pragma unroll
  for (int i = 0; i < DPW; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;

  auto fetch = [&](int k) {
    const int c0 = pstart + k * kChunk;
    const int slot = k & 1;
    bf16* kd = k_t + (NARROW ? 0 : slot * kChunk * LD);
    bf16* vd = v_t + (NARROW ? 0 : slot * kChunk * LD);
    unsigned char* rk = raw + slot * kChunk * DI;
    unsigned char* rv = raw + (2 + slot) * kChunk * DI;
    stage<DI, NARROW, NTHR>(kd, rk, a.k_pool, rows_s, c0, pstart, pend, h,
                            a);
    if constexpr (PV)
      stage<DI, NARROW, NTHR>(vd, rv, a.v_pool, rows_s, c0, pstart, pend,
                              h, a);
    cp_async_commit();
  };

  if (nk > 0) {
    // The tile's query rows (zero past nr and past D), with chunk 0.
    const bf16* qb = a.q + static_cast<size_t>(b) * a.Q * a.H * a.D;
    for (int i = tid; i < RT * (DI / 8); i += NTHR) {
      const int j = i / (DI / 8);
      const int sg = i - j * (DI / 8);
      const bool ok = j < nr && sg < a.D / 8;
      size_t off = 0;
      if (ok) {
        const int r = r0 + j;
        const int g = r / a.Q;
        const int qi = r - g * a.Q;
        off = (static_cast<size_t>(qi) * a.H + h * G + g) * a.D + sg * 8;
      }
      cp_async16(q_s + j * LD + sg * 8, qb + off, ok ? 16 : 0);
    }
    fetch(0);
  }

  for (int k = 0; k < nk; ++k) {
    const int slot = k & 1;
    const int c0 = pstart + k * kChunk;
    if (k + 1 < nk) {
      fetch(k + 1);            // in flight during this chunk's math
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_t + (NARROW ? 0 : slot * kChunk * LD);
    const bf16* vt = v_t + (NARROW ? 0 : slot * kChunk * LD);
    if constexpr (NARROW) {
      widen<DI, NTHR>(k_t, raw + slot * kChunk * DI, ks_s, c0, pstart, pend,
                      a);
      if constexpr (PV)
        widen<DI, NTHR>(v_t, raw + (2 + slot) * kChunk * DI, vs_s, c0,
                        pstart, pend, a);
      __syncthreads();
    }
    scores<DI, RT>(s_s, q_s, kt, nr, a.scale);
    __syncthreads();

    if constexpr (!PV) {
      // Online statistics, one warp per row, over the row's positions of
      // this chunk only (a chunk past its limit leaves m and l as they
      // are): the CUDA-core body's reduction, position for position.
      for (int j = warp; j < nr; j += NW) {
        const int nv = min(kChunk, lim_s[j] - c0);
        if (nv <= 0) continue;
        const float* sr = s_s + j * SLD;
        float mb = kNegInf;
        for (int t = lane; t < nv; t += 32) mb = fmaxf(mb, sr[t]);
        const float m_prev = m_s[j];
        const float m_new = fmaxf(m_prev, warp_max(mb));
        float sum = 0.f;
        for (int t = lane; t < nv; t += 32) sum += expf(sr[t] - m_new);
        sum = warp_sum(sum);
        if (lane == 0) {
          l_s[j] = l_s[j] * expf(m_prev - m_new) + sum;
          m_s[j] = m_new;
        }
      }
    } else {
      // p in bf16, zero at and past each row's limit and on padded rows,
      // written over the scores once every thread has read its own.
      constexpr int kPer = RT * kChunk / NTHR;
      float p[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = tid + u * NTHR;
        const int j = i / kChunk;
        const int t = i - j * kChunk;
        p[u] = c0 + t < lim_s[j]
                   ? expf(s_s[j * SLD + t] - m_s[j]) / fmaxf(l_s[j], 1e-30f)
                   : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = tid + u * NTHR;
        const int j = i / kChunk;
        p_s[j * PLD + i - j * kChunk] = __float2bfloat16(p[u]);
      }
      __syncthreads();
      if (16 * rg < nr) {
        const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);
        const int a_col = 8 * (lane / 16);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          uint32_t pa[4];
          ldmatrix_x4(pa, p_s + (16 * rg + a_row) * PLD + 16 * kk + a_col);
#pragma unroll
          for (int i = 0; i < DPW; ++i) {
            const int dp = cg + CG * i;
            if (dp < DP) {
              uint32_t vb[4];
              ldmatrix_x4_trans(vb,
                                vt + (16 * kk + a_row) * LD + 16 * dp + a_col);
              mma(o[i][0], pa, vb[0], vb[1]);
              mma(o[i][1], pa, vb[2], vb[3]);
            }
          }
        }
      }
    }
    __syncthreads();           // the slot and the tiles may be reused now
  }

  if constexpr (!PV) {
    if (tid < nr && lim_s[tid] > pstart)
      a.ml[(row_base + tid) * a.NP + part] = make_float2(m_s[tid], l_s[tid]);
    return;
  } else {
    // This partition's partial P V of each row that attends into it.
    const int g = lane / 4;
    const int t4 = lane % 4;
#pragma unroll
    for (int i = 0; i < DPW; ++i) {
      const int dp = cg + CG * i;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * dp + 8 * n + 2 * t4;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = 16 * rg + g + 8 * hr;
          if (dp < DP && j < nr && col < a.D && lim_s[j] > pstart)
            *reinterpret_cast<float2*>(
                a.part + ((row_base + j) * a.NP + part) * a.D + col) =
                make_float2(o[i][n][2 * hr], o[i][n][2 * hr + 1]);
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      unsigned* count = a.counters + static_cast<size_t>(bk) * gridDim.y +
                        blockIdx.y;
      const bool last = atomicAdd(count, 1u) + 1 == static_cast<unsigned>(
                                                        n_active);
      if (last) *count = 0u;   // every block of the tile has arrived
      *last_s = last;
    }
    __syncthreads();
    if (!*last_s) return;
    __threadfence();
    // The last block: each row's partials summed in partition order,
    // four columns a thread, four partitions' loads in flight at once.
    for (int i = tid; i < nr * (a.D / 4); i += NTHR) {
      const int j = i / (a.D / 4);
      const int d = (i - j * (a.D / 4)) * 4;
      const int lim = lim_s[j];
      const int nq = lim > 0 ? (lim + a.P - 1) / a.P : 0;
      const float4* pp = reinterpret_cast<const float4*>(
          a.part + (row_base + j) * a.NP * a.D + d);
      const int step = a.D / 4;            // float4s from one partition on
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (nq > 0) acc = __ldcg(pp);
      int q = 1;
      for (; q + 4 <= nq; q += 4) {
        const float4 x0 = __ldcg(pp + q * step);
        const float4 x1 = __ldcg(pp + (q + 1) * step);
        const float4 x2 = __ldcg(pp + (q + 2) * step);
        const float4 x3 = __ldcg(pp + (q + 3) * step);
        add4(acc, x0);
        add4(acc, x1);
        add4(acc, x2);
        add4(acc, x3);
      }
      for (; q < nq; ++q) add4(acc, __ldcg(pp + q * step));
      const int r = r0 + j;
      const int gg = r / a.Q;
      const int qi = r - gg * a.Q;
      bf16* o = a.out +
                ((static_cast<size_t>(b) * a.Q + qi) * a.H + h * G + gg) *
                    a.D + d;
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(acc.x,
                                                                    acc.y);
      *reinterpret_cast<__nv_bfloat162*>(o + 2) =
          __floats2bfloat162_rn(acc.z, acc.w);
    }
  }
}

// Opt an instance in to the shared memory it needs (above 48 KB); each
// instance remembers the most it has been given.
template <int DI, int RT, bool NARROW, bool PV>
cudaError_t allow_smem(int bytes) {
  static int given = 0;
  if (bytes <= given) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<DI, RT, NARROW, PV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) given = bytes;
  return err;
}

template <int DI, int RT, bool NARROW>
int launch(const Args& a, int B, int n_rt, cudaStream_t stream) {
  const int nblk = a.P / a.T;
  const int s0 = layout<DI, RT, NARROW, false>(nblk).bytes;
  const int s1 = layout<DI, RT, NARROW, true>(nblk).bytes;
  cudaError_t err = allow_smem<DI, RT, NARROW, false>(s0);
  if (err == cudaSuccess) err = allow_smem<DI, RT, NARROW, true>(s1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.KV, n_rt, a.NP);
  constexpr int threads = 32 * warps<RT>();
  paged_split_kernel<DI, RT, NARROW, false><<<grid, threads, s0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_split_kernel<DI, RT, NARROW, true><<<grid, threads, s1, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DI, int RT>
int by_pool(const Args& a, int B, int n_rt, bool narrow, cudaStream_t s) {
  return narrow ? launch<DI, RT, true>(a, B, n_rt, s)
                : launch<DI, RT, false>(a, B, n_rt, s);
}

template <int DI>
int by_rows(const Args& a, int B, int n_rt, int RT, bool narrow,
            cudaStream_t s) {
  switch (RT) {
    case 16: return by_pool<DI, 16>(a, B, n_rt, narrow, s);
    case 32: return by_pool<DI, 32>(a, B, n_rt, narrow, s);
    default: return by_pool<DI, 64>(a, B, n_rt, narrow, s);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): B1 (Q = 1) and B2 alike.
// ``ml``, ``part`` and ``counters`` are the caller's workspace: (B KV,
// G Q, NP) float2, (B KV, G Q, NP, D) f32 on 16 bytes and (B KV,
// ceil(G Q / RT))
// uint32, the counters zero (the kernel leaves them zero again).  RT is
// 16, 32 or 64 rows a tile; P a multiple of 64 and of T with P / T <=
// 512; NP = max(1, ceil(nb T / P)).  ``kv_kind`` 1 bf16, 2 int8, 3 fp8
// e4m3; narrow pools come with their (R, KV) f32 scales.  Returns
// cudaGetLastError() after the second launch: 0 on success,
// cudaErrorInvalidValue for arguments the body does not take.
extern "C" int paged_attention_split(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* ml, void* part, void* counters,
    int B, int Q, int H, int KV, int D, int T, int nb, int RT, int P, int NP,
    int kv_kind, float scale, void* stream) {
  if (B == 0 || Q == 0) return 0;
  const bool narrow = kv_kind == kInt8 || kv_kind == kE4M3;
  const int cap = nb * T;
  const int want_np = cap > P ? (cap + P - 1) / P : 1;
  if (B < 1 || Q < 1 || KV < 1 || H % KV != 0 || T < 1 || nb < 1 ||
      D < 16 || D > 256 || D % 16 != 0 ||
      (kv_kind != kBF16 && !narrow) || (RT != 16 && RT != 32 && RT != 64) ||
      P % kChunk != 0 || P % T != 0 || P / T > kMaxPartBlocks ||
      NP != want_np || narrow != (k_scale != nullptr && v_scale != nullptr) ||
      reinterpret_cast<size_t>(q) % 16 != 0 ||
      reinterpret_cast<size_t>(part) % 16 != 0 ||
      reinterpret_cast<size_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<size_t>(v_pool) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(q), k_pool, v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tables),
               static_cast<const int*>(lengths), static_cast<bf16*>(out),
               static_cast<float2*>(ml), static_cast<float*>(part),
               static_cast<unsigned*>(counters), Q, H, KV, D, T, nb, P, NP,
               kv_kind == kE4M3 ? 1 : 0, scale};
  const int n_rt = (H / KV * Q + RT - 1) / RT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return by_rows<16>(a, B, n_rt, RT, narrow, s);
  if (D <= 32) return by_rows<32>(a, B, n_rt, RT, narrow, s);
  if (D <= 64) return by_rows<64>(a, B, n_rt, RT, narrow, s);
  if (D <= 128) return by_rows<128>(a, B, n_rt, RT, narrow, s);
  return by_rows<256>(a, B, n_rt, RT, narrow, s);
}
