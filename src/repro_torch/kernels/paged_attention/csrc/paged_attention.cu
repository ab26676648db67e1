// Paged attention for Hopper (sm_90a): GQA attention read straight off a
// paged KV block pool through per-slot block tables, for one query per
// slot (decode) or Q consecutive queries per slot (chunked prefill and
// the speculative verify window).  This is the kernel's CUDA-core body:
// ops.body routes bf16 queries on bf16, int8 or fp8 pools (the serving
// path) to paged_attention_split.cu, and f32 queries or f32 pools here.
//
// Replaces the Pallas TPU kernels
//   B1 src/repro/kernels/paged_attention/kernel.py:paged_attention_pallas
//      (body _paged_attn_kernel, score helper _scores)
//   B2 src/repro/kernels/paged_attention/kernel.py:
//      paged_prefill_attention_pallas (body _paged_prefill_kernel)
// and computes what they compute, not block by block:
//
//   q       (B, Q, H, D)    bf16 or f32 (the compute dtype dt); B1: Q = 1
//   k/v pool (R, T, KV, D)  f32, bf16, int8 or fp8 e4m3, row 0 the NULL
//                           block
//   k/v scale (R, KV) f32   narrow pools only: one scale per (row, head)
//   tables  (B, nb) int32   physical pool row of each logical block
//   lengths (B,) int32      valid positions per slot (start + Q)
//   out     (B, Q, H, D)    dt
//
// The G * Q query rows of kv head h are numbered g-major (row r is query
// head h * G + r / Q at query position qi = r % Q), and row r attends the
// positions below its own causal limit lengths[b] - (Q - 1 - qi).  Both
// entry points launch one kernel: B1 is the Q = 1 case.
//
// One thread block per (slot b, kv head h, tile of R rows), R as many
// rows as the register accumulator holds (kThreads * kMaxPairs / D: 8 at
// D = 128, all G rows of a decode step at qwen3-8b).  The block stages
// its rows' queries once, then walks the positions below its longest
// row's limit in chunks of C positions (C = T * max(1, 64 / T): several
// pool blocks per step, to spread each barrier and load latency over
// more work).  For each chunk it reads the chunk's block-table entries
// itself and stages the (C, D) K or V tile in shared memory.  Positions
// past the tile's longest limit are never read, and a row never reads a
// score or a V row past its own limit, so whatever the NULL block, a
// stale tail or a later query's position holds (even NaN) cannot leak.
//
// Rows are independent: a row's bits depend only on its query, its limit
// and the pool, never on Q, R or the other rows of its tile.  Every
// per-row loop runs over exactly the positions below the row's limit, in
// the same chunks (aligned at multiples of C) and the same lane order as
// for any other tile, and a chunk wholly past a row's limit leaves its
// statistics untouched.  So B2 at Q = 1 is B1, and every row of a verify
// window equals B1 called with lengths = that row's limit, bit for bit.
//
// Two passes, with the reference's rounding sites (kernel.py _scores and
// _accumulate, as XLA compiles them), so the kernel tracks the dense
// gather path to reduction-order noise:
//   pass 0: s = round_dt(f32 dot(q, k)) * scale_dt, the product kept in
//           f32 (XLA's excess precision drops the source's round of it);
//           running max m and rescaled sum l (online softmax, f32);
//   pass 1: p = round_dt(exp(s - m) / max(l, 1e-30)); acc += p * v (f32);
//   out = round_dt(acc).
// expf (not __expf) keeps the kernel and the plain version within
// reduction-order noise of each other.
//
// Narrow pools (int8 or fp8 e4m3 words, the quantized branch of the
// Pallas kernels: _dequant, the ks/vs operands of _scores and the
// quantized=True bodies) differ only in staging: each 16-byte load
// brings 16 one-byte words, each is widened exactly to f32, multiplied
// in f32 by its block's (row, kv head) scale and rounded once to dt —
// serving/kvquant.dequantize's expression — and the tile holds that
// value as f32.  The chunk's scales are read once per pool block, beside
// its table entries.  Everything after staging is the wide kernel, so a
// narrow pool gives exactly what its dequantized bf16 pool gives.
//
// Tiles are staged with 16-byte loads, all of a thread's loads issued
// before any is used.  Work split inside the block: one thread per
// (row, position) for the dot products (4 partial sums for ILP, tile rows
// padded to D + 1 floats so the column reads are bank-conflict free), one
// warp per row for the softmax statistics, and a register accumulator
// per thread over at most kMaxPairs (row, dim) pairs for PV.
//
// Bound: the HBM bytes of the K/V positions attended.  At qwen3-8b width
// that is 36 layers x 2 (K, V) x 8 kv heads x 128 x 2 B = 147 KB per
// cached token per decode tick (74 KB from a 1-byte pool, plus 64 B of
// scales per 16-token block and layer), read against 3.35 TB/s.  This
// body keeps f32 arithmetic for its f32 callers and does not chase the
// bound: K is read twice (once per pass), each row tile of a prefill
// chunk reads the slot's prefix again, a decode step has only B * KV
// blocks in flight, tiles are staged synchronously and the dot products
// run on CUDA cores.  The split body (paged_attention_split.cu) removes
// those gaps for bf16 queries: positions split across blocks, cp.async
// double buffering, mma.sync, 64-row tiles.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Register accumulator slots per thread: R * D <= kThreads * kMaxPairs.
constexpr int kMaxPairs = 8;
// 16-byte loads a thread keeps in flight while staging a tile.
constexpr int kLoads = 8;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round a float32 value to the compute dtype and widen it back: the
// reference's ``.astype(dt).astype(f32)`` (round to nearest even).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
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

// One 1-byte pool word, widened exactly to f32.
template <typename KVT> __device__ __forceinline__ float narrow_to_f32(
    unsigned byte);
template <> __device__ __forceinline__ float narrow_to_f32<int8_t>(
    unsigned byte) {
  return static_cast<float>(static_cast<int8_t>(byte));
}
template <> __device__ __forceinline__ float narrow_to_f32<__nv_fp8_e4m3>(
    unsigned byte) {
  __nv_fp8_e4m3 w;
  w.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(w);
}

// Widen one 16-byte load to floats: 8 bf16 (a bf16 is the top half of
// the float with the same bits) or 4 f32; or dequantize 16 one-byte
// words (little-endian: word w[k]'s byte j is element 4k + j) with the
// block's scale s: f32 product, one round to the compute dtype QT.
template <typename QT, typename KVT>
__device__ __forceinline__ void unpack(const uint4& r, float s, float* dst) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (std::is_same_v<KVT, float>) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = __uint_as_float(w[k]);
  } else if constexpr (std::is_same_v<KVT, __nv_bfloat16>) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dst[2 * k] = __uint_as_float(w[k] << 16);
      dst[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[4 * k + j] = round_to<QT>(
            narrow_to_f32<KVT>((w[k] >> (8 * j)) & 0xffu) * s);
    }
  }
}

// Stage the chunk's nvalid rows of one pool (K or V) for kv head h into
// tile (row stride D + 1); rows_s holds the chunk's physical pool rows
// and, for a narrow pool, scale_s their scales for head h.  Each thread
// first issues all its 16-byte loads (up to kLoads), then converts and
// stores them, so the loads' latencies overlap instead of adding up.
// The wrapper guarantees D * sizeof(KVT) % 16 == 0 and a 16-byte
// aligned pool.
template <typename QT, typename KVT>
__device__ __forceinline__ void stage_tile(
    float* tile, const KVT* __restrict__ pool, const int* rows_s,
    const float* scale_s, int nvalid, int h, int KV, int D, int T) {
  constexpr int kVec = 16 / sizeof(KVT);   // elements per 16-byte load
  const int per_row = D / kVec;
  const int n = nvalid * per_row;
  for (int base = 0; base < n; base += kThreads * kLoads) {
    uint4 regs[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int v = base + u * kThreads + threadIdx.x;
      if (v < n) {
        const int t = v / per_row;
        const int blk = t / T;
        const size_t tok =
            static_cast<size_t>(rows_s[blk]) * T + (t - blk * T);
        regs[u] = *reinterpret_cast<const uint4*>(
            pool + (tok * KV + h) * D + (v - t * per_row) * kVec);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int v = base + u * kThreads + threadIdx.x;
      if (v < n) {
        const int t = v / per_row;
        const float sc = sizeof(KVT) == 1 ? scale_s[t / T] : 1.f;
        unpack<QT, KVT>(regs[u], sc,
                        tile + t * (D + 1) + (v - t * per_row) * kVec);
      }
    }
  }
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) paged_rows_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, QT* __restrict__ out, int Q, int H,
    int KV, int D, int T, int nb, int C, int R, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / KV;
  const int r0 = blockIdx.z * R;           // first row of this tile
  const int nr = min(R, G * Q - r0);       // rows in this tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Dp = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;            // (R, D) query rows, f32
  float* kv_s = q_s + R * D;    // (C, D + 1) staged K or V tile, f32
  float* s_s = kv_s + C * Dp;   // (R, C) scores, then probabilities
  float* m_s = s_s + R * C;     // (R,) running max
  float* l_s = m_s + R;         // (R,) running denominator
  int* lim_s = reinterpret_cast<int*>(l_s + R);  // (R,) row limits
  int* rows_s = lim_s + R;                       // (C / T,) pool rows
  // (C / T,) each: the rows' K and V scales for head h (narrow pools).
  float* ks_s = reinterpret_cast<float*>(rows_s + C / T);
  float* vs_s = ks_s + C / T;

  // Row j of the tile is g-major row r0 + j of kv head h: query head
  // h * G + r / Q at query position r % Q.  Its causal limit is
  // lengths[b] - (Q - 1 - r % Q), never past the table.
  const int length = lengths[b];
  const int cap = nb * T;
  auto row_limit = [&](int j) {
    const int qi = (r0 + j) % Q;
    return min(length - (Q - 1 - qi), cap);
  };
  auto row_offset = [&](int j) {
    const int r = r0 + j;
    const int g = r / Q;
    const int qi = r - g * Q;
    return ((static_cast<size_t>(b) * Q + qi) * H + h * G + g) *
           static_cast<size_t>(D);
  };
  // The tile walks the positions its longest row attends; up to its
  // shortest row's limit, every row attends every position.
  int span = 0, common = cap;
  for (int j = 0; j < nr; ++j) {
    const int lim = row_limit(j);
    span = max(span, lim);
    common = min(common, lim);
  }
  const int n_chunks = span > 0 ? (span + C - 1) / C : 0;

  for (int i = tid; i < nr * D; i += kThreads) {
    const int j = i / D;
    q_s[i] = to_f32<QT>(q[row_offset(j) + (i - j * D)]);
  }
  if (tid < nr) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    lim_s[tid] = row_limit(tid);
  }

  // This thread's (row, dim) accumulator pairs i = tid + k * kThreads:
  // offsets of the row in s_s and of the dim in a tile row.
  float acc[kMaxPairs];
  int s_off[kMaxPairs];
  int d_off[kMaxPairs];
  int p_row[kMaxPairs];
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int i = tid + k * kThreads;
    acc[k] = 0.f;
    p_row[k] = i < nr * D ? i / D : -1;
    s_off[k] = (i / D) * C;
    d_off[k] = i % D;
  }

  const int* tb = tables + static_cast<size_t>(b) * nb;
  for (int phase = 0; phase < 2; ++phase) {
    for (int c = 0; c < n_chunks; ++c) {
      const int c0 = c * C;                 // a multiple of T
      const int nvalid = min(C, span - c0);
      // Every row of the tile attends the whole chunk (always so for
      // B1): the per-row limit checks below are then skipped.
      const bool whole = common - c0 >= nvalid;
      if (tid < (nvalid + T - 1) / T) {
        const int row = tb[c0 / T + tid];
        rows_s[tid] = row;
        if (sizeof(KVT) == 1) {
          const size_t si = static_cast<size_t>(row) * KV + h;
          ks_s[tid] = k_scale[si];
          vs_s[tid] = v_scale[si];
        }
      }
      __syncthreads();
      stage_tile<QT, KVT>(kv_s, k_pool, rows_s, ks_s, nvalid, h, KV, D, T);
      __syncthreads();

      // Scores: one thread per (row j, position t) inside the row's
      // limit; positions past it are never read.
      for (int i = tid; i < nr * nvalid; i += kThreads) {
        const int j = i / nvalid;
        const int t = i - j * nvalid;
        if (!whole && t >= lim_s[j] - c0) continue;
        const float* qr = q_s + j * D;
        const float* kr = kv_s + t * Dp;
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
        int d = 0;
        for (; d + 4 <= D; d += 4) {
          p0 = fmaf(qr[d], kr[d], p0);
          p1 = fmaf(qr[d + 1], kr[d + 1], p1);
          p2 = fmaf(qr[d + 2], kr[d + 2], p2);
          p3 = fmaf(qr[d + 3], kr[d + 3], p3);
        }
        for (; d < D; ++d) p0 = fmaf(qr[d], kr[d], p0);
        s_s[j * C + t] = round_to<QT>((p0 + p1) + (p2 + p3)) * scale;
      }
      __syncthreads();

      if (phase == 0) {
        // Online softmax statistics, one warp per row, over the row's
        // valid positions only (a chunk past its limit leaves m and l
        // untouched).  The next chunk's first __syncthreads orders these
        // reads of s_s before its score writes.
        for (int j = warp; j < nr; j += kWarps) {
          const int nv = min(nvalid, lim_s[j] - c0);
          if (nv <= 0) continue;
          const float* sr = s_s + j * C;
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
        // Probabilities, rounded to dt before the PV product.
        for (int i = tid; i < nr * nvalid; i += kThreads) {
          const int j = i / nvalid;
          const int t = i - j * nvalid;
          if (!whole && t >= lim_s[j] - c0) continue;
          const float p =
              expf(s_s[j * C + t] - m_s[j]) / fmaxf(l_s[j], 1e-30f);
          s_s[j * C + t] = round_to<QT>(p);
        }
        // K is no longer needed: stage the chunk's V rows in its place.
        stage_tile<QT, KVT>(kv_s, v_pool, rows_s, vs_s, nvalid, h, KV, D,
                            T);
        __syncthreads();
        if (whole) {
          for (int t = 0; t < nvalid; ++t) {
#pragma unroll
            for (int k = 0; k < kMaxPairs; ++k) {
              if (p_row[k] >= 0)
                acc[k] = fmaf(s_s[s_off[k] + t], kv_s[t * Dp + d_off[k]],
                              acc[k]);
            }
          }
        } else {
          // A row stops at its own limit: V past it may be anything.
          int nv[kMaxPairs];
#pragma unroll
          for (int k = 0; k < kMaxPairs; ++k)
            nv[k] = p_row[k] >= 0 ? min(nvalid, lim_s[p_row[k]] - c0) : 0;
          for (int t = 0; t < nvalid; ++t) {
#pragma unroll
            for (int k = 0; k < kMaxPairs; ++k) {
              if (t < nv[k])
                acc[k] = fmaf(s_s[s_off[k] + t], kv_s[t * Dp + d_off[k]],
                              acc[k]);
            }
          }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    if (p_row[k] >= 0)
      out[row_offset(p_row[k]) + d_off[k]] = from_f32<QT>(acc[k]);
  }
}

// Positions staged per chunk: whole pool blocks, about 64 positions.
inline int chunk_positions(int T) {
  const int blocks = 64 / T;
  return T * (blocks > 1 ? blocks : 1);
}

template <typename QT, typename KVT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* lengths, void* out, int B, int Q, int H, int KV, int D,
           int T, int nb, float scale, cudaStream_t stream) {
  if (B == 0 || KV == 0 || Q == 0) return 0;
  const int G = H / KV;
  // Rows per tile: as many as the register accumulator holds.
  const int R = min(G * Q, kThreads * kMaxPairs / D);
  if (R < 1 || (D * sizeof(KVT)) % 16 != 0 ||
      reinterpret_cast<size_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<size_t>(v_pool) % 16 != 0 ||
      (sizeof(KVT) == 1) != (k_scale != nullptr && v_scale != nullptr))
    return cudaErrorInvalidValue;
  const int C = chunk_positions(T);
  const size_t smem = sizeof(float) * (R * D + C * (D + 1) + R * C + 2 * R) +
                      sizeof(int) * (R + C / T) + sizeof(float) * 2 * (C / T);
  cudaError_t err = cudaFuncSetAttribute(
      paged_rows_kernel<QT, KVT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, KV, (G * Q + R - 1) / R);
  paged_rows_kernel<QT, KVT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, tables, lengths,
      static_cast<QT*>(out), Q, H, KV, D, T, nb, C, R, scale);
  return static_cast<int>(cudaGetLastError());
}

// Pool kinds (the wrapper's ``kv_kind``).
enum PoolKind { kF32 = 0, kBF16 = 1, kInt8 = 2, kE4M3 = 3 };

template <typename QT>
int dispatch_pool(const void* q, const void* k_pool, const void* v_pool,
                  const float* ks, const float* vs, const int* tb,
                  const int* ln, void* out, int B, int Q, int H, int KV,
                  int D, int T, int nb, int kv_kind, float scale,
                  cudaStream_t s) {
  switch (kv_kind) {
    case kF32:
      return launch<QT, float>(q, k_pool, v_pool, ks, vs, tb, ln, out, B, Q,
                               H, KV, D, T, nb, scale, s);
    case kBF16:
      return launch<QT, __nv_bfloat16>(q, k_pool, v_pool, ks, vs, tb, ln,
                                       out, B, Q, H, KV, D, T, nb, scale, s);
    case kInt8:
      return launch<QT, int8_t>(q, k_pool, v_pool, ks, vs, tb, ln, out, B,
                                Q, H, KV, D, T, nb, scale, s);
    case kE4M3:
      return launch<QT, __nv_fp8_e4m3>(q, k_pool, v_pool, ks, vs, tb, ln,
                                       out, B, Q, H, KV, D, T, nb, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* lengths, void* out, int B, int Q, int H, int KV,
             int D, int T, int nb, int q_bf16, int kv_kind, float scale,
             void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return dispatch_pool<__nv_bfloat16>(q, k_pool, v_pool, ks, vs, tb, ln,
                                        out, B, Q, H, KV, D, T, nb, kv_kind,
                                        scale, s);
  return dispatch_pool<float>(q, k_pool, v_pool, ks, vs, tb, ln, out, B, Q,
                              H, KV, D, T, nb, kv_kind, scale, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  ``q_bf16`` selects bf16 (1)
// or f32 (0) for the query and output; ``kv_kind`` the pool's words
// (PoolKind: 0 f32, 1 bf16, 2 int8, 3 fp8 e4m3).  ``k_scale``/``v_scale``
// are the (R, KV) f32 scales of a narrow pool and null for a wide one.
// Each returns cudaGetLastError() after the launch: 0 on success.

// B1: q and out (B, H, D), one query per slot, limit lengths[b].
extern "C" int paged_attention_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, int B, int H, int KV, int D, int T,
    int nb, int q_bf16, int kv_kind, float scale, void* stream) {
  return dispatch(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out,
                  B, 1, H, KV, D, T, nb, q_bf16, kv_kind, scale, stream);
}

// B2: q and out (B, Q, H, D), Q queries per slot whose K/V are the last
// Q of lengths[b] positions; query qi's limit is lengths[b] - (Q-1-qi).
extern "C" int paged_attention_prefill(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, int B, int Q, int H, int KV, int D,
    int T, int nb, int q_bf16, int kv_kind, float scale, void* stream) {
  return dispatch(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out,
                  B, Q, H, KV, D, T, nb, q_bf16, kv_kind, scale, stream);
}
