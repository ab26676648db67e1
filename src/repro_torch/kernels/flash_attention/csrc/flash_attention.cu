// Flash attention for Hopper (sm_90a), f32 body: blocked causal or
// non-causal softmax attention with an online softmax, GQA by index, and
// the causal mask shifted by S_kv - S, on the CUDA cores.
//
// Replaces, with flash_attention_mma.cu's bf16 tensor-core body, the
// Pallas TPU kernel
//   B3 src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
//      (body _attn_kernel)
// for f32 operands (ops.body() routes by dtype; TF32 tensor cores would
// break f32's 1e-5 tolerance), and computes what it computes, not block
// by block:
//
//   q   (B, S, H, D)       f32
//   k/v (B, S_kv, Hkv, D)  f32, H % Hkv == 0, S_kv >= S under causal
//   (non-causal: any S_kv >= 1; every row attends all S_kv keys)
//   out (B, S, H, D)       f32
//
// Query head h of batch b reads kv head h / (H / Hkv): the TPU kernel's
// kv_stream index map, with no K/V repeat.  Scores are
// dot(q_f32, k_f32) * scale with an f32 scale (1 / sqrt(D), passed in);
// with causal, query row r attends kv positions <= r + (S_kv - S), and
// masked scores are -1e30, never -inf.  The running max m, sum l and
// accumulator acc are f32; at the end out = acc / max(l, 1e-30).  expf
// (not __expf) keeps the kernel within reduction-order noise of its
// plain version.
//
// One thread block per (query tile of kBQ rows, batch x query head).  A
// loop inside the block over key tiles of kBK positions replaces the
// TPU's sequential third grid dimension; under a causal mask it stops at
// the block's last row's limit, where the TPU kernel skips the blocks
// above the diagonal.  Blocks run heavy tiles first (blockIdx.x counts
// query tiles from the end), so the causal triangle's long tiles are not
// left for last.  The q tile is staged once in shared memory; for
// each key tile the block stages K (16-byte loads, all of a thread's
// loads issued before any is used), computes its scores, runs the online
// softmax in registers, writes P to shared memory, then stages V in K's
// buffer and accumulates P @ V in registers.  Rows past S and K/V rows
// past S_kv are zero-filled, and their scores masked, so ragged edges
// need no padding of the inputs.
//
// Head widths: any dh from 1 to 256.  The kernel is compiled for the
// widths D in {32, 64, 128, 192, 256} and takes the smallest D >= dh;
// columns dh .. D - 1 of every staged tile are zero, so they add nothing
// to a score, and the output columns past dh are not written.  Rows
// whose bytes are a multiple of 16 (with 16-byte aligned operands) are
// staged with 16-byte loads; any other row (dh not a multiple of 4)
// with one scalar load per element.
//
// Work split: 128 threads as 16 x 8; thread (ty, tx) owns query rows
// 4 ty .. 4 ty + 3, score columns tx + 8 c (c < 8) and output columns
// 4 tx + 32 g .. + 3 (g < D / 32).  Tile rows are padded to D + 4 floats
// so the float4 reads of eight lanes with consecutive tx fall on
// distinct banks.  A row's max and sum are reduced across the eight tx
// lanes that share it with shuffles.  Launch bounds ask for three blocks
// per SM at D = 64 (168 registers, no spills; four blocks cap a thread at
// 128 registers, which spills and ran 4% slower) and two at every other
// width, which with 128 threads leaves a thread all 255 registers.  At
// D = 128 two blocks fit in shared memory (84 KB each); at D = 192 and
// 256 one (118 KB and 151 KB of the SM's 227 KB), and a thread holds
// 4 x D / 8 accumulators: the build log prints every instance's ptxas
// register and spill lines.

// Bound: the operations.  At smollm-360m's heads (B=8, S=4096, H=15,
// Hkv=5, D=64, causal) the attention is 2.6e11 FLOP against 67 TFLOP/s
// of f32 outside the tensor cores (3.9 ms), while q, k, v and out in f32
// are 336 MB against 3.35 TB/s (0.10 ms).  The main path trains in bf16
// and runs the tensor-core body; this one serves f32 callers.  Known
// gaps, for later work: no pipeline overlapping the next tile's loads
// with this tile's math (3xTF32 tensor-core math would keep f32
// accuracy), diagonal tiles computed in full and masked, and no
// backward kernel.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key positions per tile
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 8;   // score columns per thread
constexpr int kLoads = 8;        // 16-byte loads a thread keeps in flight
constexpr float kNegInf = -1e30f;


__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Max and sum over the eight lanes (consecutive tx) that share a row.
__device__ __forceinline__ float row_max(float x) {
  for (int o = 1; o < 8; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage kBQ (= kBK) rows of dh elements into dst (row stride D + 4
// floats); source row t is at src + t * stride.  Rows at or past n_rows
// and columns at or past dh are zero-filled.  With ``vec`` (dh a
// multiple of 4, operands 16-byte aligned) each thread issues up to
// kLoads 16-byte loads before it stores any, so their latencies overlap;
// otherwise it loads one element at a time.
template <int D>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      size_t stride, int n_rows, int dh,
                                      bool vec) {
  constexpr int LD = D + 4;
  if (!vec) {
#pragma unroll 8
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int t = i / D;
      const int c = i - t * D;
      dst[t * LD + c] = t < n_rows && c < dh ? src[t * stride + c] : 0.f;
    }
    return;
  }
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  constexpr int kN = kBK * kPerRow;
#pragma unroll
  for (int base = 0; base < kN; base += kThreads * kLoads) {
    uint4 regs[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      const int t = i / kPerRow;
      const int c = (i - t * kPerRow) * kVec;
      regs[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kN && t < n_rows && c < dh)
        regs[u] = *reinterpret_cast<const uint4*>(src + t * stride + c);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      const int t = i / kPerRow;
      if (i < kN)
        *reinterpret_cast<uint4*>(dst + t * LD + (i - t * kPerRow) * kVec) =
            regs[u];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 2)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int S, int Skv, int H, int Hkv, int dh, int vec,
                     float scale, int causal) {
  constexpr int LD = D + 4;      // row stride of the q and K/V tiles
  constexpr int PLD = kBK + 4;   // row stride of P
  constexpr int DG = D / 32;     // float4 output groups per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // (kBQ, LD) queries, f32
  float* kv_s = q_s + kBQ * LD;   // (kBK, LD) K, then V, of one tile
  float* p_s = kv_s + kBK * LD;   // (kBQ, PLD) probabilities

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const int offset = Skv - S;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const size_t q_stride = static_cast<size_t>(H) * dh;
  const size_t kv_stride = static_cast<size_t>(Hkv) * dh;
  const float* kb = k + static_cast<size_t>(b) * Skv * kv_stride +
                    static_cast<size_t>(hk) * dh;
  const float* vb = v + static_cast<size_t>(b) * Skv * kv_stride +
                    static_cast<size_t>(hk) * dh;

  stage<D>(q_s,
               q + (static_cast<size_t>(b) * S + q0) * q_stride +
                   static_cast<size_t>(h) * dh,
               q_stride, min(kBQ, S - q0), dh, vec);

  float m[kRows], l[kRows], acc[kRows][4 * DG];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * DG; ++e) acc[r][e] = 0.f;
  }

  // Key positions this block attends: all of them, or up to its last
  // real row's causal limit.
  const int last_row = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? min(Skv, last_row + offset + 1) : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    const int n_valid = min(kBK, Skv - k0);
    __syncthreads();   // the previous tile's P @ V is done with kv_s, p_s
    stage<D>(kv_s, kb + k0 * kv_stride, kv_stride, n_valid, dh, vec);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qv[r] = *reinterpret_cast<const float4*>(q_s + (4 * ty + r) * LD + d);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kv_s + (tx + 8 * c) * LD + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r][c] = fmaf(qv[r].x, kv.x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv.y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv.z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv.w, s[r][c]);
        }
      }
    }

    // Scale and mask; a tile every row of the block sees whole skips the
    // per-element checks.
    const bool whole = n_valid == kBK &&
                       (!causal || k0 + kBK - 1 <= q0 + offset);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + 4 * ty + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = k0 + tx + 8 * c;
        float x = s[r][c] * scale;
        if (!whole && (col >= Skv || (causal && col > row + offset)))
          x = kNegInf;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[r][c] - m_new);
        p_s[(4 * ty + r) * PLD + tx + 8 * c] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * DG; ++e) acc[r][e] *= alpha;
    }
    __syncthreads();   // every thread is done with K; P is written
    stage<D>(kv_s, vb + k0 * kv_stride, kv_stride, n_valid, dh, vec);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pr[r] = *reinterpret_cast<const float4*>(p_s + (4 * ty + r) * PLD + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              kv_s + (j + u) * LD + 4 * tx + 32 * g);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float p = lane_of(pr[r], u);
            acc[r][4 * g] = fmaf(p, vv.x, acc[r][4 * g]);
            acc[r][4 * g + 1] = fmaf(p, vv.y, acc[r][4 * g + 1]);
            acc[r][4 * g + 2] = fmaf(p, vv.z, acc[r][4 * g + 2]);
            acc[r][4 * g + 3] = fmaf(p, vv.w, acc[r][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* o = out + (static_cast<size_t>(b) * S + row) * q_stride +
               static_cast<size_t>(h) * dh;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * tx + 32 * g + e < dh)
          o[4 * tx + 32 * g + e] = acc[r][4 * g + e] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Skv, int H, int Hkv, int dh, int vec, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * (D + 4) + kBK * (D + 4) + kBQ * (kBK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Skv, H, Hkv,
      dh, vec, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_width(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int Skv, int H, int Hkv, int dh, int causal,
                 float scale, cudaStream_t s) {
  const int vec = dh % 4 == 0 &&
                  reinterpret_cast<size_t>(q) % 16 == 0 &&
                  reinterpret_cast<size_t>(k) % 16 == 0 &&
                  reinterpret_cast<size_t>(v) % 16 == 0;
#define FLASH_WIDTH(W)                                                  \
  if (dh <= W)                                                          \
    return launch<W>(q, k, v, out, B, S, Skv, H, Hkv, dh, vec, causal, \
                     scale, s);
  FLASH_WIDTH(32)
  FLASH_WIDTH(64)
  FLASH_WIDTH(128)
  FLASH_WIDTH(192)
  FLASH_WIDTH(256)
#undef FLASH_WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (loaded with ctypes): f32 q, k, v and out,
// 1 <= dh <= 256, Skv >= S under causal (any Skv >= 1 without).
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* out, int B,
                                       int S, int Skv, int H, int Hkv, int dh,
                                       int causal, float scale,
                                       void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  // A causal row r attends keys <= r + Skv - S, so Skv >= S; a non-causal
  // row attends all Skv keys, whatever S is.
  if (Hkv <= 0 || H % Hkv != 0 || Skv < (causal ? S : 1) || dh < 1 ||
      dh > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_width(q, k, v, out, B, S, Skv, H, Hkv, dh, causal, scale,
                      static_cast<cudaStream_t>(stream));
}
