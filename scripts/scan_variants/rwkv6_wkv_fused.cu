// A design variant of B4's chunk body (src/repro_torch/kernels/rwkv6_wkv/
// csrc/rwkv6_wkv_chunk.cu) for scripts/scan_body_ab.py: the scan over the
// chunks fused into the output pass.  Not a translation unit of its own:
// the A/B script appends it to the shipped source, so it uses that
// source's helpers and its launch 1, and builds the pair into one library
// whose entry point rwkv6_wkv_fused_forward takes rwkv6_wkv_chunk_forward's
// arguments.
//
// Launch 1 is the shipped one: each chunk's own state st and its decays
// tot.  Launch 2 does the shipped launches 2 and 3 at once: one block a
// (b, h, slice of the value columns) walks the chunks in order, holding
// the state's columns of its slice in shared memory.  At each chunk it
// computes y's columns of the slice from the state entering the chunk (the
// shipped launch 3's arithmetic, A over all of the chunk's rows recomputed
// by each slice) and then carries the state across the chunk, S = S tot +
// st with an f32 multiply then an add, as the shipped launch 2 does: the
// same bits.  So the scratch states are written once and read once, where
// the shipped body writes, reads, writes and reads them (84 MB each at
// rwkv6-3b's training shape), but a head's chunks run in series: B H
// kFusedSlices blocks, 640 at that shape.

namespace {

// Blocks a head's value columns are split over (N / kFusedSlices a
// multiple of 16).
constexpr int kFusedSlices = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv_fused_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ lw,
                     const T* __restrict__ u, const float* __restrict__ st,
                     const float* __restrict__ tot,
                     const float* __restrict__ s0, float* __restrict__ sf,
                     T* __restrict__ y, int S, int H, int N, int Q,
                     Strides sr, Strides sk, Strides sv, Strides sl,
                     int vec) {
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
  float* Ss = smem + lay.s;      // (N, lds): the state, the slice's columns
  float* U = smem + lay.u;       // (N): u of this head
  float* DG = smem + lay.dg;     // (Q): sum_c r u k, A's diagonal

  const int nc = S / Q;
  const int bh = blockIdx.x / kFusedSlices;   // b H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int ns = N / kFusedSlices;
  const int n0 = (blockIdx.x - bh * kFusedSlices) * ns;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int e = tid; e < N * ns; e += kThreads) {
    const int m = e / ns;
    const int n = n0 + e - m * ns;
    Ss[m * lds + n] =
        s0 != nullptr ? s0[(static_cast<size_t>(bh) * N + m) * N + n] : 0.f;
  }
  if (tid < N) U[tid] = to_f32<T>(u[static_cast<size_t>(h) * N + tid]);
  // The state entering chunk c + 1 from the one entering chunk c.  A
  // thread carries the same elements every time (and writes them to sf).
  auto carry = [&](int c) {
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    for (int e = tid; e < N * ns; e += kThreads) {
      const int m = e / ns;
      const int n = n0 + e - m * ns;
      Ss[m * lds + n] = __fadd_rn(__fmul_rn(Ss[m * lds + n], tot[bch * N + m]),
                                  st[(bch * N + m) * N + n]);
    }
  };

  const int row_tiles = Q / 32;
  const int col_tiles = Q / 16;
  const int tiles_n = ns / 16;
  const size_t y_s = static_cast<size_t>(H) * N;
  for (int c = 0; c < nc; ++c) {
    const long long t0 = static_cast<long long>(c) * Q;
    Prefetch<T, kMaxQ * kMaxN * sizeof(T) / 16 / kThreads> pr, pk, pv, pl;
    pr.load(r + b * sr.b + t0 * sr.s + h * sr.h, sr.s, Q, N, vec);
    pk.load(k + b * sk.b + t0 * sk.s + h * sk.h, sk.s, Q, N, vec);
    pv.load(v + b * sv.b + t0 * sv.s + h * sv.h, sv.s, Q, N, vec);
    pl.load(lw + b * sl.b + t0 * sl.s + h * sl.h, sl.s, Q, N, vec);
    __syncthreads();   // the previous chunk's reads are done
    if (c > 0) carry(c - 1);
    pr.store(R, ldr, Q, N);
    pk.store(KJ, ldr, Q, N);
    pv.store(V, ldv, Q, N);
    pl.store(LW, N, Q, N);
    __syncthreads();
    column_cumsum(LW, N, CUM, ldr, Q, N);
    {  // the bonus diagonal from the raw r and k: two threads a row
      const int i = tid >> 1;
      const int c0 = (tid & 1) * (N / 2);
      float d = 0.f;
      if (i < Q)
        for (int cc = c0; cc < c0 + N / 2; ++cc)
          d = fmaf(R[i * ldr + cc] * U[cc], KJ[i * ldr + cc], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (i < Q && (tid & 1) == 0) DG[i] = d;
    }
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N;
      const int cc = e - i * N;
      const float cu = CUM[i * ldr + cc];
      R[i * ldr + cc] *= expf(cu - LW[i * N + cc]);
      KJ[i * ldr + cc] *= expf(-cu);
    }
    __syncthreads();
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
    T* yb = y + (static_cast<size_t>(b) * S + t0) * y_s +
            static_cast<size_t>(h) * N;
    for (int tile = warp; tile < row_tiles * tiles_n; tile += kWarps) {
      const int tr = tile / tiles_n;
      const int tc = n0 / 16 + tile - tr * tiles_n;
      float acc[2][2][4];
      zero(acc);
      warp_mma<2, 2, true, !kExact>(acc, Am + 32 * tr * lda, lda, 1,
                                    V + 16 * tc, ldv, 1, 32 * (tr + 1));
      warp_mma<2, 2, true, true>(acc, R + 32 * tr * ldr, ldr, 1,
                                 Ss + 16 * tc, lds, 1, N);
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
  __syncthreads();
  carry(nc - 1);
  for (int e = tid; e < N * ns; e += kThreads) {
    const int m = e / ns;
    const int n = n0 + e - m * ns;
    sf[(static_cast<size_t>(bh) * N + m) * N + n] = Ss[m * lds + n];
  }
}

template <typename T>
int launch_fused(const void* r, const void* k, const void* v,
                 const void* lw, const void* u, const void* s0, void* y,
                 void* sf, void* st, void* tot, int B, int S, int H, int N,
                 int Q, Strides sr, Strides sk, Strides sv, Strides sl,
                 cudaStream_t stream) {
  const int nc = S / Q;
  constexpr int V = 16 / sizeof(T);
  const void* ops[] = {r, k, v, lw};
  const Strides ss[] = {sr, sk, sv, sl};
  int vec = 1;
  for (int i = 0; i < 4; ++i)
    vec &= reinterpret_cast<uintptr_t>(ops[i]) % 16 == 0 &&
           ss[i].b % V == 0 && ss[i].s % V == 0 && ss[i].h % V == 0;
  const size_t smem1 = sizeof(float) * state_smem(N, Q);
  const size_t smem2 = sizeof(float) * OutLayout(N, Q).total;
  if (static_cast<long long>(smem1) > kSmemLimit ||
      static_cast<long long>(smem2) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wkv_fused_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);

  wkv_state_kernel<T><<<static_cast<unsigned>(static_cast<long long>(B) *
                                              nc * H),
                         kThreads, smem1, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), static_cast<float*>(st),
      static_cast<float*>(tot), S, H, N, Q, sk, sv, sl, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  wkv_fused_kernel<T><<<static_cast<unsigned>(B * H * kFusedSlices),
                         kThreads, smem2, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw),
      static_cast<const T*>(u), static_cast<const float*>(st),
      static_cast<const float*>(tot), static_cast<const float*>(s0),
      static_cast<float*>(sf), static_cast<T*>(y), S, H, N, Q, sr, sk, sv,
      sl, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rwkv6_wkv_chunk_forward's arguments and checks, and N a multiple of
// 16 kFusedSlices.
extern "C" int rwkv6_wkv_fused_forward(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* y, void* sf, void* st, void* tot,
    int B, int S, int H, int N, int Q, int bf16, long long r_b,
    long long r_s, long long r_h, long long k_b, long long k_s,
    long long k_h, long long v_b, long long v_s, long long v_h,
    long long l_b, long long l_s, long long l_h, void* stream) {
  if (N % (16 * kFusedSlices) != 0 || N < 16 || N > kMaxN || Q % 32 != 0 ||
      Q < 32 || Q > kMaxQ || S < Q || S % Q != 0 || B < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Strides sr{r_b, r_s, r_h}, sk{k_b, k_s, k_h}, sv{v_b, v_s, v_h},
      sl{l_b, l_s, l_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fused<__nv_bfloat16>(r, k, v, lw, u, s0, y, sf, st,
                                            tot, B, S, H, N, Q, sr, sk, sv,
                                            sl, s)
              : launch_fused<float>(r, k, v, lw, u, s0, y, sf, st, tot, B, S,
                                    H, N, Q, sr, sk, sv, sl, s);
}
