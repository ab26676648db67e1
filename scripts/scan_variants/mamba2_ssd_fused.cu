// A design variant of B5's chunk body (src/repro_torch/kernels/mamba2_ssd/
// csrc/mamba2_ssd_chunk.cu) for scripts/scan_body_ab.py: the scan over the
// chunks fused into the output pass.  Not a translation unit of its own:
// the A/B script appends it to the shipped source, so it uses that
// source's helpers and its launch 1, and builds the pair into one library
// whose entry point mamba2_ssd_fused_forward takes mamba2_ssd_chunk_forward's
// arguments.
//
// Launch 1 is the shipped one: each chunk's own state st, its cums and its
// decay tot.  Launch 2 does the shipped launches 2 and 3 at once: one block
// a (b, h, 64-row tile) walks the chunks in order, holding the head's state
// in shared memory.  At each chunk it computes the tile's y from the state
// entering the chunk (the shipped launch 3's arithmetic for one head, so
// C B^T is computed for each head rather than once for kOutHeads) and then
// carries the state across the chunk, S = tot S + st with an f32 multiply
// then an add, as the shipped launch 2 does: the same bits.  So a chunk's
// state is written once and read by the head's four row tiles (neighbours,
// so mostly from L2), where the shipped body writes, reads, writes and
// reads it (168 MB each at mamba2-2.7b's training shape); a head's chunks
// run in series: B H Q / 64 blocks, 1,280 at that shape.

namespace {

// Shared memory, in floats: C's tile rows (kRows, N + 4); C B^T (kRows,
// Q + 4); B's rows of one tile (kRows, N + 4); the state (P, N + 4); x's
// rows of one tile (kRows, P + 8); M's tile (kRows, kRows + 4); cum and dt
// of the rows up to the tile's end (Q each).
struct FusedLayout {
  int ldc, ldcb, ldx, ldm, lds;
  int c, cb, bt, s, x, m, cum, dt, total;
  __host__ __device__ FusedLayout(int P, int N, int Q) {
    ldc = N + 4;
    ldcb = Q + 4;
    ldx = P + 8;
    ldm = kRows + 4;
    lds = N + 4;
    c = 0;
    cb = c + kRows * ldc;
    bt = cb + kRows * ldcb;
    s = bt + kRows * ldc;
    x = s + P * lds;
    m = x + kRows * ldx;
    cum = m + kRows * ldm;
    dt = cum + Q;
    total = dt + Q;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_fused_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const float* __restrict__ st,
                     const float* __restrict__ cum,
                     const float* __restrict__ tot,
                     const float* __restrict__ s0, float* __restrict__ sf,
                     T* __restrict__ y, int S, int H, int P, int N, int Q,
                     XStrides sx, RowStrides sd, RowStrides sb,
                     RowStrides sc, int vec) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 operands
  const FusedLayout lay(P, N, Q);
  const int ldc = lay.ldc, ldcb = lay.ldcb, ldx = lay.ldx, ldm = lay.ldm,
            lds = lay.lds;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem + lay.c;       // (kRows, ldc): C's rows of the tile
  float* CB = smem + lay.cb;      // (kRows, ldcb): C B^T up to the tile
  float* Bt = smem + lay.bt;      // (kRows, ldc): B's rows of one tile
  float* Ss = smem + lay.s;       // (P, lds): the state
  float* Xs = smem + lay.x;       // (kRows, ldx): x's rows of one tile
  float* Ms = smem + lay.m;       // (kRows, ldm): M's tile
  float* CUM = smem + lay.cum;    // (Q): cum of rows 0 .. the tile's end
  float* DT = smem + lay.dt;      // (Q): dt of the same rows

  const int nc = S / Q;
  const int row_tiles = Q / kRows;
  const int rt = blockIdx.x % row_tiles;   // a head's row tiles are
  const int bh = blockIdx.x / row_tiles;   // neighbours: they share its
  const int b = bh / H;                    // chunks' states in L2
  const int h = bh - b * H;
  const int i0 = rt * kRows;
  const int K = i0 + kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    Ss[p * lds + e - p * N] =
        s0 != nullptr ? s0[static_cast<size_t>(bh) * P * N + e] : 0.f;
  }
  // The state entering chunk c + 1 from the one entering chunk c.  A
  // thread carries the same elements every time (and writes them to sf).
  auto carry = [&](int c) {
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    const float d = tot[bch];
    const float* own = st + bch * P * N;
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N;
      float* s = Ss + p * lds + e - p * N;
      *s = __fadd_rn(__fmul_rn(*s, d), own[e]);
    }
  };
  Prefetch<T, kRows * kMaxP * sizeof(T) / 16 / kThreads> xn;
  auto fetch_x = [&](int c, int jt) {
    xn.load(x + b * sx.b + (static_cast<long long>(c) * Q + jt * kRows) *
                               sx.s + h * sx.h,
            sx.s, kRows, P, vec);
  };
  fetch_x(0, 0);

  const int tiles_p = P / 16;
  const int wr = warp / tiles_p;
  const int wc = warp - wr * tiles_p;
  const bool active = wr < kRows / 16;
  const size_t y_s = static_cast<size_t>(H) * P;
  for (int c = 0; c < nc; ++c) {
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    const long long t0 = static_cast<long long>(c) * Q;
    __syncthreads();   // the previous chunk's reads are done
    if (c > 0) carry(c - 1);
    if (tid < K) {
      CUM[tid] = cum[bch * Q + tid];
      DT[tid] = to_f32<T>(dt[b * sd.b + (t0 + tid) * sd.s + h]);
    }
    stage<T>(Cs, ldc, Cm + b * sc.b + (t0 + i0) * sc.s, sc.s, kRows, N);
    {  // C B^T, as the shipped launch 3 computes it
      const int tr = warp / 4;
      const int tc = warp % 4;
      for (int jt = 0; jt <= rt; ++jt) {
        __syncthreads();
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
    __syncthreads();   // C B^T, the carried state, cum and dt written

    float yo[1][2][4];
    zero(yo);
    if (active) {
      warp_mma<1, 2, !kExact, true>(yo, Cs + 16 * wr * ldc, ldc, 1,
                                    Ss + 16 * wc * lds, 1, lds, N);
      const int r = i0 + 16 * wr + g;
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
    float acc[1][2][4];
    zero(acc);
    for (int jt = 0; jt <= rt; ++jt) {
      __syncthreads();
      const int j0 = jt * kRows;
      xn.store(Xs, ldx, kRows, P);
      {
        const int j = tid % kRows;
        const int gj = j0 + j;
        const float cj = CUM[gj];
        const float dj = DT[gj];
#pragma unroll
        for (int q = 0; q < kRows * kRows / kThreads; ++q) {
          const int i = tid / kRows + q * (kThreads / kRows);
          const int gi = i0 + i;
          const float m = CB[i * ldcb + gj] *
                          __expf(gj <= gi ? CUM[gi] - cj : 0.f) * dj;
          Ms[i * ldm + j] = gj <= gi ? m : 0.f;
        }
      }
      __syncthreads();
      if (jt < rt)
        fetch_x(c, jt + 1);
      else if (c + 1 < nc)
        fetch_x(c + 1, 0);
      if (active)
        warp_mma<1, 2, true, !kExact>(acc, Ms + 16 * wr * ldm, ldm, 1,
                                      Xs + 16 * wc, ldx, 1, kRows);
    }
    if (active) {
      T* yb = y + (static_cast<size_t>(b) * S + t0 + i0) * y_s +
              static_cast<size_t>(h) * P;
      const int r = 16 * wr + g;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = 16 * wc + 8 * j + 2 * t;
        store2(yb + r * y_s + p, acc[0][j][0] + yo[0][j][0],
               acc[0][j][1] + yo[0][j][1]);
        store2(yb + (r + 8) * y_s + p, acc[0][j][2] + yo[0][j][2],
               acc[0][j][3] + yo[0][j][3]);
      }
    }
  }
  if (rt == 0) {   // one of the head's tiles writes the final state
    __syncthreads();
    carry(nc - 1);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N;
      sf[static_cast<size_t>(bh) * P * N + e] = Ss[p * lds + e - p * N];
    }
  }
}

template <typename T>
int launch_fused(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* s0, void* y,
                 void* sf, void* st, void* cum, void* tot, int B, int S,
                 int H, int P, int N, int Q, XStrides sx, RowStrides sd,
                 RowStrides sb, RowStrides sc, cudaStream_t stream) {
  const int nc = S / Q;
  constexpr int V = 16 / sizeof(T);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  sx.b % V == 0 && sx.s % V == 0 && sx.h % V == 0;
  const size_t smem1 = sizeof(float) * state_smem(P, N, Q);
  const size_t smem2 = sizeof(float) * FusedLayout(P, N, Q).total;
  if (static_cast<long long>(smem1) > kSmemLimit ||
      static_cast<long long>(smem2) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_fused_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
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

  ssd_fused_kernel<T><<<static_cast<unsigned>(static_cast<long long>(B) * H *
                                              (Q / kRows)),
                         kThreads, smem2, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(st), static_cast<const float*>(cum),
      static_cast<const float*>(tot), static_cast<const float*>(s0),
      static_cast<float*>(sf), static_cast<T*>(y), S, H, P, N, Q, sx, sd,
      sb, sc, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mamba2_ssd_chunk_forward's arguments and checks.
extern "C" int mamba2_ssd_fused_forward(
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
  return bf16 ? launch_fused<__nv_bfloat16>(x, dt, A, Bs, Cs, s0, y, sf, st,
                                            cum, tot, B, S, H, P, N, Q, sx,
                                            sd, sb, sc, s)
              : launch_fused<float>(x, dt, A, Bs, Cs, s0, y, sf, st, cum,
                                    tot, B, S, H, P, N, Q, sx, sd, sb, sc,
                                    s);
}
