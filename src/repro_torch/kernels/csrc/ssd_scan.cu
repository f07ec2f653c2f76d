// Mamba-2 SSD chunk scan forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces: src/repro/kernels/ssd.py, the Pallas TPU kernel `_ssd_kernel`
// (line 31) launched by `ssd_scan_fwd` (line 73).  It computes the same
// function.  For each flattened (batch, head) row bh and each chunk of
// `chunk` sequence rows, with cs the cumulative sum of dA over the chunk:
//
//   y  = (C B^T o L) X + (C h) o exp(cs),   L[i,j] = exp(cs_i - cs_j), i >= j
//   h <- exp(cs_last) h + (B o exp(cs_last - cs))^T X
//
// where X = xdt (S, P), B and C are (S, N) and h is the (N, P) f32 state.
// Math is f32; y is written in xdt's dtype.
//
// Translation: the TPU kernel carries h in VMEM scratch across a sequential
// ("arbitrary") grid axis over chunks.  Blocks on the card run in no order,
// so one CTA owns one bh row and one slice of PT of its P columns (the state
// columns depend only on the same columns of X, so splitting P is exact) and
// loops over the chunks itself, the state staying in the CTA.  A ragged S
// and a chunk below 64 are masked: every chunk is staged as a 64-row tile
// whose rows past the chunk or past S are zero (dA 0), which is what the
// Pallas kernel's zero padding computes.
//
// Chunk: the kernel's tile is 64 rows; `chunk` may be 1..64 (the model
// passes min(64, S)).  The JAX plan path picks 512 at the serve shape (S 1024,
// P 64, N 128) for a 64 MiB VMEM budget; a 512 x 512 f32 intra-chunk
// matrix is 1 MB, and a block has at most 227 KB of shared memory.
// Shared memory of the bf16 instance at N = 128: C and B tiles
// 2 x 64 x 136 x 2 B each (double-buffered, +8 pad), X 2 x 64 x (PT + 8)
// x 2 B, decayed X 64 x (PT + 8) x 2 B, the bf16 copy of h 128 x (PT + 8)
// x 2 B, dA and cs 768 B: 96,000 B at PT = 32, so two CTAs fit an SM.
// PT = min(P, 32): at the mamba2 serving shape 32 was the fastest of 16,
// 32 and 64 on the H100 (PERF.md).  The f32 state itself lives in the mma
// accumulator registers of the four warps (32 floats a thread at N = 128,
// PT = 32).
//
// What bounds it on this card: at the mamba2-130m serving prefill shape
// (BH 192, S 1024, P 64, N 128, bf16 X/B/C, f32 dA) the chunk-64 algorithm
// is 8.9 GFLOP (the masked products' lower triangles only) against 151.8
// MB of compulsory traffic, ~59 FLOP per byte, far below the H100's ~295
// FLOP/byte ridge: it is bound by bytes.  So the
// design reads every input once from device memory (B and C of one bh are
// read by its P slices close together in time, through L2), keeps h, C B^T
// and every intermediate on chip, double-buffers the next chunk's tiles
// with cp.async so its load overlaps this chunk's math, and runs the four
// products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate).  Tiles of C B^T above the diagonal are neither computed nor
// multiplied.  C B^T o L enters its product with X as a bf16 high and low
// part (two mma), because rounding it to one bf16 was the largest of the
// design's rounding errors; the decayed X (before B^T) and h (before C)
// are rounded to bf16, each a relative 2^-9 of the terms it sums, so the
// bf16 instance holds a tolerance scaled to the output's magnitude, not
// the f32 one.  wgmma, TMA and reading a
// group's B/C once for all its heads are later work.
//
// The f32 instance runs every product as f32 FMAs on the CUDA cores (no
// TF32), so that it holds the 2e-3 tolerance of the JAX kernel tests; it is
// the path of the f32 tests, not of serving.
//
// Layout: xdt, B and C are read through their (bh, seq) strides with a unit
// inner stride; dA through its bh stride with a unit seq stride; y is
// contiguous (BH, S, P).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;        // rows of a chunk tile
constexpr int THREADS = 128;  // four warps

struct Params {
  const void* x;
  const float* da;
  const void* b;
  const void* c;
  void* y;
  int BH, S, P, N, chunk;
  long long x_sb, x_ss, d_sb, b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Inclusive prefix sum of the 64 values v[0..63] by one warp (two a lane);
// writes cs[0..63].
__device__ __forceinline__ void warp_cumsum64(const float* v, float* cs) {
  const int lane = threadIdx.x % 32;
  const float a = v[2 * lane], b = v[2 * lane + 1];
  float s = a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  const float excl = s - (a + b);
  cs[2 * lane] = excl + a;
  cs[2 * lane + 1] = excl + a + b;
}

// ------------------------------------------------------------- bf16 path

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes (rows past the chunk or S)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) as a bf16 pair hi and the bf16 pair lo of what hi leaves out
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// Stage rows [0, 64) of a tile of W columns whose row r is src + r * stride
// into shared memory with a row pitch of W + 8 elements (ldmatrix reads
// without bank conflicts).  Rows at or past `rows` are zero-filled.
template <int W>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int rows) {
  constexpr int CPR = W / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < CH * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < rows;
    cp_async16(dst + r * (W + 8) + c * 8, ok ? src + r * stride + c * 8 : src,
               ok);
  }
}

// One chunk's tiles (C, B, X, dA) into buffer `buf`, rows past `rows` zero.
template <int N, int PT>
__device__ __forceinline__ void load_chunk(
    const Params& p, __nv_bfloat16* Cs, __nv_bfloat16* Bs, __nv_bfloat16* Xs,
    float* Ds, const __nv_bfloat16* cg, const __nv_bfloat16* bg,
    const __nv_bfloat16* xg, const float* dg, int row0, int rows) {
  load_tile_bf16<N>(Cs, cg + row0 * p.c_ss, p.c_ss, rows);
  load_tile_bf16<N>(Bs, bg + row0 * p.b_ss, p.b_ss, rows);
  load_tile_bf16<PT>(Xs, xg + row0 * p.x_ss, p.x_ss, rows);
  if (threadIdx.x < CH) {
    const bool ok = threadIdx.x < rows;
    cp_async4(Ds + threadIdx.x, ok ? dg + row0 + threadIdx.x : dg, ok);
  }
  cp_async_commit();
}

// 128 threads.  Warp w owns chunk rows [16w, 16w + 16) for the output and
// the (m-tile, n-pair) units w, w + 4, ... of the (N, PT) state.
template <int N, int PT>
__global__ void __launch_bounds__(THREADS) ssd_fwd_bf16(const Params p) {
  constexpr int LDN = N + 8, LDP = PT + 8;
  constexpr int MT = N / 16, NP = PT / 16;  // state: m-tiles, n-tile pairs
  constexpr int UNITS = MT * NP, UPW = (UNITS + 3) / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 buffers
  __nv_bfloat16* Bs = Cs + 2 * CH * LDN;                       // 2 buffers
  __nv_bfloat16* Xs = Bs + 2 * CH * LDN;                       // 2 buffers
  __nv_bfloat16* Xd = Xs + 2 * CH * LDP;  // decayed X of this chunk
  __nv_bfloat16* Hs = Xd + CH * LDP;      // bf16 copy of h (N x PT)
  float* Ds = reinterpret_cast<float*>(Hs + N * LDP);  // dA, 2 buffers
  float* cs = Ds + 2 * CH;                              // cumsum of dA

  const int slices = p.P / PT;
  const int bh = blockIdx.x / slices, p0 = (blockIdx.x % slices) * PT;
  const __nv_bfloat16* xg =
      static_cast<const __nv_bfloat16*>(p.x) + bh * p.x_sb + p0;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(p.b) + bh * p.b_sb;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.c) + bh * p.c_sb;
  const float* dg = p.da + bh * p.d_sb;
  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(p.y) +
                      (long long)bh * p.S * p.P + p0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row / column pair
  const int nc = (p.S + p.chunk - 1) / p.chunk;

  for (int i = threadIdx.x; i < N * LDP; i += THREADS)
    Hs[i] = __float2bfloat16(0.f);
  float h[UPW][2][4];  // the f32 state, as mma accumulators
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int t = 0; t < 2; ++t) h[u][t][0] = h[u][t][1] = h[u][t][2] = h[u][t][3] = 0.f;

  load_chunk<N, PT>(p, Cs, Bs, Xs, Ds, cg, bg, xg, dg, 0, min(p.chunk, p.S));

  for (int ci = 0; ci < nc; ++ci) {
    const int buf = ci & 1;
    const int row0 = ci * p.chunk, rows = min(p.chunk, p.S - row0);
    cp_async_wait_all();
    __syncthreads();  // tiles of ci visible, buffer buf^1 and Xd free
    if (ci + 1 < nc) {
      const int nrow0 = row0 + p.chunk;
      load_chunk<N, PT>(p, Cs + (buf ^ 1) * CH * LDN, Bs + (buf ^ 1) * CH * LDN,
                        Xs + (buf ^ 1) * CH * LDP, Ds + (buf ^ 1) * CH, cg, bg,
                        xg, dg, nrow0, min(p.chunk, p.S - nrow0));
    }
    const __nv_bfloat16* Cb = Cs + buf * CH * LDN;
    const __nv_bfloat16* Bb = Bs + buf * CH * LDN;
    const __nv_bfloat16* Xb = Xs + buf * CH * LDP;
    if (warp == 0) warp_cumsum64(Ds + buf * CH, cs);
    __syncthreads();  // cs visible
    const float total = cs[CH - 1];

    // decayed X for the state update: Xd[r] = X[r] * exp(total - cs[r])
    for (int i = threadIdx.x; i < CH * PT / 2; i += THREADS) {
      const int r = i / (PT / 2), c = (i % (PT / 2)) * 2;
      const float d = expf(total - cs[r]);
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(Xb + r * LDP + c);
      *reinterpret_cast<uint32_t*>(Xd + r * LDP + c) =
          pack_bf16(__low2float(v) * d, __high2float(v) * d);
    }

    // this warp's 16 rows of C as mma A fragments (k = N)
    uint32_t cf[N / 16][4];
#pragma unroll
    for (int kc = 0; kc < N / 16; ++kc)
      ldmatrix_x4(cf[kc], smem_u32(Cb + (warp * 16 + (lane % 16)) * LDN +
                                   kc * 16 + (lane / 16) * 8));

    // S = C B^T for 16 rows x 64 columns; column pairs past the diagonal
    // block are zero and skipped
    float s[CH / 8][4];
#pragma unroll
    for (int i = 0; i < CH / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int np = 0; np < CH / 16; ++np) {
      if (np > warp) continue;
#pragma unroll
      for (int kc = 0; kc < N / 16; ++kc) {
        uint32_t bf[4];  // B fragments of n-tiles 2np and 2np+1
        ldmatrix_x4(bf, smem_u32(Bb + (np * 16 + (lane % 8) + (lane / 16) * 8) * LDN +
                                 kc * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(s[2 * np], cf[kc], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], cf[kc], bf[2], bf[3]);
      }
    }
    // o L: exp(cs_i - cs_j) on and below the diagonal, 0 above
    const int i0 = warp * 16 + g;
    const float csi[2] = {cs[i0], cs[i0 + 8]};
#pragma unroll
    for (int nt = 0; nt < CH / 8; ++nt) {
      if (nt / 2 > warp) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + (e >> 1) * 8, j = nt * 8 + tq * 2 + (e & 1);
        s[nt][e] = j <= i ? s[nt][e] * expf(csi[e >> 1] - cs[j]) : 0.f;
      }
    }

    // y = (C B^T o L) X: the masked scores are the A fragments, 16 columns
    // at a time, split into a bf16 high and low part (two products) so
    // that rounding them costs ~2^-17 instead of 2^-9
    float y[PT / 8][4];
#pragma unroll
    for (int i = 0; i < PT / 8; ++i) y[i][0] = y[i][1] = y[i][2] = y[i][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < CH / 16; ++kc) {
      if (kc > warp) continue;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)  // r: (row g | g + 8) x (n-tile 2kc | +1)
        split_bf16(s[2 * kc + r / 2][2 * (r % 2)], s[2 * kc + r / 2][2 * (r % 2) + 1],
                   hi[r], lo[r]);
#pragma unroll
      for (int dp = 0; dp < PT / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(Xb + (kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDP +
                                       dp * 16 + (lane / 16) * 8));
        mma_bf16(y[2 * dp], hi, bf[0], bf[1]);
        mma_bf16(y[2 * dp + 1], hi, bf[2], bf[3]);
        mma_bf16(y[2 * dp], lo, bf[0], bf[1]);
        mma_bf16(y[2 * dp + 1], lo, bf[2], bf[3]);
      }
    }

    // y += (C h) o exp(cs), h being the state before this chunk
    {
      float t[PT / 8][4];
#pragma unroll
      for (int i = 0; i < PT / 8; ++i) t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < N / 16; ++kc) {
#pragma unroll
        for (int dp = 0; dp < PT / 16; ++dp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, smem_u32(Hs + (kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDP +
                                         dp * 16 + (lane / 16) * 8));
          mma_bf16(t[2 * dp], cf[kc], bf[0], bf[1]);
          mma_bf16(t[2 * dp + 1], cf[kc], bf[2], bf[3]);
        }
      }
      const float ecs[2] = {expf(csi[0]), expf(csi[1])};
#pragma unroll
      for (int i = 0; i < PT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[i][e] += t[i][e] * ecs[e >> 1];
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r * 8;
      if (i < rows) {
        __nv_bfloat16* out = yg + (long long)(row0 + i) * p.P;
#pragma unroll
        for (int nt = 0; nt < PT / 8; ++nt)
          *reinterpret_cast<uint32_t*>(out + nt * 8 + tq * 2) =
              pack_bf16(y[nt][2 * r], y[nt][2 * r + 1]);
      }
    }
    __syncthreads();  // Xd written; every read of Hs done

    // h <- exp(total) h + B^T Xd, then its bf16 copy for the next chunk
    const float et = expf(total);
#pragma unroll
    for (int uu = 0; uu < UPW; ++uu) {
      const int u = warp + 4 * uu;
      if (u >= UNITS) continue;
      const int mt = u / NP, np = u % NP;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[uu][t][e] *= et;
#pragma unroll
      for (int kc = 0; kc < CH / 16; ++kc) {
        uint32_t a[4];  // A = B^T: ldmatrix.trans of the (chunk, N) tile
        const int mi = lane / 8;
        ldmatrix_x4_trans(a, smem_u32(Bb + (kc * 16 + (lane % 8) + (mi / 2) * 8) * LDN +
                                      mt * 16 + (mi % 2) * 8));
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(Xd + (kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDP +
                                       np * 16 + (lane / 16) * 8));
        mma_bf16(h[uu][0], a, bf[0], bf[1]);
        mma_bf16(h[uu][1], a, bf[2], bf[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(Hs + (mt * 16 + g + r * 8) * LDP +
                                       (2 * np + t) * 8 + tq * 2) =
              pack_bf16(h[uu][t][2 * r], h[uu][t][2 * r + 1]);
    }
  }
}

// -------------------------------------------------------------- f32 path

// 128 threads; one CTA owns one bh row and all P columns.
template <int N, int P>
__global__ void __launch_bounds__(THREADS) ssd_fwd_f32(const Params p) {
  constexpr int LDN = N + 1, LDC = CH + 1;  // odd pitches
  extern __shared__ float smf[];
  float* Xs = smf;             // CH x P
  float* Bs = Xs + CH * P;     // CH x LDN
  float* Cs = Bs + CH * LDN;   // CH x LDN
  float* Ss = Cs + CH * LDN;   // CH x LDC: C B^T o L
  float* Hs = Ss + CH * LDC;   // N x P: the state
  float* Ds = Hs + N * P;      // dA
  float* cs = Ds + CH;         // cumsum
  float* ec = cs + CH;         // exp(cs)
  float* dc = ec + CH;         // exp(total - cs)

  const int bh = blockIdx.x;
  const float* xg = static_cast<const float*>(p.x) + bh * p.x_sb;
  const float* bg = static_cast<const float*>(p.b) + bh * p.b_sb;
  const float* cg = static_cast<const float*>(p.c) + bh * p.c_sb;
  const float* dg = p.da + bh * p.d_sb;
  float* yg = static_cast<float*>(p.y) + (long long)bh * p.S * P;
  const int tid = threadIdx.x;
  const int nc = (p.S + p.chunk - 1) / p.chunk;

  for (int i = tid; i < N * P; i += THREADS) Hs[i] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int row0 = ci * p.chunk, rows = min(p.chunk, p.S - row0);
    __syncthreads();  // previous chunk consumed
    for (int i = tid; i < CH * P; i += THREADS) {
      const int r = i / P, c = i % P;
      Xs[i] = r < rows ? xg[(row0 + r) * p.x_ss + c] : 0.f;
    }
    for (int i = tid; i < CH * N; i += THREADS) {
      const int r = i / N, c = i % N;
      Bs[r * LDN + c] = r < rows ? bg[(row0 + r) * p.b_ss + c] : 0.f;
      Cs[r * LDN + c] = r < rows ? cg[(row0 + r) * p.c_ss + c] : 0.f;
    }
    if (tid < CH) Ds[tid] = tid < rows ? dg[row0 + tid] : 0.f;
    __syncthreads();
    if (tid < 32) warp_cumsum64(Ds, cs);
    __syncthreads();
    const float total = cs[CH - 1];
    if (tid < CH) {
      ec[tid] = expf(cs[tid]);
      dc[tid] = expf(total - cs[tid]);
    }
    // C B^T o L
    for (int i = tid; i < CH * CH; i += THREADS) {
      const int r = i / CH, j = i % CH;
      float acc = 0.f;
      if (j <= r) {
#pragma unroll 8
        for (int n = 0; n < N; ++n) acc = fmaf(Cs[r * LDN + n], Bs[j * LDN + n], acc);
        acc *= expf(cs[r] - cs[j]);
      }
      Ss[r * LDC + j] = acc;
    }
    __syncthreads();
    // y = (C B^T o L) X + (C h) o exp(cs)
    for (int i = tid; i < CH * P; i += THREADS) {
      const int r = i / P, c = i % P;
      if (r >= rows) continue;
      float a = 0.f, b = 0.f;
      for (int j = 0; j <= r; ++j) a = fmaf(Ss[r * LDC + j], Xs[j * P + c], a);
#pragma unroll 8
      for (int n = 0; n < N; ++n) b = fmaf(Cs[r * LDN + n], Hs[n * P + c], b);
      yg[(long long)(row0 + r) * P + c] = a + b * ec[r];
    }
    __syncthreads();  // every read of h done
    // h <- exp(total) h + (B o exp(total - cs))^T X
    const float et = expf(total);
    for (int i = tid; i < N * P; i += THREADS) {
      const int n = i / P, c = i % P;
      float acc = 0.f;
      for (int j = 0; j < CH; ++j)
        acc = fmaf(Bs[j * LDN + n] * dc[j], Xs[j * P + c], acc);
      Hs[i] = fmaf(et, Hs[i], acc);
    }
  }
}

// Dynamic shared memory of each instance, in bytes (see the layouts in the
// kernels).
constexpr int smem_bf16(int N, int PT) {
  return (4 * CH * (N + 8) + 3 * CH * (PT + 8) + N * (PT + 8)) *
             (int)sizeof(__nv_bfloat16) +
         3 * CH * (int)sizeof(float);
}

constexpr int smem_f32(int N, int P) {
  return (CH * P + 2 * CH * (N + 1) + CH * (CH + 1) + N * P + 5 * CH) *
         (int)sizeof(float);
}

template <int N, int PT>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const int smem = smem_bf16(N, PT);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_bf16<N, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ssd_fwd_bf16<N, PT><<<p.BH * (p.P / PT), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N, int P>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = smem_f32(N, P);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_f32<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ssd_fwd_f32<N, P><<<p.BH, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The P columns one bf16 CTA owns.
constexpr int p_tile(int P) { return P < 32 ? P : 32; }

template <int N>
cudaError_t dispatch_p(const Params& p, bool bf16, cudaStream_t s) {
  if (bf16) {
    switch (p.P) {
      case 16: return launch_bf16<N, p_tile(16)>(p, s);
      case 32: return launch_bf16<N, p_tile(32)>(p, s);
      case 64: return launch_bf16<N, p_tile(64)>(p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (p.P) {
    case 16: return launch_f32<N, 16>(p, s);
    case 32: return launch_f32<N, 32>(p, s);
    case 64: return launch_f32<N, 64>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of xdt, B, C and y; dA is float32).
// Strides are in elements.  chunk in [1, 64].  Returns the launch's
// cudaError_t (0 on success).
extern "C" int ssd_fwd(const void* x, const float* da, const void* b,
                       const void* c, void* y, int dtype, int BH, int S, int P,
                       int N, int chunk, long long x_sb, long long x_ss,
                       long long d_sb, long long b_sb, long long b_ss,
                       long long c_sb, long long c_ss, void* stream) {
  const Params p{x, da, b, c, y, BH, S, P, N, chunk,
                 x_sb, x_ss, d_sb, b_sb, b_ss, c_sb, c_ss};
  if ((dtype != 0 && dtype != 1) || chunk < 1 || chunk > CH || BH < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return (int)dispatch_p<16>(p, bf16, s);
    case 32: return (int)dispatch_p<32>(p, bf16, s);
    case 64: return (int)dispatch_p<64>(p, bf16, s);
    case 128: return (int)dispatch_p<128>(p, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory (bytes) the instance for (dtype, N, P) launches
// with.
extern "C" int ssd_smem_bytes(int dtype, int N, int P) {
  return dtype == 1 ? smem_bf16(N, p_tile(P)) : smem_f32(N, P);
}
