// Fused GEMM-epilogue for Hopper (sm_90a): softmax, LayerNorm or RMSNorm of
// every row of C = A B, f32 and bf16, as one thread-block-cluster kernel.
//
// Replaces: src/repro/kernels/gemm_softmax.py, the Pallas TPU kernel
// `_kernel` (line 27) launched by `gemm_softmax` (line 49), and
// src/repro/kernels/gemm_layernorm.py, `_kernel` (line 26) launched by
// `_fused_gemm_norm` (line 57) for `gemm_layernorm` and `gemm_rmsnorm`.
// Both TPU kernels stream K through VMEM into a (block_m, N) f32
// accumulator and run the row epilogue at the last K step, so C never
// reaches device memory.  This kernel computes the same functions:
//   softmax:   exp(c - max) / sum exp(c - max)           (2 rounds)
//   LayerNorm: (c - mean) rsqrt(mean((c - mean)^2) + eps) g + b   (2 rounds)
//   RMSNorm:   c rsqrt(mean(c^2) + eps) g                 (1 round)
// over the true N, with the centred variance, in f32; g and b are f32, the
// output has A's dtype.
//
// The design problem: the TPU kernel keeps a whole row block of C (16 rows
// of N = 16384 in f32 are 1 MB) in VMEM.  A CTA on the H100 has at most
// 227 KB of shared memory and 255 registers a thread, so no CTA can hold a
// row.  Here the row is split across a thread-block cluster, the paper's
// Fused-GEMM-distSM / distLN dataflow with its collective made explicit:
//
// - A cluster of CL CTAs (CL in 1, 2, 4, 8, 16; grid = (CL, ceil(M / 16)))
//   shares one block of BM = 16 rows of C.  CTA r of the cluster owns the
//   columns [r ns, r ns + ns), ns = N / CL rounded up to 16, and runs the
//   whole K loop for its (16, ns) slice: K is read once and C is computed
//   once.  The slice stays in registers.
// - The per-CTA budget: ns <= NT = 1024 columns.  8 warps (256 threads),
//   each holding 16 rows x 128 columns of f32 accumulators, 64 registers a
//   thread; __launch_bounds__(256, 2) caps a thread at 128 registers so that
//   two CTAs share an SM (a 16-CTA cluster then needs 8 SMs of a GPC).
//   CL is the smallest size whose slice fits: N <= 1024 * CL, so N up to
//   16384 in both dtypes; a larger N is refused by the wrapper and here.
// - Shared memory: double-buffered A and B tiles, 67,584 B (bf16) or
//   66,560 B (f32) of dynamic shared memory, plus 640 B of row scratch.
// - bf16: cp.async.cg double buffering of the (16, ns) B tile and 16-deep
//   K steps, mma.sync m16n8k16 with f32 accumulation (ldmatrix for A,
//   ldmatrix.trans for the row-major B tile).  f32: 8-deep K steps, f32 FMAs
//   on the CUDA cores, no TF32 (the 2e-5 f32 bar).
// - The row statistics: each thread reduces its part of a row, then the
//   four threads of an mma quad (bf16) or the 32 lanes of a warp (f32) with
//   __shfl_xor_sync, then the 8 warps through shared memory, then the CL
//   CTAs through distributed shared memory (DSMEM): every CTA writes its 16
//   partials to its own shared memory, cluster.sync(), reads all CL ranks'
//   partials with cluster.map_shared_rank in rank order (so every CTA
//   computes the same bits), and a second cluster.sync() keeps any CTA from
//   rewriting its partials, or exiting, while another still reads them.
// - Ragged shapes are masked in place: A elements past M or K and B rows
//   past K are staged as zeros, rows past M are not stored, and columns
//   past N are left out of the max (as -inf), of every sum, and of the
//   divisor, which is the true N.
//
// What bounds it on this card: at (M, N, K) = (4096, 16384, 4096) bf16 the
// product is 549.8 GFLOP against 302 MB of compulsory traffic (A, B, the
// output), ~1800 FLOP per byte, far above the H100's ~295 FLOP/byte ridge:
// tensor-core operations bound it (0.556 ms at 989 TFLOP/s).  At the
// paper's small-K cloud shapes (K 64 or 128) bytes bound it, and avoiding
// the round trip of C through device memory is the whole gain.  This first
// version reads each B slice once per 16 rows of A (16 FLOP per byte from
// L2) and issues mma.sync, not wgmma; TMA multicast of A across the
// cluster, wgmma with a larger row block and warp specialisation are later
// work.
//
// Layout: A (M, K) and B (K, N) row-major and contiguous; B's rows 16-byte
// aligned (N a multiple of 8 in bf16, of 4 in f32); out (M, N) contiguous.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 16;         // rows of C per cluster (and per CTA)
constexpr int NT = 1024;       // most columns a CTA holds: its slice budget
constexpr int THREADS = 256;   // 8 warps
constexpr int NWARP = THREADS / 32;
constexpr int MAX_CLUSTER = 16;

enum Epilogue { SOFTMAX = 0, LAYERNORM = 1, RMSNORM = 2 };

struct Params {
  const void* a;
  const void* b;
  const float* gamma;  // (N,) f32, or null for softmax
  const float* beta;   // (N,) f32, LayerNorm only
  void* out;
  int M, N, K;
  int ns;  // columns of a CTA's slice: a multiple of 16, <= NT
  float eps;
};

// Row statistics: per-warp partials, this CTA's partials (read by the
// whole cluster through DSMEM), and the cluster's statistic.
struct RowScratch {
  float warp[NWARP][BM];
  float cta[BM];
  float stat[BM];
};

struct MaxOp {
  static __device__ __forceinline__ float id() { return -INFINITY; }
  static __device__ __forceinline__ float op(float x, float y) {
    return fmaxf(x, y);
  }
};

struct SumOp {
  static __device__ __forceinline__ float id() { return 0.f; }
  static __device__ __forceinline__ float op(float x, float y) {
    return x + y;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes (rows past K, columns past N)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
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

// ------------------------------------------------------------- bf16 path
//
// Warp w owns the column pairs of 16 (two mma n-tiles) starting at
// (w + 8 i) * 16, i = 0..7, for all 16 rows: acc[2 i + h] is n-tile h of
// pair i.  In an n-tile, thread (g = lane / 4, tq = lane % 4) holds rows g
// (elements 0, 1) and g + 8 (elements 2, 3), columns 2 tq and 2 tq + 1.

struct Bf16Tile {
  static constexpr int BK = 16;        // K per step
  static constexpr int LDA = BK + 8;   // A tile pitch (elements)
  static constexpr int LDB = NT + 8;   // B tile pitch: ldmatrix conflict-free
  static constexpr int ROWS = 2;       // rows a thread holds
  static constexpr int SMEM =
      2 * (BK * LDB + BM * LDA) * (int)sizeof(__nv_bfloat16);

  // f(slot, row, column in the slice, accumulator)
  template <class F>
  static __device__ __forceinline__ void for_each(float (&c)[16][4], F&& f) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tq = lane % 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(e >> 1, g + 8 * (e >> 1),
            (warp + NWARP * i) * 16 + h * 8 + 2 * tq + (e & 1), c[2 * i + h][e]);
  }

  template <class Op>
  static __device__ __forceinline__ void warp_reduce(float (&part)[ROWS]) {
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      part[s] = Op::op(part[s], __shfl_xor_sync(0xffffffffu, part[s], 1));
      part[s] = Op::op(part[s], __shfl_xor_sync(0xffffffffu, part[s], 2));
    }
  }

  static __device__ __forceinline__ void store_warp(const float (&part)[ROWS],
                                                    float* w) {
    const int lane = threadIdx.x % 32;
    if (lane % 4 == 0) {
      w[lane / 4] = part[0];
      w[lane / 4 + 8] = part[1];
    }
  }

  // Stage the 16 x ceil16(ncols) B tile at K row k0 (zero past K and
  // ncols).  The 16 x 16 A tile moves through registers, one element a
  // thread (load_a, store_a): A's rows need not be 16-byte aligned.
  static __device__ __forceinline__ void load_b(__nv_bfloat16* Bs,
                                                const Params& p, int k0,
                                                int col0, int ncols) {
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(p.b);
    const int chunks = (ncols + 15) / 16 * 2;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < BK * chunks; i += THREADS) {
      const int r = i / chunks, c = i % chunks;
      const bool ok = k0 + r < p.K && c * 8 < ncols;
      const __nv_bfloat16* src =
          ok ? b + (long long)(k0 + r) * p.N + col0 + c * 8 : b;
      cp_async16(Bs + r * LDB + c * 8, src, ok);
    }
  }

  static __device__ __forceinline__ uint16_t load_a(const Params& p, int m0,
                                                    int k0) {
    const int r = threadIdx.x / BK, c = threadIdx.x % BK;
    const uint16_t* a = static_cast<const uint16_t*>(p.a);
    return (m0 + r < p.M && k0 + c < p.K)
               ? a[(long long)(m0 + r) * p.K + k0 + c]
               : (uint16_t)0;
  }

  static __device__ __forceinline__ void store_a(__nv_bfloat16* As,
                                                 uint16_t v) {
    const int r = threadIdx.x / BK, c = threadIdx.x % BK;
    reinterpret_cast<uint16_t*>(As)[r * LDA + c] = v;
  }

  static __device__ void mainloop(const Params& p, unsigned char* smem,
                                  float (&acc)[16][4], int m0, int col0,
                                  int ncols) {
    __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 buffers
    __nv_bfloat16* As = Bs + 2 * BK * LDB;                       // 2 buffers
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nk = (p.K + BK - 1) / BK;

    load_b(Bs, p, 0, col0, ncols);
    cp_async_commit();
    store_a(As, load_a(p, m0, 0));
    cp_async_wait_all();
    __syncthreads();

    for (int s = 0; s < nk; ++s) {
      const int buf = s & 1;
      const bool more = s + 1 < nk;
      uint16_t a_next = 0;
      if (more) {  // prefetch the next step into the other buffers
        load_b(Bs + (buf ^ 1) * BK * LDB, p, (s + 1) * BK, col0, ncols);
        cp_async_commit();
        a_next = load_a(p, m0, (s + 1) * BK);
      }
      const __nv_bfloat16* Ab = As + buf * BM * LDA;
      const __nv_bfloat16* Bb = Bs + buf * BK * LDB;
      uint32_t af[4];
      ldmatrix_x4(af, smem_u32(Ab + (lane % 16) * LDA + (lane / 16) * 8));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int pc = (warp + NWARP * i) * 16;
        if (pc < ncols) {  // warp-uniform: pairs past the slice are skipped
          uint32_t bf[4];  // B fragments of n-tiles 2i and 2i + 1
          ldmatrix_x4_trans(bf, smem_u32(Bb + ((lane % 8) + ((lane / 8) % 2) * 8) * LDB +
                                         pc + (lane / 16) * 8));
          mma_bf16(acc[2 * i], af, bf[0], bf[1]);
          mma_bf16(acc[2 * i + 1], af, bf[2], bf[3]);
        }
      }
      if (more) {
        store_a(As + (buf ^ 1) * BM * LDA, a_next);
        cp_async_wait_all();
      }
      __syncthreads();  // next step's tiles visible; this buffer free
    }
  }

  static __device__ void store(const Params& p, float (&c)[16][4], int m0,
                               int col0, int ncols) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tq = lane % 4;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (warp + NWARP * i) * 16 + h * 8 + 2 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = m0 + g + 8 * r;
          if (col < ncols && m < p.M)
            *reinterpret_cast<uint32_t*>(out + (long long)m * p.N + col0 + col) =
                pack_bf16(c[2 * i + h][2 * r], c[2 * i + h][2 * r + 1]);
        }
      }
  }
};

// -------------------------------------------------------------- f32 path
//
// Thread t owns columns 4 t .. 4 t + 3 of the slice for all 16 rows:
// acc[r][j] is row r, column 4 t + j.

struct F32Tile {
  static constexpr int BK = 8;         // K per step
  static constexpr int ROWS = BM;      // rows a thread holds
  static constexpr int SMEM = 2 * (BK * NT + BK * BM) * (int)sizeof(float);

  template <class F>
  static __device__ __forceinline__ void for_each(float (&c)[16][4], F&& f) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(r, r, 4 * (int)threadIdx.x + j, c[r][j]);
  }

  template <class Op>
  static __device__ __forceinline__ void warp_reduce(float (&part)[ROWS]) {
#pragma unroll
    for (int s = 0; s < ROWS; ++s)
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        part[s] = Op::op(part[s], __shfl_xor_sync(0xffffffffu, part[s], o));
  }

  static __device__ __forceinline__ void store_warp(const float (&part)[ROWS],
                                                    float* w) {
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int s = 0; s < ROWS; ++s) w[s] = part[s];
    }
  }

  static __device__ __forceinline__ void load_b(float* Bs, const Params& p,
                                                int k0, int col0, int ncols) {
    const float* b = static_cast<const float*>(p.b);
    const int chunks = ncols / 4;  // ncols is a multiple of 4
    for (int i = threadIdx.x; i < BK * chunks; i += THREADS) {
      const int r = i / chunks, c = i % chunks;
      const bool ok = k0 + r < p.K;
      const float* src = ok ? b + (long long)(k0 + r) * p.N + col0 + c * 4 : b;
      cp_async16(Bs + r * NT + c * 4, src, ok);
    }
  }

  // A tile stored K-major: As[k][row]
  static __device__ __forceinline__ float load_a(const Params& p, int m0,
                                                 int k0) {
    const int r = threadIdx.x % BM, c = threadIdx.x / BM;
    const float* a = static_cast<const float*>(p.a);
    return (threadIdx.x < BK * BM && m0 + r < p.M && k0 + c < p.K)
               ? a[(long long)(m0 + r) * p.K + k0 + c]
               : 0.f;
  }

  static __device__ __forceinline__ void store_a(float* As, float v) {
    if (threadIdx.x < BK * BM) As[threadIdx.x] = v;  // [c][r] = c * BM + r
  }

  static __device__ void mainloop(const Params& p, unsigned char* smem,
                                  float (&acc)[16][4], int m0, int col0,
                                  int ncols) {
    float* Bs = reinterpret_cast<float*>(smem);  // 2 buffers of BK x NT
    float* As = Bs + 2 * BK * NT;                // 2 buffers of BK x BM
    const int nk = (p.K + BK - 1) / BK;
    const bool mine = 4 * (int)threadIdx.x < ncols;

    load_b(Bs, p, 0, col0, ncols);
    cp_async_commit();
    store_a(As, load_a(p, m0, 0));
    cp_async_wait_all();
    __syncthreads();

    for (int s = 0; s < nk; ++s) {
      const int buf = s & 1;
      const bool more = s + 1 < nk;
      float a_next = 0.f;
      if (more) {
        load_b(Bs + (buf ^ 1) * BK * NT, p, (s + 1) * BK, col0, ncols);
        cp_async_commit();
        a_next = load_a(p, m0, (s + 1) * BK);
      }
      if (mine) {
        const float* Ab = As + buf * BK * BM;
        const float* Bb = Bs + buf * BK * NT;
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          const float4 bv = *reinterpret_cast<const float4*>(Bb + k * NT + 4 * threadIdx.x);
#pragma unroll
          for (int q = 0; q < BM / 4; ++q) {
            const float4 av = *reinterpret_cast<const float4*>(Ab + k * BM + 4 * q);
            const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float* c = acc[4 * q + u];
              c[0] = fmaf(ar[u], bv.x, c[0]);
              c[1] = fmaf(ar[u], bv.y, c[1]);
              c[2] = fmaf(ar[u], bv.z, c[2]);
              c[3] = fmaf(ar[u], bv.w, c[3]);
            }
          }
        }
      }
      if (more) {
        store_a(As + (buf ^ 1) * BK * BM, a_next);
        cp_async_wait_all();
      }
      __syncthreads();
    }
  }

  static __device__ void store(const Params& p, float (&c)[16][4], int m0,
                               int col0, int ncols) {
    const int col = 4 * threadIdx.x;
    if (col >= ncols) return;
    float* out = static_cast<float*>(p.out);
#pragma unroll
    for (int r = 0; r < BM; ++r)
      if (m0 + r < p.M)
        *reinterpret_cast<float4*>(out + (long long)(m0 + r) * p.N + col0 + col) =
            make_float4(c[r][0], c[r][1], c[r][2], c[r][3]);
  }
};

// ------------------------------------------------------- the row epilogue

// All-reduce one statistic per row over the cluster.  `part` holds this
// thread's partials of its rows; on return rs.stat[row] holds
// fin(Op over every column of the row) in every CTA of the cluster.
template <class Op, class Tile, class Fin>
__device__ void allreduce_rows(float (&part)[Tile::ROWS], RowScratch& rs,
                               Fin fin) {
  cg::cluster_group cluster = cg::this_cluster();
  Tile::template warp_reduce<Op>(part);  // lanes that share a row
  Tile::store_warp(part, rs.warp[threadIdx.x / 32]);
  __syncthreads();
  if (threadIdx.x < BM) {  // the CTA's partials, over its 8 warps
    float v = Op::id();
#pragma unroll
    for (int w = 0; w < NWARP; ++w) v = Op::op(v, rs.warp[w][threadIdx.x]);
    rs.cta[threadIdx.x] = v;
  }
  cluster.sync();  // every CTA's partials are written
  if (threadIdx.x < BM) {  // read them all over DSMEM, in rank order
    float v = Op::id();
    const int ranks = (int)cluster.num_blocks();
    for (int r = 0; r < ranks; ++r)
      v = Op::op(v, cluster.map_shared_rank(&rs.cta[0], r)[threadIdx.x]);
    rs.stat[threadIdx.x] = fin(v);
  }
  // stat visible to the whole CTA; no CTA reads rs.cta any longer, so it may
  // be rewritten (next round) or its CTA may exit
  cluster.sync();
}

template <int EPI, bool BF16>
__global__ void __launch_bounds__(THREADS, 2) ge_fwd_kernel(const Params p) {
  using Tile = std::conditional_t<BF16, Bf16Tile, F32Tile>;
  __shared__ RowScratch rs;
  extern __shared__ __align__(16) unsigned char smem[];

  const int col0 = blockIdx.x * p.ns;  // blockIdx.x is the cluster rank
  const int ncols = max(0, min(p.ns, p.N - col0));
  const int m0 = blockIdx.y * BM;

  float c[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
  if (ncols > 0) Tile::mainloop(p, smem, c, m0, col0, ncols);

  float part[Tile::ROWS];
  const float inv_n = 1.f / (float)p.N;
  auto set = [&](float v) {
#pragma unroll
    for (int s = 0; s < Tile::ROWS; ++s) part[s] = v;
  };
  if (EPI == SOFTMAX) {
    set(-INFINITY);
    Tile::for_each(c, [&](int s, int r, int col, float& v) {
      if (col < ncols) part[s] = fmaxf(part[s], v);
    });
    allreduce_rows<MaxOp, Tile>(part, rs, [](float v) { return v; });
    set(0.f);
    Tile::for_each(c, [&](int s, int r, int col, float& v) {
      v = expf(v - rs.stat[r]);
      if (col < ncols) part[s] += v;
    });
    allreduce_rows<SumOp, Tile>(part, rs, [](float v) { return v; });
    Tile::for_each(c, [&](int s, int r, int col, float& v) { v = v / rs.stat[r]; });
  } else if (EPI == LAYERNORM) {
    set(0.f);
    Tile::for_each(c, [&](int s, int r, int col, float& v) {
      if (col < ncols) part[s] += v;
    });
    allreduce_rows<SumOp, Tile>(part, rs, [&](float v) { return v * inv_n; });
    set(0.f);
    Tile::for_each(c, [&](int s, int r, int col, float& v) {
      v -= rs.stat[r];  // centred: mean((c - mean)^2), not E[c^2] - mean^2
      if (col < ncols) part[s] += v * v;
    });
    const float eps = p.eps;
    allreduce_rows<SumOp, Tile>(part, rs,
                                [&](float v) { return rsqrtf(v * inv_n + eps); });
    Tile::for_each(c, [&](int s, int r, int col, float& v) {
      if (col < ncols) v = v * rs.stat[r] * p.gamma[col0 + col] + p.beta[col0 + col];
    });
  } else {  // RMSNORM
    set(0.f);
    Tile::for_each(c, [&](int s, int r, int col, float& v) {
      if (col < ncols) part[s] += v * v;
    });
    const float eps = p.eps;
    allreduce_rows<SumOp, Tile>(part, rs,
                                [&](float v) { return rsqrtf(v * inv_n + eps); });
    Tile::for_each(c, [&](int s, int r, int col, float& v) {
      if (col < ncols) v = v * rs.stat[r] * p.gamma[col0 + col];
    });
  }
  Tile::store(p, c, m0, col0, ncols);
}

template <int EPI, bool BF16>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int cluster, int row_blocks, cudaStream_t stream) {
  const int smem = BF16 ? Bf16Tile::SMEM : F32Tile::SMEM;
  static bool attributes_set = false;  // once per instance and process
  if (!attributes_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ge_fwd_kernel<EPI, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ge_fwd_kernel<EPI, BF16>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attributes_set = true;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster, row_blocks, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int EPI, bool BF16>
cudaError_t launch(const Params& p, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<EPI, BF16>(cfg, attr, cluster,
                                       (p.M + BM - 1) / BM, stream);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, ge_fwd_kernel<EPI, BF16>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int EPI, bool BF16>
cudaError_t max_clusters(int cluster, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<EPI, BF16>(cfg, attr, cluster, 1, 0);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(n, ge_fwd_kernel<EPI, BF16>, &cfg);
}

bool valid_cluster(int cluster) {
  return cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
         cluster == MAX_CLUSTER;
}

}  // namespace

// The slice budget of a CTA, in columns (the wrapper's SLICE_COLUMNS).
extern "C" int ge_slice_columns() { return NT; }

// Dynamic shared memory of the kernel for dtype (0 = float32, 1 = bfloat16).
extern "C" int ge_smem_bytes(int dtype) {
  return dtype == 1 ? Bf16Tile::SMEM : F32Tile::SMEM;
}

// epilogue: 0 softmax, 1 LayerNorm, 2 RMSNorm; dtype: 0 float32, 1 bfloat16.
// `cluster` CTAs (1, 2, 4, 8 or 16) share each 16-row block; the slice of a
// CTA, ceil(N / cluster) rounded up to 16, must fit NT columns.  gamma/beta
// are f32 (N,) (beta LayerNorm only).  Returns the launch's cudaError_t (0
// on success).
extern "C" int ge_fwd(const void* a, const void* b, const void* gamma,
                      const void* beta, void* out, int epilogue, int dtype,
                      int M, int N, int K, int cluster, float eps,
                      void* stream) {
  if (!valid_cluster(cluster) || M < 1 || N < 1 || K < 1 ||
      (dtype != 0 && dtype != 1) || epilogue < 0 || epilogue > 2 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int ns = ((N + cluster - 1) / cluster + 15) / 16 * 16;
  if (ns > NT || N % (dtype == 1 ? 8 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{a, b, static_cast<const float*>(gamma),
                 static_cast<const float*>(beta), out, M, N, K, ns, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  switch (epilogue) {
    case SOFTMAX:
      return (int)(bf16 ? launch<SOFTMAX, true>(p, cluster, s)
                        : launch<SOFTMAX, false>(p, cluster, s));
    case LAYERNORM:
      return (int)(bf16 ? launch<LAYERNORM, true>(p, cluster, s)
                        : launch<LAYERNORM, false>(p, cluster, s));
    default:
      return (int)(bf16 ? launch<RMSNORM, true>(p, cluster, s)
                        : launch<RMSNORM, false>(p, cluster, s));
  }
}

// cudaOccupancyMaxActiveClusters of one instance: how many clusters of
// `cluster` CTAs the card can hold at once (0: the cluster cannot be
// placed).  Returns the count, or minus the cudaError_t of the query.
extern "C" int ge_max_active_clusters(int epilogue, int dtype, int cluster) {
  if (!valid_cluster(cluster) || (dtype != 0 && dtype != 1) || epilogue < 0 ||
      epilogue > 2)
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  const bool bf16 = dtype == 1;
  cudaError_t e;
  switch (epilogue) {
    case SOFTMAX:
      e = bf16 ? max_clusters<SOFTMAX, true>(cluster, &n)
               : max_clusters<SOFTMAX, false>(cluster, &n);
      break;
    case LAYERNORM:
      e = bf16 ? max_clusters<LAYERNORM, true>(cluster, &n)
               : max_clusters<LAYERNORM, false>(cluster, &n);
      break;
    default:
      e = bf16 ? max_clusters<RMSNORM, true>(cluster, &n)
               : max_clusters<RMSNORM, false>(cluster, &n);
  }
  return e == cudaSuccess ? n : -(int)e;
}
