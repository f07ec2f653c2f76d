// Streamed GEMM for Hopper (sm_90a): C = X W with the contraction K streamed
// in `chunks` equal chunks through one or two shared-memory stages, f32 and
// bf16 in, f32 accumulation, C in X's dtype.
//
// Replaces: src/repro/kernels/allgather_gemm.py, the Pallas TPU kernel
// `_kernel` (line 70) launched by `streamed_gemm` (line 124), which the
// all-gather entry `allgather_gemm` (line 166) calls with one chunk per
// source shard.  The TPU kernel DMAs chunk c of X (M, kc) and of W (kc, N)
// into one of `buffers` VMEM slots and adds their product into a whole
// (M, N) f32 accumulator in VMEM; with two slots the copy of chunk c + 1 is
// in flight while the MXU contracts chunk c, with one slot copy and compute
// alternate.  The pair measures how much of the copy hides under compute.
//
// The design problem: at the smallest shape the JAX bench drives, (M, K, N,
// chunks) = (256, 4096, 512, 8) in f32, one X slot alone is 512 KB, and the
// accumulator another 512 KB; a CTA on the H100 has at most 227 KB of shared
// memory.  So nothing here holds a whole chunk or the whole C:
//
// - One CTA for each output tile, the accumulator in registers: bf16 tiles
//   of 128 x 128 (8 warps of 64 x 32, mma.sync m16n8k16 with f32
//   accumulation, ldmatrix for X, ldmatrix.trans for the row-major W tile);
//   f32 tiles of 64 x 64 (256 threads of 4 x 4, f32 FMAs on the CUDA cores,
//   no TF32).  The grid runs over M fastest, so the CTAs of a wave share a
//   column tile of W and X stays in L2.
// - The K loop follows the chunk order: chunk c = 0 .. chunks - 1, and inside
//   each chunk its kc columns in k-tiles of BK (32 in bf16, 16 in f32).  The
//   last k-tile of a chunk is ragged when BK does not divide kc and is padded
//   with zeros; no k-tile straddles two chunks.  The chunk stays the unit of
//   the stream, so that a 4-card version can make chunk c wait for its
//   arrival from rank c.
// - NBUF = 2: two shared-memory stages filled with cp.async, committed as
//   one group per k-tile; the next k-tile (the first tile of chunk c + 1
//   after the last of chunk c) is in flight while the current one's products
//   run, and `cp.async.wait_group 1` waits for the current one only.  This is
//   the TPU kernel's prefetch (lines 85-106) at the granularity that shared
//   memory allows.
// - NBUF = 1: one stage; issue, `wait_group 0`, __syncthreads, products,
//   __syncthreads: the serial baseline of lines 107-119.
// - Both modes run the same products in the same order, so their outputs
//   agree bit for bit.
// - Ragged M, N and K: rows past M, columns past N and the padded columns of
//   a ragged k-tile are staged as zeros (cp.async with src-size 0), and C is
//   stored under a mask.  cp.async moves 16 bytes, so the rows of X and W
//   and the start of every chunk are 16-byte aligned: N and kc = K / chunks
//   are multiples of 8 in bf16 and of 4 in f32 (the wrapper checks this,
//   and the launcher refuses it too).
//
// What bounds it on this card: at glm4-9b's MLP input projection at the
// serving prefill, (M, K, N) = (4096, 4096, 13696) bf16 with chunks = 4,
// the product is 459.6 GFLOP against 258 MB of compulsory traffic (X, W,
// C): operations bound it, 0.465 ms at 989 TFLOP/s against 0.077 ms of
// bytes at 3.35 TB/s.  At the JAX bench's f32 shapes (BUDGET_SHAPES of the
// wrapper) the bound is 0.5-16 us and the grid fills 8-32 of the 132 SMs:
// a call costs its launch and one CTA's serial walk over K, which is latency.
// There the two stages matter most: with one CTA on an SM nothing else
// hides a k-tile's load, so NBUF = 2 puts it under the previous tile's
// products.  This first version issues mma.sync, not wgmma, from a
// two-stage cp.async ring; TMA with mbarriers, a third stage and split-K
// for the small grids are later work.
//
// Layout: X (M, K), W (K, N) and C (M, N) row-major and contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* x;
  const void* w;
  void* out;
  int M, N, K;
  int kc;      // columns of a chunk: K / chunks
  int chunks;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes (rows past M or K, columns past N)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ------------------------------------------------------------- bf16 tile
//
// Warp w (0..7) owns rows (w / 4) * 64 .. + 64 and columns (w % 4) * 32 ..
// + 32 of the 128 x 128 tile: acc[i][j] is m16 tile i, n8 tile j.  In an
// (m16, n8) tile, thread (g = lane / 4, tq = lane % 4) holds rows g
// (elements 0, 1) and g + 8 (elements 2, 3), columns 2 tq and 2 tq + 1.

struct Bf16Tile {
  using T = __nv_bfloat16;  // in device memory
  using S = uint16_t;       // its bits in shared memory
  static constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
  static constexpr int PER16 = 8;        // elements in 16 bytes
  static constexpr int LDX = BK + 8;     // 80-byte rows: ldmatrix conflict-free
  static constexpr int LDW = BN + 8;     // 272-byte rows: likewise
  struct Stage {
    S x[BM * LDX];
    S w[BK * LDW];
  };
  struct Acc {
    float v[4][4][4];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[i][j][e] = 0.f;
    }
  };

  static __device__ __forceinline__ void mma(const Stage& st, Acc& acc) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], smem_u32(st.x + (wm * 64 + i * 16 + lane % 16) * LDX +
                                   kk + (lane / 16) * 8));
      uint32_t b[2][4];  // b[j]: the fragments of n8 tiles 2 j and 2 j + 1
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(
            b[j], smem_u32(st.w + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDW +
                           wn * 32 + j * 16 + (lane / 16) * 8));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc.v[i][2 * j], a[i], b[j][0], b[j][1]);
          mma_bf16(acc.v[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }

  static __device__ void store(const Params& p, const Acc& acc, int m0,
                               int n0) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, tq = lane % 4;
    T* out = static_cast<T*>(p.out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * tq;  // even, N even: n + 1 < N
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
          if (m < p.M && n < p.N)
            *reinterpret_cast<uint32_t*>(out + (long long)m * p.N + n) =
                pack_bf16(acc.v[i][j][2 * h], acc.v[i][j][2 * h + 1]);
        }
      }
  }
};

// -------------------------------------------------------------- f32 tile
//
// Thread t owns rows 4 (t / 16) .. + 4 and columns 4 (t % 16) .. + 4 of the
// 64 x 64 tile: acc.v[u][j] is row 4 (t / 16) + u, column 4 (t % 16) + j.

struct F32Tile {
  using T = float;
  using S = float;
  static constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
  static constexpr int PER16 = 4;
  static constexpr int LDX = BK + 4;     // the two row groups of a warp
                                         // fall 16 banks apart
  static constexpr int LDW = BN;
  struct Stage {
    S x[BM * LDX];
    S w[BK * LDW];
  };
  struct Acc {
    float v[4][4];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = 0.f;
    }
  };

  static __device__ __forceinline__ void mma(const Stage& st, Acc& acc) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(st.w + k * LDW + 4 * tx);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = st.x[(4 * ty + u) * LDX + k];
        acc.v[u][0] = fmaf(a, b.x, acc.v[u][0]);
        acc.v[u][1] = fmaf(a, b.y, acc.v[u][1]);
        acc.v[u][2] = fmaf(a, b.z, acc.v[u][2]);
        acc.v[u][3] = fmaf(a, b.w, acc.v[u][3]);
      }
    }
  }

  static __device__ void store(const Params& p, const Acc& acc, int m0,
                               int n0) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const int n = n0 + 4 * tx;  // N % 4 == 0: the 4 columns are all in or out
    if (n >= p.N) return;
    float* out = static_cast<float*>(p.out);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = m0 + 4 * ty + u;
      if (m < p.M)
        *reinterpret_cast<float4*>(out + (long long)m * p.N + n) =
            make_float4(acc.v[u][0], acc.v[u][1], acc.v[u][2], acc.v[u][3]);
    }
  }
};

// ---------------------------------------------------------- the k stream

// Stage the BM x BK tile of X and the BK x BN tile of W at column/row k0,
// zero past M, N and the chunk's end `kend`.  k0 and kend are multiples of
// PER16 (kc is), so each 16-byte group lies wholly inside or outside.
template <class Tile>
__device__ __forceinline__ void load_tiles(typename Tile::Stage& st,
                                           const Params& p, int m0, int n0,
                                           int k0, int kend) {
  using T = typename Tile::T;
  constexpr int XG = Tile::BK / Tile::PER16;  // 16-byte groups in a row
  constexpr int WG = Tile::BN / Tile::PER16;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  for (int i = threadIdx.x; i < Tile::BM * XG; i += Tile::THREADS) {
    const int r = i / XG, k = k0 + (i % XG) * Tile::PER16;
    const bool ok = m0 + r < p.M && k < kend;
    cp_async16(st.x + r * Tile::LDX + (i % XG) * Tile::PER16,
               ok ? x + (long long)(m0 + r) * p.K + k : x, ok);
  }
  for (int i = threadIdx.x; i < Tile::BK * WG; i += Tile::THREADS) {
    const int r = i / WG, n = n0 + (i % WG) * Tile::PER16;
    const bool ok = k0 + r < kend && n < p.N;
    cp_async16(st.w + r * Tile::LDW + (i % WG) * Tile::PER16,
               ok ? w + (long long)(k0 + r) * p.N + n : w, ok);
  }
  cp_async_commit();
}

template <class Tile, int NBUF>
__global__ void __launch_bounds__(256, 2) sg_fwd_kernel(const Params p) {
  __shared__ __align__(16) typename Tile::Stage stages[NBUF];
  const int m0 = blockIdx.x * Tile::BM, n0 = blockIdx.y * Tile::BN;
  const int per_chunk = (p.kc + Tile::BK - 1) / Tile::BK;  // k-tiles a chunk
  const int steps = p.chunks * per_chunk;

  typename Tile::Acc acc;
  acc.zero();

  // k-tile s is tile s % per_chunk of chunk s / per_chunk
  auto load = [&](typename Tile::Stage& st, int s) {
    const int c = s / per_chunk;
    load_tiles<Tile>(st, p, m0, n0, c * p.kc + (s - c * per_chunk) * Tile::BK,
                     (c + 1) * p.kc);
  };

  if constexpr (NBUF == 2) {
    load(stages[0], 0);
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) {
        load(stages[(s + 1) & 1], s + 1);  // in flight under tile s
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile s visible to every warp
      Tile::mma(stages[s & 1], acc);
      __syncthreads();  // stage s & 1 free for tile s + 2
    }
  } else {
    for (int s = 0; s < steps; ++s) {
      load(stages[0], s);
      cp_async_wait<0>();
      __syncthreads();
      Tile::mma(stages[0], acc);
      __syncthreads();
    }
  }
  Tile::store(p, acc, m0, n0);
}

template <class Tile>
cudaError_t launch(const Params& p, int buffers, cudaStream_t stream) {
  const dim3 grid((p.M + Tile::BM - 1) / Tile::BM,
                  (p.N + Tile::BN - 1) / Tile::BN, 1);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (buffers == 2)
    sg_fwd_kernel<Tile, 2><<<grid, Tile::THREADS, 0, stream>>>(p);
  else
    sg_fwd_kernel<Tile, 1><<<grid, Tile::THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The tile of `dtype` (0 = float32, 1 = bfloat16): which 0 rows (BM),
// 1 columns (BN), 2 k-tile depth (BK); -1 for anything else.
extern "C" int sg_tile(int dtype, int which) {
  if (dtype == 1)
    return which == 0 ? Bf16Tile::BM : which == 1 ? Bf16Tile::BN
                                     : which == 2 ? Bf16Tile::BK : -1;
  if (dtype == 0)
    return which == 0 ? F32Tile::BM : which == 1 ? F32Tile::BN
                                    : which == 2 ? F32Tile::BK : -1;
  return -1;
}

// C = X W with K streamed in `chunks` chunks through `buffers` (1 or 2)
// shared-memory stages; dtype 0 float32, 1 bfloat16 (X, W and C alike).
// Requires K % chunks == 0, and N and K / chunks multiples of 8 (bf16) or
// 4 (f32).  Returns the launch's cudaError_t (0 on success).
extern "C" int sg_fwd(const void* x, const void* w, void* out, int dtype,
                      int M, int N, int K, int chunks, int buffers,
                      void* stream) {
  if (M < 1 || N < 1 || K < 1 || chunks < 1 || K % chunks != 0 ||
      (buffers != 1 && buffers != 2) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int per16 = dtype == 1 ? 8 : 4;
  const Params p{x, w, out, M, N, K, K / chunks, chunks};
  if (N % per16 != 0 || p.kc % per16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch<Bf16Tile>(p, buffers, s)
                          : launch<F32Tile>(p, buffers, s));
}
