// Streamed GEMM for Hopper (sm_90a): C = X W with the contraction K streamed
// in `chunks` equal chunks, f32 and bf16 in, f32 accumulation, C in X's
// dtype.
//
// Replaces: src/repro/kernels/allgather_gemm.py, the Pallas TPU kernel
// `_kernel` (line 70) launched by `streamed_gemm` (line 124), which the
// all-gather entry `allgather_gemm` (line 166) calls with one chunk per
// source shard.  The TPU kernel DMAs chunk c of X (M, kc) and of W (kc, N)
// into one of `buffers` VMEM slots and adds their product into a whole
// (M, N) f32 accumulator in VMEM; with two slots the copy of chunk c + 1 is
// in flight while the MXU contracts chunk c (lines 85-106), with one slot
// copy and compute alternate (lines 107-119).  The pair measures how much
// of the copy hides under compute.
//
// The design problem: at the smallest shape the JAX bench drives, (M, K, N,
// chunks) = (256, 4096, 512, 8) in f32, one X slot alone is 512 KB, and the
// accumulator another 512 KB; a CTA on the H100 has at most 227 KB of shared
// memory.  So nothing here holds a whole chunk or the whole C: a CTA holds
// one output tile's accumulator in registers and streams K through it in
// k-tiles.  In both paths the K loop follows the chunk order: chunk c = 0 ..
// chunks - 1, and inside each chunk its kc columns in k-tiles of BK; the
// last k-tile of a chunk is ragged when BK does not divide kc and is filled
// with zeros; no k-tile straddles two chunks.  The chunk stays the unit of
// the stream, so that a 4-card version can make chunk c wait for its
// arrival from rank c.
//
// What bounds it on this card: at glm4-9b's MLP input projection at the
// serving prefill, (M, K, N) = (4096, 4096, 13696) bf16 with chunks = 4,
// the product is 459.6 GFLOP against 258 MB of compulsory traffic (X, W,
// C): operations bound it, 0.465 ms at 989 TFLOP/s against 0.077 ms of
// bytes at 3.35 TB/s.  What stands between a tile loop and that bound is
// the tensor cores' rate (only wgmma reaches it) and the bytes the tiling
// reads from L2: every output tile reads a BM-row panel of X and a
// BN-column panel of W, so X crosses L2 once per column tile and W once per
// row tile (launch/kernel_bench.py::streamed_l2_bytes counts them).
//
// The bf16 path (`sg_bf16_kernel`):
// - Tile 256 x 128, k-tile 64.  Warp specialisation: 384 threads.
//   Warpgroups 0 and 1 are consumers (setmaxnreg 232), each owning 128 rows
//   x 128 columns as two wgmma.mma_async m64n128k16 per 16-deep step (128
//   f32 accumulators a thread); warpgroup 2 is the producer (setmaxnreg 40),
//   one thread of which issues every TMA load.
// - Chunk-aware tensor maps: X (M, K) is encoded as a rank-3 map of dims
//   (kc, chunks, M) and W (K, N) as one of dims (N, kc, chunks), so a box
//   never leaves its chunk; columns past kc, rows past M and columns past N
//   arrive as zeros.  That is how kc, M and N are ragged, with no padding
//   copy and no masked load.  TMA wants 16-byte global strides and a
//   16-byte-aligned base: kc and N multiples of 8 (the wrapper checks it,
//   and the launcher refuses it too).  Both operands come with the 128-byte
//   swizzle: X's tile K-major (256 rows of 64 columns), W's as two
//   64-column boxes of 64 rows, wgmma's transpose-B (MN-major) form.
// - The ring: STAGES = 4 stages of 48 KB (32 KB of X, 16 KB of W), a full
//   and an empty mbarrier each; a consumer warpgroup releases a stage when
//   the wgmma group that read it has retired.  Every wait is bounded and
//   traps instead of hanging the card.
// - buffers = 2 runs all STAGES stages: the next k-tiles' loads are in
//   flight under the current one's products, which is the TPU kernel's
//   "prefetch chunk c + 1 while contracting chunk c" (lines 85-106) at the
//   granularity shared memory allows.  buffers = 1 runs a ring of depth 1:
//   the producer waits for the stage to be released before every load, and
//   the consumers retire each k-tile's products before releasing it, so
//   copies and products alternate (lines 107-119).  Both modes issue the
//   same wgmma sequence on the same tiles, so their outputs are equal bit
//   for bit.
// - Clusters of two CTAs, each unit of work two tiles that share an
//   operand by TMA multicast (Grid): a row pair, two column tiles of one row
//   tile, shares X's tile (each CTA loads 128 of its 256 rows into both, and
//   its own W), so X crosses L2 once per 256 columns; with an odd count of
//   column tiles the last column goes in column pairs, two row tiles of it
//   sharing W's tile (each CTA loads one of its two boxes into both, and its
//   own X).  Every unit costs the same, so at glm4-9b's shape the 16 x 107
//   tiles make 848 + 8 = 856 units, 13 rounds of the card's 66 clusters,
//   against 14 for row pairs alone (864 units: 53.5 pairs a row); the
//   tiling loads 3.60 GB from L2 (single CTAs 5.39 GB, column pairs
//   everywhere 4.49 GB, which measured 1.5% slower: PERF.md).  Every consumer
//   warpgroup releases a stage in both CTAs (mapa + a remote
//   mbarrier.arrive), since the peer's multicast writes into it.  With an
//   odd count of row tiles the last column pair's second tile lies past M:
//   that CTA loads its box of W, no X, computes on whatever the stage holds
//   and stores nothing.
// - A persistent grid: one cluster per slot that
//   cudaOccupancyMaxActiveClusters reports on the device, at most one a
//   unit (sg_fwd sizes it).  The row pairs run M-fastest, so a round's
//   tiles hold all of X and a few panels of W in the 50 MB L2.  The
//   producer runs ahead into the next tile while the consumers store the
//   last one.
// - The store: each consumer warpgroup writes its accumulators as bf16
//   pairs into a 64-row staging tile in shared memory (two 64-column boxes,
//   128-byte swizzle, so a warp's writes hit 32 banks), and one thread
//   stores it by TMA, which leaves out rows and columns past M and N and
//   writes whole lines asynchronously.  (Masked st.global of bf16 pairs
//   straight from the registers measured slower: PERF.md.)
//
// The f32 path (`sg_fwd_kernel<F32Tile, NBUF>`) stays on the CUDA cores
// without TF32 (the JAX test's 2e-4 / 2e-5 bar): one CTA for each 64 x 64
// tile (256 threads of 4 x 4, f32 FMAs), k-tiles of 16 through NBUF = 2
// cp.async stages (the next in flight under the current one's products,
// `cp.async.wait_group 1`) or NBUF = 1 (issue, wait, compute); rows past M,
// columns past N and the padding of a ragged k-tile are staged as zeros
// (cp.async with src-size 0), and C is stored under a mask.  At the JAX
// bench's f32 shapes (BUDGET_SHAPES of the wrapper) the bound is 0.5-16 us
// and the grid fills 8-32 of the 132 SMs: a call costs its launch and one
// CTA's serial walk over K, which is latency; split-K is later work.
//
// Layout: X (M, K), W (K, N) and C (M, N) row-major and contiguous.

#include "hopper.cuh"  // mbarriers, clusters, TMA, wgmma descriptors, the tensor-map encoder

namespace {

struct Params {
  const void* x;
  const void* w;
  void* out;
  int M, N, K;
  int kc;      // columns of a chunk: K / chunks
  int chunks;
  int depth;   // bf16: ring stages in use (buffers = 2: STAGES; 1: one)
};

// ============================================================= bf16 path

constexpr int BF16_THREADS = 384;    // 2 consumer warpgroups + 1 producer
constexpr int BF16_CONSUMERS = 256;

struct Bf16Cfg {
  static constexpr int BM = 256, BN = 128, BK = 64;
  static constexpr int STAGES = 4;
  static constexpr int CLUSTER = 2;               // CTAs sharing a tile
  static constexpr int X_HALF = BM / CLUSTER;     // rows of X's box
  static constexpr int BOX = 64;                  // columns in a 128-byte row
  static constexpr int ROW_BYTES = BOX * 2;       // of every box here
  static constexpr int X_BYTES = BM * BK * 2;     // 256 rows of 64 columns
  static constexpr int W_BOX_BYTES = BK * ROW_BYTES;  // 64 rows of 64 columns
  static constexpr int W_BYTES = (BN / BOX) * W_BOX_BYTES;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  // a consumer warpgroup stages 64 rows of C for a TMA store: two 64-column
  // boxes
  static constexpr int C_BOX_BYTES = 64 * ROW_BYTES;
  static constexpr int C_BYTES = (BN / BOX) * C_BOX_BYTES;
  // 1024 bytes of slack to align the ring for the 128-byte swizzle
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * C_BYTES;
  static_assert(BK == BOX && X_BYTES % 1024 == 0 && W_BOX_BYTES % 1024 == 0,
                "alignment");
  static_assert(BN / BOX == CLUSTER, "one W box a rank");
  static_assert(X_HALF % 8 == 0, "whole swizzle atoms a rank");
};

// d (64 x 128, f32) += A (64 x 16, K-major) B (16 x 128, MN-major: the
// transpose-B form), both from shared memory
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The tile grid of a launch, walked by clusters of two CTAs in units of two
// tiles.  Units 0 .. np tm - 1 are row pairs: row tile u % tm, column tiles
// 2 p and 2 p + 1 of p = u / tm, which share X's tile.  With an odd count of
// column tiles, the last column's tiles go in column pairs after them: row
// tiles 2 v and 2 v + 1 of unit np tm + v, which share W's tile.  Rank r of
// the cluster takes the unit's tile r.  A row pair runs M-fastest, so a
// round's tiles hold all of X and a few panels of W in the 50 MB L2.
struct Grid {
  int tm, tn, np, units;
  __host__ __device__ Grid(int M, int N)
      : tm((M + Bf16Cfg::BM - 1) / Bf16Cfg::BM),
        tn((N + Bf16Cfg::BN - 1) / Bf16Cfg::BN),
        np(tn / 2),
        units(np * tm + (tn % 2) * ((tm + 1) / 2)) {}
  // rank's tile of unit u; true if the unit shares X, false if W
  __device__ bool tile(int u, int rank, int& mi, int& ni) const {
    if (u < np * tm) {
      mi = u % tm;
      ni = 2 * (u / tm) + rank;
      return true;
    }
    mi = 2 * (u - np * tm) + rank;
    ni = tn - 1;
    return false;
  }
};

// bar.sync among the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__global__ void __launch_bounds__(BF16_THREADS, 1)
    sg_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_c, const Params p) {
  using Cfg = Bf16Cfg;
  constexpr int CL = Cfg::CLUSTER, S = Cfg::STAGES, BM = Cfg::BM,
                BN = Cfg::BN, BK = Cfg::BK;
  extern __shared__ unsigned char sg_smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  // the ring, then the two warpgroups' C staging, at a 1024-byte boundary
  // of the shared window
  unsigned char* smem = sg_smem + ((1024 - (smem_u32(sg_smem) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int rank = (int)cluster_rank();
  const Grid grid(p.M, p.N);
  const int per_chunk = (p.kc + BK - 1) / BK;  // k-tiles a chunk
  const int steps = p.chunks * per_chunk;
  const int cluster0 = blockIdx.x / CL, clusters = gridDim.x / CL;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);        // the producer's expect_tx; TMA's bytes
      mbar_init(&empty[s], 2 * CL);  // each consumer warpgroup of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // both CTAs' barriers exist before any remote arrive

  if (tid >= BF16_CONSUMERS) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == BF16_CONSUMERS) {
      prefetch_map(&tm_x);
      prefetch_map(&tm_w);
      const uint16_t both = (uint16_t)((1u << CL) - 1);
      int s = 0;
      uint32_t phase = 0;
      for (int u = cluster0; u < grid.units; u += clusters) {
        int mi, ni;
        const bool share_x = grid.tile(u, rank, mi, ni);
        // a row tile past M (a column pair's second) loads no X, and
        // nothing waits for it
        const bool x_in = mi < grid.tm;
        const uint32_t bytes = (x_in ? Cfg::X_BYTES : 0) + Cfg::W_BYTES;
        for (int c = 0; c < p.chunks; ++c) {
          for (int kt = 0; kt < per_chunk; ++kt) {
            mbar_wait(&empty[s], phase ^ 1);
            unsigned char* st = smem + s * Cfg::STAGE_BYTES;
            unsigned char* wt = st + Cfg::X_BYTES;
            mbar_expect_tx(&full[s], bytes);
            const int k = kt * BK;  // within chunk c
            if (share_x) {  // half `rank` of X's tile to both; W's own
              tma_load_3d_multicast(st + rank * Cfg::X_HALF * Cfg::ROW_BYTES,
                                    &tm_x, &full[s], k, c,
                                    mi * BM + rank * Cfg::X_HALF, both);
#pragma unroll
              for (int b = 0; b < CL; ++b)
                tma_load_3d(wt + b * Cfg::W_BOX_BYTES, &tm_w, &full[s],
                            ni * BN + b * Cfg::BOX, k, c);
            } else {  // X's own; box `rank` of W's tile to both
              if (x_in) {
#pragma unroll
                for (int h = 0; h < CL; ++h)
                  tma_load_3d(st + h * Cfg::X_HALF * Cfg::ROW_BYTES, &tm_x,
                              &full[s], k, c, mi * BM + h * Cfg::X_HALF);
              }
              tma_load_3d_multicast(wt + rank * Cfg::W_BOX_BYTES, &tm_w,
                                    &full[s], ni * BN + rank * Cfg::BOX, k, c,
                                    both);
            }
            if (++s == p.depth) {
              s = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    __syncwarp();
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128, t = tid % 128;
    const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
    // acc[h][4 j + e]: row 128 wg + 64 h + 16 warp + g + 8 (e >> 1) of the
    // tile, column 8 j + 2 tq + (e & 1)
    float acc[2][64];
    const uint32_t a_off = wg * 128 * Cfg::ROW_BYTES;  // this warpgroup's rows
    unsigned char* c_stage = smem + S * Cfg::STAGE_BYTES + wg * Cfg::C_BYTES;
    if (t == 0) prefetch_map(&tm_c);
    auto release = [&](int s) {  // in both CTAs
      if (t < CL) mbar_arrive_cluster(&empty[s], t);
    };
    int s = 0;
    uint32_t phase = 0;
    for (int u = cluster0; u < grid.units; u += clusters) {
      int mi, ni;
      grid.tile(u, rank, mi, ni);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
      int prev = -1;
      for (int step = 0; step < steps; ++step) {
        mbar_wait(&full[s], phase);
        const uint32_t st = smem_u32(smem + s * Cfg::STAGE_BYTES);
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {  // X: +32 bytes; W: +16 rows
          const uint64_t db = smem_desc(st + Cfg::X_BYTES + 16 * Cfg::ROW_BYTES * kk,
                                        Cfg::W_BOX_BYTES, 8 * Cfg::ROW_BYTES, 1);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_128(acc[h],
                      smem_desc(st + a_off + h * 64 * Cfg::ROW_BYTES + 32 * kk,
                                16, 8 * Cfg::ROW_BYTES, 1),
                      db);
        }
        wgmma_commit();
        if (p.depth > 1) {
          wgmma_wait<1>();  // the previous stage's group has retired
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          if (prev >= 0) release(prev);
          prev = s;
        } else {  // one stage: retire this k-tile before the next load
          wgmma_wait<0>();
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          release(s);
        }
        if (++s == p.depth) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (prev >= 0) release(prev);
      if (mi >= grid.tm) continue;  // a column pair's spare tile
      // C through shared memory, 64 rows at a time: bf16 pairs into the
      // staging boxes (the 128-byte swizzle: 16-byte group j % 8 of row r
      // lands at group (j % 8) ^ (r % 8)), then one thread stores both boxes
      // by TMA
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (t == 0) bulk_wait_read<0>();  // the last store has read the staging
        warpgroup_sync(wg);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;  // row % 8 == g
            *reinterpret_cast<uint32_t*>(
                c_stage + (j / 8) * Cfg::C_BOX_BYTES + row * Cfg::ROW_BYTES +
                (((j % 8) ^ g) << 4) + 4 * tq) =
                pack_bf16(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
          }
        fence_proxy_async();
        warpgroup_sync(wg);
        if (t == 0) {
#pragma unroll
          for (int b = 0; b < BN / Cfg::BOX; ++b)
            tma_store_2d(&tm_c, c_stage + b * Cfg::C_BOX_BYTES,
                         ni * BN + b * Cfg::BOX, mi * BM + wg * 128 + h * 64);
          bulk_commit();
        }
      }
    }
    if (t == 0) bulk_wait<0>();  // C written before the CTA exits
  }
  // no CTA may exit while its peer can still multicast into it or arrive
  // on its barriers
  cluster_sync();
}

// ============================================================== f32 path

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

// ============================================================ the launch

cudaError_t launch_f32(const Params& p, int buffers, cudaStream_t stream) {
  const dim3 grid((p.M + F32Tile::BM - 1) / F32Tile::BM,
                  (p.N + F32Tile::BN - 1) / F32Tile::BN, 1);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (buffers == 2)
    sg_fwd_kernel<F32Tile, 2><<<grid, F32Tile::THREADS, 0, stream>>>(p);
  else
    sg_fwd_kernel<F32Tile, 1><<<grid, F32Tile::THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

void configure_bf16(int ctas, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                    cudaLaunchAttribute* attr) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(BF16_THREADS, 1, 1);
  cfg.dynamicSmemBytes = Bf16Cfg::SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Bf16Cfg::CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// The bf16 kernel's clusters the current device holds at once (0: a
// cluster cannot be placed), after raising its shared-memory limit there;
// each device is asked once.  Returns the count, or minus the cudaError_t.
int bf16_slots() {
  constexpr int DEVICES = 64;
  static int known[DEVICES];  // a device's count + 1; 0 until asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < DEVICES && known[dev] > 0) return known[dev] - 1;
  e = cudaFuncSetAttribute(sg_bf16_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Bf16Cfg::SMEM);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure_bf16(Bf16Cfg::CLUSTER, 0, cfg, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, sg_bf16_kernel, &cfg);
  if (e != cudaSuccess) return -(int)e;
  if (dev < DEVICES) known[dev] = n + 1;
  return n;
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using Cfg = Bf16Cfg;
  const int slots = bf16_slots();
  if (slots < 0) return (cudaError_t)-slots;
  if (slots == 0) return cudaErrorInvalidConfiguration;
  const Grid grid(p.M, p.N);
  const int ctas = (slots < grid.units ? slots : grid.units) * Cfg::CLUSTER;
  // X (M, K) as (kc, chunks, M) and W (K, N) as (N, kc, chunks): a box
  // never leaves its chunk
  const cuuint64_t xd[3] = {(cuuint64_t)p.kc, (cuuint64_t)p.chunks,
                            (cuuint64_t)p.M};
  const cuuint64_t xs[2] = {(cuuint64_t)p.kc * 2, (cuuint64_t)p.K * 2};
  const cuuint32_t xb[3] = {Cfg::BOX, 1, Cfg::X_HALF};
  const cuuint64_t wd[3] = {(cuuint64_t)p.N, (cuuint64_t)p.kc,
                            (cuuint64_t)p.chunks};
  const cuuint64_t ws[2] = {(cuuint64_t)p.N * 2, (cuuint64_t)p.kc * p.N * 2};
  const cuuint32_t wb[3] = {Cfg::BOX, Cfg::BK, 1};
  CUtensorMap tx, tw, tc;
  if (!encode_tiled(&tx, p.x, 3, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tiled(&tw, p.w, 3, wd, ws, wb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tc, p.out, p.N, p.M, (uint64_t)p.N * 2, Cfg::BOX, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure_bf16(ctas, stream, cfg, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, sg_bf16_kernel, tx, tw, tc, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The tile of `dtype` (0 = float32, 1 = bfloat16): which 0 rows (BM),
// 1 columns (BN), 2 k-tile depth (BK), 3 CTAs of a cluster along M; -1 for
// anything else.
extern "C" int sg_tile(int dtype, int which) {
  if (dtype == 1)
    return which == 0   ? Bf16Cfg::BM
           : which == 1 ? Bf16Cfg::BN
           : which == 2 ? Bf16Cfg::BK
           : which == 3 ? Bf16Cfg::CLUSTER
                        : -1;
  if (dtype == 0)
    return which == 0   ? F32Tile::BM
           : which == 1 ? F32Tile::BN
           : which == 2 ? F32Tile::BK
           : which == 3 ? 1
                        : -1;
  return -1;
}

// cudaOccupancyMaxActiveClusters of the bf16 kernel on the current device:
// how many of its clusters the card holds at once (0: a cluster cannot be
// placed).  Returns the count, or minus the cudaError_t.
extern "C" int sg_max_active_clusters() { return bf16_slots(); }

// C = X W with K streamed in `chunks` chunks; dtype 0 float32, 1 bfloat16
// (X, W and C alike).  buffers 2 keeps the next k-tiles' loads in flight
// under the current products, 1 alternates them.  bf16 runs a persistent
// grid of one cluster per slot of the current device, at most one a unit of
// tiles (Grid); f32 takes a CTA a 64 x 64 tile.  Requires K % chunks == 0,
// and N and K / chunks multiples of 8 (bf16, with x, w and out 16-byte
// aligned for TMA) or 4 (f32).  Returns the launch's cudaError_t (0 on
// success).
extern "C" int sg_fwd(const void* x, const void* w, void* out, int dtype,
                      int M, int N, int K, int chunks, int buffers,
                      void* stream) {
  if (M < 1 || N < 1 || K < 1 || chunks < 1 || K % chunks != 0 ||
      (buffers != 1 && buffers != 2) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int per16 = dtype == 1 ? 8 : 4;
  const Params p{x, w, out, M, N, K, K / chunks, chunks,
                 buffers == 2 ? Bf16Cfg::STAGES : 1};
  if (N % per16 != 0 || p.kc % per16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(p, buffers, s);
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0 ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bf16(p, s);
}
