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
// The design problem: the TPU kernel keeps a whole row block of C in VMEM
// (16 rows of N = 16384 in f32 are 1 MB).  A CTA on the H100 has at most
// 227 KB of shared memory and 64K registers, so no CTA holds a row.  The
// row is split across a thread-block cluster of CL CTAs (1, 2, 4, 8 or
// 16; grid = (CL, row blocks)), the paper's Fused-GEMM-distSM / distLN
// dataflow with its collective made explicit: CTA r of the cluster owns the
// columns [r ns, r ns + ns) of the cluster's row block, runs the whole K
// loop for that slice, and the row statistics are all-reduced over the
// cluster.  The tiling (cluster, rows per block BM, columns per CTA ns,
// column passes) is one that this source runs (`valid_tiling` below;
// gemm_epilogue.py::tilings states the same rule), chosen by the wrapper
// from the COMET plan (autotune.gemm_epilogue_tiling) and passed to
// ge_fwd, which refuses any other.
//
// What bounds it on this card.  At (M, N, K) = (4096, 16384, 4096) bf16
// the product is 549.8 GFLOP against 302 MB of compulsory traffic (A, B,
// the output), ~1800 FLOP per byte, far above the H100's ~295 FLOP/byte
// ridge: tensor-core operations bound it (0.556 ms at 989 TFLOP/s).  At
// the paper's small-K cloud shapes (K 64 or 128) bytes bound it, and
// keeping C out of device memory is the whole gain.  What a fused row
// epilogue costs on top is the re-reading of B: every row block reads all
// of B (its cluster's CTAs share it out), so B crosses L2 M / BM times:
// 16-row blocks would read 34.4 GB of B at the large shape.  Here, bf16:
//
//   (M, N, K)             tiling (CL, BM, ns, passes)  B from L2   A from L2
//   (4096, 16384, 4096)   16, 64, 1024, 2              8.59 GB     1.07 GB
//   (4096,  4096, 4096)   16, 128, 256, 1              1.07 GB     0.54 GB
//   (4096,  4096, 4096)   4, 64, 1024, 2               2.15 GB     0.27 GB
//   cloud (M <= 512, K <= 128)  B once per 64-128 rows: 0.26-4.2 MB
//
// (Each of the CL CTAs, and each pass, reads the block's rows of A.)  At
// (4096, 16384, 4096) the L2 reads, not the products, set the pace: the
// register and shared-memory capacity of 16 CTAs holds 64 rows of a
// 16384-wide row, not more.  launch/kernel_bench.py::gemm_l2_bytes counts
// these bytes for any shape.
//
// The bf16 path (`ge_bf16_kernel`), one CTA an SM:
// - Warp specialisation: 384 threads.  Warpgroups 0 and 1 are consumers
//   (setmaxnreg 240: 128 accumulators a thread and the epilogue), warpgroup
//   2 the producer (setmaxnreg 24), of which one thread issues every load.
//   240 x 256 + 24 x 128 registers are the 168 x 384 the launch holds.
// - The producer keeps a ring of STAGES stages full.  A stage is an A tile
//   (BM x BK, a 64- or 32-byte swizzle) and the CTA's B tile (BK x 256 or
//   512, as 64-column boxes with 128-byte swizzle), loaded by TMA
//   (cp.async.bulk.tensor) against a full and an empty mbarrier per stage.
//   The ring is as deep as shared memory allows: 8 stages of BK 32 at 128
//   rows (192 KB), 6 at 64 rows (216 KB), and 5 of BK 16 (90 KB) beside
//   the two-pass kernel's 128 KB parked tile.
//   The tensor maps are encoded by the host launcher and passed as
//   __grid_constant__ parameters; out-of-bounds rows and columns of a box
//   arrive as zeros, which is how M, N and K are ragged.
// - The consumers issue wgmma.mma_async m64n256k16, bf16 in, f32
//   accumulate, A K-major from shared memory and B MN-major (B is row-major
//   (K, N): the transpose-B form).  One wgmma group stays in flight; a
//   stage is released when the group that read it has retired.
// - The instances, by the slice ns = ceil(N / CL) rounded up to 8:
//     ns <= 256:         BM = 128, warpgroup w owns rows 64w..64w+63 of
//                        all ns columns;
//     ns <= 512:         BM = 64, warpgroup w owns columns 256w..256w+255
//                        of the 64 rows;
//     512 < ns <= 1024:  BM = 64, in two column passes of 512: the first
//                        pass's f32 tile (64 x 512, 128 KB) is parked in
//                        shared memory while the second runs in registers.
//   Any cluster of 1-16 CTAs whose slices fit an instance and all get
//   columns may run (N <= 16384 at 16 CTAs).  So B is read from L2 once
//   per 64 rows or fewer at every tiling.
//   The parked tile must stay f32: at LayerNorm rows of mean 1e3 one bf16
//   step of c is 4, against a std of about 1.
// - The epilogue: each thread reduces its two rows' values (registers and,
//   with two passes, its parked values in the same order every round),
//   then the four lanes of a quad with __shfl_xor_sync, then the
//   warpgroups through shared memory, then the CL CTAs through distributed
//   shared memory (DSMEM): every CTA writes its BM partials, cluster sync,
//   reads all CL ranks' partials with map_shared_rank in rank order (so
//   every CTA computes the same bits), and a second cluster sync keeps any
//   CTA from rewriting its partials, or exiting, while another still reads
//   them.  The producer warpgroup joins every cluster sync.  Rows past M
//   are not stored; columns past N are left out of the max (as -inf), of
//   every sum, and of the divisor, which is the true N.
// - An mbarrier wait that lasts far beyond any load traps (a launch error)
//   instead of hanging the card.
//
// The f32 path (`ge_f32_kernel`) stays on the CUDA cores without TF32 (the
// 2e-5 f32 bar): BM = 16, slices of up to 1024 columns, 8 warps each
// holding 16 rows x 128 columns of accumulators, cp.async double buffering
// of 8-deep K steps, and the same epilogue.
//
// Layout: A (M, K) row-major with rows of lda elements (lda * 2 bytes a
// multiple of 16 and A 16-byte aligned in bf16, for TMA); B (K, N)
// row-major and contiguous, 16-byte aligned, N a multiple of 8 in bf16 and
// of 4 in f32; out (M, N) contiguous.

#include <cooperative_groups.h>
#include <math.h>

#include "hopper.cuh"  // mbarriers, clusters, TMA, wgmma descriptors, the tensor-map encoder

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 16;
constexpr int F32_BM = 16;       // rows of C per cluster, f32
constexpr int F32_NT = 1024;     // most columns an f32 CTA holds
constexpr int F32_THREADS = 256;
constexpr int F32_NWARP = F32_THREADS / 32;
constexpr int BF16_THREADS = 384;  // 2 consumer warpgroups + 1 producer
constexpr int BF16_CONSUMERS = 256;

enum Epilogue { SOFTMAX = 0, LAYERNORM = 1, RMSNORM = 2 };

struct Params {
  const void* a;
  const void* b;
  const float* gamma;  // (N,) f32, or null for softmax
  const float* beta;   // (N,) f32, LayerNorm only
  void* out;
  int M, N, K;
  int lda;             // A's row length in elements (>= K)
  int ns;              // columns of a CTA's slice
  float eps;
};

struct Tiling {
  int cluster, rows, cols, passes;
};

// statistic rounds of an epilogue, each between two cluster syncs
__host__ __device__ constexpr int rounds(int epilogue) {
  return epilogue == RMSNORM ? 1 : 2;
}

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

// ------------------------------------------------------- the row epilogue
//
// A View holds a thread's values of C and knows their rows and columns:
//   ROWS                      rows a thread holds values of
//   for_each(f)               f(slot, row, column in the slice, value&)
//   allreduce<Op>(part, fin)  all-reduce the per-slot partials over the
//                             cluster; stat(row) = fin(Op over the row)
//   stat(row)

template <int EPI, class View>
__device__ __forceinline__ void row_epilogue(View& t, const Params& p,
                                             int col0, int ncols) {
  float part[View::ROWS];
  const float inv_n = 1.f / (float)p.N;
  auto set = [&](float v) {
#pragma unroll
    for (int s = 0; s < View::ROWS; ++s) part[s] = v;
  };
  if (EPI == SOFTMAX) {
    set(-INFINITY);
    t.for_each([&](int s, int r, int col, float& v) {
      if (col < ncols) part[s] = fmaxf(part[s], v);
    });
    t.template allreduce<MaxOp>(part, [](float v) { return v; });
    set(0.f);
    t.for_each([&](int s, int r, int col, float& v) {
      v = expf(v - t.stat(r));
      if (col < ncols) part[s] += v;
    });
    t.template allreduce<SumOp>(part, [](float v) { return v; });
    t.for_each([&](int s, int r, int col, float& v) { v = v / t.stat(r); });
  } else if (EPI == LAYERNORM) {
    set(0.f);
    t.for_each([&](int s, int r, int col, float& v) {
      if (col < ncols) part[s] += v;
    });
    t.template allreduce<SumOp>(part, [&](float v) { return v * inv_n; });
    set(0.f);
    t.for_each([&](int s, int r, int col, float& v) {
      v -= t.stat(r);  // centred: mean((c - mean)^2), not E[c^2] - mean^2
      if (col < ncols) part[s] += v * v;
    });
    const float eps = p.eps;
    t.template allreduce<SumOp>(
        part, [&](float v) { return rsqrtf(v * inv_n + eps); });
    t.for_each([&](int s, int r, int col, float& v) {
      if (col < ncols)
        v = v * t.stat(r) * p.gamma[col0 + col] + p.beta[col0 + col];
    });
  } else {  // RMSNORM
    set(0.f);
    t.for_each([&](int s, int r, int col, float& v) {
      if (col < ncols) part[s] += v * v;
    });
    const float eps = p.eps;
    t.template allreduce<SumOp>(
        part, [&](float v) { return rsqrtf(v * inv_n + eps); });
    t.for_each([&](int s, int r, int col, float& v) {
      if (col < ncols) v = v * t.stat(r) * p.gamma[col0 + col];
    });
  }
}

// ============================================================= bf16 path

// d (64 x 256, f32) += A (64 x 16, K-major) B (16 x 256, MN-major)
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The shape of one bf16 instance: BM rows per block, PASSES column passes.
template <int BM, int PASSES>
struct Bf16Cfg {
  // K per stage and stages in the ring: as deep as shared memory allows
  // (the two-pass ring shares it with the 128 KB parked tile, so its
  // stages are 16 deep to keep 5 of them in flight)
  static constexpr int BK = PASSES == 2 ? 16 : 32;
  // A's rows in a stage are BK * 2 bytes, its TMA and wgmma swizzle span
  // (64 bytes; 32 for BK = 16): wgmma layout 2 (64 B) or 3 (32 B), 8 rows
  // to a swizzle atom
  static constexpr int A_ROW_BYTES = BK * 2;
  static constexpr uint64_t A_LAYOUT = A_ROW_BYTES == 64 ? 2 : 3;
  static constexpr int A_SBO = 8 * A_ROW_BYTES;
  static constexpr bool SPLIT_ROWS = BM == 128;     // else split columns
  static constexpr int PASS_COLS = SPLIT_ROWS ? 256 : 512;  // per pass
  static constexpr int BOX_COLS = 64;               // a 128-byte swizzle row
  static constexpr int NBOX = PASS_COLS / BOX_COLS;
  static constexpr int BOX_BYTES = BK * BOX_COLS * 2;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = NBOX * BOX_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = PASSES == 2 ? 5 : (BM == 128 ? 8 : 6);
  static constexpr int PARK_BYTES = PASSES == 2 ? BF16_CONSUMERS * 128 * 4 : 0;
  // 1024 bytes of slack to align the ring for the 128-byte swizzle
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + PARK_BYTES;
  static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0, "alignment");
};

// Row statistics of a bf16 block: the warpgroups' partials (two when they
// split the columns), this CTA's partials (read by the whole cluster
// through DSMEM), and the cluster's statistic.
template <int BM>
struct Bf16Rows {
  float wg[2][BM];
  float cta[BM];
  float stat[BM];
};

// A consumer thread's values: 2 rows (g and g + 8 of its warp's 16) x 64
// columns in registers, in the wgmma accumulator layout (acc[4 j + e]: rows
// g + 8 (e >> 1), column 8 j + 2 tq + (e & 1) of its warpgroup's 256), and
// with two passes the first pass's 128 values parked at park[256 i].
template <int BM, int PASSES>
struct Bf16View {
  using Cfg = Bf16Cfg<BM, PASSES>;
  static constexpr int ROWS = 2;
  float (&acc)[128];
  float* park;  // this thread's parked values: park[i * 256]
  Bf16Rows<BM>& rs;
  int wg, row0, reg_col0, park_col0, g, tq;

  __device__ float stat(int row) const { return rs.stat[row]; }

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) {
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      const int s = (i >> 1) & 1;
      f(s, row0 + g + 8 * s, reg_col0 + 8 * (i >> 2) + 2 * tq + (i & 1),
        acc[i]);
    }
    if (PASSES == 2) {
#pragma unroll 4
      for (int i = 0; i < 128; ++i) {
        const int s = (i >> 1) & 1;
        float v = park[i * BF16_CONSUMERS];
        f(s, row0 + g + 8 * s, park_col0 + 8 * (i >> 2) + 2 * tq + (i & 1), v);
        park[i * BF16_CONSUMERS] = v;
      }
    }
  }

  template <class Op, class Fin>
  __device__ __forceinline__ void allreduce(float (&part)[ROWS], Fin fin) {
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {  // the quad's lanes share a row
      part[s] = Op::op(part[s], __shfl_xor_sync(0xffffffffu, part[s], 1));
      part[s] = Op::op(part[s], __shfl_xor_sync(0xffffffffu, part[s], 2));
    }
    if (tq == 0) {
      float* w = rs.wg[Cfg::SPLIT_ROWS ? 0 : wg];
      w[row0 + g] = part[0];
      w[row0 + g + 8] = part[1];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(BF16_CONSUMERS) : "memory");
    const int tid = threadIdx.x;
    if (tid < BM)  // this CTA's partials, over its warpgroups
      rs.cta[tid] = Cfg::SPLIT_ROWS ? rs.wg[0][tid]
                                    : Op::op(rs.wg[0][tid], rs.wg[1][tid]);
    cluster_sync();  // every CTA's partials are written
    if (tid < BM) {  // read them all over DSMEM, in rank order
      cg::cluster_group cluster = cg::this_cluster();
      float v = Op::id();
      const int ranks = (int)cluster.num_blocks();
      for (int r = 0; r < ranks; ++r)
        v = Op::op(v, cluster.map_shared_rank(&rs.cta[0], r)[tid]);
      rs.stat[tid] = fin(v);
    }
    // stat visible to both warpgroups; no CTA reads rs.cta any longer, so
    // it may be rewritten (next round) or its CTA may exit
    cluster_sync();
  }
};

template <int EPI, int BM, int PASSES>
__global__ void __launch_bounds__(BF16_THREADS, 1)
    ge_bf16_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b,
                   const Params p) {
  using Cfg = Bf16Cfg<BM, PASSES>;
  constexpr int S = Cfg::STAGES, BK = Cfg::BK;
  extern __shared__ unsigned char smem_bf16[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ Bf16Rows<BM> rs;
  // the ring at a 1024-byte boundary of the shared window
  unsigned char* smem =
      smem_bf16 + ((1024 - (smem_u32(smem_bf16) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int col0 = (int)rank * p.ns;
  const int ncols = max(0, min(p.ns, p.N - col0));
  const int m0 = blockIdx.y * BM;
  const int nk = (p.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx; TMA's bytes
      mbar_init(&empty[s], 2);  // each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= BF16_CONSUMERS) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == BF16_CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_b))
                   : "memory");
      int s = 0;
      uint32_t phase = 0;
      for (int pass = 0; pass < PASSES; ++pass) {
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = smem + s * Cfg::STAGE_BYTES;
          mbar_expect_tx(&full[s], Cfg::STAGE_BYTES);
          tma_load(st, &tma_a, &full[s], kt * BK, m0);
#pragma unroll
          for (int j = 0; j < Cfg::NBOX; ++j)
            tma_load(st + Cfg::A_BYTES + j * Cfg::BOX_BYTES, &tma_b, &full[s],
                     col0 + pass * Cfg::PASS_COLS + j * Cfg::BOX_COLS,
                     kt * BK);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
    for (int i = 0; i < 2 * rounds(EPI); ++i) cluster_sync();  // the epilogue's
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    float acc[128];
    float* park = reinterpret_cast<float*>(smem + S * Cfg::STAGE_BYTES) + tid;
    // this warpgroup's slice of a stage: rows (A) or columns (B)
    const uint32_t a_off = Cfg::SPLIT_ROWS ? wg * 64 * BK * 2 : 0;
    const uint32_t b_off =
        Cfg::A_BYTES + (Cfg::SPLIT_ROWS ? 0 : wg * 4 * Cfg::BOX_BYTES);
    auto release = [&](int s) {
      if (t == 0) mbar_arrive(&empty[s]);
    };
    int s = 0;
    uint32_t phase = 0;
    for (int pass = 0; pass < PASSES; ++pass) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[s], phase);
        const uint32_t st = smem_u32(smem + s * Cfg::STAGE_BYTES);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // A: +32 bytes; B: +16 rows
          wgmma_256(acc, smem_desc(st + a_off + 32 * kk, 16, Cfg::A_SBO,
                                   Cfg::A_LAYOUT),
                    smem_desc(st + b_off + 2048 * kk, Cfg::BOX_BYTES, 1024, 1));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group has retired
        fence_acc(acc);
        if (prev >= 0) release(prev);
        prev = s;
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release(prev);
      if (PASSES == 2 && pass == 0) {
#pragma unroll
        for (int i = 0; i < 128; ++i) park[i * BF16_CONSUMERS] = acc[i];
      }
    }

    const int g = lane / 4, tq = lane % 4;
    const int row0 = (Cfg::SPLIT_ROWS ? 64 * wg : 0) + 16 * warp;
    const int wg_col0 = Cfg::SPLIT_ROWS ? 0 : 256 * wg;
    Bf16View<BM, PASSES> view{acc, park, rs, wg, row0,
                              (PASSES - 1) * Cfg::PASS_COLS + wg_col0,
                              wg_col0, g, tq};
    row_epilogue<EPI>(view, p, col0, ncols);

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    auto store = [&](int col, int i, float lo, float hi) {
      const int m = m0 + row0 + g + 8 * ((i >> 1) & 1);
      if (col < ncols && m < p.M)
        *reinterpret_cast<uint32_t*>(out + (long long)m * p.N + col0 + col) =
            pack_bf16(lo, hi);
    };
#pragma unroll
    for (int i = 0; i < 128; i += 2)
      store(view.reg_col0 + 8 * (i >> 2) + 2 * tq, i, acc[i], acc[i + 1]);
    if (PASSES == 2) {
#pragma unroll 4
      for (int i = 0; i < 128; i += 2)
        store(wg_col0 + 8 * (i >> 2) + 2 * tq, i, park[i * BF16_CONSUMERS],
              park[(i + 1) * BF16_CONSUMERS]);
    }
  }
}

// ============================================================== f32 path
//
// Thread t owns columns 4 t .. 4 t + 3 of the slice for all 16 rows:
// acc[r][j] is row r, column 4 t + j.

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes (rows past K)
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

struct F32Tile {
  static constexpr int BK = 8;  // K per step
  static constexpr int SMEM =
      2 * (BK * F32_NT + BK * F32_BM) * (int)sizeof(float);

  static __device__ __forceinline__ void load_b(float* Bs, const Params& p,
                                                int k0, int col0, int ncols) {
    const float* b = static_cast<const float*>(p.b);
    const int chunks = ncols / 4;  // ncols is a multiple of 4
    for (int i = threadIdx.x; i < BK * chunks; i += F32_THREADS) {
      const int r = i / chunks, c = i % chunks;
      const bool ok = k0 + r < p.K;
      const float* src = ok ? b + (long long)(k0 + r) * p.N + col0 + c * 4 : b;
      cp_async16(Bs + r * F32_NT + c * 4, src, ok);
    }
  }

  // A tile stored K-major: As[k][row]
  static __device__ __forceinline__ float load_a(const Params& p, int m0,
                                                 int k0) {
    const int r = threadIdx.x % F32_BM, c = threadIdx.x / F32_BM;
    const float* a = static_cast<const float*>(p.a);
    return (threadIdx.x < BK * F32_BM && m0 + r < p.M && k0 + c < p.K)
               ? a[(long long)(m0 + r) * p.lda + k0 + c]
               : 0.f;
  }

  static __device__ __forceinline__ void store_a(float* As, float v) {
    if (threadIdx.x < BK * F32_BM) As[threadIdx.x] = v;  // [c][r]
  }

  static __device__ void mainloop(const Params& p, unsigned char* smem,
                                  float (&acc)[16][4], int m0, int col0,
                                  int ncols) {
    float* Bs = reinterpret_cast<float*>(smem);  // 2 buffers of BK x NT
    float* As = Bs + 2 * BK * F32_NT;            // 2 buffers of BK x BM
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
        load_b(Bs + (buf ^ 1) * BK * F32_NT, p, (s + 1) * BK, col0, ncols);
        cp_async_commit();
        a_next = load_a(p, m0, (s + 1) * BK);
      }
      if (mine) {
        const float* Ab = As + buf * BK * F32_BM;
        const float* Bb = Bs + buf * BK * F32_NT;
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          const float4 bv =
              *reinterpret_cast<const float4*>(Bb + k * F32_NT + 4 * threadIdx.x);
#pragma unroll
          for (int q = 0; q < F32_BM / 4; ++q) {
            const float4 av =
                *reinterpret_cast<const float4*>(Ab + k * F32_BM + 4 * q);
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
        store_a(As + (buf ^ 1) * BK * F32_BM, a_next);
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
    for (int r = 0; r < F32_BM; ++r)
      if (m0 + r < p.M)
        *reinterpret_cast<float4*>(out + (long long)(m0 + r) * p.N + col0 + col) =
            make_float4(c[r][0], c[r][1], c[r][2], c[r][3]);
  }
};

// Row statistics of an f32 block: per-warp partials, this CTA's partials
// (read by the whole cluster through DSMEM), and the cluster's statistic.
struct F32Rows {
  float warp[F32_NWARP][F32_BM];
  float cta[F32_BM];
  float stat[F32_BM];
};

struct F32View {
  static constexpr int ROWS = F32_BM;
  float (&c)[16][4];
  F32Rows& rs;

  __device__ float stat(int row) const { return rs.stat[row]; }

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) {
#pragma unroll
    for (int r = 0; r < F32_BM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(r, r, 4 * (int)threadIdx.x + j, c[r][j]);
  }

  template <class Op, class Fin>
  __device__ __forceinline__ void allreduce(float (&part)[ROWS], Fin fin) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int s = 0; s < ROWS; ++s)  // the warp's lanes share every row
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        part[s] = Op::op(part[s], __shfl_xor_sync(0xffffffffu, part[s], o));
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int s = 0; s < ROWS; ++s) rs.warp[threadIdx.x / 32][s] = part[s];
    }
    __syncthreads();
    if (threadIdx.x < F32_BM) {  // the CTA's partials, over its 8 warps
      float v = Op::id();
#pragma unroll
      for (int w = 0; w < F32_NWARP; ++w) v = Op::op(v, rs.warp[w][threadIdx.x]);
      rs.cta[threadIdx.x] = v;
    }
    cluster.sync();  // every CTA's partials are written
    if (threadIdx.x < F32_BM) {  // read them all over DSMEM, in rank order
      float v = Op::id();
      const int ranks = (int)cluster.num_blocks();
      for (int r = 0; r < ranks; ++r)
        v = Op::op(v, cluster.map_shared_rank(&rs.cta[0], r)[threadIdx.x]);
      rs.stat[threadIdx.x] = fin(v);
    }
    cluster.sync();  // as in Bf16View::allreduce
  }
};

// The LayerNorm instance holds one more statistic round's values than
// 128 registers a thread allow; it takes one CTA an SM instead of
// spilling.
template <int EPI>
__global__ void __launch_bounds__(F32_THREADS, EPI == LAYERNORM ? 1 : 2)
    ge_f32_kernel(const Params p) {
  __shared__ F32Rows rs;
  extern __shared__ __align__(16) unsigned char smem_f32[];

  const int col0 = blockIdx.x * p.ns;  // blockIdx.x is the cluster rank
  const int ncols = max(0, min(p.ns, p.N - col0));
  const int m0 = blockIdx.y * F32_BM;

  float c[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
  if (ncols > 0) F32Tile::mainloop(p, smem_f32, c, m0, col0, ncols);
  F32View view{c, rs};
  row_epilogue<EPI>(view, p, col0, ncols);
  F32Tile::store(p, c, m0, col0, ncols);
}

// ============================================================ the launch

template <class Kernel>
cudaError_t configure(Kernel kernel, bool& attributes_set, int smem,
                      int threads, int cluster, int row_blocks,
                      cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute* attr) {
  if (!attributes_set) {  // once per instance and process
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attributes_set = true;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster, row_blocks, 1);
  cfg.blockDim = dim3(threads, 1, 1);
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

template <int EPI, int BM, int PASSES>
cudaError_t configure_bf16(int cluster, int row_blocks, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  static bool set = false;
  return configure(ge_bf16_kernel<EPI, BM, PASSES>, set,
                   Bf16Cfg<BM, PASSES>::SMEM, BF16_THREADS, cluster,
                   row_blocks, stream, cfg, attr);
}

template <int EPI>
cudaError_t configure_f32(int cluster, int row_blocks, cudaStream_t stream,
                          cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  static bool set = false;
  return configure(ge_f32_kernel<EPI>, set, F32Tile::SMEM, F32_THREADS,
                   cluster, row_blocks, stream, cfg, attr);
}

template <int EPI, int BM, int PASSES>
cudaError_t launch_bf16(const Params& p, const Tiling& t, cudaStream_t stream) {
  using Cfg = Bf16Cfg<BM, PASSES>;
  CUtensorMap ta, tb;
  if (!encode_map(&ta, p.a, p.K, p.M, (uint64_t)p.lda * 2, Cfg::BK, BM,
                  Cfg::A_ROW_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                         : CU_TENSOR_MAP_SWIZZLE_32B) ||
      !encode_map(&tb, p.b, p.N, p.K, (uint64_t)p.N * 2, Cfg::BOX_COLS,
                  Cfg::BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure_bf16<EPI, BM, PASSES>(
      t.cluster, (p.M + BM - 1) / BM, stream, cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, ge_bf16_kernel<EPI, BM, PASSES>, ta, tb, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_f32(const Params& p, const Tiling& t, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure_f32<EPI>(t.cluster, (p.M + F32_BM - 1) / F32_BM,
                                     stream, cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, ge_f32_kernel<EPI>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch(const Params& p, const Tiling& t, int dtype,
                   cudaStream_t stream) {
  if (dtype == 0) return launch_f32<EPI>(p, t, stream);
  if (t.rows == 128) return launch_bf16<EPI, 128, 1>(p, t, stream);
  if (t.passes == 1) return launch_bf16<EPI, 64, 1>(p, t, stream);
  return launch_bf16<EPI, 64, 2>(p, t, stream);
}

template <class Kernel>
cudaError_t occupancy(Kernel kernel, cudaError_t configured,
                      cudaLaunchConfig_t& cfg, int* n) {
  if (configured != cudaSuccess) return configured;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

template <int EPI>
cudaError_t max_clusters(int dtype, int rows, int passes, int cluster, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (dtype == 0)
    return occupancy(ge_f32_kernel<EPI>,
                     configure_f32<EPI>(cluster, 1, 0, cfg, attr), cfg, n);
  if (rows == 128)
    return occupancy(ge_bf16_kernel<EPI, 128, 1>,
                     configure_bf16<EPI, 128, 1>(cluster, 1, 0, cfg, attr),
                     cfg, n);
  if (passes == 1)
    return occupancy(ge_bf16_kernel<EPI, 64, 1>,
                     configure_bf16<EPI, 64, 1>(cluster, 1, 0, cfg, attr),
                     cfg, n);
  return occupancy(ge_bf16_kernel<EPI, 64, 2>,
                   configure_bf16<EPI, 64, 2>(cluster, 1, 0, cfg, attr), cfg,
                   n);
}

bool valid_cluster(int cluster) {
  return cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
         cluster == MAX_CLUSTER;
}

// an instance of the source: f32 rows 16, bf16 rows 128 (one pass) or 64
// (one or two passes)
bool valid_instance(int dtype, int rows, int passes) {
  if (dtype == 0) return rows == F32_BM && passes == 1;
  if (dtype == 1)
    return (rows == 128 && passes == 1) ||
           (rows == 64 && (passes == 1 || passes == 2));
  return false;
}

// a tiling this source runs (gemm_epilogue.py::tilings is its Python
// copy): an instance, a cluster it is built for, the slice ceil(N /
// cluster) rounded up to 16 columns (f32) or 8 (bf16, its stores' pairs),
// which must fit the instance (two passes only for a slice one pass cannot
// hold), and columns for every CTA of the cluster
bool valid_tiling(int dtype, int N, const Tiling& t) {
  if (!valid_instance(dtype, t.rows, t.passes) || !valid_cluster(t.cluster))
    return false;
  const int align = dtype == 0 ? 16 : 8;
  const int ns = ((N + t.cluster - 1) / t.cluster + align - 1) / align * align;
  if (t.cols != ns || (long long)(t.cluster - 1) * ns >= N) return false;
  if (dtype == 0) return ns <= F32_NT;
  const int pass_cols = t.rows == 128 ? Bf16Cfg<128, 1>::PASS_COLS
                                      : Bf16Cfg<64, 1>::PASS_COLS;
  return ns > (t.passes - 1) * pass_cols && ns <= t.passes * pass_cols;
}

}  // namespace

// Dynamic shared memory of the instance for dtype, rows and passes (-1: no
// such instance).
extern "C" int ge_smem_bytes(int dtype, int rows, int passes) {
  if (!valid_instance(dtype, rows, passes)) return -1;
  if (dtype == 0) return F32Tile::SMEM;
  if (rows == 128) return Bf16Cfg<128, 1>::SMEM;
  return passes == 1 ? Bf16Cfg<64, 1>::SMEM : Bf16Cfg<64, 2>::SMEM;
}

// epilogue: 0 softmax, 1 LayerNorm, 2 RMSNorm; dtype: 0 float32, 1 bfloat16.
// a (M, K) with rows of lda elements, b (K, N), gamma/beta f32 (N,) (beta
// LayerNorm only), out (M, N).  The tiling is the wrapper's, one of
// gemm_epilogue.py::tilings: a cluster of `cluster` CTAs, `rows` rows per
// block, `cols` columns a CTA in `passes` column passes.
// Returns the launch's cudaError_t (0 on success).
extern "C" int ge_fwd(const void* a, const void* b, const void* gamma,
                      const void* beta, void* out, int epilogue, int dtype,
                      int M, int N, int K, int lda, float eps, int cluster,
                      int rows, int cols, int passes, void* stream) {
  const Tiling t{cluster, rows, cols, passes};
  if (M < 1 || N < 1 || K < 1 || lda < K || (dtype != 0 && dtype != 1) ||
      epilogue < 0 || epilogue > 2 || !valid_tiling(dtype, N, t) ||
      (M + t.rows - 1) / t.rows > 65535 || N % (dtype == 1 ? 8 : 4) != 0 ||
      (dtype == 1 && (lda % 8 != 0 || (uintptr_t)a % 16 != 0 ||
                      (uintptr_t)b % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const Params p{a, b, static_cast<const float*>(gamma),
                 static_cast<const float*>(beta), out, M, N, K, lda, t.cols,
                 eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case SOFTMAX:
      return (int)launch<SOFTMAX>(p, t, dtype, s);
    case LAYERNORM:
      return (int)launch<LAYERNORM>(p, t, dtype, s);
    default:
      return (int)launch<RMSNORM>(p, t, dtype, s);
  }
}

// cudaOccupancyMaxActiveClusters of one instance (dtype, rows, passes) at
// a cluster of `cluster` CTAs: how many such clusters the card holds at
// once (0: the cluster cannot be placed).  Returns the count, or minus the
// cudaError_t of the query.
extern "C" int ge_max_active_clusters(int epilogue, int dtype, int rows,
                                      int passes, int cluster) {
  if (!valid_cluster(cluster) || !valid_instance(dtype, rows, passes) ||
      epilogue < 0 || epilogue > 2)
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t e;
  switch (epilogue) {
    case SOFTMAX:
      e = max_clusters<SOFTMAX>(dtype, rows, passes, cluster, &n);
      break;
    case LAYERNORM:
      e = max_clusters<LAYERNORM>(dtype, rows, passes, cluster, &n);
      break;
    default:
      e = max_clusters<RMSNORM>(dtype, rows, passes, cluster, &n);
  }
  return e == cudaSuccess ? n : -(int)e;
}
