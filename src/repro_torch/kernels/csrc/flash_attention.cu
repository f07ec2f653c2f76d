// FlashAttention forward for Hopper (sm_90a), GQA, bf16 and f32.
//
// Replaces: src/repro/kernels/flash_attention.py, the Pallas TPU kernel
// `_fa_kernel` (line 35) launched by `flash_attention_fwd` (line 95).
// It computes the same function, softmax(scale * Q K^T + mask) V, with
// online softmax in f32, three masks (padded keys; causal with q aligned to
// the end of the kv axis, offset Skv - Sq; sliding window) and the kv head
// of q head h being h / (Hq / Hkv).  It differs from `_fa_kernel` in one
// place on purpose: a row that sees no key gives 0, as the reference
// `attention_ref` does, where `_fa_kernel`'s finite -1e30 mask gives the
// mean of V over the block.
//
// Translation: the TPU kernel walks a sequential grid axis over K/V blocks
// and carries (m, l, acc) in VMEM scratch between grid steps.  Here a
// consumer warpgroup loops over the K/V tiles itself and keeps (m, l, acc)
// in registers.  Tiles strictly above the causal diagonal, and tiles
// wholly behind the window, are never loaded.
//
// What bounds it on this card: at glm4-9b's prefill shape (q 4x32x1024x128,
// k/v 4x2x1024x128, bf16, causal) the work is about 34 GFLOP against about
// 71 MB of compulsory traffic (q, k, v and o once each), ~480 FLOP per
// byte, above the H100's ~295 FLOP/byte ridge: tensor-core operations bound
// it (0.0348 ms at 989 TFLOP/s).  Two more floors sit below: the K/V tiles
// each CTA reads through L2 (every q head of a GQA group needs the same
// tiles; launch/kernel_bench.py::attention_l2_bytes counts them), and ~75 M
// exponentials on the MUFU unit (16 a clock an SM, about half the
// tensor-core time), which must run under the products.  The bf16 path
// (`fa_fwd_bf16`):
//
// - Persistent and warp-specialised: one CTA of 384 threads an SM walks
//   work items, longest (last causal q tile) first.  Warpgroups 0 and 1
//   are consumers (setmaxnreg 232), warpgroup 2 the producer (setmaxnreg
//   40), of which one thread issues every load.
// - K/V shared across q heads: an item is (batch, kv head, a pair of q
//   heads of its group, a 64-row q tile), and consumer warpgroup w owns
//   q head 2 pair + w.  Both heads read each K/V tile from shared memory,
//   which halves the K/V traffic through L2 against one head a CTA.  A
//   group of odd size (1 included) takes one head an item, 128 rows of it:
//   warpgroup w owns q rows 64 w .. 64 w + 63.  Either way each K/V tile
//   serves 128 q rows.  The wrapper's rule (flash_attention.py::tiling)
//   picks the form, the items and the grid; `fa_fwd` checks only that this
//   source has the instance.
// - The producer loads the item's two q tiles (once the last item's are
//   read) and K/V tiles of 128 keys into a ring of STAGES stages (3 at D
//   128, 6 at 64, 8 below), by TMA (cp.async.bulk.tensor) over rank-4
//   tensor maps (D, S, H, B) of the real strides, so the model's (B, S, H,
//   D) projections are read in place and rows past Sq or Skv arrive as
//   zeros without reaching the next head.  Each stage has a full barrier
//   for K, one for V (so Q K^T starts before V lands) and an empty barrier
//   each consumer warp arrives on once it is done with both.
// - Both products on wgmma, bf16 in, f32 accumulate.  S = Q K^T is
//   m64n128k16 with Q and K K-major from shared memory.  O += P V takes P
//   from registers: exp2(S - max) is rounded to bf16, and the accumulator
//   layout of S is wgmma's register layout for A.  V is row-major (keys,
//   D), MN-major for B: the transpose-B form.  Rows are swizzled by their
//   bytes: 32 B at D 16, 64 B at D 32, 128 B at D 64; D 128 comes as two
//   64-column boxes with the 128-byte swizzle.
// - Tile i's S is issued together with tile i - 1's P V, so P V runs under
//   the softmax of S_i, and the other warpgroup's products under both.
//   ptxas has to be kept from undoing that: it hoists a plain
//   wgmma.wait_group 0 above the exponentials (wgmma_wait0_after), and it
//   hands P's registers to the softmax once the P V wgmma is issued,
//   waiting for P V to free them (the `keep` read of the old P).  A ping-
//   pong of the two warpgroups on named barriers measured slower and is
//   not used.
// - A consumer thread holds S (64 f32 at 128 keys), P (32) and O (64 at D
//   128) within the 232 registers setmaxnreg grants it; Q stays in shared
//   memory (holding it in registers measured no faster).
// - Softmax in log2 units (the scale folded into one multiply), exp2 on
//   the MUFU unit; the masks are evaluated only on a tile that straddles
//   the diagonal, the window's edge or Skv, as two compares against
//   per-row bounds.  A row's sum stays per thread over its columns and is
//   reduced over the quad only at the end.
// - An mbarrier wait that lasts far beyond any load traps (a launch error)
//   instead of hanging the card.
//
// The f32 path (`fa_fwd_f32`) runs the products as f32 FMAs on the CUDA
// cores (no TF32) so that it holds the 2e-5 f32 tolerance: one CTA of 64
// threads per 64 q rows of one (batch, q head), 64-key tiles.
//
// Layout: q/k/v are read through their (batch, head, seq) strides with a
// unit stride on the head dim (bf16: 16-byte aligned base and strides, for
// TMA); the output is contiguous (B, Hq, Sq, D).

#include <math.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors, the tensor-map encoder

namespace {

constexpr int FA_THREADS = 384;    // 2 consumer warpgroups + 1 producer
constexpr int FA_CONSUMERS = 256;
constexpr int F32_BQ = 64;         // f32: q rows per CTA
constexpr int F32_BK = 64;         // f32: keys per K/V tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Hq, Hkv, Sq, Skv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
  int causal;
  int window;  // < 0: no window
  int heads;   // bf16: q heads a CTA, 2 (a pair of one group) or 1
};

// The tiling the wrapper hands over (flash_attention.py::tiling).
struct Tiling {
  int q_rows, keys, heads, stages, grid_x, grid_y;
};

// Range [t_lo, t_hi) of `bk`-key tiles that hold a key visible to some row
// of the q rows [q0, q0 + rows).
__device__ __forceinline__ void tile_range(const Params& p, int q0, int rows,
                                           int bk, int& t_lo, int& t_hi) {
  const int nk = (p.Skv + bk - 1) / bk;
  const int off = p.Skv - p.Sq;
  const int q_first = q0 + off;
  const int q_last = min(q0 + rows, p.Sq) - 1 + off;
  t_lo = 0;
  t_hi = nk;
  if (p.causal) t_hi = q_last < 0 ? 0 : min(nk, q_last / bk + 1);
  if (p.window >= 0) {
    const int k_first = q_first - p.window + 1;
    if (k_first > 0) t_lo = min(k_first / bk, nk);
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  return kp < p.Skv && (!p.causal || qp >= kp) &&
         (p.window < 0 || qp - kp < p.window);
}

// ============================================================= bf16 path

// d (64 x 128, f32) (+)= A (64 x 16, K-major) B (16 x 128, K-major), both
// from shared memory; scale_d 0 starts the sum
__device__ __forceinline__ void wgmma_ss_128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, registers) B (16 x N, MN-major: the
// transpose-B form) from shared memory
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

constexpr int SMEM_LIMIT = 232448 - 1024;  // a CTA's, less the static barriers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 40 x 128 + 232 x 256
                                                        // = 168 x 384

template <int D>
struct FaCfg {
  static constexpr int BQ = 64;    // q rows of a consumer warpgroup
  static constexpr int BKV = 128;  // keys of a K/V tile
  // a TMA box is one swizzle row wide: D columns, at most 64 (128 bytes)
  static constexpr int BOX = D < 64 ? D : 64;
  static constexpr int ROW_BYTES = 2 * BOX;
  static constexpr int NBOX = D / BOX;
  static constexpr uint64_t SWIZZLE = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  static constexpr int SBO = 8 * ROW_BYTES;  // 8 rows to a swizzle atom
  static constexpr int Q_BOX_BYTES = BQ * ROW_BYTES;
  static constexpr int Q_BYTES = NBOX * Q_BOX_BYTES;    // one head's q tile
  static constexpr int KV_BOX_BYTES = BKV * ROW_BYTES;
  static constexpr int KV_BYTES = NBOX * KV_BOX_BYTES;  // a K or a V tile
  // the ring as deep as shared memory allows beside the two q tiles, at
  // most 8 stages
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 2 * Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "alignment");

  // K-major operand (Q or K) at k-step kk (16 columns of D): its box, and
  // the step's 32 bytes in the swizzled row
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base,
                                                    int box_bytes, int kk) {
    return smem_desc(base + (16 * kk / BOX) * box_bytes + (16 * kk % BOX) * 2,
                     16, SBO, SWIZZLE);
  }
  // V, MN-major, at k-step kk (16 keys): the next 64-column box of D is
  // one box further (the leading byte offset), 8 key rows one atom
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return smem_desc(base + 16 * kk * ROW_BYTES, KV_BOX_BYTES, SBO, SWIZZLE);
  }
};

// wgmma.wait_group 0, placed after the softmax: ptxas hoists a plain wait
// to the top of its basic block, above the exponentials, which would then
// wait for the P V products instead of running under them.  The wait is
// predicated on the row sums, so it follows all of them.  The predicate is
// always true: each exponential is at most 1, so a row sum is at most 64
// (or NaN) and the sum of the two rows' bit patterns is never that of
// -1.0f.
__device__ __forceinline__ void wgmma_wait0_after(const float (&rsum)[2]) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 t;\n"
      "add.u32 t, %0, %1;\n"
      "setp.ne.u32 p, t, 0xBF800000;\n"
      "@p wgmma.wait_group.sync.aligned 0;\n}\n" ::"r"(__float_as_uint(rsum[0])),
      "r"(__float_as_uint(rsum[1]))
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One work item: (batch, kv head, pair, q tile); consumer warpgroup w owns
// q head h0 + w dh from row q0 + w dq, and the item's K/V tiles [lo, hi)
// are those of both warpgroups (a tile outside one warpgroup's own range is
// wholly masked for it).  Items are numbered longest first: item u is q
// tile (last - u / nx) of x = u % nx, x = (batch, kv head, pair).
struct Item {
  int b, hk, h0, dh, q0, dq, lo, hi;
};

template <int BQ, int BKV>
__device__ __forceinline__ Item item_of(const Params& p, int u) {
  Item it;
  const int group = p.Hq / p.Hkv;
  const int pairs = group / p.heads;
  const int nx = p.B * p.Hkv * pairs;
  const int x = u % nx;
  const int pair = x % pairs;
  it.hk = (x / pairs) % p.Hkv;
  it.b = x / pairs / p.Hkv;
  const int rows = BQ * 2 / p.heads;  // q rows of the item a head
  const int nqt = (p.Sq + rows - 1) / rows;
  it.q0 = (nqt - 1 - u / nx) * rows;
  it.h0 = it.hk * group + (p.heads == 2 ? 2 * pair : pair);
  it.dh = p.heads == 2 ? 1 : 0;
  it.dq = p.heads == 2 ? 0 : BQ;
  tile_range(p, it.q0, rows, BKV, it.lo, it.hi);
  return it;
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
    fa_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const Params p,
                const int items) {
  using Cfg = FaCfg<D>;
  constexpr int S = Cfg::STAGES, BQ = Cfg::BQ, BKV = Cfg::BKV;
  extern __shared__ unsigned char fa_smem[];
  __shared__ __align__(8) uint64_t full_k[S], full_v[S], empty[S], q_full,
      q_empty;
  // the tiles at a 1024-byte boundary of the shared window: the item's
  // two q tiles (one a consumer warpgroup), then the K and V rings
  unsigned char* smem = fa_smem + ((1024 - (smem_u32(fa_smem) & 1023)) & 1023);
  unsigned char* q_tiles = smem;
  unsigned char* k_tiles = smem + 2 * Cfg::Q_BYTES;
  unsigned char* v_tiles = k_tiles + S * Cfg::KV_BYTES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);  // the producer's expect_tx; TMA's bytes
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], FA_CONSUMERS / 32);  // each consumer warp
    }
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, FA_CONSUMERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= FA_CONSUMERS) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == FA_CONSUMERS) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      int s = 0, nq = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < items; u += gridDim.x) {
        const Item it = item_of<BQ, BKV>(p, u);
        if (it.lo >= it.hi) continue;
        // both q tiles, once the last item's are read (a q tile past Sq
        // arrives as zeros)
        mbar_wait(&q_empty, (nq++ & 1) ^ 1);
        mbar_expect_tx(&q_full, 2 * Cfg::Q_BYTES);
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
          for (int bx = 0; bx < Cfg::NBOX; ++bx)
            tma_load_4d(q_tiles + w * Cfg::Q_BYTES + bx * Cfg::Q_BOX_BYTES,
                        &tm_q, &q_full, bx * Cfg::BOX, it.q0 + w * it.dq,
                        it.h0 + w * it.dh, it.b);
        for (int j = it.lo; j < it.hi; ++j) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full_k[s], Cfg::KV_BYTES);
#pragma unroll
          for (int bx = 0; bx < Cfg::NBOX; ++bx)
            tma_load_4d(k_tiles + s * Cfg::KV_BYTES + bx * Cfg::KV_BOX_BYTES,
                        &tm_k, &full_k[s], bx * Cfg::BOX, j * BKV, it.hk,
                        it.b);
          mbar_expect_tx(&full_v[s], Cfg::KV_BYTES);
#pragma unroll
          for (int bx = 0; bx < Cfg::NBOX; ++bx)
            tma_load_4d(v_tiles + s * Cfg::KV_BYTES + bx * Cfg::KV_BOX_BYTES,
                        &tm_v, &full_v[s], bx * Cfg::BOX, j * BKV, it.hk,
                        it.b);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int off = p.Skv - p.Sq;
  const float sl2 = p.scale * 1.4426950408889634f;
  const uint32_t q_addr = smem_u32(q_tiles + w * Cfg::Q_BYTES);

  // o[4 j + e]: rows g + 8 (e >> 1) of the warp's 16, column 8 j + 2 tq +
  // (e & 1); sc likewise over the tile's keys; pf the bf16 pairs of P as
  // the A fragments of P V, 4 a 16-key step
  float o[D / 2], sc[BKV / 2];
  uint32_t pf[BKV / 4];
#pragma unroll
  for (int i = 0; i < BKV / 4; ++i) pf[i] = 0u;
  float m[2], l[2], alpha[2], rsum[2];
  int q0 = 0, qp = 0, q_last = 0;

  auto issue_s = [&](int s) {  // S = Q K^T, one wgmma group
    const uint32_t k_addr = smem_u32(k_tiles + s * Cfg::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_128(sc, Cfg::kmajor(q_addr, Cfg::Q_BOX_BYTES, kk),
                   Cfg::kmajor(k_addr, Cfg::KV_BOX_BYTES, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int s) {  // O += P V, one wgmma group
    const uint32_t v_addr = smem_u32(v_tiles + s * Cfg::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      WgmmaRS<D>::run(o, &pf[4 * kk], Cfg::mnmajor(v_addr, kk));
    wgmma_commit();
  };
  // S of tile j -> exp2(S - max) in place: mask (only a tile that
  // straddles the diagonal, the window's edge or Skv), log2 units, the
  // running max; alpha rescales what came before, rsum is this tile's sum.
  // Maxima and sums run over 4 interleaved partials a row, for short
  // dependency chains.
  auto softmax = [&](int j) {
    const int k0 = j * BKV;
    const bool masked = k0 + BKV > p.Skv ||
                        (p.causal && k0 + BKV - 1 > q0 + off) ||
                        (p.window >= 0 && q_last - k0 >= p.window);
    float mx4[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int a = 0; a < 4; ++a) mx4[r][a] = a == 0 ? m[r] : -INFINITY;
    if (masked) {
      // row r sees keys [first, last]; element i's key is k0 + 2 tq +
      // 8 (i >> 2) + (i & 1), so compare that constant with the bounds
      // moved into this thread's columns
      int c_lo[2], c_hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = qp + 8 * r;
        int last = p.Skv - 1, first = 0;
        if (p.causal) last = min(last, pos);
        if (p.window >= 0) first = pos - p.window + 1;
        c_lo[r] = first - k0 - 2 * tq;
        c_hi[r] = last - k0 - 2 * tq;
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int c = 8 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
        sc[i] = c >= c_lo[r] && c <= c_hi[r] ? sc[i] * sl2 : -INFINITY;
        mx4[r][(i >> 2) & 3] = fmaxf(mx4[r][(i >> 2) & 3], sc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] *= sl2;
        mx4[r][(i >> 2) & 3] = fmaxf(mx4[r][(i >> 2) & 3], sc[i]);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      base[r] = mx == -INFINITY ? 0.f : mx;  // no visible key yet
      alpha[r] = ex2(m[r] - base[r]);
      m[r] = mx;
    }
    float rs4[2][4] = {};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(sc[i] - base[r]);
      rs4[r][(i >> 2) & 3] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rsum[r] = (rs4[r][0] + rs4[r][1]) + (rs4[r][2] + rs4[r][3]);
  };
  // after the P V group that read pf has retired: rescale, then P -> pf.
  // The new pf also reads the old one (under `keep`, 0 at run time): the
  // old pf stays live in the register allocator until here, so it does not
  // hand pf's registers to the softmax and wait for P V to free them.
  const uint32_t keep = (uint32_t)p.Sq >> 31;
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < BKV / 2; i += 2)
      pf[i / 2] = pack_bf16(sc[i], sc[i + 1]) ^ (pf[i / 2] & keep);
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int s = 0, nq = 0;  // ring stage and q tile uses, as the producer's
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < items; u += gridDim.x) {
    const Item it = item_of<BQ, BKV>(p, u);
    q0 = it.q0 + w * it.dq;
    const int h = it.h0 + w * it.dh;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                        ((long long)it.b * p.Hq + h) * p.Sq * D;
    if (it.lo >= it.hi) {  // no key visible to any row: the output is 0
      for (int i = t; i < BQ * D / 2; i += 128) {
        const int qi = q0 + i / (D / 2);
        if (qi < p.Sq)
          reinterpret_cast<uint32_t*>(og + (long long)qi * D)[i % (D / 2)] = 0u;
      }
      continue;
    }
    qp = q0 + 16 * warp + g + off;  // position of row g; g + 8: +8
    q_last = min(q0 + BQ, p.Sq) - 1 + off;
    mbar_wait(&q_full, nq++ & 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;  // running max, log2 units
    l[0] = l[1] = 0.f;        // running sum, this thread's columns

    // tile 0: S alone
    const int n = it.hi - it.lo;
    mbar_wait(&full_k[s], phase);
    wgmma_fence();
    issue_s(s);
    wgmma_wait<0>();
    fence_acc(sc);
    if (n == 1) release(&q_empty);  // the q tiles' last read
    softmax(it.lo);
    rescale_and_pack();
    int s_prev = s;  // the stage of tile i - 1
    uint32_t phase_prev = phase;
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
    // tiles 1 .. n - 1: S_i = Q K_i^T is issued with the previous tile's
    // P V, so P V runs on the tensor cores under this warpgroup's softmax
    // of S_i (and the other warpgroup's products run under it too)
    for (int i = 1; i < n; ++i) {
      mbar_wait(&full_k[s], phase);
      mbar_wait(&full_v[s_prev], phase_prev);
      fence_acc(o);
      wgmma_fence();
      issue_s(s);
      issue_pv(s_prev);
      wgmma_wait<1>();  // S_i has retired; P V may still run
      fence_acc(sc);
      if (i == n - 1) release(&q_empty);
      softmax(it.lo + i);
      wgmma_wait0_after(rsum);
      fence_acc(o);
      fence_regs(pf);
      release(&empty[s_prev]);
      rescale_and_pack();
      s_prev = s;
      phase_prev = phase;
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    // the last tile's P V
    mbar_wait(&full_v[s_prev], phase_prev);
    fence_acc(o);
    wgmma_fence();
    issue_pv(s_prev);
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pf);
    release(&empty[s_prev]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no visible key -> 0
      const int qi = q0 + 16 * warp + g + 8 * r;
      if (qi < p.Sq) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(og + (long long)qi * D + 8 * i +
                                       2 * tq) =
              pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      }
    }
  }
}

// -------------------------------------------------------------- f32 path

// 64 threads: thread i owns q row i of the CTA's tile.
template <int D>
__global__ void __launch_bounds__(64) fa_fwd_f32(const Params p) {
  constexpr int BQ = F32_BQ, BK = F32_BK;
  constexpr int LDQ = D + 1;  // odd pitch: row-per-thread reads miss no bank
  extern __shared__ float smf[];
  float* Qs = smf;             // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;   // BK x D
  float* Vs = Ks + BK * D;     // BK x D
  float* St = Vs + BK * D;     // BK x BQ, scores of key j for row i at j*BQ+i

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int t_lo, t_hi;
  tile_range(p, q0, BQ, BK, t_lo, t_hi);
  const int tid = threadIdx.x;
  for (int i = tid; i < BQ * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    Qs[r * LDQ + c] = q0 + r < p.Sq ? qg[(q0 + r) * p.q_ss + c] : 0.f;
  }

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qp = q0 + tid + (p.Skv - p.Sq);

  for (int t = t_lo; t < t_hi; ++t) {
    __syncthreads();  // Q staged / previous tile consumed
    for (int i = tid; i < BK * D; i += blockDim.x) {
      const int r = i / D, c = i % D, kr = t * BK + r;
      Ks[i] = kr < p.Skv ? kg[kr * p.k_ss + c] : 0.f;
      Vs[i] = kr < p.Skv ? vg[kr * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float mx = m;
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) d = fmaf(Qs[tid * LDQ + c], Ks[j * D + c], d);
      const float x = visible(p, qp, t * BK + j) ? d * p.scale : -INFINITY;
      St[j * BQ + tid] = x;
      mx = fmaxf(mx, x);
    }
    const float base = mx == -INFINITY ? 0.f : mx;  // no visible key yet
    const float alpha = expf(m - base);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float pj = expf(St[j * BQ + tid] - base);
      l += pj;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(pj, Vs[j * D + c], acc[c]);
    }
  }

  const int qi = q0 + tid;
  if (qi < p.Sq) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no visible key -> 0
    float* og = static_cast<float*>(p.o) + ((long long)bh * p.Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) og[c] = acc[c] * inv;
  }
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, bool& set, int smem) {
  if (set) return cudaSuccess;  // once per instance and process
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  set = e == cudaSuccess;
  return e;
}

// The rank-4 bf16 map (D, S, H, B) of a (B, H, S, D) tensor with these
// element strides, in boxes of `box_rows` rows of one head.
template <int D>
bool encode_qkv(CUtensorMap* map, const void* ptr, int B, int H, int S,
                long long sb, long long sh, long long ss, int box_rows) {
  using Cfg = FaCfg<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Cfg::BOX, (cuuint32_t)box_rows, 1, 1};
  const CUtensorMapSwizzle swizzle =
      Cfg::ROW_BYTES == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : Cfg::ROW_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled(map, ptr, 4, dims, strides, box, swizzle);
}

// Work items of the bf16 kernel: (batch, kv head, pair of heads or one
// head) x q tiles of 128 / heads rows.
long long bf16_items(const Params& p, int heads) {
  const int rows = 128 / heads;
  return (long long)p.B * p.Hkv * (p.Hq / p.Hkv / heads) *
         ((p.Sq + rows - 1) / rows);
}

template <int D>
cudaError_t launch_bf16(const Params& p, const Tiling& t,
                        cudaStream_t stream) {
  using Cfg = FaCfg<D>;
  CUtensorMap tq, tk, tv;
  if (!encode_qkv<D>(&tq, p.q, p.B, p.Hq, p.Sq, p.q_sb, p.q_sh, p.q_ss,
                     Cfg::BQ) ||
      !encode_qkv<D>(&tk, p.k, p.B, p.Hkv, p.Skv, p.k_sb, p.k_sh, p.k_ss,
                     Cfg::BKV) ||
      !encode_qkv<D>(&tv, p.v, p.B, p.Hkv, p.Skv, p.v_sb, p.v_sh, p.v_ss,
                     Cfg::BKV))
    return cudaErrorInvalidValue;
  static bool set = false;
  cudaError_t e = set_smem(fa_fwd_bf16<D>, set, Cfg::SMEM);
  if (e != cudaSuccess) return e;
  fa_fwd_bf16<D><<<t.grid_x, FA_THREADS, Cfg::SMEM, stream>>>(
      tq, tk, tv, p, bf16_items(p, t.heads));
  return cudaGetLastError();
}

template <int D>
constexpr int f32_smem() {
  return (F32_BQ * (D + 1) + 2 * F32_BK * D + F32_BK * F32_BQ) *
         (int)sizeof(float);
}

template <int D>
cudaError_t launch_f32(const Params& p, const Tiling& t, cudaStream_t stream) {
  static bool set = false;
  cudaError_t e = set_smem(fa_fwd_f32<D>, set, f32_smem<D>());
  if (e != cudaSuccess) return e;
  fa_fwd_f32<D><<<dim3(t.grid_x, t.grid_y), 64, f32_smem<D>(), stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, const Tiling& t, bool bf16,
                   cudaStream_t stream) {
  return bf16 ? launch_bf16<D>(p, t, stream) : launch_f32<D>(p, t, stream);
}

// Keys a tile and ring stages of the bf16 instance of head dim D (false:
// no such instance).
bool bf16_tile(int D, int& keys, int& stages) {
  switch (D) {
    case 16: keys = FaCfg<16>::BKV; stages = FaCfg<16>::STAGES; return true;
    case 32: keys = FaCfg<32>::BKV; stages = FaCfg<32>::STAGES; return true;
    case 64: keys = FaCfg<64>::BKV; stages = FaCfg<64>::STAGES; return true;
    case 128: keys = FaCfg<128>::BKV; stages = FaCfg<128>::STAGES; return true;
    default: return false;
  }
}

// A tiling this source runs: an instance (f32: 64 q rows, 64-key tiles,
// one head, no ring; bf16: 64 q rows a warpgroup, the instance's keys and
// stages, two heads a CTA only in an even group) and a grid that covers
// every (batch, q head, q row) once (f32: a CTA each 64 rows of a head;
// bf16: 1 to `items` persistent CTAs, which walk the items between them).
bool valid_tiling(int dtype, int D, const Params& p, const Tiling& t) {
  const int group = p.Hq / p.Hkv;
  if (dtype == 0)
    return t.q_rows == F32_BQ && t.keys == F32_BK && t.heads == 1 &&
           t.stages == 1 && t.grid_x == (p.Sq + F32_BQ - 1) / F32_BQ &&
           t.grid_y == p.B * p.Hq && t.grid_y <= 65535;
  int keys, stages;
  if (!bf16_tile(D, keys, stages) ||
      (t.heads != 1 && !(t.heads == 2 && group % 2 == 0)))
    return false;
  const long long items = bf16_items(p, t.heads);
  return t.q_rows == 64 && t.keys == keys && t.stages == stages &&
         items <= 0x7fffffff && t.grid_x >= 1 && t.grid_x <= items &&
         t.grid_y == 1;
}

}  // namespace

// Keys a K/V tile and ring stages of the bf16 instance of head dim D, into
// keys[0] and stages[0]; returns 0, or -1 if there is no such instance.
extern "C" int fa_bf16_tile(int D, int* keys, int* stages) {
  return bf16_tile(D, *keys, *stages) ? 0 : -1;
}

// Dynamic shared memory of the instance for dtype and head dim D (-1: no
// such instance).
extern "C" int fa_smem_bytes(int dtype, int D) {
  switch (D) {
    case 16: return dtype == 1 ? FaCfg<16>::SMEM : f32_smem<16>();
    case 32: return dtype == 1 ? FaCfg<32>::SMEM : f32_smem<32>();
    case 64: return dtype == 1 ? FaCfg<64>::SMEM : f32_smem<64>();
    case 128: return dtype == 1 ? FaCfg<128>::SMEM : f32_smem<128>();
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  window < 0
// means no window.  The tiling is the wrapper's (flash_attention.py::
// tiling): q rows a warpgroup, keys a K/V tile, q heads a CTA, ring stages
// and the grid.  Returns the launch's cudaError_t (0 on success).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                      long long q_sb, long long q_sh, long long q_ss,
                      long long k_sb, long long k_sh, long long k_ss,
                      long long v_sb, long long v_sh, long long v_ss,
                      float scale, int causal, int window, int q_rows,
                      int keys, int heads, int stages, int grid_x, int grid_y,
                      void* stream) {
  const Params p{q,    k,    v,    o,    B,    Hq,    Hkv,    Sq,     Skv,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb,   v_sh,   v_ss,
                 scale, causal, window, heads};
  const Tiling t{q_rows, keys, heads, stages, grid_x, grid_y};
  if ((dtype != 0 && dtype != 1) || B < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      Sq < 1 || Skv < 1 || !valid_tiling(dtype, D, p, t))
    return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(p, t, bf16, s);
    case 32: return (int)launch<32>(p, t, bf16, s);
    case 64: return (int)launch<64>(p, t, bf16, s);
    case 128: return (int)launch<128>(p, t, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
