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
// Math is f32; y is written in xdt's dtype.  B and C come in group form:
// (BH / r, S, N), head row bh reading group row bh / r (jnp.repeat's order,
// each group's r heads adjacent); r = 1 is one row a head.
//
// Translation: the TPU kernel carries h in VMEM scratch across a sequential
// ("arbitrary") grid axis over chunks.  Blocks on the card run in no order,
// so a CTA owns one head and loops over its chunks itself, the state
// staying in the CTA.  A ragged S and a chunk below 64 are masked: every
// chunk is staged as a 64-row tile whose rows past the chunk or past S are
// zero (dA 0), which is what the Pallas kernel's zero padding computes.
//
// What bounds it on this card: at the mamba2-130m serving prefill shape
// (BH 192, S 1024, P 64, N 128, bf16 X/B/C, f32 dA) the chunk-64 algorithm
// is 8.9 GFLOP (the masked products' lower triangles only) against 151.8 MB
// of compulsory traffic when B and C come one row a head, ~59 FLOP per byte,
// or 55.3 MB in mamba2's own group form (one group of 24 heads), ~161 FLOP
// per byte: both far below the H100's ~295 FLOP/byte ridge, so bytes bound
// it.  The bf16 path (`ssd_fwd_bf16`):
//
// - One wave: a unit is one head and all its P columns (the wrapper's rule,
//   ssd.py::tiling; `ssd_fwd` checks only that this source has the
//   instance), a CTA of one warpgroup with up to 255 registers a thread and
//   108,544 bytes of shared memory at N 128, two CTAs an SM: mamba2's serving
//   shape's 192 units are all resident on 132 SMs at once.  A separate
//   producer warp would cap the registers at 168 (ptxas counts the
//   160-thread CTA as 192 threads at two an SM), where the warpgroup's
//   accumulators spill.
// - TMA and an mbarrier ring: thread 0 loads each chunk's C and B (from the
//   group row) and X tiles by TMA over rank-3 tensor maps of the real
//   strides (N or P, S, rows), so the model's strided view of its conv
//   output is read in place, into a two-stage ring; a stage's full barrier
//   counts TMA's bytes, and the same thread refills the stage two chunks
//   ahead as soon as each tile is read: C and X once every warp has waited
//   for the intra product and C h, B after the state update; a barrier of
//   the whole CTA precedes each refill, so no warp still reads the stage.
//   The box is `chunk` rows; the tile rows past it are zeroed once, and TMA
//   zero-fills rows past S.  Each warp loads the chunk's dA a chunk
//   ahead into registers (two values a lane), so the cumsum waits for no
//   load and dA needs no alignment.
// - wgmma for the four products, f32 accumulate.  S = C B^T: C and B K-major
//   from shared memory.  (S o L) X: S o L from registers (the accumulator
//   layout of S is wgmma's A layout) as a bf16 high and low part, because
//   rounding it to one bf16 was the largest of the rounding errors; X
//   MN-major (the transpose-B form).  C h: h's bf16 copy written by the
//   warpgroup into a swizzled tile (stmatrix), into its own accumulator,
//   which the store scales by exp(cs) and adds to y (scaling C's rows in
//   place instead costs the warpgroup more than the second accumulator).  h += B^T Xd: A is the B tile read
//   M-major (the transpose-A form), one m64 tile per 64 state rows (a state
//   of N < 64 rows reads its one atom for every 64 rows and keeps the first
//   N); Xd, X decayed, is written by the warpgroup beside the ring.  The
//   f32 state stays in the accumulator registers of the warpgroup.
// - Two wgmma groups a chunk overlap the rest: (S o L) X with C h, under
//   which the warpgroup writes Xd; then the state update, under which y is
//   staged (stmatrix) in h's copy's tile and stored by TMA.  Stored thread
//   by thread, y's 16 stores a thread held the next chunk's dA load back
//   in the load/store queue.  Only the state update's wait, h's bf16 copy and the stage's
//   refill sit between one chunk's products and the next chunk's.  Two
//   CTAs an SM fill each other's waits.
// - An mbarrier wait that lasts far beyond any load traps (a launch error)
//   instead of hanging the card.
//
// The f32 instance runs every product as f32 FMAs on the CUDA cores (no
// TF32), so that it holds the 2e-3 tolerance of the JAX kernel tests; it is
// the path of the f32 tests, not of serving.
//
// Layout: xdt, B and C are read through their (row, seq) strides with a
// unit inner stride (bf16: 16-byte aligned base and strides, for TMA); dA
// through its row stride with a unit seq stride; y is contiguous (BH, S, P).

#include <math.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors, the tensor-map encoder

namespace {

constexpr int CH = 64;            // rows of a chunk tile
constexpr int F32_THREADS = 128;  // the f32 CTA: four warps
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* x;
  const float* da;
  const void* b;
  const void* c;
  void* y;
  int BH, S, P, N, chunk, r;  // r: heads a B/C group row
  long long x_sb, x_ss, d_sb, b_sb, b_ss, c_sb, c_ss;
};

// The tiling the wrapper hands over (ssd.py::tiling).
struct Tiling {
  int stages, grid;
};

// Inclusive prefix sum over one warp of the 64 values a lane holds two of
// (lane l: values 2 l and 2 l + 1); writes cs[0..63] times `scale`.
__device__ __forceinline__ void warp_cumsum64(float a, float b, float* cs,
                                              float scale) {
  const int lane = threadIdx.x % 32;
  float s = a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  const float excl = s - (a + b);
  cs[2 * lane] = (excl + a) * scale;
  cs[2 * lane + 1] = (excl + a + b) * scale;
}

// ============================================================= bf16 path

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) as a bf16 pair hi and the bf16 pair lo of what hi leaves out
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// The 8 bf16 values at src (16 bytes of shared memory) times f, to dst.
__device__ __forceinline__ void scale_group(const unsigned char* src, float f,
                                            unsigned char* dst) {
  uint4 v = *reinterpret_cast<const uint4*>(src);
  uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u[k]);
    u[k] = pack_bf16(__low2float(b) * f, __high2float(b) * f);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// four 8 x 8 bf16 matrices from the mma accumulator layout (register k:
// matrix k, row lane / 4, columns 2 (lane % 4) and + 1) to shared memory
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

constexpr int round1k(int b) { return (b + 1023) / 1024 * 1024; }

// wgmma's swizzle code for rows of 128, 64 or 32 bytes
constexpr uint64_t swizzle_code(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

// Byte offset of (row, byte column) in a tile of RB-byte rows at a
// 1024-byte boundary under the RB swizzle, as TMA writes it and wgmma reads
// it: the 16-byte group's index is XORed with the row's bits above 128 bytes.
template <int RB>
__device__ __forceinline__ uint32_t swz(int row, int col_bytes) {
  const uint32_t o = row * RB + col_bytes;
  constexpr uint32_t mask = RB == 128 ? 7 : RB == 64 ? 3 : 1;
  return o ^ (((o >> 7) & mask) << 4);
}

// d (64 x NN, f32) (+)= A (64 x 16) B (16 x NN), bf16.  ss: both from
// shared memory, TA / TB 1 for an M- / N-major operand; rs: A from
// registers in the accumulator layout, B N-major.  scale_d 0 starts the sum.
template <int NN>
struct Wg;

template <>
struct Wg<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // A from registers (a[0..3]), B MN-major (the transpose-B form)
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wg<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // A from registers (a[0..3]), B MN-major (the transpose-B form)
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wg<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // A from registers (a[0..3]), B MN-major (the transpose-B form)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// The bf16 instance of state dim N and head dim P: one head a CTA, one
// warpgroup, two CTAs an SM.
template <int N_, int P_>
struct SsdCfg {
  static constexpr int N = N_, P = P_;
  static constexpr int THREADS = 128;  // one warpgroup
  static constexpr int MIN_CTAS = 2;   // CTAs an SM
  static constexpr int BOXN = N < 64 ? N : 64;  // B/C columns a TMA box
  static constexpr int NBOX = N / BOXN;
  static constexpr int ROWB_N = 2 * BOXN;       // bytes a B/C box row
  static constexpr uint64_t SW_N = swizzle_code(ROWB_N);
  static constexpr int CB_BOX = CH * ROWB_N;
  static constexpr int CB_BYTES = NBOX * CB_BOX;  // a C or B tile
  static constexpr int ROWB_P = 2 * P;           // bytes an X row
  static constexpr uint64_t SW_P = swizzle_code(ROWB_P);
  static constexpr int X_BYTES = round1k(CH * ROWB_P);
  static constexpr int MT = N < 64 ? 1 : N / 64;  // m64 tiles of the state
  // a stage: C, B and X
  static constexpr int OFF_B = round1k(CB_BYTES);
  static constexpr int OFF_X = 2 * round1k(CB_BYTES);
  static constexpr int STAGE = OFF_X + X_BYTES;
  // h's bf16 copy, which also stages y's tile for its TMA store
  static constexpr int HS_BYTES = round1k((N > CH ? N : CH) * ROWB_P);
  // 1024 bytes of slack to align the tiles, h's copy, the decayed X, each
  // warp's cumsum; then as many stages as fit two CTAs an SM (233,472
  // bytes, 1 KB of it reserved a CTA), at most 4
  static constexpr int FIXED = 1024 + HS_BYTES + X_BYTES + 4 * CH * 4;
  static constexpr int BUDGET = 233472 / MIN_CTAS - 1024 - 256;
  static constexpr int FIT = (BUDGET - FIXED) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static_assert(P == 16 || P == 32 || P == 64, "head dim");

  // C or B, K-major (K = N), at k-step kk: its box, and the step's 32 bytes
  // in the swizzled row
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    return smem_desc(base + (16 * kk / BOXN) * CB_BOX + (16 * kk % BOXN) * 2,
                     16, 8 * ROWB_N, SW_N);
  }
  // B^T, M-major (M = N, K = chunk rows): state rows 64 mt .. of m-tile mt
  // are box mt; a state of N < 64 rows has one atom, read again for every
  // N rows of the 64 (a leading byte offset of 0)
  static __device__ __forceinline__ uint64_t bt_desc(uint32_t base, int mt,
                                                     int kk) {
    return smem_desc(base + mt * CB_BOX + 16 * kk * ROWB_N,
                     N >= 64 ? CB_BOX : 0, 8 * ROWB_N, SW_N);
  }
  // X, Xd or h's copy, N-major (N = P), at k-step kk (16 rows)
  static __device__ __forceinline__ uint64_t nmajor(uint32_t base, int kk) {
    return smem_desc(base + 16 * kk * ROWB_P, X_BYTES, 8 * ROWB_P, SW_P);
  }
};

template <class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_CTAS)
    ssd_fwd_bf16(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const __grid_constant__ CUtensorMap tm_y, const Params p) {
  constexpr int N = Cfg::N, P = Cfg::P, ST = Cfg::STAGES, MT = Cfg::MT;
  extern __shared__ unsigned char ssd_smem[];
  __shared__ __align__(8) uint64_t full[ST];
  // the ring at a 1024-byte boundary of the shared window, then h's bf16
  // copy, the decayed X and the warps' cumsums
  unsigned char* smem =
      ssd_smem + ((1024 - (smem_u32(ssd_smem) & 1023)) & 1023);
  unsigned char* hs = smem + ST * Cfg::STAGE;
  unsigned char* xd = hs + Cfg::HS_BYTES;
  const uint32_t hs_addr = smem_u32(hs), xd_addr = smem_u32(xd);

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int bh = blockIdx.x;
  const int grp = bh / p.r;  // the B/C row of this head
  const int nc = (p.S + p.chunk - 1) / p.chunk;
  float* csw = reinterpret_cast<float*>(xd + Cfg::X_BYTES) + warp * CH;
  const float* dg = p.da + (long long)bh * p.d_sb;
  const int i0 = 16 * warp + g;  // this thread's rows: i0 and i0 + 8

  // chunk c's C (from the group row) and X into stage s by TMA, the box
  // `chunk` rows (rows past S arrive as zeros); the stage's barrier expects
  // B's bytes too, which load_b brings
  auto load_cx = [&](int c, int s) {
    unsigned char* st = smem + s * Cfg::STAGE;
    const int row0 = c * p.chunk;
    mbar_expect_tx(&full[s], (uint32_t)p.chunk * (2 * N * 2 + P * 2));
#pragma unroll
    for (int bx = 0; bx < Cfg::NBOX; ++bx)
      tma_load_3d(st + bx * Cfg::CB_BOX, &tm_c, &full[s], bx * Cfg::BOXN,
                  row0, grp);
    tma_load_3d(st + Cfg::OFF_X, &tm_x, &full[s], 0, row0, bh);
  };
  auto load_b = [&](int c, int s) {
    unsigned char* st = smem + s * Cfg::STAGE;
#pragma unroll
    for (int bx = 0; bx < Cfg::NBOX; ++bx)
      tma_load_3d(st + Cfg::OFF_B + bx * Cfg::CB_BOX, &tm_b, &full[s],
                  bx * Cfg::BOXN, c * p.chunk, grp);
  };
  // chunk c's dA, two values a lane (0 past the chunk), loaded a chunk
  // ahead of their use
  auto load_da = [&](int c, float (&v)[2]) {
    const int row0 = c * p.chunk, rows = min(p.chunk, p.S - row0);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      v[k] = 2 * lane + k < rows ? dg[row0 + 2 * lane + k] : 0.f;
  };

  // a zero ring: the rows past a chunk below 64 stay zero (TMA writes the
  // chunk's rows only)
  for (int i = t; i < ST * Cfg::STAGE / 16; i += Cfg::THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  if (t == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 1);  // expect_tx; bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    prefetch_map(&tm_x);
    prefetch_map(&tm_b);
    prefetch_map(&tm_c);
    prefetch_map(&tm_y);
    for (int c = 0; c < ST && c < nc; ++c) {
      load_cx(c, c);
      load_b(c, c);
    }
  }
  float da[2], da_next[2];
  load_da(0, da);

  // accumulators: element 4 j + e is row i0 + 8 (e >> 1), column 8 j +
  // 2 tq + (e & 1) (h: state row 64 mt + i0 + 8 (e >> 1))
  float h[MT][P / 2];
  float sc[32], y[P / 2], tc[P / 2];
  uint32_t hi[16], lo[16];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < P / 2; ++i) h[mt][i] = 0.f;

  // an m64 x P accumulator's 64 rows from row0 on, as bf16, into hs (the
  // P-column swizzled tile): a warp's 16 rows x 8 columns are two 8 x 8
  // matrices, four to a stmatrix; lane l gives the address of row l % 8 of
  // matrix l / 8
  auto stage = [&](const float (&a)[P / 2], int row0) {
    const int q = lane / 8;
    const int n = row0 + 16 * warp + 8 * (q & 1) + lane % 8;
#pragma unroll
    for (int j = 0; j < P / 8; j += 2)
      stmatrix_x4(hs_addr + swz<Cfg::ROWB_P>(n, 16 * (j + (q >> 1))),
                  pack_bf16(a[4 * j], a[4 * j + 1]),
                  pack_bf16(a[4 * j + 2], a[4 * j + 3]),
                  pack_bf16(a[4 * j + 4], a[4 * j + 5]),
                  pack_bf16(a[4 * j + 6], a[4 * j + 7]));
  };
  // h -> its bf16 copy (state rows < N), visible to wgmma
  auto copy_h = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (64 * mt + 16 * warp < N) stage(h[mt], 64 * mt);
    fence_proxy_async();
    __syncthreads();
  };
  copy_h();

  int s = 0;
  uint32_t phase = 0;
  for (int c = 0; c < nc; ++c) {
    const int row0 = c * p.chunk;
    if (c + 1 < nc) load_da(c + 1, da_next);
    warp_cumsum64(da[0], da[1], csw, LOG2E);
    __syncwarp();
    mbar_wait(&full[s], phase);
    unsigned char* st = smem + s * Cfg::STAGE;
    const uint32_t c_addr = smem_u32(st), b_addr = smem_u32(st + Cfg::OFF_B);
    const unsigned char* xt = st + Cfg::OFF_X;
    const uint32_t x_addr = smem_u32(xt);

    // S = C B^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      Wg<64>::ss<0, 0>(sc, Cfg::kmajor(c_addr, kk), Cfg::kmajor(b_addr, kk),
                       kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // S o L: exp(cs_i - cs_j) on and below the diagonal, 0 above (the
    // column blocks wholly above this warp's rows are skipped); then its
    // bf16 high and low parts as the A fragments of (S o L) X
    const float ci[2] = {csw[i0], csw[i0 + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j > 16 * warp + 15) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * j + e] = 0.f;
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1), row = i0 + 8 * (e >> 1);
        sc[4 * j + e] =
            col <= row ? sc[4 * j + e] * ex2(ci[e >> 1] - csw[col]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k)
      split_bf16(sc[2 * k], sc[2 * k + 1], hi[k], lo[k]);

    // y = (S o L) X (high part, then low) and t = C h, one group
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wg<P>::rs(y, &hi[4 * kk], Cfg::nmajor(x_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wg<P>::rs(y, &lo[4 * kk], Cfg::nmajor(x_addr, kk), 1);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      Wg<P>::template ss<0, 1>(tc, Cfg::kmajor(c_addr, kk),
                                Cfg::nmajor(hs_addr, kk), kk > 0);
    wgmma_commit();

    // under it, X decayed into Xd: row j times exp(total - cs_j)
    const float total = csw[CH - 1];
    for (int v = t; v < CH * Cfg::ROWB_P / 16; v += Cfg::THREADS)
      scale_group(xt + 16 * v, ex2(total - csw[16 * v / Cfg::ROWB_P]),
                  xd + 16 * v);
    fence_proxy_async();
    __syncthreads();

    // h <- exp(total) h + B^T Xd, a second group
    const float et = ex2(total);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < P / 2; ++i) h[mt][i] *= et;
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wg<P>::template ss<1, 1>(h[mt], Cfg::bt_desc(b_addr, mt, kk),
                                  Cfg::nmajor(xd_addr, kk), 1);
    wgmma_commit();

    // y += t o exp(cs) once the first group has retired, under the state
    // update; rows past the chunk or S are not stored
    wgmma_wait<1>();
    fence_acc(y);
    fence_acc(tc);
    fence_regs(hi);
    fence_regs(lo);
    // y = y + t o exp(cs), staged in hs (C h has read it) and stored by
    // TMA: the box is the chunk's rows, and rows past S are not written
    const float ec[2] = {ex2(ci[0]), ex2(ci[1])};
#pragma unroll
    for (int i = 0; i < P / 2; ++i) y[i] = fmaf(tc[i], ec[(i >> 1) & 1], y[i]);
    stage(y, 0);
    fence_proxy_async();
    __syncthreads();
    if (t == 0) {
      tma_store_3d(&tm_y, hs, 0, row0, bh);
      bulk_commit();
      // every warp has waited for (S o L) X and C h, so C and X of the
      // stage are read: its next chunk's C and X load under the update
      if (c + ST < nc) load_cx(c + ST, s);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(h[mt]);
    if (t == 0) bulk_wait_read<0>();  // the store has read y from hs
    __syncthreads();
    copy_h();  // the state before the next chunk; every read of stage s done
    if (t == 0 && c + ST < nc) load_b(c + ST, s);
    da[0] = da_next[0];
    da[1] = da_next[1];
    if (++s == ST) {
      s = 0;
      phase ^= 1;
    }
  }
  if (t == 0) bulk_wait<0>();  // y written before the CTA exits
}

// ============================================================== f32 path

// 128 threads; one CTA owns one bh row and all P columns; B and C come
// from its group row bh / r.
template <int N, int P>
__global__ void __launch_bounds__(F32_THREADS) ssd_fwd_f32(const Params p) {
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

  const int bh = blockIdx.x, grp = bh / p.r;
  const float* xg = static_cast<const float*>(p.x) + bh * p.x_sb;
  const float* bg = static_cast<const float*>(p.b) + grp * p.b_sb;
  const float* cg = static_cast<const float*>(p.c) + grp * p.c_sb;
  const float* dg = p.da + bh * p.d_sb;
  float* yg = static_cast<float*>(p.y) + (long long)bh * p.S * P;
  const int tid = threadIdx.x;
  const int nc = (p.S + p.chunk - 1) / p.chunk;

  for (int i = tid; i < N * P; i += F32_THREADS) Hs[i] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int row0 = ci * p.chunk, rows = min(p.chunk, p.S - row0);
    __syncthreads();  // previous chunk consumed
    for (int i = tid; i < CH * P; i += F32_THREADS) {
      const int r = i / P, c = i % P;
      Xs[i] = r < rows ? xg[(row0 + r) * p.x_ss + c] : 0.f;
    }
    for (int i = tid; i < CH * N; i += F32_THREADS) {
      const int r = i / N, c = i % N;
      Bs[r * LDN + c] = r < rows ? bg[(row0 + r) * p.b_ss + c] : 0.f;
      Cs[r * LDN + c] = r < rows ? cg[(row0 + r) * p.c_ss + c] : 0.f;
    }
    if (tid < CH) Ds[tid] = tid < rows ? dg[row0 + tid] : 0.f;
    __syncthreads();
    if (tid < 32) warp_cumsum64(Ds[2 * tid], Ds[2 * tid + 1], cs, 1.f);
    __syncthreads();
    const float total = cs[CH - 1];
    if (tid < CH) {
      ec[tid] = expf(cs[tid]);
      dc[tid] = expf(total - cs[tid]);
    }
    // C B^T o L
    for (int i = tid; i < CH * CH; i += F32_THREADS) {
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
    for (int i = tid; i < CH * P; i += F32_THREADS) {
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
    for (int i = tid; i < N * P; i += F32_THREADS) {
      const int n = i / P, c = i % P;
      float acc = 0.f;
      for (int j = 0; j < CH; ++j)
        acc = fmaf(Bs[j * LDN + n] * dc[j], Xs[j * P + c], acc);
      Hs[i] = fmaf(et, Hs[i], acc);
    }
  }
}

constexpr int smem_f32(int N, int P) {
  return (CH * P + 2 * CH * (N + 1) + CH * (CH + 1) + N * P + 5 * CH) *
         (int)sizeof(float);
}

// Raise `kernel`'s dynamic shared-memory limit to `smem` on the current
// device, once per device (the attribute is a device's) and instance (Tag).
template <class Tag>
cudaError_t set_smem(const void* kernel, int smem) {
  constexpr int DEVICES = 64;
  static bool done[DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < DEVICES && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && dev < DEVICES) done[dev] = true;
  return e;
}

template <int N, int P>
struct F32Tag {};

template <int N, int P>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  cudaError_t e = set_smem<F32Tag<N, P>>((const void*)ssd_fwd_f32<N, P>,
                                         smem_f32(N, P));
  if (e != cudaSuccess) return e;
  ssd_fwd_f32<N, P><<<p.BH, F32_THREADS, smem_f32(N, P), stream>>>(p);
  return cudaGetLastError();
}

// ============================================================ the launch

// The bf16 instances: (N, P).
#define SSD_BF16_INSTANCES(X)                                  \
  X(16, 16) X(16, 32) X(16, 64) X(32, 16) X(32, 32) X(32, 64)  \
  X(64, 16) X(64, 32) X(64, 64) X(128, 16) X(128, 32) X(128, 64)

// Call f(Cfg{}) with the instance (N, P); false if there is none.
template <class F>
bool with_bf16(int N, int P, F&& f) {
#define SSD_CASE(n, hp)          \
  if (N == n && P == hp) {       \
    f(SsdCfg<n, hp>{});          \
    return true;                 \
  }
  SSD_BF16_INSTANCES(SSD_CASE)
#undef SSD_CASE
  return false;
}

constexpr CUtensorMapSwizzle swizzle_mode(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The rank-3 bf16 map (cols, S, rows) of a (rows, S, cols) tensor with
// these element strides, in boxes of `box_cols` columns and `box_rows`
// sequence rows of one row.
bool encode_rows(CUtensorMap* map, const void* ptr, int cols, int S, int rows,
                 long long sb, long long ss, int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)S,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return encode_tiled(map, ptr, 3, dims, strides, box,
                      swizzle_mode(2 * box_cols));
}

template <class Cfg>
cudaError_t launch_bf16(const Params& p, int grid, cudaStream_t stream) {
  CUtensorMap tx, tb, tc, ty;
  const int groups = p.BH / p.r;
  if (!encode_rows(&tx, p.x, p.P, p.S, p.BH, p.x_sb, p.x_ss, Cfg::P,
                   p.chunk) ||
      !encode_rows(&ty, p.y, p.P, p.S, p.BH, (long long)p.S * p.P, p.P,
                   Cfg::P, p.chunk) ||
      !encode_rows(&tb, p.b, Cfg::N, p.S, groups, p.b_sb, p.b_ss, Cfg::BOXN,
                   p.chunk) ||
      !encode_rows(&tc, p.c, Cfg::N, p.S, groups, p.c_sb, p.c_ss, Cfg::BOXN,
                   p.chunk))
    return cudaErrorInvalidValue;
  cudaError_t e = set_smem<Cfg>((const void*)ssd_fwd_bf16<Cfg>, Cfg::SMEM);
  if (e != cudaSuccess) return e;
  ssd_fwd_bf16<Cfg><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(tx, tb, tc, ty,
                                                             p);
  return cudaGetLastError();
}

template <int N>
cudaError_t dispatch_f32(const Params& p, cudaStream_t s) {
  switch (p.P) {
    case 16: return launch_f32<N, 16>(p, s);
    case 32: return launch_f32<N, 32>(p, s);
    case 64: return launch_f32<N, 64>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// A tiling this source runs: one CTA a head; f32 no ring, bf16 the
// instance (N, P)'s stages.
bool valid_tiling(int dtype, const Params& p, const Tiling& t) {
  int stages = dtype == 0 ? 1 : -1;
  if (dtype != 0 &&
      !with_bf16(p.N, p.P, [&](auto cfg) { stages = decltype(cfg)::STAGES; }))
    return false;
  return t.stages == stages && t.grid == p.BH;
}

}  // namespace

// The bf16 instance (N, P): its ring stages, dynamic shared memory and
// the CTAs of it an SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns 0, -1 if
// there is no such instance, or the cudaError_t of the query.
extern "C" int ssd_bf16_tile(int N, int P, int* stages, int* smem,
                             int* per_sm) {
  cudaError_t e = cudaSuccess;
  if (!with_bf16(N, P, [&](auto cfg) {
        using Cfg = decltype(cfg);
        *stages = Cfg::STAGES;
        *smem = Cfg::SMEM;
        e = set_smem<Cfg>((const void*)ssd_fwd_bf16<Cfg>, Cfg::SMEM);
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              per_sm, ssd_fwd_bf16<Cfg>, Cfg::THREADS, Cfg::SMEM);
      }))
    return -1;
  return (int)e;
}

// dtype: 0 = float32, 1 = bfloat16 (of xdt, B, C and y; dA is float32).
// B and C have BH / r rows (head bh reads row bh / r).  Strides are in
// elements.  chunk in [1, 64].  The tiling is the wrapper's (ssd.py::
// tiling): ring stages and the grid.  Returns the launch's cudaError_t (0
// on success).
extern "C" int ssd_fwd(const void* x, const float* da, const void* b,
                       const void* c, void* y, int dtype, int BH, int S, int P,
                       int N, int chunk, int r, long long x_sb, long long x_ss,
                       long long d_sb, long long b_sb, long long b_ss,
                       long long c_sb, long long c_ss, int stages, int grid,
                       void* stream) {
  const Params p{x,    da,   b,    c,    y,    BH,   S,    P,   N,
                 chunk, r,   x_sb, x_ss, d_sb, b_sb, b_ss, c_sb, c_ss};
  const Tiling t{stages, grid};
  if ((dtype != 0 && dtype != 1) || chunk < 1 || chunk > CH || BH < 1 ||
      S < 1 || r < 1 || BH % r != 0 || !valid_tiling(dtype, p, t))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (N) {
      case 16: return (int)dispatch_f32<16>(p, s);
      case 32: return (int)dispatch_f32<32>(p, s);
      case 64: return (int)dispatch_f32<64>(p, s);
      case 128: return (int)dispatch_f32<128>(p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t e = cudaErrorInvalidValue;
  with_bf16(N, P,
            [&](auto cfg) { e = launch_bf16<decltype(cfg)>(p, grid, s); });
  return (int)e;
}
