// FlashAttention forward for Hopper (sm_90a), GQA, f32 and bf16.
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
// and carries (m, l, acc) in VMEM scratch between grid steps.  Here one CTA
// owns one tile of 64 q rows of one (batch, q head) and loops over the K/V
// tiles itself, keeping (m, l, acc) in registers.  Tiles strictly above the
// causal diagonal, and tiles wholly behind the window, are never loaded.
//
// What bounds it on this card: at glm4-9b's prefill shape (q 4x32x1024x128,
// k/v 4x2x1024x128, bf16, causal) the work is about 34 GFLOP against about
// 71 MB of compulsory traffic (q, k, v and o once each), ~480 FLOP per
// byte, well above the H100's ~295 FLOP/byte ridge: it is bound by
// tensor-core operations.  So the bf16 path runs both products on the tensor
// cores (mma.sync m16n8k16, f32 accumulation), keeps S and P in registers
// (P is rounded to bf16 for the PV product, which fits the bf16 tolerance
// only), and double-buffers K/V tiles in shared memory with cp.async so the
// next tile's load overlaps this tile's math.  Each q head reads its K/V
// tiles on its own; the 16 q heads of a GQA group share them through L2.
// wgmma, TMA, warp specialisation and sharing K/V across the GQA group in
// shared memory are later work.
//
// The f32 path runs the products as f32 FMAs on the CUDA cores (no TF32) so
// that it holds the 2e-5 f32 tolerance; it is the path of the f32 tests.
//
// Layout: q/k/v are read through their (batch, head, seq) strides with a
// unit stride on the head dim; the output is contiguous (B, Hq, Sq, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per CTA
constexpr int BK = 64;  // keys per K/V tile

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
};

// Range [t_lo, t_hi) of K/V tiles that hold a key visible to some row of the
// q tile starting at row q0.
__device__ __forceinline__ void tile_range(const Params& p, int q0, int& t_lo,
                                           int& t_hi) {
  const int nk = (p.Skv + BK - 1) / BK;
  const int off = p.Skv - p.Sq;
  const int q_first = q0 + off;
  const int q_last = min(q0 + BQ, p.Sq) - 1 + off;
  t_lo = 0;
  t_hi = nk;
  if (p.causal) t_hi = q_last < 0 ? 0 : min(nk, q_last / BK + 1);
  if (p.window >= 0) {
    const int k_first = q_first - p.window + 1;
    if (k_first > 0) t_lo = min(k_first / BK, nk);
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  return kp < p.Skv && (!p.causal || qp >= kp) &&
         (p.window < 0 || qp - kp < p.window);
}

// ------------------------------------------------------------- bf16 path

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes (rows past the sequence's end)
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

// Stage rows [row0, row0 + 64) of one (seq, D) matrix into shared memory
// with a padded row pitch of D + 8 elements (ldmatrix reads without bank
// conflicts).  Rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride, int row0,
                                               int rows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* s = ok ? src + (row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + r * (D + 8) + c * 8, s, ok);
  }
}

// 128 threads: warp w owns q rows [16w, 16w + 16) of the CTA's tile.
template <int D>
__global__ void __launch_bounds__(128) fa_fwd_bf16(const Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;  // two buffers
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int t_lo, t_hi;
  tile_range(p, q0, t_lo, t_hi);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row / column pair

  load_tile_bf16<D>(Qs, qg, p.q_ss, q0, p.Sq);
  if (t_lo < t_hi) {
    load_tile_bf16<D>(Ks, kg, p.k_ss, t_lo * BK, p.Skv);
    load_tile_bf16<D>(Vs, vg, p.v_ss, t_lo * BK, p.Skv);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[D / 16][4];  // this warp's 16 q rows as mma A fragments
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(qf[kc], smem_u32(Qs + (warp * 16 + (lane % 16)) * LD +
                                 kc * 16 + (lane / 16) * 8));

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // running sum, this thread's columns
  const float sl2 = p.scale * 1.4426950408889634f;
  const int qp0 = q0 + warp * 16 + g + (p.Skv - p.Sq);  // position of row g

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    const bool more = t + 1 < t_hi;
    if (more) {  // prefetch the next tile into the other buffer
      load_tile_bf16<D>(Ks + (buf ^ 1) * BK * LD, kg, p.k_ss, (t + 1) * BK,
                        p.Skv);
      load_tile_bf16<D>(Vs + (buf ^ 1) * BK * LD, vg, p.v_ss, (t + 1) * BK,
                        p.Skv);
      cp_async_commit();
    }
    const __nv_bfloat16* Kb = Ks + buf * BK * LD;
    const __nv_bfloat16* Vb = Vs + buf * BK * LD;

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bf[4];  // B fragments of n-tiles 2np and 2np+1
        ldmatrix_x4(bf, smem_u32(Kb + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD +
                                 kc * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(s[2 * np], qf[kc], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], bf[2], bf[3]);
      }
    }

    // mask, online softmax (rows g and g + 8 of the warp's 16)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kp = t * BK + nt * 8 + tq * 2 + (e & 1);
        const float x = visible(p, qp0 + r * 8, kp) ? s[nt][e] * sl2 : -INFINITY;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float base[2], alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // no visible key yet
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base[e >> 1]);
        rsum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // acc += P V: P's accumulator fragments are the A fragments of the
    // next product, 16 keys at a time
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];  // B fragments of d-tiles 2dp and 2dp+1
        ldmatrix_x4_trans(bf, smem_u32(Vb + (kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                       dp * 16 + (lane / 16) * 8));
        mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }

    if (more) cp_async_wait_all();
    __syncthreads();  // next tile visible; this buffer free for reuse
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (long long)bh * p.Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no visible key -> 0
    const int qi = q0 + warp * 16 + g + r * 8;
    if (qi < p.Sq) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(og + (long long)qi * D + i * 8 + tq * 2) =
            pack_bf16(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
  }
}

// -------------------------------------------------------------- f32 path

// 64 threads: thread i owns q row i of the CTA's tile.
template <int D>
__global__ void __launch_bounds__(64) fa_fwd_f32(const Params p) {
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
  tile_range(p, q0, t_lo, t_hi);
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

template <int D>
cudaError_t launch(const Params& p, bool bf16, cudaStream_t stream) {
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.Hq);
  if (bf16) {
    const int smem = (BQ + 4 * BK) * (D + 8) * (int)sizeof(__nv_bfloat16);
    cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    fa_fwd_bf16<D><<<grid, 128, smem, stream>>>(p);
  } else {
    const int smem = (BQ * (D + 1) + 2 * BK * D + BK * BQ) * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    fa_fwd_f32<D><<<grid, 64, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  window < 0
// means no window.  Returns the launch's cudaError_t (0 on success).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                      long long q_sb, long long q_sh, long long q_ss,
                      long long k_sb, long long k_sh, long long k_ss,
                      long long v_sb, long long v_sh, long long v_ss,
                      float scale, int causal, int window, void* stream) {
  const Params p{q,    k,    v,    o,    B,    Hq,    Hkv,   Sq,     Skv,   q_sb,  q_sh,
                 q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal, window};
  const bool bf16 = dtype == 1;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(p, bf16, s);
    case 32: return (int)launch<32>(p, bf16, s);
    case 64: return (int)launch<64>(p, bf16, s);
    case 128: return (int)launch<128>(p, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
