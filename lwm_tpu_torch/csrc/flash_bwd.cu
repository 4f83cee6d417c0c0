// Flash-attention backward for Hopper (sm_90a): dq, dk and dv in one pass,
// bf16 in, fp32 math.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (lwm_tpu/ops/pallas_flash.py:
// 288-353) and `_bwd_dkv_kernel` (:356-445), both launched by
// `_flash_attention_bwd_single` (:903-1127). Same contract, the backward of
// K1 (flash_fwd.cu):
//   logits = q·kᵀ·scale + bias, masked (causal by global position: query i
//            at q_offset + i, key j at kv_offset + j; keys ≥ skv, rows ≥ sq)
//   p  = logits > MASK_GUARD ? exp(logits − lse) : 0     (lse from K1)
//   dp = g·vᵀ,  ds = p·(dp − delta)·scale                  (delta = Σ g·out)
//   dv = pᵀ·g, dk = dsᵀ·q, dq = ds·k   (p and ds rounded to bf16 before these)
// with fp32 accumulation, GQA (query head qh reads kv head qh / g) and
// dk/dv returned at h_kv heads, every group member summed in fp32.
//
// What bounds it on the card: at training widths (seq 4096, d 128) the pass
// does 10·sq·skv·d flops per head (five products, two of them recomputing
// the forward's q·kᵀ and g·vᵀ) on O((sq + skv)·d) bytes, far above the
// H100's ~295 flop/byte ridge, so tensor-core throughput bounds it, and only
// `wgmma` reaches the tensor cores' full rate. The design (the usual
// FlashAttention-2/3 backward):
// - One block of two warpgroups per (b·h_kv, 128-key tile); each warpgroup
//   owns 64 keys, the `wgmma` M rows. The block's k and v tiles stay in
//   128-byte-swizzled shared memory for the whole block.
// - The block walks every (group member, 64-query tile) from the causal
//   start. q, g, lse and delta of the next tile are loaded by `cp.async`
//   (every thread) into the other of two stages while this tile computes.
// - Per query tile, each warpgroup computes sᵀ = k·qᵀ and dpᵀ = v·gᵀ
//   (m64n64k16, both operands from shared memory), forms pᵀ and dsᵀ in
//   registers, and adds dv += pᵀ·g and dk += dsᵀ·q with pᵀ and dsᵀ as the
//   register A operand: an m64nNk16 accumulator is, rounded to bf16 in
//   pairs, exactly the A fragment of the next product. q and g are read as
//   N-major B (bf16 allows it), so the tiles are never transposed.
// - dk and dv stay in fp32 registers for the whole block and are written
//   once, with no atomics (the group of query heads is summed there too).
// - dq: dsᵀ goes to shared memory once; each warpgroup then computes one
//   64-wide half of the tile's dq over all 128 keys (d 128; at d 64, its
//   own 64 keys over the whole row) and adds it into an fp32 dq_accum
//   [b, sq, h, d] with vector atomics. The wrapper zeroes dq_accum before
//   and rounds it to bf16 after. The order of those sums changes from run
//   to run, so dq is not bit-reproducible (dk and dv are).
// - The heaviest key tiles (causally, the first: they see the most queries)
//   of every (b, kv head) launch in the first waves and the lightest in the
//   last, so the card does not wait on a few long blocks at the end.
// Not yet: dq summed across a cluster before the atomics (they take ~0.5
// ms of the ~2.5 at the training shape on an H100 80GB HBM3 at 700 W).
// Tried and slower there: TMA loads from a producer warpgroup with
// `setmaxnreg` (384 threads: ptxas kept the 168-register budget for the
// consumers, which need 250, spilled and serialized the wgmmas).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBigNeg = -1e30f;
constexpr float kMaskGuard = -1e29f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kBK = 128;       // keys per block: 64 per warpgroup
constexpr int kBQ = 64;        // queries per inner tile

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;
  const float* lse;    // [b, h, sq]
  const float* delta;  // [b, h, sq]
  const float* bias;   // [bb, rows, skv] or null
  float* dq_accum;     // [b, sq, h, d] fp32, zeroed by the caller
  __nv_bfloat16* dk;   // [b, skv, h_kv, d]
  __nv_bfloat16* dv;
  int sq, skv, h, h_kv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh;
  long long bias_sb, bias_sr;
  int causal, q_offset, kv_offset;
  float scale;
};

// Shared memory of one block, byte offsets from a 1024-aligned base. A tile
// of R rows × D bf16 is D / 64 column halves of R rows × 128 bytes, each
// row's eight 16-byte chunks swizzled (chunk c of row r at c ^ (r % 8)): the
// layout `wgmma` reads without bank conflicts, K-major or N-major alike.
template <int D>
struct Smem {
  static constexpr int kKV = kBK * D * 2;   // the k (or v) tile
  static constexpr int kQG = kBQ * D * 2;   // a q (or g) tile, per stage
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQ = 2 * kKV;        // two stages
  static constexpr int kG = kQ + 2 * kQG;   // two stages
  static constexpr int kDS = kG + 2 * kQG;  // dsᵀ [128 keys × 64 queries], one half
  static constexpr int kStat = kDS + kBK * kBQ * 2;  // lse, delta: [stage][2][kBQ] fp32
  static constexpr int kBytes = kStat + 2 * 2 * kBQ * 4;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// byte offset of element (r, c) of an R-row swizzled tile (see Smem)
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * R * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// generic-proxy writes (cp.async, st.shared) → visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ROWS × D tile of bf16 into its swizzled slot, 16 bytes per thread per
// step; rows at or past `rows_valid` are zero-filled so masked rows never
// carry garbage into a product (0 · NaN would poison it)
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long row_stride, int rows_valid, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "whole steps of 16 bytes a thread");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r < rows_valid;
    cp_async16(dst + swz<ROWS>(r, c), src + (in ? r * row_stride + c : 0), in ? 16 : 0);
  }
}

// ------------------------------------------------------------------ wgmma

// shared-memory descriptor of a 128-byte-swizzled tile whose 8-row groups
// are 1024 bytes apart. K-major (rows are M or N, 64 k per row): the
// stride is SBO, LBO is unused; adding 2 moves the start 32 bytes (k 16).
// N-major (rows are k, 64 of M or N per row, one 64-wide atom): the 8-row
// groups are again SBO apart; LBO (the next 64-wide atom) is never used at
// M, N = 64, and is set to the same stride. 16 k rows are 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define LWM_ACC32                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define LWM_REGS32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 × 64] (+)= A (64 × 16) · B (16 × 64), both from shared memory; TA /
// TB: the operand is M- / N-major. scale_d 0 ignores d's old value.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LWM_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : LWM_ACC32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 × 64] (+)= A (64 × 16, four bf16x2 fragments a) · B (16 × 64, N-major
// in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LWM_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : LWM_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// two floats → packed bf16x2, the lower index in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// ----------------------------------------------------------------- kernel
//
// Accumulator element i of an m64n64 tile, in a thread of warp w (of its
// warpgroup), lane (g8, t4) = (lane / 4, lane % 4): row 16·w + g8 +
// 8·((i / 2) % 2), column 8·(i / 4) + 2·t4 + i % 2. Elements 8j .. 8j + 7,
// packed in pairs, are the A fragments (a0 .. a3) of k chunk j.

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_kernel(const BwdParams p) {
  using L = Smem<D>;
  constexpr int kHalves = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* stat_s = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kStat);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int bi = blockIdx.x / p.h_kv, kvh = blockIdx.x % p.h_kv;
  const int group = p.h / p.h_kv;
  const int k0 = blockIdx.y * kBK;
  const float* bias_g = p.bias ? p.bias + bi * p.bias_sb : nullptr;

  // the (group member, query tile) walk: from the first query that sees
  // any key of this tile
  const int q_start = p.causal ? max(0, p.kv_offset + k0 - p.q_offset) : 0;
  const int qt0 = q_start / kBQ;
  const int per = max(0, (p.sq + kBQ - 1) / kBQ - qt0);
  const int n_iter = group * per;

  auto load_q = [&](int it, int s) {
    const int qh = kvh * group + it / per, q0 = (qt0 + it % per) * kBQ;
    const int rows = min(kBQ, p.sq - q0);
    load_tile<D, kBQ>(base + L::kQ + s * L::kQG,
                      p.q + bi * p.q_sb + (long long)q0 * p.q_ss + qh * p.q_sh, p.q_ss, rows, tid);
    load_tile<D, kBQ>(base + L::kG + s * L::kQG,
                      p.g + bi * p.g_sb + (long long)q0 * p.g_ss + qh * p.g_sh, p.g_ss, rows, tid);
    if (tid < 2 * kBQ) {  // lse (threads 0..63) and delta (64..127)
      const int r = tid % kBQ;
      const float* src = (tid < kBQ ? p.lse : p.delta) + ((long long)bi * p.h + qh) * p.sq + q0;
      cp_async4(base + L::kStat + (s * 2 * kBQ + tid) * 4, src + (r < rows ? r : 0),
                r < rows ? 4 : 0);
    }
  };

  load_tile<D, kBK>(base + L::kK, p.k + bi * p.k_sb + (long long)k0 * p.k_ss + kvh * p.k_sh,
                    p.k_ss, min(kBK, p.skv - k0), tid);
  load_tile<D, kBK>(base + L::kV, p.v + bi * p.v_sb + (long long)k0 * p.v_ss + kvh * p.v_sh,
                    p.v_ss, min(kBK, p.skv - k0), tid);
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();

  // this thread's two keys (accumulator rows g8 and g8 + 8 of its warp)
  const int key_row = wg * 64 + warp * 16 + g8;  // within the tile
  int key[2];
  float key_bias[2] = {0.f, 0.f};  // the per-key bias, when the bias has one row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + key_row + 8 * r;
    if (bias_g && p.bias_sr == 0 && key[r] < p.skv) key_bias[r] = bias_g[key[r]];
  }
  const bool full_bias = bias_g && p.bias_sr != 0;

  float dk[kHalves][32], dv[kHalves][32];

  for (int it = 0; it < n_iter; ++it) {
    const int s = it & 1;
    const int qh = kvh * group + it / per, q0 = (qt0 + it % per) * kBQ;
    cp_async_wait_all();  // this thread's copies of stage s (and of k, v)
    fence_async_smem();
    __syncthreads();      // stage s complete; iteration it − 1 is done with stage s ^ 1 and dsᵀ
    if (it + 1 < n_iter) load_q(it + 1, s ^ 1);
    cp_async_commit();

    const uint32_t q_s = base + L::kQ + s * L::kQG, g_s = base + L::kG + s * L::kQG;
    const uint32_t k_s = base + L::kK + wg * 64 * 128, v_s = base + L::kV + wg * 64 * 128;

    // sᵀ = k·qᵀ, dpᵀ = v·gᵀ: this warpgroup's 64 keys × 64 queries, k = d
    float sa[32], da[32];
    wgmma_fence();
    fence_acc(sa);
    fence_acc(da);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * kBK * 128 + (kk & 3) * 32;   // k tile: 128 rows a half
      const int qoff = (kk >> 2) * kBQ * 128 + (kk & 3) * 32;  // q, g tiles: 64 rows a half
      wgmma_ss<0, 0>(sa, smem_desc(k_s + off), smem_desc(q_s + qoff), kk > 0);
      wgmma_ss<0, 0>(da, smem_desc(v_s + off), smem_desc(g_s + qoff), kk > 0);
    }
    wgmma_commit();
    fence_acc(sa);
    fence_acc(da);
    wgmma_wait_all();

    // pᵀ and dsᵀ in place
    const float* lse_s = stat_s + s * 2 * kBQ;
    const float* delta_s = lse_s + kBQ;
    const bool edge = q0 + kBQ > p.sq || k0 + kBK > p.skv ||
                      (p.causal && p.kv_offset + k0 + kBK - 1 > p.q_offset + q0);
    uint32_t pa[4][4], dsa[4][4];  // bf16 A fragments of the 4 query chunks of 16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 8 * j; i < 8 * j + 8; ++i) {
        const int r = (i >> 1) & 1, qi = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int qrow = q0 + qi;
        float x = fmaf(sa[i], p.scale, key_bias[r]);
        if (edge || full_bias) {
          bool valid = key[r] < p.skv && qrow < p.sq;
          if (valid && full_bias) x += bias_g[qrow * p.bias_sr + key[r]];
          if (p.causal && p.kv_offset + key[r] > p.q_offset + qrow) valid = false;
          x = valid ? x : kBigNeg;
        }
        const float pe = x > kMaskGuard ? exp2f((x - lse_s[qi]) * kLog2e) : 0.f;
        sa[i] = pe;
        da[i] = pe * (da[i] - delta_s[qi]) * p.scale;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[j][e] = pack_bf16(sa[8 * j + 2 * e], sa[8 * j + 2 * e + 1]);
        dsa[j][e] = pack_bf16(da[8 * j + 2 * e], da[8 * j + 2 * e + 1]);
      }
    }
    // dsᵀ → shared memory, [128 keys × 64 queries] (fragment e: rows g8 /
    // g8 + 8 for e even / odd, columns 16j + 8·(e / 2) + 2·t4)
    uint8_t* ds_s = smem_raw + (base - raw) + L::kDS;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<uint32_t*>(ds_s + swz<kBK>(key_row + 8 * (e & 1),
                                                     16 * j + 8 * (e >> 1) + 2 * t4)) = dsa[j][e];
    fence_async_smem();

    // dv += pᵀ·g, dk += dsᵀ·q: A from registers, g and q N-major
    wgmma_fence();
    fence_frag(pa);
    fence_frag(dsa);
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) {
      fence_acc(dv[hh]);
      fence_acc(dk[hh]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh) {
        const int off = hh * kBQ * 128 + j * 16 * 128;
        wgmma_rs(dv[hh], pa[j], smem_desc(g_s + off), it > 0 || j > 0);
        wgmma_rs(dk[hh], dsa[j], smem_desc(q_s + off), it > 0 || j > 0);
      }
    wgmma_commit();
    __syncthreads();  // both warpgroups' dsᵀ are in shared memory
    // dv and dk finish before dq starts, so that pᵀ's and dsᵀ's registers
    // are free for dq's accumulators (at d 128 they would not all fit)
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) {
      fence_acc(dv[hh]);
      fence_acc(dk[hh]);
    }
    wgmma_wait_all();
    fence_frag(pa);
    fence_frag(dsa);

    // dq = ds·k: A = dsᵀ read M-major, B = the k tile N-major. d 128: this
    // warpgroup's half of d over all 128 keys; d 64: all of d over its own
    // 64 keys (both warpgroups add into the same dq rows)
    float qa[32];
    constexpr int kSteps = D == 128 ? kBK / 16 : 4;
    const uint32_t ds_a = base + L::kDS + (D == 128 ? 0 : wg * 64 * 128);
    const uint32_t kb = base + L::kK + (D == 128 ? wg * kBK * 128 : wg * 64 * 128);
    wgmma_fence();
    fence_acc(qa);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wgmma_ss<1, 1>(qa, smem_desc(ds_a + kk * 2048), smem_desc(kb + kk * 2048), kk > 0);
    wgmma_commit();
    fence_acc(qa);
    wgmma_wait_all();

    // rows are queries here, columns d
    const int col0 = D == 128 ? wg * 64 : 0;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int qrow = q0 + warp * 16 + g8 + 8 * ((i >> 1) & 1);
      const int col = col0 + 8 * (i >> 2) + 2 * t4;
      if (qrow < p.sq)
        atomicAdd(reinterpret_cast<float2*>(p.dq_accum +
                                            (((long long)bi * p.sq + qrow) * p.h + qh) * D + col),
                  make_float2(qa[i], qa[i + 1]));
    }
  }

  cp_async_wait_all();  // no copy is left in flight when the block exits
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh) {
    fence_acc(dv[hh]);
    fence_acc(dk[hh]);
    if (n_iter == 0)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[hh][i] = dv[hh][i] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.skv) continue;
    const long long off = (((long long)bi * p.skv + key[r]) * p.h_kv + kvh) * D;
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = hh * 64 + 8 * j + 2 * t4, i = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(p.dk + off + col) = pack_bf16(dk[hh][i], dk[hh][i + 1]);
        *reinterpret_cast<uint32_t*>(p.dv + off + col) = pack_bf16(dv[hh][i], dv[hh][i + 1]);
      }
  }
}

template <int D>
cudaError_t launch(const BwdParams& p, int b, cudaStream_t stream) {
  constexpr int smem = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // blockIdx.x walks (b, kv head), blockIdx.y the key tiles: the heaviest
  // (causal) tiles of every head first
  const dim3 grid(b * p.h_kv, (p.skv + kBK - 1) / kBK);
  flash_bwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dq_accum [b, sq, h, d] fp32 must be zero; dk, dv [b, skv, h_kv, d] bf16
// are written whole
extern "C" int lwm_flash_bwd(const void* q, const void* k, const void* v, const void* g,
                             const void* lse, const void* delta, const void* bias, void* dq_accum,
                             void* dk, void* dv, int b, int sq, int skv, int h, int h_kv, int d,
                             long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                             long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                             long long v_sh, long long g_sb, long long g_ss, long long g_sh,
                             long long bias_sb, long long bias_sr, int causal, int q_offset,
                             int kv_offset, float scale, void* stream) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.bias = static_cast<const float*>(bias);
  p.dq_accum = static_cast<float*>(dq_accum);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.h_kv = h_kv;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.g_sb = g_sb;
  p.g_ss = g_ss;
  p.g_sh = g_sh;
  p.bias_sb = bias_sb;
  p.bias_sr = bias_sr;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || skv <= 0) return cudaSuccess;  // nothing to write (dq stays 0)
  switch (d) {
    case 64:
      return launch<64>(p, b, s);
    case 128:
      return launch<128>(p, b, s);
    default:
      return cudaErrorInvalidValue;
  }
}
