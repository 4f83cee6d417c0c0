// The fused backward's fp32 route: dq, dk and dv in one pass for fp32 q, k,
// v and g (sm_90a).
//
// Replaces the TPU kernels `_bwd_dq_kernel` (lwm_tpu/ops/pallas_flash.py:
// 288-353) and `_bwd_dkv_kernel` (:356-445), launched by
// `_flash_attention_bwd_single` (:903-1127), for fp32 operands, as the
// trainers run them at their default --dtype=fp32 (lwm_tpu/train.py:63;
// scripts/run_spec_natural.sh, run_context_extension.sh). Same contract as
// csrc/flash_bwd.cu, the backward of K1's fp32 route (flash_fwd_f32.cu):
//   logits = q·kᵀ·scale + bias, masked (causal by global position: query i
//            at q_offset + i·pos_stride, key j at kv_offset + j·pos_stride;
//            segment ids: kept only where the query's id equals the key's,
//            tested on every stage while they are given; keys ≥ skv, rows ≥ sq)
//   p  = logits > MASK_GUARD ? exp(logits − lse) : 0     (lse from K1)
//   dp = g·vᵀ,  ds = p·(dp − delta)·scale                  (delta = Σ g·out)
//   dv = pᵀ·g, dk = dsᵀ·q, dq = ds·k
// with an additive fp32 bias per key [bb, 1, skv] or per (row, key)
// [bb, sq, skv], GQA (query head qh reads kv head qh / g) and dk/dv
// returned at h_kv heads, every group member summed in fp32. Nothing is
// rounded to another type: p and ds stay fp32, as the TPU kernels keep them
// at fp32 inputs.
//
// What bounds it on the card: five products of 2·d flops per (query, key)
// pair and head (two recompute the forward's q·kᵀ and g·vᵀ), half of them
// for a causal row, on O((sq + skv)·d) bytes. The fp32 suite holds this
// route at 1e-5, so every product runs as three TF32 products on the tensor
// cores (csrc/tf32.cuh: hi·hi + lo·hi + hi·lo of each operand's split): 15
// TF32 products at 495 TFLOP/s, the bound beside this route's times, 2.46×
// below the fp32 FMA bound. The design keeps the loop of the FMA route it
// replaces (a block owns a key tile and walks the queries; dq by atomics),
// every product on `wgmma`:
// - One block of two warpgroups per (b·h_kv, 64-key tile), the heaviest
//   (causally first) key tiles of every head launched first. k and v are
//   split once into hi and lo tiles that stay in shared memory; the block
//   walks every (group member, 32-query stage) from the causal start; a
//   stage's q and g are split into hi/lo tiles as they lie, their rows
//   prefetched into the L2 a stage ahead.
// - sᵀ = k·qᵀ (warpgroup 0) and dpᵀ = v·gᵀ (warpgroup 1) side by side:
//   m64n32k8 from the tiles, hi·hi summed apart from the cross terms (dp −
//   delta cancels, so dp's error shows in ds). Each warpgroup hands the
//   other its sums of half the queries, and turns its half into p (expf)
//   and ds, written as pᵀ and dsᵀ hi/lo tiles.
// - `wgmma` reads 32-bit operands K-major only, and dv, dk and dq contract
//   over queries and keys, so they run transposed with A from registers:
//   dvᵀ = gᵀ·p, dkᵀ = qᵀ·ds (m64n64k8) and dqᵀ = kᵀ·dsᵀ (m64n32k8), their A
//   fragments gathered by 32-bit shared loads from the g, q and k tiles as
//   they lie (conflict-free in the swizzle), their B the pᵀ, dsᵀ and ds
//   tiles, whose columns take each group of 8 in the order (0, 2, 4, 6, 1,
//   3, 5, 7) that makes the gathered k index t4 row 2t4. At d 128 each
//   warpgroup takes 64 rows of d, so dkᵀ and dvᵀ cost it 64 fp32 registers.
// - Each stage's share of dv and dk starts from zero, cross terms first
//   (lo·lo among them: dv and dk sum over every query of the key), and is
//   added to them in fp32 registers (the tensor cores' fp32 sums lose more
//   than a rounding each; over 1024 stages at S32768 that would show); they
//   are written once, with no atomics. dq's share of the
//   block's 64 keys (hi·hi apart) is staged in shared memory and added into
//   the fp32 dq_accum [b, sq, h, d] with float4 atomics, whose order changes
//   from run to run: dq is not bit-reproducible.
// - Rows past sq and keys past skv arrive as zeros and are masked; the
//   causal and end masks only on stages that cross them.
// Shared memory at d 128: 224.25 KB of the 227 (one block an SM): k, v
// hi/lo 128, the stage's q, g hi/lo 64, pᵀ (then ds) 16 and dsᵀ 16 hi/lo.
// Registers: 255, with a few spilled. Measured (PERF.md §6, scripts/
// time_flash.py bwd32 and time_tf32_products.py, an H100 at 700 W): the
// FMA route it replaced 20.6-21.3 ms at b2 S4096, this one 16.4 (15.1 with
// ex2.approx and three products in dv and dk, as accurate against float64
// but further from the plain fp32 path in the fp32 train step's grads);
// `mma.sync` from hi/lo tiles runs 167 TFLOP/s TF32 against `wgmma`'s 475,
// so dv, dk and dq on it only tied the FMA route; by ablation, dqᵀ and its
// atomics take ~5.6 ms of 16.0, the two cross products 3.8; grouping heads
// so that dq's rows in flight fit the L2, and deriving addresses anew each
// stage, were slower (more spills).
// Head dims: any d ≤ 128 with d % 4 == 0 (fp32 rows then 16-byte aligned)
// on the tiles of 64 or 128 (kCols below 128 and not 64): q, g, k and v
// read up to d, the tiles' columns past it zero, so that every product over
// the tile's width adds nothing there; dq, dk and dv written up to d.

#include "tf32.cuh"

namespace {

using namespace lwm;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBK = 64;        // keys a block: the `wgmma` M of sᵀ and dpᵀ
constexpr int kBQ = 32;        // queries a stage: their `wgmma` N

struct BwdF32Params {
  const float* q;
  const float* k;
  const float* v;
  const float* g;
  const float* lse;    // [b, h, sq]
  const float* delta;  // [b, h, sq]
  const float* bias;   // [bb, rows, skv] or null
  float* dq_accum;     // [b, sq, h, d], zeroed by the caller
  float* dk;           // [b, skv, h_kv, d]
  float* dv;
  int sq, skv, h, h_kv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh;
  long long bias_sb, bias_sr;
  int causal, q_offset, kv_offset, pos_stride;
  float scale;
  const int* q_seg;   // [b, sq] or null
  const int* kv_seg;  // [b, skv]
  int d;              // the head dim: D, or (kCols) d < D on D-wide tiles
};

// Shared memory of one block, byte offsets from a 1024-aligned base, every
// tile swz32: k and v hi/lo [kBK][D] and the stage's q and g hi/lo [kBQ][D]
// as they lie; pᵀ hi/lo [kBK][kBQ] (later in the stage ds hi/lo [kBQ][kBK]
// in its place) and dsᵀ hi/lo [kBK][kBQ], whose columns take each group of
// 8 in the order (0, 2, 4, 6, 1, 3, 5, 7). The warpgroups' sums pass
// [16][128 threads] in dsᵀ's place, and the stage's dq [kBQ][D + 4] fp32 in
// pᵀ's and dsᵀ's; lse and delta [2][kBQ]
template <int D>
struct Smem {
  static constexpr int kKV = kBK * D * 4;
  static constexpr int kQG = kBQ * D * 4;
  static constexpr int kPT = kBK * kBQ * 4;
  static constexpr int kKHi = 0;
  static constexpr int kKLo = kKV;
  static constexpr int kVHi = 2 * kKV;
  static constexpr int kVLo = 3 * kKV;
  static constexpr int kQHi = 4 * kKV;
  static constexpr int kQLo = kQHi + kQG;
  static constexpr int kGHi = kQLo + kQG;
  static constexpr int kGLo = kGHi + kQG;
  static constexpr int kPHi = kGLo + kQG;  // pᵀ, then ds
  static constexpr int kPLo = kPHi + kPT;
  static constexpr int kDsHi = kPLo + kPT;  // p passed on, then dsᵀ
  static constexpr int kDsLo = kDsHi + kPT;
  static constexpr int kStat = kDsLo + kPT;
  static constexpr int kBytes = kStat + 2 * kBQ * 4;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// column of element c of a group of 8 in pᵀ, dsᵀ and ds: (0, 2, 4, 6, 1, 3,
// 5, 7) take columns 0..7
__device__ __forceinline__ int perm8(int c) {
  return (c & ~7) | ((c & 1) << 2) | ((c >> 1) & 3);
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* base, int off) {
  return *reinterpret_cast<const uint32_t*>(base + off);
}

// The A fragment of a product whose A is the transpose of an R-row tile
// (rows: the product's k, columns: its M): k chunk at row r = 8j + 2t4
// (k index t4; t4 + 4 is row r + 1), M rows c and c + 8 of this thread
template <int R>
__device__ __forceinline__ void gather_t(const uint8_t* tile, int r, int c, uint32_t (&a)[4]) {
  a[0] = ld32(tile, swz32<R>(r, c));
  a[1] = ld32(tile, swz32<R>(r, c + 8));
  a[2] = ld32(tile, swz32<R>(r + 1, c));
  a[3] = ld32(tile, swz32<R>(r + 1, c + 8));
}

// d = Aᵀ·B over kBQ queries as four TF32 products, from zero, lo·hi, hi·lo
// and lo·lo before hi·hi: A's hi/lo tile x (a stage's q or g, gathered), B's
// the tile at b_hi / b_lo (pᵀ or dsᵀ, K-major); 64 d rows from column c of
// x, 64 keys
__device__ __forceinline__ void product_over_queries(float (&t)[32], const uint8_t* x_hi,
                                                     const uint8_t* x_lo, int c, uint32_t b_hi,
                                                     uint32_t b_lo, int t4) {
  uint32_t fh[kBQ / 8][4], fl[kBQ / 8][4];
#pragma unroll
  for (int j = 0; j < kBQ / 8; ++j) {
    gather_t<kBQ>(x_hi, 8 * j + 2 * t4, c, fh[j]);
    gather_t<kBQ>(x_lo, 8 * j + 2 * t4, c, fl[j]);
  }
  fence_acc(t);
  fence_frag(fh);
  fence_frag(fl);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBQ / 8; ++j) {
    wgmma_tf32_rs(t, fl[j], smem_desc(b_hi + 32 * j), j > 0);
    wgmma_tf32_rs(t, fh[j], smem_desc(b_lo + 32 * j), 1);
    wgmma_tf32_rs(t, fl[j], smem_desc(b_lo + 32 * j), 1);
  }
#pragma unroll
  for (int j = 0; j < kBQ / 8; ++j) wgmma_tf32_rs(t, fh[j], smem_desc(b_hi + 32 * j), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(t);
}

// kCols: a head dim d = p.d other than D: q, g, k and v read up to d (the
// tiles' columns past it zero), dq, dk and dv written up to d
template <int D, bool kCols>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_f32_kernel(const BwdF32Params p) {
  using L = Smem<D>;
  constexpr int kD4 = D / 4;                        // float4 chunks of a row
  constexpr int kStage4 = kBQ * kD4;                // float4 chunks of a stage's q (or g)
  constexpr int kPre = 2 * kStage4 / kThreads;      // of q and g, a thread's chunks
  // at d 128 each warpgroup takes 64 columns of dvᵀ, dkᵀ and dqᵀ; at d 64
  // warpgroup 0 takes dvᵀ, 1 dkᵀ, and each half of dqᵀ's keys
  constexpr bool kHalves = D == 128;
  constexpr int kDqRow = D + 4;  // floats a row of dq in shared memory
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5;
  const int lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int bi = blockIdx.x / p.h_kv, kvh = blockIdx.x % p.h_kv;
  const int group = p.h / p.h_kv;
  const int k0 = blockIdx.y * kBK;
  const int keys = min(kBK, p.skv - k0);
  const float* bias_g = p.bias ? p.bias + bi * p.bias_sb : nullptr;
  const int d = kCols ? p.d : D;

  // the (group member, query stage) walk: from the first query that sees
  // any key of this tile
  const int q_start =
      p.causal ? first_query(p.kv_offset + k0 * p.pos_stride, p.q_offset, p.pos_stride) : 0;
  const int qt0 = q_start / kBQ;
  const int per = max(0, (p.sq + kBQ - 1) / kBQ - qt0);
  const int n_iter = group * per;

  // k and v, raw, into their hi tiles (rows past skv zero-filled)
  {
    const float* kg = p.k + bi * p.k_sb + (long long)k0 * p.k_ss + kvh * p.k_sh;
    const float* vg = p.v + bi * p.v_sb + (long long)k0 * p.v_ss + kvh * p.v_sh;
    for (int i = tid; i < kBK * kD4; i += kThreads) {
      const int r = i / kD4, c = i % kD4;
      const bool in = r < keys && 4 * c < d;
      const int off = swz32<kBK>(r, 4 * c);
      cp_async16(base + L::kKHi + off, in ? kg + r * p.k_ss + 4 * c : kg, in ? 16 : 0);
      cp_async16(base + L::kVHi + off, in ? vg + r * p.v_ss + 4 * c : vg, in ? 16 : 0);
    }
    cp_async_commit();
  }

  // the next stage's q and g rows into the L2 ahead of their split: one
  // 128-byte line a thread
  auto prefetch_l2 = [&](int it) {
    const int qh = kvh * group + it / per, q0 = (qt0 + it % per) * kBQ;
    constexpr int kLines = D / 32;   // of a row
    const int i = tid % (kBQ * kLines), r = i / kLines, c = 32 * (i % kLines);
    if (tid < 2 * kBQ * kLines && q0 + r < p.sq && c < d) {
      const float* src = tid < kBQ * kLines
                             ? p.q + bi * p.q_sb + (long long)(q0 + r) * p.q_ss + qh * p.q_sh
                             : p.g + bi * p.g_sb + (long long)(q0 + r) * p.g_ss + qh * p.g_sh;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(src + c));
    }
  };
  // a stage's q and g (rows past sq zero) split into their hi/lo tiles, and
  // its lse and delta (threads 0..63)
  auto load_stage = [&](int it) {
    const int qh = kvh * group + it / per, q0 = (qt0 + it % per) * kBQ;
    const int rows = min(kBQ, p.sq - q0);
    const float* qg = p.q + bi * p.q_sb + (long long)q0 * p.q_ss + qh * p.q_sh;
    const float* gg = p.g + bi * p.g_sb + (long long)q0 * p.g_ss + qh * p.g_sh;
    float4 x[kPre];
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int i = tid + j * kThreads;
      const int r = (i % kStage4) / kD4, c = i % kD4;
      const float* src = i < kStage4 ? qg + r * p.q_ss : gg + r * p.g_ss;
      x[j] = r < rows && 4 * c < d ? __ldg(reinterpret_cast<const float4*>(src + 4 * c))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid < 2 * kBQ) {
      const int r = tid % kBQ;
      const float* src = (tid < kBQ ? p.lse : p.delta) + ((long long)bi * p.h + qh) * p.sq + q0;
      reinterpret_cast<float*>(smem + L::kStat)[tid] = r < rows ? __ldg(src + r) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int i = tid + j * kThreads;
      const int r = (i % kStage4) / kD4, c = i % kD4;
      const int off = swz32<kBQ>(r, 4 * c);
      float4 hi, lo;
      split4(x[j], hi, lo);
      *reinterpret_cast<float4*>(smem + (i < kStage4 ? L::kQHi : L::kGHi) + off) = hi;
      *reinterpret_cast<float4*>(smem + (i < kStage4 ? L::kQLo : L::kGLo) + off) = lo;
    }
  };

  if (n_iter > 0) load_stage(0);  // while k and v land
  cp_async_wait_all();
  __syncthreads();  // k and v have landed
  {
    float4* k_hi = reinterpret_cast<float4*>(smem + L::kKHi);
    float4* k_lo = reinterpret_cast<float4*>(smem + L::kKLo);
    float4* v_hi = reinterpret_cast<float4*>(smem + L::kVHi);
    float4* v_lo = reinterpret_cast<float4*>(smem + L::kVLo);
    for (int i = tid; i < kBK * kD4; i += kThreads) {
      split4(k_hi[i], k_hi[i], k_lo[i]);
      split4(v_hi[i], v_hi[i], v_lo[i]);
    }
  }
  fence_async_smem();
  __syncthreads();

  // this thread's rows of sᵀ and dpᵀ: keys key_row and + 8 of the tile
  const int key_row = 16 * warp + g8;
  const bool key_bias = bias_g && p.bias_sr == 0;
  const bool full_bias = bias_g && p.bias_sr != 0;
  float kb[2];
  int kseg[2] = {0, 0};
  const int* qseg_g = p.q_seg ? p.q_seg + (long long)bi * p.sq : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + key_row + 8 * r;
    kb[r] = key_bias && key < p.skv ? bias_g[key] : 0.f;
    if (qseg_g && key < p.skv) kseg[r] = p.kv_seg[(long long)bi * p.skv + key];
  }

  // warpgroup 0: sᵀ = k·qᵀ → pᵀ; warpgroup 1: dpᵀ = v·gᵀ → dsᵀ
  const uint32_t a_hi = base + (wg ? L::kVHi : L::kKHi), a_lo = base + (wg ? L::kVLo : L::kKLo);
  const uint32_t b_hi = base + (wg ? L::kGHi : L::kQHi), b_lo = base + (wg ? L::kGLo : L::kQLo);
  float* swap = reinterpret_cast<float*>(smem + L::kDsHi);
  float* pt_hi = reinterpret_cast<float*>(smem + L::kPHi);
  float* pt_lo = reinterpret_cast<float*>(smem + L::kPLo);
  float* dst_hi = reinterpret_cast<float*>(smem + L::kDsHi);
  float* dst_lo = reinterpret_cast<float*>(smem + L::kDsLo);
  const float* stat = reinterpret_cast<const float*>(smem + L::kStat);
  // this thread's M rows (d) of dvᵀ, dkᵀ and dqᵀ: c_row and + 8
  const int d0 = kHalves ? 64 * wg : 0, c_row = d0 + 16 * warp + g8;

  // dvᵀ and dkᵀ [d0 .. d0 + 63][64 keys]: element i is d c_row + 8·((i / 2)
  // % 2), key 8·(i / 4) + 2t4 + i % 2
  float acc_v[32], acc_k[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_v[i] = acc_k[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int qh = kvh * group + it / per, q0 = (qt0 + it % per) * kBQ;
    if (it + 1 < n_iter) prefetch_l2(it + 1);

    // sᵀ or dpᵀ, 64 keys × 32 queries: hi·hi in xm, the cross terms in xc.
    // Element i: key key_row + 8·((i / 2) % 2), query 8·(i / 4) + 2t4 + i % 2
    float xm[16], xc[16];
    fence_acc(xm);
    fence_acc(xc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t ao = (kk >> 2) * kBK * 128 + (kk & 3) * 32;
      const uint32_t bo = (kk >> 2) * kBQ * 128 + (kk & 3) * 32;
      const uint64_t ah = smem_desc(a_hi + ao), bh = smem_desc(b_hi + bo);
      wgmma_tf32_n32(xc, smem_desc(a_lo + ao), bh, kk > 0);
      wgmma_tf32_n32(xc, ah, smem_desc(b_lo + bo), 1);
      wgmma_tf32_n32(xm, ah, bh, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(xm);
    fence_acc(xc);

    // p and ds, each warpgroup of half the elements (0: i < 8, queries 0..15;
    // 1: i >= 8): each passes the other its sums (warpgroup 0 sᵀ's, 1
    // dpᵀ's) of the other half in dsᵀ's place
    float sv[8], dpv[8];
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sv[i] = xm[i] + xc[i];
        swap[i * 128 + wtid] = xm[8 + i] + xc[8 + i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dpv[i] = xm[8 + i] + xc[8 + i];
        swap[(8 + i) * 128 + wtid] = xm[i] + xc[i];
      }
    }
    bar_sync(1, kThreads);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x = swap[((1 - wg) * 8 + i) * 128 + wtid];
      if (wg == 0) dpv[i] = x;
      else sv[i] = x;
    }
    bar_sync(1, kThreads);  // every sum is read: dsᵀ takes their place
    // element i of this warpgroup: key key_row + 8·((i / 2) % 2), query
    // 16·wg + 8·(i / 4) + 2t4 + i % 2. The logits: scale and bias; the
    // causal and end masks only on stages that cross them; MASK_GUARD on
    // every logit (the bias masks too)
    float ds[8];
    {
      const bool edge = k0 + kBK > p.skv || q0 + kBQ > p.sq || qseg_g ||
                        (p.causal && p.kv_offset + (k0 + kBK - 1) * p.pos_stride >
                                         p.q_offset + q0 * p.pos_stride);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i >> 1) & 1, kr = key_row + 8 * r, key = k0 + kr;
        const int qc = 16 * wg + 8 * (i >> 2) + 2 * t4 + (i & 1), qrow = q0 + qc;
        float x = sv[i] * p.scale + kb[r];
        bool ok = true;
        if (edge)
          ok = key < p.skv && qrow < p.sq &&
               (!p.causal ||
                p.kv_offset + key * p.pos_stride <= p.q_offset + qrow * p.pos_stride) &&
               (!qseg_g || __ldg(qseg_g + qrow) == kseg[r]);
        if (ok && full_bias) x += bias_g[(long long)qrow * p.bias_sr + key];
        const float pe =
            ok && x > kMaskGuard ? expf(x - stat[qc]) : 0.f;
        ds[i] = pe * (dpv[i] - stat[kBQ + qc]) * p.scale;
        const int at = swz32<kBK>(kr, perm8(qc)) >> 2;
        uint32_t hi, lo;
        split_tf32(pe, hi, lo);
        pt_hi[at] = __uint_as_float(hi);
        pt_lo[at] = __uint_as_float(lo);
        split_tf32(ds[i], hi, lo);
        dst_hi[at] = __uint_as_float(hi);
        dst_lo[at] = __uint_as_float(lo);
      }
    }
    fence_async_smem();
    __syncthreads();  // pᵀ and dsᵀ whole

    // dvᵀ += gᵀ·p (A gathered from g's tiles, B pᵀ), this stage's share
    // from zero, added in fp32
    if (kHalves || wg == 0) {
      float t[32];
      product_over_queries(t, smem + L::kGHi, smem + L::kGLo, c_row, base + L::kPHi,
                           base + L::kPLo, t4);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_v[i] += t[i];
    }
    // dkᵀ += qᵀ·ds (A gathered from q's tiles, B dsᵀ)
    if (kHalves || wg == 1) {
      float t[32];
      product_over_queries(t, smem + L::kQHi, smem + L::kQLo, c_row, base + L::kDsHi,
                           base + L::kDsLo, t4);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[i] += t[i];
    }
    __syncthreads();  // pᵀ read: ds takes its place
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t hi, lo;
      split_tf32(ds[i], hi, lo);
      const int at = swz32<kBQ>(16 * wg + 8 * (i >> 2) + 2 * t4 + (i & 1),
                                perm8(key_row + 8 * ((i >> 1) & 1))) >> 2;
      pt_hi[at] = __uint_as_float(hi);
      pt_lo[at] = __uint_as_float(lo);
    }
    fence_async_smem();
    __syncthreads();  // ds whole

    // dqᵀ = kᵀ·dsᵀ over the block's keys (A gathered from k's tiles, B ds):
    // d c_row + 8·((i / 2) % 2), query 8·(i / 4) + 2t4 + i % 2; hi·hi in
    // tm, the cross terms in tc; added into dq_accum by atomics
    {
      constexpr int kSteps = kHalves ? kBK / 8 : kBK / 16;  // of 8 keys, this warpgroup's
      const int kk0 = kHalves ? 0 : wg * kSteps;
      float tm[16], tc[16];
      fence_acc(tm);
      fence_acc(tc);
#pragma unroll
      for (int half = 0; half < kSteps / 4; ++half) {
        uint32_t fh[4][4], fl[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = kk0 + 4 * half + j;
          gather_t<kBK>(smem + L::kKHi, 8 * kk + 2 * t4, c_row, fh[j]);
          gather_t<kBK>(smem + L::kKLo, 8 * kk + 2 * t4, c_row, fl[j]);
        }
        fence_frag(fh);
        fence_frag(fl);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = kk0 + 4 * half + j;
          const uint32_t bo = (kk >> 2) * kBQ * 128 + (kk & 3) * 32;
          const uint64_t bh = smem_desc(base + L::kPHi + bo);
          wgmma_tf32_rs(tc, fl[j], bh, half > 0 || j > 0);
          wgmma_tf32_rs(tc, fh[j], smem_desc(base + L::kPLo + bo), 1);
          wgmma_tf32_rs(tm, fh[j], bh, half > 0 || j > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(tm);
        fence_acc(tc);
      }
      // dq [kBQ][D] (each warpgroup's part at d 64) into shared memory in
      // ds's and dsᵀ's place, rows padded to kDqRow floats, then added into
      // dq_accum by float4 atomics
      __syncthreads();  // ds and dsᵀ read
      float* dq_s = reinterpret_cast<float*>(smem + L::kPHi) + (kHalves ? 0 : wg * kBQ * kDqRow);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dq_s[(8 * (i >> 2) + 2 * t4 + (i & 1)) * kDqRow + c_row + 8 * ((i >> 1) & 1)] =
            tm[i] + tc[i];
    }
    __syncthreads();  // dq whole; every read of this stage's tiles and stats is done
    {
      const float* dq_s = reinterpret_cast<const float*>(smem + L::kPHi);
#pragma unroll
      for (int j = 0; j < kBQ * kD4 / kThreads; ++j) {
        const int i = tid + j * kThreads, r = i / kD4, c = 4 * (i % kD4);
        float4 x = *reinterpret_cast<const float4*>(dq_s + r * kDqRow + c);
        if (!kHalves) {
          const float4 y = *reinterpret_cast<const float4*>(dq_s + (kBQ + r) * kDqRow + c);
          x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
        }
        if (q0 + r < p.sq && c < d)
          atomicAdd(reinterpret_cast<float4*>(p.dq_accum +
                                              (((long long)bi * p.sq + q0 + r) * p.h + qh) * d + c),
                    x);
      }
    }
    if (it + 1 < n_iter) {
      load_stage(it + 1);
      fence_async_smem();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1), col = c_row + 8 * ((i >> 1) & 1);
    if (key >= p.skv || col >= d) continue;
    const long long off = (((long long)bi * p.skv + key) * p.h_kv + kvh) * d + col;
    if (kHalves || wg == 0) p.dv[off] = acc_v[i];
    if (kHalves || wg == 1) p.dk[off] = acc_k[i];
  }
}

template <int D, bool kCols = false>
cudaError_t launch(const BwdF32Params& p, int b, cudaStream_t stream) {
  constexpr int smem = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32_kernel<D, kCols>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // blockIdx.x walks (b, kv head), blockIdx.y the key tiles: the heaviest
  // (causal) tiles of every head first
  const dim3 grid(b * p.h_kv, (p.skv + kBK - 1) / kBK);
  flash_bwd_f32_kernel<D, kCols><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The arguments of lwm_flash_bwd (csrc/flash_bwd.cu), every tensor fp32:
// dq_accum [b, sq, h, d] must be zero; dk, dv [b, skv, h_kv, d] are
// written whole
extern "C" int lwm_flash_bwd_f32(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, const void* bias,
                                 void* dq_accum, void* dk, void* dv, int b, int sq, int skv,
                                 int h, int h_kv, int d, long long q_sb, long long q_ss,
                                 long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh, long long g_sb,
                                 long long g_ss, long long g_sh, long long bias_sb,
                                 long long bias_sr, int causal, int q_offset, int kv_offset,
                                 int pos_stride, float scale, const void* q_seg,
                                 const void* kv_seg, void* stream) {
  if (h_kv <= 0 || h % h_kv || pos_stride < 1 || (q_seg == nullptr) != (kv_seg == nullptr))
    return cudaErrorInvalidValue;
  BwdF32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.g = static_cast<const float*>(g);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.bias = static_cast<const float*>(bias);
  p.dq_accum = static_cast<float*>(dq_accum);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
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
  p.pos_stride = pos_stride;
  p.scale = scale;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || skv <= 0) return cudaSuccess;  // nothing to write (dq stays 0)
  return launch_head_dim(d, [&](auto D, auto cols) {
    return launch<decltype(D)::value, decltype(cols)::value>(p, b, s);
  });
}
