// K1's fp32 route: flash-attention forward for fp32 q, k and v (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (lwm_tpu/ops/pallas_flash.py:199-285,
// reached through flash_attention_fwd_pallas :624-795) for fp32 operands, as
// the needle evals, fp32 training, speculative decoding and the CFG sampler
// run it. Same contract as csrc/flash_fwd.cu:
//   out = softmax(q·kᵀ·scale + bias, masked) · v, lse = m + log(l)
// with an additive fp32 bias per key [bb, 1, skv] or per (row, key)
// [bb, sq, skv], global-position causal masking (query i at q_offset +
// i·pos_stride, key j at kv_offset + j·pos_stride), segment ids (a logit
// kept only where the query's id equals the key's; their test on every
// tile while they are given), GQA (query head qh reads kv head qh / g), any kv
// layout whose head dim is contiguous (seq-major, or the cache's head-major
// [b, h_kv, T, d]: the strides say which). Logits at or below MASK_GUARD
// count as masked; rows with no valid key give out 0 and lse BIG_NEG. p
// stays fp32 (the twin rounds p to v.dtype, here fp32: no rounding).
//
// What bounds it on the card: 4·d flops per (query, key) pair and head on
// O((sq + skv)·d) bytes, so the products, far above the ridge at every
// shape but the verify's 8 queries. fp32 FMAs on the CUDA cores top out at
// 67 TFLOP/s; the tensor cores take TF32 at 495, but TF32 alone keeps ~3
// digits and the fp32 suite holds this route at 1e-5. So each product runs
// as three TF32 products on the tensor cores (CUTLASS's "3xTF32"): every
// fp32 operand x is split into hi = x rounded to TF32 (to nearest, ties
// away: `cvt.rna.tf32.f32`'s rounding) and lo = x − hi rounded the same
// way, and a·b is taken as hi·hi + lo·hi + hi·lo. The dropped lo·lo and
// lo's rounding leave ~2^-22 of |a·b|, an fp32 product's error. hi is
// rounded explicitly because the tensor cores read an fp32 bit pattern as
// TF32 by dropping its low 13 bits: lo must be taken from the hi that the
// product sees. Three products at the TF32 peak make 165 TFLOP/s at fp32
// accuracy, the bound beside this route's times. The tensor cores' fp32
// sums lose more than a rounding each (one accumulator across all keys put
// the verify 1.7e-5 off; PERF.md §6), so s sums hi·hi apart from the small
// cross terms, and each key tile's p·v starts from zero, cross terms first,
// and is added to o by an FMA.
// The design (FlashAttention-2's loop on `wgmma`, the keys split between
// two warpgroups):
// - One block per (b·h, 64-query tile), the heaviest (causally last) tiles
//   launched first. q arrives by TMA and is split in place once: its hi and
//   lo tiles stay in shared memory for every key tile.
// - Two warpgroups take alternate 32-key tiles over the same 64 rows, each
//   with its own slots, barriers and online softmax, and merge (m, l, o)
//   through shared memory at the end. So neither waits on the other: one's
//   softmax and split run while the other's products hold the tensor cores.
// - `wgmma` TF32 reads B (and A, unless from registers) K-major from
//   shared memory: for s = q·kᵀ that is k as it lies (keys are rows, d
//   contiguous), for o += p·v it is vᵀ (d rows, keys contiguous). So each
//   tile of k and v arrives raw by TMA (4-D tensor maps over the strides,
//   seq-major and head-major kv alike; keys past the end arrive as zeros)
//   into the warpgroup's slots; k is split there in place (lo beside it), v
//   into vᵀ's hi and lo tiles. As soon as q·kᵀ is done, the warpgroup's
//   first thread sends its next tile's TMA, whose copy then overlaps this
//   tile's softmax and p·v and the other warpgroup's tile.
// - s = q·kᵀ: m64n32k8 from shared memory, 3 × d/8 products. o += p·v:
//   m64n(d)k8 with p's hi and lo from registers: the accumulator of s is
//   the A fragment once p·v takes the keys of each group of 8 in the order
//   (0, 2, 4, 6, 1, 3, 5, 7), and vᵀ's columns are written in that order.
// - Online softmax per row in fp32, exponentials by the SFU's ex2.approx
//   (it holds the fp32 tolerance as expf does, 12-14% faster: PERF.md §6),
//   each row in one quad of threads; the causal and end-of-keys masks only
//   on tiles that cross them; tiles past the block's frontier never load.
// Tried (PERF.md §6, scripts/time_flash.py fwd32): `mma.sync` m16n8k8 with
// the split in registers (no hi/lo tiles, no transposed v): 124 TFLOP/s
// TF32 in its product loop against `wgmma`'s 475 (scripts/
// time_tf32_products.py), slower than the fp32 FMA route; 128-query blocks
// whose two warpgroups share each key tile (1.3× slower: they wait on each
// other at every tile's split); the next tile's split overlapped with p·v
// (no gain).
// Head dims: any d ≤ 128 with d % 4 == 0 (an fp32 row is then 16-byte
// aligned) on the tiles of 64 or 128 (hopper.cuh, launch_head_dim): the
// tensor maps end at d, so the boxes' columns past it arrive as zeros, and
// every product over the tile's width adds nothing there; o is stored up
// to d. One instance a tile width serves each d on it.

#include "tf32.cuh"

namespace {

using namespace lwm;

constexpr int kThreads = 256;  // two warpgroups, over alternate key tiles
constexpr int kBQ = 64;        // queries a block: the `wgmma` M
constexpr int kBK = 32;        // keys a tile: one 128-byte row of vᵀ

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  float* out;
  float* lse;
  int sq, skv, h, h_kv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long bias_sb, bias_sr;
  int causal, q_offset, kv_offset, pos_stride;
  float scale;
  const int* q_seg;   // [b, sq] or null
  const int* kv_seg;  // [b, skv]
  int q_dim[3], k_dim[3], v_dim[3];  // the tensor maps' dims of (seq, head, batch), 1..3
  int d;                             // the head dim, d ≤ D
};

// Shared memory of one block, byte offsets from a 1024-aligned base (224 KB
// at d 128). A tile of R rows × D floats is D / 32 column groups of R rows ×
// 128 bytes, 128-byte swizzled (swz32); vᵀ is D rows of kBK keys. Each
// warpgroup has its own k and v slots: TMA lands k in kK (split there in
// place into hi, lo beside it) and v in kV (split into vᵀ's hi and lo)
template <int D>
struct Smem {
  static constexpr int kQTile = kBQ * D * 4;
  static constexpr int kTile = kBK * D * 4;  // a k, v or vᵀ tile
  static constexpr int kQHi = 0;             // q arrives here, then is split in place
  static constexpr int kQLo = kQTile;
  static constexpr int kK = 2 * kQTile;      // + kWg * warpgroup
  static constexpr int kKLo = kK + kTile;
  static constexpr int kV = kKLo + kTile;
  static constexpr int kVHi = kV + kTile;
  static constexpr int kVLo = kVHi + kTile;
  static constexpr int kWg = 5 * kTile;
  static constexpr int kBar = kK + 2 * kWg;  // q's mbarrier, then each warpgroup's
  static constexpr int kBytes = kBar + 24;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const F32Params p) {
  using L = Smem<D>;
  constexpr int kGroups = D / 32;  // 128-byte column groups of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5;
  const int lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int bi = blockIdx.x / p.h, qh = blockIdx.x % p.h;
  const int kvh = qh / (p.h / p.h_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the heaviest tiles first
  // key tiles that the block's rows see; warpgroup wg takes tiles wg, wg + 2, ..
  int n_tiles = 0;
  {
    const int end = min(q0 + kBQ, p.sq);
    const int kv_end = p.causal ? causal_keys(p.q_offset + (end - 1) * p.pos_stride, p.kv_offset,
                                              p.pos_stride, p.skv)
                                : p.skv;
    n_tiles = (kv_end + kBK - 1) / kBK;
  }

  auto coord = [](const int (&dim)[3], int c, int seq, int head, int batch) {
    return dim[0] == c ? seq : dim[1] == c ? head : batch;
  };
  const uint32_t q_bar = base + L::kBar, kv_bar = base + L::kBar + 8 + 8 * wg;
  const uint32_t ws = base + L::kK + wg * L::kWg;  // this warpgroup's slots
  // tile j's raw k and v into this warpgroup's slots, from its first thread
  auto load_kv = [&](int j) {
    const int k0 = j * kBK;
    mbar_expect_tx(kv_bar, 2 * L::kTile);
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      tma_load4(ws + c * kBK * 128, &k_map, kv_bar, 32 * c, coord(p.k_dim, 1, k0, kvh, bi),
                coord(p.k_dim, 2, k0, kvh, bi), coord(p.k_dim, 3, k0, kvh, bi));
      tma_load4(ws + (L::kV - L::kK) + c * kBK * 128, &v_map, kv_bar, 32 * c,
                coord(p.v_dim, 1, k0, kvh, bi), coord(p.v_dim, 2, k0, kvh, bi),
                coord(p.v_dim, 3, k0, kvh, bi));
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(base + L::kBar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_bar, L::kQTile);
#pragma unroll
    for (int c = 0; c < kGroups; ++c)
      tma_load4(base + L::kQHi + c * kBQ * 128, &q_map, q_bar, 32 * c,
                coord(p.q_dim, 1, q0, qh, bi), coord(p.q_dim, 2, q0, qh, bi),
                coord(p.q_dim, 3, q0, qh, bi));
  }
  __syncthreads();  // the barriers are initialised
  if (wtid == 0 && wg < n_tiles) load_kv(wg);
  mbar_wait(q_bar, 0);
  // q → hi in place, lo beside it; the same swizzled offsets
  float4* q_hi = reinterpret_cast<float4*>(smem + L::kQHi);
  float4* q_lo = reinterpret_cast<float4*>(smem + L::kQLo);
  for (int i = tid; i < kBQ * D / 4; i += kThreads) split4(q_hi[i], q_hi[i], q_lo[i]);
  fence_async_smem();
  __syncthreads();

  const float* bias_g = p.bias ? p.bias + bi * p.bias_sb : nullptr;
  const bool key_bias = bias_g && p.bias_sr == 0;
  const int row = q0 + 16 * warp + g8;  // this thread's rows: row, row + 8
  const int q_pos = p.q_offset + row * p.pos_stride;  // the global position of the first
  const bool rows_in[2] = {row < p.sq, row + 8 < p.sq};
  const int* kseg_g = p.kv_seg ? p.kv_seg + (long long)bi * p.skv : nullptr;
  int qseg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (kseg_g && rows_in[r]) qseg[r] = p.q_seg[(long long)bi * p.sq + row + 8 * r];
  float m[2] = {kBigNeg, kBigNeg};  // running row max (natural scale)
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float o[D / 2];                   // the m64n(D) accumulator's layout (hopper.cuh)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  uint8_t* wsm = smem + L::kK + wg * L::kWg;
  float4* k_hi = reinterpret_cast<float4*>(wsm);  // the raw k tile, split in place
  float4* k_lo = reinterpret_cast<float4*>(wsm + (L::kKLo - L::kK));
  const uint8_t* raw_v = wsm + (L::kV - L::kK);
  float* v_hi = reinterpret_cast<float*>(wsm + (L::kVHi - L::kK));
  float* v_lo = reinterpret_cast<float*>(wsm + (L::kVLo - L::kK));
  // v is read a row-chunk a thread (key `lane`, d 4c .. 4c + 3) and written to
  // column v_pos of vᵀ's rows 4c .. 4c + 3: in each group of 8, keys (0, 2,
  // 4, 6, 1, 3, 5, 7) take columns 0..7
  const int v_pos = (lane & 24) | ((lane & 1) << 2) | ((lane >> 1) & 3);

  for (int j = wg, u = 0; j < n_tiles; j += 2, ++u) {
    const int k0 = j * kBK;
    if (u > 0) bar_sync(1 + wg, 128);  // every warp's p·v of the last tile is done: vᵀ is free
    mbar_wait(kv_bar, u & 1);          // tile j's raw k and v
    for (int i = wtid; i < kBK * D / 4; i += 128) split4(k_hi[i], k_hi[i], k_lo[i]);
    for (int c = warp; c < D / 4; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(raw_v + swz32<kBK>(lane, 4 * c));
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        split_tf32(xs[e], hi, lo);
        const int off = swz32<D>(4 * c + e, v_pos) >> 2;
        v_hi[off] = __uint_as_float(hi);
        v_lo[off] = __uint_as_float(lo);
      }
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);  // this warpgroup's split tiles are whole

    // s = q·kᵀ, 64 rows × 32 keys: hi·hi in sm, the cross terms in sc
    float sm[16], sc[16];
    fence_acc(sm);
    fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = (kk >> 2) * kBQ * 128 + (kk & 3) * 32;
      const uint32_t ko = (kk >> 2) * kBK * 128 + (kk & 3) * 32;
      const uint64_t q_h = smem_desc(base + L::kQHi + qo), k_h = smem_desc(ws + ko);
      wgmma_tf32_n32(sc, smem_desc(base + L::kQLo + qo), k_h, kk > 0);
      wgmma_tf32_n32(sc, q_h, smem_desc(ws + (L::kKLo - L::kK) + ko), 1);
      wgmma_tf32_n32(sm, q_h, k_h, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sm);
    fence_acc(sc);
    bar_sync(1 + wg, 128);  // every warp's q·kᵀ is done: the k slot is free
    if (wtid == 0 && j + 2 < n_tiles) load_kv(j + 2);

    // logits: scale and bias; element i is row row + 8·((i / 2) % 2), key
    // k0 + 8·(i / 4) + 2·t4 + i % 2. The causal and end-of-keys masks only on
    // tiles that cross them; MASK_GUARD on every logit (the bias masks too).
    // A per-key bias is read once a key
    const bool edge = k0 + kBK > p.skv || kseg_g ||
                      (p.causal && p.kv_offset + (k0 + kBK - 1) * p.pos_stride >
                                       p.q_offset + q0 * p.pos_stride);
    float kb[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int key = k0 + 8 * (c >> 1) + 2 * t4 + (c & 1);
      kb[c] = key_bias && key < p.skv ? __ldg(bias_g + key) : 0.f;
    }
    float mx[2] = {m[0], m[1]};
    float* s = sm;  // the logits, in place
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1, key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      float x = (sm[i] + sc[i]) * p.scale + kb[((i >> 2) << 1) | (i & 1)];
      const bool in = key < p.skv && rows_in[r];
      if (bias_g && !key_bias && in) x += bias_g[(row + 8 * r) * p.bias_sr + key];
      bool ok = x > kMaskGuard;
      if (edge)
        ok = ok && in &&
             (!p.causal || p.kv_offset + key * p.pos_stride <= q_pos + 8 * r * p.pos_stride) &&
             (!kseg_g || __ldg(kseg_g + key) == qseg[r]);
      s[i] = ok ? x : kBigNeg;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float alpha[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx((m[r] - mx[r]) * kLog2e);  // 1 while the row has no valid key
      m[r] = mx[r];
      ml[r] = m[r] * kLog2e;
    }
    // p = exp(x − m) by the SFU (ex2.approx holds the fp32 tolerance:
    // PERF.md §6), 0 where masked; then its hi and lo A fragments: key
    // chunk jj's (a0, a1, a2, a3) are elements 4jj + (0, 2, 1, 3)
    float rs[2] = {0.f, 0.f};
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      const float pe = s[i] > kMaskGuard ? exp2_approx(fmaf(s[i], kLog2e, -ml[r])) : 0.f;
      rs[r] += pe;
      split_tf32(pe, ph[i >> 2][(i & 1) * 2 + r], pl[i >> 2][(i & 1) * 2 + r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];

    // this tile's p·v from zero (t), the cross terms first so that each
    // hi·hi lands on a sum they have moved; then o = o·alpha + t
    float t[D / 2];
    fence_acc(t);
    fence_frag(ph);
    fence_frag(pl);
    wgmma_fence();
    const uint32_t vh = ws + (L::kVHi - L::kK), vl = ws + (L::kVLo - L::kK);
#pragma unroll
    for (int jj = 0; jj < kBK / 8; ++jj) {
      wgmma_tf32_rs(t, pl[jj], smem_desc(vh + jj * 32), jj > 0);
      wgmma_tf32_rs(t, ph[jj], smem_desc(vl + jj * 32), 1);
    }
#pragma unroll
    for (int jj = 0; jj < kBK / 8; ++jj) wgmma_tf32_rs(t, ph[jj], smem_desc(vh + jj * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(t);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], t[i]);
  }

  // the two warpgroups' rows merged by warpgroup 0: warpgroup 1 leaves its
  // (m, l, o), thread by thread, in its own slots
  __syncthreads();
  float* xchg = reinterpret_cast<float*>(smem + L::kK + L::kWg);
  if (wg == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xchg[r * 128 + wtid] = m[r];
      xchg[(2 + r) * 128 + wtid] = l[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) xchg[(4 + i) * 128 + wtid] = o[i];
  }
  __syncthreads();
  if (wg == 1) return;
  float a1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xchg[r * 128 + wtid], mm = fmaxf(m[r], m1);
    const float a0 = exp2_approx((m[r] - mm) * kLog2e);
    a1[r] = exp2_approx((m1 - mm) * kLog2e);
    l[r] = l[r] * a0 + xchg[(2 + r) * 128 + wtid] * a1[r];
    m[r] = mm;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4) {
      o[i] *= a0;
      o[i + 1] *= a0;
    }
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = fmaf(xchg[(4 + i) * 128 + wtid], a1[(i >> 1) & 1], o[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rows_in[r]) continue;
    const int qi = row + 8 * r;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* o_g = p.out + (((long long)bi * p.sq + qi) * p.h + qh) * p.d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n + 2 * t4 < p.d)
        *reinterpret_cast<float2*>(o_g + 8 * n + 2 * t4) =
            make_float2(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    if (t4 == 0)
      p.lse[((long long)bi * p.h + qh) * p.sq + qi] = l[r] > 0.f ? m[r] + logf(l[r]) : kBigNeg;
  }
}

// A (seq, head, batch) fp32 tensor with element strides as a 4-D map of
// [32 floats × `rows` of seq] boxes, 128-byte swizzled, the outer dims in
// increasing stride; dim[] says where seq, head and batch went
cudaError_t map4(CUtensorMap* map, int (&dim)[3], const void* ptr, int d, int seq, int heads,
                 int b, long long ss, long long sh, long long sb, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  long long size[3] = {seq, heads, b}, stride[3] = {ss, sh, sb};
  int box[3] = {rows, 1, 1}, order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)  // sort the outer dims by stride
    for (int k = i + 1; k < 3; ++k)
      if (stride[order[k]] < stride[order[i]]) {
        const int t = order[i];
        order[i] = order[k];
        order[k] = t;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d)}, strides[3];
  cuuint32_t boxes[4] = {32}, steps[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(size[order[i]]);
    strides[i] = static_cast<cuuint64_t>(stride[order[i]]) * 4;
    boxes[i + 1] = box[order[i]];
    dim[order[i]] = i + 1;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                            strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(F32Params& p, int b, cudaStream_t stream) {
  CUtensorMap q_map, k_map = {}, v_map = {};  // no keys: no kv tile is loaded
  cudaError_t e = map4(&q_map, p.q_dim, p.q, p.d, p.sq, p.h, b, p.q_ss, p.q_sh, p.q_sb, kBQ);
  if (e == cudaSuccess && p.skv > 0)
    e = map4(&k_map, p.k_dim, p.k, p.d, p.skv, p.h_kv, b, p.k_ss, p.k_sh, p.k_sb, kBK);
  if (e == cudaSuccess && p.skv > 0)
    e = map4(&v_map, p.v_dim, p.v, p.d, p.skv, p.h_kv, b, p.v_ss, p.v_sh, p.v_sb, kBK);
  if (e != cudaSuccess) return e;
  constexpr int smem = Smem<D>::kAlloc;
  e = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  // blockIdx.x walks (b, head), blockIdx.y the query tiles, heaviest first
  const dim3 grid(b * p.h, (p.sq + kBQ - 1) / kBQ);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(q_map, k_map, v_map, p);
  return cudaGetLastError();
}

}  // namespace

// The arguments of lwm_flash_fwd (csrc/flash_fwd.cu), every tensor fp32:
// q [b, sq, h, d]; k, v by their (batch, seq, head) strides; bias (or NULL)
// by its (batch, row) strides; out [b, sq, h, d] and lse [b, h, sq]
// contiguous.
extern "C" int lwm_flash_fwd_f32(const void* q, const void* k, const void* v, const void* bias,
                                 void* out, void* lse, int b, int sq, int skv, int h, int h_kv,
                                 int d, long long q_sb, long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                 long long v_ss, long long v_sh, long long bias_sb,
                                 long long bias_sr, int causal, int q_offset, int kv_offset,
                                 int pos_stride, float scale, const void* q_seg,
                                 const void* kv_seg, void* stream) {
  if (h_kv <= 0 || h % h_kv || pos_stride < 1 || (q_seg == nullptr) != (kv_seg == nullptr))
    return cudaErrorInvalidValue;
  if (sq <= 0 || b <= 0) return cudaSuccess;
  F32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
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
  return launch_head_dim(d, [&](auto D, auto) { return launch<decltype(D)::value>(p, b, s); });
}
