// K4: one-token flash decoding over a head-major KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` (lwm_tpu/ops/pallas_decode.py:66-140,
// reached through flash_decode_pallas :143-247). Same contract: q [b, 1, h, d]
// bf16; k, v [b, h_kv, T, d] bf16, or int8 with fp32 per-(token, head) scales
// [b, h_kv, T] (k scales multiply the logits, v scales multiply p before p
// is rounded to bf16 for p·v, the TPU kernel's order); a per-key bool mask
// [b, T] (left-pad holes and per-row frontiers); keys at or past kv_len are
// never read (kv_len is an upper bound; the mask does the exact part). The g
// query heads of a kv head share one read of its cache; a group other than
// 1/2/4/8 (the shared-prefix fold gives slots x g) is covered in chunks of 8
// query heads, a chunk a block, the chunks of a split side by side in the
// grid so that the k/v a split reads again comes from L2. A row with no valid
// key gives 0. With partials (m_out, l_out given) it also returns the row's
// max scaled logit m and l = Σ exp(s − m) (before the v scale), and o stays
// l-normalized: the TPU kernel's `return_partials`, with (0, BIG_NEG, 0) for
// a row with no valid key.
//
// What bounds it on the card: one decode step reads every valid cache byte
// once and does ~4 flops per element read, so HBM bandwidth bounds it, and
// the card needs tens of KB in flight on every SM to reach it. Design:
// - Split T: one block of 8 warps per (split of `split` keys, batch row, kv
//   head), a grid sized from T (static across decode rounds), so a short
//   batch or a single long row still fills the 132 SMs. A block first reads
//   its split's mask slice (one byte a thread, ballots into a bit a key);
//   a split past kv_len, or with no valid key, writes an empty partial
//   (m = BIG_NEG, l = 0) and exits without touching k or v.
// - The split's 32-key tiles that hold a valid key stream through a ring of
//   shared-memory stages by 16-byte cp.async from every thread (any key
//   stride that keeps rows 16-byte aligned; masked keys are zero-filled, not
//   read), int8 tiles at their stored width with their scale slices in the
//   same stage: 4 stages of a bf16 d-128 tile (64 KB, three blocks an SM at
//   g = 1), 8 of the narrower ones; 3 tiles in flight a block.
// - Arithmetic on CUDA cores in fp32 (a decode tile is g × 32 × d, far below
//   wgmma's shape): each key is read from shared memory by a group of d/8
//   lanes, 8 elements a lane (int8 converted by byte permutes, not by the
//   card's slow int→float instruction); each lane group keeps its own online
//   softmax (m, l, acc) for the g heads in log2 units (ex2), taking its keys
//   of a tile together, and the block merges its groups and writes the
//   split's unnormalized o, m and l to fp32 scratch [b, h, n_split, d + 2].
// - A merge kernel, one block per (batch row, query head), weighs the
//   non-empty splits by exp(m_i − max m) and writes o (and m, l).
// Measured (PERF.md §6): 78% of the bound at 8 slots of a 4096 cache, 87% at
// one slot of 65536 keys, 28-50% with GQA (g = 4), where the bytes do not
// set the pace: each key's softmax is repeated on its d/8 lanes (§7); at the
// prefix fold's groups 8-32, 10-42%: the per-head products on CUDA cores.

#include "hopper.cuh"

namespace {

using lwm::cp_async16;
using lwm::cp_async4;
using lwm::cp_async_commit;
using lwm::cp_async_wait;
using lwm::cp_async_wait_all;
using lwm::exp2_approx;
using lwm::i8x4_to_f32;
using lwm::kBigNeg;
using lwm::kLog2e;
using lwm::kMaskGuard;
using lwm::smem_addr;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 32;        // a tile is one ballot word of the mask
constexpr int kSplitStep = kThreads; // splits are whole multiples: one mask byte a thread a step
constexpr int kMaxSplit = 2048;
constexpr int kMergeThreads = 512;

struct DecParams {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const uint8_t* mask;
  float* part;           // [b, h, n_split, d + 2]: unnormalized o, then m, l
  __nv_bfloat16* out;    // [b, 1, h, d]
  float* m_out;          // [b, h] or null
  float* l_out;
  int h, h_kv, T, kv_len, split, n_split;
  int g, n_chunk;        // query heads a kv head; chunks of at most G of them (chunked kernels)
  long long q_sb, q_sh, kv_sb, kv_sh, kv_ss;
  float scale;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 8 consecutive cache elements (16 bytes bf16, 8 bytes int8) → float
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&dst)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* src, float (&dst)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  i8x4_to_f32(raw.x, *reinterpret_cast<float(*)[4]>(dst));
  i8x4_to_f32(raw.y, *reinterpret_cast<float(*)[4]>(dst + 4));
}

// shared-memory plan of the split kernel: a ring of stages, each a k tile,
// a v tile and (int8) their scale slices; after the loop the same bytes hold
// the lane groups' states for the block's merge
template <int D, int G, typename KV>
struct Plan {
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static constexpr int kTileBytes = kTileKeys * kRowBytes;
  // ~64 KB of ring: 4 stages of bf16 d 128, 8 of the narrower tiles
  static constexpr int kStages = kTileBytes >= 8192 ? 4 : 8;
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kStageBytes = 2 * kTileBytes + (kQuant ? 2 * kTileKeys * 4 : 0);
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kMerge = kWarps * G * (D + 2) * 4;
  static constexpr int kSmem = kRing > kMerge ? kRing : kMerge;
};

// blocks an SM the split kernel is compiled for: two up to g = 4 (≤ 128
// registers a thread), one at g = 8, whose heads' q and acc take 128
template <int G>
constexpr int kMinBlocks = G <= 4 ? 2 : 1;

// kChunked: a group g other than G = 1/2/4/8 is covered in chunks of G = 8
// query heads, one chunk a block, the chunks of a split next to each other
// in the grid (so a split's repeated k/v reads come from L2); the heads of
// a ragged last chunk past g are computed on zero q and never written
template <int D, int G, typename KV, bool kChunked>
__global__ void __launch_bounds__(kThreads, kMinBlocks<G>) decode_split_kernel(const DecParams p) {
  using P = Plan<D, G, KV>;
  constexpr int kLanesPerKey = D / 8;
  constexpr int kKeysPerWarp = 32 / kLanesPerKey;
  constexpr int kGroups = kWarps * kKeysPerWarp;
  constexpr int kPer = kTileKeys / kGroups;  // keys of a tile a lane group takes
  constexpr int kChunksPerRow = P::kRowBytes / 16;
  constexpr int kChunks = 2 * kTileKeys * kChunksPerRow;  // k and v of a tile, 16 bytes each
  constexpr int kElemsPerChunk = 16 / (int)sizeof(KV);
  static_assert(kLanesPerKey < 32 && kChunks % kThreads == 0, "d = 64 or 128");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t valid_bits[kMaxSplit / kTileKeys];
  __shared__ int tiles[kMaxSplit / kTileKeys];
  __shared__ int n_tiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = kChunked ? blockIdx.x / p.n_chunk : blockIdx.x, row = blockIdx.y;
  const int chunk = kChunked ? blockIdx.x % p.n_chunk : 0;
  const int nh = kChunked ? min(G, p.g - chunk * G) : G;  // the chunk's query heads
  const int bi = row / p.h_kv, kvh = row % p.h_kv;
  const int qh0 = kvh * (kChunked ? p.g : G) + chunk * G;  // the chunk's first query head
  const int key0 = split * p.split;
  const int key_end = min(key0 + p.split, min(p.kv_len, p.T));  // keys at or past kv_len: never read
  const long long head_stride = (long long)p.n_split * (D + 2);
  float* part = p.part + ((long long)(bi * p.h + qh0) * p.n_split + split) * (D + 2);

  // the split's mask slice, a bit a key: word w holds keys key0 + 32 w ..
  const uint8_t* mask = p.mask + (long long)bi * p.T;
  int any = 0;
  for (int base = 0; base < p.split; base += kSplitStep) {
    const int key = key0 + base + tid;
    const uint32_t bits = __ballot_sync(0xffffffffu, key < key_end && mask[key]);
    if (lane == 0) valid_bits[base / kTileKeys + warp] = bits;
    any |= bits != 0;
  }
  if (!__syncthreads_or(any)) {  // an empty partial; the merge skips it
    if (tid < nh) {
      part[tid * head_stride + D] = kBigNeg;
      part[tid * head_stride + D + 1] = 0.f;
    }
    return;
  }
  if (warp == 0) {  // the tiles that hold a valid key, in order
    const int n_words = p.split / kTileKeys;
    int c = 0;
    for (int base = 0; base < n_words; base += 32) {
      const bool has = base + lane < n_words && valid_bits[base + lane] != 0;
      const uint32_t bal = __ballot_sync(0xffffffffu, has);
      if (has) tiles[c + __popc(bal & ((1u << lane) - 1u))] = base + lane;
      c += __popc(bal);
    }
    if (lane == 0) n_tiles = c;
  }
  __syncthreads();
  const int nt = n_tiles;

  const KV* k_row = static_cast<const KV*>(p.k) + bi * p.kv_sb + kvh * p.kv_sh;
  const KV* v_row = static_cast<const KV*>(p.v) + bi * p.kv_sb + kvh * p.kv_sh;
  const long long sc_row = ((long long)bi * p.h_kv + kvh) * p.T;
  const uint32_t ring = smem_addr(smem);

  // the i-th listed tile into stage i % kStages: every thread copies its
  // 16-byte chunks; masked keys are zero-filled (no bytes read). One commit
  // group a call, empty past the last tile, so wait_group counts stay fixed.
  auto load_tile = [&](int i) {
    if (i < nt) {
      const int t = tiles[i];
      const uint32_t bits = valid_bits[t];
      const int kb = key0 + t * kTileKeys;
      const uint32_t stage = ring + (i % P::kStages) * P::kStageBytes;
#pragma unroll
      for (int j = 0; j < kChunks / kThreads; ++j) {
        const int c = tid + j * kThreads;
        const int which = c / (kTileKeys * kChunksPerRow);  // 0: k, 1: v
        const int r = (c / kChunksPerRow) % kTileKeys, ch = c % kChunksPerRow;
        const bool ok = (bits >> r) & 1u;
        const KV* src = (which ? v_row : k_row) + (kb + r) * p.kv_ss + ch * kElemsPerChunk;
        cp_async16(stage + which * P::kTileBytes + r * P::kRowBytes + ch * 16,
                   ok ? (const void*)src : p.k, ok ? 16 : 0);
      }
      if (P::kQuant && tid < 2 * kTileKeys) {
        const int r = tid % kTileKeys;
        const bool ok = (bits >> r) & 1u;
        const float* src = (tid < kTileKeys ? p.k_scale : p.v_scale) + sc_row + kb + r;
        cp_async4(stage + 2 * P::kTileBytes + tid * 4, ok ? (const void*)src : p.k_scale,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < P::kStages - 1; ++i) load_tile(i);

  const int sub = lane / kLanesPerKey, li = lane % kLanesPerKey;
  const int grp = warp * kKeysPerWarp + sub;
  float qr[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (!kChunked || j < nh) {
      load8(p.q + bi * p.q_sb + (qh0 + j) * p.q_sh + li * 8, qr[j]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[j][e] = 0.f;
    }
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = kBigNeg;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }

  const float scale2 = p.scale * kLog2e;  // logits in log2 units: p = 2^(s − m) by ex2
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<P::kStages - 2>();  // this thread's chunks of tile i have landed
    __syncthreads();                  // everyone's have, and tile i - 1 is consumed
    load_tile(i + P::kStages - 1);    // into the stage tile i - 1 held
    const unsigned char* stage = smem + (i % P::kStages) * P::kStageBytes;
    const KV* kt = reinterpret_cast<const KV*>(stage);
    const KV* vt = reinterpret_cast<const KV*>(stage + P::kTileBytes);
    const float* sc = reinterpret_cast<const float*>(stage + 2 * P::kTileBytes);
    const uint32_t bits = valid_bits[tiles[i]];
    // the lane group's keys of this tile, taken together: one rescale of
    // (l, acc) a tile, and kPer independent dot-product chains. Masked keys
    // were zero-filled; their logits are set to BIG_NEG and their p to 0.
    float kf[kPer][8], vf[kPer][8], ks2[kPer], vsc[kPer];
    bool ok[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int kk = grp + u * kGroups;
      ok[u] = (bits >> kk) & 1u;
      load8(kt + kk * D + li * 8, kf[u]);
      load8(vt + kk * D + li * 8, vf[u]);
      ks2[u] = P::kQuant ? sc[kk] * scale2 : scale2;
      vsc[u] = P::kQuant ? sc[kTileKeys + kk] : 1.f;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float s[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        s[u] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s[u] = fmaf(qr[j][e], kf[u][e], s[u]);
      }
#pragma unroll
      for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kPer; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      float m_new = m[j];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        s[u] = ok[u] ? s[u] * ks2[u] : kBigNeg;
        m_new = fmaxf(m_new, s[u]);
      }
      const float alpha = exp2_approx(m[j] - m_new);
      l[j] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const float pe = ok[u] ? exp2_approx(s[u] - m_new) : 0.f;
        l[j] += pe;
        const float pv = bf16_round(P::kQuant ? pe * vsc[u] : pe);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(pv, vf[u][e], acc[j][e]);
      }
      m[j] = m_new;
    }
  }
  cp_async_wait_all();

  // merge the lane groups of this warp (lanes li, li + kLanesPerKey, ...)
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int off = kLanesPerKey; off < 32; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[j], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[j], off);
      const float mn = fmaxf(m[j], m2);
      const float a1 = exp2_approx(m[j] - mn), a2 = exp2_approx(m2 - mn);
      l[j] = l[j] * a1 + l2 * a2;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc2 = __shfl_xor_sync(0xffffffffu, acc[j][e], off);
        acc[j][e] = acc[j][e] * a1 + acc2 * a2;
      }
      m[j] = mn;
    }
  }
  __syncthreads();  // the ring is free: reuse it for the warps' states
  float* st = reinterpret_cast<float*>(smem);  // [warp][head][D + 2]: acc, m, l
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float* w = st + (warp * G + j) * (D + 2);
      if (li == 0) {
        w[D] = m[j];
        w[D + 1] = l[j];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) w[li * 8 + e] = acc[j][e];
    }
  }
  __syncthreads();

  // across warps, per head: the split's unnormalized o (columns 0 .. D - 1),
  // and with column D its max m and its l, which is summed like o
  for (int i = tid; i < G * (D + 1); i += kThreads) {
    const int j = i / (D + 1), c = i % (D + 1);
    float mx = kBigNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, st[(w * G + j) * (D + 2) + D]);
    const int src = c < D ? c : D + 1;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ws = st + (w * G + j) * (D + 2);
      o += ws[src] * exp2_approx(ws[D] - mx);
    }
    if (kChunked && j >= nh) continue;
    if (c < D) {
      part[j * head_stride + c] = o;
    } else {
      part[j * head_stride + D] = mx * (1.f / kLog2e);  // back to natural-log units
      part[j * head_stride + D + 1] = o;
    }
  }
}

// one block per (batch row, query head): o = Σ w_i o_i / Σ w_i l_i over the
// splits with a valid key, w_i = exp(m_i − max m); empty splits are skipped
// by their m (their o was never written)
template <int D>
__global__ void __launch_bounds__(kMergeThreads) decode_merge_kernel(const DecParams p) {
  constexpr int kCols = D / 2;                     // a float2 of o a thread
  constexpr int kGroups = kMergeThreads / kCols;   // splits walked in parallel
  __shared__ float red[kMergeThreads / 32];
  __shared__ float2 sum_o[kGroups][kCols];
  __shared__ float sum_l[kGroups];

  const int bh = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* part = p.part + (long long)bh * p.n_split * (D + 2);

  float mx = kBigNeg;
  for (int i = tid; i < p.n_split; i += kMergeThreads) mx = fmaxf(mx, part[i * (D + 2) + D]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) mx = fmaxf(mx, red[w]);

  const int col = tid % kCols, g = tid / kCols;
  float2 o = make_float2(0.f, 0.f);
  float lsum = 0.f;
#pragma unroll 8
  for (int i = g; i < p.n_split; i += kGroups) {
    const float* ps = part + (long long)i * (D + 2);
    const float mi = ps[D];
    if (mi > kMaskGuard) {
      const float w = expf(mi - mx);
      const float2 oi = *reinterpret_cast<const float2*>(ps + 2 * col);
      o.x += w * oi.x;
      o.y += w * oi.y;
      lsum += w * ps[D + 1];
    }
  }
  sum_o[g][col] = o;
  if (col == 0) sum_l[g] = lsum;
  __syncthreads();
  if (g != 0) return;
#pragma unroll
  for (int s = 1; s < kGroups; ++s) {
    o.x += sum_o[s][col].x;
    o.y += sum_o[s][col].y;
    lsum += sum_l[s];
  }
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)bh * D + 2 * col) =
      __floats2bfloat162_rn(o.x * inv, o.y * inv);
  if (p.m_out != nullptr && col == 0) {
    p.m_out[bh] = lsum > 0.f ? mx : kBigNeg;
    p.l_out[bh] = lsum;
  }
}

template <int D, int G, typename KV, bool kChunked>
cudaError_t launch_kv(const DecParams& p, int b, cudaStream_t stream) {
  constexpr int smem = Plan<D, G, KV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<D, G, KV, kChunked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<D, G, KV, kChunked>
      <<<dim3(p.n_split * p.n_chunk, b * p.h_kv), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<D><<<b * p.h, kMergeThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int G, bool kChunked = false>
cudaError_t launch_g(const DecParams& p, int b, int quant, cudaStream_t stream) {
  return quant ? launch_kv<D, G, int8_t, kChunked>(p, b, stream)
               : launch_kv<D, G, __nv_bfloat16, kChunked>(p, b, stream);
}

template <int D>
cudaError_t launch_d(const DecParams& p, int b, int g, int quant, cudaStream_t stream) {
  switch (g) {
    case 1:
      return launch_g<D, 1>(p, b, quant, stream);
    case 2:
      return launch_g<D, 2>(p, b, quant, stream);
    case 4:
      return launch_g<D, 4>(p, b, quant, stream);
    case 8:
      return launch_g<D, 8>(p, b, quant, stream);
    default:  // any other group: chunks of 8 query heads
      return launch_g<D, 8, true>(p, b, quant, stream);
  }
}

}  // namespace

// part: fp32 scratch of [b, h, ceil(T / split), d + 2], written and read here
// (no initial value); m_out, l_out: [b, h] fp32, or both null for o alone.
// split: keys a block, a multiple of 256 up to 2048.
extern "C" int lwm_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale, const void* mask,
                                void* out, void* m_out, void* l_out, void* part, int b, int h,
                                int h_kv, int T, int d, int kv_len, int quant, int split,
                                long long q_sb, long long q_sh, long long kv_sb, long long kv_sh,
                                long long kv_ss, float scale, void* stream) {
  if (split <= 0 || split % kSplitStep || split > kMaxSplit) return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  if (h_kv <= 0 || h % h_kv) return cudaErrorInvalidValue;
  if (b <= 0) return cudaSuccess;
  DecParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.mask = static_cast<const uint8_t*>(mask);
  p.part = static_cast<float*>(part);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.h = h;
  p.h_kv = h_kv;
  p.T = T;
  p.kv_len = kv_len;
  p.split = split;
  p.n_split = (T + split - 1) / split;
  p.g = h / h_kv;
  p.n_chunk = (p.g == 1 || p.g == 2 || p.g == 4 || p.g == 8) ? 1 : (p.g + 7) / 8;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.kv_sb = kv_sb;
  p.kv_sh = kv_sh;
  p.kv_ss = kv_ss;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = p.g;
  switch (d) {
    case 64:
      return launch_d<64>(p, b, g, quant, s);
    case 128:
      return launch_d<128>(p, b, g, quant, s);
    default:
      return cudaErrorInvalidValue;
  }
}
