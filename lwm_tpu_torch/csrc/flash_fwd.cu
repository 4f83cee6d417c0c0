// K1: flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the TPU kernel `_fwd_kernel` (lwm_tpu/ops/pallas_flash.py:199-285,
// reached through flash_attention_fwd_pallas :624-795). Same contract:
//   out = softmax(q·kᵀ·scale + bias, masked) · v, lse = m + log(l)
// with an additive fp32 bias per key [bb, 1, skv] or per (row, key)
// [bb, sq, skv], global-position causal masking (query i at q_offset + i,
// key j at kv_offset + j), GQA (query head qh reads kv head qh / g), and any
// kv layout whose head dim is contiguous (seq-major or the cache's
// head-major [b, h_kv, T, d]: the strides say which). p is rounded to bf16
// before p·v. Rows with no valid key give out 0 and lse BIG_NEG (the TPU
// kernel leaves a mean of v there; the module contract says 0).
//
// What bounds it on the card: at admission and training widths (q ≥ 256
// over ≥ 2048 keys, d 128) it does 4·d flops per (query, key) pair and head
// on O((sq + skv)·d) bytes, far above the H100's ~295 flop/byte ridge, so
// tensor-core throughput bounds it, and only `wgmma` reaches the tensor
// cores' full rate. Beside the products, every (query, key) pair costs an
// exponential on the SFU and a handful of instructions issued by two warps a
// scheduler, and those set the pace here (PERF.md §6). The design
// (FlashAttention-2's loop on Hopper's products, with FlashAttention-3's
// overlap inside a warpgroup):
// - One block of two warpgroups per (b·h, 128-query tile); each warpgroup
//   owns 64 query rows, the `wgmma` M. The q tile is loaded once by
//   `cp.async` into 128-byte-swizzled shared memory (hopper.cuh).
// - The block walks 128-key tiles up to the causal frontier. Thread 0
//   loads tile j + 1's k and v by TMA (4-D tensor maps over the kv strides,
//   so seq-major and head-major kv alike, keys past skv zero-filled) while
//   tile j computes; an mbarrier counts the bytes. The per-key bias slice
//   (BIG_NEG past skv) is staged beside it by `cp.async`.
// - Step j issues s = q·kᵀ of tile j (m64n128k16, both operands from shared
//   memory, k read K-major: keys are the N rows, d contiguous, as stored)
//   and then o += p·v of tile j − 1 (p from registers, v read N-major, one
//   m64n64k16 per 64-wide half of d, so v is never transposed). Tile j's
//   softmax runs while the tensor cores finish p·v; v therefore has three
//   stages, k two.
// - Online softmax in registers: each accumulator row lives in one quad of
//   threads (two shuffles for its max); exponentials by `ex2.approx` with
//   log2(e) folded into the row max. The MASK_GUARD test is kept without a
//   compare per logit: while a row has no logit above MASK_GUARD its max is
//   taken as 0, so masked logits (bias BIG_NEG or finfo(bf16).min) give
//   2^(−huge) = 0 exactly, as the twin's guard does. p, rounded to bf16 in
//   pairs, is exactly the A fragment of p·v (hopper.cuh).
// - The full-tile bias and the causal test run only on the tiles that need
//   them (a full-tile bias; tiles that cross the warpgroup's diagonal); a
//   warpgroup skips tiles past its own frontier, and tiles past the
//   block's are never loaded. The heaviest query tiles (causally the last)
//   launch in the first waves.
// Tried (PERF.md §6, timed by scripts/time_flash.py on an H100): exp2f with
// a compare per logit (1.3× slower: the softmax is issue-bound), k and v by
// cp.async from every thread (1.07×), p·v after the softmax instead of
// behind the next q·kᵀ (1.04×), tree reductions for the row max and sum (no
// change), warpgroups decoupled by mbarrier stage release (2-6% faster, not
// worth its protocol) and a ping-pong of the two warpgroups on top (no
// faster). Not yet: a producer warpgroup.

#include "hopper.cuh"

namespace {

using namespace lwm;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // queries per block: 64 per warpgroup
constexpr int kBN = 128;       // keys per kv tile

struct FwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;
  __nv_bfloat16* out;
  float* lse;
  int sq, skv, h, h_kv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long bias_sb, bias_sr;
  int causal, q_offset, kv_offset;
  float scale;
  int k_dim[3], v_dim[3];  // the tensor maps' dims of (seq, head, batch), 1..3
};

// Shared memory of one block, byte offsets from a 1024-aligned base; tiles
// in the swizzled layout of hopper.cuh
template <int D>
struct Smem {
  static constexpr int kTile = kBN * D * 2;     // a k (or v) tile, per stage
  static constexpr int kQ = 0;
  static constexpr int kK = kBM * D * 2;        // two stages
  static constexpr int kV = kK + 2 * kTile;     // three stages: p·v of tile j − 1 runs in step j
  static constexpr int kBias = kV + 3 * kTile;  // per-key bias: [stage][kBN] fp32
  static constexpr int kBar = kBias + 2 * kBN * 4;  // two mbarriers: tile j's k and v
  static constexpr int kBytes = kBar + 16;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// TMA: the box at coordinates c of a 4-D map into shared memory; rows past
// the map's extent arrive as zeros
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const FwdParams p) {
  using L = Smem<D>;
  constexpr int kHalves = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int bi = blockIdx.x / p.h, hi = blockIdx.x % p.h;
  const int kvh = hi / (p.h / p.h_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // the heaviest tiles first

  const float* bias_g = p.bias ? p.bias + bi * p.bias_sb : nullptr;
  const bool key_bias = bias_g && p.bias_sr == 0;
  const bool full_bias = bias_g && p.bias_sr != 0;

  // kv tiles that the query rows [first, end) see
  auto n_tiles_for = [&](int first, int end) {
    if (end <= first) return 0;
    const int kv_end = p.causal ? min(p.skv, p.q_offset + end - p.kv_offset) : p.skv;
    return kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;
  };
  const int wq0 = q0 + wg * 64;  // this warpgroup's first row
  const int n_tiles = n_tiles_for(q0, min(q0 + kBM, p.sq));
  const int n_mine = n_tiles_for(wq0, min(wq0 + 64, p.sq));

  // tile j: k and the bias into stage j % 2, v into stage j % 3; k and v by
  // TMA from thread 0, counted in bytes on barrier j % 2; the bias by cp.async
  auto coord = [&](const int (&dim)[3], int c, int k0) {
    return dim[0] == c ? k0 : dim[1] == c ? kvh : bi;
  };
  auto load_kv = [&](int j) {
    const int k0 = j * kBN, rows = min(kBN, p.skv - k0);
    if (tid == 0) {
      const uint32_t bar = base + L::kBar + (j & 1) * 8;
      mbar_expect_tx(bar, 2 * L::kTile);
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh) {
        tma_load4(base + L::kK + (j & 1) * L::kTile + hh * kBN * 128, &k_map, bar, hh * 64,
                  coord(p.k_dim, 1, k0), coord(p.k_dim, 2, k0), coord(p.k_dim, 3, k0));
        tma_load4(base + L::kV + (j % 3) * L::kTile + hh * kBN * 128, &v_map, bar, hh * 64,
                  coord(p.v_dim, 1, k0), coord(p.v_dim, 2, k0), coord(p.v_dim, 3, k0));
      }
    }
    if (tid < kBN) {  // the per-key bias; keys past skv are masked here
      const int off = L::kBias + ((j & 1) * kBN + tid) * 4;
      if (key_bias && tid < rows)
        cp_async4(base + off, bias_g + k0 + tid, 4);
      else
        *reinterpret_cast<float*>(smem + off) = tid < rows ? 0.f : kBigNeg;
    }
  };

  if (tid == 0) {
    mbar_init(base + L::kBar, 1);
    mbar_init(base + L::kBar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_tile<D, kBM, kThreads>(base + L::kQ,
                              p.q + bi * p.q_sb + (long long)q0 * p.q_ss + hi * p.q_sh, p.q_ss,
                              min(kBM, p.sq - q0), tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // this thread's two rows (accumulator rows g8 and g8 + 8 of its warp)
  const int row = wq0 + warp * 16 + g8;
  const int q_pos = p.q_offset + row;  // global position of row 0 (row 1: + 8)
  float m[2] = {kBigNeg, kBigNeg};     // running row max (natural scale)
  float l[2] = {0.f, 0.f};             // thread-partial row sums (quad-reduced at the end)
  float o[kHalves][32];
  uint32_t pa[kBN / 16][4];  // p of the last tile, bf16 A fragments of its p·v
#pragma unroll
  for (int jj = 0; jj < kBN / 16; ++jj) pa[jj][0] = pa[jj][1] = pa[jj][2] = pa[jj][3] = 0u;

  // o (+)= p·v over the v tile in `stage`: p from registers, v N-major, one
  // product per 64-wide half of d
  auto issue_pv = [&](int stage, int scale_d) {
    const uint32_t v_s = base + L::kV + stage * L::kTile;
#pragma unroll
    for (int jj = 0; jj < kBN / 16; ++jj)
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
        wgmma_rs(o[hh], pa[jj], smem_desc(v_s + hh * kBN * 128 + jj * 16 * 128), scale_d);
    wgmma_commit();
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) fence_acc(o[hh]);
    fence_frag(pa);
  };

  // step j: s = q·kᵀ of tile j, then p·v of tile j − 1, so that tile j's
  // softmax runs while the tensor cores finish p·v. Step 0's p·v has p = 0
  // over v of tile 0 with scale-d 0: it sets o to 0 with no branch around
  // the products
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    cp_async_wait_all();  // this thread's copies of the bias of tile j (and of q)
    mbar_wait(base + L::kBar + (j & 1) * 8, (j >> 1) & 1);  // k and v of tile j
    fence_async_smem();
    __syncthreads();      // tile j complete; step j − 1 is done with its stages
    if (j + 1 < n_tiles) load_kv(j + 1);
    cp_async_commit();
    if (j >= n_mine) continue;  // past this warpgroup's causal frontier, or no rows

    // s = q·kᵀ: this warpgroup's 64 rows × 128 keys, k = d
    const uint32_t q_s = base + L::kQ + wg * 64 * 128;
    const uint32_t k_s = base + L::kK + (j & 1) * L::kTile;
    float sa[64];
    fence_acc(sa);
    fence_o();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16(sa, smem_desc(q_s + (kk >> 2) * kBM * 128 + (kk & 3) * 32),
                       smem_desc(k_s + (kk >> 2) * kBN * 128 + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    issue_pv(j > 0 ? (j - 1) % 3 : 0, j > 0);
    wgmma_wait<1>();  // s is ready; p·v of tile j − 1 runs on
    fence_acc(sa);

    // logits: scale and the per-key bias; the full-tile bias and the causal
    // mask only where a tile needs them
    const float* kb = reinterpret_cast<const float*>(smem + L::kBias) + (j & 1) * kBN;
#pragma unroll
    for (int c8 = 0; c8 < kBN / 8; ++c8) {
      const float2 b2 = *reinterpret_cast<const float2*>(kb + 8 * c8 + 2 * t4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sa[4 * c8 + 2 * r] = fmaf(sa[4 * c8 + 2 * r], p.scale, b2.x);
        sa[4 * c8 + 2 * r + 1] = fmaf(sa[4 * c8 + 2 * r + 1], p.scale, b2.y);
      }
    }
    const bool diag = p.causal && p.kv_offset + k0 + kBN - 1 > p.q_offset + wq0;
    if (full_bias || diag)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1, key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (full_bias && key < p.skv)
          sa[i] += bias_g[min(row + 8 * r, p.sq - 1) * p.bias_sr + key];
        if (diag && p.kv_offset + key > q_pos + 8 * r) sa[i] = kBigNeg;
      }
    float mt[2] = {m[0], m[1]};  // the row max
#pragma unroll
    for (int i = 0; i < 64; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sa[i]);
    float alpha[2], m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      alpha[r] = exp2_approx((m[r] - mt[r]) * kLog2e);
      m[r] = mt[r];
      // a row with no valid key yet (m at MASK_GUARD or below) takes 0, so
      // that its masked logits still give 2^(−huge) = 0: the MASK_GUARD
      // test without a compare per logit
      m2[r] = m[r] > kMaskGuard ? m[r] * kLog2e : 0.f;
    }

    // p = exp(x − m), 0 where x ≤ MASK_GUARD, in place
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      sa[i] = exp2_approx(fmaf(sa[i], kLog2e, -m2[r]));
      rs[r] += sa[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];

    wgmma_wait<0>();  // p·v of tile j − 1 is done with o and pa
    fence_o();
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] *= alpha[(i >> 1) & 1];
    // p rounded to bf16 in pairs: elements 8jj .. 8jj + 7 are the A
    // fragments of 16-key chunk jj (hopper.cuh)
#pragma unroll
    for (int jj = 0; jj < kBN / 16; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[jj][e] = pack_bf16(sa[8 * jj + 2 * e], sa[8 * jj + 2 * e + 1]);
  }
  // p·v of this warpgroup's last tile: its v stage is not reloaded after
  // step n_mine − 1 (the two warpgroups' tile counts differ by at most one)
  if (n_mine > 0) {
    fence_o();
    wgmma_fence();
    issue_pv((n_mine - 1) % 3, 1);
    wgmma_wait<0>();
    fence_o();
  }
  cp_async_wait_all();  // no copy is left in flight when the block exits

  if (n_mine == 0)
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = row + 8 * r;
    if (qrow >= p.sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* o_g = p.out + (((long long)bi * p.sq + qrow) * p.h + hi) * D;
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * jj + 2 * r;
        *reinterpret_cast<uint32_t*>(o_g + hh * 64 + 8 * jj + 2 * t4) =
            pack_bf16(o[hh][i] * inv, o[hh][i + 1] * inv);
      }
    if (t4 == 0)
      p.lse[((long long)bi * p.h + hi) * p.sq + qrow] = l[r] > 0.f ? m[r] + logf(l[r]) : kBigNeg;
  }
}

// A kv tensor (seq, head, batch with element strides) as a 4-D map of
// [64 of d × kBN keys] boxes, the outer dims in increasing stride; dim[]
// says where seq, head and batch went
cudaError_t kv_map(CUtensorMap* map, int (&dim)[3], const void* ptr, int d, int skv, int h_kv,
                   int b, long long ss, long long sh, long long sb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  long long size[3] = {skv, h_kv, b}, stride[3] = {ss, sh, sb};
  int box[3] = {kBN, 1, 1}, order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)  // sort the outer dims by stride
    for (int k = i + 1; k < 3; ++k)
      if (stride[order[k]] < stride[order[i]]) {
        const int t = order[i];
        order[i] = order[k];
        order[k] = t;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d)}, strides[3];
  cuuint32_t boxes[4] = {64}, steps[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(size[order[i]]);
    strides[i] = static_cast<cuuint64_t>(stride[order[i]]) * 2;
    boxes[i + 1] = box[order[i]];
    dim[order[i]] = i + 1;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(FwdParams& p, int b, cudaStream_t stream) {
  CUtensorMap k_map, v_map;
  cudaError_t e = kv_map(&k_map, p.k_dim, p.k, D, p.skv, p.h_kv, b, p.k_ss, p.k_sh, p.k_sb);
  if (e == cudaSuccess)
    e = kv_map(&v_map, p.v_dim, p.v, D, p.skv, p.h_kv, b, p.v_ss, p.v_sh, p.v_sb);
  if (e != cudaSuccess) return e;
  constexpr int smem = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // blockIdx.x walks (b, head), blockIdx.y the query tiles, heaviest first
  const dim3 grid(b * p.h, (p.sq + kBM - 1) / kBM);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(k_map, v_map, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lwm_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                             void* out, void* lse, int b, int sq, int skv, int h, int h_kv,
                             int d, long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                             long long v_ss, long long v_sh, long long bias_sb,
                             long long bias_sr, int causal, int q_offset, int kv_offset,
                             float scale, void* stream) {
  FwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
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
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq <= 0 || b <= 0) return cudaSuccess;
  switch (d) {
    case 64:
      return launch<64>(p, b, s);
    case 128:
      return launch<128>(p, b, s);
    default:
      return cudaErrorInvalidValue;
  }
}
