// Prototypes of the product loops of the fp32 routes, for choosing their
// MMAs (scripts/time_tf32_products.py builds and times them). Each runs its
// products as three TF32 products, lo·hi + hi·lo + hi·hi, from operands
// resident in shared memory or registers, `iters` times over, so that the
// time is the products' alone (no copy from device memory, no softmax).
// K1's forward, s = q·kᵀ of 64-key tiles at d 128:
// - mma_sync_loop: four warps, 16 query rows each, `mma.sync` m16n8k8 TF32;
//   q and k are raw fp32 tiles (64 KB), read by `ldmatrix` and split into hi
//   and lo in registers at every fragment.
// - wgmma_loop: two warpgroups, 64 query rows each, `wgmma` m64n64k8 TF32
//   with both operands K-major from shared memory, so hi and lo are split
//   once into tiles of their own (q 128 rows, k 64 keys: 192 KB).
// The backward's dv += pᵀ·g over a 32-query stage (p 128 keys × 32 queries,
// g 32 × 128), the contraction over queries, whose B operand `wgmma` wants
// transposed (queries contiguous):
// - mma_tiles_loop: eight warps, 16 keys each, `mma.sync` m16n8k8 with p's
//   hi/lo fragments in registers and g's gathered by 32-bit shared loads
//   from hi/lo tiles split once as they lie (32 KB); each pass's sum starts
//   from zero and is added to the accumulator.
// - wgmma_rs_loop: two warpgroups, 64 keys each, `wgmma` m64n128k8 with p
//   from registers and B = gᵀ's hi/lo tiles, written transposed by the
//   split (each group of 8 queries in the order that makes p's accumulator
//   layout the A fragment), the same sums.
// The backward's sᵀ = k·qᵀ at a 32-query stage (k 64 × 128, q 32 × 128):
// - wgmma_n32_loop: two warpgroups, each `wgmma` m64n32k8 with both
//   operands K-major from hi/lo tiles (96 KB), hi·hi summed apart.
// All 128-byte swizzled (32 floats a row, chunk c of row r at c ^ (r % 8)).

#include "tf32.cuh"

namespace {

using namespace lwm;

constexpr int D = 128, kBK = 64;

// d[16 × 8] += A (16 × 8) · B (8 × 8), TF32, by one warp (`mma.sync`). With
// (g8, t4) = (lane / 4, lane % 4): a0..a3 are A's (g8, t4), (g8 + 8, t4),
// (g8, t4 + 4), (g8 + 8, t4 + 4); b0, b1 are B's (k t4, n g8) and (k t4 + 4,
// n g8); d0..d3 are (g8, 2t4), (g8, 2t4 + 1), (g8 + 8, 2t4), (g8 + 8, 2t4 + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d[64 × 64] (+)= A (64 × 8) · B (8 × 64), TF32, both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " LWM_REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : LWM_ACC32
      : "l"(da), "l"(db));
}

__device__ __forceinline__ uint8_t* aligned_smem() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  return smem_raw + (((raw + 1023) & ~1023u) - raw);
}

__global__ void __launch_bounds__(128) mma_sync_loop(const float* q, const float* k, float* s,
                                                     int iters) {
  constexpr int kBQ = 64;
  uint8_t* smem = aligned_smem();
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + kBQ * D * 4);
  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    qs[swz32<kBQ>(i / D, i % D) >> 2] = q[i];
    ks[swz32<kBK>(i / D, i % D) >> 2] = k[i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const uint32_t q_s = smem_addr(qs), k_s = smem_addr(ks);
  const int lq_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1), lq_col = 4 * (lane >> 4);
  const int lk_row = (lane & 7) + 8 * (lane >> 4), lk_col = 4 * ((lane >> 3) & 1);
  float sa[kBK / 8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t qa[4], qh[4], ql[4];
      ldsm_x4(qa, q_s + swz32<kBQ>(lq_row, 8 * kk + lq_col));
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(qa[e]), qh[e], ql[e]);
#pragma unroll
      for (int n = 0; n < kBK / 8; n += 2) {
        uint32_t kb[4], kh[4], kl[4];
        ldsm_x4(kb, k_s + swz32<kBK>(8 * n + lk_row, 8 * kk + lk_col));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(kb[e]), kh[e], kl[e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_tf32(sa[n + h], ql, kh[2 * h], kh[2 * h + 1]);
          mma_tf32(sa[n + h], qh, kl[2 * h], kl[2 * h + 1]);
          mma_tf32(sa[n + h], qh, kh[2 * h], kh[2 * h + 1]);
        }
      }
    }
  }
  if (blockIdx.x == 0)
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[(16 * warp + g8 + 8 * (e >> 1)) * kBK + 8 * n + 2 * t4 + (e & 1)] = sa[n][e];
}

__global__ void __launch_bounds__(256) wgmma_loop(const float* q, const float* k, float* s,
                                                  int iters) {
  constexpr int kBQ = 128;
  uint8_t* smem = aligned_smem();
  float* q_hi = reinterpret_cast<float*>(smem);
  float* q_lo = q_hi + kBQ * D;
  float* k_hi = q_lo + kBQ * D;
  float* k_lo = k_hi + kBK * D;
  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    uint32_t hi, lo;
    split_tf32(q[i], hi, lo);
    q_hi[swz32<kBQ>(i / D, i % D) >> 2] = __uint_as_float(hi);
    q_lo[swz32<kBQ>(i / D, i % D) >> 2] = __uint_as_float(lo);
    if (i < kBK * D) {
      split_tf32(k[i], hi, lo);
      k_hi[swz32<kBK>(i / D, i % D) >> 2] = __uint_as_float(hi);
      k_lo[swz32<kBK>(i / D, i % D) >> 2] = __uint_as_float(lo);
    }
  }
  fence_async_smem();
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float d[32] = {};
  fence_acc(d);
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int qo = (kk >> 2) * kBQ * 128 + wg * 64 * 128 + (kk & 3) * 32;
      const int ko = (kk >> 2) * kBK * 128 + (kk & 3) * 32;
      wgmma_tf32(d, smem_desc(smem_addr(q_lo) + qo), smem_desc(smem_addr(k_hi) + ko));
      wgmma_tf32(d, smem_desc(smem_addr(q_hi) + qo), smem_desc(smem_addr(k_lo) + ko));
      wgmma_tf32(d, smem_desc(smem_addr(q_hi) + qo), smem_desc(smem_addr(k_hi) + ko));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
  }
  if (blockIdx.x == 0) {
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[(64 * wg + 16 * warp + g8 + 8 * ((i >> 1) & 1)) * kBK + 8 * (i >> 2) + 2 * t4 + (i & 1)] =
          d[i];
  }
}

// the backward's dv over one stage: 128 keys, kK queries, kN columns
constexpr int kK = 32, kN = 128;

// p's A fragments of this warp's 16 rows (row0 = its first), split into
// hi/lo: query chunk j's k index t4 is query 8j + 2t4, t4 + 4 is 8j + 2t4 + 1
__device__ __forceinline__ void p_fragments(const float* p, int row0, uint32_t (&fh)[kK / 8][4],
                                            uint32_t (&fl)[kK / 8][4]) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kK / 8; ++j) {
    const int r0 = (row0 + g8) * kK, r1 = r0 + 8 * kK, c = 8 * j + 2 * t4;
    const float x[4] = {p[r0 + c], p[r1 + c], p[r0 + c + 1], p[r1 + c + 1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[e], fh[j][e], fl[j][e]);
  }
}

__global__ void __launch_bounds__(256) mma_tiles_loop(const float* p, const float* g, float* out,
                                                      int iters) {
  uint8_t* smem = aligned_smem();
  uint8_t* g_hi = smem;
  uint8_t* g_lo = smem + kK * kN * 4;
  for (int i = threadIdx.x; i < kK * kN; i += blockDim.x) {
    uint32_t hi, lo;
    split_tf32(g[i], hi, lo);
    const int off = swz32<kK>(i / kN, i % kN);
    *reinterpret_cast<uint32_t*>(g_hi + off) = hi;
    *reinterpret_cast<uint32_t*>(g_lo + off) = lo;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  uint32_t fh[kK / 8][4], fl[kK / 8][4];
  p_fragments(p, 16 * warp, fh, fl);
  float acc[kN / 8][4] = {};
  for (int it = 0; it < iters; ++it) {
    asm volatile("" ::: "memory");  // the B loads stay in the loop
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      uint32_t bh[kK / 8][2];
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kK / 8; ++j) {
        const int o0 = swz32<kK>(8 * j + 2 * t4, 8 * n + g8);
        const int o1 = swz32<kK>(8 * j + 2 * t4 + 1, 8 * n + g8);
        bh[j][0] = *reinterpret_cast<const uint32_t*>(g_hi + o0);
        bh[j][1] = *reinterpret_cast<const uint32_t*>(g_hi + o1);
        mma_tf32(t, fl[j], bh[j][0], bh[j][1]);
        mma_tf32(t, fh[j], *reinterpret_cast<const uint32_t*>(g_lo + o0),
                 *reinterpret_cast<const uint32_t*>(g_lo + o1));
      }
#pragma unroll
      for (int j = 0; j < kK / 8; ++j) mma_tf32(t, fh[j], bh[j][0], bh[j][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
    }
  }
  if (blockIdx.x == 0)
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(16 * warp + g8 + 8 * (e >> 1)) * kN + 8 * n + 2 * t4 + (e & 1)] = acc[n][e];
}

__global__ void __launch_bounds__(256) wgmma_rs_loop(const float* p, const float* g, float* out,
                                                     int iters) {
  uint8_t* smem = aligned_smem();
  float* gt_hi = reinterpret_cast<float*>(smem);  // gᵀ: kN rows of kK queries
  float* gt_lo = gt_hi + kN * kK;
  for (int i = threadIdx.x; i < kK * kN; i += blockDim.x) {
    const int q = i / kN, c = i % kN;
    const int pos = (q & 24) | ((q & 1) << 2) | ((q >> 1) & 3);
    uint32_t hi, lo;
    split_tf32(g[i], hi, lo);
    gt_hi[swz32<kN>(c, pos) >> 2] = __uint_as_float(hi);
    gt_lo[swz32<kN>(c, pos) >> 2] = __uint_as_float(lo);
  }
  fence_async_smem();
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  uint32_t fh[kK / 8][4], fl[kK / 8][4];
  p_fragments(p, 64 * wg + 16 * warp, fh, fl);
  const uint32_t vh = smem_addr(gt_hi), vl = smem_addr(gt_lo);
  float acc[64] = {};
  for (int it = 0; it < iters; ++it) {
    float t[64];
    fence_acc(t);
    fence_frag(fh);
    fence_frag(fl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kK / 8; ++j) {
      wgmma_tf32_rs(t, fl[j], smem_desc(vh + j * 32), j > 0);
      wgmma_tf32_rs(t, fh[j], smem_desc(vl + j * 32), 1);
    }
#pragma unroll
    for (int j = 0; j < kK / 8; ++j) wgmma_tf32_rs(t, fh[j], smem_desc(vh + j * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(t);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += t[i];
  }
  if (blockIdx.x == 0) {
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 64; ++i)
      out[(64 * wg + 16 * warp + g8 + 8 * ((i >> 1) & 1)) * kN + 8 * (i >> 2) + 2 * t4 + (i & 1)] =
          acc[i];
  }
}

__global__ void __launch_bounds__(256) wgmma_n32_loop(const float* k, const float* q, float* s,
                                                      int iters) {
  constexpr int kQ = 32;
  uint8_t* smem = aligned_smem();
  float* k_hi = reinterpret_cast<float*>(smem);
  float* k_lo = k_hi + kBK * D;
  float* q_hi = k_lo + kBK * D;
  float* q_lo = q_hi + kQ * D;
  for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
    uint32_t hi, lo;
    split_tf32(k[i], hi, lo);
    k_hi[swz32<kBK>(i / D, i % D) >> 2] = __uint_as_float(hi);
    k_lo[swz32<kBK>(i / D, i % D) >> 2] = __uint_as_float(lo);
    if (i < kQ * D) {
      split_tf32(q[i], hi, lo);
      q_hi[swz32<kQ>(i / D, i % D) >> 2] = __uint_as_float(hi);
      q_lo[swz32<kQ>(i / D, i % D) >> 2] = __uint_as_float(lo);
    }
  }
  fence_async_smem();
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float acc[16] = {};
  for (int it = 0; it < iters; ++it) {
    float xm[16], xc[16];
    fence_acc(xm);
    fence_acc(xc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t ko = (kk >> 2) * kBK * 128 + (kk & 3) * 32;
      const uint32_t qo = (kk >> 2) * kQ * 128 + (kk & 3) * 32;
      const uint64_t kh = smem_desc(smem_addr(k_hi) + ko), qh = smem_desc(smem_addr(q_hi) + qo);
      wgmma_tf32_n32(xc, smem_desc(smem_addr(k_lo) + ko), qh, kk > 0);
      wgmma_tf32_n32(xc, kh, smem_desc(smem_addr(q_lo) + qo), 1);
      wgmma_tf32_n32(xm, kh, qh, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(xm);
    fence_acc(xc);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += xm[i] + xc[i];
  }
  if (blockIdx.x == 0 && wg == 0) {
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      s[(16 * warp + g8 + 8 * ((i >> 1) & 1)) * kQ + 8 * (i >> 2) + 2 * t4 + (i & 1)] = acc[i];
  }
}

}  // namespace

// which 0: mma_sync_loop (a = q [64, 128], b = k [64, 128], out = a·bᵀ),
// 1: wgmma_loop (q [128, 128]), 2: mma_tiles_loop and 3: wgmma_rs_loop (a
// = p [128, 32], b = g [32, 128], out = a·b), 4: wgmma_n32_loop (a = k
// [64, 128], b = q [32, 128], out = a·bᵀ), all fp32. Every block computes
// the same tile and block 0 writes it; blocks 0: as many as fit on the card
// at once (*blocks_out says how many ran). Returns the CUDA error.
extern "C" int tf32_products(int which, const void* a, const void* b, void* out, int iters,
                             int blocks, int* blocks_out, void* stream) {
  if (which < 0 || which > 4) return cudaErrorInvalidValue;
  const int threads = which == 0 ? 128 : 256;
  const int bytes[5] = {(64 + kBK) * D * 4, 2 * (128 + kBK) * D * 4, 2 * kK * kN * 4,
                        2 * kK * kN * 4, 2 * (kBK + 32) * D * 4};
  const int smem = bytes[which] + 1024;
  const void* fns[5] = {reinterpret_cast<const void*>(mma_sync_loop),
                        reinterpret_cast<const void*>(wgmma_loop),
                        reinterpret_cast<const void*>(mma_tiles_loop),
                        reinterpret_cast<const void*>(wgmma_rs_loop),
                        reinterpret_cast<const void*>(wgmma_n32_loop)};
  const void* fn = fns[which];
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (blocks <= 0) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (e != cudaSuccess) return e;
    blocks = per_sm * sm_count();
  }
  *blocks_out = blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  switch (which) {
    case 0:
      mma_sync_loop<<<blocks, threads, smem, st>>>(af, bf, of, iters);
      break;
    case 1:
      wgmma_loop<<<blocks, threads, smem, st>>>(af, bf, of, iters);
      break;
    case 2:
      mma_tiles_loop<<<blocks, threads, smem, st>>>(af, bf, of, iters);
      break;
    case 3:
      wgmma_rs_loop<<<blocks, threads, smem, st>>>(af, bf, of, iters);
      break;
    default:
      wgmma_n32_loop<<<blocks, threads, smem, st>>>(af, bf, of, iters);
  }
  return cudaGetLastError();
}
