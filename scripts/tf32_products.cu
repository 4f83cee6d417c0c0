// Two prototypes of the product loop of K1's fp32 route, for choosing its
// MMA (scripts/time_tf32_products.py builds and times them). Each computes
// s = q·kᵀ of 64-key tiles at d 128 as three TF32 products, lo·hi + hi·lo +
// hi·hi, from tiles resident in shared memory, `iters` times over, so that
// the time is the products' alone (no copy from device memory, no softmax):
// - mma_sync_loop: the route's loop (csrc/flash_fwd_f32.cu). Four warps, 16
//   query rows each, `mma.sync` m16n8k8 TF32; q and k are raw fp32 tiles
//   (64 KB), read by `ldmatrix` and split into hi and lo in registers.
// - wgmma_loop: two warpgroups, 64 query rows each, `wgmma` m64n64k8 TF32
//   with both operands K-major from shared memory, so hi and lo are split
//   once into tiles of their own (q 128 rows, k 64 keys: 192 KB). A route
//   on it would also need v transposed into hi/lo tiles and p through
//   shared memory, which this loop leaves out.
// Both 128-byte swizzled (32 floats a row, chunk c of row r at c ^ (r % 8)).

#include "hopper.cuh"

namespace {

using namespace lwm;

constexpr int D = 128, kBK = 64;

template <int R>
__device__ __forceinline__ int swz32(int r, int c) {
  return (c >> 5) * R * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + (c & 3) * 4;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

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

}  // namespace

// which 0: mma_sync_loop, 1: wgmma_loop. q [rows, 128] (64 rows for 0, 128
// for 1), k [64, 128] fp32; block 0 writes its s [rows, 64]. Every block
// computes the same tile; blocks 0: as many as fit on the card at once.
// Returns the CUDA error; *rows_out and *blocks_out say what ran.
extern "C" int tf32_products(int which, const void* q, const void* k, void* s, int iters,
                             int blocks, int* rows_out, int* blocks_out, void* stream) {
  const int rows = which == 0 ? 64 : 128, threads = which == 0 ? 128 : 256;
  const int smem = (which == 0 ? (rows + kBK) * D * 4 : 2 * (rows + kBK) * D * 4) + 1024;
  const void* fn = which == 0 ? reinterpret_cast<const void*>(mma_sync_loop)
                              : reinterpret_cast<const void*>(wgmma_loop);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (blocks <= 0) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (e != cudaSuccess) return e;
    blocks = per_sm * sm_count();
  }
  *rows_out = rows;
  *blocks_out = blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  float* sf = static_cast<float*>(s);
  if (which == 0)
    mma_sync_loop<<<blocks, threads, smem, st>>>(qf, kf, sf, iters);
  else
    wgmma_loop<<<blocks, threads, smem, st>>>(qf, kf, sf, iters);
  return cudaGetLastError();
}
