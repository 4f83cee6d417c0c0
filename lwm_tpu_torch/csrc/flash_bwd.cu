// K2 and K3: flash-attention backward for Hopper (sm_90a), bf16 in, fp32 math.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (K2, lwm_tpu/ops/pallas_flash.py:
// 288-353) and `_bwd_dkv_kernel` (K3, :356-445), both launched by
// `_flash_attention_bwd_single` (:903-1127). Same contract, the backward of
// K1 (flash_fwd.cu):
//   logits = q·kᵀ·scale + bias, masked (causal by global position: query i
//            at q_offset + i, key j at kv_offset + j; keys ≥ skv, rows ≥ sq)
//   p  = logits > MASK_GUARD ? exp(logits − lse) : 0     (lse from K1)
//   dp = g·vᵀ,  ds = p·(dp − delta)·scale                  (delta = Σ g·out)
//   K2: dq = ds·k                     (ds rounded to bf16 before the product)
//   K3: dv = pᵀ·g, dk = dsᵀ·q         (p and ds rounded to bf16 likewise)
// with fp32 accumulation, GQA (query head qh reads kv head qh / g) and
// dk/dv returned at h_kv heads, every group member summed in fp32.
//
// What bounds it on the card: at training widths (seq 4096, d 128) each
// kernel does 6·sq·skv·d flops per head (three products) on O((sq + skv)·d)
// bytes, far above the H100's ~295 flop/byte ridge, so tensor-core
// throughput bounds it. Design, as simple as K1's:
// - K2: one block of 4 warps per (b·h, 64-query tile); each warp owns 16 query
//   rows. The block walks the kv tiles up to the causal frontier itself, so
//   dq sums in registers with no cross-block reduction. q and g stay in
//   shared memory; each 64-key tile of k and v is staged there.
// - K3: one block per (b·h_kv, 64-key tile); each warp owns 16 keys and keeps
//   their dk and dv in fp32 registers. It walks every (group member, 32-query
//   tile) from the causal start, recomputing pᵀ and dsᵀ with the keys as mma
//   rows, and writes dk/dv once: no atomics, and kv is never expanded to h
//   heads (the TPU grid (b·h_kv, nk, group·nq) does the same).
// All products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate); p/ds feed
// the second products straight from the first products' accumulators, as K1
// feeds p·v. Not yet: TMA, wgmma, a fused dq/dkv pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBigNeg = -1e30f;
constexpr float kMaskGuard = -1e29f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // bf16 elements of padding per smem row
constexpr int kBM = 64;        // K2: query rows per block (16 per warp)
constexpr int kBN = 64;        // K2: keys per kv tile; K3: keys per block (16 per warp)
constexpr int kBQ = 32;        // K3: query rows per inner tile

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;
  const float* lse;    // [b, h, sq]
  const float* delta;  // [b, h, sq]
  const float* bias;   // [bb, rows, skv] or null
  __nv_bfloat16* dq;   // [b, sq, h, d]
  __nv_bfloat16* dk;   // [b, skv, h_kv, d]
  __nv_bfloat16* dv;
  int sq, skv, h, h_kv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh;
  long long bias_sb, bias_sr;
  int causal, q_offset, kv_offset;
  float scale;
};

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two floats → packed bf16x2, the lower index in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// ROWS × D tile of bf16 into smem (row stride D + kPad), 16 bytes per
// thread per step; rows at or past `rows_valid` are zero-filled so masked
// rows never carry garbage into a product (0 · NaN would poison it)
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* g,
                                          long long row_stride, int rows_valid, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(g + r * row_stride + c * 8);
    *reinterpret_cast<uint4*>(smem + r * (D + kPad) + c * 8) = val;
  }
}

// acc[16 × 8·NT] = A[row0 .. row0+16, 0..D) · B[0 .. 8·NT, 0..D)ᵀ, both
// row-major in smem (A's rows are the mma rows, B's rows its columns)
template <int D, int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], const __nv_bfloat16* a_s,
                                         int row0, const __nv_bfloat16* b_s, int gid, int t4) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D; kc += 16) {
    const __nv_bfloat16* pa = a_s + (row0 + gid) * LD + kc + 2 * t4;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(pa + 8 * LD);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(pa + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* pb = b_s + (nt * 8 + gid) * LD + kc + 2 * t4;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pb);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pb + 8);
      mma_bf16_16816(acc[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

// out[16 × D] += X[16 × 16·KK] · B[0 .. 16·KK, 0..D), X given as the fp32
// accumulators of a previous mma_rows (n-tiles 2kk, 2kk+1 are exactly the A
// fragment of k chunk kk) and rounded to bf16 here; B row-major in smem
template <int D, int KK>
__device__ __forceinline__ void mma_acc(float (&out)[D / 8][4], const float (&x)[2 * KK][4],
                                        const __nv_bfloat16* b_s, int gid, int t4) {
  constexpr int LD = D + kPad;
  const unsigned short* bits = reinterpret_cast<const unsigned short*>(b_s);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint32_t a0 = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int base = (kk * 16 + 2 * t4) * LD + dt * 8 + gid;
      const uint32_t b0 = (uint32_t)bits[base] | ((uint32_t)bits[base + LD] << 16);
      const uint32_t b1 = (uint32_t)bits[base + 8 * LD] | ((uint32_t)bits[base + 9 * LD] << 16);
      mma_bf16_16816(out[dt], a0, a1, a2, a3, b0, b1);
    }
  }
}

// the masked, scaled logit of (query qrow, key) from the raw product s
__device__ __forceinline__ float masked_logit(const BwdParams& p, const float* bias_g, float s,
                                              int qrow, int key) {
  bool valid = key < p.skv && qrow < p.sq;
  float x = s * p.scale;
  if (valid && bias_g) x += bias_g[qrow * p.bias_sr + key];
  if (p.causal && p.kv_offset + key > p.q_offset + qrow) valid = false;
  return valid ? x : kBigNeg;
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 8][4],
                                           int r, int t4) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(dst + dt * 8 + 2 * t4) =
        pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// K2: dq for one (b, h, 64-query tile)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* g_s = q_s + kBM * LD;
  __nv_bfloat16* k_s = g_s + kBM * LD;
  __nv_bfloat16* v_s = k_s + kBN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int bi = blockIdx.y / p.h, hi = blockIdx.y % p.h;
  const int kvh = hi / (p.h / p.h_kv);
  const int q0 = blockIdx.x * kBM;

  const __nv_bfloat16* k_g = p.k + bi * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v_g = p.v + bi * p.v_sb + kvh * p.v_sh;
  const float* bias_g = p.bias ? p.bias + bi * p.bias_sb : nullptr;
  const int rows_valid = min(kBM, p.sq - q0);
  load_tile<D, kBM>(q_s, p.q + bi * p.q_sb + (long long)q0 * p.q_ss + hi * p.q_sh, p.q_ss,
                    rows_valid, tid);
  load_tile<D, kBM>(g_s, p.g + bi * p.g_sb + (long long)q0 * p.g_ss + hi * p.g_sh, p.g_ss,
                    rows_valid, tid);

  // this thread's two rows (fragment rows gid and gid + 8 of its warp)
  int qrow[2];
  float lse[2], delta[2];
  const long long stat0 = ((long long)bi * p.h + hi) * p.sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + warp * 16 + gid + 8 * r;
    const bool in = qrow[r] < p.sq;
    lse[r] = in ? p.lse[stat0 + qrow[r]] : 0.f;
    delta[r] = in ? p.delta[stat0 + qrow[r]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int kv_end = p.skv;
  if (p.causal) {  // last key any row of this tile can see
    const int last_q = p.q_offset + q0 + rows_valid - 1;
    kv_end = min(kv_end, last_q - p.kv_offset + 1);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    __syncthreads();  // the previous tile's reads are done
    load_tile<D, kBN>(k_s, k_g + (long long)k0 * p.k_ss, p.k_ss, min(kBN, p.skv - k0), tid);
    load_tile<D, kBN>(v_s, v_g + (long long)k0 * p.v_ss, p.v_ss, min(kBN, p.skv - k0), tid);
    __syncthreads();

    float s[kBN / 8][4], dp[kBN / 8][4];
    mma_rows<D, kBN / 8>(s, q_s, warp * 16, k_s, gid, t4);   // q·kᵀ
    mma_rows<D, kBN / 8>(dp, g_s, warp * 16, v_s, gid, t4);  // g·vᵀ
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        const float x = masked_logit(p, bias_g, s[nt][e], qrow[r], key);
        const float pe = x > kMaskGuard ? expf(x - lse[r]) : 0.f;
        s[nt][e] = pe * (dp[nt][e] - delta[r]) * p.scale;  // ds
      }
    }
    mma_acc<D, kBN / 16>(acc, s, k_s, gid, t4);  // dq += ds·k
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= p.sq) continue;
    store_rows<D>(p.dq + (((long long)bi * p.sq + qrow[r]) * p.h + hi) * D, acc, r, t4);
  }
}

// K3: dk and dv for one (b, kv head, 64-key tile), summed over the group
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kBN * LD;
  __nv_bfloat16* q_s = v_s + kBN * LD;
  __nv_bfloat16* g_s = q_s + kBQ * LD;
  float* lse_s = reinterpret_cast<float*>(g_s + kBQ * LD);
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t4 = lane & 3;
  const int bi = blockIdx.y / p.h_kv, kvh = blockIdx.y % p.h_kv;
  const int group = p.h / p.h_kv;
  const int k0 = blockIdx.x * kBN;

  const float* bias_g = p.bias ? p.bias + bi * p.bias_sb : nullptr;
  load_tile<D, kBN>(k_s, p.k + bi * p.k_sb + (long long)k0 * p.k_ss + kvh * p.k_sh, p.k_ss,
                    min(kBN, p.skv - k0), tid);
  load_tile<D, kBN>(v_s, p.v + bi * p.v_sb + (long long)k0 * p.v_ss + kvh * p.v_sh, p.v_ss,
                    min(kBN, p.skv - k0), tid);

  int key[2];
  key[0] = k0 + warp * 16 + gid;
  key[1] = key[0] + 8;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  // first query that sees any key of this tile
  const int q_start = p.causal ? max(0, p.kv_offset + k0 - p.q_offset) : 0;
  const int n_qt = (p.sq + kBQ - 1) / kBQ;

  for (int gi = 0; gi < group; ++gi) {
    const int qh = kvh * group + gi;
    const __nv_bfloat16* q_g = p.q + bi * p.q_sb + qh * p.q_sh;
    const __nv_bfloat16* g_g = p.g + bi * p.g_sb + qh * p.g_sh;
    const long long stat0 = ((long long)bi * p.h + qh) * p.sq;
    for (int qt = q_start / kBQ; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's reads are done
      load_tile<D, kBQ>(q_s, q_g + (long long)q0 * p.q_ss, p.q_ss, min(kBQ, p.sq - q0), tid);
      load_tile<D, kBQ>(g_s, g_g + (long long)q0 * p.g_ss, p.g_ss, min(kBQ, p.sq - q0), tid);
      if (tid < kBQ) {
        const bool in = q0 + tid < p.sq;
        lse_s[tid] = in ? p.lse[stat0 + q0 + tid] : 0.f;
        delta_s[tid] = in ? p.delta[stat0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      // transposed products: rows are this warp's 16 keys, columns queries
      float s[kBQ / 8][4], dp[kBQ / 8][4];
      mma_rows<D, kBQ / 8>(s, k_s, warp * 16, q_s, gid, t4);   // k·qᵀ
      mma_rows<D, kBQ / 8>(dp, v_s, warp * 16, g_s, gid, t4);  // v·gᵀ
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + 2 * t4 + (e & 1);
          const float x = masked_logit(p, bias_g, s[nt][e], q0 + qi, key[e >> 1]);
          const float pe = x > kMaskGuard ? expf(x - lse_s[qi]) : 0.f;
          s[nt][e] = pe;
          dp[nt][e] = pe * (dp[nt][e] - delta_s[qi]) * p.scale;  // dsᵀ
        }
      }
      mma_acc<D, kBQ / 16>(dv, s, g_s, gid, t4);   // dv += pᵀ·g
      mma_acc<D, kBQ / 16>(dk, dp, q_s, gid, t4);  // dk += dsᵀ·q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.skv) continue;
    const long long off = (((long long)bi * p.skv + key[r]) * p.h_kv + kvh) * D;
    store_rows<D>(p.dk + off, dk, r, t4);
    store_rows<D>(p.dv + off, dv, r, t4);
  }
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int b, cudaStream_t stream) {
  const int smem = (2 * kBM + 2 * kBN) * (D + kPad) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBM - 1) / kBM, b * p.h);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int b, cudaStream_t stream) {
  const int smem = (2 * kBN + 2 * kBQ) * (D + kPad) * (int)sizeof(__nv_bfloat16) +
                   2 * kBQ * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.skv + kBN - 1) / kBN, b * p.h_kv);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* g,
                      const void* lse, const void* delta, const void* bias, int sq, int skv,
                      int h, int h_kv, long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                      long long v_ss, long long v_sh, long long g_sb, long long g_ss,
                      long long g_sh, long long bias_sb, long long bias_sr, int causal,
                      int q_offset, int kv_offset, float scale) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.bias = static_cast<const float*>(bias);
  p.dq = p.dk = p.dv = nullptr;
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
  return p;
}

}  // namespace

#define LWM_BWD_ARGS                                                                          \
  const void *q, const void *k, const void *v, const void *g, const void *lse,               \
      const void *delta, const void *bias
#define LWM_BWD_DIMS                                                                          \
  int b, int sq, int skv, int h, int h_kv, int d, long long q_sb, long long q_ss,            \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,        \
      long long v_ss, long long v_sh, long long g_sb, long long g_ss, long long g_sh,        \
      long long bias_sb, long long bias_sr, int causal, int q_offset, int kv_offset,         \
      float scale, void *stream
#define LWM_BWD_PARAMS                                                                        \
  make_params(q, k, v, g, lse, delta, bias, sq, skv, h, h_kv, q_sb, q_ss, q_sh, k_sb, k_ss,  \
              k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh, bias_sb, bias_sr, causal, q_offset,  \
              kv_offset, scale)

extern "C" int lwm_flash_bwd_dq(LWM_BWD_ARGS, void* dq, LWM_BWD_DIMS) {
  BwdParams p = LWM_BWD_PARAMS;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq <= 0 || b <= 0) return cudaSuccess;
  switch (d) {
    case 64:
      return launch_dq<64>(p, b, s);
    case 128:
      return launch_dq<128>(p, b, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int lwm_flash_bwd_dkv(LWM_BWD_ARGS, void* dk, void* dv, LWM_BWD_DIMS) {
  BwdParams p = LWM_BWD_PARAMS;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (skv <= 0 || b <= 0) return cudaSuccess;
  switch (d) {
    case 64:
      return launch_dkv<64>(p, b, s);
    case 128:
      return launch_dkv<128>(p, b, s);
    default:
      return cudaErrorInvalidValue;
  }
}
