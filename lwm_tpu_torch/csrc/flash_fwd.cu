// K1: flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the TPU kernel `_fwd_kernel` (lwm_tpu/ops/pallas_flash.py:199-285,
// reached through flash_attention_fwd_pallas :624-795). Same contract:
//   out = softmax(q·kᵀ·scale + bias, masked) · v, lse = m + log(l)
// with an additive fp32 bias per key [bb, 1, skv] or per (row, key)
// [bb, sq, skv], global-position causal masking (query i at q_offset + i,
// key j at kv_offset + j), GQA (query head qh reads kv head qh / g), and any
// kv layout whose head dim is contiguous (seq-major or the cache's
// head-major [b, h_kv, T, d]: the strides say which). Rows with no valid key
// give out 0 and lse BIG_NEG (the TPU kernel leaves a mean of v there; the
// module contract says 0).
//
// What bounds it on the card: at admission widths (q ≥ 256 over a 4096
// cache) it does 4·sq·skv·d flops per head on 2·skv·d bytes of kv, far
// above the H100's ~295 flop/byte ridge, so tensor-core throughput bounds
// it. Design: one block of 4 warps per (b·h, 64-query tile); each warp owns
// 16 query rows and runs q·kᵀ and p·v on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); 64-key tiles of k and v
// are staged in shared memory (rows padded by 16 bytes so the fragment
// loads hit distinct banks); the online softmax keeps m and l in registers
// and rounds p to bf16 before p·v, as the TPU kernel does. Causally dead kv
// tiles are never loaded. Not yet: TMA, wgmma and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBigNeg = -1e30f;
constexpr float kMaskGuard = -1e29f;
constexpr int kBM = 64;       // query rows per block: 16 per warp
constexpr int kBN = 64;       // keys per kv tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 elements of padding per smem row

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

// rows × D tile of bf16 into smem (row stride D + kPad), 16 bytes per
// thread per step; rows at or past `rows_valid` are zero-filled so masked
// keys never carry garbage (0 · NaN would poison p·v)
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* g,
                                          long long row_stride, int rows_valid, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(g + r * row_stride + c * 8);
    *reinterpret_cast<uint4*>(smem + r * (D + kPad) + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FwdParams p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBM * LD;
  __nv_bfloat16* v_s = k_s + kBN * LD;
  const unsigned short* v_bits = reinterpret_cast<const unsigned short*>(v_s);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int bi = blockIdx.y / p.h, hi = blockIdx.y % p.h;
  const int kvh = hi / (p.h / p.h_kv);
  const int q0 = blockIdx.x * kBM;

  const __nv_bfloat16* q_g = p.q + bi * p.q_sb + (long long)q0 * p.q_ss + hi * p.q_sh;
  const __nv_bfloat16* k_g = p.k + bi * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v_g = p.v + bi * p.v_sb + kvh * p.v_sh;
  const float* bias_g = p.bias ? p.bias + bi * p.bias_sb : nullptr;

  load_tile<D>(q_s, q_g, p.q_ss, min(kBM, p.sq - q0), tid);

  // this thread's two rows (fragment rows gid and gid + 8 of its warp)
  int row[2];
  row[0] = warp * 16 + gid;
  row[1] = row[0] + 8;
  float m[2] = {kBigNeg, kBigNeg};
  float l[2] = {0.f, 0.f};  // thread-partial row sums (quad-reduced at the end)
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  int kv_end = p.skv;
  if (p.causal) {  // last key any row of this tile can see
    const int last_q = p.q_offset + min(q0 + kBM, p.sq) - 1;
    kv_end = min(kv_end, last_q - p.kv_offset + 1);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    __syncthreads();  // the previous tile's reads are done
    load_tile<D>(k_s, k_g + (long long)k0 * p.k_ss, p.k_ss, min(kBN, p.skv - k0), tid);
    load_tile<D>(v_s, v_g + (long long)k0 * p.v_ss, p.v_ss, min(kBN, p.skv - k0), tid);
    __syncthreads();

    // s = q · kᵀ for this warp's 16 rows × 64 keys (8 n-tiles of 8 keys)
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D; kc += 16) {
      const __nv_bfloat16* qa = q_s + row[0] * LD + kc + 2 * t4;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const __nv_bfloat16* kb = k_s + (nt * 8 + gid) * LD + kc + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + 8);
        mma_bf16_16816(s[nt], a0, a1, a2, a3, b0, b1);
      }
    }

    // scale, bias, masks; tile row max
    float mt[2] = {kBigNeg, kBigNeg};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int qrow = min(q0 + row[r], p.sq - 1);  // tail rows are never stored
        float x = s[nt][e] * p.scale;
        bool valid = key < p.skv;
        if (valid && bias_g) x += bias_g[qrow * p.bias_sr + key];
        if (p.causal && p.kv_offset + key > p.q_offset + q0 + row[r]) valid = false;
        x = valid ? x : kBigNeg;
        s[nt][e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = s[nt][e];
        const float pe = x > kMaskGuard ? expf(x - m[r]) : 0.f;
        s[nt][e] = pe;
        rs[r] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // o += p · v: the s accumulators of n-tiles (2kk, 2kk+1) are exactly
    // the A fragment of key chunk kk; p is rounded to bf16 here
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int base = (kk * 16 + 2 * t4) * LD + dt * 8 + gid;
        const uint32_t b0 = (uint32_t)v_bits[base] | ((uint32_t)v_bits[base + LD] << 16);
        const uint32_t b1 =
            (uint32_t)v_bits[base + 8 * LD] | ((uint32_t)v_bits[base + 9 * LD] << 16);
        mma_bf16_16816(o[dt], a0, a1, a2, a3, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = q0 + row[r];
    if (qrow >= p.sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* o_g = p.out + (((long long)bi * p.sq + qrow) * p.h + hi) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(o_g + dt * 8 + 2 * t4) =
          pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    }
    if (t4 == 0) {
      p.lse[((long long)bi * p.h + hi) * p.sq + qrow] =
          l[r] > 0.f ? m[r] + logf(l[r]) : kBigNeg;
    }
  }
}

template <int D>
cudaError_t launch(const FwdParams& p, int b, cudaStream_t stream) {
  const int smem = (kBM + 2 * kBN) * (D + kPad) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBM - 1) / kBM, b * p.h);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
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
