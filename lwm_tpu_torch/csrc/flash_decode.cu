// K4: one-token flash decoding over a head-major KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` (lwm_tpu/ops/pallas_decode.py:66-140,
// reached through flash_decode_pallas :143-247). Same contract: q [b, 1, h, d]
// bf16; k, v [b, h_kv, T, d] bf16, or int8 with fp32 per-(token, head) scales
// [b, h_kv, T] (k scales multiply the logits, v scales multiply p before p
// is rounded to bf16 for p·v, the TPU kernel's order); a per-key bool mask
// [b, T] (left-pad holes and per-row frontiers); keys at or past kv_len are
// never read (kv_len is an upper bound; the mask does the exact part). The g
// query heads of a kv head share one read of its cache. A row with no valid
// key gives 0.
//
// What bounds it on the card: one decode step reads every valid cache byte
// once and does ~4 flops per element read, so HBM bandwidth bounds it. Design:
// one block of 8 warps per (batch row, kv head); each key is read by a group
// of d/8 lanes, 8 elements (16 bytes bf16, 8 bytes int8) per lane, so a
// warp's load covers 2 (d=128) or 4 (d=64) neighbouring keys contiguously;
// masked keys are skipped before their k/v bytes are read; each lane group
// keeps its own online softmax (m, l, acc) for all g heads in registers, and
// the groups merge once at the end (shuffles within a warp, shared memory
// across warps). int8 keys and values are read at their stored width. Not
// yet: splitting T across blocks (b·h_kv is below the SM count at small
// batch), deeper load pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBigNeg = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct DecParams {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const uint8_t* mask;
  __nv_bfloat16* out;
  int h, h_kv, T, kv_len;
  long long q_sb, q_sh, kv_sb, kv_sh, kv_ss;
  float scale;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 8 consecutive cache elements → float
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
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = (float)b[i];
}

template <int D, int G, typename KV>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const DecParams p) {
  constexpr int kLanesPerKey = D / 8;
  constexpr int kKeysPerWarp = 32 / kLanesPerKey;
  constexpr int kGroups = kWarps * kKeysPerWarp;
  constexpr bool kQuant = sizeof(KV) == 1;

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane / kLanesPerKey, li = lane % kLanesPerKey;
  const int grp = warp * kKeysPerWarp + sub;
  static_assert(kLanesPerKey < 32, "d = 64 or 128");
  const unsigned gmask = ((1u << kLanesPerKey) - 1u) << (sub * kLanesPerKey);
  const int bi = blockIdx.x / p.h_kv, kvh = blockIdx.x % p.h_kv;

  float qr[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) load8(p.q + bi * p.q_sb + (kvh * G + j) * p.q_sh + li * 8, qr[j]);

  const KV* k_g = static_cast<const KV*>(p.k) + bi * p.kv_sb + kvh * p.kv_sh + li * 8;
  const KV* v_g = static_cast<const KV*>(p.v) + bi * p.kv_sb + kvh * p.kv_sh + li * 8;
  const long long sc_row = ((long long)bi * p.h_kv + kvh) * p.T;
  const uint8_t* mask = p.mask + (long long)bi * p.T;

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = kBigNeg;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }

  const int n = min(p.kv_len, p.T);
  for (int key = grp; key < n; key += kGroups) {
    if (!mask[key]) continue;  // uniform across the key's lane group
    float kf[8], vf[8];
    load8(k_g + key * p.kv_ss, kf);
    load8(v_g + key * p.kv_ss, vf);
    const float ksc = kQuant ? p.k_scale[sc_row + key] : 1.f;
    const float vsc = kQuant ? p.v_scale[sc_row + key] : 1.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s += qr[j][e] * kf[e];
#pragma unroll
      for (int off = kLanesPerKey / 2; off > 0; off >>= 1) s += __shfl_xor_sync(gmask, s, off);
      s *= p.scale;
      if (kQuant) s *= ksc;
      const float m_new = fmaxf(m[j], s);
      const float alpha = expf(m[j] - m_new);
      const float pe = expf(s - m_new);
      l[j] = l[j] * alpha + pe;
      const float pv = bf16_round(kQuant ? pe * vsc : pe);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] = acc[j][e] * alpha + pv * vf[e];
      m[j] = m_new;
    }
  }

  // merge the lane groups of this warp (lanes li, li + kLanesPerKey, ...)
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int off = kLanesPerKey; off < 32; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[j], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[j], off);
      const float mn = fmaxf(m[j], m2);
      const float a1 = expf(m[j] - mn), a2 = expf(m2 - mn);
      l[j] = l[j] * a1 + l2 * a2;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc2 = __shfl_xor_sync(0xffffffffu, acc[j][e], off);
        acc[j][e] = acc[j][e] * a1 + acc2 * a2;
      }
      m[j] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (li == 0) {
        sm_m[warp][j] = m[j];
        sm_l[warp][j] = l[j];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sm_acc[warp][j][li * 8 + e] = acc[j][e];
    }
  }
  __syncthreads();

  // merge across warps: one output element (head j, dim c) per thread step
  for (int i = tid; i < G * D; i += kThreads) {
    const int j = i / D, c = i % D;
    float mx = kBigNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][j]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(sm_m[w][j] - mx);
      lsum += sm_l[w][j] * a;
      o += sm_acc[w][j][c] * a;
    }
    p.out[((long long)bi * p.h + kvh * G + j) * D + c] =
        __float2bfloat16_rn(lsum > 0.f ? o / lsum : 0.f);
  }
}

template <int D, int G>
cudaError_t launch_g(const DecParams& p, int b, int quant, cudaStream_t stream) {
  const dim3 grid(b * p.h_kv);
  if (quant)
    flash_decode_kernel<D, G, int8_t><<<grid, kThreads, 0, stream>>>(p);
  else
    flash_decode_kernel<D, G, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
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
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int lwm_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale, const void* mask,
                                void* out, int b, int h, int h_kv, int T, int d, int kv_len,
                                int quant, long long q_sb, long long q_sh, long long kv_sb,
                                long long kv_sh, long long kv_ss, float scale, void* stream) {
  DecParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.h = h;
  p.h_kv = h_kv;
  p.T = T;
  p.kv_len = kv_len;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.kv_sb = kv_sb;
  p.kv_sh = kv_sh;
  p.kv_ss = kv_ss;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0) return cudaSuccess;
  const int g = h / h_kv;
  switch (d) {
    case 64:
      return launch_d<64>(p, b, g, quant, s);
    case 128:
      return launch_d<128>(p, b, g, quant, s);
    default:
      return cudaErrorInvalidValue;
  }
}
