// K1's fp32 route: flash-attention forward for fp32 q, k and v (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (lwm_tpu/ops/pallas_flash.py:199-285,
// reached through flash_attention_fwd_pallas :624-795) for fp32 operands, as
// the needle evals run it (scripts/run_eval_needle.sh: --dtype=fp32). Same
// contract as csrc/flash_fwd.cu:
//   out = softmax(q·kᵀ·scale + bias, masked) · v, lse = m + log(l)
// with an additive fp32 bias per key [bb, 1, skv] or per (row, key)
// [bb, sq, skv], global-position causal masking (query i at q_offset + i,
// key j at kv_offset + j), GQA (query head qh reads kv head qh / g), any kv
// layout whose head dim is contiguous (seq-major, or the cache's head-major
// [b, h_kv, T, d]: the strides say which). Logits at or below MASK_GUARD
// count as masked; rows with no valid key give out 0 and lse BIG_NEG. p
// stays fp32 (the twin rounds p to v.dtype, here fp32: no rounding).
//
// What bounds it on the card: 4·d flops per (query, key) pair and head on
// O((sq + skv)·d) bytes. The fp32 suite holds this route at 1e-5, and TF32
// (`wgmma`'s only fp32 input) keeps ~3 digits, so the products run as fp32
// FMAs on the CUDA cores: 67 TFLOP/s on an H100 SXM, the bound here. The
// design is the simple tiled one:
// - One block of 256 threads per (b·h, 64-query tile), the heaviest (causally
//   last) tiles launched first; 64-key tiles up to the block's causal
//   frontier. q, k and v tiles are copied row by row into shared memory by
//   16-byte cp.async (keys or rows past the end zero-filled), rows padded by
//   4 floats so that the 16-byte reads below meet distinct banks.
// - Thread (ty, tx) of a 16 × 16 grid owns query rows ty + 16i and keys
//   tx + 16j (i, j < 4): s = q·kᵀ in registers from 16-byte reads along d.
// - Online softmax per row in fp32 (`expf`, not the SFU's ex2.approx), the
//   row's 16 threads reduced by shuffles; p goes to shared memory (over the
//   k tile, which s no longer needs), and the same thread adds p·v for its
//   rows and columns (tx + 16c)·4 .. + 3.
// - Two blocks an SM (~101 KB of shared memory each at d 128), so one
//   block's copies overlap the other's arithmetic.

#include "hopper.cuh"

namespace {

using lwm::cp_async16;
using lwm::cp_async_commit;
using lwm::cp_async_wait_all;
using lwm::kBigNeg;
using lwm::kMaskGuard;
using lwm::smem_addr;

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // queries a block
constexpr int kBK = 64;  // keys a tile

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
  int causal, q_offset, kv_offset;
  float scale;
};

template <int D>
struct F32Smem {
  static constexpr int kRow = D + 4;  // floats a padded row
  static constexpr int kTile = kBK * kRow;
  static constexpr int kBytes = 3 * kTile * 4;  // q, k (then p), v
};

// ROWS rows of D floats, row r at src + r * stride, into a padded tile;
// rows at or past `valid` are zero-filled (no bytes read)
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, long long stride,
                                          int valid, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool in = r < valid;
    cp_async16(smem_addr(dst + r * F32Smem<D>::kRow + c), in ? src + r * stride + c : src,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_f32_kernel(const F32Params p) {
  using L = F32Smem<D>;
  constexpr int kR4 = L::kRow / 4;  // float4s a padded row
  constexpr int kC = D / 64;        // float4 column groups a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = smem + L::kTile;  // the k tile, then p [kBQ][kRow]
  float* vs = smem + 2 * L::kTile;
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bi = blockIdx.x / p.h, qh = blockIdx.x % p.h;
  const int kvh = qh / (p.h / p.h_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the heaviest tiles first
  const int rows = min(kBQ, p.sq - q0);
  // keys past the block's last query are never seen
  int kv_end = p.skv;
  if (p.causal) kv_end = max(0, min(p.skv, p.q_offset + q0 + rows - p.kv_offset));

  const float* kg = p.k + bi * p.k_sb + kvh * p.k_sh;
  const float* vg = p.v + bi * p.v_sb + kvh * p.v_sh;
  const float* bias = p.bias ? p.bias + bi * p.bias_sb : nullptr;
  copy_rows<D, kBQ>(qs, p.q + bi * p.q_sb + q0 * p.q_ss + qh * p.q_sh, p.q_ss, rows, tid);
  cp_async_commit();

  float m[4], l[4], acc[4][kC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kBigNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the last tile's p and v are consumed
    const int keys = min(kBK, p.skv - k0);
    copy_rows<D, kBK>(ks, kg + k0 * p.k_ss, p.k_ss, keys, tid);
    copy_rows<D, kBK>(vs, vg + k0 * p.v_ss, p.v_ss, keys, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs4[(ty + 16 * i) * kR4 + d4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks4[(tx + 16 * j) * kR4 + d4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
    }

    // scale, bias and masks; then the online softmax of each row (s
    // becomes p in place)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kBigNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        ok[j] = kj < p.skv && qi < p.sq;
        if (ok[j] && bias) x += __ldg(bias + qi * p.bias_sr + kj);
        ok[j] = ok[j] && x > kMaskGuard &&
                (!p.causal || p.kv_offset + kj <= p.q_offset + qi);
        s[i][j] = x;
        if (ok[j]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 1 while the row has no valid key
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();  // every thread is done reading the k tile: p goes there
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ks[(ty + 16 * i) * L::kRow + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int k4 = 0; k4 < kBK / 4; ++k4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ks4[(ty + 16 * i) * kR4 + k4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vb[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) vb[c] = vs4[(4 * k4 + u) * kR4 + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            acc[i][c][0] = fmaf(pu, vb[c].x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pu, vb[c].y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pu, vb[c].z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pu, vb[c].w, acc[i][c][3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // the q copy, when no key tile ran

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* o = p.out + (((long long)bi * p.sq + qi) * p.h + qh) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      *reinterpret_cast<float4*>(o + (tx + 16 * c) * 4) =
          make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv, acc[i][c][2] * inv,
                      acc[i][c][3] * inv);
    if (tx == 0)
      p.lse[((long long)bi * p.h + qh) * p.sq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : kBigNeg;
  }
}

template <int D>
cudaError_t launch(const F32Params& p, int b, cudaStream_t stream) {
  constexpr int smem = F32Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * p.h, (p.sq + kBQ - 1) / kBQ);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
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
                                 float scale, void* stream) {
  if (h_kv <= 0 || h % h_kv) return cudaErrorInvalidValue;
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
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(p, b, s);
    case 128:
      return launch<128>(p, b, s);
    default:
      return cudaErrorInvalidValue;
  }
}
