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
//            at q_offset + i, key j at kv_offset + j; keys ≥ skv, rows ≥ sq)
//   p  = logits > MASK_GUARD ? exp(logits − lse) : 0     (lse from K1)
//   dp = g·vᵀ,  ds = p·(dp − delta)·scale                  (delta = Σ g·out)
//   dv = pᵀ·g, dk = dsᵀ·q, dq = ds·k
// with an additive fp32 bias per key [bb, 1, skv] or per (row, key)
// [bb, sq, skv], GQA (query head qh reads kv head qh / g) and dk/dv
// returned at h_kv heads, every group member summed in fp32. Nothing is
// rounded: p and ds stay fp32, as the TPU kernels keep them at fp32 inputs.
//
// What bounds it on the card: five products of 2·d flops per (query, key)
// pair and head (two recompute the forward's q·kᵀ and g·vᵀ), 10·sq·skv·d
// flops per head, half of them for a causal row, on O((sq + skv)·d) bytes.
// The fp32 suite holds this route at 1e-5, and TF32 (`wgmma`'s only fp32
// input) keeps ~3 digits, so the products run as fp32 FMAs on the CUDA
// cores: 67 TFLOP/s on an H100 SXM, the bound here. The design is the
// simple tiled one of flash_fwd_f32.cu turned around, as flash_bwd.cu is:
// - One block of 256 threads per (b·h_kv, 64-key tile), the heaviest
//   (causally first) key tiles of every head launched first. The block's k
//   and v tiles stay in shared memory; it walks every (group member,
//   64-query tile) from the causal start. q, g, lse and delta of the next
//   tile are copied by 16-byte `cp.async` into the other of two stages
//   while this tile computes (rows past sq and keys past skv zero-filled).
// - Thread (ty, tx) of a 16 × 16 grid owns keys ty + 16i and queries
//   tx + 16j (i, j < 4): sᵀ = k·qᵀ and dpᵀ = v·gᵀ in registers from 16-byte
//   reads along d. k and v rows are read by a quarter-warp at one address
//   (a broadcast); q and g rows by eight rows at once, so their 16-byte
//   chunks are swizzled (chunk c of row r at c ^ (r % 8)) instead of padded:
//   padding would not fit the block's 225 KB at d 128.
// - pᵀ and dsᵀ go to shared memory [64 keys × 64 queries]; the same thread
//   adds dv += pᵀ·g and dk += dsᵀ·q for its keys and columns (tx + 16c)·4
//   .. + 3. dk and dv stay in fp32 registers (2 × 4 keys × d / 16 floats a
//   thread: 64 at d 128) for the whole block and are written once, with no
//   atomics.
// - dq = ds·k over the block's 64 keys: thread (dc, qa) = (tid / 16,
//   tid % 16) owns queries 4qa .. 4qa + 3 (one 16-byte read of dsᵀ a key)
//   and columns (dc + 16c)·4 .. + 3, and adds them into the fp32 dq_accum
//   [b, sq, h, d] with float2 atomics, as flash_bwd.cu does. Atomics rather
//   than a second pass over the keys: a second pass would recompute p and
//   ds (four more products of the five), and the atomics' traffic (d floats
//   a query a key tile) is small beside the products. The order of those
//   sums changes from run to run, so dq is not bit-reproducible (dk and dv
//   are).
// - One block an SM (225 KB of shared memory at d 128, 129 KB at d 64);
//   the two-stage copies hide the loads.
// It runs at 50% of its fp32 bound at the train shape (b2 S4096 h32, and
// b1 S8192) on an H100 80GB HBM3 at 700 W (PERF.md): its inner loops read
// shared memory once every 8-11 FMAs, so shared memory, not the FMA pipes,
// is what it waits on; larger register tiles are the lever left.

#include "hopper.cuh"

namespace {

using lwm::cp_async16;
using lwm::cp_async4;
using lwm::cp_async_commit;
using lwm::cp_async_wait_all;
using lwm::kBigNeg;
using lwm::kMaskGuard;
using lwm::smem_addr;

constexpr int kThreads = 256;
constexpr int kBK = 64;  // keys a block
constexpr int kBQ = 64;  // queries a tile

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
  int causal, q_offset, kv_offset;
  float scale;
};

// Shared memory of one block, in floats: k and v [kBK][D], q and g
// [2 stages][kBQ][D] (swizzled), pᵀ and dsᵀ [kBK][kBQ], lse and delta
// [2 stages][2][kBQ]
template <int D>
struct SmemF32 {
  static constexpr int kKV = kBK * D;
  static constexpr int kQG = kBQ * D;
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQ = 2 * kKV;
  static constexpr int kG = kQ + 2 * kQG;
  static constexpr int kP = kG + 2 * kQG;
  static constexpr int kDS = kP + kBK * kBQ;
  static constexpr int kStat = kDS + kBK * kBQ;
  static constexpr int kBytes = (kStat + 2 * 2 * kBQ) * 4;
};

// float4 index of chunk c of row r in a swizzled [rows][D] tile
template <int D>
__device__ __forceinline__ int sw4(int r, int c) {
  return r * (D / 4) + (c ^ (r & 7));
}

// ROWS rows of D floats, row r at src + r * stride, into shared memory at
// `dst` (swizzled or not); rows at or past `valid` are zero-filled (no
// bytes read), so masked rows never carry garbage into a product
template <int D, int ROWS, bool SWIZZLE>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, long long stride,
                                          int valid, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < valid;
    const int at = SWIZZLE ? sw4<D>(r, c) : r * kChunks + c;
    cp_async16(smem_addr(dst + 4 * at), in ? src + r * stride + 4 * c : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane4(const float4 a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_f32_kernel(const BwdF32Params p) {
  using L = SmemF32<D>;
  constexpr int kD4 = D / 4;   // float4s a row
  constexpr int kC = D / 64;   // float4 column groups a thread
  constexpr int kQ4 = kBQ / 4;
  extern __shared__ __align__(16) float smem[];
  const float4* ks4 = reinterpret_cast<const float4*>(smem + L::kK);
  const float4* vs4 = reinterpret_cast<const float4*>(smem + L::kV);
  float* ps = smem + L::kP;
  float* dss = smem + L::kDS;
  const float4* ps4 = reinterpret_cast<const float4*>(ps);
  const float4* dss4 = reinterpret_cast<const float4*>(dss);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bi = blockIdx.x / p.h_kv, kvh = blockIdx.x % p.h_kv;
  const int group = p.h / p.h_kv;
  const int k0 = blockIdx.y * kBK;
  const int keys = min(kBK, p.skv - k0);
  const float* bias_g = p.bias ? p.bias + bi * p.bias_sb : nullptr;

  // the (group member, query tile) walk: from the first query that sees
  // any key of this tile
  const int q_start = p.causal ? max(0, p.kv_offset + k0 - p.q_offset) : 0;
  const int qt0 = q_start / kBQ;
  const int per = max(0, (p.sq + kBQ - 1) / kBQ - qt0);
  const int n_iter = group * per;

  auto load_q = [&](int it, int s) {
    const int qh = kvh * group + it / per, q0 = (qt0 + it % per) * kBQ;
    const int rows = min(kBQ, p.sq - q0);
    copy_rows<D, kBQ, true>(smem + L::kQ + s * L::kQG,
                            p.q + bi * p.q_sb + (long long)q0 * p.q_ss + qh * p.q_sh, p.q_ss,
                            rows, tid);
    copy_rows<D, kBQ, true>(smem + L::kG + s * L::kQG,
                            p.g + bi * p.g_sb + (long long)q0 * p.g_ss + qh * p.g_sh, p.g_ss,
                            rows, tid);
    if (tid < 2 * kBQ) {  // lse (threads 0..63) and delta (64..127)
      const int r = tid % kBQ;
      const float* src = (tid < kBQ ? p.lse : p.delta) + ((long long)bi * p.h + qh) * p.sq + q0;
      cp_async4(smem_addr(smem + L::kStat + s * 2 * kBQ + tid), src + (r < rows ? r : 0),
                r < rows ? 4 : 0);
    }
  };

  copy_rows<D, kBK, false>(smem + L::kK,
                           p.k + bi * p.k_sb + (long long)k0 * p.k_ss + kvh * p.k_sh, p.k_ss,
                           keys, tid);
  copy_rows<D, kBK, false>(smem + L::kV,
                           p.v + bi * p.v_sb + (long long)k0 * p.v_ss + kvh * p.v_sh, p.v_ss,
                           keys, tid);
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();

  // this thread's keys ty + 16i: their per-key bias, when the bias has one row
  float key_bias[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    key_bias[i] = bias_g && p.bias_sr == 0 && key < p.skv ? bias_g[key] : 0.f;
  }
  const bool full_bias = bias_g && p.bias_sr != 0;

  float dk[4][kC][4], dv[4][kC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][c][e] = dv[i][c][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int s = it & 1;
    const int qh = kvh * group + it / per, q0 = (qt0 + it % per) * kBQ;
    cp_async_wait_all();  // this thread's copies of stage s (and of k, v)
    __syncthreads();      // stage s complete; iteration it − 1 is done with the rest
    if (it + 1 < n_iter) load_q(it + 1, s ^ 1);
    cp_async_commit();

    const float4* qs4 = reinterpret_cast<const float4*>(smem + L::kQ + s * L::kQG);
    const float4* gs4 = reinterpret_cast<const float4*>(smem + L::kG + s * L::kQG);
    const float* lse_s = smem + L::kStat + s * 2 * kBQ;
    const float* delta_s = lse_s + kBQ;

    // sᵀ = k·qᵀ and dpᵀ = v·gᵀ: keys ty + 16i, queries tx + 16j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < kD4; ++d4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ks4[(ty + 16 * i) * kD4 + d4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = qs4[sw4<D>(tx + 16 * j, d4)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dot4(a[i], b[j], st[i][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = vs4[(ty + 16 * i) * kD4 + d4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = gs4[sw4<D>(tx + 16 * j, d4)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dpt[i][j] = dot4(a[i], b[j], dpt[i][j]);
    }

    // pᵀ and dsᵀ, to shared memory
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qj = tx + 16 * j, qrow = q0 + qj;
      const float lse = lse_s[qj], delta = delta_s[qj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ki = ty + 16 * i, key = k0 + ki;
        float x = st[i][j] * p.scale + key_bias[i];
        bool valid = key < p.skv && qrow < p.sq;
        if (valid && full_bias) x += bias_g[qrow * p.bias_sr + key];
        if (p.causal && p.kv_offset + key > p.q_offset + qrow) valid = false;
        const float pe = valid && x > kMaskGuard ? expf(x - lse) : 0.f;
        ps[ki * kBQ + qj] = pe;
        dss[ki * kBQ + qj] = pe * (dpt[i][j] - delta) * p.scale;
      }
    }
    __syncthreads();

    // dv += pᵀ·g, dk += dsᵀ·q: keys ty + 16i, columns (tx + 16c)·4 .. + 3
#pragma unroll 2
    for (int q4 = 0; q4 < kQ4; ++q4) {
      float4 pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps4[(ty + 16 * i) * kQ4 + q4];
        da[i] = dss4[(ty + 16 * i) * kQ4 + q4];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = 4 * q4 + u;
        float4 gb[kC], qb[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          gb[c] = gs4[sw4<D>(row, tx + 16 * c)];
          qb[c] = qs4[sw4<D>(row, tx + 16 * c)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = lane4(pa[i], u), du = lane4(da[i], u);
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            fma4(dv[i][c], pu, gb[c]);
            fma4(dk[i][c], du, qb[c]);
          }
        }
      }
    }

    // dq = ds·k over this tile's keys: queries 4qa .. 4qa + 3, columns
    // (dc + 16c)·4 .. + 3
    {
      const int qa = tid % 16, dc = tid / 16;
      float dq[4][kC][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[r][c][e] = 0.f;
#pragma unroll 4
      for (int kj = 0; kj < kBK; ++kj) {
        const float4 dsv = dss4[kj * kQ4 + qa];
        float4 kb[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) kb[c] = ks4[kj * kD4 + dc + 16 * c];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          fma4(dq[0][c], dsv.x, kb[c]);
          fma4(dq[1][c], dsv.y, kb[c]);
          fma4(dq[2][c], dsv.z, kb[c]);
          fma4(dq[3][c], dsv.w, kb[c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qrow = q0 + 4 * qa + r;
        if (qrow >= p.sq) continue;
        float* dst = p.dq_accum + (((long long)bi * p.sq + qrow) * p.h + qh) * D;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int col = (dc + 16 * c) * 4;
          atomicAdd(reinterpret_cast<float2*>(dst + col), make_float2(dq[r][c][0], dq[r][c][1]));
          atomicAdd(reinterpret_cast<float2*>(dst + col + 2),
                    make_float2(dq[r][c][2], dq[r][c][3]));
        }
      }
    }
  }

  cp_async_wait_all();  // no copy is left in flight when the block exits
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.skv) continue;
    const long long off = (((long long)bi * p.skv + key) * p.h_kv + kvh) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = (tx + 16 * c) * 4;
      *reinterpret_cast<float4*>(p.dk + off + col) =
          make_float4(dk[i][c][0], dk[i][c][1], dk[i][c][2], dk[i][c][3]);
      *reinterpret_cast<float4*>(p.dv + off + col) =
          make_float4(dv[i][c][0], dv[i][c][1], dv[i][c][2], dv[i][c][3]);
    }
  }
}

template <int D>
cudaError_t launch(const BwdF32Params& p, int b, cudaStream_t stream) {
  constexpr int smem = SmemF32<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // blockIdx.x walks (b, kv head), blockIdx.y the key tiles: the heaviest
  // (causal) tiles of every head first
  const dim3 grid(b * p.h_kv, (p.skv + kBK - 1) / kBK);
  flash_bwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
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
                                 float scale, void* stream) {
  if (h_kv <= 0 || h % h_kv) return cudaErrorInvalidValue;
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
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || skv <= 0) return cudaSuccess;  // nothing to write (dq stays 0)
  switch (d) {
    case 64:
      return launch<64>(p, b, s);
    case 128:
      return launch<128>(p, b, s);
    default:
      return cudaErrorInvalidValue;
  }
}
