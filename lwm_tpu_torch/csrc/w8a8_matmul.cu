// K6: W8A8 int8 matmul for Hopper (sm_90a):
//   out[m, f] = bf16((float(Σ_d x_q[m, d] · w[f, d]) · x_scale[m]) · w_scale[f])
//
// Replaces the TPU kernel `_w8a8_matmul_kernel` (lwm_tpu/ops/quant.py:182-202,
// reached through w8a8_matmul_pallas :205-244). Same contract and order: int8
// x_q [m, d] with an fp32 per-row scale [m, 1] (the activations, quantized per
// row outside the kernel); int8 w [f, d] (torch's [out, in] layout) with an
// fp32 per-output-channel scale [f]. Products are summed exactly in int32
// (d·127² < 2³¹) on the tensor cores (mma.sync m16n8k32 s8·s8 → s32); the
// epilogue is JAX's `acc.astype(f32) * x_scale * w_scale`, in that order, so
// the result is bit-identical to the plain twin.
//
// What bounds it on the card, and the two designs:
// - Decode (m ≤ 16, `w8a8_gemv_kernel`): 2·m ops per weight byte, far below
//   the ridge (1,979 TOP/s over 3.35 TB/s), so the int8 weight stream bounds
//   it, exactly as for K5 (w1 at 4096 → 11008: at least 13.5 µs). The same
//   shape as K5's decode kernel: the weight is the A operand (16 output
//   channels per row tile), the tokens the B operand (8 per column tile); each
//   thread streams 16 contiguous bytes per row per 64-wide chunk, which are its
//   A fragments of two m16n8k32 steps under a k permutation that x_q's B
//   fragments share; 8 warps per block split d and sum their int32 partials in
//   shared memory (exact, so the order does not matter). Unlike K5 there is
//   no conversion at all: the bytes go to the tensor cores as they are.
// - Admission (m up to 2048, `w8a8_gemm_kernel`): above the ridge, so the
//   int8 tensor-core rate bounds it (w1 at m 2048: at least 0.093 ms at 1,979
//   TOP/s). 128 × 128 output tiles, 8 warps of 64 × 32, k tiles of 64 bytes
//   staged by a 3-stage cp.async pipeline; each thread's 16 k bytes of a row
//   are contiguous, so every fragment comes from one 16-byte shared-memory
//   load with no bank conflicts.
// Ragged m, f and d edges are zero-filled at the loads (zeros add nothing to
// an integer sum) and masked at the stores; d is a multiple of 16 (16-byte
// rows; the wrapper checks). Not yet: wgmma, TMA, split-K for decode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGemvRows = 32;  // output channels per decode block: 2 row tiles
constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;

struct Args {
  const int8_t* xq;
  const float* xs;
  const int8_t* w;
  const float* ws;
  __nv_bfloat16* out;
  int m, f, d;
};

__device__ __forceinline__ void mma_s8_16832(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// the epilogue in JAX's order: (float(acc) · row scale) · column scale
__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ----------------------------------------------------------------- decode

template <int NT>  // token tiles of 8: m ≤ 8·NT
__global__ void __launch_bounds__(kThreads) w8a8_gemv_kernel(const Args a) {
  constexpr int kE = 2 * NT * 4;  // int32 accumulators per thread
  __shared__ int red[kWarps][kE][32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.x * kGemvRows;

  const int8_t* wrow[2][2];
  bool wok[2][2];
#pragma unroll
  for (int ft = 0; ft < 2; ++ft)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = f0 + 16 * ft + 8 * hh + g;
      wok[ft][hh] = r < a.f;
      wrow[ft][hh] = a.w + (long long)(wok[ft][hh] ? r : 0) * a.d + 16 * t;
    }
  const int8_t* xrow[NT];
  bool xok[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int tok = 8 * nt + g;
    xok[nt] = tok < a.m;
    xrow[nt] = a.xq + (long long)(xok[nt] ? tok : 0) * a.d + 16 * t;
  }

  int acc[2][NT][4];
#pragma unroll
  for (int ft = 0; ft < 2; ++ft)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[ft][nt][0] = acc[ft][nt][1] = acc[ft][nt][2] = acc[ft][nt][3] = 0;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int n_chunks = (a.d + 63) / 64;
  uint4 wn[2][2], xn[NT];  // the next chunk, loaded ahead
  auto load = [&](int c) {
    const int k = c * 64;
    const bool kin = c < n_chunks && k + 16 * t < a.d;  // d % 16 == 0: all 16 in or out
#pragma unroll
    for (int ft = 0; ft < 2; ++ft)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        wn[ft][hh] = kin && wok[ft][hh] ? __ldcs(reinterpret_cast<const uint4*>(wrow[ft][hh] + k))
                                        : zero;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      xn[nt] = kin && xok[nt] ? __ldg(reinterpret_cast<const uint4*>(xrow[nt] + k)) : zero;
  };

  load(warp);
  for (int c = warp; c < n_chunks; c += kWarps) {
    uint4 wc[2][2], xc[NT];
#pragma unroll
    for (int ft = 0; ft < 2; ++ft) wc[ft][0] = wn[ft][0], wc[ft][1] = wn[ft][1];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) xc[nt] = xn[nt];
    load(c + kWarps);
    // step j: physical k 16t+8j+{0..3} stand for logical 4t+{0..3},
    // 16t+8j+{4..7} for 16+4t+{0..3}, in both operands
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int ft = 0; ft < 2; ++ft)
          mma_s8_16832(acc[ft][nt], word(wc[ft][0], 2 * j), word(wc[ft][1], 2 * j),
                       word(wc[ft][0], 2 * j + 1), word(wc[ft][1], 2 * j + 1),
                       word(xc[nt], 2 * j), word(xc[nt], 2 * j + 1));
  }

#pragma unroll
  for (int ft = 0; ft < 2; ++ft)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) red[warp][(ft * NT + nt) * 4 + r][lane] = acc[ft][nt][r];
  __syncthreads();

  for (int i = tid; i < kE * 32; i += kThreads) {
    const int e = i >> 5, ln = i & 31;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][e][ln];
    const int ft = e / (NT * 4), nt = (e >> 2) % NT, r = e & 3;
    const int row = f0 + 16 * ft + (ln >> 2) + 8 * (r >> 1);  // C rows: output channels
    const int tok = 8 * nt + 2 * (ln & 3) + (r & 1);          // C columns: tokens
    if (row < a.f && tok < a.m)
      a.out[(long long)tok * a.f + row] = __float2bfloat16_rn(dequant(s, a.xs[tok], a.ws[row]));
  }
}

// -------------------------------------------------------------- admission

__global__ void __launch_bounds__(kThreads) w8a8_gemm_kernel(const Args a) {
  __shared__ __align__(16) int8_t xs[kStages][kBM][kBK];
  __shared__ __align__(16) int8_t ws[kStages][kBN][kBK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows 64·wm.., columns 32·wn..
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (a.d + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBM * (kBK / 16); i += kThreads) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool ok = m0 + r < a.m && k0 + c < a.d;
      cp_async16(&xs[stage][r][c], a.xq + (ok ? (long long)(m0 + r) * a.d + k0 + c : 0), ok);
    }
    for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool ok = n0 + r < a.f && k0 + c < a.d;
      cp_async16(&ws[stage][r][c], a.w + (ok ? (long long)(n0 + r) * a.d + k0 + c : 0), ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int pf = kt + kStages - 1;
    if (pf < nk) load_stage(pf % kStages, pf);
    cp_async_commit();

    const int st = kt % kStages;
    uint4 xa[4][2], wb[4];  // k bytes 16t..16t+15 of rows g, g + 8 (x) and g (w)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        xa[mt][hh] = *reinterpret_cast<const uint4*>(&xs[st][wm * 64 + mt * 16 + 8 * hh + g][16 * t]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      wb[nt] = *reinterpret_cast<const uint4*>(&ws[st][wn * 32 + nt * 8 + g][16 * t]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8_16832(acc[mt][nt], word(xa[mt][0], 2 * j), word(xa[mt][1], 2 * j),
                       word(xa[mt][0], 2 * j + 1), word(xa[mt][1], 2 * j + 1),
                       word(wb[nt], 2 * j), word(wb[nt], 2 * j + 1));
  }

  const bool pairs = (a.f & 1) == 0;  // bf16x2 stores stay 4-byte aligned
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 64 + mt * 16 + 8 * hh + g;
      if (row >= a.m) continue;
      const float sx = a.xs[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        __nv_bfloat16* o = a.out + (long long)row * a.f + col;
        const int v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
        if (pairs && col + 1 < a.f) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(dequant(v0, sx, a.ws[col]), dequant(v1, sx, a.ws[col + 1]));
        } else {
          if (col < a.f) o[0] = __float2bfloat16_rn(dequant(v0, sx, a.ws[col]));
          if (col + 1 < a.f) o[1] = __float2bfloat16_rn(dequant(v1, sx, a.ws[col + 1]));
        }
      }
    }
}

}  // namespace

extern "C" int lwm_w8a8_matmul(const void* xq, const void* xs, const void* w, const void* ws,
                               void* out, int m, int f, int d, void* stream) {
  Args a;
  a.xq = static_cast<const int8_t*>(xq);
  a.xs = static_cast<const float*>(xs);
  a.w = static_cast<const int8_t*>(w);
  a.ws = static_cast<const float*>(ws);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.m = m;
  a.f = f;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || f <= 0) return cudaSuccess;
  if (d % 16) return cudaErrorInvalidValue;
  if (m <= 8) {
    w8a8_gemv_kernel<1><<<(f + kGemvRows - 1) / kGemvRows, kThreads, 0, s>>>(a);
  } else if (m <= 16) {
    w8a8_gemv_kernel<2><<<(f + kGemvRows - 1) / kGemvRows, kThreads, 0, s>>>(a);
  } else {
    const dim3 grid((f + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    w8a8_gemm_kernel<<<grid, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}
