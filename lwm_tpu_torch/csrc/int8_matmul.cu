// K5: W8A16 dequant matmul for Hopper (sm_90a):
//   out[m, f] = bf16((Σ_d x[m, d] · bf16(w[f, d])) · scale[f])
//
// Replaces the TPU kernel `_int8_matmul_kernel` (lwm_tpu/ops/quant.py:107-122,
// reached through int8_matmul_pallas :139-174). Same contract and order: x bf16
// [m, d] row-major; w int8 [f, d] (torch's [out, in] layout, so each output
// channel's weights are contiguous); scale fp32 [f]. The int8 weight is
// converted to bf16 in registers (exact for |q| ≤ 127), the products are
// summed in fp32, multiplied by the fp32 scale and rounded to bf16 once.
//
// What bounds it on the card, and the two designs:
// - Decode (m ≤ 16, `int8_gemv_kernel`): 2·m flops per weight byte, far below
//   the H100's ~295 flop/byte ridge, so the int8 weight stream from HBM bounds
//   it (w1 at 4096 → 11008 is 45 MB: at least 13.5 µs at 3.35 TB/s). The
//   weight is the mma A operand (16 output channels per row tile) and the ≤ 16
//   tokens are the B operand (8 per column tile, missing tokens zero), so no
//   lane of the tensor core works on padding rows of the weight. Each thread
//   streams 16 contiguous weight bytes per row per 64-wide chunk; the k order
//   inside the chunk is permuted so that those 16 bytes are exactly the
//   thread's A fragments of four m16n8k16 steps (x's B fragments take the same
//   permutation, which the sum does not see). A block of 8 warps owns 32
//   output channels and splits d among its warps, so more bytes are in flight
//   at small f; the warps' fp32 partials are summed in shared memory. The next
//   chunk's loads are issued before the current chunk's mmas.
// - Admission (m up to 2048, `int8_gemm_kernel`): 2·m flops per weight byte,
//   above the ridge, so the tensor cores bound it (w1 at m 2048 is 185 GFLOP:
//   at least 0.187 ms at 989 TFLOP/s). 128 × 128 output tiles, 8 warps of
//   64 × 32, k tiles of 32 staged in shared memory by a 3-stage cp.async
//   pipeline (x as bf16, w as int8: the weight tile costs half the bytes of a
//   bf16 one). Each thread's 8 k values of a row are again contiguous, so its
//   fragments come from one 16-byte (x) and one 8-byte (w) shared-memory load
//   with no bank conflicts, and int8 → bf16 happens in registers.
// Ragged m, f and d edges are zero-filled at the loads and masked at the
// stores; d is a multiple of 16 (16-byte weight rows; the wrapper checks).
// Not yet: wgmma, TMA, split-K for decode at small f.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGemvRows = 32;  // output channels per decode block: 2 row tiles
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;

struct Args {
  const __nv_bfloat16* x;
  const int8_t* w;
  const float* scale;
  __nv_bfloat16* out;
  int m, f, d;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// four int8 (one little-endian word) → two bf16x2 words: bytes 0,1 in `lo`,
// bytes 2,3 in `hi`. q + 128 is placed in the low mantissa bits of 2^23, so
// one byte permute and one subtraction give q exactly, with no int→float
// conversion instruction.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t q4, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = q4 ^ 0x80808080u;
  const float bias = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - bias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - bias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - bias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - bias;
  lo = pack_bf16(f0, f1);
  hi = pack_bf16(f2, f3);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
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
__global__ void __launch_bounds__(kThreads) int8_gemv_kernel(const Args a) {
  constexpr int kE = 2 * NT * 4;  // fp32 accumulators per thread
  __shared__ float red[kWarps][kE][32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.x * kGemvRows;

  // this thread's weight rows (f0 + 16·ft + 8·hh + g) and token rows (8·nt + g)
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
  const __nv_bfloat16* xrow[NT];
  bool xok[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int tok = 8 * nt + g;
    xok[nt] = tok < a.m;
    xrow[nt] = a.x + (long long)(xok[nt] ? tok : 0) * a.d + 16 * t;
  }

  float acc[2][NT][4];
#pragma unroll
  for (int ft = 0; ft < 2; ++ft)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[ft][nt][0] = acc[ft][nt][1] = acc[ft][nt][2] = acc[ft][nt][3] = 0.f;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int n_chunks = (a.d + 63) / 64;
  uint4 wn[2][2], xn[NT][2];  // the next chunk, loaded ahead
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
    for (int nt = 0; nt < NT; ++nt) {
      const uint4* src = reinterpret_cast<const uint4*>(xrow[nt] + k);
      xn[nt][0] = kin && xok[nt] ? __ldg(src) : zero;
      xn[nt][1] = kin && xok[nt] ? __ldg(src + 1) : zero;
    }
  };

  load(warp);
  for (int c = warp; c < n_chunks; c += kWarps) {
    uint4 wc[2][2], xc[NT][2];
#pragma unroll
    for (int ft = 0; ft < 2; ++ft) wc[ft][0] = wn[ft][0], wc[ft][1] = wn[ft][1];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) xc[nt][0] = xn[nt][0], xc[nt][1] = xn[nt][1];
    load(c + kWarps);
    // step j reads bytes 4j..4j+3 of each 16-byte weight run: physical k
    // 16t+4j+{0,1} stand for logical k 2t+{0,1}, 16t+4j+{2,3} for 2t+8+{0,1}
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t af[2][4];
#pragma unroll
      for (int ft = 0; ft < 2; ++ft) {
        i8x4_to_bf16(word(wc[ft][0], j), af[ft][0], af[ft][2]);
        i8x4_to_bf16(word(wc[ft][1], j), af[ft][1], af[ft][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4& half = xc[nt][j >> 1];  // x elements 4j..4j+3
        const uint32_t b0 = (j & 1) ? half.z : half.x;
        const uint32_t b1 = (j & 1) ? half.w : half.y;
#pragma unroll
        for (int ft = 0; ft < 2; ++ft)
          mma_bf16_16816(acc[ft][nt], af[ft][0], af[ft][1], af[ft][2], af[ft][3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int ft = 0; ft < 2; ++ft)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) red[warp][(ft * NT + nt) * 4 + r][lane] = acc[ft][nt][r];
  __syncthreads();

  // one (accumulator, lane) slot per thread step: sum the warps, scale, store
  for (int i = tid; i < kE * 32; i += kThreads) {
    const int e = i >> 5, ln = i & 31;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][e][ln];
    const int ft = e / (NT * 4), nt = (e >> 2) % NT, r = e & 3;
    const int row = f0 + 16 * ft + (ln >> 2) + 8 * (r >> 1);  // C rows: output channels
    const int tok = 8 * nt + 2 * (ln & 3) + (r & 1);          // C columns: tokens
    if (row < a.f && tok < a.m)
      a.out[(long long)tok * a.f + row] = __float2bfloat16_rn(s * a.scale[row]);
  }
}

// -------------------------------------------------------------- admission

__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(const Args a) {
  __shared__ __align__(16) __nv_bfloat16 xs[kStages][kBM][kBK];
  __shared__ __align__(16) int8_t ws[kStages][kBN][kBK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows 64·wm.., columns 32·wn..
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (a.d + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {  // x: 8 bf16 per copy
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = m0 + r < a.m && k0 + c < a.d;
      cp_async16(&xs[stage][r][c], a.x + (ok ? (long long)(m0 + r) * a.d + k0 + c : 0), ok);
    }
    for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {  // w: 16 int8 per copy
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool ok = n0 + r < a.f && k0 + c < a.d;
      cp_async16(&ws[stage][r][c], a.w + (ok ? (long long)(n0 + r) * a.d + k0 + c : 0), ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

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
    uint4 xa[4][2];  // rows g and g + 8 of each 16-row tile: k 8t..8t+7
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        xa[mt][hh] = *reinterpret_cast<const uint4*>(&xs[st][wm * 64 + mt * 16 + 8 * hh + g][8 * t]);
    uint2 wb[4];  // weight row g of each 8-column tile: k 8t..8t+7
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      wb[nt] = *reinterpret_cast<const uint2*>(&ws[st][wn * 32 + nt * 8 + g][8 * t]);
    // step j: physical k 8t+4j+{0,1} stand for logical 2t+{0,1}, 8t+4j+{2,3}
    // for 2t+8+{0,1}, in x's A fragments and w's B fragments alike
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) i8x4_to_bf16(j ? wb[nt].y : wb[nt].x, bf[nt][0], bf[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t a0 = word(xa[mt][0], 2 * j), a1 = word(xa[mt][1], 2 * j);
        const uint32_t a2 = word(xa[mt][0], 2 * j + 1), a3 = word(xa[mt][1], 2 * j + 1);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a0, a1, a2, a3, bf[nt][0], bf[nt][1]);
      }
    }
  }

  const bool pairs = (a.f & 1) == 0;  // bf16x2 stores stay 4-byte aligned
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 64 + mt * 16 + 8 * hh + g;
      if (row >= a.m) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        __nv_bfloat16* o = a.out + (long long)row * a.f + col;
        const float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
        if (pairs && col + 1 < a.f) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(v0 * a.scale[col], v1 * a.scale[col + 1]);
        } else {
          if (col < a.f) o[0] = __float2bfloat16_rn(v0 * a.scale[col]);
          if (col + 1 < a.f) o[1] = __float2bfloat16_rn(v1 * a.scale[col + 1]);
        }
      }
    }
}

}  // namespace

extern "C" int lwm_int8_matmul(const void* x, const void* w, const void* scale, void* out, int m,
                               int f, int d, void* stream) {
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.m = m;
  a.f = f;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || f <= 0) return cudaSuccess;
  if (d % 16) return cudaErrorInvalidValue;
  if (m <= 8) {
    int8_gemv_kernel<1><<<(f + kGemvRows - 1) / kGemvRows, kThreads, 0, s>>>(a);
  } else if (m <= 16) {
    int8_gemv_kernel<2><<<(f + kGemvRows - 1) / kGemvRows, kThreads, 0, s>>>(a);
  } else {
    const dim3 grid((f + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    int8_gemm_kernel<<<grid, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}
