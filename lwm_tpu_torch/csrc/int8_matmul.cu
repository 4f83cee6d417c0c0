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
// - Decode (m ≤ 16, the ring of gemv.cuh with `Int8Gemv`): 2·m flops per
//   weight byte, far below the H100's ~295 flop/byte ridge, so the int8
//   weight stream from HBM bounds it (w1 at 4096 → 11008 is 45 MB: at least
//   13.5 µs at 3.35 TB/s). Three things stand between a kernel and that
//   bound: bytes in flight on every SM, the int8 → bf16 convert (as costly,
//   per block, as the stream), and a fixed cost per launch that a 5-15 µs
//   kernel feels. K5's part of the shared design:
//   * x comes through the ring with the weight as two boxes [8·NT, 64] bf16
//     a stage: 2·m / 32 of the weight's bytes (half at m 8), from the L2.
//     Dropping x's boxes altogether did not change the time.
//   * A consumer warp converts its weight chunks in registers
//     (`i8x4_to_bf16`, exact) and issues `mma.sync` m16n8k16; each chunk is
//     its A fragments of four steps and the matching x chunks its B
//     fragments. The convert is what a warp's time follows (without it a
//     consumer-only run took half as long; without the mma, as long): the
//     second team doubles the converting warps a block, and two
//     accumulator sets halve the mma chain. At 2·m flops a byte `wgmma`
//     would add a shared-memory copy of the converted weight.
//   * The split (`gemv_split`): d over a cluster of 2 or 4 blocks where f's
//     tiles leave SMs without a block (f 4096: 128 tiles on 132 SMs, 2).
//     The ring (`launch_ring`): 8 stages where the grid leaves at most two
//     blocks an SM, 4 where it has more (a smaller ring leaves room for
//     more blocks an SM). fp32 partials, summed in rank order.
// - Admission (m > kGemvMaxM, `int8_gemm_kernel`): 2·m flops per weight byte,
//   above the ridge, so the tensor cores bound it (w1 at m 2048 is 185 GFLOP:
//   at least 0.187 ms at 989 TFLOP/s), and on Hopper only `wgmma` reaches
//   their full rate. `wgmma` reads both operands from shared memory, so the
//   int8 weight has to be there as bf16 first, and that convert (not the
//   tensor cores) is what the block's time follows. The design:
//   * Each block owns a BM × 128 output tile and walks d in k tiles of 64
//     through a ring of stages in dynamic shared memory. A stage holds x
//     [BM, 64] bf16 and the weight [128, 64] twice: int8, as TMA brings it
//     (half a bf16 tile's bytes from HBM and L2), and bf16. x and the bf16
//     weight are K-major with the 128-byte swizzle (a 64-wide row is 128
//     bytes: 16-byte chunk c of row r sits at chunk c ^ (r % 8)), the layout
//     TMA writes and `wgmma` reads without bank conflicts.
//   * Warp specialisation: one producer warpgroup, whose thread 0 issues the
//     TMA loads (x and int8 w, completion counted in bytes on an mbarrier)
//     up to `kStages - 1` tiles ahead, and whose 128 threads convert each
//     landed int8 tile into the stage's bf16 tile, once per weight element
//     per block (`i8x4_to_bf16`, 16-byte shared loads and stores), then
//     `fence.proxy.async` and arrive on the stage's `full` barrier. WG
//     consumer warpgroups (64 rows each) only wait on `full`, issue four
//     m64n128k16 `wgmma`s (bf16 × bf16 → fp32 in registers), wait for them
//     and arrive on the stage's `empty` barrier. The scale is applied in the
//     epilogue, with one rounding to bf16.
//   * The convert costs per block what the weight tile costs, and a taller
//     tile shares it among more rows of x: BM = 256 (4 consumer
//     warpgroups) halves the convert per product of BM = 128. Tile pick:
//     the tallest of BM 256 / 128 / 64 whose grid covers at least half the
//     SMs (the 256-token bucket at f 4096 has 32 / 64 / 128 blocks: BM 64).
//     Blocks walk m first, so each weight tile comes from HBM about once.
// Ragged m, f and d edges are zero-filled at the loads (TMA fills
// out-of-bounds boxes with zeros) and masked at the stores; d is a multiple
// of 16 (16-byte weight rows and TMA strides; the wrapper checks).
// Not yet: a persistent grid (the epilogue overlapping the next tile's
// loads), pairs of blocks sharing one converted weight tile.

#include "gemv.cuh"

namespace {

using namespace lwm;

constexpr int kGemvMaxM = 16;  // m ≤ this: the decode GEMV; above: the GEMM
constexpr int kBN = 128;       // admission GEMM: output channels per block
constexpr int kBK = 64;        // and its k tile: one 128-byte swizzled bf16 row

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

// four int8 (one little-endian word) → two bf16x2 words: bytes 0,1 in `lo`,
// bytes 2,3 in `hi`
__device__ __forceinline__ void i8x4_to_bf16(uint32_t q4, uint32_t& lo, uint32_t& hi) {
  float f[4];
  i8x4_to_f32(q4, f);
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

// ----------------------------------------------------------------- decode

// K5's part of the decode GEMV (gemv.cuh): x as two [8·NT, 64] bf16 boxes a
// stage (k 0-63, 64-127), the weight converted in registers, fp32 sums
struct Int8Gemv {
  using Args = ::Args;
  using Acc = float;
  static constexpr int kXBoxes = 2;

  static cudaError_t x_map(CUtensorMap* map, const Args& a, int box_rows) {
    return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a.m, a.d, box_rows, 64,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  }

  // Lane (g, t) reads the weight chunks of gemv_weight_offsets and x chunks
  // 4(t % 2) .. + 3 of box t / 2 for token g, in the other order for t ≥ 2
  // (h = t / 2 flips the chunk index): the same k as its weight chunks, and
  // with the swizzle the 8 lanes of every load hit 8 different chunks.
  template <int NT>
  struct Consumer {
    int w_off[2][2], x_off[NT][4];

    __device__ Consumer(int tile, int lane) {
      const int g = lane >> 2, t = lane & 3, h = t >> 1;
      gemv_weight_offsets(tile, lane, w_off);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x_off[nt][i] = kGemvWBox + h * kGemvXBox<NT> + (8 * nt + g) * 128 +
                         (((4 * (t & 1) + (i ^ (2 * h))) ^ g) << 4);
    }

    __device__ void step(const uint8_t* st, float (&acc)[kGemvChains][NT][4]) const {
      uint4 wv[2][2], xv[NT][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) wv[r][q] = *reinterpret_cast<const uint4*>(st + w_off[r][q]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[nt][i] = *reinterpret_cast<const uint4*>(st + x_off[nt][i]);
      // step j: weight bytes 4(j % 4)..+3 of register j / 4 and x elements
      // 4(j % 2)..+3 of register j / 2 are the same four k; bytes and elements
      // 0, 1 stand for logical k 2t, 2t + 1 of the m16n8k16 step, 2, 3 for
      // 2t + 8, 2t + 9
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t af[4];
        i8x4_to_bf16(word(wv[0][j >> 2], j & 3), af[0], af[2]);
        i8x4_to_bf16(word(wv[1][j >> 2], j & 3), af[1], af[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4& c = xv[nt][j >> 1];
          const uint32_t b0 = (j & 1) ? c.z : c.x;
          const uint32_t b1 = (j & 1) ? c.w : c.y;
          mma_bf16_16816(acc[j % kGemvChains][nt], af[0], af[1], af[2], af[3], b0, b1);
        }
      }
    }
  };

  __device__ static __nv_bfloat16 out(const Args& a, float acc, int row, int) {
    return __float2bfloat16_rn(acc * a.scale[row]);
  }
};

// blocks of a cluster that split d: where f's row tiles leave SMs without a
// block, up to 4, while each block keeps at least 1024 of d
int gemv_split(int f, int d) {
  const int tiles = (f + kGemvRows - 1) / kGemvRows;
  int cs = 1;
  while (cs < 4 && tiles * cs < sm_count() && d >= 2048 * cs) cs *= 2;
  return cs;
}

// the ring: 8 stages where the grid leaves at most two blocks an SM, 4 where
// it has more (a smaller ring leaves room for more blocks an SM)
template <int NT, int CS>
cudaError_t launch_ring(const Args& a, cudaStream_t s) {
  const int blocks = CS * ((a.f + kGemvRows - 1) / kGemvRows);
  if (blocks <= 2 * sm_count()) return launch_gemv<Int8Gemv, NT, CS, 8>(a, s);
  return launch_gemv<Int8Gemv, NT, CS, 4>(a, s);
}

template <int NT>
cudaError_t gemv(const Args& a, cudaStream_t s) {
  const int cs = gemv_split(a.f, a.d);
  if (cs == 4) return launch_ring<NT, 4>(a, s);
  if (cs == 2) return launch_ring<NT, 2>(a, s);
  return launch_ring<NT, 1>(a, s);
}

// -------------------------------------------------------------- admission

template <int WG>  // WG consumer warpgroups: BM = 64·WG rows of x per block
struct GemmTile {
  static constexpr int kBM = 64 * WG;
  static constexpr int kThreads = 128 * (WG + 1);  // + the producer warpgroup
  static constexpr int kX = kBM * kBK * 2;         // x, bf16, swizzled (TMA)
  static constexpr int kWb = kBN * kBK * 2;        // weight, bf16, swizzled (the convert)
  static constexpr int kWq = kBN * kBK;            // weight, int8, row-major (TMA)
  static constexpr int kStage = kX + kWb + kWq;
  static constexpr int kFit = (232448 - 2048) / kStage;  // 227 KB less alignment and barriers
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kSmem = kStages * kStage + 2048;
};

// byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled tile
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B layout for 128-byte rows)
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

template <int WG>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map, const Args a) {
  using T = GemmTile<WG>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage s at base + s·kStage, 1024-aligned
  uint8_t* smem = smem_raw + (base - raw);
  // per stage: `loaded` (TMA bytes of x and int8 w), `full` (bf16 w written
  // by every producer thread), `empty` (every consumer warp is done with it)
  const uint32_t bars = base + S * T::kStage;
  auto loaded = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (S + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * S + s); };

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * T::kBM, n0 = blockIdx.y * kBN;
  const int nk = (a.d + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(loaded(s), 1);
      mbar_init(full(s), 128);
      mbar_init(empty(s), 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: TMA (thread 0) and the convert (every thread)
    auto issue = [&](int t) {  // TMA of tile t once its stage is free
      const int s = t % S;
      if (t >= S) mbar_wait(empty(s), (t / S + 1) & 1);
      const uint32_t st = base + s * T::kStage;
      mbar_expect_tx(loaded(s), T::kX + T::kWq);
      tma_load(st, &x_map, loaded(s), t * kBK, m0);
      tma_load(st + T::kX + T::kWb, &w_map, loaded(s), t * kBK, n0);
    };
    // tiles in flight ahead of the one converted: S - 1, the next issued
    // after this tile's convert (it waits for the consumers' tile t - 1)
    if (tid == 0)
      for (int t = 0; t < S - 1 && t < nk; ++t) issue(t);
    constexpr int kPer = kBN * 4 / 128;  // 16-byte int8 chunks per thread per tile
    for (int t = 0; t < nk; ++t) {
      const int s = t % S;
      mbar_wait(loaded(s), (t / S) & 1);
      uint8_t* st = smem + s * T::kStage;
      uint4 q[kPer];  // every chunk loaded before the first is converted
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + 128 * j;
        q[j] = *reinterpret_cast<const uint4*>(st + T::kX + T::kWb + (i >> 2) * kBK + 16 * (i & 3));
      }
      // 16 int8 of a row → the row's swizzled bf16 chunks 2c and 2c + 1
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + 128 * j, r = i >> 2, c = i & 3;
        uint4 lo, hi;
        i8x4_to_bf16(q[j].x, lo.x, lo.y);
        i8x4_to_bf16(q[j].y, lo.z, lo.w);
        i8x4_to_bf16(q[j].z, hi.x, hi.y);
        i8x4_to_bf16(q[j].w, hi.z, hi.w);
        *reinterpret_cast<uint4*>(st + T::kX + swz(r, 2 * c)) = lo;
        *reinterpret_cast<uint4*>(st + T::kX + swz(r, 2 * c + 1)) = hi;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes → wgmma
      mbar_arrive(full(s));
      if (tid == 0 && t + S - 1 < nk) issue(t + S - 1);
    }
    return;
  }

  // consumer warpgroups: wgmma only
  const int ct = tid - 128, wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  float acc[64];
  for (int t = 0; t < nk; ++t) {
    const int s = t % S;
    mbar_wait(full(s), (t / S) & 1);
    const uint32_t st = base + s * T::kStage;
    const uint64_t da = smem_desc(st + wg * 64 * 128), db = smem_desc(st + T::kX);
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) wgmma_m64n128k16(acc, da + 2 * k, db + 2 * k, t > 0 || k > 0);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(empty(s));
  }
  fence_acc(acc);
  if (nk == 0)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // accumulator i of a thread: row 16·warp + lane/4 + 8·((i/2)%2) of the
  // warpgroup's 64, column 8·(i/4) + 2·(lane%4) + i%2
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const bool pairs = (a.f & 1) == 0;  // bf16x2 stores stay 4-byte aligned
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    const float s0 = col < a.f ? a.scale[col] : 0.f;
    const float s1 = col + 1 < a.f ? a.scale[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= a.m) continue;
      const float v0 = acc[4 * j + 2 * h] * s0, v1 = acc[4 * j + 2 * h + 1] * s1;
      __nv_bfloat16* o = a.out + (long long)row * a.f + col;
      if (pairs && col + 1 < a.f) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < a.f) o[0] = __float2bfloat16_rn(v0);
        if (col + 1 < a.f) o[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int WG>
cudaError_t launch_gemm(const Args& a, cudaStream_t s) {
  using T = GemmTile<WG>;
  CUtensorMap x_map, w_map;
  cudaError_t e = tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a.m, a.d, T::kBM,
                             kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.w, a.f, a.d, kBN, kBK,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(int8_gemm_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (e != cudaSuccess) return e;
  // consecutive blocks walk m first, so a wave shares few weight tiles and
  // each weight tile is read from HBM about once
  const dim3 grid((a.m + T::kBM - 1) / T::kBM, (a.f + kBN - 1) / kBN);
  int8_gemm_kernel<WG><<<grid, T::kThreads, T::kSmem, s>>>(x_map, w_map, a);
  return cudaGetLastError();
}

}  // namespace

// The m at and below which lwm_int8_matmul runs the decode GEMV (the
// wrapper reads it to count the GEMM's launches apart).
extern "C" int lwm_int8_gemv_max_m() { return kGemvMaxM; }

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
  if (m <= 8) return gemv<1>(a, s);
  if (m <= kGemvMaxM) return gemv<2>(a, s);
  // the tallest tile (the least convert per product) whose grid still covers
  // half the card
  const int sms = sm_count(), cols = (f + kBN - 1) / kBN;
  if (2 * ((m + 255) / 256) * cols >= sms) return launch_gemm<4>(a, s);
  if (2 * ((m + 127) / 128) * cols >= sms) return launch_gemm<2>(a, s);
  return launch_gemm<1>(a, s);
}
