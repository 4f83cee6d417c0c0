// K6: W8A8 int8 matmul for Hopper (sm_90a):
//   out[m, f] = bf16((float(Σ_d x_q[m, d] · w[f, d]) · x_scale[m]) · w_scale[f])
//
// Replaces the TPU kernel `_w8a8_matmul_kernel` (lwm_tpu/ops/quant.py:182-202,
// reached through w8a8_matmul_pallas :205-244). Same contract and order: int8
// x_q [m, d] with an fp32 per-row scale [m, 1] (the activations, quantized per
// row outside the kernel); int8 w [f, d] (torch's [out, in] layout) with an
// fp32 per-output-channel scale [f]. Products are summed exactly in int32
// (d·127² < 2³¹) on the tensor cores; the epilogue is JAX's
// `acc.astype(f32) * x_scale * w_scale`, in that order, rounded to bf16 once,
// so the result is bit-identical to the plain twin.
//
// What bounds it on the card, and the two designs:
// - Decode (m ≤ kGemvMaxM, the ring of gemv.cuh with `W8a8Gemv`): 2·m ops
//   per weight byte, far below the ridge (1,979 TOP/s over 3.35 TB/s), so
//   the int8 weight stream from HBM bounds it (w1 at 4096 → 11008: at least
//   13.5 µs). K5's design without its convert: an s8 `mma` takes the
//   weight's bytes as they land, so the stream alone sets the time (a copy
//   whose consumers only wait and release ran within 1-3% of the kernel;
//   the consumers without the stream took a quarter to a half of it).
//   K6's part of the shared design:
//   * x_q comes through the ring as one box [8·NT, 128] int8 a stage; it
//     costs nothing measurable (a copy without it ran as fast). Zeros past
//     m or d add nothing to an integer sum.
//   * A consumer warp reads its chunks and issues `mma.sync` m16n8k32 s8 ·
//     s8 → s32 straight from them: each 16-byte chunk is
//     its A (or B) fragments of two steps (bytes 0-3 of a step's 8 stand
//     for logical k 4t..4t + 3, bytes 4-7 for 16 + 4t..). One team a row
//     tile was 3-6% slower at f 4096.
//   * The split and the ring (`gemv`), measured for K6 rather than taken
//     from K5: at f 4096 a deep ring on one block an SM beat any split, so
//     d is split over a cluster of 2 only where the split grid keeps one
//     block an SM (f ≤ 2112) and each block keeps at least 2048 of d. The
//     partials are int32, exact in any order: the split keeps the result
//     bit-identical.
// - Admission (m > kGemvMaxM, `w8a8_gemm_kernel`): above the ridge, so the
//   int8 tensor-core rate bounds it (w1 at m 2048: at least 0.093 ms at 1,979
//   TOP/s), and on Hopper only `wgmma` reaches it. x_q [m, d] and w [f, d]
//   are both K-major as stored, which is what an 8-bit `wgmma` takes (it has
//   no transpose), so the bytes go from TMA to the tensor cores untouched:
//   * Each block owns a BM × 128 output tile and walks d in k tiles of 128
//     bytes through a ring of stages in dynamic shared memory. A stage holds
//     x_q [BM, 128] and w [128, 128], each 128-byte-swizzled as TMA writes it
//     (16-byte chunk c of row r at chunk c ^ (r % 8)), the layout `wgmma`
//     reads without bank conflicts.
//   * Warp specialisation: a producer warp after the consumer warpgroups.
//     Its first thread issues both TMA loads of a stage (completion counted
//     in bytes on the stage's `full` mbarrier) as soon as the stage is free;
//     its other 31 stage the block's x and w scales in shared memory. Each
//     consumer warpgroup (64 rows) waits on `full`, issues four m64n128k32
//     `wgmma`s (s8 · s8 → s32 in registers) and commits them, and frees the
//     previous tile's stage on its `empty` mbarrier once that tile's group
//     has completed: one group stays in flight while the next is issued.
//   * The epilogue is the decode kernel's arithmetic (`dequant`, one
//     rounding), written into the freed ring (swizzled, no bank conflicts)
//     and read back so that each warp stores whole 256-byte output rows: a
//     direct store of the accumulator fragments (16-byte pieces of 8 rows
//     per instruction) took 1.2-1.3× as long at m 2048 (PERF.md).
//   * Tile pick: the tallest BM of 256 / 128 / 64 whose grid still covers
//     half the SMs, as K5's GEMM; 256-row tiles share each weight tile among
//     the most rows. Blocks walk m first, so each weight tile comes from HBM
//     about once. BN 256 (one warpgroup's accumulators doubled) measured
//     slower than BM 256 at every shape but one.
// Ragged m, f and d edges are zero-filled at the loads (TMA fills out-of-
// bounds boxes with zeros, which add nothing to an integer sum) and masked at
// the stores (whole 16-byte chunks where f % 8 == 0, else element by
// element); d is a multiple of 16 (16-byte rows and TMA strides; the wrapper
// checks).

#include "gemv.cuh"

namespace {

using namespace lwm;

constexpr int kGemvMaxM = 16;  // m ≤ this: the decode GEMV; above: the GEMM
constexpr int kBN = 128;       // admission GEMM: output channels per block
constexpr int kBK = 128;       // and its k tile: one 128-byte swizzled int8 row

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

// the epilogue in JAX's order: (float(acc) · row scale) · column scale
__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

// ----------------------------------------------------------------- decode

// K6's part of the decode GEMV (gemv.cuh): x_q as one [8·NT, 128] int8 box a
// stage, s8 products straight from the stage, int32 sums
struct W8a8Gemv {
  using Args = ::Args;
  using Acc = int;
  static constexpr int kXBoxes = 1;

  static cudaError_t x_map(CUtensorMap* map, const Args& a, int box_rows) {
    return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.xq, a.m, a.d, box_rows, kGemvK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  }

  // Lane (g, t) reads the weight chunks of gemv_weight_offsets and the same
  // two chunks of token 8·nt + g's row: all rows are swizzled by g, so the
  // 8 lanes of a load hit 8 different chunks.
  template <int NT>
  struct Consumer {
    int w_off[2][2], x_off[NT][2];

    __device__ Consumer(int tile, int lane) {
      gemv_weight_offsets(tile, lane, w_off);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          x_off[nt][q] = kGemvWBox + (8 * nt + (lane >> 2)) * kGemvK + gemv_chunk(lane, q);
    }

    __device__ void step(const uint8_t* st, int (&acc)[kGemvChains][NT][4]) const {
      uint4 wv[2][2], xv[NT][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        wv[0][q] = *reinterpret_cast<const uint4*>(st + w_off[0][q]);
        wv[1][q] = *reinterpret_cast<const uint4*>(st + w_off[1][q]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          xv[nt][q] = *reinterpret_cast<const uint4*>(st + x_off[nt][q]);
      }
      // step j: words 2(j % 2), 2(j % 2) + 1 of chunk j / 2 hold the same
      // eight k in both operands, logical 4t..4t + 3 and 16 + 4t..16 + 4t + 3
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = j >> 1, e = 2 * (j & 1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8_16832(acc[j % kGemvChains][nt], word(wv[0][q], e), word(wv[1][q], e),
                       word(wv[0][q], e + 1), word(wv[1][q], e + 1), word(xv[nt][q], e),
                       word(xv[nt][q], e + 1));
      }
    }
  };

  __device__ static __nv_bfloat16 out(const Args& a, int acc, int row, int tok) {
    return __float2bfloat16_rn(dequant(acc, a.xs[tok], a.ws[row]));
  }
};

// The grid and the ring, measured for K6. d is split over a cluster of 2
// where the split grid still gives each SM at most one block and each block
// keeps at least 2048 of d: the 1b preset's w2 (5504 → 2048), not its wq
// (2048 → 2048), nor anything at f 4096. The ring has 16 stages up to one
// block an SM, 8 up to two, 4 above: a deeper ring keeps more of the stream
// in flight, a shallower one leaves room for more blocks.
template <int NT>
cudaError_t gemv(const Args& a, cudaStream_t s) {
  const int tiles = (a.f + kGemvRows - 1) / kGemvRows, sms = sm_count();
  if (2 * tiles <= sms && a.d >= 4096) return launch_gemv<W8a8Gemv, NT, 2, 16>(a, s);
  if (tiles <= sms) return launch_gemv<W8a8Gemv, NT, 1, 16>(a, s);
  if (tiles <= 2 * sms) return launch_gemv<W8a8Gemv, NT, 1, 8>(a, s);
  return launch_gemv<W8a8Gemv, NT, 1, 4>(a, s);
}

// -------------------------------------------------------------- admission

template <int WG>  // WG consumer warpgroups: BM = 64·WG rows of x_q per block
struct GemmTile {
  static constexpr int kBM = 64 * WG;
  static constexpr int kThreads = 128 * WG + 32;         // + the producer warp
  static constexpr int kX = kBM * kBK;                   // x_q tile, int8, swizzled (TMA)
  static constexpr int kStage = kX + kBN * kBK;          // + the w tile, the same
  static constexpr int kFit = (232448 - 4096) / kStage;  // 227 KB less alignment, barriers, scales
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmem = kStages * kStage + 4096;
};

template <int WG>
__global__ void __launch_bounds__(GemmTile<WG>::kThreads, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map, const Args a) {
  using T = GemmTile<WG>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage s at base + s·kStage, 1024-aligned
  uint8_t* smem = smem_raw + (base - raw);
  // per stage: `full` (the TMA bytes of both tiles), `empty` (every consumer
  // warp is done with it)
  const uint32_t bars = base + S * T::kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t scaled = bars + 16 * S;  // the scales below are in shared memory
  // x_scale[m0 .. m0 + BM), then w_scale[n0 .. n0 + 128), zero past m and f
  float* scales = reinterpret_cast<float*>(smem + S * T::kStage + 256);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * T::kBM, n0 = blockIdx.y * kBN;
  const int nk = (a.d + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * WG);
    }
    mbar_init(scaled, 31);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * WG) {  // the producer warp: TMA from its first thread, scales from the rest
    const int lane = tid & 31;
    if (lane == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty(s), (t / S + 1) & 1);  // tile t - S is consumed
        const uint32_t st = base + s * T::kStage;
        mbar_expect_tx(full(s), T::kStage);
        tma_load(st, &x_map, full(s), t * kBK, m0);
        tma_load(st + T::kX, &w_map, full(s), t * kBK, n0);
      }
    } else {
      for (int i = lane - 1; i < T::kBM + kBN; i += 31) {
        const bool is_x = i < T::kBM;
        const int r = is_x ? m0 + i : n0 + i - T::kBM;
        scales[i] = r < (is_x ? a.m : a.f) ? (is_x ? a.xs[r] : a.ws[r]) : 0.f;
      }
      mbar_arrive(scaled);
    }
    return;
  }

  // consumer warpgroups: wgmma only
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  int acc[kBN / 2];
  for (int t = 0; t < nk; ++t) {
    const int s = t % S;
    mbar_wait(full(s), (t / S) & 1);
    const uint32_t st = base + s * T::kStage;
    const uint64_t da = smem_desc(st + wg * 64 * kBK), db = smem_desc(st + T::kX);
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int k = 0; k < kBK / 32; ++k) wgmma_s8(acc, da + 2 * k, db + 2 * k, t > 0 || k > 0);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // tile t - 1's group is done: its stage is free
    if (t > 0 && lane == 0) mbar_arrive(empty((t - 1) % S));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (nk == 0)
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;

  // The epilogue: (float(acc) · x_scale) · w_scale rounded to bf16 once,
  // staged in shared memory so that each warp stores whole 256-byte rows.
  // The ring is free once every consumer warpgroup is past its loop; this
  // warpgroup's 64 × 128 tile takes 16 KB of it as two 64-column halves of
  // 64 rows × 128 bytes, 16-byte chunk c of row r at chunk c ^ (r % 8).
  bar_sync(1, 128 * WG);
  uint8_t* tile = smem + wg * 64 * 2 * kBN;
  mbar_wait(scaled, 0);
  // accumulator i of a thread: row 16·warp + lane/4 + 8·((i/2)%2) of the
  // warpgroup's 64, column 8·(i/4) + 2·(lane%4) + i%2
  const int r0 = warp * 16 + (lane >> 2);
  const float sx[2] = {scales[wg * 64 + r0], scales[wg * 64 + r0 + 8]};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float sw0 = scales[T::kBM + c], sw1 = scales[T::kBM + c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      *reinterpret_cast<uint32_t*>(tile + (j >> 3) * 64 * 128 + r * 128 +
                                   (((j & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) =
          pack_bf16(dequant(acc[4 * j + 2 * h], sx[h], sw0),
                    dequant(acc[4 * j + 2 * h + 1], sx[h], sw1));
    }
  }
  bar_sync(2 + wg, 128);
  // thread i of the warpgroup: chunk i % 16 (8 columns) of rows i / 16 + 8k
  const int c = tid & 15, col = n0 + 8 * c;
  const bool whole = (a.f & 7) == 0;  // 16-byte rows: a chunk is all in or all out
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = ((tid & 127) >> 4) + 8 * k, row = m0 + wg * 64 + r;
    if (row >= a.m) break;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + (c >> 3) * 64 * 128 + r * 128 +
                                                    (((c & 7) ^ (r & 7)) << 4));
    __nv_bfloat16* o = a.out + (long long)row * a.f + col;
    if (whole) {
      if (col < a.f) *reinterpret_cast<uint4*>(o) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (col + q < a.f) o[q] = e[q];
    }
  }
}

template <int WG>
cudaError_t launch_gemm(const Args& a, cudaStream_t s) {
  using T = GemmTile<WG>;
  static const cudaError_t set = cudaFuncSetAttribute(
      w8a8_gemm_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  CUtensorMap x_map, w_map;
  cudaError_t e = set;
  if (e == cudaSuccess)
    e = tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.xq, a.m, a.d, T::kBM, kBK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.w, a.f, a.d, kBN, kBK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  // consecutive blocks walk m first, so a wave shares few weight tiles and
  // each weight tile is read from HBM about once
  const dim3 grid((a.m + T::kBM - 1) / T::kBM, (a.f + kBN - 1) / kBN);
  w8a8_gemm_kernel<WG><<<grid, T::kThreads, T::kSmem, s>>>(x_map, w_map, a);
  return cudaGetLastError();
}

}  // namespace

// The m at and below which lwm_w8a8_matmul runs the decode GEMV (the
// wrapper reads it to count the GEMM's launches apart).
extern "C" int lwm_w8a8_gemv_max_m() { return kGemvMaxM; }

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
  if (m <= 8) return gemv<1>(a, s);
  if (m <= kGemvMaxM) return gemv<2>(a, s);
  // the tallest tile (the most products per byte loaded) whose grid still
  // covers half the card
  const int sms = sm_count(), cols = (f + kBN - 1) / kBN;
  if (2 * ((m + 255) / 256) * cols >= sms) return launch_gemm<4>(a, s);
  if (2 * ((m + 127) / 128) * cols >= sms) return launch_gemm<2>(a, s);
  return launch_gemm<1>(a, s);
}
