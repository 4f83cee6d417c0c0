// The decode GEMV's weight stream, shared by K5 (int8_matmul.cu, W8A16) and
// K6 (w8a8_matmul.cu, W8A8): out[m, f] for m ≤ 16 tokens against an int8
// weight [f, d]. At 2·m operations a weight byte the int8 stream from HBM
// bounds it; this is the pipeline that keeps that stream in flight, and
// each kernel brings only its inner step, its epilogue and its pick of the
// split and the ring (an `Op`, below).
//
// * A block owns 32 output channels (kGemvRows) and a range of d. One
//   producer thread walks the range in pieces of 128 k and has TMA copy each
//   into a ring of S stages in dynamic shared memory: the weight box [32,
//   128] int8, then the tokens' Op::kXBoxes boxes [8·NT, 128 / kXBoxes] (128
//   bytes a row), all 128-byte-swizzled (16-byte chunk c of row r at
//   c ^ (r % 8)), completion counted in bytes on the stage's `full`
//   mbarrier. Boxes past f, m or d arrive as zeros, so nothing is masked
//   before the store. The weight's boxes carry an L2 evict-first policy: it
//   is read once, and the hint took 2-8% off every decode shape of both
//   kernels. 1-D bulk copies of weight row slices cost the issuing warp ~80
//   cycles each whatever their size.
// * Consumer warps: two row tiles of 16 output channels, each taken by
//   kGemvTeams teams, team e on the stages p ≡ e (mod kGemvTeams). A warp
//   waits on `full`, runs Op's step on the stage (`mma.sync` with the weight
//   as A, 16 channels, and the ≤ 16 tokens as B, 8 a column tile) into
//   kGemvChains accumulator sets, and releases the stage on `empty` after
//   the step (released as soon as it was in registers, K5's 4-stage ring
//   ran 1.2x slower and K6 no faster). Teams must divide the ring's stages,
//   else a warp passes a parity wait a phase early.
// * The weight's k permutation: lane (g, t) = (lane / 4, lane % 4) takes the
//   32 k at 32t of each 128, 16-byte chunks 2t and 2t + 1 of rows g and
//   g + 8 (`gemv_weight_offsets`); lanes with t ≥ 2 walk the two in the
//   other order, so that with the swizzle the 8 lanes of every 16-byte
//   shared load hit 8 different chunks (no bank conflicts). Op's step reads
//   the tokens' bytes for the same k, so the sum does not see the order.
// * d split over the CS blocks of a thread-block cluster, where f's tiles
//   leave SMs without a block: the other blocks store their partials into
//   rank 0's shared memory and arrive on its `done` mbarrier (release at
//   cluster scope), then leave; rank 0 sums in rank order, so K5's fp32 sum
//   is deterministic and K6's int32 sum exact, applies Op's epilogue once
//   and stores. One launch, no scratch in HBM, no atomics; the cluster
//   barrier only tells the blocks that rank 0 has started, and is waited on
//   at the end. Two `cluster.sync`s and reads of the other blocks' shared
//   memory cost ~1.5 µs a call instead.
//
// An Op provides: `Args` (with w, out, m, f, d), `Acc` (float or int), the
// x boxes a stage (`kXBoxes`), `x_map(map, a, box_rows)`, `Consumer<NT>`
// built from (tile, lane) with `step(stage, acc)`, and `out(a, acc, row,
// token)`, the bf16 value stored.

#pragma once

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace lwm {

constexpr int kGemvTiles = 2;                        // row tiles of 16 output channels a block
constexpr int kGemvRows = 16 * kGemvTiles;           // output channels a block
constexpr int kGemvTeams = 2;                        // consumer warps a row tile
constexpr int kGemvWarps = kGemvTiles * kGemvTeams;  // consumer warps
constexpr int kGemvThreads = 32 * (kGemvWarps + 1);  // + the producer warp
constexpr int kGemvK = 128;                          // k a stage: one swizzled weight row
constexpr int kGemvChains = 2;  // accumulator sets a consumer thread alternates
constexpr int kGemvWBox = kGemvRows * kGemvK;  // the weight box's bytes, at the stage's start

// the bytes of one of the tokens' boxes: 8·NT rows of 128
template <int NT>
constexpr int kGemvXBox = 8 * NT * 128;

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// the byte offset, in a 128-byte row swizzled by g = lane / 4, of lane (g,
// t)'s chunk q (k 32t + 16q .. + 15 in the other order for t ≥ 2)
__device__ __forceinline__ int gemv_chunk(int lane, int q) {
  const int g = lane >> 2, t = lane & 3;
  return ((2 * t + (q ^ (t >> 1))) ^ g) << 4;
}

// the stage offsets of lane (g, t)'s weight chunks in row tile `tile`:
// [row g, g + 8][chunk q]
__device__ __forceinline__ void gemv_weight_offsets(int tile, int lane, int (&off)[2][2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    off[0][q] = (16 * tile + (lane >> 2)) * kGemvK + gemv_chunk(lane, q);
    off[1][q] = off[0][q] + 8 * kGemvK;  // row g + 8: the same swizzle
  }
}

// NT token tiles of 8 (m ≤ 8·NT); CS blocks of a cluster split d; S stages
template <class Op, int NT, int CS, int S>
struct GemvTile {
  // team e takes the stages p ≡ e (mod kGemvTeams); each stage serves one
  // team, so no team waits on a phase of the ring two ahead of its own
  static_assert(S % kGemvTeams == 0, "whole rounds of the ring a team");
  static_assert(sizeof(typename Op::Acc) == 4, "fp32 or int32 partials");
  static constexpr int kStage = kGemvWBox + Op::kXBoxes * kGemvXBox<NT>;  // 1024-aligned
  static constexpr int kOut = kGemvTiles * NT * 128;  // accumulator elements a block
  // partials: the other teams', then the other blocks'
  static constexpr int kRed = (kGemvTeams - 1 + CS - 1) * kOut * 4;
  // + 1024 to align; barriers: full and empty a stage, and `done`
  static constexpr int kSmem = 1024 + S * kStage + kRed + 8 * (2 * S + 1);
};

template <class Op, int NT, int CS, int S>
__global__ void __launch_bounds__(kGemvThreads)
    gemv_kernel(const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap x_map, const typename Op::Args a) {
  namespace cg = cooperative_groups;
  using T = GemvTile<Op, NT, CS, S>;
  using Acc = typename Op::Acc;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage s at base + s·kStage
  uint8_t* smem = smem_raw + (base - raw);
  Acc* red = reinterpret_cast<Acc*>(smem + S * T::kStage);
  // per stage: `full` (the TMA bytes landed), `empty` (every consumer warp is
  // done with it); `done`: every thread of the other blocks stored its partials
  const uint32_t bars = base + S * T::kStage + T::kRed;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t done = bars + 16 * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = CS > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int f0 = blockIdx.x / CS * kGemvRows;  // a cluster is CS consecutive blocks
  // this block's k: a CS-th of d in whole stages
  const int span = ((a.d + CS - 1) / CS + kGemvK - 1) / kGemvK * kGemvK;
  const int k_begin = min(a.d, rank * span), k_end = min(a.d, k_begin + span);
  const int n_pieces = (k_end - k_begin + kGemvK - 1) / kGemvK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kGemvTiles);
    }
    if (CS > 1) mbar_init(done, (CS - 1) * 32 * kGemvTiles);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every block of the cluster has started (and initialised `done`) by the
  // time this phase completes; waited on only before the partials move
  if constexpr (CS > 1) asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");

  if (warp == kGemvWarps) {  // producer: one thread, 1 + kXBoxes TMA boxes a stage
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&w_map) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&x_map) : "memory");
      const uint64_t stream = l2_evict_first();  // the weight is read once
      for (int p = 0; p < n_pieces; ++p) {
        const int s = p % S;
        if (p >= S) mbar_wait(empty(s), (p / S + 1) & 1);
        const int k0 = k_begin + p * kGemvK;
        const uint32_t st = base + s * T::kStage;
        // boxes past f, m or d arrive as zeros and count as bytes
        mbar_expect_tx(full(s), T::kStage);
        tma_load(st, &w_map, full(s), k0, f0, stream);
#pragma unroll
        for (int i = 0; i < Op::kXBoxes; ++i)
          tma_load(st + kGemvWBox + i * kGemvXBox<NT>, &x_map, full(s),
                   k0 + i * (kGemvK / Op::kXBoxes), 0);
      }
    }
    if constexpr (CS > 1) asm volatile("barrier.cluster.wait;\n" ::: "memory");
    return;
  }

  // consumers: warp w owns output channels f0 + 16·tile .. + 15 (tile =
  // w % kGemvTiles) and the stages p ≡ w / kGemvTiles (mod kGemvTeams)
  const int tile = warp % kGemvTiles, team = warp / kGemvTiles;
  const typename Op::template Consumer<NT> consumer(tile, lane);
  Acc acc[kGemvChains][NT][4];
#pragma unroll
  for (int c = 0; c < kGemvChains; ++c)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][nt][r] = 0;
  for (int p = team; p < n_pieces; p += kGemvTeams) {
    const int s = p % S;
    mbar_wait(full(s), (p / S) & 1);
    consumer.step(smem + s * T::kStage, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
#pragma unroll
  for (int c = 1; c < kGemvChains; ++c)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[0][nt][r] += acc[c][nt][r];

  // accumulator (nt, r) of lane (g, t): output channel f0 + 16·tile + g +
  // 8·(r / 2), token 8·nt + 2·t + r % 2; element at(nt, r) of a partials slot
  auto at = [&](int nt, int r) { return tile * NT * 128 + (nt * 4 + r) * 32 + lane; };
  // the teams' partials meet in team 0 (slots 0 .. kGemvTeams - 2)
  if (team > 0)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) red[(team - 1) * T::kOut + at(nt, r)] = acc[0][nt][r];
  bar_sync(1, 32 * kGemvWarps);
  if (team > 0) {
    if constexpr (CS > 1) asm volatile("barrier.cluster.wait;\n" ::: "memory");
    return;
  }
#pragma unroll
  for (int e = 1; e < kGemvTeams; ++e)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[0][nt][r] += red[(e - 1) * T::kOut + at(nt, r)];
  if constexpr (CS > 1) {
    // the other blocks store their partials into rank 0's slots (after the
    // teams') and leave; rank 0 waits for them and sums in rank order
    Acc* peers = red + (kGemvTeams - 1) * T::kOut;
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
    if (rank > 0) {
      Acc* dst = cg::this_cluster().map_shared_rank(peers, 0) + (rank - 1) * T::kOut;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) dst[at(nt, r)] = acc[0][nt][r];
      uint32_t done0;  // rank 0's `done`
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(done0) : "r"(done), "r"(0));
      mbar_arrive_cluster(done0);
      return;
    }
    mbar_wait_cluster(done, 0);
#pragma unroll
    for (int q = 1; q < CS; ++q)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[0][nt][r] += peers[(q - 1) * T::kOut + at(nt, r)];
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = f0 + 16 * tile + g + 8 * (r >> 1), tok = 8 * nt + 2 * t + (r & 1);
      if (row < a.f && tok < a.m)
        a.out[(long long)tok * a.f + row] = Op::out(a, acc[0][nt][r], row, tok);
    }
}

// one launch of the GEMV with CS blocks a cluster and S stages; the
// shared-memory size is set once per instantiation, the tensor maps are
// encoded every call (a cache of them did not lower a call's host cost)
template <class Op, int NT, int CS, int S>
cudaError_t launch_gemv(const typename Op::Args& a, cudaStream_t s) {
  using T = GemvTile<Op, NT, CS, S>;
  static const cudaError_t set = cudaFuncSetAttribute(
      gemv_kernel<Op, NT, CS, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  CUtensorMap w_map, x_map;
  cudaError_t e = set;
  if (e == cudaSuccess)
    e = tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.w, a.f, a.d, kGemvRows, kGemvK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess) e = Op::x_map(&x_map, a, 8 * NT);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CS;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS * ((a.f + kGemvRows - 1) / kGemvRows));
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = s;
  cfg.attrs = cluster;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, gemv_kernel<Op, NT, CS, S>, w_map, x_map, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace lwm
