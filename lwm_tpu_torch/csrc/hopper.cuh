// Building blocks shared by the port's Hopper (sm_90a) kernels: K1's
// forward (flash_fwd.cu), the fused flash backward (flash_bwd.cu), K4's
// decode (flash_decode.cu), K5 (int8_matmul.cu) and K6 (w8a8_matmul.cu),
// each of the last two a decode GEMV and an admission GEMM.
//
// Shared-memory tiles. A tile of R rows × D bf16 is D / 64 column halves of
// R rows × 128 bytes, each row's eight 16-byte chunks swizzled (chunk c of
// row r at c ^ (r % 8)): the layout `wgmma` reads without bank conflicts,
// K-major or N-major alike. Tiles start 1024-aligned.
//
// Accumulator element i of an m64nN `wgmma` tile (fp32 or int32), in a
// thread of warp w (of its warpgroup), lane (g8, t4) = (lane / 4, lane % 4):
// row 16·w + g8 + 8·((i / 2) % 2), column 8·(i / 4) + 2·t4 + i % 2. Elements
// 8j .. 8j + 7, packed in pairs, are the A fragments (a0 .. a3) of k chunk j
// of a product that takes the accumulator as its register A operand.

#pragma once

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lwm {

constexpr float kBigNeg = -1e30f;     // a masked logit
constexpr float kMaskGuard = -1e29f;  // logits at or below count as masked: p = 0
constexpr float kLog2e = 1.4426950408889634f;

// floor(a / b) and ceil(a / b) for b > 0 and a of either sign
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}
__device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

// Causal attention by global position, queries at q_offset + i·stride and
// keys at kv_offset + j·stride (stride > 1: the striped sequence layout).
// The keys [0, n) that the row at position `pos` sees, n in [0, skv]
__device__ __forceinline__ int causal_keys(int pos, int kv_offset, int stride, int skv) {
  return max(0, min(skv, floor_div(pos - kv_offset, stride) + 1));
}
// The first query row that sees the key at position `kpos`
__device__ __forceinline__ int first_query(int kpos, int q_offset, int stride) {
  return max(0, ceil_div(kpos - q_offset, stride));
}

// byte offset of element (r, c) of an R-row swizzled tile
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * R * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// 2^x by the SFU (ex2.approx: ~2 ulp, subnormal results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// an N-byte copy (4, 8 or 16), src_bytes of it read and the rest zero-filled
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (N == 16) {
    cp_async16(dst, src, src_bytes);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
                 "r"(src_bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// wait until at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) → visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ROWS × D tile of bf16 into its swizzled slot by THREADS threads, 16 bytes
// per thread per step; rows at or past `rows_valid` are zero-filled so
// masked rows never carry garbage into a product (0 · NaN would poison it)
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long row_stride, int rows_valid, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "whole steps of 16 bytes a thread");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r < rows_valid;
    cp_async16(dst + swz<ROWS>(r, c), src + (in ? r * row_stride + c : 0), in ? 16 : 0);
  }
}

// Head dims other than 64 and 128 (d ≤ 128, d % 4 == 0: 32, 80, 100, ..)
// run on the tiles of the next of those, D, in the same layout: columns at
// or past d are zero in shared memory, so that a product over D adds
// nothing past d, and nothing past d is stored. Such a row is 8-byte
// aligned in bf16 at best (a head of 100 is 200 bytes), so it is copied 8
// bytes at a time.
//
// load_tile for rows of d ≤ D bf16: 8 bytes per thread per step, columns
// at or past d and rows at or past `rows_valid` zero-filled. A thread keeps
// one column and steps over rows a multiple of 8 apart, so its swizzled
// offset moves by whole 1024-byte row groups: one add a copy, few registers
// (the kernels that call it hold ~160 live accumulator registers)
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_cols(uint32_t dst, const __nv_bfloat16* src,
                                               long long row_stride, int rows_valid, int d,
                                               int tid) {
  constexpr int kChunks = D / 4;                 // 8-byte chunks of a row
  constexpr int kRowStep = THREADS / kChunks;    // rows apart of a thread's copies
  static_assert(THREADS % kChunks == 0 && kRowStep % 8 == 0 && ROWS % kRowStep == 0,
                "whole steps of 8 bytes a thread, rows a multiple of 8 apart");
  const int r0 = tid / kChunks, c = (tid % kChunks) * 4;
  const bool col_in = c < d;
  const uint32_t dst0 = dst + swz<ROWS>(r0, c);
  const __nv_bfloat16* src0 = src + c;
#pragma unroll
  for (int j = 0; j < ROWS / kRowStep; ++j) {
    const int r = r0 + j * kRowStep;
    const bool in = col_in && r < rows_valid;
    cp_async<8>(dst0 + j * kRowStep * 128, in ? src0 + r * row_stride : src, in ? 8 : 0);
  }
}

// load_tile_cols for a head dim d other than D (kCols), else load_tile
template <int D, int ROWS, int THREADS, bool kCols>
__device__ __forceinline__ void load_tile_d(uint32_t dst, const __nv_bfloat16* src,
                                            long long row_stride, int rows_valid, int d,
                                            int tid) {
  if constexpr (kCols)
    load_tile_cols<D, ROWS, THREADS>(dst, src, row_stride, rows_valid, d, tid);
  else
    load_tile<D, ROWS, THREADS>(dst, src, row_stride, rows_valid, tid);
}

// The tile width that runs head dim d, as a launch's template arguments:
// 64 and 128 on their own tiles (kCols false), any other d ≤ 128 with
// d % 4 == 0 on the next of them (kCols true); any other d is refused.
// `launch(D, kCols)` gets both as std::integral_constant values.
// (ops/flash.py tile_dim is the same rule.)
template <typename Launch>
cudaError_t launch_head_dim(int d, Launch&& launch) {
  using std::false_type, std::true_type;
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (d == 64) return launch(D64{}, false_type{});
  if (d == 128) return launch(D128{}, false_type{});
  if (d <= 0 || d > 128 || d % 4) return cudaErrorInvalidValue;
  return d < 64 ? launch(D64{}, true_type{}) : launch(D128{}, true_type{});
}

// ------------------------------------------------------------------ wgmma

// shared-memory descriptor of a 128-byte-swizzled tile whose 8-row groups
// are 1024 bytes apart. K-major (rows are M or N, 64 k per row): the
// stride is SBO, LBO is unused; adding 2 moves the start 32 bytes (k 16).
// N-major (rows are k, 64 of M or N per row, one 64-wide atom): the 8-row
// groups are again SBO apart; LBO (the next 64-wide atom) is never used at
// M, N = 64, and is set to the same stride. 16 k rows are 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define LWM_ACC32                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define LWM_REGS32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 × 64] (+)= A (64 × 16) · B (16 × 64), both from shared memory; TA /
// TB: the operand is M- / N-major. scale_d 0 ignores d's old value.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LWM_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : LWM_ACC32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 × 64] (+)= A (64 × 16, four bf16x2 fragments a) · B (16 × 64, N-major
// in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LWM_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : LWM_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#define LWM_ACC64                                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),                \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),             \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),             \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),             \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),             \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),             \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),             \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),             \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),             \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define LWM_REGS64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "      \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "       \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "       \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 × 128] (+)= A (64 × 16) · B (16 × 128), both K-major in shared
// memory; scale_d 0 ignores d's old value
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LWM_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : LWM_ACC64
      : "l"(da), "l"(db), "r"(scale_d));
}

#define LWM_IACC64                                                                             \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),          \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),  \
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),            \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),            \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),            \
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),            \
      "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),            \
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),            \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),            \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),            \
      "+r"(d[62]), "+r"(d[63])
// d[64 × 128] (+)= A (64 × 32) · B (32 × 128), int8 × int8 summed exactly
// in int32, both K-major in shared memory (an 8-bit `wgmma` takes no
// transpose). 32 int8 k values are 32 bytes, so the descriptors step as for
// 16 bf16 ones. scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " LWM_REGS64 ", %64, %65, p;\n}\n"
      : LWM_IACC64
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }
// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// two floats → packed bf16x2, the lower index in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// four int8 (one little-endian word) → four floats, byte i in f[i]. q + 128
// is placed in the low mantissa bits of 2^23, so one byte permute and one
// subtraction give q exactly, with no int→float conversion instruction (a
// quarter-rate one on the card).
__device__ __forceinline__ void i8x4_to_f32(uint32_t q4, float (&f)[4]) {
  const uint32_t u = q4 ^ 0x80808080u;
  const float bias = 8388736.f;  // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - bias;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - bias;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - bias;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - bias;
}

// ------------------------------------------------------ mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// named barrier `id` (1..15) over `threads` threads (a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// arrive on the mbarrier at shared::cluster address `bar` (another block's),
// releasing this thread's writes at cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spin until phase `parity` of a barrier arrived at from other blocks has
// completed (acquire at cluster scope)
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (column c0, row c1) of a 2-D `map` into shared memory,
// completion (bytes) reported to `bar`; out-of-bounds elements arrive as
// zeros and count as bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same, with an L2 cache policy (`l2_evict_first`) for the box's lines
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

// an L2 policy under which the lines a load brings in are the first to be
// evicted: for a stream read once, such as a decode GEMV's weight
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// (no -lcuda); null where it is missing
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

// the card's SM count, read once
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// a row-major [rows, cols] tensor cut into [box_rows, box_cols] boxes
inline cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                              const void* ptr, int rows, int cols, int box_rows, int box_cols,
                              CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace lwm
