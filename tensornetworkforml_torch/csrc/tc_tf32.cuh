// The one-pass TF32 GEMM of K4a and K4b (polar_sketch.cu, under gramfree_split's
// reduced precisions): every product from cvt.rna-rounded TF32 operands,
// summed in float32 on Hopper's tensor cores. A kernel of its own beside the
// 3xTF32 core (tc_gemm.cuh), sharing only its helpers.
//
// One block computes a tile of
//   C (M, N) = sum_k A(m, k) B(n, k)
// over its k range: 256 x 128 for K4a, 128 x 256 for K4b (Shape). Wgmma
// reads a tf32 operand from shared memory only K-major (the PTX ISA's
// register-A form does take .tf32), so the operand whose m index is the
// contiguous one is wgmma's A, taken from registers: each consumer thread
// loads its fragment from the landed stage, rounds it (cvt.rna) and so
// transposes it in the load. B is always K-major. An output
// whose m index is the contiguous one is written transposed (OUT_T). So
//   K4a   y0^T = Omega^T B^T: A = Omega (J, q), m contiguous; B = B (I, J);
//         y0 written transposed; n2 from the squares of B's float32 values;
//   K4b   y1^T is rounded and transposed once (tf1_transpose_kernel, 2 MB at
//         M = 512), then t = B^T y1: A = B, m contiguous; B = y1^T; t written
//         transposed (t^T, q x J) and rounded to TF32 (the rounding the second
//         half would apply when it reads t), then z = B t: A = B, k contiguous;
//         B = t^T.
// Only K4a's B arrives unrounded: three converter warps round it in place in
// the landed stage (it is K-major, wgmma's layout) while the tensor cores
// work on the chunks before it. Every block that reads a B tile rounds it, so
// K4a takes the tile with the fewer columns: at M = 512 each B tile is
// rounded twice, not four times, which took 5 us off its 64.
//
// Pipeline (a block of three warpgroups, 384 threads, one block an SM):
//   warp 8       the producer: one thread keeps a ring of STAGES stages
//                filled by the TMA (A and B of one k chunk of BK = 32 each,
//                128-byte swizzled rows of 32 floats, which is wgmma's K-major
//                SW128 layout), on full/empty mbarrier pairs;
//   warps 9-11   K4a only: wait for a stage to land, add B's squares (n2),
//                round B in place, fence it for the async proxy and arrive
//                on the stage's `ready` barrier;
//   warps 0-7    two consumer warpgroups, half of the tile's rows each, in
//                blocks of 64 (one m64n256 or two m64n128 accumulators, 128
//                registers a thread; setmaxnreg moves the producer's
//                registers to them, without which ptxas serializes): wait for
//                chunk c's stage, load and round A's fragments, issue the
//                chunk's products (k steps of 8), and release the stage when
//                they are done. A warpgroup writes its next fragment only
//                after its last products finished: a fragment register
//                written while products are in flight makes ptxas serialize
//                every wgmma (its C7513 note), so the two warpgroups take
//                turns on the tensor cores instead. No block barrier sits in
//                the k loop: a conversion waits for nothing but its stage.
// The k split: the S blocks of one output tile (S from the shape alone,
// plan) pair up in thread-block clusters of 2. Each block writes its
// accumulator tile into its own shared memory; after a cluster barrier each
// adds the pair's two tiles over its half of the rows through distributed
// shared memory in split order. With S > 2 the S / 2 pairs' half tiles meet in
// global memory (S / 2 x 128 KB a tile, 8 MB for K4a at M = 512), and the
// block that arrives last at its half tile (an atomic ticket) adds them in
// pair order and writes them out. n2's per-block partial sums are added the
// same way. One launch a GEMM, no float atomics, and every sum's order is
// fixed by the shape: two launches agree bit for bit.
//
// TMA needs 16-byte row strides: an operand whose row is not a whole number
// of 16 bytes is first copied into aligned scratch (tf1_pad_kernel), so every
// shape the wrappers accept runs this kernel.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "layout.cuh"
#include "tc_gemm.cuh"  // to_tf32, smem_u32, the wgmma fences

namespace {
namespace tf1 {

constexpr int NT = 384;               // two consumer warpgroups, then the producer's
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_WARP = 8;      // its lane 0 issues the TMA copies
constexpr int CONVERTERS = 96;        // warps 9-11 (K4a: B rounded in place)
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;  // setmaxnreg: 2 x 128 x 232 + 128 x 40
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = (128 + 256) * BK * 4;  // A and B of a chunk, either shape: 48 KB
constexpr int TILE = 128 * 256;                    // floats of a block's tile, either shape
constexpr int RED = 32;               // floats of the block's flags and n2's warp sums
constexpr size_t SMEM_BYTES = 1024 + (size_t)STAGES * STAGE_BYTES + 3 * STAGES * 8 + RED * 4;

// A block's tile, 128 MW x 256 / MW: each consumer warpgroup takes MW blocks of
// 64 rows, each an m64n(256 / MW) accumulator (128 float32 registers a thread
// in all). MW = 2 halves the B tile, for K4a, whose B each block rounds.
template <int MW>
struct Shape {
  static constexpr int BM = 128 * MW, BN = 256 / MW;
  static constexpr int ACC = BN / 2;   // accumulators a thread, each 64-row block
  static constexpr int A_BYTES = BM * BK * 4, B_BYTES = BN * BK * 4;
  static constexpr int LDP_T = BM + 4;  // row stride of a transposed accumulator tile (floats)
  static constexpr int LDP_N = BN + 8;  // ... of a direct one
  static_assert(A_BYTES + B_BYTES == STAGE_BYTES, "one stage size");
  static_assert(BN * LDP_T * 4 <= STAGES * STAGE_BYTES, "tile fits the ring");
  static_assert(BM * LDP_N * 4 <= STAGES * STAGE_BYTES, "tile fits the ring");
};

// The plan: S, the k split, from {1, 2, 4, 8} with the fewest waves x chunks a
// block, counting FILL chunks of pipeline fill a block, on an H100's 132 SMs
// at one block an SM (132 blocks at once, alone or in the 66 clusters of 2
// the card holds). A fixed number, not the card's, so the sums' order
// depends on the shape alone. Splits pair up into clusters of 2; with S > 2
// the S / 2 pairs of a tile meet in global memory (its exchange), which
// needs a ticket for each half tile (MAX_TICKETS).
constexpr int SLOTS = 132;
constexpr int FILL = 8;
constexpr int MIN_CHUNKS = 4;  // of k a block, under a split
constexpr int MAX_TICKETS = 4096;

struct Gemm {
  float* out;   // C(m, n) at out[m ldo + n], or at out[n ldo + m] (OUT_T)
  int ldo;
  int M, N, K;
  int nM, nN, S, kc;  // tiles, the split, chunks of BK a split
  float* xp;          // S > 2: the pairs' half tiles, S / 2 x tiles x TILE floats
  float* n2;          // K4a: |B|_F^2, else null
  float* n2p;         // K4a: nN x S per-block partial sums
};

__host__ __device__ inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

template <int MW>
inline Gemm plan(int M, int N, int K) {
  Gemm g{};
  g.M = M;
  g.N = N;
  g.K = K;
  g.nM = cdiv(M, Shape<MW>::BM);
  g.nN = cdiv(N, Shape<MW>::BN);
  const long tiles = (long)g.nM * g.nN;
  const int chunks = cdiv(K, BK);
  long best = -1;
  for (int S = 1; S <= 8; S *= 2) {
    const int kc = cdiv(chunks, S);
    if (S > 1 && kc < MIN_CHUNKS) break;
    if (S > 2 && tiles * 2 > MAX_TICKETS) break;
    const long cost = cdiv(tiles * S, SLOTS) * (long)(kc + FILL);
    if (best < 0 || cost < best) {
      best = cost;
      g.S = S;
      g.kc = kc;
    }
  }
  return g;
}

// floats of the pairs' half tiles, 0 without an exchange
inline long exchange_floats(const Gemm& g) {
  return g.S > 2 ? (long)(g.S / 2) * g.nM * g.nN * TILE : 0L;
}

inline int round4(int n) { return (n + 3) / 4 * 4; }

// ---- device helpers --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` of the barrier at `bar` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// one box of a 2-d tensor map into shared memory at `dst`, at coordinates
// (c0 innermost, c1), reported to the barrier at `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float4 at shared address `addr` in the shared memory of cluster block `rank`
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// wgmma's descriptor of a K-major operand in 128-byte swizzled rows (the TMA's
// SWIZZLE_128B): 8-row groups 1024 bytes apart; the leading offset is unused
// when a product's k (32 bytes) lies inside the swizzle's 128-byte row
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// D (64 x 256) += A (64 x 8, tf32 in registers) B (256 x 8, tf32 in shared)^T
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 8, tf32 in registers) B (128 x 8, tf32 in shared)^T
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps a fragment's registers live (and unmoved) until the products that
// read them asynchronously have been waited for
__device__ __forceinline__ void fence_frag(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Byte offset, in a stage's A part, of A(m, k) (m < BM, k < BK).
//   K-major: BM rows m of 32 floats, 16-byte chunk (k / 4) ^ (m % 8);
//   m contiguous: BM / 32 boxes of 4 KB, 32 m each, 32 rows k of 32 floats,
//   16-byte chunk ((m % 32) / 4) ^ (k % 8).
template <bool A_KMAJOR>
__device__ __forceinline__ uint32_t a_offset(int m, int k) {
  if (A_KMAJOR) return m * 128 + ((((k >> 2) ^ m) & 7) << 4) + ((k & 3) << 2);
  return (m >> 5) * 4096 + k * 128 + (((((m >> 2) ^ k) & 7)) << 4) + ((m & 3) << 2);
}

// This thread's A fragment of a chunk's stage, rounded: k step ks in
// a[4 ks .. 4 ks + 3] as (row, k) = (r, t), (r + 8, t), (r, t + 4),
// (r + 8, t + 4) with t = lane % 4 (wgmma's tf32 A layout). off[i]: the
// offset of element i of k step 0. With m contiguous a k step is 8 rows k
// further (1 KB) and keeps every row's swizzle; K-major, it moves the 16-byte
// chunk, whose swizzle then changes.
template <bool A_KMAJOR>
__device__ __forceinline__ void load_frag(uint32_t (&a)[16], const unsigned char* stage,
                                          const uint32_t (&off)[4], int r, int t) {
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t o = A_KMAJOR ? a_offset<true>(r + 8 * (i & 1), 8 * ks + t + 4 * (i >> 1))
                                  : off[i] + 1024 * ks;
      const float v = *reinterpret_cast<const float*>(stage + o);
      a[4 * ks + i] = __float_as_uint(tc::to_tf32(v));
    }
  }
}

// a barrier of the first `count` threads' warps (id > 0: the block's own
// __syncthreads is id 0)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- the kernel ----------------------------------------------------------------

// Tickets counted by atomicInc, which wraps each back to 0 when its last
// block has counted, ready for the next launch. They are the library's, one
// set a device: the launches that use them run one after another on the
// caller's stream, as the wrappers issue them.
__device__ unsigned int n2_ticket = 0;             // K4a's blocks of n2
__device__ unsigned int tickets[MAX_TICKETS] = {};  // the half tiles of an exchange

// A_KMAJOR: A(m, k) read with k contiguous (else m); CONVERT_B: B arrives as
// float32 and is rounded in place (K4a; else it is already TF32); OUT_T: C(m, n)
// stored at out[n ldo + m]; ROUND_OUT: C rounded to TF32 as it is stored
template <int MW, bool A_KMAJOR, bool CONVERT_B, bool OUT_T, bool ROUND_OUT>
__global__ void __launch_bounds__(NT, 1)
    tf1_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                    const Gemm g) {
  using T = Shape<MW>;
  constexpr int BM = T::BM, BN = T::BN, A_BYTES = T::A_BYTES, B_BYTES = T::B_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = tc::smem_u32(smem);  // 1024-aligned, as SW128 wants
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  float* red = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES + 3 * STAGES * 8);
  auto full = [=](int s) { return bars + 8 * s; };
  auto ready = [=](int s) { return bars + 8 * (STAGES + s); };
  auto empty = [=](int s) { return bars + 8 * (2 * STAGES + s); };

  // block (tile, pair x, rank r in the cluster of C) takes split s = C x + r
  const int C = g.S > 1 ? 2 : 1, X = g.S / C;
  const int rank = blockIdx.x % C, x = (blockIdx.x / C) % X, tile = blockIdx.x / g.S;
  const int mt = tile % g.nM, nt = tile / g.nM;
  const int m0 = mt * BM, n0 = nt * BN;
  const int c0 = (x * C + rank) * g.kc;
  const int nk = max(0, min(g.kc, cdiv(g.K, BK) - c0));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), CONVERTERS);
      mbar_init(empty(s), 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The roles never meet again (setmaxnreg): the consumers write the tile and
  // run the exchange; the producer's warpgroup keeps the cluster barriers and
  // K4a's converters sum n2.
  if (warp < PRODUCER_WARP) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    float d[MW][T::ACC];
#pragma unroll
    for (int h = 0; h < MW; ++h)
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) d[h][i] = 0.f;
    // this thread's rows r0 + 64 h (+ 8) of 64-row block h
    const int r0 = (warp / 4) * 64 * MW + (warp % 4) * 16 + lane / 4, t = lane % 4;
    uint32_t af[MW][16] = {}, off[MW][4];
#pragma unroll
    for (int h = 0; h < MW; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        off[h][i] = a_offset<A_KMAJOR>(r0 + 64 * h + 8 * (i & 1), t + 4 * (i >> 1));
    auto fences = [&]() {
#pragma unroll
      for (int h = 0; h < MW; ++h) {
        fence_acc(d[h]);
        fence_frag(af[h]);
      }
    };
    for (int c = 0; c < nk; ++c) {
      // chunk c - 1's products done before chunk c's fragment is written: a
      // fragment register written while products are in flight would make
      // ptxas serialize every wgmma. The other warpgroup's products keep
      // the tensor cores busy meanwhile.
      tc::wgmma_wait<0>();
      fences();
      if (c > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty((c - 1) % STAGES));
      const int s = c % STAGES;
      mbar_wait(CONVERT_B ? ready(s) : full(s), (c / STAGES) & 1);
#pragma unroll
      for (int h = 0; h < MW; ++h)
        load_frag<A_KMAJOR>(af[h], smem + s * STAGE_BYTES, off[h], r0 + 64 * h, t);
      const uint32_t b_s = ring + s * STAGE_BYTES + A_BYTES;
      tc::wgmma_fence();
      fences();
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
        for (int h = 0; h < MW; ++h) wgmma_rs(d[h], af[h] + 4 * ks, desc_sw128(b_s + 32 * ks));
      tc::wgmma_commit();
      fences();
    }
    tc::wgmma_wait<0>();
    fences();

    // every stage consumed (both warpgroups): the ring holds the tile
    bar_sync(1, CONSUMERS);
    float* P = reinterpret_cast<float*>(smem);
    {
      // fragment of block h: rows r0 + 64 h (+ 8), columns 8 j + 2 (l % 4) (+ 1)
#pragma unroll
      for (int h = 0; h < MW; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = r0 + 64 * h + 8 * e, col = 8 * j + 2 * (lane % 4);
            const float v0 = d[h][4 * j + 2 * e], v1 = d[h][4 * j + 2 * e + 1];
            if (OUT_T) {
              P[col * T::LDP_T + row] = v0;
              P[(col + 1) * T::LDP_T + row] = v1;
            } else {
              *reinterpret_cast<float2*>(P + row * T::LDP_N + col) = make_float2(v0, v1);
            }
          }
        }
    }
    if (C > 1) {
      cluster_sync();
    } else {
      bar_sync(1, CONSUMERS);
    }
    // this block's 1/C of the tile's outer rows (n under OUT_T, else m): the
    // pair's two tiles added in split order; then, with X pairs, the pairs'
    // half tiles added in pair order by the block of the tile's half that
    // arrives last
    constexpr int OUTER = OUT_T ? BN : BM, INNER = OUT_T ? BM : BN;
    constexpr int LDP = OUT_T ? T::LDP_T : T::LDP_N;
    const int rows = OUTER / C, n4 = rows * (INNER / 4);
    const int o0 = OUT_T ? n0 : m0, i0 = OUT_T ? m0 : n0;
    const int olim = OUT_T ? g.N : g.M, ilim = OUT_T ? g.M : g.N;
    const bool vec = g.ldo % 4 == 0 && reinterpret_cast<uintptr_t>(g.out) % 16 == 0;
    float4* xparts = X > 1 ? reinterpret_cast<float4*>(g.xp) + ((size_t)(tile * C + rank) * X) * n4
                           : nullptr;  // this half tile's X partials
    auto store = [&](int e, float4 v) {
      const int orow = rank * rows + e / (INNER / 4), ic = (e % (INNER / 4)) * 4;
      const int go = o0 + orow, gi = i0 + ic;
      if (go >= olim || gi >= ilim) return;
      if (ROUND_OUT) {
        v.x = tc::to_tf32(v.x);
        v.y = tc::to_tf32(v.y);
        v.z = tc::to_tf32(v.z);
        v.w = tc::to_tf32(v.w);
      }
      float* o = g.out + (size_t)go * g.ldo + gi;
      if (vec && gi + 3 < ilim) {
        *reinterpret_cast<float4*>(o) = v;
      } else {
        const float w[4] = {v.x, v.y, v.z, v.w};
        for (int u = 0; u < 4 && gi + u < ilim; ++u) o[u] = w[u];
      }
    };
    for (int e = threadIdx.x; e < n4; e += CONSUMERS) {
      const int orow = rank * rows + e / (INNER / 4), ic = (e % (INNER / 4)) * 4;
      const uint32_t addr = ring + 4 * (orow * LDP + ic);
      float4 v =
          C > 1 ? ld_cluster4(addr, 0) : *reinterpret_cast<const float4*>(P + orow * LDP + ic);
      if (C > 1) {
        const float4 u = ld_cluster4(addr, 1);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      if (X > 1) {
        xparts[(size_t)x * n4 + e] = v;
      } else {
        store(e, v);
      }
    }
    if (C > 1) cluster_sync();  // no block leaves while the other reads its tile
    if (X > 1) {
      __threadfence();
      bar_sync(1, CONSUMERS);
      if (threadIdx.x == 0)
        red[0] = __uint_as_float(
            atomicInc(&tickets[tile * C + rank], X - 1) == (unsigned int)(X - 1) ? 1u : 0u);
      bar_sync(1, CONSUMERS);
      if (__float_as_uint(red[0]) == 1u) {  // every pair's half tile is written
        __threadfence();
        for (int e = threadIdx.x; e < n4; e += CONSUMERS) {
          float4 v = __ldcg(xparts + e);
          for (int p = 1; p < X; ++p) {
            const float4 u = __ldcg(xparts + (size_t)p * n4 + e);
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
          }
          store(e, v);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == PRODUCER_WARP) {
      if (lane == 0) {
        for (int c = 0; c < nk; ++c) {
          const int s = c % STAGES;
          if (c >= STAGES) mbar_wait(empty(s), ((c / STAGES) - 1) & 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          const uint32_t a_s = ring + s * STAGE_BYTES;
          const int k = (c0 + c) * BK;
          if (A_KMAJOR) {
            tma_load(a_s, &ta, k, m0, full(s));
          } else {
#pragma unroll
            for (int b = 0; b < BM / 32; ++b)
              tma_load(a_s + 4096 * b, &ta, m0 + 32 * b, k, full(s));
          }
          tma_load(a_s + A_BYTES, &tb, k, n0, full(s));
        }
      }
    } else if (CONVERT_B) {  // the converters
      const bool sq = g.n2p != nullptr && mt == 0;  // each element of B once over the grid
      const int i0 = threadIdx.x - (PRODUCER_WARP + 1) * 32;
      float ss = 0.f;
      for (int c = 0; c < nk; ++c) {
        const int s = c % STAGES;
        mbar_wait(full(s), (c / STAGES) & 1);
        float4* bp = reinterpret_cast<float4*>(smem + s * STAGE_BYTES + A_BYTES);
        for (int i = i0; i < B_BYTES / 16; i += CONVERTERS) {
          float4 v = bp[i];
          if (sq) {
            ss = fmaf(v.x, v.x, ss);
            ss = fmaf(v.y, v.y, ss);
            ss = fmaf(v.z, v.z, ss);
            ss = fmaf(v.w, v.w, ss);
          }
          v.x = tc::to_tf32(v.x);
          v.y = tc::to_tf32(v.y);
          v.z = tc::to_tf32(v.z);
          v.w = tc::to_tf32(v.w);
          bp[i] = v;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        mbar_arrive(ready(s));
      }
      if (sq) {  // this block's squares; n2 from the last block's fixed-order sum
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
        if (lane == 0) red[1 + warp - (PRODUCER_WARP + 1)] = ss;
        bar_sync(2, CONVERTERS);
        if (i0 == 0) {
          const unsigned int total = (unsigned int)(g.nN * g.S);
          g.n2p[nt * g.S + x * C + rank] = (red[1] + red[2]) + red[3];
          __threadfence();
          if (atomicInc(&n2_ticket, total - 1) == total - 1) {  // every block's sum is written
            __threadfence();
            float v = 0.f;
            for (unsigned int i = 0; i < total; ++i) v += __ldcg(g.n2p + i);
            *g.n2 = v;
          }
        }
      }
    }
    if (C > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  }
}

// dst (q, ldd) = tf32(src (rows, cols))^T: y1^T for K4b, rounded
__global__ void __launch_bounds__(256) tf1_transpose_kernel(const float* src, int rows, int cols,
                                                            float* dst, int ldd) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32, tx = threadIdx.x % 32,
            ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    if (r < rows && c < cols) tile[i][tx] = src[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c < cols && r < rows) dst[(size_t)c * ldd + r] = tc::to_tf32(tile[tx][i]);
  }
}

// dst (rows, ldd) = src (rows, cols), ldd = round4(cols): an operand whose rows
// are not a whole number of 16 bytes, for the TMA
__global__ void __launch_bounds__(256) tf1_pad_kernel(const float* src, int rows, int cols,
                                                      float* dst, int ldd) {
  const long n = (long)rows * cols;
  for (long e = (long)blockIdx.x * 256 + threadIdx.x; e < n; e += (long)gridDim.x * 256)
    dst[(e / cols) * ldd + e % cols] = src[e];
}

// ---- the host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a row-major float32 matrix (outer, inner) with row stride
// ld floats (a multiple of 4), read in boxes of (box_outer, box_inner = 32)
// with 128-byte swizzled rows; past the edge the TMA fills zeros
inline cudaError_t tensor_map(CUtensorMap* map, const float* p, int outer, int inner, int ld,
                              int box_outer) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// C = A B^T for plan g: A (M, K) given by `a` with row stride lda, k contiguous
// (A_KMAJOR) or m contiguous (then a is (K, M)); B (N, K) given by `b`, k
// contiguous, row stride ldb
template <int MW, bool A_KMAJOR, bool CONVERT_B, bool OUT_T, bool ROUND_OUT>
cudaError_t gemm(const Gemm& g, const float* a, int lda, const float* b, int ldb,
                 cudaStream_t stream) {
  static bool ready = false;
  auto kernel = tf1_gemm_kernel<MW, A_KMAJOR, CONVERT_B, OUT_T, ROUND_OUT>;
  constexpr int BM = Shape<MW>::BM, BN = Shape<MW>::BN;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  CUtensorMap ta, tb;
  cudaError_t err = A_KMAJOR ? tensor_map(&ta, a, g.M, g.K, lda, BM)
                             : tensor_map(&ta, a, g.K, g.M, lda, 32);
  if (err == cudaSuccess) err = tensor_map(&tb, b, g.N, g.K, ldb, BN);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.nM * g.nN * g.S);  // tile-major, then pair, then rank
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.S > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, ta, tb, g);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// an operand (rows, cols) with rows of a whole number of 16 bytes: p itself,
// or its copy at `pad` with row stride round4(cols)
inline const float* aligned_rows(const float* p, int rows, int cols, float* pad, int& ld,
                                 cudaStream_t stream) {
  ld = round4(cols);
  if (ld == cols) return p;
  const long n = (long)rows * cols;
  const int blocks = (int)std::min<long>((n + 255) / 256, 4096);
  tf1_pad_kernel<<<blocks, 256, 0, stream>>>(p, rows, cols, pad, ld);
  return pad;
}

// ---- K4a and K4b in one pass -------------------------------------------------------

// the scratch of either, offsets in floats on 256-byte boundaries (layout.cuh)
struct Layout {
  long n2p, xp, om, b, y1t, tt, floats;
};

// K4a: the partial sums of n2, the exchange, then Omega and B padded where
// their rows need it
inline Layout sketch_layout(int I, int J, int q) {
  const Gemm g = plan<2>(q, I, J);
  Layout L{};
  long o = 0;
  L.n2p = o; o += part((long)g.nN * g.S);
  L.xp = o; o += part(exchange_floats(g));
  L.om = o; o += q % 4 ? part((long)J * round4(q)) : 0;
  L.b = o; o += J % 4 ? part((long)I * round4(J)) : 0;
  L.floats = o;
  return L;
}

// K4b: y1^T (q, round4(I)), t^T (q, round4(J)), either half's exchange, then B
// padded where its rows need it
inline Layout gmul_layout(int I, int J, int q) {
  Layout L{};
  long o = 0;
  L.y1t = o; o += part((long)q * round4(I));
  L.tt = o; o += part((long)q * round4(J));
  L.xp = o;
  o += part(std::max(exchange_floats(plan<1>(J, q, I)), exchange_floats(plan<1>(I, q, J))));
  L.b = o; o += J % 4 ? part((long)I * round4(J)) : 0;
  L.floats = o;
  return L;
}

// K4a: y0 = B Omega (I, q) and n2 = |B|_F^2, as y0^T = Omega^T B^T
inline cudaError_t sketch(const float* b, const float* om, float* y0, float* n2, float* scratch,
                          int I, int J, int q, cudaStream_t stream) {
  const Layout L = sketch_layout(I, J, q);
  int ldb, ldom;
  const float* B = aligned_rows(b, I, J, scratch + L.b, ldb, stream);
  const float* Om = aligned_rows(om, J, q, scratch + L.om, ldom, stream);
  Gemm g = plan<2>(q, I, J);
  g.out = y0;
  g.ldo = q;
  g.xp = scratch + L.xp;
  g.n2 = n2;
  g.n2p = scratch + L.n2p;
  return gemm<2, false, true, true, false>(g, Om, ldom, B, ldb, stream);
}

// K4b: z = B (B^T y1) (I, q): y1^T rounded, then t = B^T y1 stored as t^T
// rounded, then z = B t
inline cudaError_t gmul(const float* b, const float* y1, float* z, float* scratch, int I, int J,
                        int q, cudaStream_t stream) {
  const Layout L = gmul_layout(I, J, q);
  int ldb;
  const float* B = aligned_rows(b, I, J, scratch + L.b, ldb, stream);
  float* y1t = scratch + L.y1t;
  float* tt = scratch + L.tt;
  const int ldi = round4(I), ldj = round4(J);
  tf1_transpose_kernel<<<dim3(cdiv(q, 32), cdiv(I, 32)), 256, 0, stream>>>(y1, I, q, y1t, ldi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Gemm g1 = plan<1>(J, q, I);  // t (J, q) = B^T y1, k = I
  g1.out = tt;
  g1.ldo = ldj;
  g1.xp = scratch + L.xp;
  err = gemm<1, false, false, true, true>(g1, B, ldb, y1t, ldi, stream);
  if (err != cudaSuccess) return err;
  Gemm g2 = plan<1>(I, q, J);  // z (I, q) = B t, k = J
  g2.out = z;
  g2.ldo = q;
  g2.xp = scratch + L.xp;
  return gemm<1, true, false, false, false>(g2, B, ldb, tt, ldj, stream);
}

}  // namespace tf1
}  // namespace
