// A float32 block GEMM on Hopper's tensor cores in 3xTF32, for the port's
// J-streaming reductions K4a, K4b and K5 (polar_sketch.cu) and K8's first
// stage (polar_iterate.cu).
//
// One block of two warpgroups (256 threads) computes a 128 x 128 tile of
//   C (M, N) = sum_k A(m, k) B(n, k)
// over one k range [k0, k0 + klen). Each operand is read either with its k
// index contiguous in memory (KCONT: A(m, k) = a[m * lda + k]) or with its
// m / n index contiguous (A(m, k) = a[k * lda + m]), so one core serves
// y0 = B Omega, t^T = y1^T B, z = B t and G = B B^T. For G only the tiles of
// the upper triangle run, and each writes its elements on and above the
// diagonal at both (i, j) and (j, i): G is symmetric bit for bit, the
// diagonal tiles too (wgmma's accumulation order is not symmetric, so their
// two halves would not agree otherwise).
//
// Precision: 3xTF32, close to float32 but not equal to it. Each operand value
// x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna.tf32.f32), and
// the tile accumulates lo.hi + hi.lo and then hi.hi in float32 accumulators.
// hi + lo carries x only to ~2^-22 relative (lo drops bits again), and the
// lo.lo term is dropped, so each product is a few times float32's unit
// roundoff (2^-24) off. Measured on an H100 against float64 at M = 512
// (I = 1024, J = 10240, q = 512): y0 = B Omega within 8.7e-6 of its max and
// z = B (B^T y1) within 2.2e-5, where float32 FMA tiles reach 1.9e-6 on z:
// about ten times float32's error, 4.5 times inside the 1e-4 limit the
// checks hold. TF32 alone keeps ~2^-11 and reads above that limit on an
// ill-scaled B (tests/test_torch_gramfree.py: emulated on the CPU, and
// cuBLAS with TF32 allowed as a control on the card).
//
// Pipeline, per k chunk of BK = 16:
//   cp.async    a ring of STAGES raw float32 stages in shared memory, filled
//               STAGES - 1 chunks ahead (16-byte copies where the operand's
//               rows are 16-byte aligned, else 4-byte ones; a copy past the
//               matrix's edge reads nothing and zero-fills, so no edge reads
//               past the operand);
//   convert     all 256 threads read the raw chunk, split it into hi and lo
//               and store both K-major in wgmma's no-swizzle core-matrix
//               layout (8 rows x 16 bytes per core matrix): wgmma reads a
//               tf32 operand from shared memory only K-major, so an operand
//               whose m / n index is the contiguous one is transposed in the
//               same register pass;
//   wgmma       each warpgroup issues m64n128k8 for its 64 rows: three per
//               k step of 8 (lo.hi, hi.lo, hi.hi), asynchronously; the next
//               chunk's copies and conversion wait for them only where they
//               reuse the converted tile.
// The k order of every output is fixed by the tile and the plan alone, and
// no float atomics are used: two launches agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "layout.cuh"     // part(): the scratch's parts on 256-byte boundaries
#include "pdl.cuh"        // K8 chains the tile launch, the sum and K1's launch
#include "tile_gemm.cuh"  // block_sum, the cp.async copies

namespace {
namespace tc {

constexpr int NT = 256;            // two warpgroups
constexpr int BM = 128, BN = 128;  // block tile; each warpgroup owns 64 rows
constexpr int BK = 16;             // k per chunk: two wgmma k steps of 8
constexpr int STAGES = 3;          // raw cp.async ring
constexpr int ACC = 64;            // m64n128 float32 accumulators per thread
constexpr int RAW_LD = BK + 4;     // row stride of a KCONT raw chunk (floats)
constexpr int RAW = BM * RAW_LD;   // floats of one operand's raw chunk (>= BK * BM)
constexpr int CONV = BM * BK;      // floats of one converted operand part
constexpr size_t SMEM_BYTES = sizeof(float) * (STAGES * 2 * RAW + 4 * CONV);
// The plan: split the k range until about TARGET_BLOCKS blocks have work (two
// per SM of an H100), no block taking fewer than MIN_CHUNK of k. A fixed
// target, not the card's SM count, so the summation order and the result
// depend on the shape alone.
constexpr int TARGET_BLOCKS = 264;
constexpr int MIN_CHUNK = 128;

struct Gemm {
  const float* a;   // A(m, k)
  const float* b;   // B(n, k)
  float* c;         // (M, N), row stride ldc
  float* cp;        // S > 1: (S, M, N) partial tiles
  float* n2p;       // sq: (S, nM) partial sums of A's squares, else null
  int M, N, K;
  int lda, ldb, ldc;
  int a_vec, b_vec;  // 16-byte copies allowed
  int nM, nN, S, kc;
};

inline int cdiv_l(long a, long b) { return (int)((a + b - 1) / b); }

// split the k range of g for a launch of `tiles` output tiles
inline void split_k(Gemm& g, int tiles) {
  int S = TARGET_BLOCKS / tiles;
  if (S > cdiv_l(g.K, MIN_CHUNK)) S = cdiv_l(g.K, MIN_CHUNK);
  if (S < 1) S = 1;
  g.kc = cdiv_l(cdiv_l(g.K, S), BK) * BK;
  g.S = cdiv_l(g.K, g.kc);
}

inline void plan(Gemm& g, int M, int N, int K) {
  g.M = M;
  g.N = N;
  g.K = K;
  g.nM = cdiv_l(M, BM);
  g.nN = cdiv_l(N, BN);
  split_k(g, g.nM * g.nN);
}

// floats of the (S, M, N) partials, 0 when the k range is not split
inline long partial_floats(const Gemm& g) { return g.S > 1 ? (long)g.S * g.M * g.N : 0L; }

inline bool aligned16(const void* p, int ld) {
  return ((uintptr_t)p % 16 == 0) && (ld % 4 == 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// wgmma's shared-memory matrix descriptor, no swizzle: the start address,
// the leading byte offset (between core matrices adjacent in k) and the
// stride byte offset (between core matrices adjacent in m / n), each >> 4
__device__ __forceinline__ uint64_t make_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128) += A (64 x 8) B (128 x 8)^T, tf32 operands from shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// offset (floats) of element (r, k) of a converted R x BK operand part:
// core matrices of 8 rows x 4 k, row groups adjacent (128 bytes apart),
// k quads R * 16 bytes apart
template <int R>
__device__ __forceinline__ int core_offset(int r, int kq) {
  return (kq * (R / 8) + (r >> 3)) * 32 + (r & 7) * 4;
}

// issue the copies of one operand's chunk [k0, k0 + BK) of rows [r0, r0 + R)
// into `raw`; rows >= rows_n and k >= kend are zero-filled
template <bool KCONT, int R>
__device__ __forceinline__ void load_chunk(float* raw, const float* p, int ld, bool vec, int r0,
                                           int rows_n, int k0, int kend) {
  const int tid = threadIdx.x;
  if (KCONT) {  // raw[r * RAW_LD + k]
    if (vec) {
#pragma unroll
      for (int i = 0; i < R * BK / 4 / NT; ++i) {
        const int u = tid + i * NT, r = u / (BK / 4), k = (u % (BK / 4)) * 4;
        const int kk = k0 + k;
        const int n = (r0 + r < rows_n) ? max(0, min(4, kend - kk)) : 0;
        cp_async16(raw + r * RAW_LD + k, n ? p + (size_t)(r0 + r) * ld + kk : p, n * 4);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < R * BK / NT; ++i) {
        const int u = tid + i * NT, r = u / BK, k = u % BK;
        const bool in = r0 + r < rows_n && k0 + k < kend;
        cp_async4(raw + r * RAW_LD + k, in ? p + (size_t)(r0 + r) * ld + k0 + k : p, in ? 4 : 0);
      }
    }
  } else {  // raw[k * R + r]
    if (vec) {
#pragma unroll
      for (int i = 0; i < R * BK / 4 / NT; ++i) {
        const int u = tid + i * NT, k = u / (R / 4), r = (u % (R / 4)) * 4;
        const int n = (k0 + k < kend) ? max(0, min(4, rows_n - (r0 + r))) : 0;
        cp_async16(raw + k * R + r, n ? p + (size_t)(k0 + k) * ld + r0 + r : p, n * 4);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < R * BK / NT; ++i) {
        const int u = tid + i * NT, k = u / R, r = u % R;
        const bool in = k0 + k < kend && r0 + r < rows_n;
        cp_async4(raw + k * R + r, in ? p + (size_t)(k0 + k) * ld + r0 + r : p, in ? 4 : 0);
      }
    }
  }
}

// split one operand's raw chunk into hi and lo, stored K-major as core
// matrices; with `sq`, add the squares of the float32 values to ss
template <bool KCONT, int R>
__device__ __forceinline__ void convert_chunk(const float* raw, float* hi, float* lo, bool sq,
                                              float& ss) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < R * BK / 4 / NT; ++i) {
    const int u = tid + i * NT, r = u % R, kq = u / R;  // consecutive threads: consecutive r
    float v[4];
    if (KCONT) {
      const float4 x = *reinterpret_cast<const float4*>(raw + r * RAW_LD + kq * 4);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = raw[(kq * 4 + j) * R + r];
    }
    float h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (sq) ss = fmaf(v[j], v[j], ss);
      h[j] = to_tf32(v[j]);
      l[j] = to_tf32(v[j] - h[j]);
    }
    const int o = core_offset<R>(r, kq);
    *reinterpret_cast<float4*>(hi + o) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + o) = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// one block: output tile (mt, nt) over k split s; with MIRROR (a tile of G's
// upper triangle, M == N) each element on or above the diagonal is written at
// (row, col) and (col, row)
template <bool A_KCONT, bool B_KCONT, bool MIRROR>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int mt, int nt, int s, float* smem,
                                          float* red) {
  float* raw = smem;                         // STAGES x (A chunk, B chunk)
  float* conv = smem + STAGES * 2 * RAW;     // A hi, A lo, B hi, B lo
  float* a_hi = conv;
  float* a_lo = conv + CONV;
  float* b_hi = conv + 2 * CONV;
  float* b_lo = conv + 3 * CONV;
  const int m0 = mt * BM, n0 = nt * BN;
  const int k0 = s * g.kc, kend = min(g.K, k0 + g.kc);
  const int nk = (kend - k0 + BK - 1) / BK;
  const bool sq = g.n2p != nullptr && nt == 0;  // uniform over the block
  const int wg = threadIdx.x / 128;

  float d[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0.f;
  float ss = 0.f;

  auto issue = [=](int c) {
    if (c < nk) {
      float* st = raw + (c % STAGES) * 2 * RAW;
      const int kc0 = k0 + c * BK;
      load_chunk<A_KCONT, BM>(st, g.a, g.lda, g.a_vec, m0, g.M, kc0, kend);
      load_chunk<B_KCONT, BN>(st + RAW, g.b, g.ldb, g.b_vec, n0, g.N, kc0, kend);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's copies)
    fence_acc(d);
    wgmma_wait<0>();  // the previous chunk's products no longer read conv
    fence_acc(d);
    __syncthreads();  // ... in both warpgroups; every thread's copies of chunk c visible
    issue(c + STAGES - 1);  // into the stage chunk c - 1 used, converted before the barrier
    const float* st = raw + (c % STAGES) * 2 * RAW;
    convert_chunk<A_KCONT, BM>(st, a_hi, a_lo, sq, ss);
    float unused = 0.f;
    convert_chunk<B_KCONT, BN>(st + RAW, b_hi, b_lo, false, unused);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    wgmma_fence();
    fence_acc(d);
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      // k quads 2 ks and 2 ks + 1; this warpgroup's 64 rows of A, all of B
      const int ao = core_offset<BM>(wg * 64, 2 * ks), bo = core_offset<BN>(0, 2 * ks);
      const uint64_t dah = make_desc(a_hi + ao, BM * 16, 128);
      const uint64_t dal = make_desc(a_lo + ao, BM * 16, 128);
      const uint64_t dbh = make_desc(b_hi + bo, BN * 16, 128);
      const uint64_t dbl = make_desc(b_lo + bo, BN * 16, 128);
      wgmma_tf32(d, dal, dbh);
      wgmma_tf32(d, dah, dbl);
      wgmma_tf32(d, dah, dbh);
    }
    wgmma_commit();
    fence_acc(d);
  }
  wgmma_wait<0>();
  fence_acc(d);
  cp_async_wait<0>();

  // accumulator fragment of m64n128: thread (warp w, lane l) of the
  // warpgroup holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1)
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  float* out = g.S > 1 ? g.cp + (size_t)s * g.M * g.N : g.c;
  const int ldc = g.S > 1 ? g.N : g.ldc;
  const int r_base = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_base + 8 * h;
      if (row < g.M) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int cu = col + u;
          const float v = d[4 * j + 2 * h + u];
          if (cu >= g.N) continue;
          if (!MIRROR) {
            out[(size_t)row * ldc + cu] = v;
          } else if (row <= cu) {
            out[(size_t)row * ldc + cu] = v;
            out[(size_t)cu * ldc + row] = v;
          }
        }
      }
    }
  }
  if (g.n2p != nullptr && nt == 0) {
    ss = block_sum<NT>(ss, red);
    if (threadIdx.x == 0) g.n2p[s * g.nM + mt] = ss;
  }
}

template <bool A_KCONT, bool B_KCONT>
__global__ void __launch_bounds__(NT, 2) tc_gemm_kernel(Gemm g) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float red[NT];
  gemm_tile<A_KCONT, B_KCONT, false>(g, blockIdx.x % g.nM, blockIdx.x / g.nM, blockIdx.y, smem,
                                     red);
}

// tile t of the upper triangle of an n x n tile grid, row by row: (it, jt), it <= jt
__device__ __forceinline__ void tri_tile(int t, int n, int& it, int& jt) {
  it = 0;
  while (t >= n - it) {
    t -= n - it;
    ++it;
  }
  jt = it + t;
}

// K5: one launch of one tile list over k split blockIdx.y. Blocks
// [0, y.nM y.nN) are the tiles of y = B Omega (Omega's n index contiguous;
// the tiles of column-tile 0 also sum n2's squares), the rest the upper
// triangle of G = B B^T (both operands B, k contiguous), mirrored.
__global__ void __launch_bounds__(NT, 2) tc_sketch_gram_kernel(Gemm y, Gemm gram) {
  pdl::start();  // K8's chain (pdl.cuh); returns at once for K5 alone
  extern __shared__ __align__(128) float smem[];
  __shared__ float red[NT];
  const int ny = y.nM * y.nN, t = blockIdx.x;
  if (t < ny) {
    gemm_tile<true, false, false>(y, t % y.nM, t / y.nM, blockIdx.y, smem, red);
  } else {
    int it, jt;
    tri_tile(t - ny, gram.nM, it, jt);
    gemm_tile<true, true, true>(gram, it, jt, blockIdx.y, smem, red);
  }
}

// The fixed-order sum of S partial tiles of y (and of G) and of y's partial
// sums of squares into n2: each element adds its S partials in split order;
// n2 adds its partials in one fixed tree order.
struct Sums {
  float* y;
  const float* yp;
  long ny;
  float* g;  // or null
  const float* gp;
  long ng;
  float* n2;  // or null
  const float* n2p;
  int nn2, S;
};

__global__ void __launch_bounds__(NT) split_sum_kernel(Sums f) {
  pdl::start();  // K8's chain (pdl.cuh); returns at once for K4a, K4b and K5 alone
  __shared__ float red[NT];
  const long e = (long)blockIdx.x * NT + threadIdx.x;
  if (f.S > 1) {
    if (e < f.ny) {
      float v = 0.f;
      for (int p = 0; p < f.S; ++p) v += f.yp[p * f.ny + e];
      f.y[e] = v;
    }
    if (f.g != nullptr && e < f.ng) {
      float v = 0.f;
      for (int p = 0; p < f.S; ++p) v += f.gp[p * f.ng + e];
      f.g[e] = v;
    }
  }
  if (f.n2 != nullptr && blockIdx.x == 0) {
    float v = 0.f;
    for (int p = threadIdx.x; p < f.nn2; p += NT) v += f.n2p[p];
    v = block_sum<NT>(v, red);
    if (threadIdx.x == 0) *f.n2 = v;
  }
}

// after y's launch (and gram's, in the same k split): the sum of the split
// partials into y.c (and gram->c), which are dense, and of the partial sums
// of squares into n2 where it is wanted; nothing when neither is needed.
// pdl: a programmatic dependent launch of the launch before it (pdl.cuh)
inline int sum_splits(const Gemm& y, float* n2, const Gemm* gram, cudaStream_t stream,
                      bool pdl = false) {
  if (y.S == 1 && n2 == nullptr) return 0;
  Sums f{};
  f.y = y.c;
  f.yp = y.cp;
  f.ny = (long)y.M * y.N;
  f.n2 = n2;
  f.n2p = y.n2p;
  f.nn2 = y.S * y.nM;
  f.S = y.S;
  if (gram != nullptr) {
    f.g = gram->c;
    f.gp = gram->cp;
    f.ng = (long)gram->M * gram->N;
  }
  const long n = f.ny > f.ng ? f.ny : f.ng;
  return (int)pdl::launch(split_sum_kernel, y.S > 1 ? cdiv_l(n, NT) : 1, NT, 0, stream, pdl, f);
}

template <bool A_KCONT, bool B_KCONT>
cudaError_t launch(const Gemm& g, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(tc_gemm_kernel<A_KCONT, B_KCONT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  tc_gemm_kernel<A_KCONT, B_KCONT><<<dim3(g.nM * g.nN, g.S), NT, SMEM_BYTES, stream>>>(g);
  return cudaGetLastError();
}

// K5's plan: y = B Omega (I, q) with n2's partial sums, and G = B B^T (I, I)
// by its upper triangle of tiles, over one k split (J) chosen from both tile
// counts together
struct SketchGram {
  Gemm y, g;
};

// y (I, q) = B (I, J) Omega (J, q), k = J: K4a's GEMM, and K5's y
inline Gemm sketch_plan(const float* b, const float* om, float* y, int I, int J, int q) {
  Gemm g{};
  plan(g, I, q, J);
  g.a = b;
  g.lda = J;
  g.a_vec = aligned16(b, J);
  g.b = om;
  g.ldb = q;
  g.b_vec = aligned16(om, q);
  g.c = y;
  g.ldc = q;
  return g;
}

inline SketchGram sketch_gram_plan(const float* b, const float* om, float* y, float* gm, int I,
                                   int J, int q) {
  SketchGram p{};
  p.y = sketch_plan(b, om, y, I, J, q);
  plan(p.g, I, I, J);
  p.g.a = b;
  p.g.lda = J;
  p.g.a_vec = p.y.a_vec;
  p.g.b = b;
  p.g.ldb = J;
  p.g.b_vec = p.y.a_vec;
  p.g.c = gm;
  p.g.ldc = I;
  const int tiles = p.y.nM * p.y.nN + p.g.nM * (p.g.nM + 1) / 2;
  split_k(p.y, tiles);
  split_k(p.g, tiles);
  return p;
}

// K5's scratch, offsets in floats, each part on a 256-byte boundary
// (layout.cuh): n2's partial sums, the partials of y, the partials of G
struct SketchGramLayout {
  long n2p, yp, gp, floats;
};

inline SketchGramLayout sketch_gram_layout(const SketchGram& p) {
  SketchGramLayout s;
  long o = 0;
  s.n2p = o; o += part((long)p.y.S * p.y.nM);
  s.yp = o; o += part(partial_floats(p.y));
  s.gp = o; o += part(partial_floats(p.g));
  s.floats = o;
  return s;
}

inline SketchGramLayout sketch_gram_layout(int I, int J, int q) {
  return sketch_gram_layout(sketch_gram_plan(nullptr, nullptr, nullptr, nullptr, I, J, q));
}

inline long sketch_gram_scratch_floats(int I, int J, int q) {
  return sketch_gram_layout(I, J, q).floats;
}

// K5: y = B Omega, G = B B^T (exactly symmetric), n2 = |B|_F^2; one tile
// launch, then the fixed-order sum. chained (K8's chain, not K5 alone): the
// sum is a programmatic dependent launch of the tile launch (pdl.cuh).
inline int sketch_gram(const float* b, const float* om, float* y, float* gm, float* n2,
                       float* scratch, int I, int J, int q, cudaStream_t stream,
                       bool chained = false) {
  SketchGram p = sketch_gram_plan(b, om, y, gm, I, J, q);
  const SketchGramLayout s = sketch_gram_layout(p);
  p.y.n2p = scratch + s.n2p;
  p.y.cp = scratch + s.yp;
  p.g.cp = scratch + s.gp;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_sketch_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int tiles = p.y.nM * p.y.nN + p.g.nM * (p.g.nM + 1) / 2;
  tc_sketch_gram_kernel<<<dim3(tiles, p.y.S), NT, SMEM_BYTES, stream>>>(p.y, p.g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits(p.y, n2, &p.g, stream, chained);
}

}  // namespace tc
}  // namespace
