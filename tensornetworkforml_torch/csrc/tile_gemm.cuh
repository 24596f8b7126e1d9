// A register-tiled float32 block GEMM shared by the port's hand-written kernels.
//
// One thread block accumulates a TM x TN tile of C = A B over k in [0, K):
// each thread owns a 4 x 4 sub-tile (rows 4*ty.., columns 4*tx..), the A and B
// chunks of depth TK pass through shared memory, and the next chunk is loaded
// into registers while the current one is multiplied. Operands are read
// through functors la(m, k) and lb(k, n), which return 0 outside the matrix,
// so a kernel can build an operand on the fly (a scaled matrix, an outer
// product) without materialising it. Every product is a float32 FMA, and the
// k order of every output is 0, 1, ..., K-1, so the result does not depend on
// the tile position or the launch.
//
// With KS > 1 the block holds KS thread groups of NT threads; group g takes
// the chunks g, g + KS, ... (each with its own shared-memory stage), which
// puts KS chunks in flight at once, and the groups' sums are added in group
// order at the end. Only group 0 (threadIdx.x < NT) then holds the tile, and
// tile_gemm returns true there.
//
// A is stored k-major (As[k][m]); B is stored k-major (Bs[k][n]). "KFAST"
// selects the thread-to-element map for an operand whose k index is the
// contiguous one in memory: 8 consecutive k by 4 consecutive rows per warp,
// which keeps both the global reads in 32-byte runs and the shared stores
// free of bank conflicts (the row stride TM + 4 is 4 mod 32 words).
#pragma once

#include <cuda_runtime.h>

template <int TM, int TN, int TK, int KS = 1>
struct __align__(16) TileSmem {
  float a[KS][TK][TM + 4];
  float b[KS][TK][TN + 4];
};

template <int TM, int TN, int TK, int NT, bool A_KFAST, bool B_KFAST, int KS = 1, class LA,
          class LB>
__device__ __forceinline__ bool tile_gemm(TileSmem<TM, TN, TK, KS>& sm, int m0, int n0, int K,
                                          const LA& la, const LB& lb, float (&acc)[4][4]) {
  constexpr int TX = TN / 4;
  static_assert((TM / 4) * TX == NT, "one 4x4 sub-tile per thread");
  static_assert(TK % 8 == 0, "k runs of 8");
  constexpr int NA = TM * TK / NT, NB = TN * TK / NT;
  static_assert(NA * NT == TM * TK && NB * NT == TN * TK, "chunks split evenly");
  static_assert((KS - 1) * NT * 16 <= KS * TK * (TM + 4), "room to add the groups' sums");
  const int grp = threadIdx.x / NT, tid = threadIdx.x % NT, ty = tid / TX, tx = tid % TX;
  const int kg = grp * TK;  // this group's offset inside each round of KS chunks
  float ra[NA], rb[NB];

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // element e of a chunk -> (row, k); the same map loads and stores
#define TG_A_MAP(e, m, k)                                          \
  if (A_KFAST) {                                                   \
    m = ((e) >> 3) % TM;                                           \
    k = (((e) >> 3) / TM) * 8 + ((e) & 7);                         \
  } else {                                                         \
    m = (e) % TM;                                                  \
    k = (e) / TM;                                                  \
  }
#define TG_B_MAP(e, n, k)                                          \
  if (B_KFAST) {                                                   \
    n = ((e) >> 3) % TN;                                           \
    k = (((e) >> 3) / TN) * 8 + ((e) & 7);                         \
  } else {                                                         \
    n = (e) % TN;                                                  \
    k = (e) / TN;                                                  \
  }

#pragma unroll
  for (int i = 0; i < NA; ++i) {
    int m, k;
    TG_A_MAP(tid + i * NT, m, k);
    ra[i] = la(m0 + m, kg + k);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    int n, k;
    TG_B_MAP(tid + i * NT, n, k);
    rb[i] = lb(kg + k, n0 + n);
  }
  for (int k0 = 0; k0 < K; k0 += TK * KS) {
    __syncthreads();  // the previous chunk is no longer being read
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      int m, k;
      TG_A_MAP(tid + i * NT, m, k);
      sm.a[grp][k][m] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      int n, k;
      TG_B_MAP(tid + i * NT, n, k);
      sm.b[grp][k][n] = rb[i];
    }
    __syncthreads();
    if (k0 + TK * KS < K) {  // the next round is in flight while this one is used
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        int m, k;
        TG_A_MAP(tid + i * NT, m, k);
        ra[i] = la(m0 + m, k0 + TK * KS + kg + k);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        int n, k;
        TG_B_MAP(tid + i * NT, n, k);
        rb[i] = lb(k0 + TK * KS + kg + k, n0 + n);
      }
    }
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.a[grp][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.b[grp][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#undef TG_A_MAP
#undef TG_B_MAP
  if (KS == 1) return true;
  // add the groups' sums in group order, through the (now idle) A stages
  float* part = &sm.a[0][0][0];
  __syncthreads();
  if (grp > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[((grp - 1) * 16 + i * 4 + j) * NT + tid] = acc[i][j];
  }
  __syncthreads();
  if (grp == 0) {
    for (int g = 1; g < KS; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[((g - 1) * 16 + i * 4 + j) * NT + tid];
  }
  __syncthreads();
  return grp == 0;
}

// Deterministic block-wide sum and max (fixed tree order); every thread gets
// the result. `red` holds NT floats of shared memory.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// max that propagates NaN, as torch.max and jnp.max do
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = nanmax(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  return red[0];
}

// cp.async copies from global to shared memory, 16 or 4 bytes; `bytes` of the
// source are read and the rest of the destination is zero-filled (0: zeros).
// A thread's copies land once cp_async_wait<N>() leaves N groups in flight.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
