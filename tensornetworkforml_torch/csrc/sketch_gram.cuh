// The sketch-and-Gram tile pass over the columns of B (I, J) of the
// rangefinder split (K6, rangefinder_split.cu): y = B rhs (I, q), G = B B^T
// (I, I) and partial sums of |B|_F^2, as float32 FMA output tiles
// of 64 x 64 whose k range (the J axis) is split over S blocks when the tiles
// alone cannot fill the card. With S > 1 the blocks write partial tiles,
// which K6's next launch adds in split order. K6 alone uses it: K5 and K8's
// first stage moved to the tensor cores (tc_gemm.cuh), while K6 keeps this
// float32 pass, since its G is applied six times over.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "tile_gemm.cuh"

namespace {

constexpr int NT = 256;
constexpr int T = 64, TK = 16;
using Smem = TileSmem<T, T, TK>;
// Split the k range until about this many blocks have work (two per SM of an
// H100), but give no block fewer than MIN_CHUNK columns of B. A fixed target,
// not the card's SM count, so that the summation order and therefore the
// result do not depend on the card.
constexpr int TARGET_BLOCKS = 264;
constexpr int MIN_CHUNK = 256;

struct Args {
  const float* b;    // (I, J)
  const float* rhs;  // (J, q): Omega
  float* y;          // (I, q)
  float* g;          // (I, I)
  float* n2;         // (1)
  float* yp;         // S > 1: (S, I, q) partial tiles
  float* gp;         // S > 1: (S, I, I) partial tiles
  float* n2p;        // (S, nI) partial norms
  int I, J, q;
  int nI, nQ;            // tile counts over I and q
  int jobs_y, jobs_g;    // tiles of y, and of G's upper triangle
  int S, kc;             // k splits and the columns of B each takes
};

int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

// tile t of the upper triangle of an n x n tile grid, row by row: (it, jt), it <= jt
__device__ __forceinline__ void tri_tile(int t, int n, int& it, int& jt) {
  it = 0;
  while (t >= n - it) {
    t -= n - it;
    ++it;
  }
  jt = it + t;
}

__global__ void __launch_bounds__(NT) sketch_tile_kernel(Args a) {
  __shared__ Smem sm;
  __shared__ float red[NT];
  const int s = blockIdx.y, tid = threadIdx.x, ty = tid / (T / 4), tx = tid % (T / 4);
  const int I = a.I, J = a.J, q = a.q;
  const int k0 = s * a.kc, klen = min(a.kc, J - k0);
  const float* b = a.b + k0;  // this split's columns of B
  float acc[4][4];
  int job = blockIdx.x;
  if (job < a.jobs_y) {
    const int it = job % a.nI, qt = job / a.nI;
    const bool sq = qt == 0;  // uniform over the block
    const float* rhs = a.rhs + (size_t)k0 * q;
    float ss = 0.f;
    tile_gemm<T, T, TK, NT, true, false>(
        sm, it * T, qt * T, klen,
        [&](int m, int k) {
          const float v = (m < I && k < klen) ? b[(size_t)m * J + k] : 0.f;
          if (sq) ss = fmaf(v, v, ss);  // each element is loaded once per block
          return v;
        },
        [=](int k, int n) { return (k < klen && n < q) ? rhs[(size_t)k * q + n] : 0.f; }, acc);
    float* out = a.S > 1 ? a.yp + (size_t)s * I * q : a.y;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = it * T + ty * 4 + i, n = qt * T + tx * 4 + j;
        if (m < I && n < q) out[(size_t)m * q + n] = acc[i][j];
      }
    if (sq) {
      ss = block_sum<NT>(ss, red);
      if (tid == 0) a.n2p[s * a.nI + it] = ss;
    }
    return;
  }
  job -= a.jobs_y;
  int it, jt;
  tri_tile(job, a.nI, it, jt);
  tile_gemm<T, T, TK, NT, true, true>(
      sm, it * T, jt * T, klen,
      [=](int m, int k) { return (m < I && k < klen) ? b[(size_t)m * J + k] : 0.f; },
      [=](int k, int n) { return (k < klen && n < I) ? b[(size_t)n * J + k] : 0.f; }, acc);
  float* out = a.S > 1 ? a.gp + (size_t)s * I * I : a.g;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = it * T + ty * 4 + i, n = jt * T + tx * 4 + j;
      if (m < I && n < I) {
        out[(size_t)m * I + n] = acc[i][j];
        if (it != jt) out[(size_t)n * I + m] = acc[i][j];
      }
    }
}

void plan(Args& a, int I, int J, int q) {
  a.I = I;
  a.J = J;
  a.q = q;
  a.nI = cdiv(I, T);
  a.nQ = cdiv(q, T);
  a.jobs_y = a.nI * a.nQ;
  a.jobs_g = a.nI * (a.nI + 1) / 2;
  const int tiles = a.jobs_y + a.jobs_g;
  const int S = std::max(1, std::min(cdiv(TARGET_BLOCKS, tiles), cdiv(J, MIN_CHUNK)));
  a.kc = cdiv(cdiv(J, S), TK) * TK;
  a.S = cdiv(J, a.kc);
}

long partial_floats(const Args& a) {
  long n = (long)a.S * a.nI;
  if (a.S > 1) n += (long)a.S * a.I * a.q + (long)a.S * a.I * a.I;
  return n;
}

}  // namespace
