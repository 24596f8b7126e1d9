// The two-site pre-split step's device code, shared by presplit.cu (K2, the
// hybrid engine's step) and two_site_step.cu (K7, the fused engine's whole
// step): merge, loss derivative, gradient, plain weight decay, L1 clip,
// ascent update, output recompute, and the split's sketch y0 = B_new Omega and
// Gram G = B_new B_new^T, as six launches (see presplit.cu for the design).
//
// A growth cap (K7 only; K2 passes growth_cap = 0, which changes no bit):
//   g_sc = min(1, (1 + cap) sum|bt| / sum|bnew|)
// scales bnew before f_new, y0 and G are formed. The launch that forms them
// (products_kernel) first reduces the update's partial sum|bnew| in the same
// fixed order in every block, scales bnew as it lands in shared memory, and
// writes g_sc to *gsc; finish_kernel then reports |g_sc bnew|^2 and
// sum|g_sc bnew| in the stats row. bnew itself is written unscaled.
//
// Every sum has one fixed order, that of this kernel's first version (64 x 64
// tiles of 256 threads, 4 x 4 outputs each): each product output is one FMA
// chain over k = 0, 1, ..., K - 1 and the zeros up to the next multiple of TK,
// the |bt| and |db| partials of each 64 x 64 tile are that tiling's per-thread
// sums added by a 256-slot tree, and so on. The tiling here differs (128
// threads, 8 x 4 outputs each), but each thread owns two of the old threads'
// 4 x 4 blocks and builds their sums in their order, and the operands are the
// same floats, only laid out otherwise, so the outputs are the same bits.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "pdl.cuh"
#include "tile_gemm.cuh"

namespace {
namespace presplit {

constexpr int NR = 256;         // threads of the other launches; slots of a sum's tree
constexpr int T = 64, TK = 16;  // output tile, k chunk
constexpr int NT = 128;         // threads of a product block, 8 x 4 outputs each
constexpr int TP = T + 4;       // row stride of a staged chunk (4 mod 32 words)
constexpr int NSTAGE = 3;       // chunks in flight
constexpr int TT = 32;          // transpose tile

enum { ACT_LINEAR = 0, ACT_SIGMOID = 1, ACT_SOFTMAX = 2 };
enum { LOSS_MSE = 0, LOSS_CE = 1, LOSS_FULL_CE = 2 };

struct Args {
  const float* lab;    // (L, I, Mk)
  const float* a2m;    // (Mk, DM)
  const float* x1;     // (B, D)
  const float* x2;     // (B, D)
  const float* l_env;  // (B, M)
  const float* r_env;  // (B, M)
  const float* y1h;    // (L, B)
  const float* f;      // (L, B)
  const float* om;     // (L, DM, q)
  const float* lr;     // (1)
  const float* wd;     // (1)
  float* bnew;         // (L, I, DM)
  float* y0;           // (I, q)
  float* g;            // (I, I) or null
  float* f_new;        // (L, B)
  float* left_part;    // (B, I)
  float* stats;        // (8)
  float* ld;           // scratch (L, B): loss_der
  float* rp;           // scratch (B, DM): right_part
  float* lpt;          // scratch (I, B): left_part^T
  float* labt;         // scratch (L, Mk, I): lab_o^T
  float* bnt;          // scratch (L, DM, I): bnew_o^T, in labt's place
  float* bt;           // scratch (L, I, DM)
  float* db;           // scratch (L, I, DM)
  float* gp;           // scratch (L, I, I): per-label G
  float* yp;           // scratch (L, I, q)
  float* fp;           // scratch (L, nD, B)
  float* part_a;       // scratch (2 * blocks_a)
  float* part_b;       // scratch (2 * blocks_b)
  int L, I, Mk, DM, B, D, M, q;
  int nI, nD, nQ, nB;  // tile counts over I, DM, q and B
  int blocks_a, blocks_b, with_gram;
  int n_elem;          // elementwise blocks of the prep launch
  int act, loss;
  float temp;        // softmax / sigmoid temperature
  float growth_cap;  // 0: no cap (K2)
  float* gsc;        // (1): g_sc, written when growth_cap > 0
};

__device__ __forceinline__ float f_act(const Args& a, int o, int b) {
  const float x = a.f[(size_t)o * a.B + b];
  if (a.act == ACT_LINEAR) return x;
  if (a.act == ACT_SIGMOID) return 1.f / (1.f + expf(-x / a.temp));
  float zmax = -__int_as_float(0x7f800000);
  for (int p = 0; p < a.L; ++p) zmax = nanmax(zmax, a.f[(size_t)p * a.B + b] / a.temp);
  float s = 0.f;
  for (int p = 0; p < a.L; ++p) s += expf(a.f[(size_t)p * a.B + b] / a.temp - zmax);
  return expf(x / a.temp - zmax) / s;
}

__device__ __forceinline__ float loss_der(const Args& a, int o, int b) {
  const float fa = f_act(a, o, b);
  const float y = a.y1h[(size_t)o * a.B + b];
  if (a.loss == LOSS_MSE) return y - fa;
  if (a.loss == LOSS_CE) return a.act == ACT_SOFTMAX ? (y - y * fa) / a.temp : y / fa;
  return 1.f / (fa - (1.f - y) + 1e-4f);
}

__device__ __forceinline__ float left_part(const Args& a, int b, int r) {
  return a.l_env[(size_t)b * a.M + r / a.D] * a.x1[(size_t)b * a.D + r % a.D];
}

__device__ __forceinline__ float right_part(const Args& a, int b, int s) {
  return a.x2[(size_t)b * a.D + s / a.M] * a.r_env[(size_t)b * a.M + s % a.M];
}

// ---- P: loss_der, left_part, right_part and the transposed operands once; the
// batch metrics

// src (n, rows, cols) -> dst (n, cols, rows), one 32 x 32 tile a block of NR threads
__device__ __forceinline__ void transpose_tile(const float* src, float* dst, int rows, int cols,
                                               int tile, float (*buf)[TT + 1]) {
  const int nr = (rows + TT - 1) / TT, nc = (cols + TT - 1) / TT;
  const int tc = tile % nc, tr = (tile / nc) % nr, n = tile / (nc * nr);
  src += (size_t)n * rows * cols;
  dst += (size_t)n * rows * cols;
  const int tx = threadIdx.x % TT, ty = threadIdx.x / TT;
  for (int i = ty; i < TT; i += NR / TT) {
    const int r = tr * TT + i, c = tc * TT + tx;
    if (r < rows && c < cols) buf[i][tx] = src[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = ty; i < TT; i += NR / TT) {
    const int c = tc * TT + i, r = tr * TT + tx;
    if (r < rows && c < cols) dst[(size_t)c * rows + r] = buf[tx][i];
  }
}

// Block 0: acc, mae and mean|f| of the carried output (unique-max argmax);
// blocks 1 .. n_elem: loss_der (L, B), left_part (B, I) and its transpose,
// right_part (B, DM); the rest: lab's 32 x 32 tiles, transposed.
__global__ void __launch_bounds__(NR) prep_kernel(Args a) {
  pdl::start();  // K7's chain (pdl.cuh); returns at once for K2 alone
  __shared__ float red[NR];
  __shared__ float buf[TT][TT + 1];
  const int tid = threadIdx.x, B = a.B;
  if (blockIdx.x == 0) {
    float hits = 0.f, mae = 0.f, fabs_sum = 0.f;
    for (int b = tid; b < B; b += NR) {
      float fmax = -__int_as_float(0x7f800000);
      for (int p = 0; p < a.L; ++p) fmax = nanmax(fmax, f_act(a, p, b));
      float hit = 0.f;
      for (int p = 0; p < a.L; ++p) {
        const float fa = f_act(a, p, b), y = a.y1h[(size_t)p * B + b];
        hit += (fa >= fmax ? 1.f : 0.f) * y;
        mae += fabsf(y - fa);
        fabs_sum += fabsf(a.f[(size_t)p * B + b]);
      }
      hits += hit > 0.f ? 1.f : 0.f;
    }
    hits = block_sum<NR>(hits, red);
    mae = block_sum<NR>(mae, red);
    fabs_sum = block_sum<NR>(fabs_sum, red);
    if (tid == 0) {
      const float n = (float)a.L * (float)B;
      a.stats[4] = hits / (float)B;
      a.stats[5] = mae / n;
      a.stats[6] = fabs_sum / n;
      a.stats[7] = 0.f;
    }
    return;
  }
  if (blockIdx.x > a.n_elem) {
    transpose_tile(a.lab, a.labt, a.I, a.Mk, blockIdx.x - 1 - a.n_elem, buf);
    return;
  }
  const long e = (long)(blockIdx.x - 1) * NR + tid;
  if (e < (long)a.L * B) a.ld[e] = loss_der(a, (int)(e / B), (int)(e % B));
  if (e < (long)B * a.I) {
    a.left_part[e] = left_part(a, (int)(e / a.I), (int)(e % a.I));
    a.lpt[e] = left_part(a, (int)(e % B), (int)(e / B));
  }
  if (e < (long)B * a.DM) a.rp[e] = right_part(a, (int)(e / a.DM), (int)(e % a.DM));
}

// bnew (L, I, DM) -> bnt (L, DM, I), after the update
__global__ void __launch_bounds__(NR) transpose_kernel(Args a) {
  pdl::start();  // K7's chain (pdl.cuh); returns at once for K2 alone
  __shared__ float buf[TT][TT + 1];
  transpose_tile(a.bnew, a.bnt, a.I, a.DM, blockIdx.x, buf);
}

// ---- the product tile -------------------------------------------------------
//
// One block of NT = 128 threads accumulates a 64 x 64 tile of C = A B over
// k in [0, K): thread (ty, tx) = (tid / 16, tid % 16) owns acc[i][j] at row
// sub(ty, i) and column tx * 4 + j of the tile: the 4 x 4 blocks at rows
// ty*4 and 32 + ty*4, each the block of thread slot(ty, tx, i) of a
// 256-thread 4 x 4 tiling. A k step reads three float4 from shared memory for
// 32 FMAs.
//
// Both operands are stored with the tile's row (column) index contiguous, the
// k index strided: X[r][k] at p[k * ld + r]. Chunks of TK = 16 k are copied
// from global into shared memory by cp.async, 16 bytes at a time where rows
// come in aligned runs of 4 (else 4 bytes), NSTAGE chunks in flight, one
// barrier a chunk; elements outside the matrix land as zeros. Every output is
// one FMA chain over k = 0, 1, ..., K - 1 and the zeros up to the next
// multiple of TK. A thread may scale the elements it copied once they land
// (x * s, the first version's operand order), before the barrier that
// publishes the chunk.

struct __align__(16) Stage {
  float a[TK][TP];
  float b[TK][TP];
};

// operand X[r][k] = p[k * ld + r], r < R and k < K
struct Operand {
  const float* p;
  int ld, R, K;
  // rows come in aligned runs of 4, so a thread copies 4 at once
  __device__ bool vec() const {
    return (ld & 3) == 0 && (R & 3) == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
  }
};

struct NoScale {};
struct Uniform {  // every element times s
  float s;
  __device__ float operator()(int) const { return s; }
};
struct PerK {  // element (r, k) times s[k]
  const float* s;
  __device__ float operator()(int k) const { return s[k]; }
};

__device__ __forceinline__ int sub(int t, int i) { return (i >> 2) * 32 + t * 4 + (i & 3); }
// the 256-thread tiling's thread whose 4 x 4 block holds acc[i][*]
__device__ __forceinline__ int slot(int ty, int tx, int i) { return (ty + 8 * (i >> 2)) * 16 + tx; }

constexpr int NS = T * TK / NT;  // elements of an operand a thread copies a chunk
constexpr int NV = NS / 4;       // runs of 4 of them, for vec() operands

// Calls f(row, k, width) for the elements (width 4: runs) this thread copies
// of a chunk, in one order for the copy and the scaling.
template <class F>
__device__ __forceinline__ void chunk_elements(bool vec, const F& f) {
  if (vec) {
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      const int e = threadIdx.x + s * NT;
      f((e % (T / 4)) * 4, e / (T / 4), 4);
    }
  } else {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int e = threadIdx.x + s * NT;
      f(e % T, e / T, 1);
    }
  }
}

__device__ __forceinline__ void copy_chunk(float (*dst)[TP], const Operand& x, int r0, int k0) {
  chunk_elements(x.vec(), [&](int r, int k, int w) {
    const int gr = r0 + r, gk = k0 + k;
    const bool ok = gr < x.R && gk < x.K;
    const float* src = ok ? x.p + (size_t)gk * x.ld + gr : x.p;
    if (w == 4)
      cp_async16(&dst[k][r], src, ok ? 16 : 0);
    else
      cp_async4(&dst[k][r], src, ok ? 4 : 0);
  });
}

template <class F>
__device__ __forceinline__ void scale_chunk(float (*dst)[TP], const Operand& x, int r0, int k0,
                                            const F& f) {
  if constexpr (!std::is_same<F, NoScale>::value) {
    chunk_elements(x.vec(), [&](int r, int k, int w) {
      if (r0 + r < x.R && k0 + k < x.K) {
        const float v = f(k0 + k);
        for (int u = 0; u < w; ++u) dst[k][r + u] = dst[k][r + u] * v;
      }
    });
  }
}

template <class FA = NoScale, class FB = NoScale>
__device__ __forceinline__ void tile_product(Stage (&st)[NSTAGE], const Operand& A,
                                             const Operand& Bop, int m0, int n0,
                                             float (&acc)[8][4], const FA& fa = {},
                                             const FB& fb = {}) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nk = (A.K + TK - 1) / TK;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) {
      copy_chunk(st[s].a, A, m0, s * TK);
      copy_chunk(st[s].b, Bop, n0, s * TK);
    }
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    Stage& sm = st[c % NSTAGE];
    cp_async_wait<NSTAGE - 2>();  // this thread's copies of chunk c have landed
    scale_chunk(sm.a, A, m0, c * TK, fa);
    scale_chunk(sm.b, Bop, n0, c * TK, fb);
    __syncthreads();  // chunk c is complete, and chunk c - 1's stage is free
    const int nc = c + NSTAGE - 1;
    if (nc < nk) {
      copy_chunk(st[nc % NSTAGE].a, A, m0, nc * TK);
      copy_chunk(st[nc % NSTAGE].b, Bop, n0, nc * TK);
    }
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[k][32 + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.b[k][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages may be refilled
}

// ---- A: bt and db tiles with their |.| partials -------------------------------

struct GradSmem {
  Stage st[NSTAGE];
  float red[2][NR];
};

// One 64 x 64 tile (I-tile, DM-tile, label) of bt and db a block.
__global__ void __launch_bounds__(NT) gradient_kernel(Args a) {
  pdl::start();  // K7's chain (pdl.cuh); returns at once for K2 alone
  extern __shared__ float ld[];  // loss_der[o, :]
  __shared__ GradSmem sm;
  const int tid = threadIdx.x, blk = blockIdx.x;
  const int it = blk % a.nI, jt = (blk / a.nI) % a.nD, o = blk / (a.nI * a.nD);
  const int I = a.I, Mk = a.Mk, DM = a.DM, B = a.B;
  for (int b = tid; b < B; b += NT) ld[b] = a.ld[(size_t)o * B + b];
  const int m0 = it * T, n0 = jt * T, ty = tid / 16, tx = tid % 16;
  float acc[8][4];
  // bt_o = lab_o a2m
  tile_product(sm.st, Operand{a.labt + (size_t)o * Mk * I, I, I, Mk}, Operand{a.a2m, DM, DM, Mk},
               m0, n0, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + sub(ty, i), n = n0 + tx * 4 + j;
      if (m < I && n < DM) a.bt[((size_t)o * I + m) * DM + n] = acc[i][j];
    }
  // left_part^T (right_part * loss_der_o), the second operand scaled as it lands
  tile_product(sm.st, Operand{a.left_part, I, I, B}, Operand{a.rp, DM, DM, B}, m0, n0, acc,
               NoScale{}, PerK{ld});

  const float wd = *a.wd;
#pragma unroll
  for (int ib = 0; ib < 2; ++ib) {
    float sb = 0.f, sdb = 0.f;
#pragma unroll
    for (int i = ib * 4; i < ib * 4 + 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + sub(ty, i), n = n0 + tx * 4 + j;
        if (m < I && n < DM) {
          const size_t idx = ((size_t)o * I + m) * DM + n;
          const float bt = a.bt[idx];  // this thread's own write above
          const float db = acc[i][j] - wd * bt;
          a.db[idx] = db;
          sb += fabsf(bt);
          sdb += fabsf(db);
        }
      }
    sm.red[0][slot(ty, tx, ib * 4)] = sb;
    sm.red[1][slot(ty, tx, ib * 4)] = sdb;
  }
  __syncthreads();
#pragma unroll
  for (int s = NR / 2; s > 0; s >>= 1) {  // block_sum<NR>'s tree over the 256 slots
    for (int t = tid; t < s; t += NT) {
      sm.red[0][t] += sm.red[0][t + s];
      sm.red[1][t] += sm.red[1][t + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    a.part_a[2 * blk] = sm.red[0][0];
    a.part_a[2 * blk + 1] = sm.red[1][0];
  }
}

// ---- B: eta from all partials (same order in every block), bnew and its partial sums

__global__ void __launch_bounds__(NR) update_kernel(Args a) {
  pdl::start();  // K7's chain (pdl.cuh); returns at once for K2 alone
  __shared__ float red[NR];
  const int tid = threadIdx.x;
  float sb = 0.f, sdb = 0.f;
  for (int p = tid; p < a.blocks_a; p += NR) {
    sb += a.part_a[2 * p];
    sdb += a.part_a[2 * p + 1];
  }
  sb = block_sum<NR>(sb, red);
  sdb = block_sum<NR>(sdb, red);
  const float eta = *a.lr * (sdb > sb ? sb / fmaxf(sdb, 1e-30f) : 1.f);
  const size_t n = (size_t)a.L * a.I * a.DM;
  float n2 = 0.f, sabs = 0.f;
  for (size_t e = (size_t)blockIdx.x * NR + tid; e < n; e += (size_t)gridDim.x * NR) {
    const float v = a.bt[e] + eta * a.db[e];
    a.bnew[e] = v;
    n2 = fmaf(v, v, n2);
    sabs += fabsf(v);
  }
  n2 = block_sum<NR>(n2, red);
  sabs = block_sum<NR>(sabs, red);
  if (tid == 0) {
    a.part_b[2 * blockIdx.x] = n2;
    a.part_b[2 * blockIdx.x + 1] = sabs;
    if (blockIdx.x == 0) {
      a.stats[0] = sb;
      a.stats[1] = sdb;
    }
  }
}

// ---- C: per-label tiles of G and y0, per-(label, DM-tile) partials of f_new.
// G's tiles are computed on and above the diagonal; each writes its mirror
// below it too, since fmaf(x, y, c) = fmaf(y, x, c) gives the same bits.

__device__ __forceinline__ void upper_tile(int t, int n, int& it, int& jt) {
  it = 0;
  while (t >= n - it) {
    t -= n - it;
    ++it;
  }
  jt = it + t;
}

static_assert(sizeof(Stage) * NSTAGE >= sizeof(float) * T * (T + 1), "room for a G tile");

struct ProductSmem {
  Stage st[NSTAGE];  // also the transposed G tile, T x (T + 1) floats, once a product is done
  float rowpart[T][T / 4 + 1];
  float red[NR];
};

// One tile of G, y0 or f a block, bnew times gs (NoScale, or the growth cap's
// Uniform factor) as it lands.
template <class S>
__device__ __forceinline__ void product_job(const Args& a, ProductSmem& sm, int job, const S& gs) {
  const int I = a.I, DM = a.DM, q = a.q, B = a.B;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tri = a.nI * (a.nI + 1) / 2;
  const int jobs_g = a.with_gram ? a.L * tri : 0;
  const int jobs_y = a.L * a.nI * a.nQ;
  float acc[8][4];
  if (job < jobs_g) {
    int it, jt;
    upper_tile(job % tri, a.nI, it, jt);
    const int o = job / tri;
    const Operand bn{a.bnt + (size_t)o * DM * I, I, I, DM};
    tile_product(sm.st, bn, bn, it * T, jt * T, acc, gs, gs);
    float* gp = a.gp + (size_t)o * I * I;
    float(*tile)[T + 1] = reinterpret_cast<float(*)[T + 1]>(&sm.st[0]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = it * T + sub(ty, i), n = jt * T + tx * 4 + j;
        if (m < I && n < I) gp[(size_t)m * I + n] = acc[i][j];
        tile[tx * 4 + j][sub(ty, i)] = acc[i][j];
      }
    if (it == jt) return;
    __syncthreads();  // the mirror tile, written row by row
    for (int e = tid; e < T * T; e += NT) {
      const int r = e / T, c = e % T, n = jt * T + r, m = it * T + c;
      if (m < I && n < I) gp[(size_t)n * I + m] = tile[r][c];
    }
    return;
  }
  job -= jobs_g;
  if (job < jobs_y) {
    const int it = job % a.nI, qt = (job / a.nI) % a.nQ, o = job / (a.nI * a.nQ);
    tile_product(sm.st, Operand{a.bnt + (size_t)o * DM * I, I, I, DM},
                 Operand{a.om + (size_t)o * DM * q, q, q, DM}, it * T, qt * T, acc, gs);
    float* yp = a.yp + (size_t)o * I * q;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = it * T + sub(ty, i), n = qt * T + tx * 4 + j;
        if (m < I && n < q) yp[(size_t)m * q + n] = acc[i][j];
      }
    return;
  }
  job -= jobs_y;
  // f partial: rows b of (left_part @ bnew_o)[:, DM-tile] dotted with right_part,
  // each group of 4 columns as one FMA chain, the 16 groups added in order
  const int bt = job % a.nB, jt = (job / a.nB) % a.nD, o = job / (a.nB * a.nD);
  tile_product(sm.st, Operand{a.lpt, B, B, I}, Operand{a.bnew + (size_t)o * I * DM, DM, DM, I},
               bt * T, jt * T, acc, NoScale{}, gs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = sub(ty, i), b = bt * T + row;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = jt * T + tx * 4 + j;
      if (b < B && n < DM) s = fmaf(acc[i][j], a.rp[(size_t)b * DM + n], s);
    }
    sm.rowpart[row][tx] = s;
  }
  __syncthreads();
  if (tid < T) {
    const int b = bt * T + tid;
    float s = 0.f;
    for (int p = 0; p < T / 4; ++p) s += sm.rowpart[tid][p];
    if (b < B) a.fp[((size_t)o * a.nD + jt) * B + b] = s;
  }
}

__global__ void __launch_bounds__(NT) products_kernel(Args a) {
  pdl::start();  // K7's chain (pdl.cuh); returns at once for K2 alone
  __shared__ ProductSmem sm;
  const int tid = threadIdx.x;
  if (a.growth_cap > 0.f) {  // the growth cap's factor on bnew, as 256 threads summed it
    for (int v = tid; v < NR; v += NT) {
      float s = 0.f;
      for (int p = v; p < a.blocks_b; p += NR) s += a.part_b[2 * p + 1];
      sm.red[v] = s;
    }
    __syncthreads();
#pragma unroll
    for (int s = NR / 2; s > 0; s >>= 1) {
      for (int t = tid; t < s; t += NT) sm.red[t] += sm.red[t + s];
      __syncthreads();
    }
    const float s = sm.red[0];
    const float cap = (1.f + a.growth_cap) * a.stats[0];
    const float gs = s > cap ? cap / fmaxf(s, 1e-30f) : 1.f;
    if (blockIdx.x == 0 && tid == 0) *a.gsc = gs;
    product_job(a, sm, blockIdx.x, Uniform{gs});
  } else {
    product_job(a, sm, blockIdx.x, NoScale{});
  }
}

// ---- D: fixed-order sums of the partials

__global__ void __launch_bounds__(NR) finish_kernel(Args a) {
  pdl::start();  // K7's chain (pdl.cuh); returns at once for K2 alone
  __shared__ float red[NR];
  const size_t II = (size_t)a.I * a.I, Iq = (size_t)a.I * a.q, LB = (size_t)a.L * a.B;
  const size_t e = (size_t)blockIdx.x * NR + threadIdx.x;
  if (a.with_gram && e < II) {
    float s = 0.f;
    for (int o = 0; o < a.L; ++o) s += a.gp[o * II + e];
    a.g[e] = s;
  }
  if (e < Iq) {
    float s = 0.f;
    for (int o = 0; o < a.L; ++o) s += a.yp[o * Iq + e];
    a.y0[e] = s;
  }
  if (e < LB) {
    const size_t o = e / a.B, b = e % a.B;
    float s = 0.f;
    for (int jt = 0; jt < a.nD; ++jt) s += a.fp[(o * a.nD + jt) * a.B + b];
    a.f_new[e] = s;
  }
  if (blockIdx.x == 0) {
    float n2 = 0.f, sabs = 0.f;
    for (int p = threadIdx.x; p < a.blocks_b; p += NR) {
      n2 += a.part_b[2 * p];
      sabs += a.part_b[2 * p + 1];
    }
    n2 = block_sum<NR>(n2, red);
    sabs = block_sum<NR>(sabs, red);
    if (a.growth_cap > 0.f) {
      const float gs = *a.gsc;
      n2 = n2 * gs * gs;
      sabs = sabs * gs;
    }
    if (threadIdx.x == 0) {
      a.stats[2] = n2;
      a.stats[3] = sabs;
    }
  }
}

int cdiv(long a, long b) { return (int)((a + b - 1) / b); }
long round4(long n) { return (n + 3) / 4 * 4; }

void fill_counts(Args& a) {
  a.nI = cdiv(a.I, T);
  a.nD = cdiv(a.DM, T);
  a.nQ = cdiv(a.q, T);
  a.nB = cdiv(a.B, T);
  a.blocks_a = a.nI * a.nD * a.L;
  a.blocks_b = std::min(cdiv((long)a.L * a.I * a.DM, NR * 8), 1024);
  a.n_elem = cdiv(std::max({(long)a.L * a.B, (long)a.B * a.I, (long)a.B * a.DM}), NR);
}

// The scratch, in floats, each part 16-byte aligned: ld, rp, lpt, labt (then
// bnt: lab's transpose is read before bnew's is written, and Mk = M <= D M =
// DM), bt, db, gp, yp, fp, part_a, part_b.
constexpr int NPARTS = 11;

void scratch_parts(const Args& a, long (&n)[NPARTS]) {
  const long L = a.L, I = a.I, DM = a.DM, B = a.B;
  const long parts[NPARTS] = {L * B,      B * DM,    I * B,       L * DM * I,
                              L * I * DM, L * I * DM, L * I * I,  L * I * a.q,
                              L * a.nD * B, 2L * a.blocks_a, 2L * a.blocks_b};
  for (int i = 0; i < NPARTS; ++i) n[i] = round4(parts[i]);
}

long scratch_floats(int L, int I, int DM, int B, int q) {
  Args a{};
  a.L = L; a.I = I; a.DM = DM; a.B = B; a.q = q;
  fill_counts(a);
  long n[NPARTS], total = 0;
  scratch_parts(a, n);
  for (long v : n) total += v;
  return total;
}

int transpose_tiles(int n, int rows, int cols) { return n * cdiv(rows, TT) * cdiv(cols, TT); }

// The six launches on `stream`; the inputs, outputs, shapes and options of
// `a` are set, fill_counts(a) has run, and `scratch` holds scratch_floats().
// with_pdl: each launch may start while its predecessor runs (pdl.cuh), as
// in K7's chain; K2 alone launches without it.
int launch(Args& a, float* scratch, cudaStream_t stream, bool with_pdl = false) {
  const int L = a.L, I = a.I, DM = a.DM, B = a.B, q = a.q;
  long n[NPARTS];
  scratch_parts(a, n);
  float** parts[NPARTS] = {&a.ld, &a.rp, &a.lpt, &a.labt, &a.bt,    &a.db,
                           &a.gp, &a.yp, &a.fp,  &a.part_a, &a.part_b};
  for (int i = 0; i < NPARTS; ++i) {
    *parts[i] = scratch;
    scratch += n[i];
  }
  a.bnt = a.labt;

  cudaError_t err = pdl::launch(prep_kernel, 1 + a.n_elem + transpose_tiles(L, I, a.Mk), NR, 0,
                                stream, with_pdl, a);
  if (err != cudaSuccess) return (int)err;
  const size_t dyn = (size_t)B * sizeof(float);
  if (dyn + sizeof(GradSmem) > 48 * 1024) {
    if (dyn + sizeof(GradSmem) > 227 * 1024) return (int)cudaErrorInvalidValue;
    static size_t opted = 0;  // the dynamic shared memory the kernel may take so far
    if (dyn > opted) {
      err = cudaFuncSetAttribute(gradient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)dyn);
      if (err != cudaSuccess) return (int)err;
      opted = dyn;
    }
  }
  err = pdl::launch(gradient_kernel, a.blocks_a, NT, dyn, stream, with_pdl, a);
  if (err != cudaSuccess) return (int)err;
  err = pdl::launch(update_kernel, a.blocks_b, NR, 0, stream, with_pdl, a);
  if (err != cudaSuccess) return (int)err;
  err = pdl::launch(transpose_kernel, transpose_tiles(L, I, DM), NR, 0, stream, with_pdl, a);
  if (err != cudaSuccess) return (int)err;
  const int jobs = (a.with_gram ? L * (a.nI * (a.nI + 1) / 2) : 0) + L * a.nI * a.nQ +
                   L * a.nB * a.nD;
  err = pdl::launch(products_kernel, jobs, NT, 0, stream, with_pdl, a);
  if (err != cudaSuccess) return (int)err;
  const long n_fin = std::max({a.with_gram ? (long)I * I : 0L, (long)I * q, (long)L * B});
  return (int)pdl::launch(finish_kernel, cdiv(n_fin, NR), NR, 0, stream, with_pdl, a);
}

}  // namespace presplit
}  // namespace
