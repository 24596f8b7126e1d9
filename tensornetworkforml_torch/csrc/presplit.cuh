// The two-site pre-split step's device code, shared by presplit.cu (K2, the
// hybrid engine's step) and two_site_step.cu (K7, the fused engine's whole
// step): merge, loss derivative, gradient, plain weight decay, L1 clip,
// ascent update, output recompute, and the split's sketch y0 = B_new Omega and
// Gram G = B_new B_new^T, as four launches (see presplit.cu for the design).
//
// A growth cap (K7 only; K2 passes growth_cap = 0, which changes no bit):
//   g_sc = min(1, (1 + cap) sum|bt| / sum|bnew|)
// scales bnew before f_new, y0 and G are formed. The launch that forms them
// (reduce_kernel) first reduces the update's partial sum|bnew| in the same
// fixed order in every block, scales bnew as it loads it, and writes g_sc to
// *gsc; finish_kernel then reports |g_sc bnew|^2 and sum|g_sc bnew| in the
// stats row. bnew itself is written unscaled.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "tile_gemm.cuh"

namespace {
namespace presplit {

constexpr int NT = 256;
constexpr int T = 64, TK = 16;
using Smem = TileSmem<T, T, TK>;

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
  float* bt;           // scratch (L, I, DM)
  float* db;           // scratch (L, I, DM)
  float* gp;           // scratch (L, I, I)
  float* yp;           // scratch (L, I, q)
  float* fp;           // scratch (L, nD, B)
  float* part_a;       // scratch (2 * blocks of A)
  float* part_b;       // scratch (2 * blocks of B)
  int L, I, Mk, DM, B, D, M, q;
  int nI, nD, nQ, nB;  // tile counts over I, DM, q and B
  int blocks_a, blocks_b, with_gram;
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

// A: bt, db tiles and their |.| partial sums
__global__ void __launch_bounds__(NT) grad_kernel(Args a) {
  extern __shared__ float ld[];  // loss_der[o, :]
  __shared__ Smem sm;
  __shared__ float red[NT];
  const int it = blockIdx.x, jt = blockIdx.y, o = blockIdx.z, tid = threadIdx.x;
  const int blk = (o * a.nD + jt) * a.nI + it;
  for (int b = tid; b < a.B; b += NT) ld[b] = loss_der(a, o, b);
  __syncthreads();

  const int I = a.I, Mk = a.Mk, DM = a.DM, B = a.B;
  const int m0 = it * T, n0 = jt * T;
  const float* lab = a.lab + (size_t)o * I * Mk;
  const float* a2m = a.a2m;
  float acc_bt[4][4], acc_db[4][4];
  tile_gemm<T, T, TK, NT, true, false>(
      sm, m0, n0, Mk,
      [=](int m, int k) { return (m < I && k < Mk) ? lab[(size_t)m * Mk + k] : 0.f; },
      [=](int k, int n) { return (k < Mk && n < DM) ? a2m[(size_t)k * DM + n] : 0.f; }, acc_bt);
  const Args& ar = a;
  tile_gemm<T, T, TK, NT, false, false>(
      sm, m0, n0, B,
      [&](int m, int b) { return (m < I && b < B) ? left_part(ar, b, m) : 0.f; },
      [&](int b, int n) { return (b < B && n < DM) ? right_part(ar, b, n) * ld[b] : 0.f; },
      acc_db);

  const float wd = *a.wd;
  const int ty = tid / (T / 4), tx = tid % (T / 4);
  float sb = 0.f, sdb = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < I && n < DM) {
        const float bt = acc_bt[i][j];
        const float db = acc_db[i][j] - wd * bt;
        const size_t idx = ((size_t)o * I + m) * DM + n;
        a.bt[idx] = bt;
        a.db[idx] = db;
        sb += fabsf(bt);
        sdb += fabsf(db);
      }
    }
  sb = block_sum<NT>(sb, red);
  sdb = block_sum<NT>(sdb, red);
  if (tid == 0) {
    a.part_a[2 * blk] = sb;
    a.part_a[2 * blk + 1] = sdb;
  }

  if (o == 0 && jt == 0) {  // left_part rows of this I-tile
    for (int e = tid; e < B * T; e += NT) {
      const int b = e / T, m = m0 + e % T;
      if (m < I) a.left_part[(size_t)b * I + m] = left_part(a, b, m);
    }
  }
  if (blk == 0) {  // batch metrics on the carried output (unique-max argmax)
    float hits = 0.f, mae = 0.f, fabs_sum = 0.f;
    for (int b = tid; b < B; b += NT) {
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
    hits = block_sum<NT>(hits, red);
    mae = block_sum<NT>(mae, red);
    fabs_sum = block_sum<NT>(fabs_sum, red);
    if (tid == 0) {
      const float n = (float)a.L * (float)B;
      a.stats[4] = hits / (float)B;
      a.stats[5] = mae / n;
      a.stats[6] = fabs_sum / n;
      a.stats[7] = 0.f;
    }
  }
}

// B: eta from all partials (same order in every block), bnew and its partial sums
__global__ void __launch_bounds__(NT) update_kernel(Args a) {
  __shared__ float red[NT];
  const int tid = threadIdx.x;
  float sb = 0.f, sdb = 0.f;
  for (int p = tid; p < a.blocks_a; p += NT) {
    sb += a.part_a[2 * p];
    sdb += a.part_a[2 * p + 1];
  }
  sb = block_sum<NT>(sb, red);
  sdb = block_sum<NT>(sdb, red);
  const float eta = *a.lr * (sdb > sb ? sb / fmaxf(sdb, 1e-30f) : 1.f);
  const size_t n = (size_t)a.L * a.I * a.DM;
  float n2 = 0.f, sabs = 0.f;
  for (size_t e = (size_t)blockIdx.x * NT + tid; e < n; e += (size_t)gridDim.x * NT) {
    const float v = a.bt[e] + eta * a.db[e];
    a.bnew[e] = v;
    n2 = fmaf(v, v, n2);
    sabs += fabsf(v);
  }
  n2 = block_sum<NT>(n2, red);
  sabs = block_sum<NT>(sabs, red);
  if (tid == 0) {
    a.part_b[2 * blockIdx.x] = n2;
    a.part_b[2 * blockIdx.x + 1] = sabs;
    if (blockIdx.x == 0) {
      a.stats[0] = sb;
      a.stats[1] = sdb;
    }
  }
}

// C: per-label partial tiles of G and y0, per-(label, DM-tile) partials of f_new
__global__ void __launch_bounds__(NT) reduce_kernel(Args a) {
  __shared__ Smem sm;
  __shared__ float rowpart[T][T / 4 + 1];
  const int I = a.I, DM = a.DM, q = a.q, B = a.B;
  const int tid = threadIdx.x, ty = tid / (T / 4), tx = tid % (T / 4);
  float gs = 1.f;  // the growth cap's factor on bnew
  if (a.growth_cap > 0.f) {
    float s = 0.f;
    for (int p = tid; p < a.blocks_b; p += NT) s += a.part_b[2 * p + 1];
    s = block_sum<NT>(s, &rowpart[0][0]);
    const float cap = (1.f + a.growth_cap) * a.stats[0];
    gs = s > cap ? cap / fmaxf(s, 1e-30f) : 1.f;
    if (blockIdx.x == 0 && tid == 0) *a.gsc = gs;
    __syncthreads();
  }
  int job = blockIdx.x;
  const int jobs_g = a.with_gram ? a.L * a.nI * a.nI : 0;
  const int jobs_y = a.L * a.nI * a.nQ;
  float acc[4][4];
  if (job < jobs_g) {
    const int it = job % a.nI, jt = (job / a.nI) % a.nI, o = job / (a.nI * a.nI);
    const float* bn = a.bnew + (size_t)o * I * DM;
    tile_gemm<T, T, TK, NT, true, true>(
        sm, it * T, jt * T, DM,
        [=](int m, int k) { return (m < I && k < DM) ? bn[(size_t)m * DM + k] * gs : 0.f; },
        [=](int k, int n) { return (k < DM && n < I) ? bn[(size_t)n * DM + k] * gs : 0.f; }, acc);
    float* gp = a.gp + (size_t)o * I * I;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = it * T + ty * 4 + i, n = jt * T + tx * 4 + j;
        if (m < I && n < I) gp[(size_t)m * I + n] = acc[i][j];
      }
    return;
  }
  job -= jobs_g;
  if (job < jobs_y) {
    const int it = job % a.nI, qt = (job / a.nI) % a.nQ, o = job / (a.nI * a.nQ);
    const float* bn = a.bnew + (size_t)o * I * DM;
    const float* om = a.om + (size_t)o * DM * q;
    tile_gemm<T, T, TK, NT, true, false>(
        sm, it * T, qt * T, DM,
        [=](int m, int k) { return (m < I && k < DM) ? bn[(size_t)m * DM + k] * gs : 0.f; },
        [=](int k, int n) { return (k < DM && n < q) ? om[(size_t)k * q + n] : 0.f; }, acc);
    float* yp = a.yp + (size_t)o * I * q;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = it * T + ty * 4 + i, n = qt * T + tx * 4 + j;
        if (m < I && n < q) yp[(size_t)m * q + n] = acc[i][j];
      }
    return;
  }
  job -= jobs_y;
  // f partial: rows b of (left_part @ bnew_o)[:, DM-tile] dotted with right_part
  const int bt = job % a.nB, jt = (job / a.nB) % a.nD, o = job / (a.nB * a.nD);
  const float* bn = a.bnew + (size_t)o * I * DM;
  const Args& ar = a;
  tile_gemm<T, T, TK, NT, true, false>(
      sm, bt * T, jt * T, I,
      [&](int b, int r) { return (b < B && r < I) ? left_part(ar, b, r) : 0.f; },
      [=](int r, int s) { return (r < I && s < DM) ? bn[(size_t)r * DM + s] * gs : 0.f; }, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = bt * T + ty * 4 + i;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = jt * T + tx * 4 + j;
      if (b < B && n < DM) s = fmaf(acc[i][j], right_part(a, b, n), s);
    }
    rowpart[ty * 4 + i][tx] = s;
  }
  __syncthreads();
  if (tid < T) {
    const int b = bt * T + tid;
    float s = 0.f;
    for (int p = 0; p < T / 4; ++p) s += rowpart[tid][p];
    if (b < B) a.fp[((size_t)o * a.nD + jt) * B + b] = s;
  }
}

// D: fixed-order sums of the partials
__global__ void __launch_bounds__(NT) finish_kernel(Args a) {
  __shared__ float red[NT];
  const size_t II = (size_t)a.I * a.I, Iq = (size_t)a.I * a.q, LB = (size_t)a.L * a.B;
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
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
    for (int p = threadIdx.x; p < a.blocks_b; p += NT) {
      n2 += a.part_b[2 * p];
      sabs += a.part_b[2 * p + 1];
    }
    n2 = block_sum<NT>(n2, red);
    sabs = block_sum<NT>(sabs, red);
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

void fill_counts(Args& a) {
  a.nI = cdiv(a.I, T);
  a.nD = cdiv(a.DM, T);
  a.nQ = cdiv(a.q, T);
  a.nB = cdiv(a.B, T);
  a.blocks_a = a.nI * a.nD * a.L;
  a.blocks_b = std::min(cdiv((long)a.L * a.I * a.DM, NT * 8), 1024);
}

long scratch_floats(int L, int I, int DM, int B, int q) {
  Args a{};
  a.L = L; a.I = I; a.DM = DM; a.B = B; a.q = q;
  fill_counts(a);
  return 2L * L * I * DM + (long)L * I * I + (long)L * I * q + (long)L * a.nD * B +
         2L * a.blocks_a + 2L * a.blocks_b;
}

// The four launches on `stream`; the inputs, outputs, shapes and options of
// `a` are set, fill_counts(a) has run, and `scratch` holds scratch_floats().
int launch(Args& a, float* scratch, cudaStream_t stream) {
  const int L = a.L, I = a.I, DM = a.DM, B = a.B, q = a.q;
  a.bt = scratch;
  a.db = a.bt + (size_t)L * I * DM;
  a.gp = a.db + (size_t)L * I * DM;
  a.yp = a.gp + (size_t)L * I * I;
  a.fp = a.yp + (size_t)L * I * q;
  a.part_a = a.fp + (size_t)L * a.nD * B;
  a.part_b = a.part_a + 2 * a.blocks_a;

  const size_t dyn = (size_t)B * sizeof(float);
  if (dyn > 48 * 1024) {
    if (dyn > 200 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  grad_kernel<<<dim3(a.nI, a.nD, L), NT, dyn, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  update_kernel<<<a.blocks_b, NT, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int jobs = (a.with_gram ? L * a.nI * a.nI : 0) + L * a.nI * a.nQ + L * a.nB * a.nD;
  reduce_kernel<<<jobs, NT, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n_fin = std::max({a.with_gram ? (long)I * I : 0L, (long)I * q, (long)L * B});
  finish_kernel<<<cdiv(n_fin, NT), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace presplit
}  // namespace
